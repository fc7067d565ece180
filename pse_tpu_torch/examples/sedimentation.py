"""BASELINE config 2: deterministic mobility (kT=0) sedimentation.

N=10k particles under a uniform body force; the velocity field is U = M·F.
Validates the deterministic path at scale and demonstrates the public
mobility matvec (gpu_stokes_Mobility_wrap analogue).

    python -m pse_tpu_torch.examples.sedimentation [--device cpu] [--steps 100]
"""

import argparse

import numpy as np
import torch

import pse_tpu_torch as pse


def main(device="cuda", n_steps=100):
    N, L, dt = 10_000, 64.0, 1e-3
    rng = np.random.default_rng(0)
    positions = rng.uniform(-L / 2, L / 2, size=(N, 3)).astype(np.float32)

    gravity = torch.tensor([[0.0, 0.0, -1.0]], device=device).repeat(N, 1)

    sim = pse.Simulation(
        positions=positions, L=L, dt=dt, force_fn=lambda p, t: gravity,
        sync_every=20, device=device,
    )
    sim.set_integrator(pse.integrate.PSEv1(T=0.0, seed=0, xi=0.5,
                                           error=1e-3))

    # One-shot mobility matvec: mean sedimentation velocity of the suspension
    u = sim.mobility_matvec(gravity).cpu().numpy()
    print(f"mean settling velocity: {u[:, 2].mean():.4f} "
          f"(spread {u[:, 2].std():.4f})")

    sim.run(n_steps)
    s = sim.snapshot()
    print(f"ran to step {s['step']}; mean z-displacement "
          f"{(s['pos'][:, 2] - positions[:, 2]).mean():.4f}")
    return sim, u


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    main(args.device, args.steps)
