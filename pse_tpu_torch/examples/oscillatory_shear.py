"""BASELINE config 3: semidilute suspension (phi = 0.2) under oscillatory shear.

The two cooperating shear mechanisms: per-step affine advection from the
shear rate, and box tilting driven by the wrapped strain variant, with the
sheared-lattice wave vectors and the tilted-cell minimum image engaged
throughout.  Frames go to an npz trajectory (utils.trajectory).

    python -m pse_tpu_torch.examples.oscillatory_shear [--device cpu]
        [--steps 200] [--n 20000] [--out shear_traj.npz]
"""

import argparse
import math

import numpy as np

import pse_tpu_torch as pse
from pse_tpu_torch.utils.trajectory import TrajectoryWriter


def main(device="cuda", n_steps=200, n=20_000, out="shear_traj.npz"):
    phi = 0.2
    L = (n * 4.0 / 3.0 * math.pi / phi) ** (1.0 / 3.0)
    dt = 1e-3

    rng = np.random.default_rng(1)
    positions = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)

    shear = pse.shear_function.sine(dt=dt, shear_rate=0.5, shear_freq=1.0)

    sim = pse.Simulation(positions=positions, L=L, dt=dt, sync_every=20,
                         device=device)
    sim.set_integrator(
        pse.integrate.PSEv1(T=1.0, seed=2, xi=0.5, error=1e-3,
                            function_form=shear),
        verbose=False,
    )
    sim.enable_shear_box(total_timesteps=n_steps)

    writer = TrajectoryWriter(out, every=1)
    sim.run(n_steps, callback=writer)
    path = writer.close()

    s = sim.snapshot()
    print(f"step {s['step']}  box tilt {s['tilt_xy']:+.4f}  "
          f"m_lanczos {s['m_lanczos']}  engine {sim.config.engine}  "
          f"trajectory -> {path}")
    return sim, path


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--out", default="shear_traj.npz")
    args = ap.parse_args()
    main(args.device, args.steps, args.n, args.out)
