"""Port of the reference example (examples/run.py): 1000-particle SC lattice
in an L=64 box, sinusoidal oscillatory shear, kT=1 Brownian dynamics.

    python -m pse_tpu_torch.examples.run_pse [--device cpu]
"""

import argparse
import math

import pse_tpu_torch as pse


def main(device="cuda"):
    # Time stepping information (run.py:10-12)
    dt = 1e-3      # time step
    tf = 1e-1      # final time (shortened from 1e0 for a quick demo)
    nrun = int(tf / dt)

    # Simple cubic crystal of 1000 particles (run.py:27-34)
    N = 1000
    L = 64
    n = math.ceil(N ** (1.0 / 3.0))
    positions = pse.create_lattice(n, L)

    # Sinusoidal oscillatory shear (run.py:36-42)
    function_form = pse.shear_function.sine(dt=dt, shear_rate=1.0,
                                            shear_freq=1.0)

    # Set up PSE integrator (run.py:44-54)
    sim = pse.Simulation(positions=positions, L=L, dt=dt, sync_every=20,
                         device=device)
    sim.set_integrator(
        pse.integrate.PSEv1(
            T=1.0, seed=1, xi=0.5, error=1e-3, function_form=function_form
        )
    )
    sim.enable_shear_box(total_timesteps=nrun)

    # Run the simulation (run.py:57)
    sim.run(nrun)

    s = sim.snapshot()
    print(sim.metrics_summary())
    print(f"done: step={s['step']} tilt={s['tilt_xy']:.4f} "
          f"m_lanczos={s['m_lanczos']}")
    print(f"mean |displacement| = {abs(s['pos'] - positions).mean():.4f}")
    return sim


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
