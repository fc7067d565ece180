"""The JAX package's end-to-end physics pins (tests/test_physics.py) run on
the PyTorch port, on the CPU: dilute self-diffusion on the gather and
blocked engines, the harmonic trap's Boltzmann variance, a user shear
function, a temperature ramp and Hasimoto's sedimentation lattice.  The
two dense pins are in test_torch_physics_dense.py and
test_torch_physics_error.py, one module each, because the suite gives one
worker a whole file."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pse_tpu_torch as pse                  # noqa: E402
from pse_tpu_torch import box as boxlib      # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("engine", ["gather", "blocked"])
def test_dilute_self_diffusion(engine):
    """Per-step displacement variance of a dilute thermal suspension matches
    2·D·dt with the periodic-corrected self-diffusion
    D = kT·(1 − 2.837297 a/L + ...) (Hasimoto correction; units 6πηa = a = 1).

    Per-step increments are independent (Euler-Maruyama is memoryless), so
    N·steps·3 ≈ 5e4 square samples give ~1% statistics; E[x²] is unbiased by
    inter-particle correlations.  Runs through BOTH engines so the production
    (blocked + thermal) configuration has end-to-end physics evidence.
    """
    N_side, L, dt, T = 3, 30.0, 5e-3, 1.0
    n = N_side ** 3
    n_steps = 600

    sim = pse.Simulation(
        positions=pse.create_lattice(N_side, L), L=L, dt=dt, sync_every=1,
        device="cpu",
    )
    sim.set_integrator(
        pse.integrate.PSEv1(T=T, seed=7, xi=0.5, error=1e-3),
        verbose=False, engine=engine,
    )
    assert sim.config.engine == engine
    traj = [np.asarray(boxlib.unwrap(sim.box, sim.state.pos, sim.state.images))]

    def collect(s):
        traj.append(
            np.asarray(boxlib.unwrap(s.box, s.state.pos, s.state.images))
        )

    sim.run(n_steps, callback=collect)
    steps = np.diff(np.stack(traj), axis=0)        # (n_steps, n, 3)
    var = (steps ** 2).mean()
    d_meas = var / (2.0 * dt)

    d_expected = T * 1.0 * (1.0 - 2.837297 / L)
    rel = abs(d_meas - d_expected) / d_expected
    assert rel < 0.05, f"D={d_meas:.4f} vs {d_expected:.4f} (rel {rel:.3f})"


def test_harmonic_trap_equilibrium():
    """Particles in a harmonic trap equilibrate to Boltzmann variance kT/k
    (validates the fluctuation-dissipation balance of drift vs noise)."""
    n, L, dt, T, k_spring = 27, 25.0, 2e-3, 0.8, 2.0
    # relaxation time tau = 1/(k·M) ≈ 250 steps: burn 4 tau, sample 8 tau
    n_steps, burn = 2000, 1000

    # One trap per particle, centers 8.3a apart: hydrodynamic coupling is
    # weak, so every mode relaxes at ~tau.  (A tight overlapping cluster
    # would NOT equilibrate: RPY relative mobility vanishes at contact and
    # the relative modes freeze.)
    centers = torch.as_tensor(pse.create_lattice(3, L))
    force_fn = lambda p, t: -k_spring * (p - centers)   # noqa: E731

    sim = pse.Simulation(
        positions=centers.numpy(), L=L, dt=dt,
        force_fn=force_fn, sync_every=100, device="cpu",
    )
    sim.set_integrator(
        pse.integrate.PSEv1(T=T, seed=11, xi=0.5, error=1e-3),
        verbose=False, engine="gather",
    )
    sim.run(burn)
    samples = []

    def collect(s):
        samples.append(np.asarray(s.state.pos).copy())

    sim.run(n_steps, callback=collect)
    centers_np = centers.numpy()
    pos = np.concatenate([s - centers_np for s in samples], axis=0)
    var = (pos ** 2).mean()

    # Euler-Maruyama with mobility M has stationary variance
    # kT/k · 1/(1 − k·M·dt/2) per component; the correction is tiny here.
    expected = T / k_spring
    rel = abs(var - expected) / expected
    assert rel < 0.15, f"var={var:.4f} vs {expected:.4f} (rel {rel:.3f})"


def test_custom_shear_function_subclass():
    """User-defined ShearFunction subclasses drive the integrator
    (ShearFunctionWrap trampoline parity, ShearFunctionWrap.h:21-38)."""

    class RampShear(pse.shear_function.ShearFunction):
        offset = 0

        def shear_rate(self, timestep):
            return 1e-3 * timestep

        def strain(self, timestep):
            return 0.5e-3 * timestep ** 2 * 1e-3

    sim = pse.Simulation(positions=pse.create_lattice(3, 20.0), L=20.0,
                         dt=1e-3, device="cpu")
    sim.set_integrator(
        pse.integrate.PSEv1(T=0.0, seed=0, xi=0.5, error=1e-3,
                            function_form=RampShear()),
        verbose=False, engine="gather",
    )
    sim.run(5)
    assert int(sim.state.step) == 5


def test_temperature_variant_ramp():
    """T may be a function of the timestep (HOOMD Variant parity)."""
    T_fn = lambda t: 0.5 + 0.5 * min(t / 10.0, 1.0)     # noqa: E731
    sim = pse.Simulation(positions=pse.create_lattice(3, 20.0), L=20.0,
                         dt=1e-3, device="cpu")
    sim.set_integrator(
        pse.integrate.PSEv1(T=T_fn, seed=2, xi=0.5, error=1e-3),
        verbose=False, engine="gather",
    )
    p0 = np.asarray(sim.state.pos).copy()
    sim.run(8)
    assert np.abs(np.asarray(sim.state.pos) - p0).max() > 1e-4


def test_sedimentation_hasimoto_lattice():
    """Literature pin: sedimentation mobility of a simple-cubic array vs
    Hasimoto's lattice series U/U0 = 1 − 1.7601·φ^{1/3} + φ − 1.5593·φ²
    (H. Hasimoto, J. Fluid Mech. 5, 317 (1959)), the classic dilute-array
    result the Ewald k=0 exclusion (Helper.cu:326 / Brownian.cu:210-215
    semantics) must reproduce.

    Velocities are in the reference's units of F/(6πηa) (self mobility → 1
    as ξ→0, Stokes.cc:315-319), so U/U0 is just the mean z-velocity under
    unit z-forces.  RPY converges to the point-force lattice result from
    above as φ→0; measured agreement: 0.05% at φ=0.01, ~0.3% at φ=0.02
    (and the identity U(N-particle lattice, L) == U(1 particle, L/n_side)
    holds to round-off, checked once during development).
    """
    import math

    from pse_tpu_torch import integrator

    phi = 0.02
    n_side = 4
    n = n_side ** 3
    a_lat = (4.0 / 3.0 * math.pi / phi) ** (1.0 / 3.0)
    L = a_lat * n_side
    g = (np.arange(n_side) + 0.5) * a_lat - L / 2.0
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1).astype(
        np.float32
    )
    f = np.zeros((n, 3), np.float32)
    f[:, 2] = 1.0

    params = pse.make_params(xi=0.7, error=1e-3, L=L)
    cfg = integrator.make_config(
        params, n, thermal=False, engine="blocked", max_tilt=0.0,
        device="cpu"
    )
    u, overflow = integrator.mobility(cfg, pos, f)
    assert not bool(overflow)
    u_sed = float(np.mean(np.asarray(u)[:, 2]))
    c = phi ** (1.0 / 3.0)
    hasimoto = 1.0 - 1.7601 * c + phi - 1.5593 * phi * phi
    assert abs(u_sed - hasimoto) < 0.01 * hasimoto, (
        f"U/U0={u_sed:.4f} vs Hasimoto {hasimoto:.4f}"
    )


