"""The PyTorch port's step and Simulation API against the JAX package.

One full thermal, force-free banded step with JAX's own draws injected (the
psi and wave uniforms ``integrator.step`` draws from fold_in(PRNGKey(
hash_seed(seed)), step)), bitwise reruns, the Brownian covariance against
``pse_tpu``'s mobility, the Simulation loop and checkpoints written by
``pse_tpu``, and the engine choice with and without halo slabs (the
with-forces and athermal paths are held to ``pse_tpu`` in
test_torch_forces.py).  CPU only: the port's kernel wrappers run their
plain versions here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

import pse_tpu as J                          # noqa: E402
from pse_tpu import integrator as ji         # noqa: E402
from pse_tpu.ops import noise as jn          # noqa: E402

import pse_tpu_torch as P                    # noqa: E402
from pse_tpu_torch import integrator as pi   # noqa: E402

N, L = 1080, 24.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _positions(seed, n=N):
    rng = np.random.default_rng(seed)
    return rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)


def _configs(seed=5):
    jp = J.make_params(xi=0.5, error=1e-3, L=L)
    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    return (ji.make_config(jp, N, thermal=True, engine="banded",
                           has_forces=False, seed=seed),
            pi.make_config(tp, N, thermal=True, engine="banded",
                           has_forces=False, seed=seed, device="cpu"))


def _jax_draws(cfg, step):
    """The uniforms JAX's step draws (integrator.py step_impl)."""
    key = jax.random.fold_in(jax.random.PRNGKey(ji.hash_seed(cfg.seed)),
                             jnp.asarray(step, jnp.int32))
    k_psi, k_grid = jax.random.split(key)
    bs, p = cfg.band_spec.bins, cfg.params
    psi = jn.particle_noise_t(k_psi, (bs.n_cells[0] * bs.n_cells[1], bs.cap))
    wave = jax.random.uniform(k_grid, (6, p.Nx, p.Ny, p.Nz // 2 + 1),
                              dtype=jnp.float32, minval=-jn.SQRT3D2,
                              maxval=jn.SQRT3D2)
    return np.asarray(psi), np.asarray(wave)


@pytest.mark.parametrize("tilt,rate,new_tilt,step,m0", [
    (0.0, 0.0, 0.0, 0, 2),          # untilted, no shear, probe step
    (0.3, 0.7, 0.31, 5, 7),         # tilted box, shear, tilt update
])
def test_step_matches_jax(tilt, rate, new_tilt, step, m0):
    """Velocities to 1e-4 relative with equal m_lanczos; the port's state
    is carried over from the JAX state's arrays (state_from_arrays)."""
    jcfg, tcfg = _configs()
    js = ji.make_state(_positions(3), step=step, tilt_xy=tilt)._replace(
        m_lanczos=jnp.asarray(m0, jnp.int32),
        images=jnp.asarray(np.random.default_rng(4).integers(
            -2, 3, size=(N, 3)), jnp.int32))
    ts = pi.state_from_arrays({k: np.asarray(v) for k, v in js._asdict().items()},
                              device="cpu")
    jnew, jinfo = ji.step(jcfg, js, jnp.zeros((N, 3), jnp.float32), 1.0,
                          1e-3, rate, new_tilt)
    tnew, tinfo = pi.step(tcfg, ts, torch.zeros((N, 3)), 1.0, 1e-3, rate,
                          new_tilt, uniforms=_jax_draws(jcfg, step))
    assert tinfo["m_lanczos"] == int(jinfo["m_lanczos"])
    assert _rel(tinfo["velocities"].numpy(), jinfo["velocities"]) < 1e-4
    np.testing.assert_allclose(tnew.pos.numpy(), np.asarray(jnew.pos),
                               atol=1e-5)
    np.testing.assert_array_equal(tnew.images.numpy(),
                                  np.asarray(jnew.images))
    assert (tnew.step, tnew.m_lanczos) == (int(jnew.step),
                                           int(jnew.m_lanczos))
    assert tnew.tilt_xy == float(jnew.tilt_xy)
    assert int(tnew.nbr_overflow) == int(jnew.nbr_overflow) == 0


def test_step_reruns_are_bitwise_equal():
    """Draws are keyed by (hash_seed(seed), step): the same step twice is
    bitwise equal, the next step draws anew."""
    _, tcfg = _configs(seed=9)
    s0 = pi.make_state(_positions(8), step=3, device="cpu")
    f0 = torch.zeros((N, 3))
    a, ia = pi.step(tcfg, s0, f0, 1.0, 1e-3, 0.2)
    b, ib = pi.step(tcfg, s0, f0, 1.0, 1e-3, 0.2)
    assert torch.equal(a.pos, b.pos)
    assert torch.equal(ia["velocities"], ib["velocities"])
    _, ic = pi.step(tcfg, s0._replace(step=4), f0, 1.0, 1e-3, 0.2)
    assert not torch.equal(ia["velocities"], ic["velocities"])


def test_brownian_covariance_matches_jax_mobility():
    """<(v.u)^2> -> (2T/dt) v^T M v over the port's draws, with v^T M v
    from pse_tpu's integrator.mobility (test_banded.py's covariance test)."""
    rng = np.random.default_rng(7)
    pos = rng.uniform(-L / 2, L / 2, size=(N, 3)).astype(np.float32)
    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    cfg = pi.make_config(tp, N, thermal=True, seed=11, engine="banded",
                         has_forces=False, device="cpu")
    T, dt = 1.0, 1.0
    n_samples = 24
    probes = rng.normal(size=(3, N, 3)).astype(np.float32)
    probes /= np.linalg.norm(probes, axis=(1, 2), keepdims=True)
    acc = np.zeros(3)
    for s in range(n_samples):
        u, m_used, ov = pi.brownian_displacement(cfg, pos, 0.0, s, 8, T, dt)
        assert int(ov) == 0 and m_used >= 2
        acc += np.einsum("pij,ij->p", probes, u.numpy()) ** 2
    var = acc / n_samples
    jcfg = ji.make_config(J.make_params(xi=0.5, error=1e-3, L=L), N,
                          thermal=False, engine="banded")
    expect = np.zeros(3)
    for k in range(3):
        mv, _ = ji.mobility(jcfg, pos, probes[k])
        expect[k] = 2.0 * T / dt * float(np.einsum("ij,ij->", probes[k], mv))
    # MC error ~ sqrt(2/n_samples) ~ 29%
    assert np.all(np.abs(var - expect) < 0.75 * np.abs(expect))


def test_simulation_runs_sheared_and_resumes_a_pse_tpu_checkpoint(tmp_path):
    """Simulation.run with a sine protocol and the shear box; save/restore
    round trip; a checkpoint written by pse_tpu's Simulation resumes."""
    dt = 1e-3
    pos = _positions(12)
    sim = P.Simulation(positions=pos, L=L, dt=dt, sync_every=3, device="cpu")
    sim.set_integrator(P.PSEv1(
        T=1.0, seed=2, xi=0.5, error=1e-3,
        function_form=P.shear_function.sine(dt=dt, shear_rate=40.0,
                                            shear_freq=5.0, zero=0)),
        engine="banded", verbose=False)
    sim.enable_shear_box(total_timesteps=1000)
    sim.run(4)                                  # chunks of 3 and 1
    snap = sim.snapshot()
    assert snap["step"] == 4 and sim.metrics["steps"] == 4
    assert sum(sim.metrics["m_lanczos_hist"].values()) == 4
    assert snap["tilt_xy"] != 0.0
    assert np.isfinite(snap["pos"]).all()
    assert np.abs(snap["pos"] - pos).max() > 1e-4
    assert "steps=4" in sim.metrics_summary()

    path = tmp_path / "port.npz"
    sim.save(str(path))
    sim.run(1)
    after = sim.snapshot()["pos"]
    sim.restore(str(path))
    assert sim.snapshot()["step"] == 4
    sim.run(1)
    np.testing.assert_array_equal(sim.snapshot()["pos"], after)

    jsim = J.Simulation(positions=pos, L=L, dt=dt)
    jsim.state = jsim.state._replace(
        step=jnp.asarray(40, jnp.int32), tilt_xy=jnp.asarray(0.125),
        m_lanczos=jnp.asarray(6, jnp.int32),
        images=jnp.ones((N, 3), jnp.int32))
    jpath = tmp_path / "jax.npz"
    jsim.save(str(jpath))
    sim.restore(str(jpath))
    s = sim.snapshot()
    assert (s["step"], s["tilt_xy"], s["m_lanczos"]) == (40, 0.125, 6)
    np.testing.assert_array_equal(s["images"], np.ones((N, 3), np.int32))
    sim.run(1)
    assert sim.snapshot()["step"] == 41


def test_halo_slabs_and_engine_choice_match_jax():
    """make_config(shard_slabs=2) gives pse_tpu's engine and band_spec
    (here banded falls back to blocked: ncx = 3 rounds down to 2; at L = 33
    it bands with ncx = 4); the gather engine, the fallbacks of boxes too
    small to band or block, the blocked engine and PSEv1.group run,
    choosing pse_tpu's engine and nbr_spec."""
    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    jp = J.make_params(xi=0.5, error=1e-3, L=L)
    for n, box, expect in ((N, L, "blocked"), (4800, 33.0, "banded")):
        cfg = pi.make_config(P.make_params(xi=0.5, error=1e-3, L=box), n,
                             engine="banded", shard_slabs=2, device="cpu")
        jcfg = ji.make_config(J.make_params(xi=0.5, error=1e-3, L=box), n,
                              engine="banded", shard_slabs=2)
        assert cfg.engine == jcfg.engine == expect
        assert cfg.band_spec == jcfg.band_spec and cfg.shard_slabs == 2
    for n, engine, expect in ((N, "blocked", "blocked"),
                              (64, "banded", "blocked"),       # 64: sparse
                              (N, "gather", "gather")):
        cfg = pi.make_config(tp, n, engine=engine, has_forces=False,
                             device="cpu")
        jcfg = ji.make_config(jp, n, engine=engine, has_forces=False)
        assert cfg.engine == jcfg.engine == expect
        assert cfg.nf_spec == jcfg.nf_spec and cfg.band_spec is None
        assert cfg.nbr_spec == jcfg.nbr_spec
    small = 10.0                 # grid too small to block: gather
    sp, jsp = (pkg.make_params(xi=0.5, error=1e-3, L=small) for pkg in (P, J))
    cfg = pi.make_config(sp, 107, engine="banded", device="cpu")
    jcfg = ji.make_config(jsp, 107, engine="banded")
    assert cfg.engine == jcfg.engine == "gather"
    assert cfg.nbr_spec == jcfg.nbr_spec and cfg.nbr_spec.all_pairs
    sim = P.Simulation(positions=_positions(1), L=L, dt=1e-3, device="cpu")
    sim.set_integrator(P.PSEv1(T=1.0, group=np.arange(10)),
                       engine="banded", verbose=False)
    assert sim.config.engine == "blocked"         # 10 particles do not band
    assert sim.config.nf_spec == ji.make_config(jp, 10).nf_spec


def test_entry_points_default_to_cuda():
    """Without device=..., entry points run on CUDA and never fall back to
    the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.Simulation(positions=_positions(1), L=L, dt=1e-3)
    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    cfg = pi.make_config(tp, N, engine="banded", has_forces=False)
    assert cfg.device == "cuda" and cfg.colff_spec.weight_dtype == "bfloat16"
