"""The port's sharded step and mobility (pse_tpu_torch.parallel.sharding)
against the JAX package's, and the engine-injected step against ``step``.

The port splits the near field over a mesh of torch devices in one process
(here ``[torch.device("cpu")] * 4``): the gather engine's pair rows and the
blocked engine's stencil offsets; the far field stays on the home device.
On tests/test_sharding.py's 8^3 lattice (tilt 0.03), thermal with JAX's
draws injected and athermal: gather against pse_tpu's GSPMD-sharded step on
4 JAX CPU devices and bitwise against the port's one-device step; blocked
against pse_tpu's one-device step (which tests/test_sharding.py holds to
its sharded one), with that file's tolerances.  CPU only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

import pse_tpu as J                          # noqa: E402
from pse_tpu import integrator as ji         # noqa: E402
from pse_tpu.ops import noise as jn          # noqa: E402
from pse_tpu.parallel import sharding as jsh  # noqa: E402

import pse_tpu_torch as P                    # noqa: E402
from pse_tpu_torch import integrator as pi   # noqa: E402
from pse_tpu_torch.parallel import sharding as tsh   # noqa: E402

T, DT, RATE, NEW_TILT = 1.0, 1e-3, 0.2, 0.031


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(engine, thermal=True, n_side=8, L=24.0, tilt=0.03, seed=0):
    """tests/test_sharding.py's problem in both packages: (JAX config,
    state, forces, the port's config, state, forces)."""
    n = n_side ** 3
    rng = np.random.default_rng(seed)
    pos = J.create_lattice(n_side, L)
    pos = (pos + rng.normal(scale=0.08, size=pos.shape)).astype(np.float32)
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    jcfg = ji.make_config(J.make_params(xi=0.5, error=1e-3, L=L), n,
                          thermal=thermal, seed=1, engine=engine)
    tcfg = pi.make_config(P.make_params(xi=0.5, error=1e-3, L=L), n,
                          thermal=thermal, seed=1, engine=engine,
                          device="cpu")
    assert tcfg.engine == jcfg.engine == engine
    return (jcfg, ji.make_state(pos, tilt_xy=tilt), jnp.asarray(forces),
            tcfg, pi.make_state(pos, tilt_xy=tilt, device="cpu"),
            torch.from_numpy(forces))


def _jax_draws(cfg, step, n):
    """The uniforms pse_tpu's step draws: psi in the engine's slots ((3, N)
    on gather, (3, C, cap) on blocked) and the wave."""
    key = jax.random.fold_in(jax.random.PRNGKey(ji.hash_seed(cfg.seed)),
                             jnp.asarray(step, jnp.int32))
    k_psi, k_grid = jax.random.split(key)
    p = cfg.params
    if cfg.engine == "gather":
        shape = (n,)
    else:
        shape = (cfg.nf_spec.bins.n_cells_total, cfg.nf_spec.bins.cap)
    psi = jn.particle_noise_t(k_psi, shape)
    wave = jax.random.uniform(k_grid, (6, p.Nx, p.Ny, p.Nz // 2 + 1),
                              dtype=jnp.float32, minval=-jn.SQRT3D2,
                              maxval=jn.SQRT3D2)
    return np.asarray(psi), np.asarray(wave)


def _mesh():
    return tsh.make_mesh([torch.device("cpu")] * 4)


@pytest.mark.parametrize("engine", ["blocked", "gather"])
@pytest.mark.parametrize("thermal", [True, False])
def test_sharded_step_matches_jax(engine, thermal):
    """The sharded step on 4 devices: positions within 2e-5 and velocities
    within 5e-4 of their scale of pse_tpu's (sharded on gather, one-device
    on blocked); gather bitwise the port's one-device step."""
    jcfg, js, jf, tcfg, ts, tf = _problem(engine, thermal=thermal)
    draws = _jax_draws(jcfg, 0, ts.pos.shape[0]) if thermal else None
    if engine == "gather":
        jmesh = jsh.make_mesh(jax.devices("cpu")[:4])
        jnew, jinfo = jsh.make_sharded_step(jcfg, jmesh)(
            jsh.shard_state(js, jmesh),
            jax.device_put(jf, jsh.particle_sharding(jmesh)),
            T, DT, RATE, new_tilt=NEW_TILT)
    else:
        jnew, jinfo = ji.step(jcfg, js, jf, jnp.float32(T), jnp.float32(DT),
                              jnp.float32(RATE), jnp.float32(NEW_TILT))
    tnew, tinfo = tsh.make_sharded_step(tcfg, _mesh())(
        ts, tf, T, DT, RATE, new_tilt=NEW_TILT, uniforms=draws)
    assert int(tnew.nbr_overflow) == 0 and tnew.step == 1
    np.testing.assert_allclose(tnew.pos.numpy(), np.asarray(jnew.pos),
                               atol=2e-5)
    scale = np.abs(np.asarray(jinfo["velocities"])).max()
    np.testing.assert_allclose(tinfo["velocities"].numpy(),
                               np.asarray(jinfo["velocities"]),
                               atol=5e-4 * scale)
    if thermal:
        assert tinfo["m_lanczos"] == int(jinfo["m_lanczos"])
    if engine == "gather":
        one, one_info = pi.step(tcfg, ts, tf, T, DT, RATE, NEW_TILT,
                                uniforms=draws)
        assert torch.equal(tnew.pos, one.pos)
        assert torch.equal(tinfo["velocities"], one_info["velocities"])


@pytest.mark.parametrize("engine", ["blocked", "gather"])
def test_sharded_mobility_matches_jax(engine):
    """U = M F on 4 devices at tilt 0.05 within 1e-5 of its scale of
    pse_tpu's (sharded on gather, one-device on blocked); gather bitwise
    the port's one-device mobility."""
    jcfg, js, jf, tcfg, ts, tf = _problem(engine, thermal=False, tilt=0.05)
    if engine == "gather":
        jmesh = jsh.make_mesh(jax.devices("cpu")[:4])
        ps = jsh.particle_sharding(jmesh)
        ju, jov = jsh.make_sharded_mobility(jcfg, jmesh)(
            jax.device_put(js.pos, ps), jax.device_put(jf, ps), 0.05)
    else:
        ju, jov = ji.mobility(jcfg, js.pos, jf, 0.05)
    tu, tov = tsh.make_sharded_mobility(tcfg, _mesh())(ts.pos, tf, 0.05)
    assert int(tov) == 0 and not bool(jov)
    scale = np.abs(np.asarray(ju)).max()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju),
                               atol=1e-5 * scale + 1e-7)
    if engine == "gather":
        assert torch.equal(tu, pi.mobility(tcfg, ts.pos, tf, 0.05)[0])


def test_blocked_parts_hold_the_stencil_once():
    """The blocked engine's offsets split over the mesh in contiguous
    ranges (4, 4, 3, 3 of 14), each range's blocks on its device."""
    _, _, _, tcfg, ts, tf = _problem("blocked", thermal=False)
    eng = tsh.make_sharded_engine(tcfg, _mesh())
    ctx, ovf = eng.prepare(ts.pos, P.make_box(24.0, 0.03), tf)
    # no whole set of pair blocks: only the parts' blocks
    assert int(ovf) == 0 and "blocks" not in ctx._fields
    offs = [o for _, spec, _, _ in ctx.parts for o in spec.offsets]
    assert tuple(offs) == tuple(tcfg.nf_spec.offsets)
    assert [len(spec.offsets) for _, spec, _, _ in ctx.parts] == [4, 4, 3, 3]
    assert all(b.shape[0] == len(s.offsets) for _, s, _, b in ctx.parts)


@pytest.mark.parametrize("engine", ["banded", "blocked", "gather"])
def test_step_impl_with_the_configs_engine_is_step(engine):
    """step_impl(config, engine_of(config), ...) is bitwise step(...), and
    mobility_impl bitwise mobility, thermal with forces at tilt 0.03 (the
    banded engine on a 10^3 lattice, which bands)."""
    _, _, _, tcfg, ts, tf = _problem(engine, n_side=10 if engine == "banded"
                                     else 8)
    eng = pi.engine_of(tcfg)
    a, ia = pi.step(tcfg, ts, tf, T, DT, RATE, NEW_TILT)
    b, ib = pi.step_impl(tcfg, eng, ts, tf, T, DT, RATE, NEW_TILT)
    assert torch.equal(a.pos, b.pos) and ia["m_lanczos"] == ib["m_lanczos"]
    assert torch.equal(ia["velocities"], ib["velocities"])
    assert torch.equal(pi.mobility(tcfg, ts.pos, tf, 0.03)[0],
                       pi.mobility_impl(tcfg, eng, ts.pos, tf, 0.03)[0])
