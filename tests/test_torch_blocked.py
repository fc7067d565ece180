"""The port's blocked engine (Simulation's default) against the JAX package.

The specs and make_config's engine choice (banded -> blocked fallback), the
pair blocks, the cell matvec, the stored-weight far field, mobility(), the
thermal step without and with forces (JAX's psi and wave uniforms
injected), the athermal step, the overflow flag and grow_config, a
Simulation on the default engine resumed from a pse_tpu checkpoint, a
PSEv1.group subset run, stop_shear, and mobility() against the float64
oracle.  CPU only: the port's kernel wrappers run their plain versions here.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

import pse_tpu as J                          # noqa: E402
from pse_tpu import cellbins as jc           # noqa: E402
from pse_tpu import integrator as ji         # noqa: E402
from pse_tpu.ops import blocked_farfield as jbf   # noqa: E402
from pse_tpu.ops import blocked_nearfield as jbn  # noqa: E402
from pse_tpu.ops import noise as jn          # noqa: E402

import pse_tpu_torch as P                    # noqa: E402
from pse_tpu_torch import cellbins as pc     # noqa: E402
from pse_tpu_torch import integrator as pi   # noqa: E402
from pse_tpu_torch import trace              # noqa: E402
from pse_tpu_torch.ops import blocked_farfield as pbf   # noqa: E402
from pse_tpu_torch.ops import blocked_nearfield as pbn  # noqa: E402
from pse_tpu_torch.parallel.sharding import (  # noqa: E402
    _ranges as _sharding_ranges)

N, L = 1080, 24.0
ORACLE = pathlib.Path(__file__).parent / "data" / "oracle_gate.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _rel_max(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _positions(seed, n=N, box=L):
    rng = np.random.default_rng(seed)
    return rng.uniform(-box / 2, box / 2, size=(n, 3)).astype(np.float32)


def _forces(seed, n=N):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def _configs(error=1e-3, thermal=True, has_forces=True, seed=5, n=N, box=L,
             **kw):
    """JAX and port configs on the default engine."""
    jcfg = ji.make_config(J.make_params(xi=0.5, error=error, L=box), n,
                          thermal=thermal, has_forces=has_forces, seed=seed,
                          **kw)
    tcfg = pi.make_config(P.make_params(xi=0.5, error=error, L=box), n,
                          thermal=thermal, has_forces=has_forces, seed=seed,
                          device="cpu", **kw)
    assert jcfg.engine == tcfg.engine == "blocked"
    return jcfg, tcfg


@pytest.mark.parametrize("max_tilt", [0.0, 0.5])
@pytest.mark.parametrize("n,box,error", [
    (1080, 24.0, 1e-3),            # bands: banded stays banded
    (1080, 24.0, 1e-4),            # banded falls back to blocked
    (64, 24.0, 1e-3),              # too sparse to band
    (1000, 64.0, 1e-3),            # examples/run_pse.py
    (2048, 26.71, 1e-3),           # the oracle gate: 3 cells per axis
])
@pytest.mark.parametrize("engine", ["banded", "blocked"])
def test_specs_and_engine_choice_match_jax(engine, n, box, error, max_tilt):
    """make_config picks the JAX package's engine with its specs, field for
    field (make_nf_spec, make_ff_spec, make_col_spec, the band spec)."""
    jp = J.make_params(xi=0.5, error=error, L=box)
    tp = P.make_params(xi=0.5, error=error, L=box)
    jcfg = ji.make_config(jp, n, engine=engine, max_tilt=max_tilt)
    tcfg = pi.make_config(tp, n, engine=engine, max_tilt=max_tilt,
                          device="cpu")
    assert tcfg.engine == jcfg.engine
    assert tcfg.nf_spec == jcfg.nf_spec
    assert tcfg.ff_spec == jcfg.ff_spec
    assert tcfg.colff_spec == jcfg.colff_spec
    assert (tcfg.band_spec is None) == (jcfg.band_spec is None)
    if jcfg.band_spec is not None:
        assert tcfg.band_spec.bins == jcfg.band_spec.bins
    assert (tcfg.thermal, tcfg.has_forces, tcfg.m_max) == (
        jcfg.thermal, jcfg.has_forces, jcfg.m_max)
    np.testing.assert_allclose(np.array(tcfg.cheb.coeffs),
                               np.array(jcfg.cheb.coeffs), rtol=0, atol=1e-12)
    assert pbf.make_ff_spec(tp, n, device="cpu") == jbf.make_ff_spec(jp, n)
    assert pbn.make_nf_spec(n, tp.L, tp.ewald_cut, max_tilt) == \
        jbn.make_nf_spec(n, jp.L, jp.ewald_cut, max_tilt)


def _nf_inputs(error, tilt, seed=21):
    jcfg, tcfg = _configs(error=error)
    pos = _positions(seed)
    jbox, tbox = J.make_box(L, tilt), P.make_box(L, tilt)
    jbins = jc.bin_particles(jnp.asarray(pos), jbox, jcfg.nf_spec.bins)
    tbins = pc.bin_particles(torch.as_tensor(pos), tbox, tcfg.nf_spec.bins)
    return jcfg, tcfg, (jbins, jbox), (tbins, tbox)


def _stencil_part(spec, part):
    """[a, b) of spec.offsets: the whole stencil (part None) or the part-th
    of the four contiguous ranges parallel/sharding.py gives four devices
    (range 0 holds (0,0,0), range 1 does not)."""
    n = len(spec.offsets)
    return (0, n) if part is None else _sharding_ranges(n, 4)[part]


@pytest.mark.parametrize("part", [None, 0, 1])
@pytest.mark.parametrize("tilt", [0.0, 0.3])
@pytest.mark.parametrize("error,bound", [(1e-3, 2.0 ** -8),   # bf16 blocks
                                         (1e-4, 1e-6)])       # f32 blocks
def test_build_pair_blocks_matches_jax(error, bound, tilt, part):
    """The (noff, 6, C, cap, cap) blocks in the block dtype, in max |diff|
    / max |JAX| (bf16: one rounding step where the float32 values differ in
    their last bit); over the whole stencil and over a contiguous part of
    it, as a sharded engine builds its own offsets, against that part of
    the JAX package's whole build."""
    jcfg, tcfg, (jbins, jbox), (tbins, tbox) = _nf_inputs(error, tilt)
    p = jcfg.params
    a, b = _stencil_part(tcfg.nf_spec, part)
    want = jbn.build_pair_blocks(jbins, jbox, jcfg.nf_spec, jcfg.cheb,
                                 p.ewald_cut, p.ewald_dr)[a:b]
    spec = tcfg.nf_spec._replace(offsets=tcfg.nf_spec.offsets[a:b])
    got = pbn.build_pair_blocks(tbins, tbox, spec, tcfg.cheb, p.ewald_cut,
                                p.ewald_dr)
    assert got.shape == want.shape
    assert got.dtype == getattr(torch, jcfg.nf_spec.block_dtype)
    assert _rel_max(got.float().numpy(), want.astype(jnp.float32)) <= bound


@pytest.mark.parametrize("error", [1e-3, 1e-4])
def test_build_pair_blocks_on_cpu_is_the_plain_path(error):
    """On CPU tensors build_pair_blocks is build_pair_blocks_reference, bit
    for bit, and launches no kernel (the card's kernel counts
    launch.build_pair_blocks)."""
    _, tcfg, _, (tbins, tbox) = _nf_inputs(error, 0.3)
    p = tcfg.params
    args = (tbins, tbox, tcfg.nf_spec, tcfg.cheb, p.ewald_cut, p.ewald_dr)
    before = trace.counters().get("launch.build_pair_blocks", 0)
    got = pbn.build_pair_blocks(*args)
    assert trace.counters().get("launch.build_pair_blocks", 0) == before
    assert torch.equal(got, pbn.build_pair_blocks_reference(*args))


@pytest.mark.parametrize("part", [None, 1])
@pytest.mark.parametrize("error", [1e-3, 1e-4])
def test_matvec_cells_on_cpu_is_the_plain_path(error, part):
    """On CPU tensors matvec_cells is matvec_cells_reference, bit for bit,
    over the whole half stencil and over a sharding part that starts past
    (0,0,0) with a self term of 0.0, and launches no kernel (the card's
    kernel counts launch.matvec_cells)."""
    _, tcfg, _, (tbins, tbox) = _nf_inputs(error, 0.3)
    p = tcfg.params
    a, b = _stencil_part(tcfg.nf_spec, part)
    spec = tcfg.nf_spec._replace(offsets=tcfg.nf_spec.offsets[a:b])
    blocks = pbn.build_pair_blocks(tbins, tbox, spec, tcfg.cheb,
                                   p.ewald_cut, p.ewald_dr)
    f = torch.as_tensor(np.random.default_rng(4).normal(
        size=(3,) + tuple(tbins.px.shape)).astype(np.float32)) * tbins.mask
    self_m = p.self_mobility if a == 0 else 0.0
    before = trace.counters().get("launch.matvec_cells", 0)
    got = pbn.matvec_cells(blocks, spec, tbins, f, self_m)
    assert trace.counters().get("launch.matvec_cells", 0) == before
    want = pbn.matvec_cells_reference(blocks, spec, tbins, f, self_m)
    assert torch.equal(got, want)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("error", [1e-3, 1e-4])
def test_matvec_cells_matches_jax(error):
    """u = M_real f on the JAX package's own blocks: <= 1e-5."""
    jcfg, tcfg, (jbins, jbox), (tbins, _) = _nf_inputs(error, 0.3)
    p = jcfg.params
    blocks = jbn.build_pair_blocks(jbins, jbox, jcfg.nf_spec, jcfg.cheb,
                                   p.ewald_cut, p.ewald_dr)
    f = np.random.default_rng(3).normal(
        size=(3,) + tuple(tbins.px.shape)).astype(np.float32)
    f *= tbins.mask.numpy()
    want = jbn.matvec_cells(blocks, jcfg.nf_spec, jbins, jnp.asarray(f),
                            p.self_mobility)
    tb = torch.as_tensor(np.array(blocks.astype(jnp.float32))).to(
        getattr(torch, jcfg.nf_spec.block_dtype))
    got = pbn.matvec_cells(tb, tcfg.nf_spec, tbins, torch.as_tensor(f),
                           p.self_mobility)
    assert _rel_max(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_stored_weight_far_field_matches_jax(tilt):
    """build_weights, spread_blocked and contract_blocked (stored weights,
    and built per offset without them): <= 1e-5."""
    jcfg, tcfg = _configs()
    jp, spec = jcfg.params, jcfg.ff_spec
    pos, forces = _positions(23), _forces(24)
    jbox, tbox = J.make_box(L, tilt), P.make_box(L, tilt)
    jbins, jf = jc.bin_particles(jnp.asarray(pos), jbox, spec.bins,
                                 values=jnp.asarray(forces))
    tbins, tf = pc.bin_particles(torch.as_tensor(pos), tbox, spec.bins,
                                 values=torch.as_tensor(forces))
    jw = jbf.build_weights(jbins, jbox, spec, jp)
    tw = pbf.build_weights(tbins, tbox, tcfg.ff_spec, tcfg.params)
    assert _rel_max(tw.numpy(), jw) <= 1e-5
    grid = np.random.default_rng(25).normal(
        size=(3, jp.Nx, jp.Ny, jp.Nz)).astype(np.float32)
    want_s = jbf.spread_blocked(jbins, jf, jbox, spec, jp, weights=jw)
    want_c = jbf.contract_blocked(jbins, jnp.asarray(grid), jbox, spec, jp,
                                  weights=jw)
    for w in (tw, None):
        got_s = pbf.spread_blocked(tbins, tf, tbox, tcfg.ff_spec,
                                   tcfg.params, weights=w)
        got_c = pbf.contract_blocked(tbins, torch.as_tensor(grid), tbox,
                                     tcfg.ff_spec, tcfg.params, weights=w)
        assert _rel_max(got_s.numpy(), want_s) <= 1e-5
        assert _rel_max(got_c.numpy(), want_c) <= 1e-5


@pytest.mark.parametrize("tilt", [0.0, 0.3])
@pytest.mark.parametrize("error,far", [(1e-3, "column"), (1e-4, "column"),
                                       (1e-3, "stored")])
def test_mobility_matches_jax(error, far, tilt):
    """U = M F on the blocked engine (bf16 and f32 blocks; the z-column far
    field, or the stored-weight one where colff_spec is None): <= 1e-5."""
    jcfg, tcfg = _configs(error=error, thermal=False)
    if far == "stored":
        jcfg = dataclasses.replace(jcfg, colff_spec=None)
        tcfg = dataclasses.replace(tcfg, colff_spec=None)
    pos, forces = _positions(11), _forces(12)
    uj, oj = ji.mobility(jcfg, pos, forces, tilt)
    ut, ot = pi.mobility(tcfg, pos, forces, tilt)
    assert int(ot) == int(oj) == 0
    assert _rel(ut.numpy(), uj) <= 1e-5


def _jax_draws(cfg, step):
    """The uniforms JAX's step draws (integrator.py step_impl), psi in the
    blocked engine's (3, C, cap) cell slots."""
    key = jax.random.fold_in(jax.random.PRNGKey(ji.hash_seed(cfg.seed)),
                             jnp.asarray(step, jnp.int32))
    k_psi, k_grid = jax.random.split(key)
    bs, p = cfg.nf_spec.bins, cfg.params
    psi = jn.particle_noise_t(k_psi, (bs.n_cells_total, bs.cap))
    wave = jax.random.uniform(k_grid, (6, p.Nx, p.Ny, p.Nz // 2 + 1),
                              dtype=jnp.float32, minval=-jn.SQRT3D2,
                              maxval=jn.SQRT3D2)
    return np.asarray(psi), np.asarray(wave)


@pytest.mark.parametrize("thermal,has_forces,tilt,rate,new_tilt,step,m0", [
    (True, False, 0.0, 0.0, None, 0, 2),       # brownian, probe step
    (True, True, 0.3, 0.7, 0.31, 5, 7),        # with forces, sheared
    (False, True, 0.3, 0.7, None, 2, 5),       # athermal
])
def test_step_matches_jax(thermal, has_forces, tilt, rate, new_tilt, step,
                          m0):
    """Velocities to 1e-4 relative with equal m_lanczos, positions, images
    and the overflow mask."""
    jcfg, tcfg = _configs(thermal=thermal, has_forces=has_forces)
    js = ji.make_state(_positions(3), step=step, tilt_xy=tilt)._replace(
        m_lanczos=jnp.asarray(m0, jnp.int32))
    ts = pi.state_from_arrays({k: np.asarray(v)
                               for k, v in js._asdict().items()},
                              device="cpu")
    forces = _forces(13) if has_forces else np.zeros((N, 3), np.float32)
    jnew, jinfo = ji.step(jcfg, js, jnp.asarray(forces), 1.0 if thermal
                          else 0.0, 1e-3, rate, new_tilt)
    tnew, tinfo = pi.step(tcfg, ts, torch.as_tensor(forces) if has_forces
                          else None, 1.0 if thermal else 0.0, 1e-3, rate,
                          new_tilt,
                          uniforms=_jax_draws(jcfg, step) if thermal else None)
    assert tinfo["m_lanczos"] == int(jinfo["m_lanczos"])
    assert _rel(tinfo["velocities"].numpy(), jinfo["velocities"]) <= 1e-4
    # positions move by v dt: a bf16 block entry one rounding step apart
    # (the JAX step is jitted, its fused float32 arithmetic may differ in
    # the last bit) moves a thermal velocity of ~40 by ~1e-2
    np.testing.assert_allclose(tnew.pos.numpy(), np.asarray(jnew.pos),
                               atol=5e-5)
    np.testing.assert_array_equal(tnew.images.numpy(),
                                  np.asarray(jnew.images))
    assert tnew.tilt_xy == float(jnew.tilt_xy)
    assert int(tnew.nbr_overflow) == int(jnew.nbr_overflow) == 0


def test_blocked_overflow_flag():
    """Overfull cells raise the fill's flag and the blocked engine's OVF_NF
    bit, as tests/test_blocked.py::test_blocked_overflow_flag holds the JAX
    package's."""
    pos = np.random.default_rng(7).uniform(-5, 5, size=(200, 3)).astype(
        np.float32)
    spec = pc.BinSpec(n_cells=(3, 3, 3), cap=8)
    bins = pc.bin_particles(torch.as_tensor(pos), P.make_box(10.0), spec)
    jbins = jc.bin_particles(jnp.asarray(pos), J.make_box(10.0),
                             jc.BinSpec(n_cells=(3, 3, 3), cap=8))
    assert bool(bins.overflow) and bool(jbins.overflow)
    _, tcfg = _configs(thermal=False)
    tcfg = dataclasses.replace(tcfg, nf_spec=tcfg.nf_spec._replace(
        bins=tcfg.nf_spec.bins._replace(cap=8)))
    _, ovf = pi.mobility(tcfg, _positions(8), _forces(9))
    assert int(ovf) == pi.OVF_NF
    sim = P.Simulation(positions=_positions(8), L=L, dt=1e-3, device="cpu")
    sim.set_integrator(P.PSEv1(T=0.0), verbose=False)
    sim.config = tcfg
    with pytest.raises(RuntimeError, match=r"overflow in mobility \(nf_spec\)"):
        sim.mobility_matvec(torch.as_tensor(_forces(9)))


@pytest.mark.parametrize("flags", [ji.OVF_NF, ji.OVF_FF,
                                   ji.OVF_NF | ji.OVF_FF | ji.OVF_LANCZOS])
def test_grow_config_matches_jax(flags):
    """OVF_NF grows the cell cap, OVF_FF both far-field caps, as pse_tpu's
    grow_config does."""
    jcfg, tcfg = _configs()
    for _ in range(2):
        jcfg = ji.grow_config(jcfg, flags=flags)
        tcfg = pi.grow_config(tcfg, flags=flags)
        assert tcfg.nf_spec == jcfg.nf_spec
        assert tcfg.ff_spec == jcfg.ff_spec
        assert tcfg.colff_spec == jcfg.colff_spec
        assert tcfg.m_max == jcfg.m_max


def _gravity(n):
    return np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n, 1))


def test_default_engine_simulation_resumes_a_pse_tpu_checkpoint(tmp_path):
    """Simulation.set_integrator(integrate.PSEv1(...)) with no engine runs
    the blocked engine; an athermal run with forces resumed from a
    checkpoint written by pse_tpu lands where pse_tpu's does."""
    pos = _positions(31)
    g = _gravity(N)
    jsim = J.Simulation(positions=pos, L=L, dt=1e-3, sync_every=2,
                        force_fn=lambda p, t: jnp.asarray(g))
    jsim.set_integrator(J.integrate.PSEv1(T=0.0, seed=1), verbose=False)
    jsim.run(1)
    path = tmp_path / "jax.npz"
    jsim.save(str(path))
    jsim.run(2)
    sim = P.Simulation(positions=pos, L=L, dt=1e-3, sync_every=2,
                       force_fn=lambda p, t: torch.as_tensor(g),
                       device="cpu")
    sim.set_integrator(P.integrate.PSEv1(T=0.0, seed=1), verbose=False)
    assert sim.config.engine == jsim.config.engine == "blocked"
    sim.restore(str(path))
    sim.run(2)
    assert sim.snapshot()["step"] == 3
    np.testing.assert_allclose(sim.snapshot()["pos"],
                               np.asarray(jsim.state.pos), atol=1e-5)
    u = sim.mobility_matvec(torch.as_tensor(g))
    assert _rel(u.numpy(), jsim.mobility_matvec(jnp.asarray(g))) <= 1e-5


def test_group_subset_run_matches_jax():
    """PSEv1.group: the members are the hydrodynamic system (specs sized
    for them), the others stay put while force_fn sees every particle."""
    pos = _positions(33)
    group = np.arange(0, N, 2)
    f = _forces(34)

    def jforce(p, t):
        return jnp.asarray(f) - 0.1 * p

    def tforce(p, t):
        return torch.as_tensor(f) - 0.1 * p

    jsim = J.Simulation(positions=pos, L=L, dt=1e-3, force_fn=jforce)
    jsim.set_integrator(J.integrate.PSEv1(T=0.0, group=group),
                        verbose=False)
    sim = P.Simulation(positions=pos, L=L, dt=1e-3, force_fn=tforce,
                       device="cpu")
    sim.set_integrator(P.integrate.PSEv1(T=0.0, group=group), verbose=False)
    assert sim.config.nf_spec == jsim.config.nf_spec
    jsim.run(2)
    sim.run(2)
    got, want = sim.snapshot()["pos"], np.asarray(jsim.state.pos)
    np.testing.assert_allclose(got, want, atol=1e-5)
    rest = np.setdiff1d(np.arange(N), group)
    np.testing.assert_array_equal(got[rest], pos[rest])
    assert np.abs(got[group] - pos[group]).max() > 1e-5
    with pytest.raises(ValueError, match="group indices"):
        sim.set_integrator(P.PSEv1(group=[N]), verbose=False)


def test_stop_shear_matches_jax():
    """stop_shear swaps the protocol for zero steady shear at the built
    max_strain, as pse_tpu's does; the box stops tilting."""
    pos = _positions(35)
    sims = []
    for pkg, kw in ((J, {}), (P, {"device": "cpu"})):
        sim = pkg.Simulation(positions=pos, L=L, dt=1e-3, **kw)
        sim.set_integrator(pkg.integrate.PSEv1(
            T=0.0, max_strain=0.4, function_form=pkg.shear_function.sine(
                dt=1e-3, shear_rate=5.0, shear_freq=1.0)), verbose=False)
        sim.stop_shear()
        sims.append(sim)
    (jsim, sim) = sims
    assert type(sim.method.function_form).__name__ == "SteadyShear"
    assert sim.method.max_strain == jsim.method.max_strain == 0.4
    for t in (0, 7, 100):
        assert sim.method.shear_rate(t) == jsim.method.shear_rate(t) == 0.0
    sim.run(1)
    np.testing.assert_array_equal(sim.snapshot()["pos"], pos)    # M·0
    with pytest.raises(ValueError, match="max_strain"):
        sim.stop_shear(max_strain=0.5)


def test_blocked_mobility_matches_the_f64_oracle():
    """engine="blocked" U = M F at the oracle gate (N = 2048: 3 x 3 x 3
    cells of cap 128) against the float64 direct-Ewald u_ref: <= 5e-3."""
    d = np.load(ORACLE)
    params = P.make_params(xi=float(d["xi"]), error=1e-3, L=float(d["L"]))
    cfg = pi.make_config(params, int(d["n"]), thermal=False,
                         engine="blocked", device="cpu")
    assert cfg.nf_spec.bins == pc.BinSpec(n_cells=(3, 3, 3), cap=128)
    u, ovf = pi.mobility(cfg, d["pos"], d["forces"])
    assert int(ovf) == 0
    assert _rel(u.numpy(), d["u_ref"]) < 5e-3
