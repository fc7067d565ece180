"""The banded engine's occupancy classes and StepConfig's defaults in the
PyTorch port against the JAX package, on the CPU.

The host side of the classes (``measure_col_counts``, ``make_slab_counts``,
``make_band_classes``, ``class_segments``, ``class_assignment``,
``_size_slab_classes`` and ``make_config(positions=...)`` at the main
path's N = 100k) must equal ``pse_tpu``'s exactly; ``grow_config`` and
``Simulation.run`` drop and re-measure them as ``pse_tpu`` does; a banded
CPU step and ``mobility()`` with classes set equal the JAX package's (both
ignore the classes off their kernels).  The class-packed kernels themselves
run on the card only (tests/test_torch_cuda.py, chip_smoke.py
[classes-small]); here the packed layout's host helpers are checked.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                      # noqa: E402

import pse_tpu as J                          # noqa: E402
from pse_tpu import api as japi              # noqa: E402
from pse_tpu import integrator as ji         # noqa: E402
from pse_tpu import neighbors as jnb         # noqa: E402
from pse_tpu.ops import banded_nearfield as jb   # noqa: E402

import pse_tpu_torch as P                    # noqa: E402
from pse_tpu_torch import api as tapi        # noqa: E402
from pse_tpu_torch import integrator as pi   # noqa: E402
from pse_tpu_torch import neighbors as tnb   # noqa: E402
from pse_tpu_torch.ops import banded_nearfield as tb   # noqa: E402

N_MAIN, PHI = 100_000, 0.45


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench_lattice(n=N_MAIN, phi=PHI, seed=0):
    """bench.py's make_positions: a vacancy-diluted simple-cubic lattice."""
    vol = n * (4.0 / 3.0) * math.pi / phi
    L = vol ** (1.0 / 3.0)
    n_side = int(math.ceil(n ** (1.0 / 3.0)))
    a = L / n_side
    grid = (np.arange(n_side) + 0.5) * a - L / 2.0
    x, y, z = np.meshgrid(grid, grid, grid, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    rng = np.random.default_rng(seed)
    keep = rng.choice(pos.shape[0], size=n, replace=False)
    pos = pos[np.sort(keep)]
    pos += rng.normal(scale=0.05 * a, size=pos.shape)
    return pos.astype(np.float32), L


@pytest.fixture(scope="module")
def main_path():
    """(positions, L, JAX single-class spec, the port's) at N = 100k."""
    pos, L = _bench_lattice()
    jp = J.make_params(xi=0.5, error=1e-3, L=L)
    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    js = jb.make_band_spec(N_MAIN, jp.L, jp.ewald_cut, max_tilt=0.5)
    ts = tb.make_band_spec(N_MAIN, tp.L, tp.ewald_cut, max_tilt=0.5)
    assert tuple(js) == tuple(ts)
    return pos, L, js, ts


def _same_spec(a, b):
    """The port's BandSpec equals the JAX package's, field by field."""
    if a is None or b is None:
        return a is None and b is None
    assert a._fields == b._fields
    return all(getattr(a, f) == getattr(b, f) for f in a._fields)


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_measure_col_counts_matches_jax(main_path, tilt):
    pos, L, js, ts = main_path
    want = jb.measure_col_counts(js, pos, (L,) * 3, tilt=tilt)
    got = tb.measure_col_counts(ts, pos, (L,) * 3, tilt=tilt)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == N_MAIN


@pytest.mark.parametrize("n_slabs", [1, 2, 3])
def test_make_slab_counts_matches_jax(main_path, n_slabs):
    pos, L, js, ts = main_path
    counts = jb.measure_col_counts(js, pos, (L,) * 3)
    np.testing.assert_array_equal(tb.make_slab_counts(ts, n_slabs, counts),
                                  jb.make_slab_counts(js, n_slabs, counts))


def _class_cases(main_path):
    """(name, JAX spec, port spec, n, counts) covering the measured 1-D and
    2-D choosers, the Poisson model and the branches that leave the spec
    as it was (the Poisson model's c1 <= 0 and average-saving exits are
    not reached at C = 216, t_cap = 18 for any N from 14k to 120k)."""
    pos, L, js, ts = main_path
    counts = jb.measure_col_counts(js, pos, (L,) * 3)
    C = js.bins.n_cells[0] * js.bins.n_cells[1]
    R, t_cap = js.rows, js.bins.cap // js.rows
    rng = np.random.default_rng(3)
    uniform = rng.multinomial(N_MAIN, np.full(C, 1.0 / C))
    both = lambda **kw: (js._replace(**kw), ts._replace(**kw))   # noqa: E731
    small = both(bins=js.bins._replace(n_cells=(4, 7, 1)))       # C = 28
    short = both(bins=js.bins._replace(cap=5 * R))               # t_cap 5
    full = np.full(C, t_cap * R)                                 # all at cap
    return [
        ("measured 1-D", js, ts, N_MAIN, counts),
        ("measured uniform", js, ts, N_MAIN, uniform),
        ("measured 2-D, one slab", *both(bins=js.bins._replace(
            n_cells=(14, 18, 1))), 116_667,
         jb.make_slab_counts(js, 1, counts)),
        ("poisson", js, ts, N_MAIN, None),
        ("poisson dense", js, ts, 105_000, None),
        ("leave: no spec", None, None, N_MAIN, None),
        ("leave: classes set", *both(classes=((17, C - 5), (18, 5))),
         N_MAIN, counts),
        ("leave: C < 32", *small, N_MAIN, None),
        ("leave: t_cap < 6", *short, N_MAIN, None),
        ("leave: mu < 64", js, ts, 64 * C - 1, None),
        ("leave: counts of another grid", js, ts, N_MAIN, counts[:-1]),
        ("leave: a column past the cap", js, ts, N_MAIN,
         np.where(np.arange(C) == 0, t_cap * R + 1, counts)),
        ("leave: every column at the cap", js, ts, N_MAIN, full),
        ("leave: measured 2-D, two slabs", *both(bins=js.bins._replace(
            n_cells=(8, 18, 1))), 66_667, jb.make_slab_counts(js, 2, counts)),
        ("leave: poisson t2 >= t_cap", js, ts, 110_000, None),
    ]


def test_make_band_classes_matches_jax_in_every_branch(main_path):
    for name, js, ts, n, counts in _class_cases(main_path):
        want = jb.make_band_classes(js, n, counts)
        got = tb.make_band_classes(ts, n, counts)
        assert _same_spec(got, want), name
        if name.startswith("leave"):
            assert got is ts, name
        else:
            assert got.classes is not None and got.classes != ts.classes, name
            assert sum(c for _, c in got.classes) == (
                ts.bins.n_cells[0] * ts.bins.n_cells[1])


def test_class_segments_matches_jax(main_path):
    pos, L, js, ts = main_path
    for counts in (jb.measure_col_counts(js, pos, (L,) * 3), None):
        jc = jb.make_band_classes(js, N_MAIN, counts)
        tc = tb.make_band_classes(ts, N_MAIN, counts)
        assert tb.class_segments(tc) == jb.class_segments(jc)


@pytest.mark.parametrize("case", ["ties", "overflow", "lattice"])
def test_class_assignment_matches_jax(main_path, case):
    """perm, inv and the overflow flag bit for bit: need ties break by
    ascending column id, and a top class too small flags."""
    pos, L, js, ts = main_path
    C = js.bins.n_cells[0] * js.bins.n_cells[1]
    R, t_cap = js.rows, js.bins.cap // js.rows
    rng = np.random.default_rng(5)
    classes = ((15, 137), (16, 64), (18, 15))
    if case == "ties":              # few distinct needs, many ties, empties
        nv = rng.choice([0, 1, 14 * R, 15 * R, 16 * R, 17 * R + 3], size=C,
                        p=[0.2, 0.2, 0.3, 0.2, 0.05, 0.05])
    elif case == "overflow":        # 20 columns need the top class's 18
        nv = np.full(C, 14 * R)
        nv[rng.choice(C, 20, replace=False)] = t_cap * R
    else:
        nv = jb.measure_col_counts(js, pos, (L,) * 3)
        classes = jb.make_band_classes(js, N_MAIN, nv).classes
    jspec, tspec = js._replace(classes=classes), ts._replace(classes=classes)
    jperm, jinv, jovf = jb.class_assignment(jspec,
                                            jnp.asarray(nv, jnp.int32))
    perm, inv, ovf = tb.class_assignment(tspec,
                                         torch.as_tensor(nv, dtype=torch.int32))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert bool(ovf) == bool(jovf) == (case == "overflow")
    assert perm.dtype == inv.dtype == torch.int32


@pytest.mark.parametrize("n_slabs", [1, 2, 3])
def test_size_slab_classes_matches_jax(main_path, n_slabs):
    pos, L, js, ts = main_path
    counts = jb.measure_col_counts(js, pos, (L,) * 3)
    for c in (counts, None):
        assert _same_spec(pi._size_slab_classes(ts, n_slabs, N_MAIN, c),
                          ji._size_slab_classes(js, n_slabs, N_MAIN, c))


def test_make_config_sizes_the_main_paths_classes_as_jax(main_path):
    """make_config(engine="banded") at N = 100k, from the measured lattice
    and from the Poisson model: the JAX package's band_spec, field by
    field."""
    pos, L, _, _ = main_path
    jp = J.make_params(xi=0.5, error=1e-3, L=L)
    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    for positions in (pos, None):
        jc = ji.make_config(jp, N_MAIN, engine="banded", positions=positions)
        tc = pi.make_config(tp, N_MAIN, engine="banded", positions=positions,
                            device="cpu")
        assert tc.engine == jc.engine == "banded"
        assert _same_spec(tc.band_spec, jc.band_spec)
        assert tc.band_spec.classes is not None
        assert tc.shard_slabs == jc.shard_slabs == 1
    assert pi.make_config(tp, N_MAIN, engine="banded", positions=pos,
                          device="cpu").band_spec.classes == (
        (13, 36), (15, 26), (17, 44), (18, 110))


@pytest.mark.parametrize("flags", [
    pi.OVF_CLASS, pi.OVF_BAND, pi.OVF_NF, pi.OVF_FF, pi.OVF_CLASS | pi.OVF_FF,
    None])
def test_grow_config_drops_classes_as_jax(main_path, flags):
    """OVF_CLASS drops the classes to one, and so does a band that grows;
    other flags keep them."""
    pos, L, _, _ = main_path
    jp = J.make_params(xi=0.5, error=1e-3, L=L)
    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    jc = ji.make_config(jp, N_MAIN, engine="banded", positions=pos)
    tc = pi.make_config(tp, N_MAIN, engine="banded", positions=pos,
                        device="cpu")
    jg = ji.grow_config(jc, flags=flags)
    tg = pi.grow_config(tc, flags=flags)
    assert _same_spec(tg.band_spec, jg.band_spec)
    drops = flags is None or flags & (pi.OVF_CLASS | pi.OVF_BAND | pi.OVF_NF)
    assert (tg.band_spec.classes is None) == bool(drops)
    assert (tg.band_spec.slab_classes is None) == bool(drops)
    assert tg.m_max == jg.m_max
    assert ji.OVF_CLASS == pi.OVF_CLASS == 32


def _fake_step(bit, seen):
    """A step that moves nothing and sets ``bit`` while the config has
    classes, recording each config's classes: Simulation.run's control flow
    without the physics."""

    def step(config, state, forces, T, dt, rate, new_tilt=None):
        classes = config.band_spec.classes
        seen.append(classes)
        flag = bit if classes is not None else 0
        if isinstance(state.pos, torch.Tensor):
            ovf = torch.as_tensor(flag, dtype=torch.int32)
            return (state._replace(step=state.step + 1,
                                   nbr_overflow=state.nbr_overflow | ovf),
                    {"m_lanczos": 2, "nbr_overflow": ovf})
        ovf = jnp.asarray(flag, jnp.int32)
        return (state._replace(step=state.step + 1,
                               nbr_overflow=state.nbr_overflow | ovf),
                {"m_lanczos": jnp.asarray(2, jnp.int32), "nbr_overflow": ovf})
    return step


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_run_remeasures_classes_twice_then_keeps_one(main_path, monkeypatch,
                                                     tilt):
    """A forced OVF_CLASS on every step with classes: run() rewinds, drops
    the classes and re-measures them from the snapshot at its tilt, at most
    twice, then keeps one class, as pse_tpu's Simulation.run does."""
    pos, L, _, _ = main_path
    seen_j, seen_t = [], []
    monkeypatch.setattr(japi, "_step", _fake_step(ji.OVF_CLASS, seen_j))
    monkeypatch.setattr(tapi, "_step", _fake_step(pi.OVF_CLASS, seen_t))
    method = dict(T=1.0, seed=1, xi=0.5, error=1e-3)
    jsim = J.Simulation(positions=pos, L=L, dt=1e-3, sync_every=2,
                        tilt_xy=tilt)
    jsim.set_integrator(J.integrate.PSEv1(**method), engine="banded",
                        verbose=False)
    tsim = P.Simulation(positions=pos, L=L, dt=1e-3, sync_every=2,
                        tilt_xy=tilt, device="cpu")
    tsim.set_integrator(P.PSEv1(**method), engine="banded", verbose=False)
    assert _same_spec(tsim.config.band_spec, jsim.config.band_spec)
    assert tsim.config.band_spec.classes is not None
    jsim.run(4)
    tsim.run(4)
    assert tsim.metrics["overflow_retries"] == 3
    assert tsim.metrics["overflow_retries"] == jsim.metrics["overflow_retries"]
    assert tsim._class_regrows == jsim._class_regrows == 2
    assert tsim.config.band_spec.classes is None
    assert _same_spec(tsim.config.band_spec, jsim.config.band_spec)
    # three chunks of 2 steps with classes (sized at set_integrator from
    # the untilted measure, as in the JAX package, then twice re-measured
    # at the snapshot's tilt), then the single class for the 4 steps
    assert seen_t.count(None) == 4
    with_cls = [c for c in seen_t if c is not None]
    assert len(with_cls) == 6
    remeasured = tb.make_band_classes(
        tsim.config.band_spec, N_MAIN,
        tb.measure_col_counts(tsim.config.band_spec, pos, (L,) * 3,
                              tilt=np.float32(tilt))).classes
    assert with_cls[2:] == [remeasured] * 4
    assert tsim.metrics["steps"] == 4 and int(tsim.state.nbr_overflow) == 0


def _band_configs(classes):
    """The N = 1080, L = 24 banded configs with a manual 2-class split
    (its C = 12 columns are too few for the chooser)."""
    n, L = 1080, 24.0
    jcfg = ji.make_config(J.make_params(xi=0.5, error=1e-3, L=L), n,
                          thermal=True, engine="banded", seed=5)
    tcfg = pi.make_config(P.make_params(xi=0.5, error=1e-3, L=L), n,
                          thermal=True, engine="banded", seed=5,
                          device="cpu")
    bs = tcfg.band_spec
    assert bs.classes is None
    if classes:
        C = bs.bins.n_cells[0] * bs.bins.n_cells[1]
        t_cap = bs.bins.cap // bs.rows
        split = ((t_cap - 1, C - 2), (t_cap, 2))
        jcfg = dataclasses.replace(
            jcfg, band_spec=jcfg.band_spec._replace(classes=split))
        tcfg = dataclasses.replace(
            tcfg, band_spec=bs._replace(classes=split))
    return jcfg, tcfg


def _jax_draws(cfg, step):
    """The uniforms JAX's step draws (integrator.py step_impl)."""
    import jax

    from pse_tpu.ops import noise as jn

    key = jax.random.fold_in(jax.random.PRNGKey(ji.hash_seed(cfg.seed)),
                             jnp.asarray(step, jnp.int32))
    k_psi, k_grid = jax.random.split(key)
    bs, p = cfg.band_spec.bins, cfg.params
    psi = jn.particle_noise_t(k_psi, (bs.n_cells[0] * bs.n_cells[1], bs.cap))
    wave = jax.random.uniform(k_grid, (6, p.Nx, p.Ny, p.Nz // 2 + 1),
                              dtype=jnp.float32, minval=-jn.SQRT3D2,
                              maxval=jn.SQRT3D2)
    return np.asarray(psi), np.asarray(wave)


def test_banded_cpu_step_and_mobility_with_classes_match_jax():
    """Off their kernels both packages ignore the classes: the with-forces
    step (JAX's draws injected) and mobility() equal the JAX package's,
    and the port's own results equal its single-class ones bitwise."""
    jcfg, tcfg = _band_configs(True)
    _, tcfg1 = _band_configs(False)
    n, L = 1080, 24.0
    rng = np.random.default_rng(13)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    F = rng.normal(size=(n, 3)).astype(np.float32)
    uj, oj = ji.mobility(jcfg, pos, F, 0.2)
    ut, ot = pi.mobility(tcfg, pos, F, 0.2)
    u1, _ = pi.mobility(tcfg1, pos, F, 0.2)
    assert int(ot) == int(oj) == 0
    assert np.linalg.norm(ut.numpy() - uj) / np.linalg.norm(uj) < 1e-5
    assert torch.equal(ut, u1)
    js = ji.make_state(pos, step=3, tilt_xy=0.2)
    ts = pi.state_from_arrays({k: np.asarray(v)
                               for k, v in js._asdict().items()},
                              device="cpu")
    jnew, jinfo = ji.step(jcfg, js, jnp.asarray(F), 1.0, 1e-3, 0.5)
    draws = _jax_draws(jcfg, 3)
    tnew, tinfo = pi.step(tcfg, ts, torch.as_tensor(F), 1.0, 1e-3, 0.5,
                          uniforms=draws)
    t1, _ = pi.step(tcfg1, ts, torch.as_tensor(F), 1.0, 1e-3, 0.5,
                    uniforms=draws)
    assert tinfo["m_lanczos"] == int(jinfo["m_lanczos"])
    vj = np.asarray(jinfo["velocities"])
    assert np.linalg.norm(tinfo["velocities"].numpy() - vj) \
        / np.linalg.norm(vj) < 1e-4
    assert int(tnew.nbr_overflow) == int(jnew.nbr_overflow) == 0
    assert torch.equal(tnew.pos, t1.pos)


def test_packed_layout_helpers():
    """The class layout the kernels take: one allocation of per-class views
    in packed order, checked by _blocks_base; pack_blocks_reference cuts a
    full A into it; pack= must come with classes and only with them; the
    build alone stays single-class."""
    _, tcfg = _band_configs(True)
    bs = tcfg.band_spec
    C, S, R, W = 12, bs.bins.cap, bs.rows, bs.window
    blocks = tb._alloc_blocks(bs, "cpu")
    assert [tuple(b.shape) for b in blocks] == [
        (1, ck, 2, tk * R, tb.N_HALF * W) for tk, ck, _ in
        tb.class_segments(bs)]
    assert tb._blocks_base(blocks, bs) is blocks[0]
    with pytest.raises(ValueError, match="one allocation"):
        tb._blocks_base(tuple(b.clone() for b in blocks), bs)
    with pytest.raises(ValueError, match="one allocation"):
        tb._blocks_base(blocks[::-1], bs)
    full = torch.arange(2 * C * S * tb.N_HALF * W, dtype=torch.float32
                        ).reshape(1, C, 2, S, tb.N_HALF * W)
    perm = torch.as_tensor([3, 0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11])
    packed = tb.pack_blocks_reference(full, bs, perm)
    (t0, c0, _), (t1, c1, o1) = tb.class_segments(bs)
    assert torch.equal(packed[0], full[:, [3, 0], :, :t0 * R])
    assert torch.equal(packed[1][0, 0], full[0, 1, :, :t1 * R])
    nv = torch.full((C,), 40, dtype=torch.int32)
    pack = tb.class_assignment(bs, nv)[:2]
    with pytest.raises(ValueError, match="pack"):
        tb._class_args(bs, None)
    with pytest.raises(ValueError, match="pack"):
        tb._class_args(bs._replace(classes=None), pack)
    p, n, tiles, cols = tb._class_args(bs, pack)
    assert n == 2 and list(tiles) == [t0, t1] and list(cols) == [c0, c1]
    with pytest.raises(ValueError, match="single-class"):
        tb.build_banded_blocks(None, 0.0, bs, None, None, None, None, None,
                               None, None)


def test_step_config_takes_the_jax_defaults_and_order():
    """StepConfig's fields, defaults and order are pse_tpu's, device last;
    a banded or blocked config without its spec raises, naming it."""
    jf = [(f.name, f.default) for f in dataclasses.fields(ji.StepConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(pi.StepConfig)]
    assert [n for n, _ in tf] == [n for n, _ in jf] + ["device"]
    assert tf[:-1] == jf and tf[-1] == ("device", "cuda")
    tp = P.make_params(xi=0.5, error=1e-3, L=20.0)
    ts = tnb.make_spec(64, tp.L, tp.ewald_cut)
    for engine, spec in (("banded", "band_spec"), ("blocked", "nf_spec")):
        with pytest.raises(ValueError, match=spec):
            pi.StepConfig(params=tp, nbr_spec=ts, engine=engine,
                          device="cpu")
    with pytest.raises(ValueError, match="engine"):
        pi.StepConfig(params=tp, nbr_spec=ts, engine="tree", device="cpu")


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_minimal_step_config_is_the_gather_engine_like_jax(tilt):
    """StepConfig(params=..., nbr_spec=..., thermal=False) is the gather
    engine with m_max = 100 in both packages (tests/test_mobility.py's
    construction), and mobility() agrees to 1e-5."""
    L = 20.0
    jp = J.make_params(xi=0.5, error=1e-3, L=L)
    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    jc = ji.StepConfig(params=jp, nbr_spec=jnb.make_spec(64, jp.L,
                                                          jp.ewald_cut),
                       thermal=False)
    tc = pi.StepConfig(params=tp, nbr_spec=tnb.make_spec(64, tp.L,
                                                          tp.ewald_cut),
                       thermal=False, device="cpu")
    assert (tc.engine, tc.m_max, tc.seed) == (jc.engine, jc.m_max, jc.seed) \
        == ("gather", 100, 0)
    assert tc.nbr_spec == jc.nbr_spec
    rng = np.random.default_rng(2)
    pos = P.create_lattice(4, L) + rng.normal(scale=0.3, size=(64, 3)
                                              ).astype(np.float32)
    F = rng.normal(size=(64, 3)).astype(np.float32)
    uj, oj = ji.mobility(jc, pos, F, tilt)
    ut, ot = pi.mobility(tc, pos, F, tilt)
    assert int(ot) == int(oj) == 0
    uj = np.asarray(uj)
    assert np.abs(ut.numpy() - uj).max() / np.abs(uj).max() < 1e-5
