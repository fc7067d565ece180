"""The port's gather engine against the JAX package.

The neighbor list (cubic, tilted, the stencil backend, all-pairs, overflow
and growth, built in row chunks), make_spec / grow_spec, the
table-interpolated pair coefficients and matvec (the table kept on the
device once per configuration), the Gaussian taps with the tap spread and
contract, make_config's engine choice (banded -> blocked -> gather) and
nbr_spec, the step (brownian, with forces, athermal; JAX's psi and wave
uniforms injected) and mobility() on the gather engine, mobility() against
the float64 direct Ewald sum, and the OVF_NBR regrow of Simulation.run.
CPU only: the port's kernel wrappers run their plain versions here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

import pse_tpu as J                          # noqa: E402
from pse_tpu import integrator as ji         # noqa: E402
from pse_tpu import neighbors as jnb         # noqa: E402
from pse_tpu.ops import farfield as jff      # noqa: E402
from pse_tpu.ops import nearfield as jnf     # noqa: E402
from pse_tpu.ops import noise as jn          # noqa: E402

import pse_tpu_torch as P                    # noqa: E402
from pse_tpu_torch import integrator as pi   # noqa: E402
from pse_tpu_torch import neighbors as pnb   # noqa: E402
from pse_tpu_torch.ops import farfield as pff    # noqa: E402
from pse_tpu_torch.ops import nearfield as pnf   # noqa: E402

import oracles                               # noqa: E402

N, L = 1080, 24.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_max(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _wrapped_positions(seed, n, box, tilt=0.0, spread=None):
    """Uniform positions wrapped into the (tilted) box by pse_tpu."""
    rng = np.random.default_rng(seed)
    lo = spread if spread is not None else max(box) / 2
    pos = rng.uniform(-lo, lo, size=(n, 3)).astype(np.float32)
    pos, _ = J.box.wrap(J.make_box(box, tilt), jnp.asarray(pos),
                        jnp.zeros((n, 3), jnp.int32))
    return np.array(pos)


def _both_lists(pos, box, tilt, spec):
    jl = jnb.build_neighbor_list(jnp.asarray(pos), J.make_box(box, tilt),
                                 spec)
    pl = pnb.build_neighbor_list(torch.as_tensor(pos), P.make_box(box, tilt),
                                 pnb.NeighborSpec(*spec))
    return jl, pl


@pytest.mark.parametrize("case", ["cubic", "tilted", "stencil",
                                  "stencil_tilted", "all_pairs"])
def test_neighbor_list_matches_jax(case):
    """idx equal as arrays and the overflow flag equal (the cases of
    tests/test_neighbors.py), the specs equal."""
    seed, n, box, rcut, tilt, subdiv = {
        "cubic": (0, 300, (20.0,) * 3, 3.0, 0.0, 1),
        "tilted": (1, 256, (18.0, 22.0, 20.0), 3.5, 0.3, 1),
        "stencil": (4, 300, (20.0,) * 3, 3.0, 0.0, 2),
        "stencil_tilted": (5, 256, (18.0, 22.0, 20.0), 3.5, 0.45, 2),
        "all_pairs": (2, 40, (7.0,) * 3, 2.5, 0.0, 1),
    }[case]
    pos = _wrapped_positions(seed, n, box, tilt,
                             spread=15.0 if case != "all_pairs" else None)
    spec = jnb.make_spec(n, box, rcut, max_tilt=0.5, subdiv=subdiv)
    assert pnb.make_spec(n, box, rcut, max_tilt=0.5, subdiv=subdiv) == spec
    assert spec.all_pairs == (case == "all_pairs")
    jl, pl = _both_lists(pos, box, tilt, spec)
    assert pl.idx.dtype == torch.int32
    np.testing.assert_array_equal(pl.idx.numpy(), np.asarray(jl.idx))
    assert bool(pl.overflow) == bool(jl.overflow) is False
    jm, jmean = jnb.neighbor_count_stats(jl, n)
    pm, pmean = pnb.neighbor_count_stats(pl, n)
    assert int(pm) == int(jm) and float(pmean) == float(jmean)


def test_neighbor_overflow_and_growth_match_jax():
    """A cell-capacity overflow flags both; build_neighbor_list_auto grows
    to the same spec and list; a list overflow alone (max_neighbors too
    small) keeps each row's first K neighbors in both."""
    box = (20.0,) * 3
    pos = _wrapped_positions(3, 200, box)
    tight = jnb.NeighborSpec(rcut=6.0, n_cells=(3, 3, 3), cell_capacity=4,
                             max_neighbors=4)
    jl, pl = _both_lists(pos, box, 0.0, tight)
    assert bool(jl.overflow) and bool(pl.overflow)
    jl, jspec = jnb.build_neighbor_list_auto(jnp.asarray(pos),
                                             J.make_box(box), tight)
    pl, pspec = pnb.build_neighbor_list_auto(
        torch.as_tensor(pos), P.make_box(box), pnb.NeighborSpec(*tight))
    assert pspec == jspec and pspec.cell_capacity > tight.cell_capacity
    assert not bool(pl.overflow)
    np.testing.assert_array_equal(pl.idx.numpy(), np.asarray(jl.idx))
    short = jspec._replace(max_neighbors=5)
    jl, pl = _both_lists(pos, box, 0.0, short)
    assert bool(jl.overflow) and bool(pl.overflow)
    np.testing.assert_array_equal(pl.idx.numpy(), np.asarray(jl.idx))


@pytest.mark.parametrize("case", ["cells", "all_pairs", "list_overflow"])
def test_row_chunks_give_the_same_list(monkeypatch, case):
    """Chunks of a few rows give JAX's idx and flag, the flag of a chunk
    after the first included (the list built in one pass there)."""
    box = (20.0,) * 3
    pos = _wrapped_positions(6, 200, box,
                             spread=None if case == "all_pairs" else 15.0)
    rcut = 3.0 if case != "all_pairs" else 8.0
    spec = jnb.make_spec(200, box, rcut)
    assert spec.all_pairs == (case == "all_pairs")
    if case == "list_overflow":
        spec = spec._replace(max_neighbors=3)
    monkeypatch.setattr(pnb, "CHUNK_CANDIDATES", 4 * spec.cell_capacity * 27
                        if not spec.all_pairs else 800)
    _, per_row, _ = pnb._candidates(torch.as_tensor(pos), P.make_box(box),
                                    pnb.NeighborSpec(*spec))
    assert len(pnb._row_chunks(200, per_row)) >= 50
    jl, pl = _both_lists(pos, box, 0.0, spec)
    np.testing.assert_array_equal(pl.idx.numpy(), np.asarray(jl.idx))
    assert bool(pl.overflow) == bool(jl.overflow) == (case == "list_overflow")


@pytest.mark.parametrize("n,box,rcut,kw", [
    (1080, (24.0,) * 3, 5.2565, {}),
    (100_000, (97.63945917076818,) * 3, 5.2565, {}),     # the bench box
    (100_000, (97.63945917076818,) * 3, 5.2565, {"subdiv": 2}),
    (107, (10.0,) * 3, 5.2565, {}),                      # all-pairs
    (3000, (30.0, 30.0, 36.0), 3.0, {"max_tilt": 0.2, "max_neighbors": 50}),
])
def test_make_spec_and_grow_spec_match_jax(n, box, rcut, kw):
    js = jnb.make_spec(n, box, rcut, **kw)
    ps = pnb.make_spec(n, box, rcut, **kw)
    assert ps == js
    for factor in (1.5, 1.4):
        js, ps = jnb.grow_spec(js, factor), pnb.grow_spec(ps, factor)
        assert ps == js


def _setup(tilt, seed=3, n=N, box=L):
    pos = np.random.default_rng(seed).uniform(
        -box / 2, box / 2, (n, 3)).astype(np.float32)
    jp = J.make_params(xi=0.5, error=1e-3, L=box)
    tp = P.make_params(xi=0.5, error=1e-3, L=box)
    spec = jnb.make_spec(n, jp.L, jp.ewald_cut)
    jl, pl = _both_lists(pos, (box,) * 3, tilt, spec)
    return pos, jp, tp, jl, pl


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_pair_coeffs_and_matvec_match_jax(tilt):
    """The Ewald table bitwise; the interpolated coefficients <= 1e-6 of
    the largest (max |diff| / max |jax|), the matvec <= 1e-5."""
    pos, jp, tp, jl, pl = _setup(tilt)
    np.testing.assert_array_equal(tp.ewald_table, jp.ewald_table)
    assert tp.ewald_table.dtype == np.float32 and tp.ewald_n == jp.ewald_n
    jbox, pbox = J.make_box(L, tilt), P.make_box(L, tilt)
    jc = jnf.precompute_pair_coeffs(
        jnp.asarray(pos), jl.idx, jbox, jnp.asarray(jp.ewald_table),
        jp.ewald_cut, jp.ewald_dr, jp.ewald_n)
    pc = pnf.precompute_pair_coeffs(
        torch.as_tensor(pos), pl.idx, pbox, tp.ewald_table, tp.ewald_cut,
        tp.ewald_dr, tp.ewald_n)
    np.testing.assert_array_equal(pc.nbr.numpy(), np.asarray(jc.nbr))
    for k in ("imrr", "bcoef", "ex", "ey", "ez"):
        assert _rel_max(getattr(pc, k), getattr(jc, k)) <= 1e-6, k
    F = np.random.default_rng(8).normal(size=(N, 3)).astype(np.float32)
    ju = jnf.mreal_matvec(jc, jnp.asarray(F), jp.self_mobility)
    pu = pnf.mreal_matvec(pc, torch.as_tensor(F), tp.self_mobility)
    assert _rel_max(pu, ju) <= 1e-5
    pa = pnf.mreal_apply(torch.as_tensor(pos), torch.as_tensor(F), pl.idx,
                         pbox, tp.ewald_table, tp.ewald_cut, tp.ewald_dr,
                         tp.ewald_n, tp.self_mobility)
    assert torch.equal(pa, pu)


def test_ewald_table_on_device_is_made_once():
    """The table the step interpolates is the params' bitwise, and one
    tensor per configuration: equal params made anew reuse it."""
    from pse_tpu_torch.params import ewald_table_on

    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    t = ewald_table_on(tp, torch.device("cpu"))
    np.testing.assert_array_equal(t.numpy(), tp.ewald_table)
    again = P.make_params(xi=0.5, error=1e-3, L=L)
    assert again == tp and again.ewald_table is not tp.ewald_table
    assert ewald_table_on(again, torch.device("cpu")) is t


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_taps_spread_and_contract_match_jax(tilt):
    """flat_idx equal, weights <= 1e-6; the tap spread and contract <=
    1e-5 (max |diff| / max |jax|); the full-spectrum wave_space_velocity
    <= 1e-5; the spread reruns bitwise."""
    rng = np.random.default_rng(21)
    pos = rng.uniform(-L / 2, L / 2, (N, 3)).astype(np.float32)
    F = rng.normal(size=(N, 3)).astype(np.float32)
    jp = J.make_params(xi=0.5, error=1e-3, L=L)
    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    jbox, pbox = J.make_box(L, tilt), P.make_box(L, tilt)
    jt = jff.compute_taps(jnp.asarray(pos), jbox, jp)
    pt = pff.compute_taps(torch.as_tensor(pos), pbox, tp)
    np.testing.assert_array_equal(pt.flat_idx.numpy(), np.asarray(jt.flat_idx))
    assert float(np.abs(pt.weights.numpy() - np.asarray(jt.weights)).max()
                 ) <= 1e-6
    # every tap sits once in its own node's row, rows ascending, pads last
    flat, rows = pt.flat_idx.reshape(-1).numpy(), pt.node_taps.numpy()
    valid = rows < flat.size
    assert np.array_equal(np.sort(rows[valid]), np.arange(flat.size))
    node = np.broadcast_to(np.arange(rows.shape[0])[:, None], rows.shape)
    assert (flat[rows[valid]] == node[valid]).all()
    assert (np.diff(rows, axis=1) >= 0).all()
    jg = jff.spread(jt, jnp.asarray(F), jp)
    pg = pff.spread(pt, torch.as_tensor(F), tp)
    assert _rel_max(pg, jg) <= 1e-5
    assert torch.equal(pff.spread(pt, torch.as_tensor(F), tp), pg)
    grid = rng.normal(size=(3, jp.Nx, jp.Ny, jp.Nz)).astype(np.float32)
    assert _rel_max(pff.contract(pt, torch.as_tensor(grid), tp),
                    jff.contract(jt, jnp.asarray(grid), jp)) <= 1e-5
    jk, jw = J.params.gridk_arrays(jp, tilt)
    pk, pw = P.params.gridk_arrays(tp, tilt, "cpu")
    ju = jff.wave_space_velocity(jnp.asarray(pos), jnp.asarray(F), jbox, jp,
                                 jk, jw)
    pu = pff.wave_space_velocity(torch.as_tensor(pos), torch.as_tensor(F),
                                 pbox, tp, pk, pw)
    assert _rel_max(pu, ju) <= 1e-5


def _phi045_n(box):
    return int(round(0.45 * box ** 3 / (4.0 / 3.0 * np.pi)))


@pytest.mark.parametrize("box,engine,expect", [
    (8.0, "blocked", "gather"),        # too small to block: gather
    (10.0, "blocked", "gather"),
    (10.0, "banded", "gather"),        # banded -> blocked -> gather
    (12.0, "blocked", "blocked"),
    (L, "gather", "gather"),
])
def test_make_config_engine_and_nbr_spec_match_jax(box, engine, expect):
    n = _phi045_n(box) if box != L else N
    jp = J.make_params(xi=0.5, error=1e-3, L=box)
    tp = P.make_params(xi=0.5, error=1e-3, L=box)
    for subdiv in (1, 2):
        jcfg = ji.make_config(jp, n, engine=engine, nbr_subdiv=subdiv,
                              has_forces=False)
        tcfg = pi.make_config(tp, n, engine=engine, nbr_subdiv=subdiv,
                              has_forces=False, device="cpu")
        assert tcfg.engine == jcfg.engine == expect
        assert tcfg.nbr_spec == jcfg.nbr_spec
        if expect == "gather":
            assert tcfg.nf_spec is tcfg.band_spec is tcfg.colff_spec is None
            assert tcfg.cheb is None and tcfg.ff_spec is None
    pos = np.random.default_rng(2).uniform(-box / 2, box / 2, (n, 3))
    sim = P.Simulation(positions=pos, L=box, dt=1e-3, device="cpu")
    sim.set_integrator(P.PSEv1(T=1.0, nlist_type="stencil"), verbose=False,
                       **({} if engine == "blocked" else {"engine": engine}))
    jcfg = ji.make_config(jp, n, engine=engine, nbr_subdiv=2)
    assert sim.config.engine == jcfg.engine
    assert sim.config.nbr_spec == jcfg.nbr_spec
    assert sim.config.nbr_spec.subdiv == (2 if not jcfg.nbr_spec.all_pairs
                                          else 1)


def _jax_draws(cfg, step, n):
    """The uniforms pse_tpu's gather step draws: psi (3, N) and the wave."""
    key = jax.random.fold_in(jax.random.PRNGKey(ji.hash_seed(cfg.seed)),
                             jnp.asarray(step, jnp.int32))
    k_psi, k_grid = jax.random.split(key)
    p = cfg.params
    psi = jn.particle_noise_t(k_psi, (n,))
    wave = jax.random.uniform(k_grid, (6, p.Nx, p.Ny, p.Nz // 2 + 1),
                              dtype=jnp.float32, minval=-jn.SQRT3D2,
                              maxval=jn.SQRT3D2)
    return np.asarray(psi), np.asarray(wave)


@pytest.mark.parametrize("kind,box,n,subdiv", [
    ("brownian", 10.0, 107, 1),        # the fallback box, all-pairs
    ("brownian", L, N, 1),
    ("brownian", L, N, 2),             # nlist_type="stencil"
    ("forces", L, N, 1),
    ("athermal", L, N, 1),
])
def test_gather_step_and_mobility_match_jax(kind, box, n, subdiv):
    """Velocities and mobility() <= 1e-4 (max |diff| / max |jax|) with
    equal m, at tilts 0 and 0.3 with shear; the same new state."""
    thermal, has_forces = kind != "athermal", kind != "brownian"
    jp = J.make_params(xi=0.5, error=1e-3, L=box)
    tp = P.make_params(xi=0.5, error=1e-3, L=box)
    kw = dict(engine="gather", thermal=thermal, has_forces=has_forces,
              seed=4, nbr_subdiv=subdiv)
    jcfg = ji.make_config(jp, n, **kw)
    tcfg = pi.make_config(tp, n, device="cpu", **kw)
    assert jcfg.engine == tcfg.engine == "gather"
    rng = np.random.default_rng(30)
    pos = rng.uniform(-box / 2, box / 2, (n, 3)).astype(np.float32)
    F = rng.normal(size=(n, 3)).astype(np.float32)
    T = 1.0 if thermal else 0.0
    for tilt, rate, step in ((0.0, 0.0, 0), (0.3, 0.5, 5)):
        js = ji.make_state(pos, step=step, tilt_xy=tilt)
        ts = pi.make_state(pos, step, tilt, "cpu")
        jnew, jinfo = ji.step(jcfg, js, jnp.asarray(F), T, 1e-3, rate, None)
        tnew, tinfo = pi.step(
            tcfg, ts, torch.as_tensor(F) if has_forces else None, T, 1e-3,
            rate, None,
            uniforms=_jax_draws(jcfg, step, n) if thermal else None)
        assert tinfo["m_lanczos"] == int(jinfo["m_lanczos"])
        assert _rel_max(tinfo["velocities"], jinfo["velocities"]) <= 1e-4
        np.testing.assert_allclose(tnew.pos.numpy(), np.asarray(jnew.pos),
                                   atol=1e-5)
        np.testing.assert_array_equal(tnew.images.numpy(),
                                      np.asarray(jnew.images))
        assert int(tnew.nbr_overflow) == int(jnew.nbr_overflow) == 0
        if kind == "athermal":
            ju, _ = ji.mobility(jcfg, pos, F, tilt)
            tu, ovf = pi.mobility(tcfg, pos, F, tilt)
            assert int(ovf) == 0 and _rel_max(tu, ju) <= 1e-4


def test_gather_step_reruns_are_bitwise_equal():
    """The tap spread and the gathers use no atomics: the same step twice
    is bitwise equal."""
    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    cfg = pi.make_config(tp, N, engine="gather", seed=9, device="cpu")
    s0 = pi.make_state(np.random.default_rng(8).uniform(
        -L / 2, L / 2, (N, 3)), step=3, device="cpu")
    F = torch.as_tensor(np.random.default_rng(1).normal(size=(N, 3)),
                        dtype=torch.float32)
    a, ia = pi.step(cfg, s0, F, 1.0, 1e-3, 0.2)
    b, ib = pi.step(cfg, s0, F, 1.0, 1e-3, 0.2)
    assert torch.equal(ia["velocities"], ib["velocities"])
    assert torch.equal(a.pos, b.pos)


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_gather_mobility_matches_float64_oracle(tilt):
    """mobility() on the gather engine (N = 32 in L = 14, all-pairs)
    against tests/oracles.py's direct Ewald sum: <= 5e-3 relative 2-norm
    (tests/test_mobility.py's check of pse_tpu)."""
    n, box = 32, 14.0
    rng = np.random.default_rng(0)
    tp = P.make_params(xi=0.5, error=1e-3, L=box, max_strain=0.5)
    pbox = P.make_box(box, tilt)
    pos = rng.uniform(-box / 2, box / 2, size=(n, 3)).astype(np.float32)
    pos, _ = P.box.wrap(pbox, torch.as_tensor(pos),
                        torch.zeros((n, 3), dtype=torch.int32))
    F = rng.normal(size=(n, 3)).astype(np.float32)
    cfg = pi.make_config(tp, n, thermal=False, engine="gather", device="cpu")
    u, ovf = pi.mobility(cfg, pos, F, tilt)
    u_ref = oracles.direct_ewald_velocity(pos.numpy(), F, tp.L, tp.xi,
                                          tilt_xy=tilt)
    assert int(ovf) == 0
    rel = np.linalg.norm(u.numpy() - u_ref) / np.linalg.norm(u_ref)
    assert rel < 5e-3


def test_nbr_overflow_regrow_in_run_matches_jax():
    """Simulation.run with max_neighbors too small: OVF_NBR rewinds and
    regrows the neighbor list, with the retries and the grown spec of
    pse_tpu's Simulation."""
    box, n = 10.0, 107
    pos = np.random.default_rng(5).uniform(-box / 2, box / 2,
                                           (n, 3)).astype(np.float32)
    sims = []
    for pkg, kw in ((J, {}), (P, {"device": "cpu"})):
        sim = pkg.Simulation(positions=pos, L=box, dt=1e-3, sync_every=2,
                             **kw)
        sim.set_integrator(pkg.PSEv1(T=1.0, seed=3), max_neighbors=40,
                           verbose=False)
        sim.run(2)
        sims.append(sim)
    jsim, tsim = sims
    assert tsim.config.engine == jsim.config.engine == "gather"
    assert tsim.metrics["overflow_retries"] == \
        jsim.metrics["overflow_retries"] >= 1
    assert tsim.config.nbr_spec == jsim.config.nbr_spec
    assert tsim.config.nbr_spec.max_neighbors > 40
    assert tsim.snapshot()["step"] == 2 and int(tsim.state.nbr_overflow) == 0
    with pytest.raises(RuntimeError, match="nbr_spec"):
        tiny = P.Simulation(positions=pos, L=box, dt=1e-3, device="cpu")
        tiny.set_integrator(P.PSEv1(T=0.0), max_neighbors=4, verbose=False)
        tiny.mobility_matvec(torch.ones((n, 3)))
