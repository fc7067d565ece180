"""The PyTorch port (pse_tpu_torch) against the JAX package, module by module.

The same numpy inputs go through both packages on the CPU, where the port's
kernel wrappers run their plain PyTorch versions and the JAX package its XLA
paths.  Configuration: the banded test config of test_banded.py (N ~ 1080
in L = 24: 3 x 4 columns, cap 160, W = 128).
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

import pse_tpu as J                          # noqa: E402
from pse_tpu import cellbins as jc           # noqa: E402
from pse_tpu import integrator as ji         # noqa: E402
from pse_tpu import params as jparams        # noqa: E402
from pse_tpu import shear as jshear          # noqa: E402
from pse_tpu.ops import banded_nearfield as jb   # noqa: E402
from pse_tpu.ops import column_farfield as jf    # noqa: E402
from pse_tpu.ops import lanczos as jl        # noqa: E402
from pse_tpu.ops import noise as jn          # noqa: E402

import pse_tpu_torch as P                    # noqa: E402
from pse_tpu_torch import cellbins as pc     # noqa: E402
from pse_tpu_torch import integrator as pi   # noqa: E402
from pse_tpu_torch import params as pparams  # noqa: E402
from pse_tpu_torch import shear as pshear    # noqa: E402
from pse_tpu_torch import trace              # noqa: E402
from pse_tpu_torch.ops import banded_nearfield as pb   # noqa: E402
from pse_tpu_torch.ops import column_farfield as pf    # noqa: E402
from pse_tpu_torch.ops import lanczos as pl  # noqa: E402
from pse_tpu_torch.ops import noise as pn    # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
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
    a = np.asarray(a).astype(np.complex128).ravel()
    b = np.asarray(b).astype(np.complex128).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _configs(n=N, box=L, seed=0, **kw):
    jp = J.make_params(xi=0.5, error=1e-3, L=box)
    tp = P.make_params(xi=0.5, error=1e-3, L=box)
    jcfg = ji.make_config(jp, n, thermal=True, engine="banded",
                          has_forces=False, seed=seed, **kw)
    tcfg = pi.make_config(tp, n, thermal=True, engine="banded",
                          has_forces=False, seed=seed, device="cpu", **kw)
    return jcfg, tcfg


def _positions(seed, n=N, box=L):
    rng = np.random.default_rng(seed)
    return rng.uniform(-box / 2, box / 2, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("xi,error,box,n", [
    (0.5, 1e-3, 24.0, 1080),
    (0.5, 1e-3, 97.63945917076818, 100_000),      # the bench geometry
    (0.6, 1e-4, (30.0, 30.0, 36.0), 3000),
])
def test_derived_spec_and_chebyshev_match_jax(xi, error, box, n):
    """The port derives the JAX package's parameters: grid, Gaussian P,
    cutoff, band and far-field specs, and the Chebyshev fit."""
    jp = J.make_params(xi=xi, error=error, L=box)
    tp = P.make_params(xi=xi, error=error, L=box)
    for k in ("Nx", "Ny", "Nz", "gauss_P", "ewald_cut", "ewald_n", "eta",
              "gauss_m", "self_mobility", "gridh"):
        assert getattr(tp, k) == getattr(jp, k), k
    jcfg = ji.make_config(jp, n, engine="banded", has_forces=False)
    tcfg = pi.make_config(tp, n, engine="banded", has_forces=False,
                          device="cpu")
    jbs, tbs = jcfg.band_spec, tcfg.band_spec
    assert tbs.bins == jbs.bins
    assert (tbs.window, tbs.rows, tbs.block_dtype, tbs.offsets) == (
        jbs.window, jbs.rows, jbs.block_dtype, jbs.offsets)
    assert tcfg.colff_spec == jcfg.colff_spec
    assert tcfg.m_max == jcfg.m_max
    jc_, tc_ = jcfg.cheb, tcfg.cheb
    assert (tc_.lo, tc_.mid, tc_.hi) == (jc_.lo, jc_.mid, jc_.hi)
    np.testing.assert_allclose(np.array(tc_.coeffs), np.array(jc_.coeffs),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("flags", [ji.OVF_NF, ji.OVF_BAND, ji.OVF_FF,
                                   ji.OVF_LANCZOS, ji.OVF_NF | ji.OVF_BAND])
def test_grow_config_matches_jax(flags):
    jcfg, tcfg = _configs()
    for _ in range(3):                      # W 128 -> 192 -> 256 -> rows 16
        jcfg = ji.grow_config(jcfg, flags=flags)
        tcfg = pi.grow_config(tcfg, flags=flags)
        jbs, tbs = jcfg.band_spec, tcfg.band_spec
        assert (tbs.bins, tbs.window, tbs.rows) == (jbs.bins, jbs.window,
                                                     jbs.rows)
        assert tcfg.colff_spec == jcfg.colff_spec
        assert tcfg.m_max == jcfg.m_max


def test_gridk_and_hermitian_maps_match_jax():
    tp = P.make_params(xi=0.5, error=1e-3, L=(24.0, 20.0, 30.0))
    jp = J.make_params(xi=0.5, error=1e-3, L=(24.0, 20.0, 30.0))
    for half in (False, True):
        jk, jw = jparams.gridk_arrays(jp, 0.3, half=half)
        tk, tw = pparams.gridk_arrays(tp, 0.3, "cpu", half=half)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
    for a, b in zip(pparams.hermitian_noise_maps(6, 5, 4),
                    jparams.hermitian_noise_maps(6, 5, 4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tilt", [0.0, 0.3])
@pytest.mark.parametrize("columns", [True, False])
def test_binning_matches_jax(tilt, columns):
    """Identical slot contents (pid, mask), ranks, cells and overflow;
    positions to 1e-6 relative."""
    jcfg, tcfg = _configs()
    pos = _positions(1)
    pos[:7, 0] += 24.0                         # some particles off-box
    jbox, tbox = J.make_box(L, tilt), P.make_box(L, tilt)
    if columns:
        jbins = jc.bin_columns(jnp.asarray(pos), jbox, jcfg.band_spec.bins)
        tbins = pc.bin_columns(torch.as_tensor(pos), tbox,
                               tcfg.band_spec.bins)
    else:
        jbins = jc.bin_particles(jnp.asarray(pos), jbox, jcfg.colff_spec.bins)
        tbins = pc.bin_particles(torch.as_tensor(pos), tbox,
                                 tcfg.colff_spec.bins)
    for f in ("pid", "mask", "cell_of", "rank_of", "overflow"):
        np.testing.assert_array_equal(getattr(tbins, f).numpy(),
                                      np.asarray(getattr(jbins, f)), f)
    for f in ("px", "py", "pz"):
        a, b = getattr(tbins, f).numpy(), np.asarray(getattr(jbins, f))
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), f


def test_binning_overflow_flag_matches_jax():
    jcfg, tcfg = _configs()
    pos = _positions(2)
    pos[:400, :2] = 0.5                        # one overfull column
    jbins = jc.bin_columns(jnp.asarray(pos), J.make_box(L, 0.0),
                           jcfg.band_spec.bins)
    tbins = pc.bin_columns(torch.as_tensor(pos), P.make_box(L, 0.0),
                           tcfg.band_spec.bins)
    assert bool(jbins.overflow) and bool(tbins.overflow)
    np.testing.assert_array_equal(tbins.rank_of.numpy(),
                                  np.asarray(jbins.rank_of))


def _fill_case(case):
    """(unsorted cell ids, C, cap) of a lumpy occupancy: an overfull cell,
    empty cells at both ends, or fewer particles than cells."""
    rng = np.random.default_rng(11)
    if case == "overfull":         # cell 5 holds 40+ > cap, ends empty
        cid = np.concatenate([rng.integers(2, 24, size=360), np.full(40, 5)])
        c_total, cap = 27, 32
    elif case == "empty_ends":     # cells 0, 1 and 25, 26 empty
        cid = rng.integers(2, 25, size=400)
        c_total, cap = 27, 48
    else:                          # "n_lt_c": 20 particles in 27 cells
        cid = rng.integers(0, 27, size=20)
        c_total, cap = 27, 8
    return rng.permutation(cid).astype(np.int32), c_total, cap


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("case", ["overfull", "empty_ends", "n_lt_c"])
def test_fill_matches_jax_starts_ranks_and_slots(case, with_values):
    """The fill's plain version against the JAX package's
    _cell_starts_counts and its Pallas fill (interpret mode), bitwise:
    starts, counts, ranks (>= cap in an overfull cell), overflow, slots and
    value rows."""
    cid, c_total, cap = _fill_case(case)
    n = cid.shape[0]
    rng = np.random.default_rng(12)
    coords = rng.normal(size=(3, n)).astype(np.float32)
    values = rng.normal(size=(n, 3)).astype(np.float32)
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    starts, counts, rank_sorted, overflow = jc._cell_starts_counts(
        jnp.asarray(sorted_cid), c_total, cap)
    jfields = jc._fill_cells_pallas(
        jnp.asarray(coords[:, order]), jnp.asarray(order.astype(np.int32)),
        starts, counts, c_total, cap, n, interpret=True,
        values_t=jnp.asarray(values[order].T) if with_values else None)
    f = pc.fill_cells_reference(
        torch.as_tensor(sorted_cid), torch.as_tensor(order),
        tuple(torch.as_tensor(x) for x in coords), c_total, cap,
        torch.as_tensor(values) if with_values else None)
    assert bool(overflow) == (case == "overfull") == bool(f.overflow)
    np.testing.assert_array_equal(f.starts.numpy(), np.asarray(starts))
    np.testing.assert_array_equal(f.counts.numpy(), np.asarray(counts))
    np.testing.assert_array_equal(f.rank_of.numpy()[order],
                                  np.asarray(rank_sorted))
    got = (f.px, f.py, f.pz, f.mask, f.pid) + (
        (f.values,) if with_values else ())
    assert len(jfields) == len(got)
    for a, b in zip(got, jfields):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _bins_both(jcfg, tcfg, pos, tilt):
    jbox, tbox = J.make_box(L, tilt), P.make_box(L, tilt)
    jbins = jc.bin_columns(jnp.asarray(pos), jbox, jcfg.band_spec.bins)
    tbins = pc.bin_columns(torch.as_tensor(pos), tbox, tcfg.band_spec.bins)
    return jbox, tbox, jbins, tbins


@pytest.mark.parametrize("tilt,half", [(0.0, False), (0.3, False),
                                       (0.3, True)])
def test_compute_windows_match_jax(tilt, half):
    jcfg, tcfg = _configs()
    pos = _positions(3)
    jbox, tbox, jbins, tbins = _bins_both(jcfg, tcfg, pos, tilt)
    offs = jcfg.band_spec.offsets[:jb.N_HALF] if half else None
    jw = jb.compute_windows(jbins, jcfg.band_spec, jbox, jcfg.params.ewald_cut,
                            offsets=offs)
    tw = pb.compute_windows(tbins, tcfg.band_spec, tbox, tcfg.params.ewald_cut,
                            offsets=offs)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_band_overflow_flags_like_jax():
    """All particles in one thin z slab: every band exceeds the window."""
    jcfg, tcfg = _configs(n=4000)
    pos = _positions(6, n=4000)
    pos[:, 2] *= 0.02
    jbox, tbox, jbins, tbins = _bins_both(jcfg, tcfg, pos, 0.0)
    jw = jb.compute_windows(jbins, jcfg.band_spec, jbox, jcfg.params.ewald_cut)
    tw = pb.compute_windows(tbins, tcfg.band_spec, tbox, tcfg.params.ewald_cut)
    assert bool(jw[2]) and bool(tw[2])


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_plain_banded_matvec_matches_jax(tilt):
    """matvec_banded_reference (the plain version of both banded kernels,
    and what the wrappers run on CPU tensors) against the JAX package's."""
    jcfg, tcfg = _configs()
    pos = _positions(4)
    forces = np.random.default_rng(5).normal(size=(N, 3)).astype(np.float32)
    jbox, tbox, jbins, tbins = _bins_both(jcfg, tcfg, pos, tilt)
    jp, tp = jcfg.params, tcfg.params
    j0, nv, _, zsh = jb.compute_windows(jbins, jcfg.band_spec, jbox,
                                        jp.ewald_cut)
    tj0, tnv, _, tzsh = pb.compute_windows(tbins, tcfg.band_spec, tbox,
                                           tp.ewald_cut)
    fj = jc.vec_to_cells(jbins, jcfg.band_spec.bins, jnp.asarray(forces))
    ft = pc.vec_to_cells(tbins, tcfg.band_spec.bins, torch.as_tensor(forces))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    uj = jb.matvec_banded_reference(jbins, jbox.tilt_xy, jcfg.band_spec,
                                    jcfg.cheb, jp.L, jp.ewald_cut,
                                    jp.ewald_dr, j0, nv, fj, jp.self_mobility)
    args = (tbins, tbox.tilt_xy, tcfg.band_spec, tcfg.cheb, tp.L,
            tp.ewald_cut, tp.ewald_dr, tj0, tnv, tzsh)
    blocks, ub = pb.build_mv_banded(*args, ft, tp.self_mobility)
    um = pb.matvec_banded(blocks, *args, ft, tp.self_mobility)
    assert blocks is None                      # CPU tensors: plain version
    assert _rel(ub.numpy(), uj) < 1e-5
    assert _rel(um.numpy(), uj) < 1e-5
    back = pc.vec_from_cells(tbins, tcfg.band_spec.bins, ub).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jc.vec_from_cells(jbins, jcfg.band_spec.bins, uj)),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tilt", [0.0, 0.25])
def test_contract_col_matches_jax(tilt):
    """Far-field factors and the plain contract (float32 factors, what the
    CPU runs) against the JAX package's XLA path."""
    jcfg, tcfg = _configs()
    pos = _positions(7)
    jbox, tbox = J.make_box(L, tilt), P.make_box(L, tilt)
    jspec, tspec = jcfg.colff_spec, tcfg.colff_spec
    jbins = jc.bin_particles(jnp.asarray(pos), jbox, jspec.bins)
    tbins = pc.bin_particles(torch.as_tensor(pos), tbox, tspec.bins)
    jfac = jf.build_col_factors(jbins, jbox, jspec, jcfg.params)
    tfac = pf.build_col_factors(tbins, tbox, tspec, tcfg.params)
    for a, b in zip(tfac, jfac):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    p = jcfg.params
    grid = np.random.default_rng(8).normal(
        size=(3, p.Nx, p.Ny, p.Nz)).astype(np.float32)
    uj = jf.contract_col(jbins, jnp.asarray(grid), jbox, jspec, p, jfac)
    ut = pf.contract_col_kernel(torch.as_tensor(grid), tspec, tcfg.params,
                                tfac)
    assert _rel(ut.numpy(), uj) < 1e-5


@pytest.mark.parametrize("tilt,shape", [(0.0, 24.0), (0.3, (24.0, 20.0, 30.0))])
def test_wave_noise_matches_jax(tilt, shape):
    """wave_space_noise_hat_half with the same injected uniforms (odd and
    even Nz planes)."""
    jp = J.make_params(xi=0.5, error=1e-3, L=shape)
    tp = P.make_params(xi=0.5, error=1e-3, L=shape)
    key = jax.random.PRNGKey(3)
    jk, jw = jparams.gridk_arrays(jp, tilt, half=True)
    uj = jn.wave_space_noise_hat_half(key, jp, jk, jw, 1.0, 1e-3)
    u = jax.random.uniform(key, (6, jp.Nx, jp.Ny, jp.Nz // 2 + 1),
                           dtype=jnp.float32, minval=-jn.SQRT3D2,
                           maxval=jn.SQRT3D2)
    tk, tw = pparams.gridk_arrays(tp, tilt, "cpu", half=True)
    ut = pn.wave_space_noise_hat_half(tp, tk, tw, 1.0, 1e-3,
                                      uniforms=np.asarray(u))
    assert _rel(ut.numpy(), np.asarray(uj)) < 1e-6


def _spd(dim, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    lam = rng.uniform(0.2, 2.0, size=dim)
    return ((q * lam) @ q.T).astype(np.float32)


@pytest.mark.parametrize("m_start,with_w0", [(2, False), (8, True)])
def test_sqrt_mreal_matches_jax(m_start, with_w0):
    """Same m, same hit_cap and M^{1/2} psi to 1e-5 on a fixed SPD
    operator, with and without the precomputed first matvec."""
    shape = (3, 4, 8)
    dim = int(np.prod(shape))
    M = _spd(dim, 11)
    psi = np.random.default_rng(12).uniform(-1.7, 1.7, size=shape).astype(
        np.float32)
    Mj, Mt = jnp.asarray(M), torch.as_tensor(M)

    def mv_j(v):
        return (Mj @ v.reshape(-1)).reshape(shape)

    def mv_t(v):
        return (Mt @ v.reshape(-1)).reshape(shape)

    w0 = (M @ (psi / np.linalg.norm(psi)).reshape(-1)).reshape(shape)
    uj, mj, hj = jl.sqrt_mreal(mv_j, jnp.asarray(psi), 1e-3,
                               jnp.asarray(m_start), 24,
                               w0=jnp.asarray(w0) if with_w0 else None)
    ut, mt, ht = pl.sqrt_mreal(mv_t, torch.as_tensor(psi), 1e-3, m_start, 24,
                               w0=torch.as_tensor(w0) if with_w0 else None)
    assert mt == int(mj) and ht == bool(hj)
    assert _rel(ut.numpy(), np.asarray(uj)) < 1e-5
    lam, q = np.linalg.eigh(M.astype(np.float64))
    exact = (q * np.sqrt(np.maximum(lam, 0))) @ q.T @ psi.reshape(-1)
    assert _rel(ut.numpy().reshape(-1), exact) < 1e-2


def test_sqrt_mreal_breakdown_assembles_partial_basis():
    """M = c I collapses the Krylov basis at once (where exactly is float32
    round-off, so this is not compared with JAX): with a high warm start the
    result must still be assembled from the partial basis."""
    c = 0.73
    psi = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    u, m, hit = pl.sqrt_mreal(lambda v: c * v, torch.as_tensor(psi), 1e-3,
                              10, 20)
    np.testing.assert_allclose(u.numpy(), np.sqrt(c) * psi, rtol=1e-5,
                               atol=1e-6)
    assert not hit and m <= 20


def test_sqrt_mreal_cap_hit_matches_jax():
    shape = (3, 2, 8)
    M = _spd(48, 13)
    psi = np.random.default_rng(14).normal(size=shape).astype(np.float32)
    Mj, Mt = jnp.asarray(M), torch.as_tensor(M)
    uj, mj, hj = jl.sqrt_mreal(lambda v: (Mj @ v.reshape(-1)).reshape(shape),
                               jnp.asarray(psi), 1e-7, jnp.asarray(2), 4)
    ut, mt, ht = pl.sqrt_mreal(lambda v: (Mt @ v.reshape(-1)).reshape(shape),
                               torch.as_tensor(psi), 1e-7, 2, 4)
    assert (mt, ht) == (int(mj), bool(hj)) == (4, True)
    assert _rel(ut.numpy(), np.asarray(uj)) < 1e-5


def test_shear_protocols_match_jax():
    dt = 1e-3
    pairs = [
        (jshear.steady(dt, 0.7, zero=0), pshear.steady(dt, 0.7, zero=0)),
        (jshear.sine(dt, 1.3, 2.0, zero=5), pshear.sine(dt, 1.3, 2.0, zero=5)),
        (jshear.chirp(dt, 0.2, 1.0, 5.0, 2.0, zero=0),
         pshear.chirp(dt, 0.2, 1.0, 5.0, 2.0, zero=0)),
        (jshear.windowed(jshear.sine(dt, 1.0, 1.0, zero=0),
                         jshear.tukey_window(dt, 1.5, 0.5, zero=0)),
         pshear.windowed(pshear.sine(dt, 1.0, 1.0, zero=0),
                         pshear.tukey_window(dt, 1.5, 0.5, zero=0))),
    ]
    steps = np.array([0, 3, 250, 999, 1700])
    for jfn, tfn in pairs:
        for t in steps:
            np.testing.assert_allclose(float(tfn.shear_rate(int(t))),
                                       float(jfn.shear_rate(int(t))),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(float(tfn.strain(int(t))),
                                       float(jfn.strain(int(t))),
                                       rtol=1e-5, atol=1e-6)
        jv = jshear.ShearVariant(jfn, 1200, 0.5)
        tv = pshear.ShearVariant(tfn, 1200, 0.5)
        for t in steps:
            np.testing.assert_allclose(float(tv.value(int(t))),
                                       float(jv.value(int(t))),
                                       rtol=1e-5, atol=1e-6)


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|pse_tpu)\b(?!_torch)"
    r"|from\s+(jax|pse_tpu)\b(?!_torch)"
    r"|from\s+\.\.+\s+import\s)", re.M)


def test_port_imports_neither_jax_nor_pse_tpu():
    """The port and chip_smoke.py import torch, never jax or pse_tpu (whose
    __init__ pulls in jax), not even numpy-only modules."""
    files = sorted((REPO / "pse_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 10
    names = {path.relative_to(REPO).as_posix() for path in files}
    assert {f"pse_tpu_torch/{m}.py" for m in (
        "neighbors", "ops/nearfield", "ops/farfield", "utils/gsd",
        "utils/trajectory", "utils/backend", "utils/cache",
        "examples/oscillatory_shear", "parallel/halo",
        "parallel/sharding")} <= names
    for path in files:
        text = path.read_text()
        bad = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)
               if "pse_tpu_torch" not in path.parts or ".." not in m.group(0)
               or _escapes_package(path, m.group(0))]
        assert not bad, f"{path.relative_to(REPO)}: {bad}"
        assert "jax" not in re.findall(r"import\s+(\w+)", text)


def _escapes_package(path, stmt):
    """A relative import whose dots climb out of pse_tpu_torch."""
    dots = len(re.match(r"\s*from\s+(\.+)", stmt).group(1))
    depth = len(path.relative_to(REPO / "pse_tpu_torch").parts) - 1
    return dots - 1 > depth


def test_kernel_wrappers_take_the_plain_path_on_cpu():
    """On CPU tensors every wrapper returns its plain version's result and
    launches nothing."""
    jcfg, tcfg = _configs()
    pos = torch.as_tensor(_positions(9))
    box = P.make_box(L, 0.1)
    before = trace.counters()
    spec = tcfg.band_spec.bins
    ops = pc.fill_operands(pos, box, spec, True)
    vals = torch.as_tensor(np.random.default_rng(3).normal(
        size=(N, 3)).astype(np.float32))
    for a, b in zip(pc.fill_cells(*ops, spec.n_cells_total, spec.cap, vals),
                    pc.fill_cells_reference(*ops, spec.n_cells_total,
                                            spec.cap, vals)):
        assert torch.equal(a, b)
    eng = pi.engine_of(tcfg)
    ctx, ovf = eng.prepare(pos, box)
    assert int(ovf) == 0
    ctx, u = eng.build_mv(ctx, torch.ones((3,) + ctx.nf_bins.px.shape))
    assert ctx.blocks is None and torch.isfinite(u).all()
    launches = ("launch.fill_cells", "launch.build_mv_banded",
                "launch.matvec_banded", "launch.contract_col_kernel")
    after = trace.counters()
    assert [after.get(k, 0) for k in launches] == [before.get(k, 0)
                                                   for k in launches]


@pytest.mark.parametrize("tilt", [0.0, -0.35])
def test_box_matches_jax(tilt):
    """Minimum image, wrap with image tracking, and unwrap."""
    rng = np.random.default_rng(21)
    box = (20.0, 24.0, 28.0)
    dr = rng.uniform(-40, 40, size=(500, 3)).astype(np.float32)
    pos = rng.uniform(-60, 60, size=(500, 3)).astype(np.float32)
    img = rng.integers(-3, 4, size=(500, 3)).astype(np.int32)
    jbox, tbox = J.make_box(box, tilt), P.make_box(box, tilt)
    np.testing.assert_allclose(
        P.box.min_image(tbox, torch.as_tensor(dr)).numpy(),
        np.asarray(J.box.min_image(jbox, jnp.asarray(dr))), atol=1e-5)
    jw, ji_ = J.box.wrap(jbox, jnp.asarray(pos), jnp.asarray(img))
    tw, ti = P.box.wrap(tbox, torch.as_tensor(pos), torch.as_tensor(img))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji_))
    back = P.box.unwrap(tbox, tw, ti - torch.as_tensor(img))
    np.testing.assert_allclose(back.numpy(), pos, atol=1e-4)
