"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
neither jax nor pse_tpu, so it runs on a machine that has only the port's
dependencies; the repository's conftest imports jax, so run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Sizes are small (the banded test config, N = 1080 in L = 24, N = 5300 in
L = 40, the oracle gate's N = 2048 in L = 26.71 with its 27^3 grid and
3 x 3 far-field columns, the gather engine's fallback box, N = 107 in
L = 10, and the halo's, N = 4800 in L = 33); chip_smoke.py holds the
kernels at the main path's shapes.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pse_tpu_torch import integrator as pi              # noqa: E402
from pse_tpu_torch import make_box, make_params, trace  # noqa: E402
from pse_tpu_torch.cellbins import (                    # noqa: E402
    BinSpec, CellBins, Fill, bin_columns, bin_particles, fill_cells,
    fill_cells_reference, fill_operands, half_space_offsets, vec_to_cells)
from pse_tpu_torch.ops import banded_nearfield as bdn   # noqa: E402
from pse_tpu_torch.ops import blocked_nearfield as bnf  # noqa: E402
from pse_tpu_torch.ops import column_farfield as cff    # noqa: E402

pytestmark = pytest.mark.cuda

# the step's kernel wrappers, by their launch counters
STEP_LAUNCHES = ("launch.fill_cells", "launch.contract_col_kernel",
                 "launch.spread_moments_kernel", "launch.build_mv_banded",
                 "launch.matvec_banded")


def _launched(before):
    """Launches of each of STEP_LAUNCHES since the counters ``before``."""
    now = trace.counters()
    return [now.get(k, 0) - before.get(k, 0) for k in STEP_LAUNCHES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _rel(a, b):
    """||a - b|| / ||b||: at these small sizes the max-norm residual of
    bf16 coefficients is one element's rounding (~2^-9), so the banded
    bounds are held in the 2-norm (chip_smoke.py holds the max-norm ones
    at the main path's shapes)."""
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _setup(n, L, tilt, seed=0, **config):
    """A banded config with one occupancy class (the kernels' single-class
    layout; the class-packed one has tests of its own), positions and a
    box."""
    params = make_params(xi=0.5, error=1e-3, L=L)
    cfg = pi.make_config(params, n, engine="banded", has_forces=False,
                         device="cuda", **config)
    cfg = dataclasses.replace(cfg, band_spec=cfg.band_spec._replace(
        classes=None, slab_classes=None))
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(
        rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32),
        device="cuda")
    return cfg, pos, make_box(L, tilt)


def _assert_fill_bitwise(sorted_cid, order, coords, c_total, cap, vals):
    """Every output of the fill kernel bitwise its plain version's."""
    got = fill_cells(sorted_cid, order, coords, c_total, cap, vals)
    want = fill_cells_reference(sorted_cid, order, coords, c_total, cap, vals)
    for name, a, b in zip(Fill._fields, got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    return got


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("columns", [True, False])
def test_fill_kernel_is_bitwise_the_plain_version(cuda, columns,
                                                  with_values):
    cfg, pos, box = _setup(5300, 40.0, 0.2)
    pos[:700, :2] = 0.5                        # one overfull column / cell
    spec = cfg.band_spec.bins if columns else cfg.colff_spec.bins
    vals = torch.randn(pos.shape, device=cuda) if with_values else None
    got = _assert_fill_bitwise(*fill_operands(pos, box, spec, columns),
                               spec.n_cells_total, spec.cap, vals)
    assert bool(got.overflow)


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
def test_fill_kernel_edge_cases_are_bitwise_the_plain_version(
        cuda, case, with_values):
    """The fill on the sort of lumpy cell ids (the CPU parity test's cases):
    ranks >= cap and the overflow flag, empty end cells, N < C."""
    cid, c_total, cap = _fill_case(case)
    n = cid.shape[0]
    rng = np.random.default_rng(12)
    cid = torch.as_tensor(cid, device=cuda)
    sorted_cid, order = torch.sort(cid, stable=True)
    pos = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32),
                          device=cuda)
    vals = (torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32),
                            device=cuda) if with_values else None)
    got = _assert_fill_bitwise(sorted_cid, order,
                               tuple(pos[:, k] for k in range(3)), c_total,
                               cap, vals)
    assert bool(got.overflow) == (case == "overfull")
    assert int(got.counts.sum()) == n


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5),
                                         ("bfloat16", 2e-3)])
@pytest.mark.parametrize("n,L,tilt,window", [
    (1080, 24.0, 0.0, None), (5300, 40.0, 0.3, None),
    (5300, 40.0, 0.1, 192), (5300, 40.0, 0.0, 256)])
def test_banded_kernels_match_plain_version(cuda, dtype, bound, n, L, tilt,
                                            window):
    """build_mv and matvec against the unrounded float32 plain version,
    at the default window and the grown ones (W = 192, 256)."""
    cfg, pos, box = _setup(n, L, tilt)
    p = cfg.params
    bs = cfg.band_spec._replace(block_dtype=dtype)
    if window is not None:
        bs = bs._replace(window=window)
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, ovf, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    assert not bool(ovf)
    f = vec_to_cells(bins, bs.bins, torch.randn(pos.shape, device=cuda))
    args = (bins, tilt, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    ref = bdn.matvec_banded_reference(*args[:9], f, p.self_mobility)
    blocks, u_b = bdn.build_mv_banded(*args, f, p.self_mobility)
    u_m = bdn.matvec_banded(blocks, *args, f, p.self_mobility)
    assert _rel(u_b, ref) < bound
    assert _rel(u_m, ref) < bound
    # the build's in-register coefficients are the stored ones
    assert _rel_max(u_b, u_m) < 1e-6


def test_banded_kernels_at_16_rows(cuda):
    """grow_config halves the row tile when W cannot widen: build_mv and
    the matvec against the plain version and each other."""
    cfg, pos, box = _setup(5300, 40.0, 0.05)
    cfg = pi.grow_config(pi.grow_config(pi.grow_config(
        cfg, flags=pi.OVF_BAND), flags=pi.OVF_BAND), flags=pi.OVF_BAND)
    bs, p = cfg.band_spec._replace(block_dtype="float32"), cfg.params
    assert bs.rows == 16
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, _, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    f = vec_to_cells(bins, bs.bins, torch.randn(pos.shape, device=cuda))
    args = (bins, 0.05, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    ref = bdn.matvec_banded_reference(*args[:9], f, p.self_mobility)
    blocks, u = bdn.build_mv_banded(*args, f, p.self_mobility)
    assert _rel_max(u, ref) < 1e-5
    u_m = bdn.matvec_banded(blocks, *args, f, p.self_mobility)
    assert _rel_max(u_m, ref) < 1e-5
    assert _rel_max(u, u_m) < 1e-6


def _cut_columns(pos, box, spec):
    """Remove particles so that one column is empty, one holds a multiple
    of R and one does not: (kept positions, the three columns)."""
    bins = bin_columns(pos, box, spec.bins)
    cell, rank = bins.cell_of.long(), bins.rank_of.long()
    counts = torch.bincount(cell, minlength=spec.bins.n_cells_total)
    R = spec.rows
    c_empty, c_full, c_ragged = (int(c) for c in
                                 torch.argsort(counts, descending=True)[:3])
    keep = cell != c_empty
    keep &= ~((cell == c_full) & (rank >= R * (int(counts[c_full]) // R)))
    keep &= ~((cell == c_ragged)
              & (rank >= R * (int(counts[c_ragged]) // R) - 5))
    return pos[keep], (c_empty, c_full, c_ragged)


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5),
                                         ("bfloat16", 2e-3)])
def test_matvec_at_empty_full_and_ragged_columns(cuda, dtype, bound):
    """The matvec skips the tiles past ceil(n_valid / R): held to the plain
    version and to build_mv's u (<= 1e-6) with one column empty, one at a
    multiple of R and one not (cut from N = 5300 in L = 40), one and two
    right-hand sides (two vs two single launches <= 1e-4), reruns bitwise
    equal."""
    cfg, pos, box = _setup(5300, 40.0, 0.2)
    p = cfg.params
    bs = cfg.band_spec._replace(block_dtype=dtype)
    pos, (c0, c1, c2) = _cut_columns(pos, box, bs)
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, ovf, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    R = bs.rows
    assert not bool(ovf) and int(nv[c0]) == 0
    assert int(nv[c1]) > 0 and int(nv[c1]) % R == 0
    assert int(nv[c2]) % R != 0
    f = vec_to_cells(bins, bs.bins, torch.randn(pos.shape, device=cuda))
    g = vec_to_cells(bins, bs.bins, torch.randn(pos.shape, device=cuda))
    args = (bins, 0.2, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    ref = bdn.matvec_banded_reference(*args[:9], f, p.self_mobility)
    blocks, u_b = bdn.build_mv_banded(*args, f, p.self_mobility)
    u = bdn.matvec_banded(blocks, *args, f, p.self_mobility)
    assert _rel(u, ref) < bound
    assert _rel_max(u, u_b) < 1e-6
    fg = torch.cat([f, g])
    u2 = bdn.matvec_banded(blocks, *args, fg, p.self_mobility)
    ug = bdn.matvec_banded(blocks, *args, g, p.self_mobility)
    assert _rel_max(u2, torch.cat([u, ug])) < 1e-4
    assert torch.equal(bdn.matvec_banded(blocks, *args, f, p.self_mobility),
                       u)
    assert torch.equal(bdn.matvec_banded(blocks, *args, fg, p.self_mobility),
                       u2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_at_empty_full_and_ragged_columns(cuda, dtype):
    """The build skips the tiles past ceil(n_valid / R) and writes their A
    rows as zeros: with one column empty, one at a multiple of R and one
    not (cut from N = 5300 in L = 40), build_mv at one and two right-hand
    sides and the build alone write the same A, bitwise the plain build
    (the build rounds as its plain version does, then to the block dtype),
    zero in every row of an empty tile; build_mv's u is bitwise the
    matvec's on that A and within the bound of the plain version.  Each
    dtype with its own pair-function fit: degree 8 at bfloat16 (the
    unrolled recurrence), degree 12 at float32 (the general one)."""
    cfg, pos, box = _setup(5300, 40.0, 0.2, block_dtype=dtype)
    assert cfg.cheb.degree == (8 if dtype == "bfloat16" else 12)
    p = cfg.params
    bs = cfg.band_spec
    pos, (c0, c1, c2) = _cut_columns(pos, box, bs)
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, ovf, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    R = bs.rows
    assert not bool(ovf) and int(nv[c0]) == 0
    assert int(nv[c1]) > 0 and int(nv[c1]) % R == 0
    assert int(nv[c2]) % R != 0
    f = vec_to_cells(bins, bs.bins, torch.randn(pos.shape, device=cuda))
    g = vec_to_cells(bins, bs.bins, torch.randn(pos.shape, device=cuda))
    args = (bins, 0.2, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    A = bdn.build_banded_blocks(*args)
    assert torch.equal(A, bdn.build_banded_blocks_reference(*args))
    live = (nv.long() + R - 1) // R * R                    # rows of live tiles
    rows = torch.arange(bs.bins.cap, device=cuda)
    empty = rows[None, :] >= live[:, None]                 # (C, S)
    assert bool(empty[c0].all())
    assert int(empty[c1].sum()) == bs.bins.cap - int(nv[c1])
    assert int((A[0].float().abs().sum(dim=(1, 3)) * empty).count_nonzero()
               ) == 0
    for rhs in (f, torch.cat([f, g])):
        ref = bdn._reference_per_rhs(rhs, lambda fk: (
            bdn.matvec_banded_reference(*args[:9], fk, p.self_mobility)))
        blocks, u = bdn.build_mv_banded(*args, rhs, p.self_mobility)
        assert torch.equal(blocks, A)
        assert _rel(u, ref) < (1e-5 if dtype == "float32" else 2e-3)
        assert torch.equal(
            bdn.matvec_banded(blocks, *args, rhs, p.self_mobility), u)


def _rcut_edge_positions(n, L, rcut, seed, pairs=80):
    """Uniform positions whose first ``pairs`` pairs straddle a periodic
    face at a distance within a few float32 ulps of rcut."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    h = L / 2
    for k in range(pairs):
        d = rng.normal(size=3)
        a = rng.uniform(-h, h, 3)
        a[k % 3] = (h - rng.uniform(0, 1)) * (1 if k % 2 else -1)
        b = a + rcut * (1 + rng.integers(-6, 7) * 2.0 ** -24) * d \
            / np.linalg.norm(d)
        pos[2 * k], pos[2 * k + 1] = a, (b + h) % L - h
    return pos


def _split_edge_pairs(args):
    """Occupied window pairs that the window's shifted z (the matvec's
    geometry) and the minimum image of the z separation (the build's) put
    on opposite sides of rcut^2."""
    bins, tilt, bs, _, L, rcut, _, j0, nv, zsh = args
    cut2 = np.float32(float(rcut) ** 2)
    C, R = bs.bins.n_cells_total, bs.rows
    Lz = float(np.float32(L[2]))
    split = 0
    for h in range(bdn.N_HALF):
        dx, dy, wdz, mi, mj, same, nbr, slot = bdn.window_geometry(
            bins, tilt, bs, L, j0, nv, zsh, h)
        dz = bins.pz.reshape(C, -1, R, 1) - bins.pz[nbr[:, None, None],
                                                    slot][:, :, None, :]
        dz = dz - Lz * torch.round(dz / Lz)
        occupied = (mi * mj > 0) & ~same
        xy = dx * dx + dy * dy
        split += int((occupied & ((xy + wdz * wdz < cut2)
                                  != (xy + dz * dz < cut2))).sum())
    return split


@pytest.mark.parametrize("tilt", [0.0, 0.2])
def test_banded_kernels_decide_rcut_edge_pairs_as_the_plain_version(cuda,
                                                                   tilt):
    """80 pairs across the periodic faces within float32 rounding of rcut
    (N = 5300, L = 40, float32 A), some of which the window's shifted z
    and the minimum image of the z separation put on opposite sides of
    rcut: the build kernel takes the minimum image, so its A is bitwise the
    plain build's and build_mv's u is within 1e-5 of the 9-offset
    matvec_banded_reference's (a pair decided otherwise moves u by
    ~1e-3); the matvec on that A is bitwise build_mv's."""
    cfg, _, box = _setup(5300, 40.0, tilt, block_dtype="float32")
    p, bs = cfg.params, cfg.band_spec
    pos = torch.as_tensor(_rcut_edge_positions(5300, 40.0, p.ewald_cut, 5),
                          device=cuda)
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, ovf, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    assert not bool(ovf)
    args = (bins, tilt, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    assert _split_edge_pairs(args) > 0
    A = bdn.build_banded_blocks(*args)
    assert torch.equal(A, bdn.build_banded_blocks_reference(*args))
    f = vec_to_cells(bins, bs.bins, torch.randn(pos.shape, device=cuda))
    ref = bdn.matvec_banded_reference(*args[:9], f, p.self_mobility)
    blocks, u = bdn.build_mv_banded(*args, f, p.self_mobility)
    assert torch.equal(blocks, A)
    assert _rel(u, ref) < 1e-5
    assert torch.equal(bdn.matvec_banded(blocks, *args, f, p.self_mobility),
                       u)


@pytest.mark.parametrize("nrhs,window,rows,cap,Lz", [
    (1, 128, 32, 13408, 400.0), (2, 256, 32, 5760, 400.0),
    (2, 64, 16, 5360, 1600.0)])
def test_matvec_at_the_largest_cap_build_mv_launches(cuda, nrhs, window,
                                                     rows, cap, Lz):
    """build_mv is the build kernel, whose shared memory does not grow with
    S, then the matvec, whose shared memory grows with S only by its rank
    accumulator: so build_mv launches up to the matvec's largest cap S for
    this window, row tile and number of right-hand sides (13,408 at one RHS
    and W = 128, 5,360 at two RHS, W = 64 and R = 16: above the 5,440 and
    3,408 of the build_mv that kept the whole column in shared memory).
    There, in a tall box (24 x 24 x Lz, 12 columns of over 1000 particles,
    so several passes of tiles per block), build_mv and the matvec against
    the plain version, each other (bitwise) and a rerun (bitwise)."""
    L = (24.0, 24.0, Lz)
    n = 12 * (1200 if Lz == 400.0 else 1100)
    params = make_params(xi=0.5, error=1e-3, L=L)
    cfg = pi.make_config(params, n, engine="banded", has_forces=False,
                         device="cuda")
    p = cfg.params
    bs = cfg.band_spec
    bs = bs._replace(window=window, rows=rows,
                     bins=bs.bins._replace(cap=cap), classes=None,
                     slab_classes=None)
    assert bs.bins.n_cells_total == 12
    rng = np.random.default_rng(0)
    pos = torch.as_tensor((rng.uniform(-0.5, 0.5, size=(n, 3))
                           * np.array(L)).astype(np.float32), device=cuda)
    box = make_box(L, 0.2)
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, ovf, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    assert not bool(ovf) and int(nv.min()) > 1000
    f = torch.cat([vec_to_cells(bins, bs.bins,
                                torch.randn(pos.shape, device=cuda))
                   for _ in range(nrhs)])
    args = (bins, 0.2, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    ref = bdn._reference_per_rhs(f, lambda fk: bdn.matvec_banded_reference(
        *args[:9], fk, p.self_mobility))
    blocks, u_b = bdn.build_mv_banded(*args, f, p.self_mobility)
    u = bdn.matvec_banded(blocks, *args, f, p.self_mobility)
    assert _rel(u, ref) < 2e-3
    assert torch.equal(u, u_b)
    assert torch.equal(bdn.matvec_banded(blocks, *args, f, p.self_mobility),
                       u)


@pytest.mark.parametrize("nrhs", [1, 2])
def test_matvec_reruns_are_bitwise_equal(cuda, nrhs):
    """No float atomics: the same launch gives the same bits, at the
    default window and the widest (W = 256), bf16 blocks."""
    cfg, pos, box = _setup(5300, 40.0, 0.3)
    p = cfg.params
    for window in (None, 256):
        bs = cfg.band_spec if window is None else \
            cfg.band_spec._replace(window=window)
        bins = bin_columns(pos, box, bs.bins)
        j0, nv, _, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
        f = torch.cat([vec_to_cells(bins, bs.bins,
                                    torch.randn(pos.shape, device=cuda))
                       for _ in range(nrhs)])
        args = (bins, 0.3, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0,
                nv, zsh)
        blocks, _ = bdn.build_mv_banded(*args, f[:3], p.self_mobility)
        u = bdn.matvec_banded(blocks, *args, f, p.self_mobility)
        for _ in range(3):
            assert torch.equal(
                bdn.matvec_banded(blocks, *args, f, p.self_mobility), u)


@pytest.mark.parametrize("nrhs", [1, 2])
def test_build_mv_reruns_are_bitwise_equal(cuda, nrhs):
    """No float atomics in the build either: the same build_mv launch
    gives the same A and u, at the default window and the widest (W =
    256), bf16 blocks."""
    cfg, pos, box = _setup(5300, 40.0, 0.3)
    p = cfg.params
    for window in (None, 256):
        bs = cfg.band_spec if window is None else \
            cfg.band_spec._replace(window=window)
        bins = bin_columns(pos, box, bs.bins)
        j0, nv, _, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
        f = torch.cat([vec_to_cells(bins, bs.bins,
                                    torch.randn(pos.shape, device=cuda))
                       for _ in range(nrhs)])
        args = (bins, 0.3, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0,
                nv, zsh)
        blocks, u = bdn.build_mv_banded(*args, f, p.self_mobility)
        for _ in range(3):
            again, u_again = bdn.build_mv_banded(*args, f, p.self_mobility)
            assert torch.equal(again, blocks) and torch.equal(u_again, u)


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5),
                                         ("bfloat16", 5e-3)])
@pytest.mark.parametrize("n,L,tilt", [(5300, 40.0, 0.25),
                                      (2048, 26.71378026056561, 0.0)])
def test_contract_kernel_matches_plain_version(cuda, dtype, bound, n, L,
                                               tilt):
    """At N = 5300 in L = 40 and at the oracle's shapes (NN = 729, cap 312,
    Nz = 27: no tile multiple, a window that wraps onto itself); reruns
    are bitwise equal."""
    cfg, pos, box = _setup(n, L, tilt)
    p = cfg.params
    spec = cfg.colff_spec._replace(weight_dtype=dtype)
    fac = cff.build_col_factors(bin_particles(pos, box, spec.bins), box,
                                spec, p)
    grid = torch.randn((3, p.Nx, p.Ny, p.Nz), device=cuda)
    got = cff.contract_col_kernel(grid, spec, p, fac)
    want = cff.contract_col(grid, spec, p, fac)
    assert _rel_max(got, want) < bound
    assert torch.equal(cff.contract_col_kernel(grid, spec, p, fac), got)


def test_step_on_card_matches_cpu_step(cuda):
    """The whole step, float32 blocks and factors, card vs CPU."""
    n, L = 1080, 24.0
    params = make_params(xi=0.5, error=1e-3, L=L)
    gpu = pi.make_config(params, n, engine="banded", has_forces=False,
                         block_dtype="float32", ff_weight_dtype="float32",
                         device="cuda")
    cpu = pi.make_config(params, n, engine="banded", has_forces=False,
                         block_dtype="float32", device="cpu")
    rng = np.random.default_rng(3)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    bs, p = cpu.band_spec.bins, params
    draws = (rng.uniform(-1.7, 1.7, (3, bs.n_cells[0] * bs.n_cells[1],
                                     bs.cap)).astype(np.float32),
             rng.uniform(-1.2, 1.2, (6, p.Nx, p.Ny, p.Nz // 2 + 1)
                         ).astype(np.float32))
    f0 = torch.zeros((n, 3))
    _, ic = pi.step(cpu, pi.make_state(pos, device="cpu"), f0, 1.0, 1e-3,
                    0.3, uniforms=draws)
    _, ig = pi.step(gpu, pi.make_state(pos, device="cuda"), f0, 1.0, 1e-3,
                    0.3, uniforms=draws)
    assert ig["m_lanczos"] == ic["m_lanczos"]
    assert _rel_max(ig["velocities"].cpu(), ic["velocities"]) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,L,tilt", [(5300, 40.0, 0.25),
                                      (2048, 26.71378026056561, 0.0)])
def test_spread_kernel_matches_plain_version(cuda, dtype, n, L, tilt):
    """The moments and the folded grid at N = 5300 in L = 40 and at the
    oracle's shapes (NN = 729, cap 312, Nz = 27), with the contract's
    factors in either dtype: the spread computes float32 factors of the
    slots' node-space coordinates either way, held to the plain version's
    at 1e-5; reruns bitwise, one launch a call."""
    cfg, pos, box = _setup(n, L, tilt)
    p = cfg.params
    spec = cfg.colff_spec._replace(weight_dtype=dtype)
    bins, f = bin_particles(pos, box, spec.bins,
                            values=torch.randn(pos.shape, device=cuda))
    nodes = cff.spread_nodes(bins, box, p)
    before = trace.counters().get("launch.spread_moments_kernel", 0)
    got = cff.spread_moments_kernel(f, spec, p, nodes, tilt)
    assert trace.counters()["launch.spread_moments_kernel"] == before + 1
    want = cff.spread_moments(f, spec, p, nodes, tilt)
    assert _rel_max(got, want) < 1e-5
    assert torch.equal(cff.spread_moments_kernel(f, spec, p, nodes, tilt),
                       got)
    assert _rel_max(cff.spread_col_kernel(f, spec, p, nodes, tilt),
                    cff.spread_col(f, spec, p, nodes, tilt)) < 1e-5


@pytest.mark.parametrize("n,L,tilt", [(5300, 40.0, 0.25),
                                      (2048, 26.71378026056561, 0.0)])
def test_reach_spread_kernel_matches_plain_version(cuda, n, L, tilt):
    """What a step spreads forces with: the engine's spread on a prepared
    step (the contract's factors in the config's dtype) launches the kernel
    once and matches the plain spread of the slots' float32 factors at
    1e-5."""
    params = make_params(xi=0.5, error=1e-3, L=L)
    cfg = pi.make_config(params, n, engine="banded", has_forces=True,
                         device="cuda")
    rng = np.random.default_rng(1)
    pos = torch.as_tensor(
        rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32),
        device="cuda")
    forces = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32),
                             device="cuda")
    box = make_box(L, tilt)
    eng = pi.engine_of(cfg)
    ctx, _ = eng.prepare(pos, box, forces)
    before = trace.counters().get("launch.spread_moments_kernel", 0)
    got = eng.spread(ctx, box)
    assert trace.counters()["launch.spread_moments_kernel"] == before + 1
    want = cff.spread_col(ctx.ff_f, cfg.colff_spec, params,
                          cff.spread_nodes(ctx.ff_bins, box, params), tilt)
    assert _rel_max(got, want) < 1e-5


@pytest.mark.parametrize("cap", [1, 15, 300])
@pytest.mark.parametrize("ncx,ncy,sx,sy,nz", [(3, 4, 3, 2, 20),
                                              (3, 3, 5, 4, 24),
                                              (3, 3, 9, 9, 12),
                                              (3, 3, 2, 2, 100)])
def test_reach_spread_kernel_at_ragged_shapes(cuda, cap, ncx, ncy, sx, sy,
                                              nz):
    """The spread kernel on hand-built slots (uniform in their columns, a
    third of them empty, tilt 0.2) at 54, 180 and 729 window nodes (z
    chunks of 32, 16 and 4), z columns shorter than, near and far past
    the Gaussian's reach, and slot counts of one, a few and past a block's
    threads: held to the plain version at 1e-5, reruns bitwise."""
    L = (ncx * sx * 0.9, ncy * sy * 1.1, nz * 0.95)
    params = SimpleNamespace(Nx=ncx * sx, Ny=ncy * sy, Nz=nz, L=L,
                             spread_expfac=1.2, spread_prefac=0.37,
                             quadW=0.81)
    spec = cff.ColFfSpec(bins=BinSpec(n_cells=(ncx, ncy, 1), cap=cap),
                         s=(sx, sy), weight_dtype="bfloat16")
    C = ncx * ncy
    rng = np.random.default_rng(cap + nz)
    col = np.arange(C)
    nodes = np.stack([
        ((col // ncy)[:, None] + rng.uniform(0, 1, (C, cap))) * sx,
        ((col % ncy)[:, None] + rng.uniform(0, 1, (C, cap))) * sy,
        rng.uniform(0, nz, (C, cap)),
        (rng.uniform(0, 1, (C, cap)) < 0.67).astype(np.float64)])
    nodes = torch.as_tensor(nodes.astype(np.float32), device=cuda)
    f = torch.as_tensor(rng.normal(size=(3, C, cap)).astype(np.float32),
                        device=cuda) * nodes[3]
    got = cff.spread_moments_kernel(f, spec, params, nodes, 0.2)
    assert _rel_max(got, cff.spread_moments(f, spec, params, nodes, 0.2)
                    ) < 1e-5
    assert torch.equal(cff.spread_moments_kernel(f, spec, params, nodes, 0.2),
                       got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [1, 15, 16, 17, 248])
@pytest.mark.parametrize("ncx,ncy,sx,sy,nz", [(3, 4, 3, 2, 20),
                                              (3, 3, 5, 4, 24),
                                              (3, 3, 2, 2, 100),
                                              (3, 3, 1, 2, 300)])
def test_far_field_kernels_at_ragged_shapes(cuda, dtype, cap, ncx, ncy, sx,
                                            sy, nz):
    """Spread and contract on hand-built operands: 3 x 4 columns of
    (sx, sy) = (3, 2) nodes (NN = 54, Nz = 20); 3 x 3 columns of (5, 4)
    nodes (NN = 180, Nz = 24: the contract streams wxy instead of keeping
    it resident); Nz = 100 (two z chunks in the contract) and Nz = 300, at
    slot counts at and around one 16-deep product step and at the main
    path's 248 (only 16 and 248 take the contract's 16-byte staging).  The
    contract's factors are in ``dtype``; the spread takes the slots'
    node-space coordinates (uniform in their columns, a third of the slots
    empty, tilt 0.2) and computes float32 factors whatever ``dtype`` is.
    Held to the plain versions (spread 1e-5, contract 1e-5 / 5e-3), reruns
    bitwise equal.  The grid is positive, so the bf16 contract's H rounding
    (plain version only) cannot be magnified by cancellation."""
    L = (ncx * sx * 0.9, ncy * sy * 1.1, nz * 0.95)
    params = SimpleNamespace(Nx=ncx * sx, Ny=ncy * sy, Nz=nz, L=L,
                             spread_expfac=1.2, spread_prefac=0.37,
                             quadW=0.81)
    spec = cff.ColFfSpec(bins=BinSpec(n_cells=(ncx, ncy, 1), cap=cap),
                         s=(sx, sy), weight_dtype=dtype)
    C, nn = ncx * ncy, 9 * sx * sy
    rng = np.random.default_rng(cap)
    wdt = getattr(torch, dtype)

    def dev(a, dt=torch.float32):
        return torch.as_tensor(a.astype(np.float32), device=cuda).to(dt)

    fac = cff.ColFactors(wxy=dev(rng.uniform(0, 1, (C, nn, cap)), wdt),
                         wz=dev(rng.uniform(0, 1, (C, nz, cap)), wdt))
    col = np.arange(C)
    nodes = dev(np.stack([
        ((col // ncy)[:, None] + rng.uniform(0, 1, (C, cap))) * sx,
        ((col % ncy)[:, None] + rng.uniform(0, 1, (C, cap))) * sy,
        rng.uniform(0, nz, (C, cap)),
        (rng.uniform(0, 1, (C, cap)) < 0.67).astype(np.float64)]))
    f = dev(rng.normal(size=(3, C, cap))) * nodes[3]
    grid = dev(rng.uniform(0, 1, (3, params.Nx, params.Ny, nz)))
    c_bound = 1e-5 if dtype == "float32" else 5e-3
    got = cff.spread_moments_kernel(f, spec, params, nodes, 0.2)
    assert _rel_max(got, cff.spread_moments(f, spec, params, nodes, 0.2)
                    ) < 1e-5
    assert torch.equal(cff.spread_moments_kernel(f, spec, params, nodes, 0.2),
                       got)
    got = cff.contract_col_kernel(grid, spec, params, fac)
    assert _rel_max(got, cff.contract_col(grid, spec, params, fac)) < c_bound
    assert torch.equal(cff.contract_col_kernel(grid, spec, params, fac), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,L,tilt,window", [
    (1080, 24.0, 0.0, None), (5300, 40.0, 0.3, None), (5300, 40.0, 0.1, 256)])
def test_two_rhs_and_build_only_banded_kernels(cuda, dtype, n, L, tilt,
                                               window):
    """Two right-hand sides against two one-RHS launches (<= 1e-4, the JAX
    gate's fused bound), at the default and the widest window (the shared
    partials and rank accumulator are largest there); the build alone
    writes build_mv's A bit for bit, within 1e-6 (float32) or 2^-8
    (bfloat16, against the float32 plain build) of max |A| of the plain
    build."""
    cfg, pos, box = _setup(n, L, tilt)
    p = cfg.params
    bs = cfg.band_spec._replace(block_dtype=dtype)
    if window is not None:
        bs = bs._replace(window=window)
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, _, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    f = vec_to_cells(bins, bs.bins, torch.randn(pos.shape, device=cuda))
    g = vec_to_cells(bins, bs.bins, torch.randn(pos.shape, device=cuda))
    fg = torch.cat([f, g])
    args = (bins, tilt, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    blocks2, u2 = bdn.build_mv_banded(*args, fg, p.self_mobility)
    blocks1, u1 = bdn.build_mv_banded(*args, f, p.self_mobility)
    assert torch.equal(blocks1, blocks2)
    m2 = bdn.matvec_banded(blocks1, *args, fg, p.self_mobility)
    m1 = torch.cat([bdn.matvec_banded(blocks1, *args, f, p.self_mobility),
                    bdn.matvec_banded(blocks1, *args, g, p.self_mobility)])
    assert _rel_max(u2[:3], u1) < 1e-4
    assert _rel_max(m2, m1) < 1e-4
    A = bdn.build_banded_blocks(*args)
    assert torch.equal(A, blocks1)
    plain = bdn.build_banded_blocks_reference(
        *args[:2], bs._replace(block_dtype="float32"), *args[3:])
    bound = 1e-6 if dtype == "float32" else 2.0 ** -8
    for k in range(2):
        assert _rel_max(A[:, :, k].float(), plain[:, :, k]) < bound


@pytest.mark.parametrize("thermal", [True, False])
def test_with_forces_step_and_mobility_on_card_match_cpu(cuda, thermal):
    """The step with forces (two-RHS build when thermal) and U = M F,
    float32 blocks and factors, card vs CPU."""
    n, L = 1080, 24.0
    params = make_params(xi=0.5, error=1e-3, L=L)
    kw = dict(engine="banded", thermal=thermal, block_dtype="float32")
    gpu = pi.make_config(params, n, ff_weight_dtype="float32", device="cuda",
                         **kw)
    cpu = pi.make_config(params, n, device="cpu", **kw)
    rng = np.random.default_rng(5)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    forces = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    bs, p = cpu.band_spec.bins, params
    draws = (rng.uniform(-1.7, 1.7, (3, bs.n_cells[0] * bs.n_cells[1],
                                     bs.cap)).astype(np.float32),
             rng.uniform(-1.2, 1.2, (6, p.Nx, p.Ny, p.Nz // 2 + 1)
                         ).astype(np.float32)) if thermal else None
    _, ic = pi.step(cpu, pi.make_state(pos, 2, 0.3, "cpu"), forces, 1.0,
                    1e-3, 0.4, uniforms=draws)
    _, ig = pi.step(gpu, pi.make_state(pos, 2, 0.3, "cuda"), forces.cuda(),
                    1.0, 1e-3, 0.4, uniforms=draws)
    assert ig["m_lanczos"] == ic["m_lanczos"]
    assert _rel_max(ig["velocities"].cpu(), ic["velocities"]) < 1e-4
    uc, _ = pi.mobility(cpu, pos, forces, 0.3)
    ug, og = pi.mobility(gpu, pos, forces, 0.3)
    assert int(og) == 0 and _rel_max(ug.cpu(), uc) < 1e-4


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_fill_kernel_at_3d_cells_is_bitwise_the_plain_version(
        cuda, tilt, with_values):
    """The fill on the blocked near field's 3-D cell grid (and its
    overfull case): every output bitwise its plain version's."""
    params = make_params(xi=0.5, error=1e-3, L=40.0)
    cfg = pi.make_config(params, 5300, device="cuda")
    spec = cfg.nf_spec.bins
    assert cfg.engine == "blocked" and min(spec.n_cells) >= 3
    _, pos, box = _setup(5300, 40.0, tilt)
    vals = torch.randn(pos.shape, device=cuda) if with_values else None
    for overfull in (False, True):
        if overfull:
            pos[:700] = 0.5                    # one overfull cell
        got = _assert_fill_bitwise(*fill_operands(pos, box, spec, False),
                                   spec.n_cells_total, spec.cap, vals)
        assert bool(got.overflow) == overfull


@pytest.mark.parametrize("thermal,has_forces", [(True, False), (True, True),
                                                (False, True)])
def test_blocked_step_and_mobility_on_card_match_cpu(cuda, thermal,
                                                     has_forces):
    """The blocked engine's step (and U = M F), float32 blocks and factors,
    card vs CPU, through the fill, contract and spread kernels and no
    banded kernel."""
    n, L = 1080, 24.0
    params = make_params(xi=0.5, error=1e-3, L=L)
    kw = dict(thermal=thermal, has_forces=has_forces, block_dtype="float32")
    gpu = pi.make_config(params, n, ff_weight_dtype="float32", device="cuda",
                         **kw)
    cpu = pi.make_config(params, n, device="cpu", **kw)
    assert gpu.engine == cpu.engine == "blocked"
    rng = np.random.default_rng(6)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    forces = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    bs, p = cpu.nf_spec.bins, params
    draws = (rng.uniform(-1.7, 1.7, (3, bs.n_cells_total, bs.cap)
                         ).astype(np.float32),
             rng.uniform(-1.2, 1.2, (6, p.Nx, p.Ny, p.Nz // 2 + 1)
                         ).astype(np.float32)) if thermal else None
    before = trace.counters()
    T = 1.0 if thermal else 0.0
    _, ic = pi.step(cpu, pi.make_state(pos, 2, 0.3, "cpu"),
                    forces if has_forces else None, T, 1e-3, 0.4,
                    uniforms=draws)
    _, ig = pi.step(gpu, pi.make_state(pos, 2, 0.3, "cuda"),
                    forces.cuda() if has_forces else None, T, 1e-3, 0.4,
                    uniforms=draws)
    assert ig["m_lanczos"] == ic["m_lanczos"]
    assert _rel_max(ig["velocities"].cpu(), ic["velocities"]) < 1e-4
    launches = _launched(before)
    assert launches[0] == 2 and launches[1] == 1
    assert launches[2] == int(has_forces) and launches[3:] == [0, 0]
    uc, _ = pi.mobility(cpu, pos, forces, 0.3)
    ug, og = pi.mobility(gpu, pos, forces, 0.3)
    assert int(og) == 0 and _rel_max(ug.cpu(), uc) < 1e-4


@pytest.mark.parametrize("box,n,subdiv", [(10.0, 107, 1),      # all-pairs
                                          (26.71, 2048, 1),    # 3 x 5 x 5
                                          (26.71, 2048, 2)])   # stencil
@pytest.mark.parametrize("thermal,has_forces", [(True, False), (True, True),
                                                (False, True)])
def test_gather_step_and_mobility_on_card_match_cpu(cuda, box, n, subdiv,
                                                    thermal, has_forces):
    """The gather engine's step and U = M F, card vs CPU: velocities <=
    1e-4 with equal m, the neighbor idx equal, reruns bitwise (the tap
    spread included); the cell list's binning runs the fill kernel once
    per step, the all-pairs list none, and no other kernel launches."""
    from pse_tpu_torch import neighbors as nb
    from pse_tpu_torch.ops import farfield as ff

    params = make_params(xi=0.5, error=1e-3, L=box)
    kw = dict(engine="gather", thermal=thermal, has_forces=has_forces,
              nbr_subdiv=subdiv)
    gpu = pi.make_config(params, n, device="cuda", **kw)
    cpu = pi.make_config(params, n, device="cpu", **kw)
    assert gpu.engine == cpu.engine == "gather"
    rng = np.random.default_rng(9)
    pos = rng.uniform(-box / 2, box / 2, size=(n, 3)).astype(np.float32)
    forces = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    p = params
    draws = (rng.uniform(-1.7, 1.7, (3, n)).astype(np.float32),
             rng.uniform(-1.2, 1.2, (6, p.Nx, p.Ny, p.Nz // 2 + 1)
                         ).astype(np.float32)) if thermal else None
    T = 1.0 if thermal else 0.0
    before = trace.counters()
    _, ic = pi.step(cpu, pi.make_state(pos, 2, 0.3, "cpu"),
                    forces if has_forces else None, T, 1e-3, 0.4,
                    uniforms=draws)
    runs = [pi.step(gpu, pi.make_state(pos, 2, 0.3, "cuda"),
                    forces.cuda() if has_forces else None, T, 1e-3, 0.4,
                    uniforms=draws)[1] for _ in range(2)]
    assert runs[0]["m_lanczos"] == ic["m_lanczos"]
    assert _rel_max(runs[0]["velocities"].cpu(), ic["velocities"]) < 1e-4
    assert torch.equal(runs[0]["velocities"], runs[1]["velocities"])
    cells = 0 if gpu.nbr_spec.all_pairs else 1
    assert _launched(before) == [2 * cells, 0, 0, 0, 0]
    box_t = make_box(box, 0.3)
    lg = nb.build_neighbor_list(torch.as_tensor(pos, device="cuda"), box_t,
                                gpu.nbr_spec)
    lc = nb.build_neighbor_list(torch.as_tensor(pos), box_t, cpu.nbr_spec)
    assert torch.equal(lg.idx.cpu(), lc.idx) and not bool(lg.overflow)
    taps = ff.compute_taps(torch.as_tensor(pos, device="cuda"), box_t, p)
    g1 = ff.spread(taps, forces.cuda(), p)
    assert torch.equal(g1, ff.spread(taps, forces.cuda(), p))
    if not thermal:
        uc, _ = pi.mobility(cpu, pos, forces, 0.3)
        ug, og = pi.mobility(gpu, pos, forces, 0.3)
        assert int(og) == 0 and _rel_max(ug.cpu(), uc) < 1e-4


@pytest.mark.parametrize("nrhs", [1, 2])
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5),
                                         ("bfloat16", 2e-3)])
@pytest.mark.parametrize("tilt", [0.0, 0.07, 0.3])
def test_class_packed_kernels_are_bitwise_the_single_class(cuda, nrhs, dtype,
                                                          bound, tilt):
    """Occupancy classes (tests/test_banded.py's manual 2-class split at
    N = 1080, L = 24): the packed build_mv and matvec give the single-class
    kernels' u bit for bit, within the plain version's bound; the packed A
    is the single-class A's tiles of its columns; reruns are bitwise."""
    cfg, pos, box = _setup(1080, 24.0, tilt, seed=31, block_dtype=dtype)
    p, bs1 = cfg.params, cfg.band_spec
    C, t_cap = bs1.bins.n_cells_total, bs1.bins.cap // bs1.rows
    bs = bs1._replace(classes=((t_cap - 1, C - 2), (t_cap, 2)))
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, _, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    perm, inv, ovf = bdn.class_assignment(bs, nv)
    assert not bool(ovf)
    f = torch.cat([vec_to_cells(bins, bs.bins, torch.randn(
        pos.shape, generator=torch.Generator(device="cuda").manual_seed(k),
        device=cuda)) for k in range(nrhs)])
    args = (bins, box.tilt_xy, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr,
            j0, nv, zsh)
    args1 = (bins, box.tilt_xy, bs1) + args[3:]
    blocks, u = bdn.build_mv_banded(*args, f, p.self_mobility,
                                    pack=(perm, inv))
    blocks1, u1 = bdn.build_mv_banded(*args1, f, p.self_mobility)
    assert isinstance(blocks, tuple) and len(blocks) == 2
    assert torch.equal(u, u1)
    um = bdn.matvec_banded(blocks, *args, f, p.self_mobility,
                           pack=(perm, inv))
    assert torch.equal(um, bdn.matvec_banded(blocks1, *args1, f,
                                             p.self_mobility))
    assert torch.equal(um, bdn.matvec_banded(blocks, *args, f,
                                             p.self_mobility,
                                             pack=(perm, inv)))
    for a, b in zip(blocks, bdn.pack_blocks_reference(blocks1, bs, perm)):
        assert torch.equal(a, b)
    ref = torch.cat([bdn.matvec_banded_reference(
        *args1[:9], f[k:k + 3], p.self_mobility) for k in range(0, 3 * nrhs,
                                                                3)])
    assert _rel(um, ref) < bound
    with pytest.raises(ValueError, match="pack"):
        bdn.matvec_banded(blocks, *args, f, p.self_mobility)
    with pytest.raises(ValueError, match="single-class"):
        bdn.build_banded_blocks(*args)


def test_class_packed_overflow_flags_and_stays_in_bounds(cuda):
    """A top class too small: the step's mask carries OVF_CLASS, and the
    packed build_mv runs (its over-full columns cut to their class's tiles)
    with a finite result."""
    cfg, pos, box = _setup(1080, 24.0, 0.3, seed=31)
    bs = cfg.band_spec
    C, t_cap = bs.bins.n_cells_total, bs.bins.cap // bs.rows
    ocfg = dataclasses.replace(cfg, band_spec=bs._replace(
        classes=((2, C - 1), (t_cap, 1))))
    forces = torch.randn(pos.shape, device=cuda)
    eng = pi.engine_of(ocfg)
    ctx, mask = eng.prepare(pos, box, forces)
    assert int(mask) & pi.OVF_CLASS
    _, u = eng.build_mv(ctx, ctx.nf_f)
    assert bool(torch.isfinite(u).all())


def _halo_problem(dtype, slabs=2, seed=1):
    """tests/test_halo.py's box (N = 4800, L = 33) at ``slabs`` slabs:
    (config, positions, forces), and two slab classes that fit it."""
    from pse_tpu_torch.ops import banded_nearfield as b

    n, L = 4800, 33.0
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    cfg = pi.make_config(make_params(xi=0.5, error=1e-3, L=L), n,
                         engine="banded", shard_slabs=slabs, seed=3,
                         block_dtype=dtype, ff_weight_dtype=dtype,
                         device="cuda")
    bs = cfg.band_spec
    ncx, ncy, _ = bs.bins.n_cells
    counts = b.make_slab_counts(bs, slabs, b.measure_col_counts(
        bs, pos, cfg.params.L))
    low = max(int(np.sort(-(-np.maximum(c, 1) // bs.rows))[::-1][2])
              for c in counts)
    classes = ((low, (ncx // slabs + 2) * ncy - 2), (bs.bins.cap // bs.rows,
                                                     2))
    return cfg, pos, forces, classes


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4),
                                         ("bfloat16", 2e-3)])
def test_halo_two_slabs_match_one_device_on_card(cuda, dtype, bound):
    """The halo engine at D = 2 slabs on one card against the one-device
    engine: mobility (tilts 0 and 0.3) and the thermal step with forces at
    equal uniforms within ``bound`` (2-norm); with slab classes bitwise
    without; the kernels launch D and D (m - 1) times per step."""
    from pse_tpu_torch.parallel import halo, sharding

    cfg, pos, forces, classes = _halo_problem(dtype)
    mesh = sharding.make_mesh([cuda] * 2)
    no_cls = dataclasses.replace(cfg, band_spec=cfg.band_spec._replace(
        slab_classes=None))
    with_cls = dataclasses.replace(cfg, band_spec=cfg.band_spec._replace(
        slab_classes=classes))
    for tilt in (0.0, 0.3):
        u1, o1 = pi.mobility(no_cls, pos, forces, tilt)
        u, o = halo.make_halo_mobility(no_cls, mesh)(pos, forces, tilt)
        uc, oc = halo.make_halo_mobility(with_cls, mesh)(pos, forces, tilt)
        assert int(o) == int(oc) == int(o1) == 0
        assert _rel(u, u1) < bound
        assert torch.equal(u, uc)
    rng = np.random.default_rng(5)
    bs, p = cfg.band_spec.bins, cfg.params
    draws = (rng.uniform(-1.7, 1.7, (3, bs.n_cells_total, bs.cap))
             .astype(np.float32),
             rng.uniform(-1.2, 1.2, (6, p.Nx, p.Ny, p.Nz // 2 + 1))
             .astype(np.float32))
    st = pi.make_state(pos, 3, 0.3, "cuda")
    f = torch.as_tensor(forces, device=cuda)
    s1, i1 = pi.step(no_cls, st, f, 1.0, 1e-3, 0.5, None, uniforms=draws)
    before = trace.counters()
    s2, i2 = halo.make_halo_step(with_cls, mesh)(st, f, 1.0, 1e-3, 0.5,
                                                 uniforms=draws)
    assert _launched(before)[3:] == [2, 2 * (i2["m_lanczos"] - 1)]
    assert i1["m_lanczos"] == i2["m_lanczos"] and int(s2.nbr_overflow) == 0
    assert _rel(s2.pos - st.pos, s1.pos - st.pos) < bound


def test_sharded_gather_is_bitwise_one_device_on_card(cuda):
    """The gather engine's rows split over 4 shards of one card: the
    thermal step with forces and mobility bitwise the one-device ones."""
    from pse_tpu_torch.parallel import sharding

    n, L = 1080, 24.0
    rng = np.random.default_rng(2)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    f = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32),
                        device=cuda)
    cfg = pi.make_config(make_params(xi=0.5, error=1e-3, L=L), n,
                         engine="gather", seed=4, device="cuda")
    mesh = sharding.make_mesh([cuda] * 4)
    st = pi.make_state(pos, 2, 0.03, "cuda")
    s1, i1 = pi.step(cfg, st, f, 1.0, 1e-3, 0.2, 0.031)
    s2, i2 = sharding.make_sharded_step(cfg, mesh)(st, f, 1.0, 1e-3, 0.2,
                                                   0.031)
    assert torch.equal(s1.pos, s2.pos)
    assert torch.equal(i1["velocities"], i2["velocities"])
    assert torch.equal(pi.mobility(cfg, pos, f, 0.03)[0],
                       sharding.make_sharded_mobility(cfg, mesh)(pos, f,
                                                                 0.03)[0])


# -- the blocked engine's pair blocks (csrc/blocked.cu) ----------------------

def _bitwise(a, b):
    """Same dtype, shape and bits (the sign of a zero included)."""
    iv = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(iv), b.view(iv)))


def _pair_blocks_checked(bins, box, spec, cfg):
    """build_pair_blocks on the card: bitwise (torch.equal, and bit for
    bit) build_pair_blocks_reference on the same CUDA tensors, one launch
    a call, a rerun bitwise equal; returns the blocks."""
    p = cfg.params
    args = (bins, box, spec, cfg.cheb, p.ewald_cut, p.ewald_dr)
    before = trace.counters().get("launch.build_pair_blocks", 0)
    got = bnf.build_pair_blocks(*args)
    assert trace.counters()["launch.build_pair_blocks"] == before + 1
    want = bnf.build_pair_blocks_reference(*args)
    assert got.dtype == getattr(torch, spec.block_dtype)
    assert torch.equal(got, want) and _bitwise(got, want)
    assert _bitwise(bnf.build_pair_blocks(*args), got)
    assert trace.counters()["launch.build_pair_blocks"] == before + 2
    return got


def _uniform(n, L, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32),
        device="cuda")


def _blocked_config(n, L, dtype):
    params = make_params(xi=0.5, error=1e-3 if dtype == "bfloat16" else 1e-4,
                         L=L)
    cfg = pi.make_config(params, n, device="cuda", block_dtype=dtype)
    assert cfg.engine == "blocked" and cfg.nf_spec.block_dtype == dtype
    return cfg


@pytest.mark.parametrize("part", [None, 0, 1])
@pytest.mark.parametrize("tilt", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_blocks_kernel_is_bitwise_the_plain_version(cuda, dtype, tilt,
                                                         part):
    """N = 1080 in L = 24 (cells (3, 3, 3), cap 80, not a multiple of 32),
    float32 blocks with the degree-12 fit (the general recurrence) and
    bfloat16 with the degree-8 one (unrolled), over the whole half stencil
    and over the first two of the four contiguous parts
    parallel/sharding.py passes four devices (the first holds (0,0,0));
    each part is that part of the whole build."""
    from pse_tpu_torch.parallel.sharding import _ranges

    cfg = _blocked_config(1080, 24.0, dtype)
    assert cfg.cheb.degree == (8 if dtype == "bfloat16" else 12)
    pos, box = _uniform(1080, 24.0, seed=3), make_box(24.0, tilt)
    bins = bin_particles(pos, box, cfg.nf_spec.bins)
    offs = cfg.nf_spec.offsets
    a, b = (0, len(offs)) if part is None else _ranges(len(offs), 4)[part]
    spec = cfg.nf_spec._replace(offsets=offs[a:b])
    got = _pair_blocks_checked(bins, box, spec, cfg)
    if part is not None:
        whole = _pair_blocks_checked(bins, box, cfg.nf_spec, cfg)
        assert _bitwise(got, whole[a:b].contiguous())
    assert bool(got.float().abs().amax() > 0)


def _hand_bins(spec, L, counts, seed):
    """CellBins on spec's grid with counts[c] particles in cell c, uniform
    inside the cell, in slots 0 .. counts[c] - 1; padded slots have mask 0
    and positions 0 (the CellBins contract)."""
    ncs = np.array(spec.n_cells)
    C, cap = spec.n_cells_total, spec.cap
    rng = np.random.default_rng(seed)
    xyz = np.zeros((3, C, cap), np.float32)
    mask = np.zeros((C, cap), np.float32)
    for c in range(C):
        at = np.array([c // (ncs[1] * ncs[2]), (c // ncs[2]) % ncs[1],
                       c % ncs[2]])
        n = counts[c]
        p = -L / 2 + (at + rng.uniform(size=(n, 3))) * (L / ncs)
        xyz[:, c, :n] = p.T
        mask[c, :n] = 1.0
    t = [torch.as_tensor(a, device="cuda") for a in (*xyz, mask)]
    return CellBins(*t, None, None, None, None)


@pytest.mark.parametrize("cap", [16, 40, 112])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_blocks_kernel_at_empty_full_and_ragged_cells(cuda, dtype, cap):
    """Cells (3, 4, 5) of L = 24 filled by hand: cell 0 empty, cell 1 full
    (n = cap), cell 2 ragged, the others at random occupancies, tilt 0.3;
    at cap 16 (the small-box fallback's: N = 64 in L = 24), 40 (not a
    multiple of 32) and 112 (the main path's): the blocks bitwise the
    plain version's, and zero in every slot pair of an empty slot."""
    cfg = _blocked_config(1080, 24.0, dtype)
    spec = bnf.NfSpec(bins=BinSpec(n_cells=(3, 4, 5), cap=cap),
                      offsets=half_space_offsets(1), block_dtype=dtype)
    rng = np.random.default_rng(cap)
    counts = rng.integers(0, cap + 1, size=spec.bins.n_cells_total)
    counts[:3] = (0, cap, cap // 2 + 3)
    bins = _hand_bins(spec.bins, 24.0, counts, seed=cap)
    got = _pair_blocks_checked(bins, make_box(24.0, 0.3), spec, cfg)
    empty = (bins.mask == 0)[None, None, :, :, None]     # rows of empty slots
    assert bool(empty[0, 0, 0].all())                      # the empty cell
    assert not bool((got.float() * empty).any())
    assert bool(got[:, :, 1].float().abs().amax() > 0)     # the full cell


def test_pair_blocks_kernel_on_the_fallback_configs(cuda):
    """make_config's banded -> blocked fallbacks on small boxes: N = 64 in
    L = 24 (too sparse to band: cap 16, bfloat16) and N = 1080 in L = 24 at
    error 1e-4 (float32 blocks, degree 12), tilt 0.3: bitwise the plain
    version."""
    for n, error, cap, dtype in ((64, 1e-3, 16, "bfloat16"),
                                 (1080, 1e-4, 80, "float32")):
        cfg = pi.make_config(make_params(xi=0.5, error=error, L=24.0), n,
                             engine="banded", device="cuda")
        assert cfg.engine == "blocked"
        assert (cfg.nf_spec.bins.cap, cfg.nf_spec.block_dtype) == (cap,
                                                                   dtype)
        pos, box = _uniform(n, 24.0, seed=5), make_box(24.0, 0.3)
        bins = bin_particles(pos, box, cfg.nf_spec.bins)
        _pair_blocks_checked(bins, box, cfg.nf_spec, cfg)


# -- the blocked engine's matvec (csrc/blocked.cu) ----------------------------

def _matvec_checked(blocks, spec, bins, self_mobility, seed=7):
    """matvec_cells on the card against matvec_cells_reference on the same
    CUDA tensors, f random in the occupied slots: within 2e-6 of max|u|
    (the kernel sums in another order), zero in every padded slot, one
    launch a call and a rerun bitwise equal; returns u."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    f = torch.randn((3,) + tuple(bins.mask.shape), generator=g,
                    device="cuda") * bins.mask
    before = trace.counters().get("launch.matvec_cells", 0)
    got = bnf.matvec_cells(blocks, spec, bins, f, self_mobility)
    assert trace.counters()["launch.matvec_cells"] == before + 1
    want = bnf.matvec_cells_reference(blocks, spec, bins, f, self_mobility)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
    assert not bool((got * (bins.mask == 0)).any())
    assert _bitwise(bnf.matvec_cells(blocks, spec, bins, f, self_mobility),
                    got)
    assert trace.counters()["launch.matvec_cells"] == before + 2
    return got


@pytest.mark.parametrize("part", [None, 0, 1, 3])
@pytest.mark.parametrize("tilt", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matvec_cells_kernel_matches_the_plain_version(cuda, dtype, tilt,
                                                       part):
    """N = 1080 in L = 24 (cells (3, 3, 3), cap 80), float32 and bfloat16
    blocks, over the whole half stencil and over three of the four parts
    parallel/sharding.py passes four devices: the first holds (0,0,0) and
    the self term, the others start at another offset, all transposed,
    with a self term of 0.0."""
    from pse_tpu_torch.parallel.sharding import _ranges

    cfg = _blocked_config(1080, 24.0, dtype)
    pos, box = _uniform(1080, 24.0, seed=3), make_box(24.0, tilt)
    bins = bin_particles(pos, box, cfg.nf_spec.bins)
    offs = cfg.nf_spec.offsets
    a, b = (0, len(offs)) if part is None else _ranges(len(offs), 4)[part]
    spec = cfg.nf_spec._replace(offsets=offs[a:b])
    p = cfg.params
    blocks = bnf.build_pair_blocks(bins, box, spec, cfg.cheb, p.ewald_cut,
                                   p.ewald_dr)
    u = _matvec_checked(blocks, spec, bins,
                        p.self_mobility if a == 0 else 0.0)
    assert bool(u.abs().amax() > 0)


@pytest.mark.parametrize("cap", [16, 40, 112])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matvec_cells_kernel_at_empty_full_and_ragged_cells(cuda, dtype,
                                                            cap):
    """Cells (3, 4, 5) of L = 24 filled by hand (cell 0 empty, cell 1
    full, cell 2 ragged, the others at random occupancies), tilt 0.3, at
    caps 16, 40 and 112: rows and columns past each cell's occupied slots
    are skipped, and u is the plain version's."""
    cfg = _blocked_config(1080, 24.0, dtype)
    spec = bnf.NfSpec(bins=BinSpec(n_cells=(3, 4, 5), cap=cap),
                      offsets=half_space_offsets(1), block_dtype=dtype)
    rng = np.random.default_rng(cap + 1)
    counts = rng.integers(0, cap + 1, size=spec.bins.n_cells_total)
    counts[:3] = (0, cap, cap // 2 + 3)
    bins = _hand_bins(spec.bins, 24.0, counts, seed=cap)
    p = cfg.params
    blocks = bnf.build_pair_blocks(bins, make_box(24.0, 0.3), spec, cfg.cheb,
                                   p.ewald_cut, p.ewald_dr)
    u = _matvec_checked(blocks, spec, bins, p.self_mobility)
    assert not bool(u[:, 0].any())                         # the empty cell
    assert bool(u[:, 1].abs().amin() > 0)                  # the full cell


def test_matvec_cells_kernel_at_the_blocked_cell_shapes(cuda):
    """The benchmark's blocked cell's shapes: N = 100k uniform in L = 97.64,
    cells (9, 13, 13), cap 112, bfloat16 blocks of the 14 offsets, tilt
    0.3."""
    L = 97.64
    cfg = pi.make_config(make_params(xi=0.5, error=1e-3, L=L), 100_000,
                         device="cuda")
    spec, p = cfg.nf_spec, cfg.params
    assert (cfg.engine, spec.bins.n_cells, spec.bins.cap,
            spec.block_dtype, len(spec.offsets)) == (
        "blocked", (9, 13, 13), 112, "bfloat16", 14)
    box = make_box(L, 0.3)
    bins = bin_particles(_uniform(100_000, L, seed=9), box, spec.bins)
    blocks = bnf.build_pair_blocks(bins, box, spec, cfg.cheb, p.ewald_cut,
                                   p.ewald_dr)
    _matvec_checked(blocks, spec, bins, p.self_mobility)
