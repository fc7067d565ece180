"""Banded near field: z-sorted columns and rank-band mobility coefficients.

PyTorch counterpart of ``pse_tpu/ops/banded_nearfield.py``.  After sorting each (x, y) column of particles by z, the
partners of a particle within rcut occupy a contiguous rank band of each
neighbouring column, so the mobility between an R-row tile of column c and a
neighbour column is one (R x W) block whose W lanes start at a per-(tile,
column pair) window offset j0.  Only the half stencil ((0,0) and 4 positive
offsets) is stored, as two coefficients per pair, A = (imrr, bco/d^2) in the
block dtype (1, C, 2, S, 5W); the mirror offsets are applied as transposes,
and the dyadic d d^T part is rebuilt from f32 coordinates.

Host side: ``make_band_spec``, ``full_xy_offsets``, ``compute_windows``,
``_finish_u`` and the occupancy classes (``measure_col_counts``,
``make_slab_counts``, ``make_band_classes``, ``class_segments``,
``class_assignment``).  With ``spec.classes`` set, the kernels on CUDA
tensors pack A by class: the columns sorted by descending tile need, and
class k stores only its t_k tiles of its c_k columns, so the all-pad tail
tiles the cap's slack forces on the average column are neither built nor
stored.  One kernel source, ``csrc/banded.cu``, is wrapped by
``build_mv_banded`` (build A and apply it to the first one or two
right-hand sides), ``matvec_banded`` (apply the stored A to one or two)
and ``build_banded_blocks`` (build A alone).  On CPU tensors the matvec
wrappers run ``matvec_banded_reference``, the plain version: all 9
offsets, windows gathered, pair functions rebuilt per call, unrounded
float32; the build runs ``build_banded_blocks_reference``.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from itertools import combinations
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels, trace
from ..box import Box, min_image_components
from ..cellbins import BinSpec, CellBins, roll_cells
from .chebyshev import ChebPair, device_coeffs, eval_pair_functions

N_HALF = 5     # stored offsets: (0,0) + the lexicographically-positive half


def full_xy_offsets():
    """(0,0) first, then the positive half stencil, then its mirrors in
    matching order (offsets[5+i] == -offsets[1+i])."""
    half = [(0, 1), (1, -1), (1, 0), (1, 1)]
    return tuple([(0, 0)] + half + [(-ox, -oy) for (ox, oy) in half])


class BandSpec(NamedTuple):
    """Static banded-near-field configuration (hashable)."""

    bins: BinSpec            # n_cells = (ncx, ncy, 1); cap = slots per column
    offsets: tuple           # xy stencil offsets, (0, 0) first
    window: int              # W: band window width (multiple of 64)
    rows: int                # R: row-tile height (multiple of 8)
    block_dtype: str = "bfloat16"
    # Occupancy classes ((tiles_k, ncols_k), ...) ascending by tiles, summing
    # to C, the last tiles_k == cap // rows: each step packs the columns into
    # the smallest class whose tile count covers ceil(n_valid / rows).  None:
    # one class.
    classes: tuple | None = None
    # The same for the per-shard extended slab grid of the halo engine
    # ((ncx / D + 2) ncy local columns, sized for the worst slab).
    slab_classes: tuple | None = None


def make_band_spec(
    n_particles: int,
    L,
    rcut: float,
    max_tilt: float = 0.5,
    block_dtype: str = "bfloat16",
    rows: int = 32,
    ncx_multiple: int = 1,
) -> BandSpec | None:
    """Choose column counts, capacity and window (the JAX package's rule),
    or None when the geometry does not support the banded layout."""
    L = tuple(float(x) for x in L)
    ncx = int(math.floor(L[0] / (rcut * (1.0 + abs(max_tilt)))))
    ncy = int(math.floor(L[1] / rcut))
    ncx = (ncx // ncx_multiple) * ncx_multiple
    if ncx < max(3, ncx_multiple) or ncy < 3:
        return None

    mu = n_particles / (ncx * ncy)            # mean column occupancy
    band = 2.0 * rcut / L[2] * mu

    def w_of(r):
        need = band + r + 5.0 * math.sqrt(max(band, 1.0)) + 10.0
        w = max(64, int(math.ceil(need / 64.0)) * 64)
        if w - need < 10.0:
            w += 64
        return w, need

    if rows == 32:
        w16, _ = w_of(16)
        window, need = w_of(32)
        if window > w16 and need <= w16:
            window = w16
    else:
        window, _ = w_of(rows)

    cap = int(math.ceil((mu + 4.0 * math.sqrt(mu) + 8.0) / rows)) * rows
    if window > 256 or cap < window:
        return None
    return BandSpec(
        bins=BinSpec(n_cells=(ncx, ncy, 1), cap=cap),
        offsets=full_xy_offsets(),
        window=window,
        rows=rows,
        block_dtype=block_dtype,
    )


def measure_col_counts(spec: BandSpec, pos, L, tilt=0.0) -> np.ndarray:
    """Measured per-column occupancy (ncx ncy,), on the host in numpy, to
    size the occupancy classes.  ``tilt``: the box's xy tilt at the
    measurement (a re-measure mid-run from a sheared box)."""
    ncx, ncy, _ = spec.bins.n_cells
    L = tuple(float(x) for x in L)
    p = np.asarray(pos, np.float64)
    fx = np.mod((p[:, 0] - float(tilt) * p[:, 1]) / L[0] + 0.5, 1.0)
    fy = np.mod(p[:, 1] / L[1] + 0.5, 1.0)
    cx = np.clip((fx * ncx).astype(np.int64), 0, ncx - 1)
    cy = np.clip((fy * ncy).astype(np.int64), 0, ncy - 1)
    return np.bincount(cx * ncy + cy, minlength=ncx * ncy)


def make_slab_counts(spec: BandSpec, n_slabs: int, counts) -> np.ndarray:
    """(D, (nxl + 2) ncy) per-slab extended column counts from the global
    (ncx ncy,) histogram: each halo shard owns ncx / D x-layers plus one
    periodic halo layer per side."""
    ncx, ncy, _ = spec.bins.n_cells
    c = np.asarray(counts, np.int64).reshape(ncx, ncy)
    nxl = ncx // n_slabs
    out = []
    for d in range(n_slabs):
        xs = np.arange(d * nxl - 1, (d + 1) * nxl + 1) % ncx
        out.append(c[xs].reshape(-1))
    return np.stack(out)


def make_band_classes(spec: BandSpec | None, n_particles: int,
                      col_counts=None) -> BandSpec | None:
    """``spec`` with occupancy classes chosen, or as it was (no classes
    worth having, or classes already set).

    Tiles past ceil(n_valid / rows) hold zero A.  With ``col_counts`` (the
    measured histogram, 1-D, or 2-D (K, C) for K column sets that must all
    fit) the classes come from a brute force over at most 3 sub-cap
    classes, with capacities counting columns within half a row tile of a
    boundary as crossed plus a 2.5 sqrt(m) + 8 excursion margin; without
    it, from a Poisson model with 5 sigma + 2 % slack.  The JAX package's
    rule, number for number."""
    if spec is None or spec.classes is not None:
        return spec
    ncx, ncy, _ = spec.bins.n_cells
    C = ncx * ncy
    R = spec.rows
    t_cap = spec.bins.cap // R
    mu = n_particles / C
    if C < 32 or t_cap < 6 or mu < 64:
        return spec
    sigma = math.sqrt(mu)

    def pois_le(t):                    # P(ceil(nv/R) <= t) = P(nv <= t*R)
        return 0.5 * (1.0 + math.erf(
            (t * R + 0.5 - mu) / (sigma * math.sqrt(2.0))))

    if col_counts is not None:
        counts = np.asarray(col_counts, np.int64)
        if counts.ndim == 1:
            counts = counts[None]
        needs = -(-np.maximum(counts, 1) // R)
        soft = np.minimum(-(-(np.maximum(counts, 1) + R // 2) // R), t_cap)
        if needs.shape[-1] != C or needs.max() > t_cap:
            return spec

        def cap_gt(t):
            # columns above t, with the R/2 crossing margin, plus an
            # excursion margin for ~O(100) steps of drift
            m = int((soft > t).sum(axis=-1).max())
            return min(C, int(math.ceil(m + 2.5 * math.sqrt(max(m, 1.0))
                                        + 8.0)))

        cand_ts = sorted({int(t) for t in needs.ravel() if t < t_cap})
        best = None
        for k in (1, 2, 3):            # number of sub-cap classes
            for ts in combinations(cand_ts, k):
                cums = [cap_gt(t) for t in ts]
                c_low = C - cums[0]
                if c_low <= 0:
                    continue
                classes = [(ts[0], c_low)]
                for j in range(1, k):
                    classes.append((ts[j], cums[j - 1] - cums[j]))
                classes.append((t_cap, cums[k - 1]))
                classes = [(t, c) for (t, c) in classes if c > 0]
                if len(classes) < 2:
                    continue
                # the JAX package's cost of one more launch per class
                cost = sum(t * c for t, c in classes)
                cost += 0.005 * C * t_cap * (len(classes) - 1)
                if best is None or cost < best[0]:
                    best = (cost, tuple(classes))
        if best is None or best[0] > 0.94 * C * t_cap:
            return spec
        return spec._replace(classes=best[1])

    def cap_frac(p_gt):                # capacity above a class
        return p_gt + 5.0 * math.sqrt(max(p_gt * (1.0 - p_gt), 1e-9) / C) \
            + 0.02

    t1 = max(1, int(math.ceil((mu + 0.5 * sigma) / R)))
    t2 = t1 + 1
    if t2 >= t_cap:
        return spec
    c3 = min(C, int(math.ceil(C * cap_frac(1.0 - pois_le(t2)))))
    c23 = min(C, int(math.ceil(C * cap_frac(1.0 - pois_le(t1)))))
    c2 = max(c23 - c3, 0)
    c1 = C - c3 - c2
    if c1 <= 0:
        return spec
    avg = (c1 * t1 + c2 * t2 + c3 * t_cap) / C
    if avg > 0.94 * t_cap:
        return spec
    classes = tuple(
        (t, c) for (t, c) in ((t1, c1), (t2, c2), (t_cap, c3)) if c > 0)
    if len(classes) < 2:
        return spec
    return spec._replace(classes=classes)


def class_segments(spec: BandSpec):
    """Packed-order segments [(tiles_k, ncols_k, col_offset_k), ...],
    need-descending: the largest class owns packed columns [0, c_K)."""
    segs = []
    off = 0
    for (tk, ck) in reversed(spec.classes):
        segs.append((tk, ck, off))
        off += ck
    return segs


@lru_cache(maxsize=16)
def _segment_heads(spec: BandSpec, device: str):
    """(offsets, tiles) of the class segments as int64 tensors."""
    segs = class_segments(spec)
    return (torch.tensor([o for _, _, o in segs], device=device),
            torch.tensor([t for t, _, _ in segs], device=device))


def class_assignment(spec: BandSpec, n_valid: torch.Tensor):
    """(perm, inv, overflow): the packed -> actual column order of the
    class-packed kernels, its inverse, and a () bool set when a segment's
    first (largest) member needs more tiles than its class holds.

    Columns sort by descending tile need, ties by ascending column id (a
    stable sort, as the JAX package's ``lax.sort``), so the packing is
    deterministic."""
    C = n_valid.shape[0]
    R = spec.rows
    need = (torch.clamp(n_valid.long(), min=1) + (R - 1)) // R
    need_desc, perm = torch.sort(-need, stable=True)
    offs, tiles = _segment_heads(spec, str(n_valid.device))
    overflow = torch.any(-need_desc[offs] > tiles)
    perm = perm.to(torch.int32)
    inv = torch.empty(C, dtype=torch.int32, device=n_valid.device)
    inv[perm.long()] = torch.arange(C, dtype=torch.int32,
                                    device=n_valid.device)
    return perm, inv, overflow


def compute_windows(bins: CellBins, spec: BandSpec, box: Box, rcut: float,
                    col_mask=None, offsets: tuple | None = None):
    """Per-(offset, column, tile) band window starts in cyclic rank
    coordinates: rank k < n_valid is slot k, rank n_valid + k is slot k one
    period up (z + Lz), so a band that wraps the periodic seam stays
    contiguous.

    Returns (j0 (O, C, T) int32, n_valid (C,) int32, band_overflow () bool,
    zsh (O, C, T) f32): overflow is set when a tile's band exceeds
    min(W, n_valid); zsh in {-Lz, 0, +Lz} is the window's z image shift.
    ``col_mask``: (C,) bool, the columns whose tiles may raise the
    overflow (the halo engine's interior columns; its halo columns'
    windows wrap wrongly at the slab's edges, and their outputs are
    dropped); None: every column.  ``offsets``: the stencil offsets to
    compute (default: all 9; the CUDA kernels read only the first
    N_HALF)."""
    S, R, W = spec.bins.cap, spec.rows, spec.window
    T = S // R
    Lz = box.L[2]
    lo_z = box.lo[2]
    dev = bins.pz.device
    inf = torch.tensor(float("inf"), device=dev)

    z = torch.where(bins.mask > 0, bins.pz, inf)             # (C, S) sorted
    n_valid = torch.sum(bins.mask > 0, dim=1).to(torch.int32)
    z_lo = z[:, ::R]                                         # (C, T)
    zt = z.reshape(z.shape[0], T, R)
    z_hi = torch.amax(torch.where(torch.isfinite(zt), zt, -inf), dim=2)

    zb = z_lo - rcut
    shift = torch.where(zb < lo_z, Lz, 0.0)                  # wrap the band
    zb = zb + shift
    ze = z_hi + rcut + shift
    valid_tile = torch.isfinite(z_lo)
    if col_mask is not None:
        valid_tile = valid_tile & col_mask[:, None]

    if offsets is None:
        offsets = spec.offsets
    j0s, zshs = [], []
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for (ox, oy) in offsets:
        zn = roll_cells(z, spec.bins, (ox, oy, 0))
        nv = roll_cells(n_valid[:, None], spec.bins, (ox, oy, 0))[:, 0, None]

        def count_below(thr, zn=zn):
            main = torch.sum(zn[:, None, :] < thr[:, :, None], dim=2)
            wrap = torch.sum(zn[:, None, :] + Lz < thr[:, :, None], dim=2)
            return (main + wrap).to(torch.int32)

        j0 = count_below(zb)
        j1 = count_below(ze)
        band = torch.minimum(j1 - j0, nv)
        overflow = overflow | torch.any(valid_tile & (band > W))
        aliased = j0 >= nv
        j0 = torch.where(aliased, j0 - nv, j0)
        j0s.append(torch.clamp(j0, 0, S))
        zshs.append(shift - torch.where(aliased, Lz, 0.0))
    return (torch.stack(j0s).to(torch.int32), n_valid, overflow,
            torch.stack(zshs).to(torch.float32))


def extend_slots(arr: torch.Tensor, spec: BandSpec) -> torch.Tensor:
    """(..., C, S) -> (..., C, S + W + 128): append wrap copies of slots
    [0, W + 128) (the plain version's window gathers index past S)."""
    pad = spec.window + 128
    reps = -(-pad // arr.shape[-1])
    tail = torch.cat([arr] * reps, dim=-1)[..., :pad] if reps > 1 \
        else arr[..., :pad]
    return torch.cat([arr, tail], dim=-1)


def _pair_coefficients(dx, dy, dz, mi, mj, *, cheb, cut2, dr2, same_slot):
    """(imrr, bco, d^2) of every (row, lane) pair: the pair functions at
    valid separations dr <= d < rcut of occupied, distinct slots, zero
    elsewhere; d^2 is 1 where the pair is not valid."""
    d2 = dx * dx + dy * dy + dz * dz
    valid = (mi * mj > 0.0) & (d2 < cut2) & (d2 >= dr2) & ~same_slot
    d2_safe = torch.where(valid, d2, torch.ones_like(d2))
    uf1, uf2 = eval_pair_functions(cheb, torch.sqrt(d2_safe))
    zero = torch.zeros_like(uf1)
    return (torch.where(valid, uf1, zero), torch.where(valid, uf2 - uf1, zero),
            d2_safe)


def _min_image_z(dz, Lz):
    """The z line of ``box.min_image_components``."""
    return dz - Lz * torch.round(dz / Lz)


def _column_shift(spec: BandSpec, offset, L, tilt, dev):
    """(sx, sy), each (C,) float32: the xy image shift of column c's
    neighbour c + ``offset`` on the periodic column grid, as the kernels
    add it to the window's coordinates (sx = wx Lx + tilt sy, sy = wy Ly,
    w the wrap across the grid's edge)."""
    ncx, ncy, _ = spec.bins.n_cells
    C = ncx * ncy
    ox, oy = offset
    cx = torch.arange(C, device=dev) // ncy
    cy = torch.arange(C, device=dev) % ncy
    wx = (cx + ox >= ncx).float() - (cx + ox < 0).float()
    wy = (cy + oy >= ncy).float() - (cy + oy < 0).float()
    sy = wy * float(np.float32(L[1]))
    return wx * float(np.float32(L[0])) + float(np.float32(tilt)) * sy, sy


def pair_components(xi, yi, zi, mi, xj, yj, zj, mj, tilt, *, L, cheb,
                     cut2, dr2, same_slot):
    """The six symmetric RPY-Ewald tensor components of every (row, lane)
    pair, with the minimum image of the tilted box (plain version)."""
    dx, dy, dz = min_image_components(Box(L, tilt), xi - xj, yi - yj,
                                      zi - zj)
    return separation_components(dx, dy, dz, mi, mj, cheb=cheb, cut2=cut2,
                                 dr2=dr2, same_slot=same_slot)


def separation_components(dx, dy, dz, mi, mj, *, cheb, cut2, dr2,
                          same_slot):
    """The six components of every (row, lane) pair at separation
    (dx, dy, dz)."""
    imrr, bco, d2 = _pair_coefficients(dx, dy, dz, mi, mj, cheb=cheb,
                                       cut2=cut2, dr2=dr2,
                                       same_slot=same_slot)
    inv_d = 1.0 / torch.sqrt(d2)
    ex, ey, ez = dx * inv_d, dy * inv_d, dz * inv_d
    return (imrr + bco * ex * ex, bco * ex * ey, bco * ex * ez,
            imrr + bco * ey * ey, bco * ey * ez, imrr + bco * ez * ez)


def matvec_banded_reference(bins: CellBins, tilt_xy, spec: BandSpec,
                            cheb: ChebPair, L: tuple, ewald_cut: float,
                            ewald_dr: float, j0: torch.Tensor,
                            n_valid: torch.Tensor, f_cells: torch.Tensor,
                            self_mobility) -> torch.Tensor:
    """Plain banded matvec (3, C, S): the same cyclic-window math as the
    kernels over all 9 offsets (j0 from ``compute_windows`` with every
    offset), windows gathered, pair functions rebuilt, f32 unrounded.

    Each pair's separation is the one the kernels' build takes, visited
    from either slot: dx, dy with the column grid's image shift s added to
    the neighbour's coordinates at the 5 stored offsets (x_i - (x_j + s))
    and taken off the own ones at the 4 mirrored ones ((x_i - s) - x_j,
    the exact negative of the stored offset's value from the other slot),
    dz the minimum image of z_i - z_j; so both decide a pair within
    rounding of rcut alike."""
    ncx, ncy, _ = spec.bins.n_cells
    C, S, R, W = ncx * ncy, spec.bins.cap, spec.rows, spec.window
    T = S // R
    O = len(spec.offsets)
    dev = f_cells.device
    tilt = float(np.float32(tilt_xy))
    L = tuple(float(np.float32(x)) for x in L)

    posm = torch.stack([bins.px, bins.py, bins.pz, bins.mask])
    posm_ext = extend_slots(posm, spec)                      # (4, C, S_ext)
    f_ext = extend_slots(f_cells.to(torch.float32), spec)

    cols = np.arange(C).reshape(ncx, ncy)
    nbr_cols = torch.as_tensor(np.stack([
        np.roll(cols, (-ox, -oy), axis=(0, 1)).reshape(-1)
        for (ox, oy) in spec.offsets
    ]), dtype=torch.long, device=dev)                        # (O, C)
    nv_nbr = n_valid.long()[nbr_cols]                        # (O, C)
    own = posm.reshape(4, C, T, R)
    islot = (torch.arange(T, device=dev)[:, None] * R
             + torch.arange(R, device=dev))                  # (T, R)
    lanes = torch.arange(W, device=dev)
    SYM = ((0, 1, 2), (1, 3, 4), (2, 4, 5))

    budget = 2 ** 27
    Tc = max(1, min(T, budget // max(1, 6 * C * R * W)))

    def offset_chunk(oi, t0, tc):
        nvo = nv_nbr[oi][:, None, None]                      # (C, 1, 1)
        jw = j0[oi][:, t0:t0 + tc].long()[..., None] + lanes  # (C, tc, W)
        use_main = jw < nvo
        idx = torch.where(use_main, jw, S + jw - nvo)
        lane_ok = lanes < nvo
        jslot = torch.where(use_main, jw, jw - nvo)
        col_idx = nbr_cols[oi][:, None, None].expand_as(idx)
        win = posm_ext[:, col_idx, idx]                      # (4, C, tc, W)
        fw = f_ext[:, col_idx, idx]                          # (3, C, tc, W)
        mj = torch.where(lane_ok, win[3], torch.zeros_like(win[3]))
        same = (oi == 0) & (jslot[:, :, None, :]
                            == islot[t0:t0 + tc][None, :, :, None])

        def tile(k):
            return own[k][:, t0:t0 + tc, :, None]            # (C, tc, R, 1)

        sx, sy = (a[:, None, None, None]
                  for a in _column_shift(spec, spec.offsets[oi], L, tilt,
                                         dev))
        xj, yj, zj = (win[k][:, :, None, :] for k in range(3))
        if oi < N_HALF:
            dx, dy = tile(0) - (xj + sx), tile(1) - (yj + sy)
        else:
            dx, dy = (tile(0) - sx) - xj, (tile(1) - sy) - yj
        comps = separation_components(
            dx, dy, _min_image_z(tile(2) - zj, L[2]), tile(3),
            mj[:, :, None, :], cheb=cheb, cut2=float(ewald_cut) ** 2,
            dr2=float(ewald_dr) ** 2, same_slot=same,
        )                                                    # 6 x (C,tc,R,W)
        fw_b = fw[:, :, :, None, :]
        return torch.stack([
            torch.sum(comps[SYM[r][0]] * fw_b[0] + comps[SYM[r][1]] * fw_b[1]
                      + comps[SYM[r][2]] * fw_b[2], dim=3).reshape(C, tc * R)
            for r in range(3)
        ])                                                   # (3, C, tc*R)

    u = torch.zeros((3, C, S), dtype=torch.float32, device=dev)
    for oi in range(O):
        parts = [offset_chunk(oi, t0, min(Tc, T - t0)) for t0 in range(0, T, Tc)]
        u = u + torch.cat(parts, dim=2)
    return u + self_mobility * f_cells.to(torch.float32)


def _finish_u(uo: torch.Tensor, spec: BandSpec, f_cells, self_mobility):
    """(C, N_HALF, 3, S) per-column output -> u (3, C, S): plane 0 is the
    forward product, planes 1..4 what the column's blocks contribute to
    column c + offsets[h], rolled onto their targets; plus the self term."""
    u = torch.movedim(uo[:, 0], 1, 0)
    for h in range(N_HALF - 1):
        ox, oy = spec.offsets[1 + h]
        u = u + torch.movedim(
            roll_cells(uo[:, 1 + h], spec.bins, (-ox, -oy, 0)), 1, 0)
    return u + self_mobility * f_cells


@lru_cache(maxsize=8)
def _cheb_operand(cheb: ChebPair, device: str) -> torch.Tensor:
    return device_coeffs(cheb, device)


# what _launch_banded launches: the build, then the matvec on the A it
# wrote, or the build alone
MODE_BUILD_MV, MODE_BUILD = 0, 1
MAX_CLASSES = 4    # the kernels' class table (csrc/banded.cu MAXK)


def _class_args(spec: BandSpec, pack):
    """The kernels' class operands (perm, n, tiles, columns): the segments
    in packed order with ``pack`` = (perm, inv) from ``class_assignment``,
    or one class (null, 0, null, null) without classes."""
    if (spec.classes is None) != (pack is None):
        raise ValueError("banded kernels take pack=(perm, inv) exactly when "
                         "spec.classes is set")
    if spec.classes is None:
        return None, 0, None, None
    segs = class_segments(spec)
    if len(segs) > MAX_CLASSES:
        raise ValueError(f"banded kernels take at most {MAX_CLASSES} "
                         f"occupancy classes, not {len(segs)}")
    perm = pack[0].to(torch.int32).contiguous()
    n = len(segs)
    return (perm, n, (ctypes.c_int * n)(*[t for t, _, _ in segs]),
            (ctypes.c_int * n)(*[c for _, c, _ in segs]))


def _alloc_blocks(spec: BandSpec, device):
    """A in the block dtype: (1, C, 2, S, 5W), or with classes a tuple of
    per-class views (1, c_k, 2, t_k R, 5W) in packed order over one
    allocation."""
    ncx, ncy, _ = spec.bins.n_cells
    C, S, R, W = ncx * ncy, spec.bins.cap, spec.rows, spec.window
    a_dtype = getattr(torch, spec.block_dtype)
    if spec.classes is None:
        return torch.empty((1, C, 2, S, N_HALF * W), dtype=a_dtype,
                           device=device)
    segs = class_segments(spec)
    sizes = [ck * 2 * tk * R * N_HALF * W for tk, ck, _ in segs]
    flat = torch.empty(sum(sizes), dtype=a_dtype, device=device)
    return tuple(part.view(1, ck, 2, tk * R, N_HALF * W)
                 for part, (tk, ck, _) in zip(torch.split(flat, sizes), segs))


def _blocks_base(blocks, spec: BandSpec) -> torch.Tensor:
    """The tensor whose pointer the kernels take as A, after checking that
    ``blocks`` has the layout ``_alloc_blocks`` gives."""
    ncx, ncy, _ = spec.bins.n_cells
    C, S, R, W = ncx * ncy, spec.bins.cap, spec.rows, spec.window
    a_dtype = getattr(torch, spec.block_dtype)
    if spec.classes is None:
        parts, shapes = (blocks,), [(1, C, 2, S, N_HALF * W)]
    else:
        parts = tuple(blocks) if isinstance(blocks, (tuple, list)) else ()
        shapes = [(1, ck, 2, tk * R, N_HALF * W)
                  for tk, ck, _ in class_segments(spec)]
    ok = len(parts) == len(shapes)
    end = None
    for part, shape in zip(parts, shapes):
        ok = ok and (isinstance(part, torch.Tensor) and part.shape == shape
                     and part.dtype == a_dtype and part.is_contiguous()
                     and (end is None or part.data_ptr() == end))
        if ok:
            end = part.data_ptr() + part.numel() * part.element_size()
    if not ok:
        raise ValueError("banded kernels: blocks do not match the spec "
                         "(one allocation, per class in packed order)")
    return parts[0]


def pack_blocks_reference(A: torch.Tensor, spec: BandSpec, perm):
    """Plain packing of a full-layout A (1, C, 2, S, 5W) into the class
    layout: per class segment k, the columns perm[off_k : off_k + c_k] and
    their first t_k R rows, (1, c_k, 2, t_k R, 5W) each."""
    R = spec.rows
    perm = perm.long()
    return tuple(A[:, perm[off:off + ck], :, :tk * R].contiguous()
                 for tk, ck, off in class_segments(spec))


def _band_operands(bins: CellBins, spec: BandSpec, j0, n_valid, zsh,
                   f_cells):
    """The banded kernels' common operands, checked and laid out: (xyz
    [px, py, pz], f or None, nrhs, j0 (5, C, T), zsh (5, C, T), n_valid).
    ``f_cells``: (3 nrhs, C, S) with nrhs 1 or 2, or None."""
    if tuple(spec.offsets[:N_HALF]) != full_xy_offsets()[:N_HALF]:
        raise ValueError("banded kernels assume full_xy_offsets() order")
    ncx, ncy, _ = spec.bins.n_cells
    C, S, R, W = ncx * ncy, spec.bins.cap, spec.rows, spec.window
    T = S // R
    if R % 8 or R > 32 or S % R or W % 64 or W > 256:
        raise ValueError(f"banded kernels take R in 8..32 (multiple of 8) "
                         f"dividing S and W in 64..256: R={R} S={S} W={W}")
    f, nrhs = None, 0
    if f_cells is not None:
        nrhs = f_cells.shape[0] // 3
        if f_cells.shape not in ((3, C, S), (6, C, S)):
            raise ValueError("banded kernels take one or two right-hand "
                             "sides, (3, C, S) or (6, C, S)")
        f = f_cells.to(torch.float32).contiguous()
    xyz = [t.to(torch.float32).contiguous()
           for t in (bins.px, bins.py, bins.pz)]
    j0h = j0[:N_HALF].to(torch.int32).contiguous()
    zsh = zsh[:N_HALF].to(torch.float32).contiguous()
    nv = n_valid.to(torch.int32).contiguous()
    if j0h.shape != (N_HALF, C, T) or zsh.shape != (N_HALF, C, T):
        raise ValueError("banded kernels take (>=5, C, T) window tables")
    return xyz, f, nrhs, j0h, zsh, nv


def _launch_banded(mode: int, bins: CellBins, tilt_xy, spec: BandSpec,
                   cheb: ChebPair, L, ewald_cut, ewald_dr, j0, n_valid, zsh,
                   f_cells=None, pack=None):
    """The build kernel of csrc/banded.cu and, in MODE_BUILD_MV, the matvec
    kernel on the A it wrote; returns (blocks, uo (C, 9, 3 nrhs, S) or
    None, rc).  ``f_cells``: (3 nrhs, C, S) with nrhs 1 or 2, or None in
    MODE_BUILD.  ``pack``: (perm, inv) when spec.classes is set (build_mv
    only); blocks is then the tuple of per-class A views."""
    if (f_cells is None) != (mode == MODE_BUILD):
        raise ValueError("banded kernels take right-hand sides unless they "
                         "only build")
    if mode == MODE_BUILD and spec.classes is not None:
        raise ValueError("the build alone is single-class; the class-packed "
                         "A comes from build_mv_banded(pack=...)")
    xyz, _, _, j0h, zsh5, nv = _band_operands(bins, spec, j0, n_valid, zsh,
                                              f_cells)
    perm, n_cls, cls_t, cls_c = _class_args(spec, pack)
    mask = bins.mask.to(torch.float32).contiguous()
    ncx, ncy, _ = spec.bins.n_cells
    S, R, W = spec.bins.cap, spec.rows, spec.window
    dev = bins.px.device
    a_dtype = getattr(torch, spec.block_dtype)
    blocks = _alloc_blocks(spec, dev)
    base = _blocks_base(blocks, spec)
    cheb_dev = _cheb_operand(cheb, str(dev))
    Lf = [float(np.float32(x)) for x in L]
    p = kernels.ptr
    rc = kernels.library().pse_banded_build(
        *(p(t) for t in xyz), p(mask), p(j0h), p(zsh5), p(nv),
        p(cheb_dev), cheb.degree + 1, float(np.float32(cheb.mid)),
        float(np.float32(float(ewald_cut) ** 2)),
        float(np.float32(float(ewald_dr) ** 2)),
        ncx, ncy, S, R, W, *Lf, float(np.float32(tilt_xy)),
        int(a_dtype == torch.bfloat16), p(base), p(perm), n_cls, cls_t,
        cls_c, kernels.stream_of(mask),
    )
    if mode == MODE_BUILD or rc:
        return blocks, None, rc
    uo, rc = _launch_matvec(blocks, bins, tilt_xy, spec, L, j0, n_valid, zsh,
                            f_cells, pack)
    return blocks, uo, rc


def _launch_matvec(blocks, bins: CellBins, tilt_xy, spec: BandSpec, L, j0,
                   n_valid, zsh, f_cells, pack=None):
    """One matvec launch of csrc/banded.cu on the stored ``blocks`` (the
    per-class tuple with ``pack``); returns (uo (C, 9, 3 nrhs, S), rc),
    uo in actual column order."""
    xyz, f, nrhs, j0h, zsh, nv = _band_operands(bins, spec, j0, n_valid,
                                                zsh, f_cells)
    perm, n_cls, cls_t, cls_c = _class_args(spec, pack)
    base = _blocks_base(blocks, spec)
    ncx, ncy, _ = spec.bins.n_cells
    C, S, R, W = ncx * ncy, spec.bins.cap, spec.rows, spec.window
    a_dtype = getattr(torch, spec.block_dtype)
    uo = torch.empty((C, 9, 3 * nrhs, S), dtype=torch.float32,
                     device=bins.px.device)
    Lf = [float(np.float32(x)) for x in L]
    p = kernels.ptr
    rc = kernels.library().pse_banded_matvec(
        nrhs, *(p(t) for t in xyz), p(f), p(j0h), p(zsh), p(nv),
        ncx, ncy, S, R, W, *Lf, float(np.float32(tilt_xy)),
        int(a_dtype == torch.bfloat16), p(base), p(uo), p(perm), n_cls,
        cls_t, cls_c, kernels.stream_of(xyz[0]),
    )
    return uo, rc


def _fold_planes(uo):
    """(C, 9, 3, S) kernel planes -> (C, N_HALF, 3, S) as _finish_u takes:
    the 5 forward planes summed, then the 4 transposed ones."""
    return torch.cat([uo[:, :N_HALF].sum(dim=1, keepdim=True),
                      uo[:, N_HALF:]], dim=1)


def _reference_per_rhs(f_cells, matvec):
    """The plain version on one or two right-hand sides: one plain matvec
    per right-hand side, concatenated, as the JAX package's off-TPU path
    does."""
    return torch.cat([matvec(f_cells[k:k + 3])
                      for k in range(0, f_cells.shape[0], 3)])


def build_mv_banded(bins: CellBins, tilt_xy, spec: BandSpec, cheb: ChebPair,
                    L, ewald_cut, ewald_dr, j0, n_valid, zsh, f_cells,
                    self_mobility, pack=None):
    """(blocks, u): build A (1, C, 2, S, 5W) in the block dtype and apply
    the rounded coefficients to ``f_cells`` (3 nrhs, C, S), nrhs 1 or 2:
    the build kernel, then the matvec kernel on the A it wrote (one
    operator for Lanczos: u is bitwise ``matvec_banded``'s on ``blocks``).
    With spec.classes, ``pack`` = (perm, inv) from ``class_assignment``
    and blocks is the tuple of per-class A (1, c_k, 2, t_k R, 5W) in
    packed order, in one allocation; u is in actual column order.

    On CPU tensors: (None, ``matvec_banded_reference`` per right-hand
    side), which ignores the classes; ``j0``/``zsh`` then cover all 9
    offsets (the kernel reads the first 5)."""
    if f_cells.device.type == "cpu":
        return None, _reference_per_rhs(
            f_cells, lambda f: matvec_banded_reference(
                bins, tilt_xy, spec, cheb, L, ewald_cut, ewald_dr, j0,
                n_valid, f, self_mobility))
    blocks, uo, rc = _launch_banded(MODE_BUILD_MV, bins, tilt_xy, spec, cheb,
                                    L, ewald_cut, ewald_dr, j0, n_valid, zsh,
                                    f_cells, pack)
    trace.count("launch.build_mv_banded")
    kernels.check("build_mv_banded", rc)
    return blocks, _finish_u(_fold_planes(uo), spec, f_cells, self_mobility)



def matvec_banded(blocks, bins: CellBins, tilt_xy, spec: BandSpec,
                  cheb: ChebPair, L, ewald_cut, ewald_dr, j0, n_valid, zsh,
                  f_cells, self_mobility, pack=None):
    """u = M_real f_cells (3 nrhs, C, S), nrhs 1 or 2, from the stored
    ``blocks`` (the per-class tuple and ``pack`` with spec.classes).

    On CPU tensors: ``matvec_banded_reference`` per right-hand side
    (``blocks`` and ``pack`` unused)."""
    if f_cells.device.type == "cpu":
        return _reference_per_rhs(
            f_cells, lambda f: matvec_banded_reference(
                bins, tilt_xy, spec, cheb, L, ewald_cut, ewald_dr, j0,
                n_valid, f, self_mobility))
    uo, rc = _launch_matvec(blocks, bins, tilt_xy, spec, L, j0, n_valid, zsh,
                            f_cells, pack)
    trace.count("launch.matvec_banded")
    kernels.check("matvec_banded", rc)
    return _finish_u(_fold_planes(uo), spec, f_cells, self_mobility)



def window_geometry(bins: CellBins, tilt_xy, spec: BandSpec, L, j0, n_valid,
                    zsh, h: int):
    """The kernels' view of stored offset ``h``: for every (column, tile,
    row, lane) the separation d = own - window (window coordinates shifted by
    the column's xy image, the cyclic z wrap and the tile's zsh, as the
    kernels shift them), the occupancies, the self-pair mask, and the
    window's (neighbour column, clamped slot).

    Returns (dx, dy, dz (C, T, R, W), mi (C, T, R, 1), mj (C, T, 1, W),
    same (C, T, R, W) bool, nbr (C,), slot (C, T, W))."""
    ncx, ncy, _ = spec.bins.n_cells
    C, S, R, W = ncx * ncy, spec.bins.cap, spec.rows, spec.window
    T = S // R
    dev = bins.px.device
    Lz = float(np.float32(L[2]))
    ox, oy = spec.offsets[h]
    cx = torch.arange(C, device=dev) // ncy
    cy = torch.arange(C, device=dev) % ncy
    nbr = ((cx + ox) % ncx) * ncy + (cy + oy) % ncy
    sx, sy = (a[:, None, None]
              for a in _column_shift(spec, (ox, oy), L, tilt_xy, dev))
    lanes = torch.arange(W, device=dev)
    nv = n_valid.long()[nbr][:, None, None]                    # (C, 1, 1)
    rank = j0[h].long()[:, :, None] + lanes                     # (C, T, W)
    wrap = rank >= nv
    j = torch.where(wrap, rank - nv, rank)
    slot = torch.clamp(j, max=S - 1)
    col = nbr[:, None, None].expand_as(slot)

    def window(a):
        return a[col, slot]                                     # (C, T, W)

    xw = window(bins.px) + sx
    yw = window(bins.py) + sy
    zw = (window(bins.pz) + torch.where(wrap, Lz, 0.0)) - zsh[h][:, :, None]
    mw = torch.where(lanes < nv, window(bins.mask), 0.0)
    own = [a.reshape(C, T, R, 1) for a in (bins.px, bins.py, bins.pz,
                                           bins.mask)]
    islot = (torch.arange(T, device=dev)[:, None] * R
             + torch.arange(R, device=dev))[None, :, :, None]  # (1, T, R, 1)
    same = (h == 0) & (j[:, :, None, :] == islot)
    return (own[0] - xw[:, :, None], own[1] - yw[:, :, None],
            own[2] - zw[:, :, None], own[3], mw[:, :, None], same, nbr, slot)


def build_banded_blocks_reference(bins: CellBins, tilt_xy, spec: BandSpec,
                                  cheb: ChebPair, L, ewald_cut, ewald_dr, j0,
                                  n_valid, zsh) -> torch.Tensor:
    """Plain version of the build: A (1, C, 2, S, 5W) = (imrr, bco/d^2) of
    the 5 stored offsets side by side on the lane axis, from the pair
    coefficients ``matvec_banded_reference`` uses (dx, dy from the window's
    shifted coordinates, dz the minimum image of the pair's z separation,
    so a pair within rounding of rcut is valid in both or in neither;
    valid only in the z image the window gives it), rounded to the block
    dtype."""
    ncx, ncy, _ = spec.bins.n_cells
    C, S, W = ncx * ncy, spec.bins.cap, spec.window
    Lz = float(np.float32(L[2]))
    planes = []
    for h in range(N_HALF):
        dx, dy, wdz, mi, mj, same, nbr, slot = window_geometry(
            bins, tilt_xy, spec, L, j0, n_valid, zsh, h)
        dz = _min_image_z(bins.pz.reshape(C, -1, spec.rows, 1)
                          - bins.pz[nbr[:, None, None], slot][:, :, None, :],
                          Lz)
        # valid only in the window's own z image (the matvec's geometry)
        other = (wdz - dz).abs() > Lz / 2
        imrr, bco, d2 = _pair_coefficients(
            dx, dy, dz, mi, mj, cheb=cheb, cut2=float(ewald_cut) ** 2,
            dr2=float(ewald_dr) ** 2, same_slot=same | other)
        planes.append(torch.stack([imrr, bco / d2]).reshape(2, C, S, W))
    A = torch.cat(planes, dim=-1)                          # (2, C, S, 5W)
    return A.transpose(0, 1)[None].to(getattr(torch, spec.block_dtype)
                                      ).contiguous()


def build_banded_blocks(bins: CellBins, tilt_xy, spec: BandSpec,
                        cheb: ChebPair, L, ewald_cut, ewald_dr, j0, n_valid,
                        zsh) -> torch.Tensor:
    """A (1, C, 2, S, 5W) in the block dtype: the build alone
    (``csrc/banded.cu`` in build mode) on CUDA tensors, the plain
    ``build_banded_blocks_reference`` on CPU tensors.  It writes the A that
    ``build_mv_banded`` writes, bit for bit.

    The JAX package's build also returns pos_cyc, the prefolded window
    coordinates its TPU matvec streams back; the port's matvec re-derives
    them from the slot arrays, so there is none here.  Single-class, as in
    the JAX package: a spec with classes raises (the packed A comes from
    ``build_mv_banded(pack=...)``)."""
    if spec.classes is not None:
        raise ValueError("build_banded_blocks is the single-class build; "
                         "the class-packed A comes from "
                         "build_mv_banded(pack=...)")
    if bins.px.device.type == "cpu":
        return build_banded_blocks_reference(bins, tilt_xy, spec, cheb, L,
                                             ewald_cut, ewald_dr, j0,
                                             n_valid, zsh)
    blocks, _, rc = _launch_banded(MODE_BUILD, bins, tilt_xy, spec, cheb, L,
                                   ewald_cut, ewald_dr, j0, n_valid, zsh)
    trace.count("launch.build_banded_blocks")
    kernels.check("build_banded_blocks", rc)
    return blocks

