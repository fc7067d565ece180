"""Banded near field: z-sorted columns and rank-band mobility coefficients.

PyTorch counterpart of ``pse_tpu/ops/banded_nearfield.py`` (single
occupancy class).  After sorting each (x, y) column of particles by z, the
partners of a particle within rcut occupy a contiguous rank band of each
neighbouring column, so the mobility between an R-row tile of column c and a
neighbour column is one (R x W) block whose W lanes start at a per-(tile,
column pair) window offset j0.  Only the half stencil ((0,0) and 4 positive
offsets) is stored, as two coefficients per pair, A = (imrr, bco/d^2) in the
block dtype (1, C, 2, S, 5W); the mirror offsets are applied as transposes,
and the dyadic d d^T part is rebuilt from f32 coordinates.

Host side: ``make_band_spec``, ``full_xy_offsets``, ``compute_windows``,
``_finish_u``.  The kernels (``csrc/banded.cu``) are wrapped by
``build_mv_banded`` (build A and apply it to the first right-hand side) and
``matvec_banded`` (apply the stored A).  On CPU tensors both wrappers run
``matvec_banded_reference``, the plain version: all 9 offsets, windows
gathered, pair functions rebuilt per call, unrounded float32.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
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
    """Static banded-near-field configuration (hashable).  Occupancy-class
    packing (the JAX package's ``classes``) is not ported: one class."""

    bins: BinSpec            # n_cells = (ncx, ncy, 1); cap = slots per column
    offsets: tuple           # xy stencil offsets, (0, 0) first
    window: int              # W: band window width (multiple of 64)
    rows: int                # R: row-tile height (multiple of 8)
    block_dtype: str = "bfloat16"


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


def compute_windows(bins: CellBins, spec: BandSpec, box: Box, rcut: float,
                    offsets: tuple | None = None):
    """Per-(offset, column, tile) band window starts in cyclic rank
    coordinates: rank k < n_valid is slot k, rank n_valid + k is slot k one
    period up (z + Lz), so a band that wraps the periodic seam stays
    contiguous.

    Returns (j0 (O, C, T) int32, n_valid (C,) int32, band_overflow () bool,
    zsh (O, C, T) f32): overflow is set when a tile's band exceeds
    min(W, n_valid); zsh in {-Lz, 0, +Lz} is the window's z image shift.
    ``offsets``: the stencil offsets to compute (default: all 9; the CUDA
    kernels read only the first N_HALF)."""
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


def _pair_components(xi, yi, zi, mi, xj, yj, zj, mj, tilt, *, L, cheb,
                     cut2, dr2, same_slot):
    """The six symmetric RPY-Ewald tensor components of every (row, lane)
    pair, with the minimum image of the tilted box (plain version)."""
    dx, dy, dz = min_image_components(Box(L, tilt), xi - xj, yi - yj,
                                      zi - zj)
    d2 = dx * dx + dy * dy + dz * dz
    valid = (mi * mj > 0.0) & (d2 < cut2) & (d2 >= dr2) & ~same_slot
    d2_safe = torch.where(valid, d2, torch.ones_like(d2))
    dist = torch.sqrt(d2_safe)
    uf1, uf2 = eval_pair_functions(cheb, dist)
    zero = torch.zeros_like(uf1)
    imrr = torch.where(valid, uf1, zero)
    bco = torch.where(valid, uf2 - uf1, zero)
    inv_d = 1.0 / dist
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
    offset), windows gathered, pair functions rebuilt, f32 unrounded."""
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

        comps = _pair_components(
            tile(0), tile(1), tile(2), tile(3),
            win[0][:, :, None, :], win[1][:, :, None, :],
            win[2][:, :, None, :], mj[:, :, None, :], tilt,
            L=L, cheb=cheb, cut2=float(ewald_cut) ** 2,
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


def _launch_banded(build: bool, bins: CellBins, tilt_xy, spec: BandSpec,
                   cheb: ChebPair, L, ewald_cut, ewald_dr, j0, n_valid, zsh,
                   f_cells, blocks=None):
    """One launch of csrc/banded.cu; returns (blocks, uo (C, 5, 3, S)) with
    the forward planes summed in torch."""
    if tuple(spec.offsets[:N_HALF]) != full_xy_offsets()[:N_HALF]:
        raise ValueError("banded kernels assume full_xy_offsets() order")
    ncx, ncy, _ = spec.bins.n_cells
    C, S, R, W = ncx * ncy, spec.bins.cap, spec.rows, spec.window
    T = S // R
    if R % 8 or R > 32 or S % R or W % 64 or W > 256:
        raise ValueError(f"banded kernels take R in 8..32 (multiple of 8) "
                         f"dividing S and W in 64..256: R={R} S={S} W={W}")
    dev = f_cells.device
    a_dtype = getattr(torch, spec.block_dtype)
    if f_cells.shape != (3, C, S):
        raise ValueError("banded kernels take one right-hand side (3, C, S)")
    f = f_cells.to(torch.float32).contiguous()
    coords = [t.to(torch.float32).contiguous()
              for t in (bins.px, bins.py, bins.pz, bins.mask)]
    j0h = j0[:N_HALF].to(torch.int32).contiguous()
    zsh = zsh[:N_HALF].to(torch.float32).contiguous()
    nv = n_valid.to(torch.int32).contiguous()
    if j0h.shape != (N_HALF, C, T) or zsh.shape != (N_HALF, C, T):
        raise ValueError("banded kernels take (>=5, C, T) window tables")
    if build:
        blocks = torch.empty((1, C, 2, S, N_HALF * W), dtype=a_dtype,
                             device=dev)
    elif (blocks.shape != (1, C, 2, S, N_HALF * W) or blocks.dtype != a_dtype
          or not blocks.is_contiguous()):
        raise ValueError("matvec_banded: blocks do not match the spec")
    cheb_dev = _cheb_operand(cheb, str(dev))
    uo = torch.empty((C, 9, 3, S), dtype=torch.float32, device=dev)
    Lf = [float(np.float32(x)) for x in L]
    p = kernels.ptr
    rc = kernels.library().pse_banded(
        int(build), *(p(t) for t in coords), p(f), p(j0h), p(zsh), p(nv),
        p(cheb_dev), cheb.degree + 1, float(np.float32(cheb.mid)),
        float(np.float32(float(ewald_cut) ** 2)),
        float(np.float32(float(ewald_dr) ** 2)),
        ncx, ncy, S, R, W, *Lf, float(np.float32(tilt_xy)),
        int(a_dtype == torch.bfloat16), p(blocks), p(uo), kernels.stream_of(f),
    )
    return blocks, uo, rc


def _fold_planes(uo):
    """(C, 9, 3, S) kernel planes -> (C, N_HALF, 3, S) as _finish_u takes:
    the 5 forward planes summed, then the 4 transposed ones."""
    return torch.cat([uo[:, :N_HALF].sum(dim=1, keepdim=True),
                      uo[:, N_HALF:]], dim=1)


def build_mv_banded(bins: CellBins, tilt_xy, spec: BandSpec, cheb: ChebPair,
                    L, ewald_cut, ewald_dr, j0, n_valid, zsh, f_cells,
                    self_mobility):
    """(blocks, u): build A (1, C, 2, S, 5W) in the block dtype and apply
    the rounded coefficients to ``f_cells`` (3, C, S) in the same kernel.

    On CPU tensors: (None, ``matvec_banded_reference``); ``j0``/``zsh`` then
    cover all 9 offsets (the kernel reads the first 5)."""
    if f_cells.device.type == "cpu":
        return None, matvec_banded_reference(
            bins, tilt_xy, spec, cheb, L, ewald_cut, ewald_dr, j0, n_valid,
            f_cells, self_mobility)
    blocks, uo, rc = _launch_banded(True, bins, tilt_xy, spec, cheb, L,
                                    ewald_cut, ewald_dr, j0, n_valid, zsh,
                                    f_cells)
    build_mv_banded.launches += 1
    kernels.check("build_mv_banded", rc)
    return blocks, _finish_u(_fold_planes(uo), spec, f_cells, self_mobility)


build_mv_banded.launches = 0


def matvec_banded(blocks, bins: CellBins, tilt_xy, spec: BandSpec,
                  cheb: ChebPair, L, ewald_cut, ewald_dr, j0, n_valid, zsh,
                  f_cells, self_mobility):
    """u = M_real f_cells (3, C, S) from the stored ``blocks``.

    On CPU tensors: ``matvec_banded_reference`` (``blocks`` unused)."""
    if f_cells.device.type == "cpu":
        return matvec_banded_reference(
            bins, tilt_xy, spec, cheb, L, ewald_cut, ewald_dr, j0, n_valid,
            f_cells, self_mobility)
    _, uo, rc = _launch_banded(False, bins, tilt_xy, spec, cheb, L,
                               ewald_cut, ewald_dr, j0, n_valid, zsh, f_cells,
                               blocks=blocks)
    matvec_banded.launches += 1
    kernels.check("matvec_banded", rc)
    return _finish_u(_fold_planes(uo), spec, f_cells, self_mobility)


matvec_banded.launches = 0
