"""Cell-blocked NUFFT spread and contract with stored Gaussian weights.

PyTorch counterpart of ``pse_tpu/ops/blocked_farfield.py``.  The FFT grid is
cut into node blocks of (sx, sy, sz) nodes aligned with a particle cell grid
of the same geometry, and spreading is a gather over the 27-stencil:

    grid[block b] = sum_o W(b, o) F[cell b + o]

where W(b, o) in R^{cap x s^3} holds the Gaussian weights between the
block's nodes and the particles of the neighbouring cell; the contraction
is the transposed sweep with the same weights.  ``make_ff_spec`` chooses
the blocks (and whether the grid can be blocked at all: ``make_config``'s
engine choice rests on it).  The step takes this stored-weight path only
where the z-column far field (``column_farfield``) has no spec; the JAX
package's version is plain XLA, so this one is plain PyTorch: batched
products in float32 (bfloat16 weights and the vectors rounded to them are
upcast, as the JAX einsums accumulate in float32).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..box import Box
from ..cellbins import BinSpec, CellBins, full_offsets, roll_cells
from ..params import PSEParams


class FfSpec(NamedTuple):
    """Static blocked-NUFFT configuration (hashable)."""

    bins: BinSpec           # particle cells == node blocks
    s: tuple                # (sx, sy, sz) nodes per block per axis
    offsets: tuple          # full stencil (reach 1)
    store_weights: bool = True    # build W once per step for both directions
    full_precision: bool = False  # error < 1e-3: float32 weights
    weight_dtype: str = "float32"


def _axis_divisors(n_grid: int, p: int):
    """Divisors s of the grid axis with s >= P/2 + 1 (the reach-1 stencil
    covers the Gaussian support) and at least 3 cells."""
    need = p // 2 + 1
    return [s for s in range(need, n_grid // 3 + 1) if n_grid % s == 0]


def make_ff_spec(
    params: PSEParams,
    n_particles: int,
    weight_dtype: str | None = None,
    device="cuda",
) -> FfSpec | None:
    """Per-axis block sizes with the least lane padding of s^3 (the JAX
    package's choice), or None when the grid is too small to block.

    Weights default to bfloat16 on CUDA at error >= 1e-3 and to float32 on
    the CPU and below 1e-3, as ``column_farfield.make_col_spec`` decides."""
    dims = (params.Nx, params.Ny, params.Nz)
    cands = [_axis_divisors(ng, params.gauss_P) for ng in dims]
    if any(not c for c in cands):
        return None

    best = None
    for sx in cands[0]:
        for sy in cands[1]:
            for sz in cands[2]:
                s3 = sx * sy * sz
                if s3 > 1024 and best is not None:
                    continue
                padded = -(-s3 // 128) * 128
                waste = padded / s3
                size_penalty = max(1.0, s3 / 256.0)
                key = (round(waste * size_penalty, 3), s3)
                if best is None or key < best[0]:
                    best = (key, (sx, sy, sz))
    s = best[1]
    nc = (dims[0] // s[0], dims[1] // s[1], dims[2] // s[2])
    mu = n_particles / (nc[0] * nc[1] * nc[2])
    cap = max(8, int(math.ceil((mu + 5.0 * math.sqrt(mu) + 4.0) / 8.0)) * 8)
    cap = min(cap, max(8, int(math.ceil(n_particles / 8.0)) * 8))
    full_precision = params.error < 1e-3
    if weight_dtype is None:
        on_cuda = torch.device(device).type == "cuda"
        weight_dtype = ("bfloat16" if (not full_precision and on_cuda)
                        else "float32")
    elif full_precision and weight_dtype == "bfloat16":
        raise ValueError(
            "bfloat16 far-field weights are incompatible with "
            f"error={params.error:g} < 1e-3 (full-precision passes)"
        )
    return FfSpec(
        bins=BinSpec(n_cells=nc, cap=cap), s=s, offsets=full_offsets(1),
        full_precision=full_precision, weight_dtype=weight_dtype,
    )


def _block_coords(spec: FfSpec, device):
    """(C,) int32 block coordinates per axis (z fastest in the flat id)."""
    ncx, ncy, ncz = spec.bins.n_cells
    bx, by, bz = np.meshgrid(np.arange(ncx), np.arange(ncy), np.arange(ncz),
                             indexing="ij")
    return tuple(torch.as_tensor(b.reshape(-1), dtype=torch.int32,
                                 device=device) for b in (bx, by, bz))


def _particle_node_fractions(bins: CellBins, box: Box, params: PSEParams):
    """Node-space particle coordinates frac * N_grid per axis, (C, cap)."""
    L, lo = box.L, box.lo
    fx = (bins.px - lo[0] - box.tilt_xy * bins.py) / L[0]
    fy = (bins.py - lo[1]) / L[1]
    fz = (bins.pz - lo[2]) / L[2]
    fx = fx - torch.floor(fx)
    fy = fy - torch.floor(fy)
    fz = fz - torch.floor(fz)
    return fx * params.Nx, fy * params.Ny, fz * params.Nz


def _offset_weights(spec: FfSpec, params: PSEParams, box: Box, pf, mask_r,
                    bcoords):
    """W (C, cap, s^3) of one stencil offset, the (rolled) mask folded in."""
    sx, sy, sz = spec.s
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    L = params.L
    expfac = params.spread_expfac
    bx, by, bz = bcoords
    pfx, pfy, pfz = pf
    dev = pfx.device

    def nodes(b, s):
        return (b[:, None] * s + torch.arange(s, dtype=torch.int32,
                                              device=dev)[None, :]).to(
            pfx.dtype)

    def red(fd):
        return fd - torch.round(fd)

    fdx = red((nodes(bx, sx)[:, :, None] - pfx[:, None, :]) / Nx)
    fdy = red((nodes(by, sy)[:, :, None] - pfy[:, None, :]) / Ny)
    fdz = red((nodes(bz, sz)[:, :, None] - pfz[:, None, :]) / Nz)

    dyu = L[1] * fdy
    dz = L[2] * fdz
    dx = (L[0] * fdx)[:, :, None, :] + box.tilt_xy * dyu[:, None, :, :]
    w_xy = torch.exp(-expfac * (dx * dx + (dyu * dyu)[:, None, :, :]))
    w_z = torch.exp(-expfac * dz * dz) * mask_r[:, None, :]
    w_xy = w_xy.permute(0, 3, 1, 2)                  # (C, cap, sx, sy)
    w_z = w_z.permute(0, 2, 1)                       # (C, cap, sz)
    W = w_xy[:, :, :, :, None] * w_z[:, :, None, None, :]
    return W.reshape(W.shape[0], spec.bins.cap, sx * sy * sz).to(
        getattr(torch, spec.weight_dtype))


def _weights_of(bins: CellBins, box: Box, spec: FfSpec, params: PSEParams):
    """W of each stencil offset in turn."""
    bcoords = _block_coords(spec, bins.px.device)
    pf = _particle_node_fractions(bins, box, params)
    for o in spec.offsets:
        pfo = tuple(roll_cells(p, spec.bins, o) for p in pf)
        mo = roll_cells(bins.mask, spec.bins, o)
        yield _offset_weights(spec, params, box, pfo, mo, bcoords)


def build_weights(bins: CellBins, box: Box, spec: FfSpec,
                  params: PSEParams) -> torch.Tensor:
    """All stencil weights (noff, C, cap, s^3), built once per step and
    shared by the spread and the contract."""
    return torch.stack(list(_weights_of(bins, box, spec, params)))


def _blocks_to_grid(blocks: torch.Tensor, spec: FfSpec,
                    params: PSEParams) -> torch.Tensor:
    """(C, 3, s^3) -> (3, Nx, Ny, Nz)."""
    ncx, ncy, ncz = spec.bins.n_cells
    sx, sy, sz = spec.s
    g = blocks.reshape(ncx, ncy, ncz, 3, sx, sy, sz)
    g = g.permute(3, 0, 4, 1, 5, 2, 6)
    return g.reshape(3, params.Nx, params.Ny, params.Nz)


def _grid_to_blocks(grid: torch.Tensor, spec: FfSpec) -> torch.Tensor:
    """(3, Nx, Ny, Nz) -> (C, 3, s^3)."""
    ncx, ncy, ncz = spec.bins.n_cells
    sx, sy, sz = spec.s
    g = grid.reshape(3, ncx, sx, ncy, sy, ncz, sz)
    g = g.permute(1, 3, 5, 0, 2, 4, 6)
    return g.reshape(ncx * ncy * ncz, 3, sx * sy * sz)


def spread_blocked(
    bins: CellBins,
    f_cells: torch.Tensor,         # (3, C, cap), padded slots zero
    box: Box,
    spec: FfSpec,
    params: PSEParams,
    weights: torch.Tensor | None = None,   # (noff, C, cap, s^3)
) -> torch.Tensor:
    """The force-moment grid (3, Nx, Ny, Nz), one gather per offset (no
    scatter).  Without ``weights`` each offset's W is built on the fly."""
    ws = (_weights_of(bins, box, spec, params) if weights is None
          else weights)
    acc = None
    for W, o in zip(ws, spec.offsets):
        fr = torch.stack([roll_cells(f_cells[c], spec.bins, o)
                          for c in range(3)], dim=1)            # (C, 3, cap)
        # the vector rounded to the weight dtype, products summed in f32
        t = torch.bmm(fr.to(W.dtype).float(), W.float())        # (C, 3, s^3)
        acc = t if acc is None else acc + t
    acc = acc * np.float32(params.spread_prefac).item()
    return _blocks_to_grid(acc, spec, params)


def contract_blocked(
    bins: CellBins,
    grid_real: torch.Tensor,       # (3, Nx, Ny, Nz)
    box: Box,
    spec: FfSpec,
    params: PSEParams,
    weights: torch.Tensor | None = None,   # (noff, C, cap, s^3)
) -> torch.Tensor:
    """Particle velocities in cell layout (3, C, cap): the transposed
    sweep, each offset's contribution gathered back to its own cell."""
    ws = (_weights_of(bins, box, spec, params) if weights is None
          else weights)
    v = _grid_to_blocks(grid_real, spec)                        # (C, 3, s^3)
    u = None
    for W, o in zip(ws, spec.offsets):
        contrib = torch.bmm(v.to(W.dtype).float(),
                            W.float().transpose(1, 2))          # (C, 3, cap)
        t = roll_cells(contrib, spec.bins, (-o[0], -o[1], -o[2]))
        u = t if u is None else u + t
    scale = np.float32(params.quadW * params.spread_prefac).item()
    return (scale * u).permute(1, 0, 2)                         # (3, C, cap)
