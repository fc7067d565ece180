"""Cell-blocked dense near field: U = M_real F as batched dense products.

PyTorch counterpart of ``pse_tpu/ops/blocked_nearfield.py``.  Particles live
in padded (C, cap) cell-major arrays (``cellbins.bin_particles`` on a 3-D
cell grid at least rcut wide), and the real-space mobility between a cell c
and its neighbour c + o is a dense (cap x cap) block per tensor component:

    A[o, k, c] in R^{cap x cap},  k in (xx, xy, xz, yy, yz, zz).

Only the half stencil (``half_space_offsets(1)``, (0,0,0) first) is stored:
the block of -o is the transpose of the block of +o.  ``build_pair_blocks``
builds them once per step; ``matvec_cells`` applies them to a slot-layout
vector, forward u(c) += A(c) f(c+o) and transposed u(c+o) += A(c)^T f(c).

Neither function has a TPU kernel behind it in the JAX package (both are
plain XLA there).  On CUDA tensors each is a hand-written kernel of
``csrc/blocked.cu``: ``build_pair_blocks`` one launch, bitwise its plain
version ``build_pair_blocks_reference``; ``matvec_cells`` one call (two
launches) that reads each live part of a stored block once for both
products, against ``matvec_cells_reference`` (batched ``torch.bmm``, the
JAX package's einsum GEMVs).  CPU tensors run the plain versions.  Both
matvecs compute in float32: bfloat16 blocks are converted for the product,
as jnp.einsum promotes them against float32 vectors, and float32 products
run in full float32 (the port never enables TF32).  Sums are gathers or
fixed-order reductions, never scattered atomics, so a rerun is bitwise
equal.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels, trace
from ..box import Box
from ..cellbins import BinSpec, CellBins, half_space_offsets, roll_cells
from .banded_nearfield import pair_components
from .chebyshev import ChebPair, device_coeffs

# The plain product's float32 copy of bfloat16 blocks is made for a group
# of offsets at a time, at most this many bytes (every offset at once at the
# test sizes; groups of 9 and 5 offsets at N = 100k, phi = 0.45).
UPCAST_BYTES = 1 << 32

# Symmetric component k of the block that maps f_j onto u_i: _COMP[i][j].
_COMP = ((0, 1, 2), (1, 3, 4), (2, 4, 5))


class NfSpec(NamedTuple):
    """Static blocked-near-field configuration (hashable)."""

    bins: BinSpec
    offsets: tuple                 # half-space stencil offsets, (0,0,0) first
    block_dtype: str = "float32"   # storage dtype of the pair blocks


def make_nf_spec(
    n_particles: int,
    L,
    rcut: float,
    max_tilt: float = 0.5,
    target_cap: int = 128,
    block_dtype: str = "float32",
) -> NfSpec:
    """Choose cell counts and capacity, as the JAX package does.

    Cells are at least rcut wide (tilt-inflated along x) so that a
    27-stencil covers every pair; beyond that they are coarsened (by 1.3
    per round) until the padded capacity approaches ``target_cap``."""
    L = tuple(float(x) for x in L)
    nc_max = [
        max(3, int(math.floor(L[0] / (rcut * (1.0 + abs(max_tilt)))))),
        max(3, int(math.floor(L[1] / rcut))),
        max(3, int(math.floor(L[2] / rcut))),
    ]

    def cap_for(nc):
        mu = n_particles / (nc[0] * nc[1] * nc[2])
        cap = mu + 5.0 * math.sqrt(mu) + 4.0
        return max(8, int(math.ceil(cap / 8.0)) * 8)

    nc = list(nc_max)
    best = (tuple(nc), cap_for(nc))
    f = 1.0
    while cap_for(nc) < target_cap * 0.75 and max(nc) > 3:
        f *= 1.3
        nc = [max(3, int(math.floor(m / f))) for m in nc_max]
        best = (tuple(nc), cap_for(nc))
        if min(nc) == 3:
            break
    n_cells, cap = best
    cap = min(cap, max(8, int(math.ceil(n_particles / 8.0)) * 8))
    return NfSpec(
        bins=BinSpec(n_cells=n_cells, cap=cap),
        offsets=half_space_offsets(1),
        block_dtype=block_dtype,
    )


def build_pair_blocks_reference(
    bins: CellBins,
    box: Box,
    spec: NfSpec,
    cheb: ChebPair,
    ewald_cut: float,
    ewald_dr: float,
) -> torch.Tensor:
    """Plain version of the build: the (noff, 6, C, cap, cap) pair blocks
    in the block dtype, from ``pair_components`` on rolled copies of the
    slot arrays.

    One offset at a time into one pre-allocated tensor: the float32
    temporaries of an offset (C, cap, cap each) are freed before the next,
    so the peak is the blocks plus one offset's temporaries."""
    cap = spec.bins.cap
    C = spec.bins.n_cells_total
    dev = bins.px.device
    out = torch.empty((len(spec.offsets), 6, C, cap, cap),
                      dtype=getattr(torch, spec.block_dtype), device=dev)
    eye = torch.eye(cap, dtype=torch.bool, device=dev)
    no_pair = torch.zeros((), dtype=torch.bool, device=dev)
    own = [t[:, :, None] for t in (bins.px, bins.py, bins.pz, bins.mask)]
    for oi, o in enumerate(spec.offsets):
        other = [roll_cells(t, spec.bins, o)[:, None, :]
                 for t in (bins.px, bins.py, bins.pz, bins.mask)]
        comps = pair_components(
            *own, *other, box.tilt_xy, L=box.L,
            cheb=cheb, cut2=float(ewald_cut) ** 2, dr2=float(ewald_dr) ** 2,
            same_slot=eye if o == (0, 0, 0) else no_pair)
        for k, a in enumerate(comps):
            out[oi, k] = a             # rounds to the block dtype
        del comps
    return out


# the C entries' limits (csrc/blocked.cu): the build's 8 slots a thread, at
# most 256 threads a block, and 27 offsets
_MAX_CAP, _MAX_OFFSETS = 8 * 256, 27


@lru_cache(maxsize=8)
def _cheb_operand(cheb: ChebPair, device: str) -> torch.Tensor:
    """The kernel's coefficient operand, copied to ``device`` once."""
    return device_coeffs(cheb, device)


def build_pair_blocks(
    bins: CellBins,
    box: Box,
    spec: NfSpec,
    cheb: ChebPair,
    ewald_cut: float,
    ewald_dr: float,
) -> torch.Tensor:
    """The (noff, 6, C, cap, cap) pair blocks in the block dtype, for the
    offsets of ``spec`` (the half stencil, or a contiguous part of it on a
    sharded engine): one launch of ``csrc/blocked.cu`` on CUDA tensors,
    bitwise ``build_pair_blocks_reference`` there; the reference itself on
    CPU tensors."""
    if bins.px.device.type == "cpu":
        return build_pair_blocks_reference(bins, box, spec, cheb, ewald_cut,
                                           ewald_dr)
    cap = spec.bins.cap
    C = spec.bins.n_cells_total
    slots = (bins.px, bins.py, bins.pz, bins.mask)
    if any(t.shape != (C, cap) or t.dtype != torch.float32
           or not t.is_contiguous() for t in slots):
        raise ValueError(f"build_pair_blocks: the slot arrays must be "
                         f"contiguous float32 ({C}, {cap})")
    offsets = [tuple(int(x) for x in o) for o in spec.offsets]
    if cap % 8 or cap > _MAX_CAP or not 1 <= len(offsets) <= _MAX_OFFSETS:
        raise ValueError(f"build_pair_blocks: cap {cap} must be a multiple "
                         f"of 8 up to {_MAX_CAP}, with 1 to {_MAX_OFFSETS} "
                         f"offsets (not {len(offsets)})")
    dev = bins.px.device
    a_dtype = getattr(torch, spec.block_dtype)
    if a_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"build_pair_blocks: block dtype float32 or "
                         f"bfloat16, not {spec.block_dtype}")
    out = torch.empty((len(offsets), 6, C, cap, cap), dtype=a_dtype,
                      device=dev)
    f32 = np.float32
    L = [f32(x) for x in box.L]
    ncx, ncy, ncz = spec.bins.n_cells
    # the scalars as the plain path's CUDA kernels take them: the box
    # lengths' float32 reciprocals (a tensor over a Python scalar is a
    # product with it), tilt * Ly rounded once, the cuts rounded to float32
    rL = [float(f32(1.0) / x) for x in L]
    offs = (ctypes.c_int * (3 * len(offsets)))(*[x for o in offsets
                                                  for x in o])
    p = kernels.ptr
    rc = kernels.library().pse_blocked_build(
        *(p(t) for t in slots), p(_cheb_operand(cheb, str(dev))),
        cheb.degree + 1, float(f32(cheb.mid)),
        float(f32(float(ewald_cut) ** 2)), float(f32(float(ewald_dr) ** 2)),
        ncx, ncy, ncz, cap, *(float(x) for x in L), *rL,
        float(f32(box.tilt_xy * box.L[1])), len(offsets), offs,
        int(a_dtype == torch.bfloat16), p(out), kernels.stream_of(out))
    trace.count("launch.build_pair_blocks")
    kernels.check("build_pair_blocks", rc)
    return out


@lru_cache(maxsize=None)
def _neighbour_cells(bins: BinSpec, offsets: tuple, device) -> torch.Tensor:
    """(2, noff, C) int64: the flat cell c + o, then c - o, of every cell c
    (periodic), made once per device."""
    cells = torch.arange(bins.n_cells_total, device=device)
    return torch.stack([
        torch.stack([roll_cells(cells, bins, (s * ox, s * oy, s * oz))
                     for ox, oy, oz in offsets])
        for s in (1, -1)])


def _apply(A, rhs, transpose: bool):
    """Per offset of A (k, 6, C, cap, cap) float32 and its right-hand side
    rhs (k, C, cap, 3): u_i = sum_j A_{ij} f_j (or A_{ij}^T f_j) as
    (k, C, cap, 3), each f_j applied to all six components in one bmm."""
    k, _, C, cap, _ = A.shape
    blocks = A.reshape(k * 6 * C, cap, cap)
    if transpose:
        blocks = blocks.transpose(1, 2)
    y = torch.bmm(blocks, rhs[:, None].expand(k, 6, C, cap, 3)
                  .reshape(k * 6 * C, cap, 3))
    y = y.reshape(k, 6, C, cap, 3)
    return torch.stack([
        y[:, ki[0], ..., 0] + y[:, ki[1], ..., 1] + y[:, ki[2], ..., 2]
        for ki in _COMP], dim=-1)


def matvec_cells_reference(
    blocks: torch.Tensor,      # (noff, 6, C, cap, cap) pair blocks
    spec: NfSpec,
    bins: CellBins,
    f_cells: torch.Tensor,     # (3, C, cap); padded slots must be zero
    self_mobility,
) -> torch.Tensor:
    """Plain version of the matvec, u = M_real f in cell layout (3, C, cap):
    the self term, then per offset the forward and (offsets other than
    (0,0,0)) the transposed product by ``torch.bmm`` on a float32 copy of
    the blocks, gathered back to the cells they belong to.  ``spec.offsets``
    may be a contiguous part of the stencil (the blocks of one device on a
    sharded engine): u is then that part's sum, with the self term as
    given (0.0 for none)."""
    noff, _, C, cap, _ = blocks.shape
    # the blocks of (0,0,0), which only apply forward, come first if at all
    first_t = int(tuple(spec.offsets[0]) == (0, 0, 0))
    nbr = _neighbour_cells(spec.bins, tuple(spec.offsets), f_cells.device)
    f = f_cells.permute(1, 2, 0)                     # (C, cap, 3) view
    u = (self_mobility * f_cells * bins.mask).permute(1, 2, 0)
    group = noff if blocks.dtype == torch.float32 else max(
        1, UPCAST_BYTES // (6 * C * cap * cap * 4))
    for o0 in range(0, noff, group):
        o1 = min(o0 + group, noff)
        A = blocks[o0:o1].to(torch.float32)
        u = u + _apply(A, f[nbr[0, o0:o1]], False).sum(0)
        t0 = max(o0, first_t)                        # (0,0,0): forward only
        if t0 < o1:
            w = _apply(A[t0 - o0:], f.expand(o1 - t0, C, cap, 3), True)
            # u(c) += w_o(c - o): a gather, no scattered sums
            w = w[torch.arange(o1 - t0, device=w.device)[:, None],
                  nbr[1, t0:o1]]
            u = u + w.sum(0)
        del A
    return u.permute(2, 0, 1).contiguous()


def matvec_cells(
    blocks: torch.Tensor,      # (noff, 6, C, cap, cap) pair blocks
    spec: NfSpec,
    bins: CellBins,
    f_cells: torch.Tensor,     # (3, C, cap); padded slots must be zero
    self_mobility,
) -> torch.Tensor:
    """u = M_real f in cell layout (3, C, cap), the function of
    ``matvec_cells_reference`` for blocks as ``build_pair_blocks`` leaves
    them (zero at every slot pair with a padded slot): on CUDA tensors one
    call of ``csrc/blocked.cu`` (two launches, its sums in another order
    than the plain version's, a rerun bitwise equal); the reference itself
    on CPU tensors."""
    if blocks.device.type == "cpu":
        return matvec_cells_reference(blocks, spec, bins, f_cells,
                                      self_mobility)
    C, cap = spec.bins.n_cells_total, spec.bins.cap
    offsets = [tuple(int(x) for x in o) for o in spec.offsets]
    noff = len(offsets)
    if (blocks.shape != (noff, 6, C, cap, cap) or not blocks.is_contiguous()
            or blocks.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"matvec_cells: the blocks must be contiguous "
                         f"float32 or bfloat16 ({noff}, 6, {C}, {cap}, "
                         f"{cap}), not {blocks.dtype} {tuple(blocks.shape)}")
    dev = blocks.device
    for name, t, shape in (("f_cells", f_cells, (3, C, cap)),
                           ("mask", bins.mask, (C, cap))):
        if (t.shape != shape or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"matvec_cells: {name} must be contiguous "
                             f"float32 {shape} on {dev}")
    if cap % 8 or cap > _MAX_CAP or not 1 <= noff <= _MAX_OFFSETS:
        raise ValueError(f"matvec_cells: cap {cap} must be a multiple of 8 "
                         f"up to {_MAX_CAP}, with 1 to {_MAX_OFFSETS} "
                         f"offsets (not {noff})")
    first_t = int(offsets[0] == (0, 0, 0))
    f32 = torch.float32
    part = torch.empty((2 * noff - first_t, 3, C, cap), dtype=f32, device=dev)
    live = torch.empty(C, dtype=torch.int32, device=dev)
    u = torch.empty((3, C, cap), dtype=f32, device=dev)
    ncx, ncy, ncz = spec.bins.n_cells
    offs = (ctypes.c_int * (3 * noff))(*[x for o in offsets for x in o])
    p = kernels.ptr
    rc = kernels.library().pse_blocked_matvec(
        p(blocks), p(f_cells), p(bins.mask), float(np.float32(self_mobility)),
        ncx, ncy, ncz, cap, noff, offs, first_t,
        int(blocks.dtype == torch.bfloat16), p(part), p(live), p(u),
        kernels.stream_of(u))
    trace.count("launch.matvec_cells")
    kernels.check("matvec_cells", rc)
    return u
