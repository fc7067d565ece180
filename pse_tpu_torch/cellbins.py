"""Padded cell-major particle storage, and the fill kernel's wrapper.

PyTorch counterpart of ``pse_tpu/cellbins.py``.  Particles are binned into a
fractional-space cell grid, each cell padded to a fixed capacity, so that the
near field and the far field run on dense, regular (C, cap) arrays.
``bin_columns`` bins into (x, y) columns sorted by z inside each column (the
banded near field's layout); ``bin_particles`` bins into 3-D cells (the
blocked near field's) or the far-field columns.

The JAX package sorts with a multi-key ``lax.sort``; here the same
lexicographic order comes from chained stable ``torch.sort`` calls.  All
that follows the sort (slots, within-cell ranks, cell starts and counts,
the overflow flag, the binned values) is one launch of the fill kernel
(``csrc/fill.cu``) on CUDA tensors, or its plain version on CPU tensors.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import kernels, trace
from .box import Box, make_fraction


class BinSpec(NamedTuple):
    """Static binning configuration (hashable)."""

    n_cells: tuple      # (ncx, ncy, ncz)
    cap: int            # padded slots per cell

    @property
    def n_cells_total(self) -> int:
        ncx, ncy, ncz = self.n_cells
        return ncx * ncy * ncz


class CellBins(NamedTuple):
    """Particles in padded cell-major layout (z fastest in the flat cell id).

    Padded slots have mask 0, pid == N and positions 0."""

    px: torch.Tensor       # (C, cap) f32 positions
    py: torch.Tensor
    pz: torch.Tensor
    mask: torch.Tensor     # (C, cap) f32: 1 valid / 0 pad
    pid: torch.Tensor      # (C, cap) i32: particle index, N for pad
    cell_of: torch.Tensor  # (N,) i32: flat cell of each particle
    rank_of: torch.Tensor  # (N,) i32: slot within the cell (may exceed cap-1
                           #          only when overflow is set)
    overflow: torch.Tensor  # () bool


class Fill(NamedTuple):
    """Everything the fill computes from one binning's sort."""

    px: torch.Tensor        # (C, cap) f32
    py: torch.Tensor
    pz: torch.Tensor
    mask: torch.Tensor      # (C, cap) f32
    pid: torch.Tensor       # (C, cap) i32
    rank_of: torch.Tensor   # (N,) i32, ranks >= cap included
    overflow: torch.Tensor  # () bool: some cell holds more than cap
    starts: torch.Tensor    # (C,) i32: searchsorted(sorted_cid, c, "left")
    counts: torch.Tensor    # (C,) i32
    values: torch.Tensor | None   # (3, C, cap) when values were given


def fill_cells_reference(sorted_cid, order, coords, n_cells, cap,
                         values=None) -> Fill:
    """Plain version of the fill kernel.  ``sorted_cid`` (N,) and ``order``
    (N,) are the sort's keys and permutation, ``coords`` three unsorted (N,)
    coordinate arrays, ``values`` unsorted (N, 3) or None.  Slot s of cell c
    takes sorted row starts[c] + s when s < counts[c]; pads get mask 0,
    pid N, zeros.  The rank of sorted row i is i - starts[sorted_cid[i]]."""
    n = order.shape[0]
    dev = order.device
    cells = torch.arange(n_cells, dtype=sorted_cid.dtype, device=dev)
    starts = torch.searchsorted(sorted_cid, cells, side="left")
    counts = torch.diff(starts, append=torch.full((1,), n, dtype=starts.dtype,
                                                  device=dev))
    rank_of = torch.empty(n, dtype=torch.int32, device=dev)
    rank_of[order] = (torch.arange(n, device=dev)
                      - starts[sorted_cid.long()]).to(torch.int32)
    s = torch.arange(cap, device=dev)
    valid = s[None, :] < counts[:, None]
    rows = order[torch.clamp(starts[:, None] + s[None, :], 0, max(n - 1, 0))]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    px, py, pz = (torch.where(valid, x[rows], zero) for x in coords)
    pid = torch.where(valid, rows, n).to(torch.int32)
    vals = None if values is None else torch.stack(
        [torch.where(valid, values[rows, k], zero) for k in range(3)])
    return Fill(px, py, pz, valid.to(torch.float32), pid, rank_of,
                (counts > cap).any(), starts.to(torch.int32),
                counts.to(torch.int32), vals)


def _as(t, dtype):
    """``t`` contiguous in ``dtype`` (no copy when it already is)."""
    return (t if t.dtype == dtype else t.to(dtype)).contiguous()


def _strided(coords):
    """The three float32 coordinate arrays with one common element stride."""
    xs = [x if x.dtype == torch.float32 else x.float() for x in coords]
    if not xs[0].stride(0) == xs[1].stride(0) == xs[2].stride(0):
        xs = [x.contiguous() for x in xs]
    return xs, xs[0].stride(0)


def fill_cells(sorted_cid, order, coords, n_cells, cap, values=None) -> Fill:
    """The binning's tail after the sort: the fill kernel on CUDA tensors,
    its plain version (``fill_cells_reference``) on CPU tensors.  The
    outputs are views of two buffers (few torch calls: the wrapper is
    host-bound), every element written by the kernel."""
    if order.device.type == "cpu":
        return fill_cells_reference(sorted_cid, order, coords, n_cells, cap,
                                    values)
    n, C = order.shape[0], n_cells
    sorted_cid, order = _as(sorted_cid, torch.int32), _as(order, torch.int64)
    (x, y, z), stride = _strided(coords)
    if values is not None:
        values = _as(values, torch.float32)
    if (sorted_cid.shape != (n,) or x.shape != (n,)
            or (values is not None and values.shape != (n, 3))):
        raise ValueError("fill_cells: expected sorted_cid, order and coords "
                         "(N,), values (N, 3)")
    planes = torch.empty((5 if values is None else 8, C, cap),
                         dtype=torch.float32, device=order.device)
    px, py, pz, mask, pid, *_ = planes.unbind(0)
    pid = pid.view(torch.int32)
    vout = None if values is None else planes[5:]
    rank_of, starts, counts, flag = torch.empty(
        n + 2 * C + 1, dtype=torch.int32, device=order.device
    ).split([n, C, C, 1])
    overflow = flag.view(torch.bool)[0]
    p = kernels.ptr
    rc = kernels.library().pse_fill_cells(
        p(sorted_cid), p(order), p(x), p(y), p(z), stride, p(values), n, C,
        cap, p(px), p(py), p(pz), p(mask), p(pid), p(vout), p(rank_of),
        p(starts), p(counts), p(overflow), kernels.stream_of(order),
    )
    trace.count("launch.fill_cells")
    kernels.check("fill_cells", rc)
    return Fill(px, py, pz, mask, pid, rank_of, overflow, starts, counts,
                vout)



def _finish_bins(sort, c_total, cap, values=None):
    """The fill on the sort's output, as CellBins (and the binned values)."""
    order, sorted_cid, cid, coords = sort
    f = fill_cells(sorted_cid, order, coords, c_total, cap, values)
    bins = CellBins(f.px, f.py, f.pz, f.mask, f.pid, cell_of=cid,
                    rank_of=f.rank_of, overflow=f.overflow)
    return bins if values is None else (bins, f.values)


def fill_operands(pos: torch.Tensor, box: Box, spec: BinSpec, columns: bool):
    """The fill's operands (sorted_cid, order, coords) for the binning of
    ``pos`` by ``bin_columns`` (columns=True) or ``bin_particles``."""
    order, sorted_cid, _, coords = (
        _sort_columns if columns else _sort_particles)(pos, box, spec)
    return sorted_cid, order, coords


@functools.lru_cache(maxsize=None)
def _cell_grid(n_cells, dtype, device):
    """(cells per axis in ``dtype``, last cell index per axis) on
    ``device``, made once: a tensor built from a list in every call copies
    from the host and waits for the stream."""
    return (torch.tensor(n_cells, dtype=dtype, device=device),
            torch.tensor([c - 1 for c in n_cells], dtype=torch.int32,
                         device=device))


def _sort_particles(pos, box: Box, spec: BinSpec):
    """(order, sorted cid, cid (N,) i32, unsorted xyz) of the cell
    binning."""
    ncx, ncy, ncz = spec.n_cells
    frac = make_fraction(box, pos)
    frac = frac - torch.floor(frac)
    nc, hi = _cell_grid(tuple(spec.n_cells), pos.dtype, pos.device)
    cxyz = torch.minimum(
        torch.clamp(torch.floor(frac * nc).to(torch.int32), min=0), hi
    )
    cid = (cxyz[:, 0] * ncy + cxyz[:, 1]) * ncz + cxyz[:, 2]
    # (cid, id) lexicographic: one stable sort on cid keeps index order
    sorted_cid, order = torch.sort(cid, stable=True)
    return order, sorted_cid, cid, tuple(pos[:, k] for k in range(3))


def _sort_columns(pos, box: Box, spec: BinSpec):
    """(order, sorted cid, cid (N,) i32, unsorted canonical xyz) of the
    column binning, z ascending within each column."""
    ncx, ncy, ncz = spec.n_cells
    if ncz != 1:
        raise ValueError("bin_columns bins in (x, y) only")
    L = box.L
    frac = make_fraction(box, pos)
    k = torch.floor(frac)
    frac = frac - k
    x_c = pos[:, 0] - k[:, 0] * L[0] - k[:, 1] * box.tilt_xy * L[1]
    y_c = pos[:, 1] - k[:, 1] * L[1]
    z_c = pos[:, 2] - k[:, 2] * L[2]
    cx = torch.clamp((frac[:, 0] * ncx).to(torch.int32), 0, ncx - 1)
    cy = torch.clamp((frac[:, 1] * ncy).to(torch.int32), 0, ncy - 1)
    cid = cx * ncy + cy
    # (cid, z, id) lexicographic: stable sort by z, then stable sort by cid
    _, by_z = torch.sort(z_c, stable=True)
    sorted_cid, o2 = torch.sort(cid[by_z], stable=True)
    return by_z[o2], sorted_cid, cid, (x_c, y_c, z_c)


def bin_particles(pos: torch.Tensor, box: Box, spec: BinSpec, values=None):
    """Bin particles into (C, cap) slots in particle-index order per cell.

    ``values``: optional (N, 3) per-particle values binned alongside;
    returns (bins, (3, C, cap) values) when given."""
    return _finish_bins(_sort_particles(pos, box, spec), spec.n_cells_total,
                        spec.cap, values)


def bin_columns(pos: torch.Tensor, box: Box, spec: BinSpec, values=None):
    """Bin into (x, y) columns and sort by z within each column.

    Same padded layout as ``bin_particles`` with ``spec.n_cells =
    (ncx, ncy, 1)`` and slots in ascending z inside every column: the
    particles within rcut of a slot then form a contiguous rank band of each
    neighbouring column (ops/banded_nearfield.py).

    Stored positions are canonicalized: each particle's binning image
    (lattice vectors of the tilted box) is subtracted, so every stored
    coordinate lies in the primary cell and agrees with its column index.
    """
    return _finish_bins(_sort_columns(pos, box, spec), spec.n_cells_total,
                        spec.cap, values)


def choose_cap(mean_occupancy: float, multiple: int = 8,
               slack_sigmas: float = 5.0) -> int:
    """Capacity covering Poisson occupancy tails, rounded to a multiple."""
    mu = max(mean_occupancy, 1e-3)
    cap = mu + slack_sigmas * math.sqrt(mu) + 4.0
    return int(math.ceil(cap / multiple)) * multiple


def _slots(bins: CellBins, spec: BinSpec):
    return (bins.cell_of.long() * spec.cap
            + torch.clamp(bins.rank_of.long(), max=spec.cap - 1))


def vec_to_cells(bins: CellBins, spec: BinSpec, values: torch.Tensor):
    """(N, 3) particle vectors -> (3, C, cap) in one scatter."""
    flat = torch.zeros((spec.n_cells_total * spec.cap, 3), dtype=values.dtype,
                       device=values.device)
    flat[_slots(bins, spec)] = values
    return flat.t().reshape(3, spec.n_cells_total, spec.cap)


def vec_from_cells(bins: CellBins, spec: BinSpec, cells: torch.Tensor):
    """(3, C, cap) -> (N, 3) in one gather."""
    return cells.reshape(3, -1).t()[_slots(bins, spec)]


def to_cells(bins: CellBins, spec: BinSpec, values: torch.Tensor,
             fill=0.0) -> torch.Tensor:
    """Per-particle values (N,) -> (C, cap) cell layout, ``fill`` in the
    empty slots (a particle past its cell's cap lands on the last slot)."""
    out = torch.full((spec.n_cells_total * spec.cap,), fill,
                     dtype=values.dtype, device=values.device)
    out[_slots(bins, spec)] = values
    return out.reshape(spec.n_cells_total, spec.cap)


def from_cells(bins: CellBins, spec: BinSpec,
               cell_values: torch.Tensor) -> torch.Tensor:
    """(C, cap) cell layout -> per-particle values (N,)."""
    return cell_values.reshape(-1)[_slots(bins, spec)]


def roll_cells(arr: torch.Tensor, spec: BinSpec, offset) -> torch.Tensor:
    """``arr`` (C, ...) with flat cell c holding the data of cell c + offset
    (periodic), offset = (ox, oy, oz)."""
    ncx, ncy, ncz = spec.n_cells
    a = arr.reshape((ncx, ncy, ncz) + tuple(arr.shape[1:]))
    a = torch.roll(a, (-offset[0], -offset[1], -offset[2]), dims=(0, 1, 2))
    return a.reshape(arr.shape)


def half_space_offsets(reach: int = 1):
    """(0,0,0) plus the lexicographically positive half of the stencil.

    Pair blocks for -o are transposes of those for +o, so only half are
    built; the matvec applies each block in both directions."""
    offs = [(0, 0, 0)]
    rng = range(-reach, reach + 1)
    for ox in rng:
        for oy in rng:
            for oz in rng:
                if (ox, oy, oz) > (0, 0, 0):
                    offs.append((ox, oy, oz))
    return tuple(offs)


def full_offsets(reach: int = 1):
    rng = range(-reach, reach + 1)
    return tuple((ox, oy, oz) for ox in rng for oy in rng for oz in rng)
