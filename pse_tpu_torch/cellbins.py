"""Padded cell-major particle storage, and the slot-fill kernel's wrapper.

PyTorch counterpart of ``pse_tpu/cellbins.py``.  Particles are binned into a
fractional-space cell grid, each cell padded to a fixed capacity, so that the
near field and the far field run on dense, regular (C, cap) arrays.
``bin_columns`` bins into (x, y) columns sorted by z inside each column (the
banded near field's layout); ``bin_particles`` bins into the far-field
columns.

The JAX package sorts with a multi-key ``lax.sort``; here the same
lexicographic order comes from chained stable ``torch.sort`` calls.  The
placement of the sorted rows into slots is the fill kernel
(``csrc/fill.cu``), on CUDA tensors, or its plain version on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels
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


def fill_cells_reference(pos_t, order, starts, counts, cap, values_t=None):
    """Plain version of the fill kernel: slot s of cell c takes sorted row
    starts[c] + s when s < counts[c]; pads get mask 0, pid N, zeros.

    pos_t (3, N) f32 and order (N,) i32 are cid-sorted; starts/counts (C,).
    Returns (px, py, pz, mask, pid[, values (3, C, cap)])."""
    n = order.shape[0]
    s = torch.arange(cap, device=order.device)
    valid = s[None, :] < counts[:, None].long()
    idx = torch.clamp(starts[:, None].long() + s[None, :], 0, max(n - 1, 0))
    zero = torch.zeros((), dtype=torch.float32, device=order.device)
    px, py, pz = (torch.where(valid, pos_t[k][idx], zero) for k in range(3))
    mask = valid.to(torch.float32)
    pid = torch.where(valid, order[idx], torch.full((), n, dtype=order.dtype,
                                                    device=order.device))
    fields = (px, py, pz, mask, pid.to(torch.int32))
    if values_t is not None:
        fields += (torch.stack(
            [torch.where(valid, values_t[k][idx], zero) for k in range(3)]
        ),)
    return fields


def fill_cells(pos_t, order, starts, counts, cap, values_t=None):
    """Cid-sorted rows -> (C, cap) slots: the fill kernel on CUDA tensors,
    its plain version (``fill_cells_reference``) on CPU tensors."""
    if pos_t.device.type == "cpu":
        return fill_cells_reference(pos_t, order, starts, counts, cap, values_t)
    n = order.shape[0]
    C = starts.shape[0]
    dev = pos_t.device
    pos_t = pos_t.contiguous().to(torch.float32)
    order = order.contiguous().to(torch.int32)
    starts = starts.contiguous().to(torch.int32)
    counts = counts.contiguous().to(torch.int32)
    if values_t is not None:
        values_t = values_t.contiguous().to(torch.float32)
    if pos_t.shape != (3, n) or counts.shape != (C,):
        raise ValueError("fill_cells: expected pos_t (3, N), starts/counts (C,)")
    f32 = dict(dtype=torch.float32, device=dev)
    px, py, pz, mask = (torch.empty((C, cap), **f32) for _ in range(4))
    pid = torch.empty((C, cap), dtype=torch.int32, device=dev)
    vout = (torch.empty((3, C, cap), **f32) if values_t is not None else None)
    p = kernels.ptr
    rc = kernels.library().pse_fill_cells(
        p(pos_t), p(order), p(values_t), p(starts), p(counts), n, C, cap,
        p(px), p(py), p(pz), p(mask), p(pid), p(vout), kernels.stream_of(pos_t),
    )
    fill_cells.launches += 1
    kernels.check("fill_cells", rc)
    fields = (px, py, pz, mask, pid)
    return fields + ((vout,) if values_t is not None else ())


fill_cells.launches = 0


def _cell_starts_counts(sorted_cid, c_total, cap):
    """Per-cell start offsets / occupancies of the cid-sorted array, the
    within-cell ranks of the sorted rows, and the overflow flag."""
    n = sorted_cid.shape[0]
    dev = sorted_cid.device
    arange = torch.arange(n, dtype=torch.int64, device=dev)
    cells = torch.arange(c_total, dtype=sorted_cid.dtype, device=dev)
    starts = torch.searchsorted(sorted_cid, cells, side="left")
    counts = torch.diff(torch.cat(
        [starts, torch.full((1,), n, dtype=starts.dtype, device=dev)]
    ))
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_cid[1:] != sorted_cid[:-1]
    seg_start = torch.cummax(
        torch.where(is_start, arange, torch.zeros_like(arange)), dim=0
    ).values
    rank_sorted = arange - seg_start
    overflow = (rank_sorted >= cap).any()
    return (starts.to(torch.int32), counts.to(torch.int32),
            rank_sorted.to(torch.int32), overflow)


def _finish_bins(sort, c_total, cap, values=None):
    """Shared tail of both binnings: ranks, the slot fill, CellBins."""
    order, sorted_cid, cid, xyz = sort
    starts, counts, rank_sorted, overflow = _cell_starts_counts(
        sorted_cid, c_total, cap
    )
    rank_of = torch.empty_like(rank_sorted)
    rank_of[order] = rank_sorted
    vals_t = None if values is None else values[order].t()
    fields = fill_cells(torch.stack(xyz), order.to(torch.int32),
                        starts, counts, cap, vals_t)
    bins = CellBins(*fields[:5], cell_of=cid.to(torch.int32),
                    rank_of=rank_of, overflow=overflow)
    return bins if values is None else (bins, fields[5])


def fill_operands(pos: torch.Tensor, box: Box, spec: BinSpec, columns: bool):
    """The fill kernel's operands (pos_t, order, starts, counts) for the
    binning of ``pos`` by ``bin_columns`` (columns=True) or
    ``bin_particles``."""
    sort = (_sort_columns if columns else _sort_particles)(pos, box, spec)
    order, sorted_cid, _, xyz = sort
    starts, counts, _, _ = _cell_starts_counts(
        sorted_cid, spec.n_cells_total, spec.cap)
    return torch.stack(xyz), order.to(torch.int32), starts, counts


def _sort_particles(pos, box: Box, spec: BinSpec):
    """(order, sorted cid, cid, sorted xyz) of the cell binning."""
    ncx, ncy, ncz = spec.n_cells
    frac = make_fraction(box, pos)
    frac = frac - torch.floor(frac)
    nc = torch.tensor([ncx, ncy, ncz], dtype=pos.dtype, device=pos.device)
    hi = torch.tensor([ncx - 1, ncy - 1, ncz - 1], dtype=torch.int32,
                      device=pos.device)
    cxyz = torch.minimum(
        torch.clamp(torch.floor(frac * nc).to(torch.int32), min=0), hi
    )
    cid = (cxyz[:, 0] * ncy + cxyz[:, 1]) * ncz + cxyz[:, 2]
    # (cid, id) lexicographic: one stable sort on cid keeps index order
    sorted_cid, order = torch.sort(cid.long(), stable=True)
    return order, sorted_cid, cid, tuple(pos[order, k] for k in range(3))


def _sort_columns(pos, box: Box, spec: BinSpec):
    """(order, sorted cid, cid, sorted canonical xyz) of the column
    binning, z ascending within each column."""
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
    sorted_cid, o2 = torch.sort(cid[by_z].long(), stable=True)
    order = by_z[o2]
    return order, sorted_cid, cid, (x_c[order], y_c[order], z_c[order])


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


def roll_cells(arr: torch.Tensor, spec: BinSpec, offset) -> torch.Tensor:
    """``arr`` (C, ...) with flat cell c holding the data of cell c + offset
    (periodic), offset = (ox, oy, oz)."""
    ncx, ncy, ncz = spec.n_cells
    a = arr.reshape((ncx, ncy, ncz) + tuple(arr.shape[1:]))
    a = torch.roll(a, (-offset[0], -offset[1], -offset[2]), dims=(0, 1, 2))
    return a.reshape(arr.shape)
