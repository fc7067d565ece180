"""Cell-list neighbor search with fixed-capacity arrays (the gather engine's).

PyTorch counterpart of ``pse_tpu/neighbors.py``, the analogue of HOOMD's
CellListGPU + NeighborListGPUBinned (the reference rebuilds the list every
step):

  * particles are binned into cells of side >= rcut / subdiv (the x side
    shrunk by the largest xy tilt so the fractional-space stencil still
    covers rcut), each cell holding up to ``cell_capacity`` occupants;
  * per particle, the (2 subdiv + 1)^3 surrounding cells give the
    candidates, which are distance-filtered and compacted into an
    (N, max_neighbors) index array padded with the sentinel N.

The cell table is ``cellbins.bin_particles``' slot table: the same cell ids
(floor, then clip, of the wrapped fractional coordinates) and the same
stable order by cell, so ``idx`` equals the JAX package's element for
element.  On CUDA tensors the binning's tail is the fill kernel.  The
candidates are filtered in row chunks of particles, which bounds the
temporaries (240 M candidates at N = 100k, phi = 0.45) and gives the same
``idx`` and flag as one pass.  Capacity overflow is reported by a flag so
the host can rebuild with larger capacities.  Boxes too small for the
stencil take dense all-pairs candidates.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .box import Box, min_image_components
from .cellbins import BinSpec, bin_particles

# candidates per chunk of rows: bounds the chunk's temporaries (a few
# arrays of this many 4- and 8-byte elements) at a few GB
CHUNK_CANDIDATES = 1 << 26


class NeighborSpec(NamedTuple):
    """Static neighbor-search configuration (hashable)."""

    rcut: float
    n_cells: tuple          # (ncx, ncy, ncz); (1, 1, 1) => all-pairs mode
    cell_capacity: int
    max_neighbors: int
    # cells per rcut: 1 = the 27-stencil of rcut-sized cells; k > 1 = cells
    # of side >= rcut/k searched with a (2k+1)^3 stencil, the analogue of
    # the reference's CellListStencil backend (PSEv1(nlist_type="stencil"))
    subdiv: int = 1

    @property
    def all_pairs(self) -> bool:
        return self.n_cells == (1, 1, 1)


class NeighborList(NamedTuple):
    """``idx[i, :]`` are the neighbor ids of particle i, padded with N."""

    idx: torch.Tensor       # (N, max_neighbors) int32
    overflow: torch.Tensor  # () bool: a capacity was exceeded; rebuild bigger


def _cell_dims(L, rcut: float, max_tilt: float, subdiv: int = 1):
    """Cells per axis so a (2 subdiv + 1)-wide stencil covers rcut in the
    tilted box: in fractional coordinates a displacement with |dx|, |dy|
    <= rcut spans up to rcut (1 + |tilt|) / Lx in x."""
    ncx = int(math.floor(L[0] * subdiv / (rcut * (1.0 + abs(max_tilt)))))
    ncy = int(math.floor(L[1] * subdiv / rcut))
    ncz = int(math.floor(L[2] * subdiv / rcut))
    return ncx, ncy, ncz


def make_spec(
    n_particles: int,
    L,
    rcut: float,
    max_tilt: float = 0.5,
    capacity_factor: float = 1.6,
    max_neighbors: int | None = None,
    avg_density: float | None = None,
    subdiv: int = 1,
) -> NeighborSpec:
    """Host-side sizing of the static neighbor-search shapes."""
    L = tuple(float(x) for x in L)
    subdiv = max(1, int(subdiv))
    ncx, ncy, ncz = _cell_dims(L, rcut, max_tilt, subdiv)
    volume = L[0] * L[1] * L[2]
    density = avg_density if avg_density is not None else n_particles / volume

    if min(ncx, ncy, ncz) < 2 * subdiv + 1:
        # box too small for the cell stencil: dense all-pairs candidates
        return NeighborSpec(
            rcut=float(rcut),
            n_cells=(1, 1, 1),
            cell_capacity=n_particles,
            max_neighbors=(
                max_neighbors if max_neighbors is not None
                else max(1, n_particles - 1)
            ),
        )

    def _poisson_pad(mu: float) -> int:
        # mean + 5 sigma + slack, so Poisson occupancies rarely overflow
        return int(math.ceil((mu + 5.0 * math.sqrt(mu) + 4.0) * capacity_factor))

    cell_vol = volume / (ncx * ncy * ncz)
    cap = max(4, _poisson_pad(density * cell_vol))
    if max_neighbors is None:
        sphere = 4.0 / 3.0 * math.pi * rcut ** 3 * density
        max_neighbors = max(8, _poisson_pad(sphere))
        max_neighbors = min(max_neighbors, max(1, n_particles - 1))
    return NeighborSpec(
        rcut=float(rcut),
        n_cells=(ncx, ncy, ncz),
        cell_capacity=cap,
        max_neighbors=int(max_neighbors),
        subdiv=subdiv,
    )


def _compact_rows(cand, mask, n_particles: int, max_neighbors: int):
    """Compact the masked candidates of each row leftwards into (R, K),
    padded with N: candidate j of row i goes to column cumsum(mask)[i, j]
    - 1 when masked in (clamped onto K once the row holds K), to the dump
    column K otherwise; column K is sliced off.  Returns (idx, overflow)."""
    cols = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    count = torch.where(mask.any(dim=1), cols[:, -1] + 1,
                        torch.zeros_like(cols[:, -1]))
    overflow = (count > max_neighbors).any()
    cols = torch.where(mask, torch.clamp(cols, max=max_neighbors),
                       torch.full_like(cols, max_neighbors))
    out = torch.full((cand.shape[0], max_neighbors + 1), n_particles,
                     dtype=torch.int32, device=cand.device)
    out.scatter_(1, cols.long(), cand.to(torch.int32))
    return out[:, :max_neighbors], overflow


def _row_chunks(n: int, per_row: int):
    step = max(1, CHUNK_CANDIDATES // max(1, per_row))
    return [(r0, min(n, r0 + step)) for r0 in range(0, n, step)]


def _stencil(subdiv: int, device):
    rng = range(-subdiv, subdiv + 1)
    return torch.tensor([(dx, dy, dz) for dx in rng for dy in rng
                         for dz in rng], dtype=torch.int64, device=device)


def _candidates(pos: torch.Tensor, box: Box, spec: NeighborSpec):
    """(cell overflow flag, candidates per row, block): ``block(r0, r1)``
    gives the (R, per_row) candidate ids of the particles r0:r1, padded
    with N, and their mask (a particle, not the row's own, within rcut)."""
    n = pos.shape[0]
    dev = pos.device
    rcut2 = float(np.float32(spec.rcut * spec.rcut))
    pos_pad_t = torch.cat([pos, pos.new_zeros((1, 3))]).t().contiguous()

    if spec.all_pairs:
        cell_overflow = torch.zeros((), dtype=torch.bool, device=dev)
        per_row = n

        def candidates(r0, r1):
            return torch.arange(n, device=dev).expand(r1 - r0, n)
    else:
        ncx, ncy, ncz = spec.n_cells
        cap = spec.cell_capacity
        bins = bin_particles(pos, box, BinSpec(tuple(spec.n_cells), cap))
        cell_overflow = bins.overflow
        cell_table = bins.pid.long()                    # (C, cap), pad N
        cid = bins.cell_of.long()
        cxyz = torch.stack([cid // (ncy * ncz), (cid // ncz) % ncy,
                            cid % ncz], dim=1)
        shifts = _stencil(spec.subdiv, dev)
        ncell = torch.tensor([ncx, ncy, ncz], dtype=torch.int64, device=dev)
        per_row = shifts.shape[0] * cap

        def candidates(r0, r1):
            nbr = torch.remainder(cxyz[r0:r1, None, :] + shifts[None], ncell)
            nbr_cids = (nbr[..., 0] * ncy + nbr[..., 1]) * ncz + nbr[..., 2]
            return cell_table[nbr_cids].reshape(r1 - r0, per_row)

    def block(r0, r1):
        cand = candidates(r0, r1)
        rows = torch.arange(r0, r1, device=dev)
        dx = pos[rows, 0][:, None] - pos_pad_t[0][cand]
        dy = pos[rows, 1][:, None] - pos_pad_t[1][cand]
        dz = pos[rows, 2][:, None] - pos_pad_t[2][cand]
        dx, dy, dz = min_image_components(box, dx, dy, dz)
        d2 = dx * dx + dy * dy + dz * dz
        del dx, dy, dz
        return cand, (cand != n) & (cand != rows[:, None]) & (d2 < rcut2)

    return cell_overflow, per_row, block


def build_neighbor_list(pos: torch.Tensor, box: Box,
                        spec: NeighborSpec) -> NeighborList:
    """The (N, max_neighbors) neighbor list of ``pos`` (N, 3) float32."""
    n = pos.shape[0]
    cell_overflow, per_row, block = _candidates(pos, box, spec)
    idxs, flags = [], [cell_overflow]
    for r0, r1 in _row_chunks(n, per_row):
        idx, ovf = _compact_rows(*block(r0, r1), n, spec.max_neighbors)
        idxs.append(idx)
        flags.append(ovf)
    return NeighborList(torch.cat(idxs), torch.stack(flags).any())


def grow_spec(spec: NeighborSpec, factor: float = 1.5) -> NeighborSpec:
    """Enlarge the capacities after an overflow (host side)."""
    return spec._replace(
        cell_capacity=int(math.ceil(spec.cell_capacity * factor)) + 1,
        max_neighbors=int(math.ceil(spec.max_neighbors * factor)) + 1,
    )


def build_neighbor_list_auto(pos, box, spec: NeighborSpec, max_tries: int = 6):
    """Build, growing the capacities until nothing overflows.  Returns
    (nlist, spec)."""
    for _ in range(max_tries):
        nlist = build_neighbor_list(pos, box, spec)
        if not bool(nlist.overflow):
            return nlist, spec
        spec = grow_spec(spec)
    raise RuntimeError(
        "Neighbor list capacity still overflowing after "
        f"{max_tries} growth steps (spec={spec})."
    )


def neighbor_count_stats(nlist: NeighborList, n_particles: int):
    """(max, mean) neighbor counts, as () tensors."""
    counts = torch.sum(nlist.idx < n_particles, dim=1)
    return torch.max(counts), torch.mean(counts.to(torch.float32))
