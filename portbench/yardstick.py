"""The yardstick: the card's published peaks and the least bytes one
application of the stored near-field operator needs.

Peaks are NVIDIA's data sheet for the H100 SXM part at its full 700 W
limit; a share of them is stated with the card's power limit beside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def _column_counts(pos, L, ncx: int, ncy: int):
    """Particles per (x, y) column of an untilted box, from positions on
    any device (the yardstick's own binning)."""
    import torch

    fx = torch.remainder(pos[:, 0].double() / L[0] + 0.5, 1.0)
    fy = torch.remainder(pos[:, 1].double() / L[1] + 0.5, 1.0)
    cx = (fx * ncx).long().clamp(0, ncx - 1)
    cy = (fy * ncy).long().clamp(0, ncy - 1)
    return torch.bincount(cx * ncy + cy, minlength=ncx * ncy)


def _cell_counts(pos, L, n_cells):
    """Particles per cell of an untilted box's (ncx, ncy, ncz) grid, from
    positions on any device (the yardstick's own binning)."""
    import torch

    nc = torch.tensor(n_cells, device=pos.device)
    f = torch.remainder(pos.double() / torch.tensor(L, dtype=torch.float64,
                                                    device=pos.device)
                        + 0.5, 1.0)
    c = torch.minimum((f * nc).long(), nc - 1)
    ncx, ncy, ncz = n_cells
    cid = (c[:, 0] * ncy + c[:, 1]) * ncz + c[:, 2]
    return torch.bincount(cid, minlength=ncx * ncy * ncz).view(ncx, ncy, ncz)


def live_slot_pairs(counts, offsets) -> int:
    """Pairs of occupied slots that the stored half stencil's pair blocks
    hold, from the per-cell counts: n_c n_(c+o) for each offset o other
    than (0, 0, 0), and for (0, 0, 0), whose block is symmetric, the
    n_c (n_c - 1) / 2 pairs of distinct slots."""
    import torch

    c = counts.long()
    total = 0
    for o in offsets:
        o = tuple(int(x) for x in o)
        if o == (0, 0, 0):
            total += int((c * (c - 1) // 2).sum())
        else:
            # rolled[c] = counts[c + o], periodic
            rolled = torch.roll(c, shifts=tuple(-x for x in o), dims=(0, 1, 2))
            total += int((c * rolled).sum())
    return total


def nf_application_bytes(config, pos, L, nrhs: int = 1) -> float:
    """Least bytes of one application of the stored near-field operator,
    each counted once: the operator's stored data that the application
    must read (banded: the rows of A's non-empty R-row tiles, both
    coefficient planes over the 5 stored offsets' W lanes; blocked: 6
    coefficients for each pair of occupied slots that the stored half
    stencil's pair blocks hold, padding slots left out), the right-hand
    side f read and u written (N x 3 float32 each, per right-hand side).
    ``config`` is the program's step configuration (its static shapes);
    ``pos`` the positions."""
    n = pos.shape[0]
    rhs = 2 * nrhs * n * 3 * 4
    if config.engine == "banded":
        bs = config.band_spec
        ncx, ncy, _ = bs.bins.n_cells
        R, W = bs.rows, bs.window
        counts = _column_counts(pos, L, ncx, ncy)
        live_rows = int(((counts + R - 1) // R * R).sum())
        return live_rows * 2 * 5 * W * ITEMSIZE[bs.block_dtype] + rhs
    if config.engine == "blocked":
        spec = config.nf_spec
        counts = _cell_counts(pos, L, tuple(spec.bins.n_cells))
        pairs = live_slot_pairs(counts, spec.offsets)
        return pairs * 6 * ITEMSIZE[spec.block_dtype] + rhs
    return None


def bound_us(nbytes: float) -> float:
    """The least time to move ``nbytes`` at the card's peak bandwidth."""
    return nbytes / HBM_BYTES_PER_S * 1e6
