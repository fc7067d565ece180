"""Real-space (near-field) Ewald RPY mobility of the gather engine:
U = M_real F over a neighbor list.

PyTorch counterpart of ``pse_tpu/ops/nearfield.py``, the design of the
reference's gpu_stokes_Mreal_kernel (Mobility.cu:594-687): a
thread-per-particle neighbor loop with table lookups becomes gathers over
the fixed-capacity (N, K) neighbor array.

Lanczos applies M_real to many vectors at fixed positions, so the pair
coefficients (table-interpolated UF1 / UF2 and the pair unit vectors) are
computed once per step (``precompute_pair_coeffs``) and each matvec is one
gather of the forces and row sums: no atomics, so reruns are bitwise equal.
Invalid (padded or out-of-range) pairs carry zero coefficients, so the
matvec needs no mask.  Vectors are (N, 3) at the API boundary and (3, N)
inside.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..box import Box, min_image_components


class PairCoeffs(NamedTuple):
    """Per-pair mobility coefficients for repeated matvecs, (N, K) each."""

    nbr: torch.Tensor    # (N, K) int64 neighbor ids, padded with N
    imrr: torch.Tensor   # (N, K) f32 UF1, zero for invalid pairs
    bcoef: torch.Tensor  # (N, K) f32 UF2 - UF1, zero for invalid pairs
    ex: torch.Tensor     # (N, K) f32 unit pair vector components (i - j)
    ey: torch.Tensor
    ez: torch.Tensor


def precompute_pair_coeffs(pos: torch.Tensor, nbr_idx: torch.Tensor,
                           box: Box, table, ewald_cut: float,
                           ewald_dr: float, ewald_n: int) -> PairCoeffs:
    """Table-interpolated UF1 / UF2 of every neighbor pair
    (Mobility.cu:655-670).  ``table``: the (nR, 4) float32 Ewald table
    (numpy or tensor).  Pairs outside [ewald_dr, ewald_cut), the padded
    sentinel entries included, get zero coefficients."""
    n = pos.shape[0]
    nbr = nbr_idx.long()
    pos_pad_t = torch.cat([pos, pos.new_zeros((1, 3))]).t().contiguous()
    dx = pos[:, 0][:, None] - pos_pad_t[0][nbr]
    dy = pos[:, 1][:, None] - pos_pad_t[1][nbr]
    dz = pos[:, 2][:, None] - pos_pad_t[2][nbr]
    dx, dy, dz = min_image_components(box, dx, dy, dz)
    d2 = dx * dx + dy * dy + dz * dz

    valid = ((nbr < n) & (d2 < ewald_cut * ewald_cut)
             & (d2 >= ewald_dr * ewald_dr))
    d2_safe = torch.where(valid, d2, torch.ones_like(d2))
    dist = torch.sqrt(d2_safe)

    # table index and linear interpolation factor (Mobility.cu:661-667)
    r_ind_f = torch.floor(ewald_n * (dist - ewald_dr) / (ewald_cut - ewald_dr))
    table = torch.as_tensor(table, dtype=torch.float32, device=pos.device)
    r_ind = torch.clamp(r_ind_f.to(torch.int32), 0, table.shape[0] - 1)
    fac = dist / ewald_dr - r_ind.to(dist.dtype) - 1.0
    r_ind = r_ind.long()

    table_t = table.t()                                    # (4, nR)
    t_uf1 = table_t[0][r_ind]
    t_uf2 = table_t[1][r_ind]
    t_uf1_next = table_t[2][r_ind]
    t_uf2_next = table_t[3][r_ind]
    imrr = t_uf1 + (t_uf1_next - t_uf1) * fac
    rr = t_uf2 + (t_uf2_next - t_uf2) * fac

    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    imrr = torch.where(valid, imrr, zero)
    rr = torch.where(valid, rr, zero)
    inv_d = torch.where(valid, 1.0 / dist, zero)
    return PairCoeffs(nbr=nbr, imrr=imrr, bcoef=rr - imrr, ex=dx * inv_d,
                      ey=dy * inv_d, ez=dz * inv_d)


def mreal_matvec_t(coeffs: PairCoeffs, ft: torch.Tensor,
                   self_mobility: float, row0: int = 0) -> torch.Tensor:
    """U = M_real F in the transposed (3, N) layout, the Lanczos matvec:
    u_i = self F_i + sum_j [UF1 F_j + (UF2 - UF1)(r-hat . F_j) r-hat]
    (Mobility.cu:632, 673-677).  ``coeffs`` may hold a contiguous range of
    rows from ``row0`` (one device's rows on a sharded engine): u is then
    (3, rows) for those particles, each row summed as in the whole."""
    ft_pad = torch.cat([ft, ft.new_zeros((3, 1))], dim=1)    # (3, N+1)
    fx = ft_pad[0][coeffs.nbr]                               # (N, K)
    fy = ft_pad[1][coeffs.nbr]
    fz = ft_pad[2][coeffs.nbr]
    rdotf = coeffs.ex * fx + coeffs.ey * fy + coeffs.ez * fz
    brf = coeffs.bcoef * rdotf
    ux = torch.sum(coeffs.imrr * fx + brf * coeffs.ex, dim=1)
    uy = torch.sum(coeffs.imrr * fy + brf * coeffs.ey, dim=1)
    uz = torch.sum(coeffs.imrr * fz + brf * coeffs.ez, dim=1)
    rows = ft[:, row0:row0 + coeffs.nbr.shape[0]]
    return self_mobility * rows + torch.stack([ux, uy, uz], dim=0)


def mreal_matvec(coeffs: PairCoeffs, forces: torch.Tensor,
                 self_mobility: float) -> torch.Tensor:
    """U = M_real F with (N, 3) in and out."""
    return mreal_matvec_t(coeffs, forces.t(), self_mobility).t()


def mreal_apply(pos, forces, nbr_idx, box, table, ewald_cut, ewald_dr,
                ewald_n, self_mobility):
    """One-shot U = M_real F (the coefficients, then the matvec)."""
    coeffs = precompute_pair_coeffs(pos, nbr_idx, box, table, ewald_cut,
                                    ewald_dr, ewald_n)
    return mreal_matvec(coeffs, forces, self_mobility)
