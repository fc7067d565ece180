"""Z-column NUFFT far field: factors, the plain contract, the contract kernel.

PyTorch counterpart of ``pse_tpu/ops/column_farfield.py`` (the thermal
slice needs the contract only; the spread is with-forces work).  Cells are
full-height columns of (sx, sy, Nz) grid nodes.  For a particle p in column
c and its 3x3 xy window G (9 sx sy xy nodes by Nz z nodes), the Gaussian
quadrature is the bilinear form

    u[p, k] = wxy[p, :] . G[:, k, :] . wz[p, :]^T

``contract_col`` evaluates it with einsums (the plain version);
``contract_col_kernel`` runs ``csrc/contract.cu`` on CUDA tensors and the
plain version on CPU tensors.  Reference semantics: gpu_stokes_Contract_kernel
(Mobility.cu:325-477).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..box import Box
from ..cellbins import BinSpec, CellBins
from ..params import PSEParams


class ColFfSpec(NamedTuple):
    """Static z-column far-field configuration (hashable)."""

    bins: BinSpec            # n_cells = (ncx, ncy, 1); cap per column
    s: tuple                 # (sx, sy) nodes per column per axis
    full_precision: bool = False
    weight_dtype: str = "float32"


class ColFactors(NamedTuple):
    """Per-step Gaussian factors (cap minor), in the weight dtype."""

    wxy: torch.Tensor   # (C, 9 sx sy, cap) joint xy window factor (tilted)
    wz: torch.Tensor    # (C, Nz, cap) full-column z factor, mask folded


def make_col_spec(
    params: PSEParams,
    n_particles: int,
    weight_dtype: str | None = None,
    device="cuda",
) -> ColFfSpec | None:
    """Choose (sx, sy) as grid divisors covering the Gaussian reach
    (sx, sy >= P/2 + 1, >= 3 columns per axis); None when the grid is too
    small.  Factors default to bfloat16 on CUDA at error >= 1e-3 (float32
    accumulation in the kernel), float32 on the CPU and below 1e-3."""
    need = params.gauss_P // 2 + 1

    def best_axis(ng):
        cands = [s for s in range(need, ng // 3 + 1) if ng % s == 0]
        return min(cands) if cands else None

    sx = best_axis(params.Nx)
    sy = best_axis(params.Ny)
    if sx is None or sy is None:
        return None
    ncx, ncy = params.Nx // sx, params.Ny // sy

    mu = n_particles / (ncx * ncy)
    cap = int(math.ceil((mu + 5.0 * math.sqrt(mu) + 4.0) / 8.0)) * 8
    cap = min(cap, max(8, int(math.ceil(n_particles / 8.0)) * 8))

    full_precision = params.error < 1e-3
    if weight_dtype is None:
        on_cuda = torch.device(device).type == "cuda"
        weight_dtype = ("bfloat16" if (not full_precision and on_cuda)
                        else "float32")
    elif full_precision and weight_dtype == "bfloat16":
        raise ValueError(
            "bfloat16 far-field factors are incompatible with "
            f"error={params.error:g} < 1e-3 (full-precision passes)"
        )
    return ColFfSpec(
        bins=BinSpec(n_cells=(ncx, ncy, 1), cap=cap),
        s=(sx, sy),
        full_precision=full_precision,
        weight_dtype=weight_dtype,
    )


def _node_fractions_xy(bins: CellBins, box: Box, params: PSEParams):
    """Node-space particle coordinates per axis (C, cap), tilt-reduced x."""
    L, lo = box.L, box.lo
    fx = (bins.px - lo[0] - box.tilt_xy * bins.py) / L[0]
    fy = (bins.py - lo[1]) / L[1]
    fz = (bins.pz - lo[2]) / L[2]
    fx = fx - torch.floor(fx)
    fy = fy - torch.floor(fy)
    fz = fz - torch.floor(fz)
    return fx * params.Nx, fy * params.Ny, fz * params.Nz


def _weight_dtype(spec: ColFfSpec) -> torch.dtype:
    return torch.float32 if spec.full_precision else getattr(
        torch, spec.weight_dtype)


def build_col_factors(
    bins: CellBins, box: Box, spec: ColFfSpec, params: PSEParams
) -> ColFactors:
    """Gaussian factors of every slot: wxy over the 3x3 window's xy nodes in
    offset-major order (ox, oy, sx, sy), wz over the full z column."""
    sx, sy = spec.s
    ncx, ncy, _ = spec.bins.n_cells
    C = ncx * ncy
    cap = spec.bins.cap
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    L = params.L
    expfac = params.spread_expfac
    dev = bins.px.device
    pfx, pfy, pfz = _node_fractions_xy(bins, box, params)

    bx, by = np.meshgrid(np.arange(ncx), np.arange(ncy), indexing="ij")
    bx = torch.as_tensor(bx.reshape(-1), dtype=torch.int32, device=dev)
    by = torch.as_tensor(by.reshape(-1), dtype=torch.int32, device=dev)

    def ext_frac_delta(b, s, pf, N):
        node = (b[:, None] - 1) * s + torch.arange(3 * s, dtype=torch.int32,
                                                   device=dev)
        fd = node[:, :, None].to(pf.dtype) / N - (pf / N)[:, None, :]
        return fd - torch.round(fd)                   # (C, 3s, cap)

    fdx = ext_frac_delta(bx, sx, pfx, Nx)
    fdy = ext_frac_delta(by, sy, pfy, Ny)
    nodez = torch.arange(Nz, dtype=pfz.dtype, device=dev)
    fdz = nodez[None, :, None] / Nz - (pfz / Nz)[:, None, :]
    fdz = fdz - torch.round(fdz)                      # (C, Nz, cap)

    dyu = L[1] * fdy
    dz = L[2] * fdz
    dxo = (L[0] * fdx).reshape(C, 3, sx, cap)
    dyo = dyu.reshape(C, 3, sy, cap)
    dx = dxo[:, :, None, :, None, :] + box.tilt_xy * dyo[:, None, :, None]
    dtype = _weight_dtype(spec)
    wxy = torch.exp(-expfac * (dx * dx + (dyo * dyo)[:, None, :, None]))
    wz = torch.exp(-expfac * dz * dz) * bins.mask[:, None, :]
    return ColFactors(
        wxy=wxy.reshape(C, 9 * sx * sy, cap).to(dtype),
        wz=wz.to(dtype),
    )


def _grid_to_windows(grid: torch.Tensor, spec: ColFfSpec, params: PSEParams,
                     dtype):
    """(3, Nx, Ny, Nz) -> (C, 9 sx sy, 3 Nz) xy windows, offset-major nodes,
    rounded to ``dtype`` before the 9x duplication."""
    sx, sy = spec.s
    ncx, ncy, _ = spec.bins.n_cells
    g = grid.to(dtype).reshape(3, ncx, sx, ncy, sy, params.Nz)
    g = g.permute(1, 2, 3, 4, 0, 5)              # (ncx, sx, ncy, sy, 3, Nz)
    gx = torch.stack([torch.roll(g, 1 - o, dims=0) for o in range(3)], dim=1)
    gxy = torch.stack([torch.roll(gx, 1 - o, dims=3) for o in range(3)], dim=4)
    gxy = gxy.permute(0, 3, 1, 4, 2, 5, 6, 7)
    return gxy.reshape(ncx * ncy, 9 * sx * sy, 3 * params.Nz)


def contract_col(grid_real: torch.Tensor, spec: ColFfSpec, params: PSEParams,
                 factors: ColFactors) -> torch.Tensor:
    """Plain version: particle velocities (3, C, cap) from the velocity grid.

    Products of weight-dtype values are summed in float32; H = G^T wxy is
    rounded to the weight dtype before the z contraction, as the JAX
    package's XLA path does."""
    C = spec.bins.n_cells_total
    cap = spec.bins.cap
    dtype = _weight_dtype(spec)
    v = _grid_to_windows(grid_real, spec, params, dtype).float()
    H = torch.einsum("cnp,cnm->cmp", factors.wxy.float(), v)
    H = H.to(dtype).float().reshape(C, 3, params.Nz, cap)
    u = torch.einsum("ckzp,czp->kcp", H, factors.wz.float())
    return np.float32(params.quadW * params.spread_prefac).item() * u


def contract_col_kernel(grid_real: torch.Tensor, spec: ColFfSpec,
                        params: PSEParams, factors: ColFactors):
    """(3, C, cap) velocities: ``csrc/contract.cu`` on CUDA tensors, the plain
    ``contract_col`` on CPU tensors."""
    if grid_real.device.type == "cpu":
        return contract_col(grid_real, spec, params, factors)
    sx, sy = spec.s
    ncx, ncy, _ = spec.bins.n_cells
    C, cap = ncx * ncy, spec.bins.cap
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    dtype = _weight_dtype(spec)
    grid = grid_real.to(torch.float32).contiguous()
    wxy, wz = factors.wxy.contiguous(), factors.wz.contiguous()
    if (grid.shape != (3, Nx, Ny, Nz) or wxy.shape != (C, 9 * sx * sy, cap)
            or wz.shape != (C, Nz, cap) or wxy.dtype != dtype
            or wz.dtype != dtype):
        raise ValueError("contract_col_kernel: operand shapes/dtypes do not "
                         "match the spec")
    u = torch.empty((3, C, cap), dtype=torch.float32, device=grid.device)
    scale = float(np.float32(params.quadW * params.spread_prefac))
    p = kernels.ptr
    rc = kernels.library().pse_contract_col(
        p(grid), p(wxy), p(wz), int(dtype == torch.bfloat16), ncx, ncy, sx,
        sy, Nx, Ny, Nz, cap, scale, p(u), kernels.stream_of(grid),
    )
    contract_col_kernel.launches += 1
    kernels.check("contract_col_kernel", rc)
    return u


contract_col_kernel.launches = 0
