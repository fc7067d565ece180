"""Z-column NUFFT far field: factors, spread and contract, and their kernels.

PyTorch counterpart of ``pse_tpu/ops/column_farfield.py``.  Cells are
full-height columns of (sx, sy, Nz) grid nodes.  For a particle p in column
c and its 3x3 xy window G (9 sx sy xy nodes by Nz z nodes), the Gaussian
quadrature is the bilinear form

    u[p, k] = wxy[p, :] . G[:, k, :] . wz[p, :]^T

``contract_col`` evaluates it with einsums (the plain version);
``contract_col_kernel`` runs ``csrc/contract.cu`` on CUDA tensors and the
plain version on CPU tensors.  The spread is its transpose: per column the
window moments out_c = wxy_c (f_c (x) wz_c)^T, overlap-added onto the grid
along x and y (``_windows_to_grid``).  It always takes float32 factors,
computed from the slots' node-space coordinates (``spread_nodes``) and
never stored: one product in a narrower weight dtype loses the cancellation
between the particles' Gaussians that M F of a dense, nearly uniform
suspension rests on (PERF.md).  ``spread_col`` is the plain version,
``spread_moments_kernel`` runs ``csrc/spread.cu`` for the moments on CUDA
tensors and ``spread_col_kernel`` folds them.  Reference semantics: gpu_stokes_Spread_kernel /
gpu_stokes_Contract_kernel (Mobility.cu:114-252, 325-477).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels, trace
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
    """Per-step Gaussian factors of the contract (cap minor), in the weight
    dtype."""

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
    wxy, wz = _factors_f32(_node_fractions_xy(bins, box, params), bins.mask,
                           box.tilt_xy, spec, params)
    dtype = _weight_dtype(spec)
    return ColFactors(wxy=wxy.to(dtype), wz=wz.to(dtype))


def _node_delta(node, pf, N):
    """(node - pf) / N wrapped to the nearest image, with each slot's
    offset from its nearest node taken first (``pf - k`` and the integer
    ``node - k`` are exact), so the one rounding is of a small number: the
    spread's factors, where the window's near nodes decide M F."""
    k = torch.round(pf)
    o = node - k
    o = o - N * torch.round(o / N)
    return (o - (pf - k)) / N


def _factors_f32(nodes, mask, tilt, spec: ColFfSpec, params: PSEParams,
                 centred: bool = False):
    """float32 (wxy (C, 9 sx sy, cap), wz (C, Nz, cap)) of the slots at
    node-space coordinates ``nodes`` = (x, y, z), each (C, cap), with the
    slot ``mask`` folded into wz.  The contract's factors take the JAX
    package's node / N - pf / N, which rounds two numbers near 1 (an
    error of ~L 2^-24 in each separation); ``centred`` takes
    ``_node_delta`` instead (the spread's)."""
    sx, sy = spec.s
    ncx, ncy, _ = spec.bins.n_cells
    C = ncx * ncy
    cap = spec.bins.cap
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    L = params.L
    expfac = params.spread_expfac
    pfx, pfy, pfz = nodes
    dev = pfx.device

    bx, by = np.meshgrid(np.arange(ncx), np.arange(ncy), indexing="ij")
    bx = torch.as_tensor(bx.reshape(-1), dtype=torch.int32, device=dev)
    by = torch.as_tensor(by.reshape(-1), dtype=torch.int32, device=dev)

    def frac_delta(node, pf, N):                       # (C, nodes, cap)
        node = node.to(pf.dtype)[:, :, None]
        if centred:
            return _node_delta(node, pf[:, None, :], N)
        fd = node / N - (pf / N)[:, None, :]
        return fd - torch.round(fd)

    def window_nodes(b, s):
        return (b[:, None] - 1) * s + torch.arange(3 * s, dtype=torch.int32,
                                                   device=dev)

    fdx = frac_delta(window_nodes(bx, sx), pfx, Nx)
    fdy = frac_delta(window_nodes(by, sy), pfy, Ny)
    fdz = frac_delta(torch.arange(Nz, device=dev)[None].expand(C, Nz), pfz,
                     Nz)

    dyu = L[1] * fdy
    dz = L[2] * fdz
    dxo = (L[0] * fdx).reshape(C, 3, sx, cap)
    dyo = dyu.reshape(C, 3, sy, cap)
    dx = dxo[:, :, None, :, None, :] + tilt * dyo[:, None, :, None]
    wxy = torch.exp(-expfac * (dx * dx + (dyo * dyo)[:, None, :, None]))
    wz = torch.exp(-expfac * dz * dz) * mask[:, None, :]
    return wxy.reshape(C, 9 * sx * sy, cap), wz


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
    trace.count("launch.contract_col_kernel")
    kernels.check("contract_col_kernel", rc)
    return u



def _windows_to_grid(out: torch.Tensor, spec: ColFfSpec, params: PSEParams):
    """(C, 9 sx sy, 3 Nz) window moments -> (3, Nx, Ny, Nz) overlap-add on x
    and y: offset o = (ox + 1) * 3 + (oy + 1) of column c lands on column
    c + (ox, oy) (the transpose of ``_grid_to_windows``)."""
    sx, sy = spec.s
    ncx, ncy, _ = spec.bins.n_cells
    out = out.reshape(ncx, ncy, 9, sx * sy, 3 * params.Nz)
    acc = None
    for o in range(9):
        t = torch.roll(out[:, :, o], (o // 3 - 1, o % 3 - 1), dims=(0, 1))
        acc = t if acc is None else acc + t
    acc = acc.reshape(ncx, ncy, sx, sy, 3, params.Nz)
    grid = acc.permute(4, 0, 2, 1, 3, 5)         # (3, ncx, sx, ncy, sy, Nz)
    return grid.reshape(3, params.Nx, params.Ny, params.Nz)


def spread_nodes(bins: CellBins, box: Box, params: PSEParams):
    """(4, C, cap) float32: the slots' node-space x, y, z and mask, the
    operand the spread computes its factors from."""
    return torch.stack([*_node_fractions_xy(bins, box, params),
                        bins.mask.to(torch.float32)])


def spread_moments(f_cells: torch.Tensor, spec: ColFfSpec, params: PSEParams,
                   nodes: torch.Tensor, tilt: float) -> torch.Tensor:
    """Plain version of the spread kernel: (C, 9 sx sy, 3 Nz) window moments
    out[c, n, (k, z)] = sum_p wxy[c, n, p] X[c, (k, z), p], with the float32
    factors of the slots at ``nodes`` (``spread_nodes``) in a box of xy
    tilt ``tilt`` and X = (prefac f) (x) wz, all in float32 whatever the
    spec's weight dtype."""
    C = spec.bins.n_cells_total
    cap = spec.bins.cap
    wxy, wz = _factors_f32(nodes[:3], nodes[3], tilt, spec, params,
                           centred=True)
    fp = f_cells.to(torch.float32) * np.float32(params.spread_prefac).item()
    X = (fp.permute(1, 0, 2)[:, :, None, :] * wz[:, None]
         ).reshape(C, 3 * params.Nz, cap)
    return torch.einsum("cnp,cmp->cnm", wxy, X)


def _z_reach(params: PSEParams) -> int:
    """The z nodes on each side of a slot's nearest node that the spread's
    float32 kernel sums: past R + 1/2 nodes a Gaussian factor is below
    2^-30 of its peak, under float32's resolution of the slot's largest
    terms."""
    hz = params.L[2] / params.Nz
    return max(0, math.ceil(math.sqrt(30.0 * math.log(2.0)
                                      / params.spread_expfac) / hz - 0.5))


def spread_col(f_cells: torch.Tensor, spec: ColFfSpec, params: PSEParams,
               nodes: torch.Tensor, tilt: float) -> torch.Tensor:
    """Plain version: the force-moment grid (3, Nx, Ny, Nz) of the slot
    forces ``f_cells`` (3, C, cap), whose padded slots are zero."""
    return _windows_to_grid(
        spread_moments(f_cells, spec, params, nodes, tilt), spec, params)


def spread_moments_kernel(f_cells: torch.Tensor, spec: ColFfSpec,
                          params: PSEParams, nodes: torch.Tensor,
                          tilt: float):
    """(C, 9 sx sy, 3 Nz) window moments: ``csrc/spread.cu`` on CUDA
    tensors, the plain ``spread_moments`` on CPU tensors.  The kernel
    computes the float32 factors of ``nodes`` itself, and each window
    node of a column sums, in slot order, the slots whose nearest z node
    lies within ``_z_reach`` nodes of its own; the terms left out are each
    below 2^-30 of their slot's largest."""
    if f_cells.device.type == "cpu":
        return spread_moments(f_cells, spec, params, nodes, tilt)
    sx, sy = spec.s
    ncx, ncy, _ = spec.bins.n_cells
    C, cap = ncx * ncy, spec.bins.cap
    f = f_cells.to(torch.float32).contiguous()
    nodes = nodes.to(torch.float32).contiguous()
    if f.shape != (3, C, cap) or nodes.shape != (4, C, cap):
        raise ValueError("spread_moments_kernel: operand shapes do not match "
                         "the spec")
    out = torch.empty((C, 9 * sx * sy, 3 * params.Nz), dtype=torch.float32,
                      device=f.device)
    L = params.L
    p = kernels.ptr
    rc = kernels.library().pse_spread_col(
        p(f), p(nodes), ncx, ncy, sx, sy, params.Nx, params.Ny, params.Nz,
        cap, float(np.float32(L[0])), float(np.float32(L[1])),
        float(np.float32(L[2])), float(np.float32(tilt)),
        float(np.float32(-params.spread_expfac)),
        float(np.float32(params.spread_prefac)), _z_reach(params), p(out),
        kernels.stream_of(f),
    )
    trace.count("launch.spread_moments_kernel")
    kernels.check("spread_moments_kernel", rc)
    return out


def spread_col_kernel(f_cells: torch.Tensor, spec: ColFfSpec,
                      params: PSEParams, nodes: torch.Tensor, tilt: float):
    """(3, Nx, Ny, Nz) force-moment grid: the moments from
    ``spread_moments_kernel``, then the plain overlap-add (as the JAX
    package's ``spread_col_pallas`` leaves the fold to XLA)."""
    return _windows_to_grid(
        spread_moments_kernel(f_cells, spec, params, nodes, tilt), spec,
        params)
