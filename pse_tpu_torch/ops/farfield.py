"""Wave-space (far-field) mobility on the FFT grid: the gather engine's tap
spread and contract, and the Green's function every engine applies.

PyTorch counterpart of ``pse_tpu/ops/farfield.py``, the NUFFT pipeline of
Mobility.cu:114-575:

  spread (Gaussian taps)  ->  FFT x3  ->  Green / transverse scale
  [-> + Hermitian noise]  ->  IFFT x3 ->  contract (Gaussian gather)

Each particle has P^3 taps, generated by index arithmetic with a partly
separable weight product (P^2 + P exponentials instead of P^3).  The taps
are fixed for a step and shared by spread and contract.  The contract is a
gather.  The spread sums, on every grid node, the taps that land there:
``compute_taps`` sorts the taps by node once (a stable sort) and lays each
node's run out as a row of a padded (n_grid, K) table, so the spread is a
gather and a sum over each row in a fixed order, with no float atomics and
bitwise equal reruns on one device (the JAX package scatter-adds).  The
tilted box enters through the fractional tap geometry as in
Mobility.cu:230-237: dr = f_x a1 + f_y a2 + f_z a3 with a1 = (Lx, 0, 0),
a2 = (xy Ly, Ly, 0), a3 = (0, 0, Lz), per-axis round-reduced fractional
deltas.  torch.fft's normalized inverse means the Green scale carries no
1/(Nx Ny Nz) factor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..box import Box, make_fraction
from ..params import PSEParams


class SpreadTaps(NamedTuple):
    """The Gaussian taps of every particle, shared by spread and contract,
    (P^3, N) with the particle index minor, and the taps of every grid node
    in the fixed order the spread sums them."""

    flat_idx: torch.Tensor    # (P^3, N) int64 flat grid node of each tap
    weights: torch.Tensor     # (P^3, N) f32 exp(-expfac |dr|^2)
    node_taps: torch.Tensor   # (n_grid, K) int64 flat tap ids (k N + i) of
                              # each node in ascending order, padded with
                              # P^3 N (a zero); K = the most taps on a node


def compute_taps(pos: torch.Tensor, box: Box, params: PSEParams) -> SpreadTaps:
    """Tap geometry of all particles (Mobility.cu:180-246 index arithmetic)
    and each node's taps.  Reads the largest node count to the host, once
    per step, to size the table."""
    P = params.gauss_P
    dims = (params.Nx, params.Ny, params.Nz)
    Nx, Ny, Nz = dims
    L = params.L
    n = pos.shape[0]
    dev = pos.device
    expfac = float(np.float32(params.spread_expfac))

    frac = make_fraction(box, pos)             # (N, 3) in [0, 1)
    frac = frac - torch.floor(frac)
    offs = torch.arange(P, dtype=torch.int32, device=dev)

    wrapped, fdelta = [], []
    for ax in range(3):
        pf = frac[:, ax] * dims[ax]
        base = torch.floor(pf).to(torch.int32)
        # center the support on the particle (Mobility.cu:212-214)
        shift = (P % 2) * ((pf - base.to(pf.dtype)) < 0.5).to(torch.int32)
        node = base[None, :] + offs[:, None] - (P // 2) + 1 - shift[None, :]
        wrapped.append(torch.remainder(node, dims[ax]))          # (P, N)
        # fractional delta, round-reduced to (-1/2, 1/2] (minimum image)
        fd = (node.to(pf.dtype) - pf[None, :]) / dims[ax]
        fdelta.append(fd - torch.round(fd))                      # (P, N)

    # physical displacements through the (tilted) lattice vectors
    dy = L[1] * fdelta[1]                                        # (P, N)
    dz = L[2] * fdelta[2]
    dx = (L[0] * fdelta[0])[:, None, :] + box.tilt_xy * dy[None, :, :]
    w_xy = torch.exp(-expfac * (dx * dx + (dy * dy)[None, :, :]))
    w_z = torch.exp(-expfac * dz * dz)                           # (Pz, N)
    weights = (w_xy[:, :, None, :] * w_z[None, None, :, :]).reshape(P ** 3, n)

    flat = ((wrapped[0].long()[:, None, None, :] * Ny
             + wrapped[1].long()[None, :, None, :]) * Nz
            + wrapped[2].long()[None, None, :, :]).reshape(P ** 3, n)
    return SpreadTaps(flat, weights, _node_taps(flat.reshape(-1),
                                                params.n_grid_total))


def _node_taps(flat: torch.Tensor, n_grid: int) -> torch.Tensor:
    """(n_grid, K) table of the tap ids on each node, ascending, padded
    with len(flat): a stable sort by node, each run's rank = position -
    the run's start.  This is the cell binning's job, but not through the
    fill kernel: taps have no coordinates for its position planes, its
    capacity must be known before the launch (K is this data's largest
    run), and its overflow search walks every cell in one block, which
    the ~10^6 grid nodes would make a serial tail."""
    n_taps = flat.shape[0]
    dev = flat.device
    nodes, perm = torch.sort(flat, stable=True)
    starts = torch.searchsorted(nodes, torch.arange(n_grid, device=dev))
    counts = torch.diff(starts, append=starts.new_full((1,), n_taps))
    trace.count("read.tap_width")
    with trace.span("sync.tap_width"):
        width = max(1, int(counts.max()))
    rank = torch.arange(n_taps, device=dev) - starts[nodes]
    table = torch.full((n_grid, width), n_taps, dtype=torch.int64, device=dev)
    table[nodes, rank] = perm
    return table


def spread(taps: SpreadTaps, forces: torch.Tensor,
           params: PSEParams) -> torch.Tensor:
    """Forces (N, 3) onto the grid (gpu_stokes_Spread_kernel analogue):
    the real (3, Nx, Ny, Nz) force-moment grid, each node one sum over its
    row of ``taps.node_taps`` (a fixed order: no atomics)."""
    prefac = float(np.float32(params.spread_prefac))
    w = prefac * taps.weights                                    # (P^3, N)
    vals = (forces.t()[:, None, :] * w[None]).reshape(3, -1)
    vals = torch.cat([vals, vals.new_zeros((3, 1))], dim=1)
    grid = vals[:, taps.node_taps].sum(dim=2)
    return grid.reshape(3, params.Nx, params.Ny, params.Nz)


def contract(taps: SpreadTaps, grid_real: torch.Tensor,
             params: PSEParams) -> torch.Tensor:
    """Grid velocities (3, Nx, Ny, Nz) back to the particles, (N, 3)
    (gpu_stokes_Contract_kernel analogue)."""
    flatg = grid_real.reshape(3, params.n_grid_total)
    scale = params.quadW * params.spread_prefac
    comps = [scale * torch.sum(flatg[c][taps.flat_idx] * taps.weights, dim=0)
             for c in range(3)]
    return torch.stack(comps, dim=1)


def apply_green(ghat: torch.Tensor, kvec: torch.Tensor,
                W: torch.Tensor) -> torch.Tensor:
    """Transverse-project and scale the FFT'd force grid
    (gpu_stokes_Green_kernel, Mobility.cu:264-299).

    ghat: (3, Nx, Ny, Nzh) complex; kvec (Nx, Ny, Nzh, 3) and W (Nx, Ny,
    Nzh) from ``params.gridk_arrays``.  B(k) = W(k) (sin k / k)^2 with the
    a = 1 finite-size factor; the k = 0 term is excluded (W(0) = 0)."""
    real = ghat.real.dtype
    k2 = torch.sum(kvec * kvec, dim=-1)
    k2_safe = torch.where(k2 > 0, k2, torch.ones_like(k2))
    k = torch.sqrt(k2_safe)
    sinc = torch.sin(k) / k
    B = (W * sinc * sinc).to(real)
    kv = torch.movedim(kvec, -1, 0).to(real)              # (3, Nx, Ny, Nzh)
    kdF = torch.sum(kv * ghat, dim=0) / k2_safe
    return (ghat - kv * kdF[None]) * B[None]


def wave_space_velocity(pos, forces, box: Box, params: PSEParams, kvec, W,
                        noise_hat=None, taps: SpreadTaps | None = None):
    """U_wave = M_wave F [+ sqrt(M_wave) noise] over the full spectrum
    (gpu_stokes_Mwave_wrap, Mobility.cu:515-575): the noise, when given,
    is added after the Green scale so the inverse FFTs and the contract are
    shared (Brownian.cu:849-872).  ``kvec``, ``W``: the full-spectrum
    arrays of ``params.gridk_arrays(half=False)``."""
    if taps is None:
        taps = compute_taps(pos, box, params)
    grid = spread(taps, forces, params)
    ghat = torch.fft.fftn(grid.to(torch.complex64), dim=(1, 2, 3))
    ghat = apply_green(ghat, kvec, W)
    if noise_hat is not None:
        ghat = ghat + noise_hat
    grid_v = torch.fft.ifftn(ghat, dim=(1, 2, 3)).real.to(forces.dtype)
    return contract(taps, grid_v, params)
