"""Derived parameters of one PSE configuration, and the static k-space arrays.

PyTorch counterpart of ``pse_tpu/params.py``; the derivations follow the
reference ``Stokes::setParams`` (Stokes.cc:129-424):

  * real-space cutoff        rcut = sqrt(-ln error) / xi
  * FFT grid dimensions      from kmax = int(2 sqrt(-ln error) xi) + 1,
                             rounded up to 2^a 3^b 5^c in [8, 4096]
  * spectral-Ewald Gaussian  (m, P, eta) with the shear safety factor
                             lambda(max_strain) = 1 + g^2/2 + g sqrt(1 + g^2/4)
  * the real-space self mobility.

The banded engine evaluates Chebyshev fits of the pair functions
(ops/chebyshev.py), so the interpolation table the JAX package also builds
for its gather engine is not made here.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch
from scipy.special import erfc

from . import tables

TWO_PI = 2.0 * math.pi


@lru_cache(maxsize=1)
def _grid_size_candidates():
    """All 2^a 3^b 5^c in [8, 4096], ascending (Stokes.cc:147-177)."""
    vals = set()
    p2 = 1
    for _ in range(13):
        p23 = p2
        for _ in range(8):
            p235 = p23
            for _ in range(6):
                if 8 <= p235 <= 4096:
                    vals.add(p235)
                p235 *= 5
            p23 *= 3
        p2 *= 2
    return tuple(sorted(vals))


def round_up_grid_size(n: int) -> int:
    for c in _grid_size_candidates():
        if n <= c:
            return c
    raise ValueError(
        f"Requested grid dimension {n} exceeds the maximum supported size 4096; "
        "reduce xi and try again."
    )


@dataclasses.dataclass(frozen=True)
class PSEParams:
    """Static, host-computed parameters of one PSE configuration."""

    # user inputs
    xi: float
    error: float
    L: tuple  # (Lx, Ly, Lz)
    max_strain: float
    radius: float = 1.0

    # derived: real space
    ewald_cut: float = 0.0
    ewald_dr: float = 1e-3
    ewald_n: int = 0
    self_mobility: float = 0.0

    # derived: wave space
    Nx: int = 0
    Ny: int = 0
    Nz: int = 0
    gridh: tuple = (0.0, 0.0, 0.0)
    gauss_m: float = 0.0
    gauss_P: int = 0
    eta: float = 0.0

    @property
    def n_grid_total(self) -> int:
        return self.Nx * self.Ny * self.Nz

    @property
    def quadW(self) -> float:
        return self.gridh[0] * self.gridh[1] * self.gridh[2]

    @property
    def spread_prefac(self) -> float:
        """(2 xi^2 / (pi eta))^{3/2} (Mobility.cu:548)."""
        x = 2.0 * self.xi * self.xi / math.pi / self.eta
        return x * math.sqrt(x)

    @property
    def spread_expfac(self) -> float:
        """2 xi^2 / eta (Mobility.cu:549)."""
        return 2.0 * self.xi * self.xi / self.eta

    def summary(self) -> str:
        """Derived-parameter block mirroring the reference's one-time notice
        (Stokes.cc:238-254)."""
        L = self.L
        lines = [
            "--- NUFFT Hydrodynamics Statistics ---",
            f"Mx: {self.Nx}",
            f"My: {self.Ny}",
            f"Mz: {self.Nz}",
            f"rcut: {self.ewald_cut}",
            f"Points per radius (x,y,z): {self.Nx / L[0]}, {self.Ny / L[1]}, {self.Nz / L[2]}",
            "--- Gaussian Spreading Parameters ---",
            f"gauss_m: {self.gauss_m}",
            f"gauss_P: {self.gauss_P}",
            f"gauss_eta: {self.eta}",
            f"gauss_w: {self.gauss_P * self.gridh[0] / 2.0}",
            f"gauss_gridh (x,y,z): {L[0] / self.Nx}, {L[1] / self.Ny}, {L[2] / self.Nz}",
        ]
        return "\n".join(lines)


def make_params(
    xi: float,
    error: float,
    L,
    max_strain: float = 0.5,
    radius: float = 1.0,
    max_grid_total: int = 512 ** 3 * 8,
) -> PSEParams:
    """Compute all derived PSE parameters (mirrors Stokes.cc:129-424)."""
    if np.isscalar(L):
        L = (float(L),) * 3
    L = tuple(float(x) for x in L)
    xi = float(xi)
    error = float(error)

    ewald_cut = math.sqrt(-math.log(error)) / xi

    kmax = int(2.0 * math.sqrt(-math.log(error)) * xi) + 1
    Nx, Ny, Nz = (
        round_up_grid_size(int(kmax * L[ax] / TWO_PI * 2.0) + 1)
        for ax in range(3)
    )
    if Nx * Ny * Nz > max_grid_total:
        raise ValueError(
            f"Requested number of Fourier nodes {Nx}x{Ny}x{Nz} exceeds "
            f"max_grid_total={max_grid_total}. Reduce xi and try again."
        )

    gamma = float(max_strain)
    lam = 1.0 + gamma * gamma / 2.0 + gamma * math.sqrt(1.0 + gamma * gamma / 4.0)
    gridh = (L[0] / Nx, L[1] / Ny, L[2] / Nz)

    # Spectral-Ewald Gaussian parameters (Lindbo & Tornberg; Stokes.cc:224-236)
    gauss_m = 1.0
    while erfc(gauss_m / math.sqrt(2.0 * lam)) > error:
        gauss_m += 0.01
    gauss_P = int(gauss_m * gauss_m / math.pi) + 1
    gauss_P = min(gauss_P, Nx, Ny, Nz)
    w = gauss_P * gridh[0] / 2.0
    eta = (2.0 * w / gauss_m) ** 2 * (xi * xi)

    ewald_dr = 1e-3
    return PSEParams(
        xi=xi,
        error=error,
        L=L,
        max_strain=float(max_strain),
        radius=float(radius),
        ewald_cut=ewald_cut,
        ewald_dr=ewald_dr,
        ewald_n=int(ewald_cut / ewald_dr - 1),
        self_mobility=tables.self_mobility(xi, radius),
        Nx=Nx,
        Ny=Ny,
        Nz=Nz,
        gridh=gridh,
        gauss_m=gauss_m,
        gauss_P=gauss_P,
        eta=eta,
    )


@lru_cache(maxsize=8)
def hermitian_noise_maps(Nx: int, Ny: int, Nz: int):
    """Conjugate-index permutation and node-class masks, (Nx, Ny, Nz) numpy.

    ``conj_idx``: flat index of the Hermitian partner ((-i, -j, -k) mod N);
    ``is_generator``: nodes carrying an independent draw (one per conjugate
    pair, the smaller flat index; the origin excluded); ``is_self_conj``:
    nodes equal to their own conjugate (Nyquist combinations), which carry a
    real-only draw scaled by sqrt(2).  Picking one generator per pair is the
    JAX package's documented fix of the reference's racy Nyquist planes
    (Brownian.cu:205-261)."""
    ii = np.arange(Nx)[:, None, None]
    jj = np.arange(Ny)[None, :, None]
    kk = np.arange(Nz)[None, None, :]

    ii_c = (-ii) % Nx
    jj_c = (-jj) % Ny
    kk_c = (-kk) % Nz
    conj_idx = (ii_c * Ny * Nz + jj_c * Nz + kk_c).astype(np.int32)
    conj_idx = np.broadcast_to(conj_idx, (Nx, Ny, Nz)).copy()

    origin = (ii == 0) & (jj == 0) & (kk == 0)
    is_self_conj = (ii == ii_c) & (jj == jj_c) & (kk == kk_c) & ~origin
    is_self_conj = np.broadcast_to(is_self_conj, (Nx, Ny, Nz)).copy()

    flat_idx = (ii * Ny * Nz + jj * Nz + kk).astype(np.int64)
    flat_idx = np.broadcast_to(flat_idx, (Nx, Ny, Nz))
    gen = ((flat_idx < conj_idx) | is_self_conj) & ~origin

    origin = np.broadcast_to(origin, (Nx, Ny, Nz)).copy()
    return conj_idx, gen, is_self_conj, origin


def gridk_arrays(params: PSEParams, tilt_xy: float, device, half: bool = False):
    """Sheared reciprocal-lattice vectors and the Green's-function scale.

    Returns (kvec (Nx, Ny, Nz', 3), W (Nx, Ny, Nz')) in float32 with
    W(k) = 6 pi (1 + k^2/4xi^2) exp(-(1 - eta) k^2/4xi^2) / k^2, W(0) = 0;
    the FFT normalization is not folded in (torch.fft's inverse is
    normalized).  ``half=True`` covers the rfft half spectrum kz in
    [0, Nz/2].  Same float32 operation order as the JAX package.
    """
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    L = params.L
    xisq = params.xi * params.xi
    f32 = torch.float32

    def _wrapped(N):
        i = torch.arange(N, device=device)
        return torch.where(i < (N + 1) // 2, i, i - N).to(f32)

    wi = _wrapped(Nx)[:, None, None]
    wj = _wrapped(Ny)[None, :, None]
    if half:
        Nz = Nz // 2 + 1
        wk = torch.arange(Nz, device=device, dtype=f32)[None, None, :]
    else:
        wk = _wrapped(Nz)[None, None, :]

    tilt = float(np.float32(tilt_xy))
    kx = TWO_PI * wi / L[0]
    ky = TWO_PI * (wj - tilt * wi * (L[1] / L[0])) / L[1]
    kz = TWO_PI * wk / L[2]

    kx = kx.expand(Nx, Ny, Nz)
    ky = ky.expand(Nx, Ny, Nz)
    kz = kz.expand(Nx, Ny, Nz)
    k2 = kx * kx + ky * ky + kz * kz

    k2_safe = torch.where(k2 > 0, k2, torch.ones((), dtype=f32, device=device))
    W = (
        6.0
        * math.pi
        * (1.0 + k2 / (4.0 * xisq))
        * torch.exp(-(1.0 - params.eta) * k2 / (4.0 * xisq))
        / k2_safe
    )
    W = torch.where(k2 > 0, W, torch.zeros((), dtype=f32, device=device))
    kvec = torch.stack([kx, ky, kz], dim=-1)
    return kvec, W
