"""Plain float64 reference of one PSE Brownian-dynamics step, in PyTorch.

It imports nothing of the program.  From the inputs alone (positions, the
step's raw draws, forces, the configuration's xi, error, kT, dt and box) it
works out again what the program's set-up derives (the real-space cutoff,
the FFT grid, the self mobility) and computes the displacement of one
Euler-Maruyama step of the positively split Ewald (PSE) method of Fiore,
Balboa Usabiaga, Donev and Swan, J. Chem. Phys. 146, 124116 (2017):

    dx = dt [M F + sqrt(2 kT / dt) (M_wave^{1/2} xi_k + M_real^{1/2} psi)]

without the program's approximations other than the split's own cutoffs:

* real space: every pair within rcut from a plain cell list, the exact
  pair functions (a frozen copy of ``pair_functions`` below), and the
  square root by a float64 Lanczos iteration with full
  reorthogonalisation, converged far below the program's tolerance;
* wave space: the sums over the program's FFT modes done exactly, as
  non-uniform discrete Fourier transforms (no Gaussian gridding), with the
  complete Gaussian screen exp(-k^2 / 4 xi^2).

The box is cubic-or-orthorhombic and untilted (the benchmark's cells shear
nothing).  ``lower`` is the control: the same arithmetic with the
near-field pair coefficients and the wave-space coefficients rounded to
the precisions one step below those the configuration states
(``control_precision``: bfloat16 pair data -> float8 e4m3 with one scale
per coefficient array, float32 wave space -> bfloat16).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

F64 = torch.float64
C128 = torch.complex128


# -- parameters -------------------------------------------------------------

def _grid_size(n: int) -> int:
    """The least 2^a 3^b 5^c in [8, 4096] that is at least n."""
    best = None
    for a in range(13):
        for b in range(8):
            for c in range(6):
                v = 2 ** a * 3 ** b * 5 ** c
                if 8 <= v <= 4096 and v >= n and (best is None or v < best):
                    best = v
    if best is None:
        raise ValueError(f"grid dimension {n} above 4096")
    return best


class Params(NamedTuple):
    xi: float
    error: float
    L: tuple
    rcut: float
    grid: tuple          # (Nx, Ny, Nz)
    self_mobility: float


def derive(xi: float, error: float, L, radius: float = 1.0) -> Params:
    """The PSE split's derived sizes (Fiore et al. 2017, Sec. III):
    rcut = sqrt(-ln error) / xi; the grid resolves kmax = 2 sqrt(-ln
    error) xi (+1), two nodes per wavelength, rounded up to 2^a 3^b 5^c."""
    if radius != 1.0:
        raise ValueError("the reference is written for radius 1")
    L = tuple(float(x) for x in L)
    rcut = math.sqrt(-math.log(error)) / xi
    kmax = int(2.0 * math.sqrt(-math.log(error)) * xi) + 1
    grid = tuple(_grid_size(int(kmax * Li / (2.0 * math.pi) * 2.0) + 1)
                 for Li in L)
    axi = xi
    self_mob = ((1.0 + 4.0 * math.sqrt(math.pi) * axi * math.erfc(2.0 * axi)
                 - math.exp(-4.0 * axi * axi))
                / (4.0 * math.sqrt(math.pi) * axi))
    return Params(xi, error, L, rcut, grid, self_mob)


# -- real space -------------------------------------------------------------

def pair_functions(r: torch.Tensor, xi: float, a: float = 1.0):
    """(UF1, UF2) of the real-space Ewald-split RPY pair mobility at
    distances r (float64), in units where 6 pi eta a = a: the velocity of i
    from a force F on j is UF1 F + (UF2 - UF1) (rhat . F) rhat.  Branches
    r > 2a, r == 2a and r < 2a, as in Fiore et al. (2017), Appendix;
    frozen copy of the formulas (they cancel catastrophically in float32)."""
    erfc, exp = torch.special.erfc, torch.exp
    spi = 1.0 / math.sqrt(math.pi)
    xi2, xim4, xim3 = xi * xi, xi ** -4.0, xi ** -3.0
    rm1 = 1.0 / r
    rm2, r2 = rm1 * rm1, r * r
    rm3, r3, r4 = rm2 * rm1, r2 * r, r2 * r2
    am1 = 1.0 / a
    am2, a2 = am1 * am1, a * a
    a3 = a2 * a
    erfc_r = erfc(r * xi)
    erfc_2apr = erfc((2.0 * a + r) * xi)
    erfc_2amr = erfc((2.0 * a - r) * xi)
    erfc_rm2a = erfc((r - 2.0 * a) * xi)
    exp_r = exp(-r2 * xi2)
    exp_2apr = exp(-((2.0 * a + r) ** 2) * xi2)
    exp_rm2a = exp(-((r - 2.0 * a) ** 2) * xi2)
    g_p = (8.0 * r * a2 * xi2 - 16.0 * a3 * xi2 + a * (2.0 - 28.0 * r2 * xi2)
           - 3.0 * (r + 6.0 * r3 * xi2))
    g_m = (8.0 * r * a2 * xi2 + 16.0 * a3 * xi2 + a * (-2.0 + 28.0 * r2 * xi2)
           - 3.0 * (r + 6.0 * r3 * xi2))
    h_m = -1.0 - 8.0 * a * r * xi2 + 8.0 * a2 * xi2 + 2.0 * r2 * xi2
    h_p = -1.0 + 8.0 * a * r * xi2 + 8.0 * a2 * xi2 + 2.0 * r2 * xi2
    s1 = 128.0 * am1 + 64.0 * a2 * rm3 + 96.0 * rm1 + am2 * (36.0 * r - 3.0 * rm3 * xim4)
    s2 = 64.0 * am1 - 64.0 * a2 * rm3 + 96.0 * rm1 + am2 * (12.0 * r + 3.0 * rm3 * xim4)
    common1 = ((3.0 * erfc_r * am2 * rm3 * (-12.0 * r4 + xim4)) / 128.0
               + (erfc_2apr * s1) / 256.0
               + (3.0 * exp_r * am2 * spi * rm2 * xim3 * (1.0 + 6.0 * r2 * xi2)) / 64.0
               + (exp_2apr * am2 * spi * rm3 * xim3 * g_p) / 128.0
               + (exp_rm2a * am2 * spi * rm3 * xim3 * g_m) / 128.0)
    common2 = ((erfc_2apr * s2) / 128.0
               + (3.0 * exp_r * am2 * spi * rm2 * xim3 * (-1.0 + 2.0 * r2 * xi2)) / 32.0
               - ((2.0 * a + 3.0 * r) * exp_rm2a * am2 * spi * rm3 * xim3 * h_m) / 64.0
               + ((2.0 * a - 3.0 * r) * exp_2apr * am2 * spi * rm3 * xim3 * h_p) / 64.0
               - (3.0 * erfc_r * am2 * rm3 * xim4 * (1.0 + 4.0 * r4 * xi ** 4)) / 64.0)
    imrr_far = (-am1 + (a2 * rm3) / 2.0 + (3.0 * rm1) / 4.0
                + am2 * ((9.0 * r) / 32.0 - (3.0 * rm3 * xim4) / 128.0)
                + (erfc_2amr * (128.0 * am1 - 64.0 * a2 * rm3 - 96.0 * rm1
                                + am2 * (-36.0 * r + 3.0 * rm3 * xim4))) / 256.0
                + common1)
    rr_far = (-am1 - a2 * rm3 + (3.0 * rm1) / 2.0
              + (3.0 * am2 * rm3 * (4.0 * r4 + xim4)) / 64.0
              + (erfc_2amr * (64.0 * am1 + 64.0 * a2 * rm3 - 96.0 * rm1
                              + am2 * (-12.0 * r - 3.0 * rm3 * xim4))) / 128.0
              + common2)
    imrr_near = ((-9.0 * r * am2) / 32.0 + am1 - (a2 * rm3) / 2.0
                 - (3.0 * rm1) / 4.0
                 + (erfc_rm2a * (-128.0 * am1 + 64.0 * a2 * rm3 + 96.0 * rm1
                                 + am2 * (36.0 * r - 3.0 * rm3 * xim4))) / 256.0
                 + common1)
    rr_near = (((2.0 * a + 3.0 * r) * am2 * (2.0 * a - r) ** 3 * rm3) / 16.0
               + (erfc_rm2a * (-64.0 * am1 - 64.0 * a2 * rm3 + 96.0 * rm1
                               + am2 * (12.0 * r + 3.0 * rm3 * xim4))) / 128.0
               + common2)
    # r == 2a exactly (touching): the limits of both branches
    am4 = am2 * am2
    am5, a4 = am4 * am1, a2 * a2
    e2, e4 = math.erfc(2.0 * a * xi), math.erfc(4.0 * a * xi)
    x16, x4 = math.exp(-16.0 * a2 * xi2), math.exp(-4.0 * a2 * xi2)
    imrr_touch = (-(am5 * (3.0 + 16.0 * a * xi * spi) * xim4) / 2048.0
                  + (3.0 * e2 * am5 * (-192.0 * a4 + xim4)) / 1024.0
                  + e4 * (am1 - (3.0 * am5 * xim4) / 2048.0)
                  + (x16 * am4 * spi * xim3 * (-1.0 - 64.0 * a2 * xi2)) / 256.0
                  + (3.0 * x4 * am4 * spi * xim3 * (1.0 + 24.0 * a2 * xi2)) / 256.0)
    rr_touch = ((am5 * (3.0 + 16.0 * a * xi * spi) * xim4) / 1024.0
                + e2 * ((-3.0 * am1) / 8.0 - (3.0 * am5 * xim4) / 512.0)
                + e4 * (am1 + (3.0 * am5 * xim4) / 1024.0)
                + (x16 * am4 * spi * xim3 * (1.0 - 32.0 * a2 * xi2)) / 128.0
                + (3.0 * x4 * am4 * spi * xim3 * (-1.0 + 8.0 * a2 * xi2)) / 128.0)
    far, touch = r > 2.0 * a, r == 2.0 * a
    uf1 = torch.where(far, imrr_far, torch.where(touch, imrr_touch, imrr_near))
    uf2 = torch.where(far, rr_far, torch.where(touch, rr_touch, rr_near))
    return uf1, uf2


# the nearest precision below each one a configuration may state
BELOW = {"float64": "float32", "float32": "bfloat16",
         "float16": "float8_e4m3fn", "bfloat16": "float8_e4m3fn"}


def control_precision(stated: dict) -> dict:
    """The control's precisions: one step below each part's stated one
    (``{"near_field_pairs": ..., "wave_space": ...}``)."""
    return {part: BELOW[dtype] for part, dtype in stated.items()}


def rounded(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """Real or complex float64 ``x`` through ``dtype`` and back; a float8
    type with one scale (max |x| -> the type's largest)."""
    if x.is_complex():
        return torch.complex(rounded(x.real, dtype), rounded(x.imag, dtype))
    t = getattr(torch, dtype)
    if dtype.startswith("float8"):
        scale = x.abs().max().clamp_min(1e-300) / torch.finfo(t).max
        return (x / scale).to(t).to(F64) * scale
    return x.to(t).to(F64)


def _half_stencil():
    offs = [(0, 0, 0)]
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                if (ox, oy, oz) > (0, 0, 0):
                    offs.append((ox, oy, oz))
    return offs


class NearField:
    """M_real of the positions as a pair list: self_mobility I plus, for
    every pair closer than rcut, UF1 I + (UF2 - UF1) rhat rhat."""

    def __init__(self, pos: torch.Tensor, p: Params, lower: str | None = None,
                 cell_chunk: int = 4096):
        pos = pos.to(F64)
        self.n = pos.shape[0]
        self.self_mobility = p.self_mobility
        dev = pos.device
        L = torch.tensor(p.L, dtype=F64, device=dev)
        nc = [max(3, int(math.floor(Li / p.rcut))) for Li in p.L]
        ncx, ncy, ncz = nc
        frac = torch.remainder(pos / L + 0.5, 1.0)
        cxyz = torch.minimum(
            (frac * torch.tensor(nc, dtype=F64, device=dev)).long(),
            torch.tensor([c - 1 for c in nc], device=dev))
        cid = (cxyz[:, 0] * ncy + cxyz[:, 1]) * ncz + cxyz[:, 2]
        C = ncx * ncy * ncz
        counts = torch.bincount(cid, minlength=C)
        cap = int(counts.max())
        order = torch.argsort(cid, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        scid = cid[order]
        rank = torch.arange(self.n, device=dev) - starts[scid]
        table = torch.full((C, cap), -1, dtype=torch.long, device=dev)
        table[scid, rank] = order
        cells = torch.arange(C, device=dev)
        cx, cy, cz = cells // (ncy * ncz), (cells // ncz) % ncy, cells % ncz
        rc2 = p.rcut * p.rcut
        ii, jj = [], []
        for ox, oy, oz in _half_stencil():
            nb = ((((cx + ox) % ncx) * ncy + (cy + oy) % ncy) * ncz
                  + (cz + oz) % ncz)
            for c0 in range(0, C, cell_chunk):
                I = table[c0:c0 + cell_chunk][:, :, None]
                J = table[nb[c0:c0 + cell_chunk]][:, None, :]
                ok = (I >= 0) & (J >= 0)
                if (ox, oy, oz) == (0, 0, 0):
                    ok = ok & (I < J)
                I, J = torch.broadcast_tensors(I, J)
                I, J = I[ok], J[ok]
                d = pos[I] - pos[J]
                d = d - L * torch.round(d / L)
                near = (d * d).sum(1) < rc2
                ii.append(I[near])
                jj.append(J[near])
        self.i = torch.cat(ii)
        self.j = torch.cat(jj)
        d = pos[self.i] - pos[self.j]
        d = d - L * torch.round(d / L)
        r = torch.sqrt((d * d).sum(1))
        self.rhat = d / r[:, None]
        uf1, uf2 = pair_functions(r, p.xi)
        self.c1, self.c2 = uf1, uf2 - uf1
        if lower:
            self.c1, self.c2 = rounded(self.c1, lower), rounded(self.c2, lower)

    @property
    def n_pairs(self) -> int:
        return int(self.i.shape[0])

    def matvec(self, v: torch.Tensor, chunk: int = 1 << 23) -> torch.Tensor:
        """M_real v for v (N, 3) float64."""
        u = self.self_mobility * v
        for s in range(0, self.n_pairs, chunk):
            i, j = self.i[s:s + chunk], self.j[s:s + chunk]
            rh, c1, c2 = (self.rhat[s:s + chunk], self.c1[s:s + chunk],
                          self.c2[s:s + chunk])
            vj, vi = v[j], v[i]
            u.index_add_(0, i, c1[:, None] * vj
                         + (c2 * (rh * vj).sum(1))[:, None] * rh)
            u.index_add_(0, j, c1[:, None] * vi
                         + (c2 * (rh * vi).sum(1))[:, None] * rh)
        return u


def lanczos_sqrt(matvec, b: torch.Tensor, tol: float = 1e-11,
                 m_max: int = 200) -> torch.Tensor:
    """A^{1/2} b for a symmetric positive A given by ``matvec``: Lanczos
    with full reorthogonalisation, stopped when the estimate changes by
    less than ``tol`` (relative) between iterations."""
    nb = torch.linalg.vector_norm(b)
    V = [b / nb]
    alpha, beta = [], []
    prev = None
    w = None
    for m in range(1, m_max + 1):
        w = matvec(V[-1])
        a = float((w * V[-1]).sum())
        alpha.append(a)
        w = w - a * V[-1] - (beta[-1] * V[-2] if beta else 0.0)
        for q in V:                             # full reorthogonalisation
            w = w - float((w * q).sum()) * q
        Tm = (torch.diag(torch.tensor(alpha, dtype=F64))
              + torch.diag(torch.tensor(beta, dtype=F64), 1)
              + torch.diag(torch.tensor(beta, dtype=F64), -1))
        lam, Q = torch.linalg.eigh(Tm)
        f = Q @ (torch.sqrt(lam.clamp_min(0.0)) * Q[0])
        if prev is not None:
            pad = torch.zeros(m, dtype=F64)
            pad[:m - 1] = prev
            if float(torch.linalg.vector_norm(f - pad)) <= tol * float(
                    torch.linalg.vector_norm(f)):
                break
        prev = f
        bn = float(torch.linalg.vector_norm(w))
        if bn < 1e-14:
            break
        beta.append(bn)
        V.append(w / bn)
    f = f.to(b.device)
    out = torch.zeros_like(b)
    for k in range(f.shape[0]):
        out += f[k] * V[k]
    return out * nb


# -- wave space -------------------------------------------------------------

class Modes(NamedTuple):
    kx: torch.Tensor      # (Nx,)
    ky: torch.Tensor      # (Ny,)
    kz: torch.Tensor      # (Nz // 2 + 1,): the half spectrum
    wz: torch.Tensor      # (Nz // 2 + 1,): 1 on kz = 0 and Nyquist, else 2
    sqrt_b: torch.Tensor  # (Nx, Ny, Nzh): sqrt(6 pi (1 + k^2/4xi^2) / k^2)
                          #  exp(-k^2/8xi^2) sin(k)/k, 0 at k = 0
    b: torch.Tensor       # (Nx, Ny, Nzh): sqrt_b^2
    L: tuple
    nz: int


def modes(p: Params, device) -> Modes:
    """The FFT grid's wave vectors (untilted box) and the screened RPY
    kernel on them (the full Gaussian screen, no grid factors)."""
    Nx, Ny, Nz = p.grid

    def wrapped(N):
        i = torch.arange(N, device=device)
        return torch.where(i < (N + 1) // 2, i, i - N).to(F64)

    kx = 2.0 * math.pi * wrapped(Nx) / p.L[0]
    ky = 2.0 * math.pi * wrapped(Ny) / p.L[1]
    nzh = Nz // 2 + 1
    kz = 2.0 * math.pi * torch.arange(nzh, device=device, dtype=F64) / p.L[2]
    wz = torch.full((nzh,), 2.0, dtype=F64, device=device)
    wz[0] = 1.0
    if Nz % 2 == 0:
        wz[-1] = 1.0
    k2 = kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None] ** 2
    safe = torch.where(k2 > 0, k2, torch.ones_like(k2))
    k = torch.sqrt(safe)
    x = safe / (4.0 * p.xi * p.xi)
    sqrt_b = (torch.sqrt(6.0 * math.pi * (1.0 + x) / safe) * torch.exp(-x / 2.0)
              * torch.sin(k) / k)
    sqrt_b = torch.where(k2 > 0, sqrt_b, torch.zeros_like(sqrt_b))
    return Modes(kx, ky, kz, wz, sqrt_b, sqrt_b * sqrt_b, p.L, Nz)


def _volume(m: Modes) -> float:
    return m.L[0] * m.L[1] * m.L[2]


def _project(c: torch.Tensor, m: Modes) -> torch.Tensor:
    """(I - khat khat) c for c (3, Nx, Ny, Nzh)."""
    kv = torch.stack(torch.broadcast_tensors(
        m.kx[:, None, None], m.ky[None, :, None], m.kz[None, None]))
    k2 = (kv * kv).sum(0)
    safe = torch.where(k2 > 0, k2, torch.ones_like(k2))
    return c - kv * ((kv * c).sum(0) / safe)[None]


def hermitize(raw: torch.Tensor, nz: int) -> torch.Tensor:
    """The step's wave-space draw (6, Nx, Ny, Nzh) -> a Hermitian half
    spectrum (3, Nx, Ny, Nzh) complex128.  Every mode with 0 < kz < Nz/2
    is free (real parts first, then imaginary).  On the kz = 0 and the kz
    = Nz/2 planes each pair {(i, j), (-i, -j)} keeps the draw of the one
    with the smaller flat index i Ny + j and gives the other its
    conjugate; a mode equal to its own conjugate keeps sqrt(2) times its
    real draw and no imaginary part; k = 0 is zero."""
    raw = raw.to(F64)
    _, Nx, Ny, nzh = raw.shape
    re, im = raw[:3].clone(), raw[3:].clone()
    dev = raw.device
    i = torch.arange(Nx, device=dev)[:, None]
    j = torch.arange(Ny, device=dev)[None, :]
    ic, jc = (-i) % Nx, (-j) % Ny
    flat, pflat = i * Ny + j, ic * Ny + jc
    origin = (i == 0) & (j == 0)
    selfc = (i == ic) & (j == jc) & ~origin
    gen = ((flat < pflat) | selfc) & ~origin
    pidx = pflat.reshape(-1)
    planes = [0] + ([nzh - 1] if nz % 2 == 0 and nz > 1 else [])
    for pz in planes:
        r0 = re[..., pz].reshape(3, -1)
        i0 = im[..., pz].reshape(3, -1)
        rp = r0[:, pidx].reshape(3, Nx, Ny)
        ip = i0[:, pidx].reshape(3, Nx, Ny)
        r0, i0 = r0.reshape(3, Nx, Ny), i0.reshape(3, Nx, Ny)
        rh = torch.where(gen, r0, rp)
        ih = torch.where(gen, i0, -ip)
        sc = selfc if pz == 0 else (selfc | origin)
        rh = torch.where(sc, math.sqrt(2.0) * r0, rh)
        ih = torch.where(sc, torch.zeros_like(ih), ih)
        if pz == 0:
            rh = torch.where(origin, torch.zeros_like(rh), rh)
            ih = torch.where(origin, torch.zeros_like(ih), ih)
        re[..., pz], im[..., pz] = rh, ih
    return torch.complex(re, im)


def _phases(x: torch.Tensor, k: torch.Tensor, sign: float) -> torch.Tensor:
    """exp(sign i k x) for x (n,), k (K,): (n, K) complex128."""
    return torch.polar(torch.ones((), dtype=F64, device=x.device),
                       sign * x[:, None] * k[None, :])


def type1(pos: torch.Tensor, F: torch.Tensor, m: Modes,
          block: int = 2048) -> torch.Tensor:
    """F_hat(k) = sum_j F_j exp(-i k.x_j) on the half spectrum:
    (3, Nx, Ny, Nzh) complex128."""
    Nx, Ny, nzh = m.kx.shape[0], m.ky.shape[0], m.kz.shape[0]
    out = torch.zeros((Nx * Ny, nzh * 3), dtype=C128, device=pos.device)
    pos, F = pos.to(F64), F.to(F64)
    for s in range(0, pos.shape[0], block):
        x = pos[s:s + block]
        exy = (_phases(x[:, 0], m.kx, -1.0)[:, :, None]
               * _phases(x[:, 1], m.ky, -1.0)[:, None, :]).reshape(
                   x.shape[0], Nx * Ny)
        rz = (_phases(x[:, 2], m.kz, -1.0)[:, :, None]
              * F[s:s + block].to(C128)[:, None, :]).reshape(x.shape[0],
                                                            nzh * 3)
        out += exy.transpose(0, 1) @ rz
    return out.reshape(Nx, Ny, nzh, 3).permute(3, 0, 1, 2)


def type2(c: torch.Tensor, pos: torch.Tensor, m: Modes,
          block: int = 512) -> torch.Tensor:
    """u_i = sum_k wz Re(c_k exp(i k.x_i)) over the half spectrum, for
    c (3, Nx, Ny, Nzh): (n, 3) float64."""
    Nx, Ny, nzh = m.kx.shape[0], m.ky.shape[0], m.kz.shape[0]
    cw = (c * m.wz.to(C128)).permute(3, 1, 2, 0).reshape(nzh, Nx * Ny * 3)
    pos = pos.to(F64)
    out = []
    for s in range(0, pos.shape[0], block):
        x = pos[s:s + block]
        h = (_phases(x[:, 2], m.kz, 1.0) @ cw).reshape(x.shape[0], Nx, Ny, 3)
        h = h * _phases(x[:, 0], m.kx, 1.0)[:, :, None, None]
        h = h * _phases(x[:, 1], m.ky, 1.0)[:, None, :, None]
        out.append(h.sum((1, 2)).real)
    return torch.cat(out)


def _from_corner(x: torch.Tensor, m: Modes) -> torch.Tensor:
    """Coordinates measured from the box's lower corner, where the FFT
    grid's first node lies: the phase origin of the step's wave draw."""
    return x.to(F64) + torch.tensor(m.L, dtype=F64, device=x.device) / 2.0


def wave_noise_velocity(raw: torch.Tensor, at: torch.Tensor, m: Modes,
                        T: float, dt: float, lower: str | None = None):
    """sqrt(2 kT / dt) M_wave^{1/2} xi at the positions ``at`` from the
    step's raw wave draw: every mode's transverse part of the Hermitian
    draw, scaled by sqrt(2 kT / (dt V)) times the square root of the
    screened kernel (with the sign of sin(k)/k)."""
    c = _project(hermitize(raw, m.nz), m) * m.sqrt_b[None] * math.sqrt(
        2.0 * T / (dt * _volume(m)))
    if lower:
        c = rounded(c, lower)
    return type2(c, _from_corner(at, m), m)


def wave_mobility(pos: torch.Tensor, F: torch.Tensor, at: torch.Tensor,
                  m: Modes, lower: str | None = None) -> torch.Tensor:
    """M_wave F at the positions ``at``: (1/V) sum_k B(k) (I - khat khat)
    F_hat(k) exp(i k.x)."""
    c = _project(type1(_from_corner(pos, m), F, m), m) * (m.b[None]
                                                          / _volume(m))
    if lower:
        c = rounded(c, lower)
    return type2(c, _from_corner(at, m), m)


# -- one step ---------------------------------------------------------------

def step_parts(pos, psi, wave_raw, forces, T: float, dt: float, p: Params,
               rows, lower: dict | None = None):
    """The displacement of one step from ``pos`` (N, 3) at ``rows``, in
    three parts, each (len(rows), 3) float64: dt M F (zero without
    forces), the near field's Brownian part dt sqrt(2 kT / dt) M_real^{1/2}
    psi, and the wave space's dt sqrt(2 kT / dt) M_wave^{1/2} xi (both zero
    for an athermal step).  ``psi`` (N, 3) and ``wave_raw`` (6, Nx, Ny,
    Nzh) are the step's draws, ``forces`` (N, 3) or None; ``lower`` the
    control's precisions (``control_precision``), None for float64."""
    pos = pos.to(F64)
    dev = pos.device
    lower = lower or {}
    near = NearField(pos, p, lower=lower.get("near_field_pairs"))
    m = modes(p, dev)
    at = pos[rows]
    zero = torch.zeros((at.shape[0], 3), dtype=F64, device=dev)
    det = near_th = wave_th = zero
    if forces is not None:
        Fd = forces.to(F64)
        det = dt * (near.matvec(Fd)[rows]
                    + wave_mobility(pos, Fd, at, m, lower.get("wave_space")))
    if psi is not None:
        near_th = dt * math.sqrt(2.0 * T / dt) * lanczos_sqrt(
            near.matvec, psi.to(F64))[rows]
        wave_th = dt * wave_noise_velocity(wave_raw, at, m, T, dt,
                                           lower.get("wave_space"))
    return det, near_th, wave_th
