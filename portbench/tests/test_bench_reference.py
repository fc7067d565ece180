"""The reference against a float64 direct Ewald sum on a tiny box, and its
Lanczos square root against an eigendecomposition."""

import math

import numpy as np
import torch

from portbench import reference as R


def direct_ewald(pos, F, L, xi, kcut_sigmas=30.0):
    """U = M F by an explicit sum: real space over the 27 nearest images
    with the pair functions, wave space over every reciprocal vector below
    kcut with the full screen (float64, numpy and torch on the CPU)."""
    n = pos.shape[0]
    U = R.derive(xi, 1e-3, (L,) * 3).self_mobility * F.copy()
    for s in np.stack(np.meshgrid(*[(-1, 0, 1)] * 3, indexing="ij"),
                      -1).reshape(-1, 3):
        rij = pos[:, None, :] - pos[None, :, :] + s * L
        d = np.linalg.norm(rij, axis=-1)
        ok = d > 1e-12
        ds = np.where(ok, d, 1.0)
        u1, u2 = (x.numpy() for x in R.pair_functions(torch.tensor(ds), xi))
        u1, u2 = np.where(ok, u1, 0.0), np.where(ok, u2, 0.0)
        rh = rij / ds[..., None]
        U += np.einsum("ij,jx->ix", u1, F)
        U += np.einsum("ij,ij,ijx->ix", u2 - u1,
                       np.einsum("ijx,jx->ij", rh, F), rh)
    kcut = 2.0 * xi * math.sqrt(kcut_sigmas)
    nmax = int(math.ceil(kcut * L / (2 * math.pi))) + 1
    g = np.arange(-nmax, nmax + 1)
    k = 2 * np.pi / L * np.stack(np.meshgrid(g, g, g, indexing="ij"),
                                 -1).reshape(-1, 3)
    k2 = (k * k).sum(1)
    sel = (k2 > 0) & (k2 < kcut * kcut)
    k, k2 = k[sel], k2[sel]
    km = np.sqrt(k2)
    B = (6 * np.pi * (1 + k2 / (4 * xi * xi)) * np.exp(-k2 / (4 * xi * xi))
         / k2 * (np.sin(km) / km) ** 2 / L ** 3)
    ph = np.exp(-1j * k @ pos.T)
    S = ph @ F
    kh = k / km[:, None]
    S = S - kh * (kh * S).sum(1)[:, None]
    U += np.real(np.conj(ph).T @ (B[:, None] * S))
    return U


def test_mobility_matches_direct_sum():
    # a box of 10 with a cutoff and a grid tight enough that the split's
    # own truncation lies far below the comparison
    rng = np.random.default_rng(0)
    L, xi, n = 10.0, 1.2, 40
    pos = rng.uniform(-L / 2, L / 2, (n, 3))
    F = rng.normal(size=(n, 3))
    rcut = 4.9                                  # erfc(xi rcut) ~ 1e-13
    p = R.Params(xi, 1e-13, (L,) * 3, rcut, (48, 48, 48),
                 R.derive(xi, 1e-3, (L,) * 3).self_mobility)
    pt, Ft = torch.tensor(pos), torch.tensor(F)
    m = R.modes(p, "cpu")
    u = R.NearField(pt, p).matvec(Ft) + R.wave_mobility(pt, Ft, pt, m)
    ref = direct_ewald(pos, F, L, xi)
    err = np.linalg.norm(u.numpy() - ref) / np.linalg.norm(ref)
    assert err < 1e-8, err


def test_lanczos_sqrt_matches_eigh():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(60, 60))
    A = A @ A.T / 60 + np.eye(60)
    b = rng.normal(size=(20, 3))
    At = torch.tensor(A)
    mv = lambda v: (At @ v.reshape(-1)).reshape(v.shape)
    u = R.lanczos_sqrt(mv, torch.tensor(b)).numpy().reshape(-1)
    lam, Q = np.linalg.eigh(A)
    ref = Q @ (np.sqrt(lam) * (Q.T @ b.reshape(-1)))
    assert np.linalg.norm(u - ref) / np.linalg.norm(ref) < 1e-9


def test_wave_modes_and_hermitian_draw():
    # the noise's kernel is the square root of the mobility's, zero at
    # k = 0, and the kz = 0 plane of the Hermitized draw is Hermitian
    L, xi = 12.0, 0.8
    p = R.Params(xi, 1e-3, (L,) * 3, 3.0, (16, 16, 16), 0.0)
    m = R.modes(p, "cpu")
    assert torch.allclose(m.sqrt_b * m.sqrt_b, m.b)
    assert float(m.sqrt_b[0, 0, 0]) == 0.0
    raw = torch.rand((6, 16, 16, 9), generator=torch.Generator().manual_seed(2))
    f = R.hermitize(raw * 2 * math.sqrt(1.5) - math.sqrt(1.5), 16)
    # f(-i, -j) = conj f(i, j) on the kz = 0 plane
    i, j = 3, 5
    assert torch.allclose(f[:, (-i) % 16, (-j) % 16, 0], f[:, i, j, 0].conj())
    assert float(f[:, 0, 0, 0].abs().max()) == 0.0
