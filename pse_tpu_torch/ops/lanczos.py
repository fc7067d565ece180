"""Lanczos square root of the near-field mobility: u = M_real^{1/2} psi.

PyTorch counterpart of ``pse_tpu/ops/lanczos.py`` (Chow & Saad Krylov
sampling; reference loop gpu_stokes_BrealLanczos_wrap, Brownian.cu:357-765).
The iteration is a host Python loop around the device matvecs and vector
updates; it reads two scalars (alpha_j, beta_{j+1}) per iteration, and the
small tridiagonal eigendecomposition runs on the host in float64 numpy.
The parts of the JAX algorithm kept as they are:

  * the warm start: at least max(m_start - 1, 1) + 1 iterations, and the
    iterations before the first deciding one skip the eigendecomposition;
  * the coefficient-space step norm ||f_j - f_{j-1}|| / sqrt(alpha_0) with
    f = T^{1/2} e_1, so the basis is contracted once, after the loop;
  * the breakdown cut (||w|| < 1e-8 ends the basis);
  * ``hit_cap``: m_max reached unconverged;
  * the zero-padded (m_max x m_max) tridiagonal: its padding decouples, so
    T^{1/2} e_1 equals the active block's.

Returns (M_real^{1/2} psi, m_used, hit_cap) with m_used and hit_cap as host
values; the caller applies the thermal scale sqrt(2T/dt).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _sqrt_tridiag_e1(alpha, beta, m_max):
    """f = T^{1/2} e_1 of the zero-padded symmetric tridiagonal (float64)."""
    T = (np.diag(alpha) + np.diag(beta[1:m_max], 1)
         + np.diag(beta[1:m_max], -1))
    lam, Q = np.linalg.eigh(T)
    return Q @ (np.sqrt(np.maximum(lam, 0.0)) * Q[0, :])


def sqrt_mreal(
    matvec_t: Callable[[torch.Tensor], torch.Tensor],
    psi_t: torch.Tensor,
    error: float,
    m_start: int,
    m_max: int = 48,
    w0=None,
):
    """Compute (M_real^{1/2} psi, m_used, hit_cap).

    ``matvec_t`` applies M_real in the engine's slot layout and ``psi_t`` is
    a vector in that layout.  ``w0``: optional precomputed M v_0 with
    v_0 = psi / ||psi|| (the step rides it on the fused build + matvec)."""
    eps_breakdown = 1e-8
    vnorm = torch.sqrt(torch.sum(psi_t * psi_t))
    v0 = psi_t / vnorm
    warm = int(np.clip(int(m_start) - 1, 1, m_max - 1))

    V = []
    alpha = np.zeros(m_max)
    beta = np.zeros(m_max)
    f = np.zeros(m_max)
    stepnorm = np.inf
    vj, vjm1 = v0, torch.zeros_like(v0)
    tempbeta = torch.zeros((), dtype=psi_t.dtype, device=psi_t.device)
    tempbeta_h = 0.0
    breakdown = False
    assembled = False

    def iterate(w_raw, assemble):
        nonlocal vj, vjm1, tempbeta, tempbeta_h, breakdown, f, stepnorm
        j = len(V)
        V.append(vj)
        beta[j] = tempbeta_h
        w = w_raw - tempbeta * vjm1
        a = torch.sum(vj * w)
        w = w - a * vj
        nb = torch.sqrt(torch.sum(w * w))
        a_h, nb_h = torch.stack([a, nb]).tolist()     # the one host read
        alpha[j] = a_h
        breakdown = nb_h < eps_breakdown
        vnext = w / (1.0 if breakdown else nb)
        if assemble:
            f_new = _sqrt_tridiag_e1(alpha, beta, m_max)
            df = f_new - f
            stepnorm = float(np.sqrt(np.dot(df, df) / alpha[0]))
            f = f_new
        vjm1, vj, tempbeta, tempbeta_h = vj, vnext, nb, nb_h

    iterate(matvec_t(v0) if w0 is None else w0, assemble=False)
    while len(V) < warm - 1 and not breakdown:
        iterate(matvec_t(vj), assemble=False)
    while (len(V) < m_max and not breakdown
           and (len(V) < warm + 1 or stepnorm > error)):
        iterate(matvec_t(vj), assemble=True)
        assembled = True
    if not assembled:
        f = _sqrt_tridiag_e1(alpha, beta, m_max)

    m_used = len(V)
    coef = torch.as_tensor(f[:m_used], dtype=torch.float32,
                           device=psi_t.device)
    vel = torch.einsum("m,m...->...", coef, torch.stack(V))
    hit_cap = m_used >= m_max and not breakdown and stepnorm > error
    return vel * vnorm, m_used, bool(hit_cap)
