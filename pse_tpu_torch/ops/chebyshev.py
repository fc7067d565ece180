"""Chebyshev evaluation of the real-space Ewald RPY pair functions.

The fit is a numpy copy of the JAX package's ``ops/chebyshev.py``: piecewise
fits of UF1/UF2 on [ewald_dr, 2a] and [2a, ewald_cut], computed in float64
from the exact formulas (tables.py) and certified against a dense sample.
``eval_pair_functions`` is the torch evaluation (Clenshaw recurrence with a
select at the r = 2a branch point); the banded kernels evaluate the same
recurrence from ``device_coeffs``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import tables


class ChebPair(NamedTuple):
    """Static container of piecewise-Chebyshev coefficients (hashable)."""

    lo: float            # domain start (= ewald_dr)
    mid: float           # branch point (min(2a, rcut))
    hi: float            # domain end (= ewald_cut)
    coeffs: tuple        # (uf1_lo, uf2_lo, uf1_hi, uf2_hi), padded equal len

    @property
    def degree(self) -> int:
        return len(self.coeffs[0]) - 1


def _fit_piece(fn, a: float, b: float, max_deg: int = 48, tol: float = 1e-6):
    """Chebyshev fit of fn on [a, b] in float64 with certified max error."""
    for deg in range(8, max_deg + 1, 4):
        nodes = np.cos(np.pi * (np.arange(deg + 1) + 0.5) / (deg + 1))
        r = 0.5 * (b - a) * (nodes + 1.0) + a
        series = np.polynomial.chebyshev.Chebyshev.fit(
            r, fn(r), deg, domain=[a, b]
        )
        check = np.linspace(a, b, 4001)
        err = np.abs(series(check) - fn(check)).max()
        if err < tol:
            return series.coef, err
    return series.coef, err


@lru_cache(maxsize=16)
def fit_pair_functions(
    xi: float, ewald_dr: float, ewald_cut: float, radius: float = 1.0,
    tol: float = 1e-6,
) -> ChebPair:
    """Fit UF1/UF2 on [ewald_dr, 2a] and [2a, ewald_cut] (one piece, used
    twice, when the cutoff lies inside the overlap region)."""
    mid = min(2.0 * radius, ewald_cut)

    def uf1(r):
        return tables.real_space_pair_functions(r, xi, radius)[0]

    def uf2(r):
        return tables.real_space_pair_functions(r, xi, radius)[1]

    pieces = []
    errs = []
    for fn in (uf1, uf2):
        c, err = _fit_piece(fn, ewald_dr, mid, tol=tol)
        pieces.append(c)
        errs.append(err)
    if ewald_cut > mid:
        for fn in (uf1, uf2):
            c, err = _fit_piece(fn, mid, ewald_cut, tol=tol)
            pieces.append(c)
            errs.append(err)
    else:
        pieces.extend(pieces[:2])

    max_err = float(np.max(errs))
    if max_err > 10 * tol:
        raise RuntimeError(
            f"Chebyshev fit of real-space pair functions failed: err={max_err}"
        )

    deg = max(len(c) for c in pieces)
    padded = tuple(
        tuple(float(x) for x in np.pad(c, (0, deg - len(c)))) for c in pieces
    )
    return ChebPair(lo=float(ewald_dr), mid=float(mid), hi=float(ewald_cut),
                    coeffs=padded)


def _affine(cheb: ChebPair):
    """float32 (a, b) of t = (2r - a) / b on each piece, as the JAX package
    computes them (Python doubles rounded once to float32)."""
    lo, mid, hi = cheb.lo, cheb.mid, cheb.hi
    a_lo, b_lo = lo + mid, mid - lo
    a_hi, b_hi = (mid + hi, hi - mid) if hi > mid else (a_lo, b_lo)
    return [float(np.float32(x)) for x in (a_lo, b_lo, a_hi, b_hi)]


def device_coeffs(cheb: ChebPair, device) -> torch.Tensor:
    """(4 + 4·(deg+1),) float32 kernel operand: the affine maps of the two
    pieces, then the coefficient rows (uf1_lo, uf2_lo, uf1_hi, uf2_hi)."""
    vals = _affine(cheb) + [c for row in cheb.coeffs for c in row]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def eval_pair_functions(cheb: ChebPair, r: torch.Tensor):
    """(UF1(r), UF2(r)) via the Clenshaw recurrence with a branch select.

    Out-of-domain r (r < lo or r >= hi) must be masked by the caller."""
    in_lo = r < cheb.mid
    # tensor divisors: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, one rounding away from the kernels' true division
    a_lo, b_lo, a_hi, b_hi = _affine(cheb)
    b_lo, b_hi = (torch.full((), b, dtype=r.dtype, device=r.device)
                  for b in (b_lo, b_hi))
    t = torch.where(in_lo, (2.0 * r - a_lo) / b_lo, (2.0 * r - a_hi) / b_hi)
    t2 = 2.0 * t
    c1_lo, c2_lo, c1_hi, c2_hi = cheb.coeffs

    def clenshaw(c_lo, c_hi):
        b1 = torch.zeros_like(t)
        b2 = torch.zeros_like(t)
        for k in range(len(c_lo) - 1, 0, -1):
            ck = torch.where(in_lo, c_lo[k], c_hi[k])
            b1, b2 = ck + t2 * b1 - b2, b1
        c0 = torch.where(in_lo, c_lo[0], c_hi[0])
        return c0 + t * b1 - b2

    return clenshaw(c1_lo, c1_hi), clenshaw(c2_lo, c2_hi)
