"""Wave-space Green's function of the far field.

PyTorch counterpart of ``apply_green`` in ``pse_tpu/ops/farfield.py`` (the
rest of that module is the gather engine's spread/contract, not ported).
"""

from __future__ import annotations

import torch


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
