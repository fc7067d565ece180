"""Stochastic increments: per-slot psi and Hermitian wave-space grid noise.

PyTorch counterpart of ``pse_tpu/ops/noise.py``.  The distributions are the
JAX package's: psi ~ U(-sqrt 3, sqrt 3) per component (unit variance), and
wave uniforms U(-sqrt 1.5, sqrt 1.5) for the real and imaginary parts of
every half-spectrum node, Hermitized by construction on the kz = 0 and
kz = Nz/2 planes.  Draws come from a ``torch.Generator``; each function also
accepts its raw uniforms, so that tests can feed both packages the same
numbers (jax's threefry bits cannot be reproduced in torch).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..params import PSEParams, hermitian_noise_maps

SQRT3 = math.sqrt(3.0)
SQRT3D2 = math.sqrt(1.5)
SQRT2 = math.sqrt(2.0)


def _given(x, device):
    """A caller's raw uniforms as a float32 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


def _uniform(shape, lo, hi, generator, device):
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u * (hi - lo) + lo


def particle_noise(n: int, device, generator=None, uniforms=None):
    """psi (N, 3), U(-sqrt 3, sqrt 3) per component (unit variance); the
    step draws ``particle_noise_t``'s layout instead.  ``uniforms``
    replaces the draw."""
    if uniforms is not None:
        return _given(uniforms, device)
    return _uniform((n, 3), -SQRT3, SQRT3, generator, device)


def particle_noise_t(shape, device, generator=None, uniforms=None):
    """psi in the engine's transposed layout (3, *shape), U(-sqrt 3, sqrt 3);
    ``uniforms`` replaces the draw."""
    if uniforms is not None:
        return _given(uniforms, device)
    return _uniform((3,) + tuple(shape), -SQRT3, SQRT3, generator, device)


def _project_and_scale(f, kvec, W, params: PSEParams, T, dt):
    """Transverse projection and the B^{1/2} amplitude (float32)."""
    dev = W.device
    n_total = params.n_grid_total
    k2 = torch.sum(kvec * kvec, dim=-1)
    one = torch.ones((), dtype=torch.float32, device=dev)
    k2_safe = torch.where(k2 > 0, k2, one)
    kv = torch.movedim(kvec, -1, 0)
    kdF = torch.sum(kv * f, dim=0) / k2_safe
    f = f - kv * kdF[None]

    k = torch.sqrt(k2_safe)
    sinc = torch.sin(k) / k
    T = torch.as_tensor(T, dtype=torch.float32, device=dev)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    fac = torch.sqrt(2.0 * T / (dt * params.quadW) * n_total)
    b12 = torch.sqrt(W) * sinc
    amp = torch.where(k2 > 0, fac * b12, torch.zeros_like(b12))
    return (f * amp[None]).to(torch.complex64)


def wave_space_noise_hat_half(params: PSEParams, kvec, W, T, dt,
                              generator=None, uniforms=None):
    """Half-spectrum random k-space velocity increment (3, Nx, Ny, Nz//2+1)
    complex64, added to the spectrum before ``irfftn``.

    Modes with 0 < kz < Nz/2 are free complex draws; the kz = 0 plane (and
    kz = Nz/2 for even Nz) is made self-Hermitian under (i, j) -> (-i, -j).
    ``uniforms``: the raw (6, Nx, Ny, Nz//2+1) draw, real parts first."""
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    nzh = Nz // 2 + 1
    dev = W.device
    if uniforms is None:
        u = _uniform((6, Nx, Ny, nzh), -SQRT3D2, SQRT3D2, generator, dev)
    else:
        u = _given(uniforms, dev)
    re, im = u[:3].clone(), u[3:].clone()

    conj2, gen2, selfc2, origin2 = hermitian_noise_maps(Nx, Ny, 1)
    conj2 = torch.as_tensor(conj2[:, :, 0].reshape(-1), dtype=torch.long,
                            device=dev)
    gen2 = torch.as_tensor(gen2[:, :, 0], device=dev)
    selfc2 = torch.as_tensor(selfc2[:, :, 0], device=dev)
    origin2 = torch.as_tensor(origin2[:, :, 0], device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def hermitize_plane(re_p, im_p, is_kz0):      # (3, Nx, Ny) each
        re_c = re_p.reshape(3, -1)[:, conj2].reshape(3, Nx, Ny)
        im_c = im_p.reshape(3, -1)[:, conj2].reshape(3, Nx, Ny)
        re_h = torch.where(gen2[None], re_p, re_c)
        im_h = torch.where(gen2[None], im_p, -im_c)
        # (0,0) is the true k = 0 mode only on the kz = 0 plane; on the
        # Nyquist plane it is a self-conjugate mode (a sqrt(2) real draw)
        selfc_m = selfc2 if is_kz0 else (selfc2 | origin2)
        re_h = torch.where(selfc_m[None], SQRT2 * re_p, re_h)
        im_h = torch.where(selfc_m[None], zero, im_h)
        if is_kz0:
            re_h = torch.where(origin2[None], zero, re_h)
            im_h = torch.where(origin2[None], zero, im_h)
        return re_h, im_h

    planes = [(0, True)] + ([(nzh - 1, False)] if Nz % 2 == 0 and Nz > 1
                            else [])
    for pz, is_kz0 in planes:
        rh, ih = hermitize_plane(re[..., pz], im[..., pz], is_kz0)
        re[..., pz] = rh
        im[..., pz] = ih

    f = torch.complex(re, im)
    return _project_and_scale(f, kvec, W, params, T, dt)


def wave_space_noise_hat(params: PSEParams, kvec, W, T, dt, generator=None,
                         uniforms=None):
    """Full-spectrum Hermitian random k-space velocity increment
    (3, Nx, Ny, Nz) complex64, for ``gridk_arrays(..., half=False)``'s
    kvec and W: every node draws, a non-generator node takes the conjugate
    of its partner's draw, self-conjugate nodes keep a real draw times
    sqrt 2, and k = 0 is zero.  ``uniforms``: the raw (6, Nx, Ny, Nz) draw,
    real parts first."""
    shape = (params.Nx, params.Ny, params.Nz)
    dev = W.device
    if uniforms is None:
        u = _uniform((6,) + shape, -SQRT3D2, SQRT3D2, generator, dev)
    else:
        u = _given(uniforms, dev)
    re, im = u[:3], u[3:]
    conj, gen, selfc, origin = (torch.as_tensor(a, device=dev) for a in
                                hermitian_noise_maps(*shape))
    conj = conj.reshape(-1).long()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    re_c = re.reshape(3, -1)[:, conj].reshape((3,) + shape)
    im_c = im.reshape(3, -1)[:, conj].reshape((3,) + shape)
    re_p = torch.where(gen[None], re, re_c)
    im_p = torch.where(gen[None], im, -im_c)
    re_p = torch.where(selfc[None], SQRT2 * re, re_p)
    im_p = torch.where(selfc[None] | origin[None], zero, im_p)
    re_p = torch.where(origin[None], zero, re_p)
    return _project_and_scale(torch.complex(re_p, im_p), kvec, W, params, T,
                              dt)
