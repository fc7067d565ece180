"""The PSE Brownian-dynamics step on the banded engine (thermal, force-free).

PyTorch counterpart of ``pse_tpu/integrator.py`` for the slice the port
covers: ``engine="banded"``, ``thermal=True``, no external forces.  One step:

  binnings (bin_columns for the near field, bin_particles for the far field)
  -> band windows + far-field factors -> Hermitian wave noise -> irfft
  -> far-field contract -> fused near-field build + first Lanczos matvec
  -> Lanczos M_real^{1/2} psi -> Euler update with shear advection -> wrap

Randomness is keyed by (hash_seed(seed), step) on a ``torch.Generator`` of
the step's device, so a rerun on one device is bitwise equal and a step's
draws do not depend on history.  The other engines ("blocked", "gather"),
external forces and ``mobility()`` are not ported yet and raise
``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .box import Box, make_box, wrap
from .cellbins import bin_columns, bin_particles, vec_from_cells
from .params import PSEParams, gridk_arrays
from .ops import banded_nearfield as bdn
from .ops import column_farfield as cff
from .ops import lanczos, noise
from .ops.chebyshev import ChebPair, fit_pair_functions

# Lanczos shrink-probe period: every K-th step starts the convergence test
# one iteration early so the persisted warm-start m can decrease.
M_SHRINK_PERIOD = 16

OVF_NF = 1        # near-field column capacity
OVF_BAND = 2      # banded window width
OVF_FF = 4        # far-field cell capacity
OVF_LANCZOS = 8   # Lanczos m_max hit unconverged

_NOT_PORTED = (
    "not ported to pse_tpu_torch yet (ROADMAP.md, Queue A: {what}); the "
    "port runs the thermal, force-free banded engine"
)


def _not_ported(what: str):
    return NotImplementedError(_NOT_PORTED.format(what=what))


class State(NamedTuple):
    """Integration state: device tensors for the particle arrays and the
    sticky overflow mask, host scalars for the counters the host loop
    reads every step."""

    pos: torch.Tensor           # (N, 3) f32 wrapped positions
    images: torch.Tensor        # (N, 3) i32 PBC image flags
    step: int                   # timestep counter
    tilt_xy: float              # current box xy tilt (strain), f32 value
    m_lanczos: int              # Lanczos warm start (init 2)
    nbr_overflow: torch.Tensor  # () i32 sticky capacity-overflow mask


def make_state(pos, step: int = 0, tilt_xy: float = 0.0,
               device="cuda") -> State:
    pos = torch.from_numpy(np.array(pos, np.float32)).to(device)
    return State(
        pos=pos,
        images=torch.zeros(pos.shape, dtype=torch.int32, device=device),
        step=int(step),
        tilt_xy=float(np.float32(tilt_xy)),
        m_lanczos=2,
        nbr_overflow=torch.zeros((), dtype=torch.int32, device=device),
    )


def state_from_arrays(d, device="cuda") -> State:
    """State from the dict ``pse_tpu``'s ``Simulation.snapshot()`` returns
    or ``save()`` writes (pos, images, step, tilt_xy, m_lanczos)."""
    return State(
        pos=torch.from_numpy(np.array(d["pos"], np.float32)).to(device),
        images=torch.from_numpy(np.array(d["images"], np.int32)).to(device),
        step=int(d["step"]),
        tilt_xy=float(np.float32(d["tilt_xy"])),
        m_lanczos=int(d["m_lanczos"]),
        nbr_overflow=torch.zeros((), dtype=torch.int32, device=device),
    )


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration of the step: always the banded engine, thermal,
    without external forces (the slice the port covers; the JAX package's
    ``engine``/``thermal``/``has_forces`` fields have one value here)."""

    params: PSEParams
    cheb: ChebPair
    band_spec: bdn.BandSpec
    colff_spec: cff.ColFfSpec
    m_max: int = 24
    seed: int = 0
    device: str = "cuda"


def _cheb_tol(block_dtype: str) -> float:
    """Pair-function fit tolerance matched to the block dtype (bf16 blocks
    round every entry at ~4e-3 relative anyway)."""
    return 3e-5 if block_dtype == "bfloat16" else 1e-6


def _ff_blockable(params: PSEParams) -> bool:
    """Whether every grid axis has a far-field block size (the JAX
    package's make_ff_spec test; banded falls back to blocked without)."""
    need = params.gauss_P // 2 + 1
    return all(
        any(ng % s == 0 for s in range(need, ng // 3 + 1))
        for ng in (params.Nx, params.Ny, params.Nz)
    )


def make_config(
    params: PSEParams,
    n_particles: int,
    thermal: bool = True,
    seed: int = 0,
    m_max: int = 24,
    engine: str = "blocked",
    max_tilt: float | None = None,
    max_neighbors: int | None = None,
    block_dtype: str | None = None,
    has_forces: bool = True,
    shard_slabs: int = 1,
    ff_weight_dtype: str | None = None,
    nbr_subdiv: int = 1,
    positions=None,
    device="cuda",
) -> StepConfig:
    """Build a StepConfig with the JAX package's banded-engine shapes.

    Raises NotImplementedError where the JAX package would run code the
    port does not have: another engine, external forces (or an athermal
    run, which the JAX package turns into one), several halo slabs, and a
    geometry too small to band (the JAX package then falls back to the
    blocked engine).  ``max_neighbors`` and ``nbr_subdiv`` size the gather
    engine and ``positions`` the occupancy classes; neither is ported, so
    they are accepted and unused."""
    del max_neighbors, nbr_subdiv, positions
    if engine != "banded":
        raise _not_ported(f"the {engine!r} engine")
    if not thermal and not has_forces:
        has_forces = True               # an athermal step is M·0
    if has_forces:
        raise _not_ported("external forces and the with-forces step")
    if shard_slabs != 1:
        raise _not_ported("parallel/ halo slabs")
    if block_dtype is None:
        block_dtype = "bfloat16" if params.error >= 1e-3 else "float32"
    elif block_dtype == "bfloat16" and params.error < 1e-3:
        warnings.warn(
            f"bfloat16 pair blocks cap near-field accuracy at ~5e-4, above "
            f"the requested error={params.error:g}; pass "
            f"block_dtype='float32' for full float32 accuracy",
            stacklevel=2,
        )
    max_tilt = params.max_strain if max_tilt is None else max_tilt
    band_spec = bdn.make_band_spec(
        n_particles, params.L, params.ewald_cut, max_tilt=max_tilt,
        block_dtype=block_dtype,
    )
    colff_spec = cff.make_col_spec(params, n_particles, ff_weight_dtype,
                                   device=device)
    if band_spec is None or colff_spec is None or not _ff_blockable(params):
        raise _not_ported("the blocked engine, which make_config falls back "
                          "to when the geometry is too small to band")
    cheb = fit_pair_functions(
        params.xi, params.ewald_dr, params.ewald_cut, params.radius,
        tol=_cheb_tol(block_dtype),
    )
    return StepConfig(
        params=params, cheb=cheb, band_spec=band_spec, colff_spec=colff_spec,
        m_max=m_max, seed=seed, device=str(torch.device(device)),
    )


def grow_config(config: StepConfig, factor: float = 1.4,
                flags: int | None = None) -> StepConfig:
    """Enlarge the capacities the overflow mask ``flags`` names (None grows
    all): m_max for OVF_LANCZOS, the far-field cap for OVF_FF, the band
    window (or, at W = 256, the row tile) for OVF_BAND and the column cap
    for OVF_NF."""
    if flags is None:
        flags = OVF_NF | OVF_BAND | OVF_FF | OVF_LANCZOS
    flags = int(flags)
    changes = {}
    if flags & OVF_LANCZOS:
        changes["m_max"] = min(max(config.m_max * 2, config.m_max + 8), 100)
    if flags & OVF_FF:
        bins = config.colff_spec.bins
        changes["colff_spec"] = config.colff_spec._replace(
            bins=bins._replace(cap=int(-(-bins.cap * factor // 8)) * 8)
        )
    if flags & (OVF_NF | OVF_BAND):
        bs = config.band_spec
        rows, window, cap = bs.rows, bs.window, bs.bins.cap
        if flags & OVF_BAND:
            if window + 64 <= 256 and cap >= window + 64:
                window += 64
            elif rows > 16:
                rows = 16
        if flags & OVF_NF:
            cap = int(-(-cap * factor // rows)) * rows
        cap = max(-(-cap // rows) * rows, window)
        changes["band_spec"] = bs._replace(
            bins=bs.bins._replace(cap=cap), rows=rows, window=window,
        )
    return dataclasses.replace(config, **changes)


def hash_seed(seed: int) -> int:
    """The reference's seed hash (Stokes.cc:102)."""
    s = (seed * 0x12345677 + 0x12345) & 0xFFFFFFFF
    s ^= s >> 16
    s = (s * 0x45679) & 0xFFFFFFFF
    return s


def step_generator(config: StepConfig, step: int) -> torch.Generator:
    """The draws of one step: a generator on the step's device seeded from
    (hash_seed(seed), step)."""
    g = torch.Generator(device=config.device)
    g.manual_seed((hash_seed(config.seed) << 32) | (int(step) & 0xFFFFFFFF))
    return g


def _box_of(config: StepConfig, tilt) -> Box:
    return make_box(config.params.L, tilt)


class BandedCtx(NamedTuple):
    """Per-step data of the banded engine."""

    nf_bins: object        # z-sorted column bins
    ff_bins: object        # far-field column bins
    j0: torch.Tensor       # (O, C, T) window starts (O = 9 on CPU, 5 on CUDA)
    n_valid: torch.Tensor  # (C,)
    zsh: torch.Tensor      # (O, C, T) window z image shifts
    ff_factors: object     # cff.ColFactors
    tilt: float
    blocks: object = None  # (1, C, 2, S, 5W) after build_mv (None on CPU)


def _ovf(flag: torch.Tensor, bit: int) -> torch.Tensor:
    return flag.to(torch.int32) * bit


def prepare_banded(config: StepConfig, pos, box: Box):
    """Binnings, band windows and far-field factors; returns (ctx, the
    overflow mask as a () int32 tensor)."""
    p = config.params
    bs = config.band_spec
    nf_bins = bin_columns(pos, box, bs.bins)
    ff_bins = bin_particles(pos, box, config.colff_spec.bins)
    # the CUDA kernels read the stored half stencil's windows only; the
    # plain matvec (CPU) gathers all 9 offsets
    offs = bs.offsets if pos.device.type == "cpu" else bs.offsets[:bdn.N_HALF]
    j0, n_valid, band_overflow, zsh = bdn.compute_windows(
        nf_bins, bs, box, p.ewald_cut, offsets=offs)
    factors = cff.build_col_factors(ff_bins, box, config.colff_spec, p)
    overflow = (_ovf(nf_bins.overflow, OVF_NF) | _ovf(ff_bins.overflow, OVF_FF)
                | _ovf(band_overflow, OVF_BAND))
    return BandedCtx(nf_bins, ff_bins, j0, n_valid, zsh, factors,
                     box.tilt_xy), overflow


def _band_args(config: StepConfig, ctx: BandedCtx):
    p = config.params
    return (ctx.nf_bins, ctx.tilt, config.band_spec, config.cheb, p.L,
            p.ewald_cut, p.ewald_dr, ctx.j0, ctx.n_valid, ctx.zsh)


def build_mv(config: StepConfig, ctx: BandedCtx, ft):
    """Fused build of A + the first near-field matvec: (ctx with blocks,
    M_real ft)."""
    blocks, u = bdn.build_mv_banded(*_band_args(config, ctx), ft,
                                    config.params.self_mobility)
    return ctx._replace(blocks=blocks), u


def mreal_t(config: StepConfig, ctx: BandedCtx, cells):
    """M_real cells (3, C, S) from the step's stored A."""
    return bdn.matvec_banded(ctx.blocks, *_band_args(config, ctx), cells,
                             config.params.self_mobility)


def _far_field(config: StepConfig, ctx: BandedCtx, box: Box, T, dt,
               generator, uniforms):
    """Wave-space Brownian velocities (N, 3): Hermitian noise -> irfft ->
    contract."""
    p = config.params
    kvec, W = gridk_arrays(p, box.tilt_xy, ctx.j0.device, half=True)
    ghat = noise.wave_space_noise_hat_half(p, kvec, W, T, dt, generator,
                                           uniforms)
    grid_v = torch.fft.irfftn(ghat, s=(p.Nx, p.Ny, p.Nz), dim=(1, 2, 3))
    u_cells = cff.contract_col_kernel(grid_v.to(torch.float32),
                                      config.colff_spec, p, ctx.ff_factors)
    return vec_from_cells(ctx.ff_bins, config.colff_spec.bins, u_cells)


def _psi(config: StepConfig, ctx: BandedCtx, generator, uniforms):
    spec = config.band_spec.bins
    C = spec.n_cells[0] * spec.n_cells[1]
    u = noise.particle_noise_t((C, spec.cap), ctx.j0.device, generator,
                               uniforms)
    return u * ctx.nf_bins.mask.reshape(1, C, spec.cap)


def step(config: StepConfig, state: State, T, dt, shear_rate,
         new_tilt=None, uniforms=None):
    """Advance one Euler-Maruyama step (Stokes.cu:137-192 semantics).

    T: temperature; dt: timestep; shear_rate: current rate (adds rate*y to
    the x velocity); new_tilt: next-step box tilt (None keeps the current).
    ``uniforms``: optional (psi (3, C, cap), wave (6, Nx, Ny, Nz//2+1)) raw
    draws replacing the step's generator (cross-package tests).

    Returns (new_state, info) with info velocities (N, 3), nbr_overflow
    (() int32 tensor) and m_lanczos (int)."""
    p = config.params
    pos = state.pos
    box = _box_of(config, state.tilt_xy)
    gen = None if uniforms is not None else step_generator(config, state.step)
    u_psi, u_wave = (None, None) if uniforms is None else uniforms

    ctx, overflow = prepare_banded(config, pos, box)
    u = _far_field(config, ctx, box, T, dt, gen, u_wave)

    psi = _psi(config, ctx, gen, u_psi)
    vnorm = torch.sqrt(torch.sum(psi * psi))
    ctx, w0 = build_mv(config, ctx, psi / vnorm)
    probe = int(state.step % M_SHRINK_PERIOD == 0)
    u_sqrt, m_used, hit_cap = lanczos.sqrt_mreal(
        lambda vt: mreal_t(config, ctx, vt), psi, p.error,
        max(state.m_lanczos - probe, 2), config.m_max, w0=w0,
    )
    if hit_cap:
        overflow = overflow | OVF_LANCZOS
    scale = float(np.float32(math.sqrt(2.0 * float(np.float32(T))
                                       / float(np.float32(dt)))))
    u = u + scale * vec_from_cells(ctx.nf_bins, config.band_spec.bins, u_sqrt)

    vel = u.clone()
    vel[:, 0] += float(np.float32(shear_rate)) * pos[:, 1]
    new_pos = pos + vel * float(np.float32(dt))
    tilt = state.tilt_xy if new_tilt is None else float(np.float32(new_tilt))
    new_pos, new_images = wrap(_box_of(config, tilt), new_pos, state.images)

    new_state = State(
        pos=new_pos, images=new_images, step=state.step + 1, tilt_xy=tilt,
        m_lanczos=int(m_used), nbr_overflow=state.nbr_overflow | overflow,
    )
    return new_state, {"velocities": vel, "nbr_overflow": overflow,
                       "m_lanczos": int(m_used)}


def brownian_displacement(config: StepConfig, pos, tilt_xy, step: int,
                          m_start: int, T, dt):
    """sqrt(2T/dt) M^{1/2} psi through the positive split, as one step
    draws it (wave part through the FFT pipeline, real part by Lanczos).
    Returns (u (N, 3), m_used, overflow mask)."""
    p = config.params
    pos = torch.from_numpy(np.array(pos, np.float32)).to(config.device)
    box = _box_of(config, tilt_xy)
    gen = step_generator(config, step)
    ctx, overflow = prepare_banded(config, pos, box)
    u_wave = _far_field(config, ctx, box, T, dt, gen, None)
    psi = _psi(config, ctx, gen, None)
    vnorm = torch.sqrt(torch.sum(psi * psi))
    ctx, w0 = build_mv(config, ctx, psi / vnorm)
    u_sqrt, m_used, hit_cap = lanczos.sqrt_mreal(
        lambda vt: mreal_t(config, ctx, vt), psi, p.error, m_start,
        config.m_max, w0=w0,
    )
    scale = float(np.float32(math.sqrt(2.0 * float(np.float32(T))
                                       / float(np.float32(dt)))))
    u_real = scale * vec_from_cells(ctx.nf_bins, config.band_spec.bins, u_sqrt)
    if hit_cap:
        overflow = overflow | OVF_LANCZOS
    return u_wave + u_real, m_used, overflow


def mobility(config: StepConfig, pos, forces, tilt_xy=0.0):
    """Deterministic U = M F: not ported yet (the with-forces slice)."""
    raise _not_ported("mobility() and the with-forces path")
