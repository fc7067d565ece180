"""The PSE Brownian-dynamics step and U = M F on the banded, blocked and
gather engines.

PyTorch counterpart of ``pse_tpu/integrator.py``: ``engine="banded"``
(with its occupancy classes), ``engine="blocked"`` (``make_config``'s
default) and
``engine="gather"`` (the neighbor-list engine, make_config's last
fallback), thermal or athermal, with or without external forces.  One
step:

  per-step near- and far-field data (banded: the column binnings, band
  windows and far-field factors; blocked: the 3-D cell binning, the pair
  blocks and the factors; gather: the neighbor list, its pair coefficients
  and the Gaussian taps) -> [forces: spread -> rfft -> Green] (+ Hermitian
  wave noise) -> irfft -> contract -> the first near-field matvec (banded:
  fused with the build of A, with two right-hand sides, the forces and the
  first Lanczos vector, when both exist; blocked and gather: M F is a
  matvec of its own) -> Lanczos M_real^{1/2} psi -> Euler update with
  shear advection -> wrap

``mobility`` is the deterministic U = M F of the same pieces.  Randomness is
keyed by (hash_seed(seed), step) on a ``torch.Generator`` of the step's
device, so a rerun on one device is bitwise equal and a step's draws do not
depend on history.

Each engine is an object (``engine_of(config)``: ``BandedEngine``,
``BlockedEngine``, ``GatherEngine``) with the JAX package's operators
(``prepare``, ``build_mv``, ``mreal_t``, ``f_slots_t``, ``slots_of_psi``,
``psi_result_to_particles``, ``spread``, ``contract``); ``step_impl`` and
``mobility_impl`` take one, so that ``parallel.halo`` (the banded near
field in x-slabs) and ``parallel.sharding`` (the near field split over
devices) stand in for it.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .box import Box, make_box, wrap
from .cellbins import (bin_columns, bin_particles, vec_from_cells,
                       vec_to_cells)
from .neighbors import NeighborSpec, build_neighbor_list, grow_spec, make_spec
from .params import PSEParams, ewald_table_on, gridk_arrays
from . import trace
from .ops import banded_nearfield as bdn
from .ops import blocked_farfield as bff
from .ops import blocked_nearfield as bnf
from .ops import column_farfield as cff
from .ops import farfield, lanczos, nearfield, noise
from .ops.farfield import apply_green
from .ops.chebyshev import ChebPair, fit_pair_functions

# Lanczos shrink-probe period: every K-th step starts the convergence test
# one iteration early so the persisted warm-start m can decrease.
M_SHRINK_PERIOD = 16

OVF_NF = 1        # near-field cell or column capacity
OVF_BAND = 2      # banded window width
OVF_FF = 4        # far-field cell capacity
OVF_LANCZOS = 8   # Lanczos m_max hit unconverged
OVF_NBR = 16      # gather-engine neighbor capacity
OVF_CLASS = 32    # banded occupancy-class capacities (falls back to 1 class)

ENGINES = ("banded", "blocked", "gather")

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
    """Static configuration of the step, with the JAX package's fields,
    defaults and order, and ``device`` last.  ``engine`` is "gather" (the
    default, with ``nbr_spec`` only, which every config carries),
    "banded" (with ``band_spec``) or "blocked" (with ``nf_spec``);
    ``colff_spec`` is the z-column far field and ``ff_spec`` the
    stored-weight far field the banded and blocked steps take where
    ``colff_spec`` is None.  ``thermal`` runs the Brownian branches,
    ``has_forces`` the deterministic M F path; ``shard_slabs`` is the halo
    slab count the config was built for."""

    params: PSEParams
    nbr_spec: NeighborSpec                 # gather-engine neighbor shapes
    thermal: bool = True
    m_max: int = 100                       # Lanczos cap (Brownian.cu:397)
    seed: int = 0
    engine: str = "gather"
    nf_spec: Optional[bnf.NfSpec] = None
    ff_spec: Optional[bff.FfSpec] = None
    cheb: Optional[ChebPair] = None
    has_forces: bool = True
    band_spec: Optional[bdn.BandSpec] = None
    colff_spec: Optional[cff.ColFfSpec] = None
    shard_slabs: int = 1
    device: str = "cuda"

    def __post_init__(self):
        if not self.thermal and not self.has_forces:
            raise ValueError(
                "StepConfig with thermal=False requires has_forces=True "
                "(an athermal zero-force step is M·0, like the reference)"
            )
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, not "
                             f"{self.engine!r}")
        if self.engine == "gather":
            return
        missing = [name for name, v in (
            ("band_spec" if self.engine == "banded" else "nf_spec",
             self.band_spec if self.engine == "banded" else self.nf_spec),
            ("cheb", self.cheb),
            ("colff_spec or ff_spec", self.colff_spec or self.ff_spec))
            if v is None]
        if missing:
            raise ValueError(
                f"StepConfig(engine={self.engine!r}) needs "
                f"{', '.join(missing)} (integrator.make_config builds them)")


def _cheb_tol(block_dtype: str) -> float:
    """Pair-function fit tolerance matched to the block dtype (bf16 blocks
    round every entry at ~4e-3 relative anyway)."""
    return 3e-5 if block_dtype == "bfloat16" else 1e-6


def _size_slab_classes(band_spec, shard_slabs, n_particles, counts):
    """``band_spec`` with its per-shard occupancy classes for the halo
    engine: sized on the extended local slab grid ((ncx / D + 2) ncy
    columns) to cover the worst slab, from the global measured histogram
    ``counts`` or, for None, the Poisson model.  Computed for one slab
    too, as in the JAX package."""
    ncx, ncy, _ = band_spec.bins.n_cells
    nxl = ncx // shard_slabs
    loc = band_spec._replace(
        bins=band_spec.bins._replace(n_cells=(nxl + 2, ncy, 1)),
        classes=None,              # the one-device classes are global-grid
    )
    slab_counts = (None if counts is None else
                   bdn.make_slab_counts(band_spec, shard_slabs, counts))
    n_loc = int(round(n_particles * (nxl + 2) / ncx))
    loc = bdn.make_band_classes(loc, n_loc, slab_counts)
    return band_spec._replace(slab_classes=loc.classes)


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
    """Build a StepConfig with the JAX package's shapes and engine choice:
    banded falls back to blocked where the geometry is too small to band,
    and blocked to gather where the grid is too small to block.

    ``max_neighbors`` and ``nbr_subdiv`` size the gather engine's neighbor
    list (``nbr_spec``, built for every engine as in the JAX package).
    ``positions``: the (N, 3) initial configuration on the host, whose
    measured column histogram sizes the banded engine's occupancy classes
    (without it, a Poisson model does).  ``shard_slabs``: the number of
    x-slabs the halo engine (``parallel.halo``) splits the banded column
    grid into; ncx is rounded down to a multiple of it, and the one-device
    occupancy classes are sized only for one slab (``slab_classes``, the
    slabs' own, for every count)."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, not {engine!r}")
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
    nbr_spec = make_spec(
        n_particles, params.L, params.ewald_cut, max_tilt=max_tilt,
        max_neighbors=max_neighbors, subdiv=nbr_subdiv,
    )
    ff_spec = band_spec = nf_spec = None
    if engine in ("banded", "blocked"):
        ff_spec = bff.make_ff_spec(params, n_particles, ff_weight_dtype,
                                   device=device)
    if engine == "banded":
        band_spec = bdn.make_band_spec(
            n_particles, params.L, params.ewald_cut, max_tilt=max_tilt,
            block_dtype=block_dtype, ncx_multiple=shard_slabs,
        )
        if band_spec is not None:
            counts = None
            if positions is not None:
                counts = bdn.measure_col_counts(band_spec, positions,
                                                params.L)
            if shard_slabs == 1:
                band_spec = bdn.make_band_classes(band_spec, n_particles,
                                                  counts)
            band_spec = _size_slab_classes(band_spec, shard_slabs,
                                           n_particles, counts)
        if ff_spec is None or band_spec is None:
            engine, band_spec = "blocked", None   # too small to band
    if engine == "blocked":
        if ff_spec is None:
            engine = "gather"                     # too small to block
        else:
            nf_spec = bnf.make_nf_spec(
                n_particles, params.L, params.ewald_cut, max_tilt=max_tilt,
                block_dtype=block_dtype,
            )
    if not thermal and not has_forces:
        has_forces = True               # an athermal step is M·0
    cheb = colff_spec = None
    if engine != "gather":
        # the gather engine interpolates params.ewald_table instead
        cheb = fit_pair_functions(
            params.xi, params.ewald_dr, params.ewald_cut, params.radius,
            tol=_cheb_tol(block_dtype),
        )
        colff_spec = cff.make_col_spec(params, n_particles, ff_weight_dtype,
                                       device=device)
    return StepConfig(
        params=params, nbr_spec=nbr_spec, thermal=bool(thermal), m_max=m_max,
        seed=seed, engine=engine, nf_spec=nf_spec, ff_spec=ff_spec,
        cheb=cheb, has_forces=bool(has_forces), band_spec=band_spec,
        colff_spec=colff_spec, shard_slabs=shard_slabs,
        device=str(torch.device(device)),
    )


def _grown(spec, factor: float, multiple: int = 8):
    """``spec`` with its bins' cap grown by ``factor`` to a multiple."""
    if spec is None:
        return None
    cap = int(-(-spec.bins.cap * factor // multiple)) * multiple
    return spec._replace(bins=spec.bins._replace(cap=cap))


def grow_config(config: StepConfig, factor: float = 1.4,
                flags: int | None = None) -> StepConfig:
    """Enlarge the capacities the overflow mask ``flags`` names (None grows
    all): the neighbor list for OVF_NBR, m_max for OVF_LANCZOS, the
    far-field caps for OVF_FF, the blocked cell cap for OVF_NF, and on the
    banded engine the band window (or, at W = 256, the row tile) for
    OVF_BAND and the column cap for OVF_NF.  OVF_CLASS drops the
    occupancy classes to the one safe class, and so does a band that
    grows (its tile counts change)."""
    if flags is None:
        flags = (OVF_NF | OVF_BAND | OVF_FF | OVF_LANCZOS | OVF_NBR
                 | OVF_CLASS)
    flags = int(flags)
    changes = {}
    if flags & OVF_NBR and config.nbr_spec is not None:
        changes["nbr_spec"] = grow_spec(config.nbr_spec, factor)
    if flags & OVF_LANCZOS and config.thermal:
        changes["m_max"] = min(max(config.m_max * 2, config.m_max + 8), 100)
    if flags & OVF_NF and config.nf_spec is not None:
        changes["nf_spec"] = _grown(config.nf_spec, factor)
    if flags & OVF_FF:
        changes["ff_spec"] = _grown(config.ff_spec, factor)
        changes["colff_spec"] = _grown(config.colff_spec, factor)
    if (flags & OVF_CLASS and config.band_spec is not None
            and (config.band_spec.classes is not None
                 or config.band_spec.slab_classes is not None)):
        changes["band_spec"] = config.band_spec._replace(
            classes=None, slab_classes=None)
    if config.band_spec is not None and flags & (OVF_NF | OVF_BAND):
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
            classes=None, slab_classes=None,
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
    ff_bins: object        # far-field bins
    j0: torch.Tensor       # (O, C, T) window starts (O = 9 on CPU, 5 on CUDA)
    n_valid: torch.Tensor  # (C,)
    zsh: torch.Tensor      # (O, C, T) window z image shifts
    ff_factors: object     # cff.ColFactors, or the stored far-field weights
    tilt: float
    blocks: object = None  # (1, C, 2, S, 5W) after build_mv (None on CPU;
                           #  the per-class tuple when spec.classes is set)
    nf_f: object = None    # (3, C, cap) forces binned with the near field
    ff_f: object = None    # (3, C_ff, cap_ff) ditto on the far-field grid
    cls: object = None     # (perm, inv) occupancy-class packing (CUDA), or
                           #  None


class BlockedCtx(NamedTuple):
    """Per-step data of the blocked engine."""

    nf_bins: object        # 3-D cell bins
    ff_bins: object        # far-field bins
    blocks: object         # (noff, 6, C, cap, cap) pair blocks
    ff_factors: object     # cff.ColFactors, or the stored far-field weights
    nf_f: object = None    # (3, C, cap) forces binned with the near field
    ff_f: object = None    # (3, C_ff, cap_ff) ditto on the far-field grid


class GatherCtx(NamedTuple):
    """Per-step data of the gather engine."""

    coeffs: nearfield.PairCoeffs   # the neighbor pairs' coefficients
    taps: farfield.SpreadTaps      # the Gaussian taps, shared far field
    nf_f: object = None            # (3, N) forces (the engine's slots)
    ff_f: object = None            # (N, 3) forces for the tap spread


def _ovf(flag: torch.Tensor, bit: int) -> torch.Tensor:
    return flag.to(torch.int32) * bit


def _nf_bin_spec(config: StepConfig):
    """The BinSpec of the near field's slot layout."""
    return (config.band_spec if config.engine == "banded"
            else config.nf_spec).bins


def _ff_bin_spec(config: StepConfig):
    """The BinSpec the far field bins the particles with."""
    return (config.colff_spec or config.ff_spec).bins


def _bin_both(config: StepConfig, pos, box: Box, binner, forces):
    """The near-field binning (by ``binner``) and the far-field one, with
    ``forces`` (N, 3), when given, binned by both fills (zero in pad
    slots): (nf_bins, ff_bins, nf_f, ff_f)."""
    nf_spec, ff_spec = _nf_bin_spec(config), _ff_bin_spec(config)
    with trace.span("prepare.bin"):
        if forces is None:
            nf_bins = binner(pos, box, nf_spec)
            ff_bins = bin_particles(pos, box, ff_spec)
            return nf_bins, ff_bins, None, None
        nf_bins, nf_f = binner(pos, box, nf_spec, values=forces)
        ff_bins, ff_f = bin_particles(pos, box, ff_spec, values=forces)
        return nf_bins, ff_bins, nf_f, ff_f


def _ff_shared(config: StepConfig, ff_bins, box: Box):
    """Per-step far-field data: the contract's z-column factors, or the
    stored weights that spread and contract share (None when the spec
    builds them per use)."""
    p = config.params
    with trace.span("prepare.ff_factors"):
        if config.colff_spec is not None:
            return cff.build_col_factors(ff_bins, box, config.colff_spec, p)
        if config.ff_spec.store_weights:
            return bff.build_weights(ff_bins, box, config.ff_spec, p)
        return None


class _Engine:
    """An engine's config and home device (config.device unless given)."""

    two_rhs = False        # build_mv takes M F as a second right-hand side

    def __init__(self, config: StepConfig, device=None):
        self.config = config
        self.device = torch.device(config.device if device is None
                                   else device)

    def build_mv(self, ctx, ft):
        """The step's first near-field matvec, (ctx, M_real ft): a plain
        ``mreal_t`` on what prepare built."""
        return ctx, self.mreal_t(ctx, ft)


class _CellEngine(_Engine):
    """What the banded and blocked engines share: the near field's slots
    are a cell binning's (3, C, cap), and the far field is the z-column
    one (or the stored-weight one where config.colff_spec is None)."""

    def f_slots_t(self, ctx, values):
        """(N, 3) particle values -> (3, C, cap) slots."""
        return vec_to_cells(ctx.nf_bins, _nf_bin_spec(self.config), values)

    def slots_of_psi(self, ctx, generator, uniforms):
        """psi (3, C, cap) in the near field's slots, zero in pad slots."""
        spec = _nf_bin_spec(self.config)
        mask = ctx.nf_bins.mask
        u = noise.particle_noise_t((spec.n_cells_total, spec.cap),
                                   mask.device, generator, uniforms)
        return u * mask

    def psi_result_to_particles(self, ctx, cells):
        """(3, C, cap) slots -> (N, 3)."""
        return vec_from_cells(ctx.nf_bins, _nf_bin_spec(self.config), cells)

    def spread(self, ctx, box: Box):
        """The binned forces ctx.ff_f onto the grid (3, Nx, Ny, Nz)."""
        cfg = self.config
        if cfg.colff_spec is not None:
            return cff.spread_col_kernel(
                ctx.ff_f, cfg.colff_spec, cfg.params,
                cff.spread_nodes(ctx.ff_bins, box, cfg.params), box.tilt_xy)
        return bff.spread_blocked(ctx.ff_bins, ctx.ff_f, box, cfg.ff_spec,
                                  cfg.params, ctx.ff_factors)

    def contract(self, ctx, box: Box, grid_v):
        """Grid velocities (3, Nx, Ny, Nz) -> (N, 3)."""
        cfg = self.config
        u_cells = (cff.contract_col_kernel(grid_v, cfg.colff_spec, cfg.params,
                                           ctx.ff_factors)
                   if cfg.colff_spec is not None else bff.contract_blocked(
                       ctx.ff_bins, grid_v, box, cfg.ff_spec, cfg.params,
                       ctx.ff_factors))
        return vec_from_cells(ctx.ff_bins, _ff_bin_spec(cfg), u_cells)


class BandedEngine(_CellEngine):
    """The banded engine: windows per step, the fused build of A with the
    first matvec (one or two right-hand sides), the stored-A matvec."""

    two_rhs = True

    def prepare(self, pos, box: Box, forces=None):
        """Binnings, band windows and far-field factors; returns (ctx, the
        overflow mask as a () int32 tensor).  ``forces`` (N, 3), when
        given, are binned by both fills into ctx.nf_f / ctx.ff_f (zero in
        pad slots)."""
        cfg = self.config
        bs = cfg.band_spec
        nf_bins, ff_bins, nf_f, ff_f = _bin_both(cfg, pos, box, bin_columns,
                                                 forces)
        # the CUDA kernels read the stored half stencil's windows only; the
        # plain matvec (CPU) gathers all 9 offsets
        offs = (bs.offsets if pos.device.type == "cpu"
                else bs.offsets[:bdn.N_HALF])
        with trace.span("prepare.windows"):
            j0, n_valid, band_overflow, zsh = bdn.compute_windows(
                nf_bins, bs, box, cfg.params.ewald_cut, offsets=offs)
        factors = _ff_shared(cfg, ff_bins, box)
        overflow = (_ovf(nf_bins.overflow, OVF_NF)
                    | _ovf(ff_bins.overflow, OVF_FF)
                    | _ovf(band_overflow, OVF_BAND))
        cls = None
        if bs.classes is not None and pos.device.type != "cpu":
            # the kernels pack A by occupancy class; the plain matvec (CPU)
            # ignores the classes, as the JAX package's off-TPU path does
            with trace.span("prepare.classes"):
                perm, inv, class_overflow = bdn.class_assignment(bs, n_valid)
            cls = (perm, inv)
            overflow = overflow | _ovf(class_overflow, OVF_CLASS)
        return BandedCtx(nf_bins, ff_bins, j0, n_valid, zsh, factors,
                         box.tilt_xy, nf_f=nf_f, ff_f=ff_f, cls=cls), overflow

    def _band_args(self, ctx: BandedCtx):
        p = self.config.params
        return (ctx.nf_bins, ctx.tilt, self.config.band_spec, self.config.cheb,
                p.L, p.ewald_cut, p.ewald_dr, ctx.j0, ctx.n_valid, ctx.zsh)

    def build_mv(self, ctx, ft):
        """The fused build of A + matvec, for ft (3, C, S) or two
        right-hand sides (6, C, S): (ctx with its blocks, M_real ft)."""
        blocks, u = bdn.build_mv_banded(*self._band_args(ctx), ft,
                                        self.config.params.self_mobility,
                                        pack=ctx.cls)
        return ctx._replace(blocks=blocks), u

    def mreal_t(self, ctx, cells):
        """M_real cells, (3, C, S) or (6, C, S), from the stored A."""
        return bdn.matvec_banded(ctx.blocks, *self._band_args(ctx), cells,
                                 self.config.params.self_mobility,
                                 pack=ctx.cls)

    def mreal_t2(self, ctx, cells):
        """The two-RHS matvec (6, C, S) on one read of A."""
        if cells.shape[0] != 6:
            raise ValueError("mreal_t2 takes two right-hand sides (6, C, S)")
        return self.mreal_t(ctx, cells)


class BlockedEngine(_CellEngine):
    """The blocked engine: pair blocks of a 3-D cell binning per step."""

    def prepare(self, pos, box: Box, forces=None):
        """Both binnings (3-D cells for the near field), the pair blocks
        and the far-field factors; returns (ctx, the overflow mask)."""
        cfg, p = self.config, self.config.params
        nf_bins, ff_bins, nf_f, ff_f = _bin_both(cfg, pos, box, bin_particles,
                                                 forces)
        with trace.span("prepare.pair_blocks"):
            blocks = bnf.build_pair_blocks(nf_bins, box, cfg.nf_spec,
                                           cfg.cheb, p.ewald_cut, p.ewald_dr)
        factors = _ff_shared(cfg, ff_bins, box)
        overflow = (_ovf(nf_bins.overflow, OVF_NF)
                    | _ovf(ff_bins.overflow, OVF_FF))
        ctx = BlockedCtx(nf_bins, ff_bins, blocks, factors, nf_f, ff_f)
        return ctx, overflow

    def mreal_t(self, ctx, cells):
        """M_real cells (3, C, cap)."""
        return bnf.matvec_cells(ctx.blocks, self.config.nf_spec, ctx.nf_bins,
                                cells, self.config.params.self_mobility)


class GatherEngine(_Engine):
    """The gather engine: a neighbor list, its pair coefficients and the
    Gaussian taps per step; vectors in particle layout (3, N)."""

    def prepare(self, pos, box: Box, forces=None):
        """The neighbor list, its pair coefficients and the Gaussian taps;
        returns (ctx, the overflow mask).  ``forces`` (N, 3) are kept as
        they are (ctx.ff_f) and transposed (ctx.nf_f)."""
        cfg, p = self.config, self.config.params
        with trace.span("prepare.bin"):
            nlist = build_neighbor_list(pos, box, cfg.nbr_spec)
        with trace.span("prepare.pair_coeffs"):
            coeffs = nearfield.precompute_pair_coeffs(
                pos, nlist.idx, box, ewald_table_on(p, pos.device),
                p.ewald_cut, p.ewald_dr, p.ewald_n)
        with trace.span("prepare.ff_factors"):
            taps = farfield.compute_taps(pos, box, p)
        nf_f = None if forces is None else forces.t()
        ctx = GatherCtx(coeffs, taps, nf_f, forces)
        return ctx, _ovf(nlist.overflow, OVF_NBR)

    def mreal_t(self, ctx, ft):
        """M_real ft, (3, N) in and out."""
        return nearfield.mreal_matvec_t(ctx.coeffs, ft,
                                        self.config.params.self_mobility)

    def f_slots_t(self, ctx, values):
        return values.t()

    def slots_of_psi(self, ctx, generator, uniforms):
        """psi (3, N)."""
        nf = ctx.coeffs.nbr
        return noise.particle_noise_t((nf.shape[0],), nf.device, generator,
                                      uniforms)

    def psi_result_to_particles(self, ctx, cells):
        return cells.t()

    def spread(self, ctx, box: Box):
        return farfield.spread(ctx.taps, ctx.ff_f, self.config.params)

    def contract(self, ctx, box: Box, grid_v):
        return farfield.contract(ctx.taps, grid_v, self.config.params)


_ENGINES = {"banded": BandedEngine, "blocked": BlockedEngine,
            "gather": GatherEngine}


def engine_of(config: StepConfig):
    """The config's own engine on config.device (the one ``step``,
    ``mobility`` and ``brownian_displacement`` run)."""
    return _ENGINES[config.engine](config)


def _far_field(config: StepConfig, eng, ctx, box: Box, device, noise_args):
    """Wave-space velocities (N, 3): [spread the binned forces ctx.ff_f ->
    rfft -> Green] (+ Hermitian noise when ``noise_args`` = (T, dt,
    generator, uniforms)) -> irfft -> contract."""
    p = config.params
    kvec, W = gridk_arrays(p, box.tilt_xy, device, half=True)
    ghat = None
    if ctx.ff_f is not None:
        with trace.span("far_field.spread"):
            grid_f = eng.spread(ctx, box)
        with trace.span("far_field.fft"):
            fhat = torch.fft.rfftn(grid_f, dim=(1, 2, 3))
        with trace.span("far_field.green"):
            ghat = apply_green(fhat, kvec, W)
    if noise_args is not None:
        T, dt, generator, uniforms = noise_args
        with trace.span("far_field.fft"):
            nh = noise.wave_space_noise_hat_half(p, kvec, W, T, dt,
                                                 generator, uniforms)
            ghat = nh if ghat is None else ghat + nh
    with trace.span("far_field.ifft"):
        grid_v = torch.fft.irfftn(ghat, s=(p.Nx, p.Ny, p.Nz),
                                  dim=(1, 2, 3)).to(torch.float32)
    with trace.span("far_field.contract"):
        return eng.contract(ctx, box, grid_v)


def _velocity_scale(T, dt) -> float:
    """sqrt(2 T / dt) in float32."""
    return float(np.float32(math.sqrt(2.0 * float(np.float32(T))
                                      / float(np.float32(dt)))))


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def step(config: StepConfig, state: State, forces, T, dt, shear_rate,
         new_tilt=None, uniforms=None):
    """Advance one Euler-Maruyama step (Stokes.cu:137-192 semantics).

    forces: (N, 3) forces at the current positions (read only when
    config.has_forces), or None for zero forces; T: temperature (the thermal branch is
    config.thermal); dt: timestep; shear_rate: current rate (adds rate*y to
    the x velocity); new_tilt: next-step box tilt (None keeps the current).
    ``uniforms``: optional (psi (3, C, cap), wave (6, Nx, Ny, Nz//2+1)) raw
    draws replacing the step's generator (cross-package tests); on the
    gather engine psi is (3, N).

    Returns (new_state, info) with info velocities (N, 3), nbr_overflow
    (() int32 tensor) and m_lanczos (int)."""
    return step_impl(config, engine_of(config), state, forces, T, dt,
                     shear_rate, new_tilt, uniforms)


def _matvec(eng, ctx):
    """M_real in the engine's slots on ``ctx``, each call a
    ``near_field.matvec`` span."""
    def matvec_t(vt):
        with trace.span("near_field.matvec"):
            return eng.mreal_t(ctx, vt)
    return matvec_t


def _build_mv(eng, ctx, ft):
    """``eng.build_mv(ctx, ft)`` in a ``near_field.build_mv`` span, its
    right-hand sides (three rows of ``ft`` each) counted in
    ``near_field.rhs``."""
    trace.count("near_field.rhs", ft.shape[0] // 3)
    with trace.span("near_field.build_mv"):
        return eng.build_mv(ctx, ft)


def step_impl(config: StepConfig, eng, state: State, forces, T, dt,
              shear_rate, new_tilt=None, uniforms=None):
    """``step`` with the engine ``eng`` (``engine_of(config)``, or a halo
    or sharded engine from ``parallel/``); the state lies on its home
    device."""
    with trace.span("step"):
        return _step_body(config, eng, state, forces, T, dt, shear_rate,
                          new_tilt, uniforms)


def _step_body(config: StepConfig, eng, state: State, forces, T, dt,
               shear_rate, new_tilt, uniforms):
    p = config.params
    pos = state.pos
    box = _box_of(config, state.tilt_xy)
    gen = None
    if config.thermal and uniforms is None:
        gen = step_generator(config, state.step)
    u_psi, u_wave = (None, None) if uniforms is None else uniforms
    f = None
    if config.has_forces:
        f = (torch.zeros_like(pos) if forces is None
             else _as_f32(forces, pos.device))

    with trace.span("prepare"):
        ctx, overflow = eng.prepare(pos, box, f)
    with trace.span("far_field"):
        u = _far_field(config, eng, ctx, box, pos.device,
                       (T, dt, gen, u_wave) if config.thermal else None)

    m_used = state.m_lanczos
    if config.thermal:
        psi = eng.slots_of_psi(ctx, gen, u_psi)
        vnorm = torch.sqrt(torch.sum(psi * psi))
        if config.has_forces and eng.two_rhs:
            # M F rides the build as a second right-hand side: one pass
            # over A covers the build, M F and the first Lanczos matvec
            ctx, u0 = _build_mv(eng, ctx, torch.cat([ctx.nf_f, psi / vnorm]))
            u = u + eng.psi_result_to_particles(ctx, u0[0:3])
            w0 = u0[3:6]
        else:
            ctx, w0 = _build_mv(eng, ctx, psi / vnorm)
            if config.has_forces:
                # blocked and gather: M F is a matvec of its own on the
                # forces in the engine's slots
                with trace.span("near_field.matvec"):
                    mf = eng.mreal_t(ctx, ctx.nf_f)
                u = u + eng.psi_result_to_particles(ctx, mf)
        probe = int(state.step % M_SHRINK_PERIOD == 0)
        with trace.span("lanczos"):
            u_sqrt, m_used, hit_cap = lanczos.sqrt_mreal(
                _matvec(eng, ctx), psi, p.error,
                max(state.m_lanczos - probe, 2), config.m_max, w0=w0,
            )
        if hit_cap:
            overflow = overflow | OVF_LANCZOS
        u = u + _velocity_scale(T, dt) * eng.psi_result_to_particles(
            ctx, u_sqrt)
    else:
        ctx, uF = _build_mv(eng, ctx, ctx.nf_f)
        u = u + eng.psi_result_to_particles(ctx, uF)

    with trace.span("update"):
        vel = u.clone()
        vel[:, 0] += float(np.float32(shear_rate)) * pos[:, 1]
        new_pos = pos + vel * float(np.float32(dt))
        tilt = (state.tilt_xy if new_tilt is None
                else float(np.float32(new_tilt)))
        new_pos, new_images = wrap(_box_of(config, tilt), new_pos,
                                   state.images)

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
    eng = engine_of(config)
    with trace.span("step"):
        pos = _as_f32(pos, eng.device)
        box = _box_of(config, tilt_xy)
        gen = step_generator(config, step)
        with trace.span("prepare"):
            ctx, overflow = eng.prepare(pos, box)
        with trace.span("far_field"):
            u_wave = _far_field(config, eng, ctx, box, pos.device,
                                (T, dt, gen, None))
        psi = eng.slots_of_psi(ctx, gen, None)
        vnorm = torch.sqrt(torch.sum(psi * psi))
        ctx, w0 = _build_mv(eng, ctx, psi / vnorm)
        with trace.span("lanczos"):
            u_sqrt, m_used, hit_cap = lanczos.sqrt_mreal(
                _matvec(eng, ctx), psi, p.error, m_start, config.m_max,
                w0=w0,
            )
        u_real = _velocity_scale(T, dt) * eng.psi_result_to_particles(
            ctx, u_sqrt)
        if hit_cap:
            overflow = overflow | OVF_LANCZOS
        return u_wave + u_real, m_used, overflow


def mobility(config: StepConfig, pos, forces, tilt_xy=0.0):
    """Deterministic U = M F, the public validation matvec
    (gpu_stokes_Mobility_wrap, Mobility.cu:729-782).

    Returns (velocities (N, 3), the capacity overflow mask as a () int32
    tensor)."""
    return mobility_impl(config, engine_of(config), pos, forces, tilt_xy)


def mobility_impl(config: StepConfig, eng, pos, forces, tilt_xy=0.0):
    """``mobility`` with the engine ``eng``, on its home device
    ``eng.device``."""
    with trace.span("step"):
        pos = _as_f32(pos, eng.device)
        forces = _as_f32(forces, eng.device)
        box = _box_of(config, tilt_xy)
        with trace.span("prepare"):
            ctx, overflow = eng.prepare(pos, box, forces)
        ctx, u0 = _build_mv(eng, ctx, ctx.nf_f)
        u_real = eng.psi_result_to_particles(ctx, u0)
        with trace.span("far_field"):
            u_wave = _far_field(config, eng, ctx, box, pos.device, None)
        return u_real + u_wave, overflow
