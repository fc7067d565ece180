"""Execution over a mesh of devices in one process.

PyTorch counterpart of ``pse_tpu/parallel/sharding.py``.  A ``Mesh`` is a
tuple of ``torch.device`` along one axis; a device may repeat, so D slabs
or shards can run on one card.  The JAX package jits the step once over
the mesh and lets GSPMD shard every array (particles on the particle
dimension, the FFT grids on x).  Torch has no GSPMD, so the port places
the step's data by design, not by propagation:

  * the global particle arrays, the Lanczos vectors, the binnings and the
    whole far field (spread, FFTs, contract) live on the mesh's home
    device, ``devices[0]``; the FFT grid is not split over x;
  * only the near field is split, through an engine that ``step_impl`` /
    ``mobility_impl`` take in place of the config's own:
      - gather: the pair coefficients' rows in D contiguous ranges, one per
        device; each device computes its rows of M_real f from a copy of
        f, and the rows are concatenated in order (bitwise the one-device
        matvec: every row is summed as there);
      - blocked: the half stencil's offsets in D contiguous ranges, each
        range's pair blocks built and kept on its device (so the blocks
        are never whole on one device); each device returns its partial
        u, summed on the home device in device order (no float atomics);
      - banded: the config's own engine, unsplit, on the home device; its
        split is ``parallel.halo.make_halo_step`` (x-slabs with halos).

Kernels launch on the device of their tensors under ``torch.cuda.device``,
so that several cards each run their own part.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from .. import integrator, trace
from ..cellbins import CellBins, bin_particles
from ..integrator import OVF_FF, OVF_NF, State, StepConfig, _ovf
from ..ops import blocked_nearfield as bnf
from ..ops import nearfield


class Mesh(NamedTuple):
    """A 1-D mesh: the devices along ``axis``, ``devices[0]`` the home."""

    devices: tuple
    axis: str = "dp"

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    """A mesh over ``devices`` (torch devices or names; repeats allowed),
    by default every visible CUDA device."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass the devices "
                               "(e.g. [torch.device('cpu')] * 4)")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    return Mesh(devices, axis)


def particle_sharding(mesh: Mesh, axis: str = "dp") -> torch.device:
    """Where the particle arrays live: the home device (the engine splits
    the near field, not the arrays)."""
    return mesh.home


def replicated(mesh: Mesh) -> torch.device:
    """Where whole arrays live: the home device."""
    return mesh.home


def on_device(device: torch.device):
    """The context that makes ``device`` current for kernel launches."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_state(state: State, mesh: Mesh, axis: str = "dp") -> State:
    """``state`` with its tensors on the mesh's home device."""
    dev = mesh.home
    return state._replace(pos=state.pos.to(dev), images=state.images.to(dev),
                          nbr_overflow=state.nbr_overflow.to(dev))


def _check_mesh(config: StepConfig, mesh: Mesh, axis: str) -> int:
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    if torch.device(config.device).type != mesh.home.type:
        raise ValueError(f"config built for {config.device}, mesh home "
                         f"{mesh.home}: build the config for the mesh's "
                         f"devices")
    return mesh.shape[axis]


def _ranges(n: int, d: int):
    """[lo, hi) of n items in d contiguous ranges, the first ones longer;
    empty ranges dropped."""
    edges = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(n), d)])
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]


class ShardedBlockedCtx(NamedTuple):
    """The blocked engine's per-step data with its pair blocks in parts."""

    nf_bins: object
    ff_bins: object
    parts: tuple           # (device, nf_spec of its offsets, its copy of
                           #  nf_bins, its pair blocks) per offset range
    ff_factors: object
    nf_f: object = None
    ff_f: object = None


class ShardedGatherCtx(NamedTuple):
    """The gather engine's per-step data with its rows in parts."""

    coeffs: nearfield.PairCoeffs
    taps: object
    nf_f: object = None
    ff_f: object = None
    parts: tuple = ()      # (device, first row, its rows of coeffs)


class ShardedBlockedEngine(integrator.BlockedEngine):
    """The blocked engine with its half stencil split over the mesh: each
    device builds and applies the pair blocks of its range of offsets."""

    def __init__(self, config: StepConfig, mesh: Mesh):
        super().__init__(config, mesh.home)
        self.mesh = mesh
        offs = tuple(config.nf_spec.offsets)
        self.specs = [(dev, config.nf_spec._replace(offsets=offs[a:b]))
                      for dev, (a, b) in zip(
                          mesh.devices, _ranges(len(offs), len(mesh.devices)))]

    def prepare(self, pos, box, forces=None):
        """``BlockedEngine.prepare`` with each range's pair blocks built on
        its device."""
        cfg, p = self.config, self.config.params
        nf_bins, ff_bins, nf_f, ff_f = integrator._bin_both(
            cfg, pos, box, bin_particles, forces)
        parts = []
        for dev, spec in self.specs:
            with on_device(dev):
                bins = CellBins(*(t.to(dev) for t in nf_bins[:4]), None,
                                None, None, None)
                with trace.span("prepare.pair_blocks"):
                    blocks = bnf.build_pair_blocks(
                        bins, box, spec, cfg.cheb, p.ewald_cut, p.ewald_dr)
                parts.append((dev, spec, bins, blocks))
        factors = integrator._ff_shared(cfg, ff_bins, box)
        overflow = (_ovf(nf_bins.overflow, OVF_NF)
                    | _ovf(ff_bins.overflow, OVF_FF))
        ctx = ShardedBlockedCtx(nf_bins, ff_bins, tuple(parts), factors, nf_f,
                                ff_f)
        return ctx, overflow

    def mreal_t(self, ctx, cells):
        """The parts' u summed on the home device in device order (the
        self term with the first part)."""
        u = None
        for dev, spec, bins, blocks in ctx.parts:
            with on_device(dev):
                part = bnf.matvec_cells(
                    blocks, spec, bins, cells.to(dev),
                    self.config.params.self_mobility if u is None else 0.0,
                ).to(self.device)
            u = part if u is None else u + part
        return u


class ShardedGatherEngine(integrator.GatherEngine):
    """The gather engine with its pair coefficients' rows split over the
    mesh: each device computes its particles' rows of M_real f."""

    def __init__(self, config: StepConfig, mesh: Mesh):
        super().__init__(config, mesh.home)
        self.mesh = mesh

    def prepare(self, pos, box, forces=None):
        """``GatherEngine.prepare`` with each device's rows of the pair
        coefficients copied to it."""
        ctx, overflow = super().prepare(pos, box, forces)
        coeffs = ctx.coeffs
        parts = tuple(
            (dev, a, nearfield.PairCoeffs(*(t[a:b].to(dev) for t in coeffs)))
            for dev, (a, b) in zip(self.mesh.devices,
                                   _ranges(coeffs.nbr.shape[0],
                                           len(self.mesh.devices))))
        return ShardedGatherCtx(*ctx, parts=parts), overflow

    def mreal_t(self, ctx, ft):
        rows = []
        for dev, row0, coeffs in ctx.parts:
            with on_device(dev):
                rows.append(nearfield.mreal_matvec_t(
                    coeffs, ft.to(dev), self.config.params.self_mobility,
                    row0).to(self.device))
        return torch.cat(rows, dim=1)


def make_sharded_engine(config: StepConfig, mesh: Mesh, axis: str = "dp"):
    """The config's engine with its near field split over ``mesh`` (the
    banded engine unsplit on the home device)."""
    _check_mesh(config, mesh, axis)
    if config.engine == "gather":
        return ShardedGatherEngine(config, mesh)
    if config.engine == "blocked":
        return ShardedBlockedEngine(config, mesh)
    return integrator.BandedEngine(config, mesh.home)


def make_sharded_step(config: StepConfig, mesh: Mesh, axis: str = "dp"):
    """The PSE step with the near field split over ``mesh``.

    Returns run(state, forces, T, dt, shear_rate, new_tilt=None,
    uniforms=None), ``integrator.step``'s call (new_tilt None keeps the
    current tilt); the state is placed on the home device."""
    eng = make_sharded_engine(config, mesh, axis)

    def run(state, forces, T, dt, shear_rate, new_tilt=None, uniforms=None):
        return integrator.step_impl(config, eng, shard_state(state, mesh),
                                    forces, T, dt, shear_rate, new_tilt,
                                    uniforms)

    return run


def make_sharded_mobility(config: StepConfig, mesh: Mesh, axis: str = "dp"):
    """U = M F with the near field split over ``mesh``: run(pos, forces,
    tilt_xy=0.0) -> (velocities (N, 3), overflow mask) on the home
    device."""
    eng = make_sharded_engine(config, mesh, axis)

    def run(pos, forces, tilt_xy=0.0):
        return integrator.mobility_impl(config, eng, pos, forces, tilt_xy)

    return run
