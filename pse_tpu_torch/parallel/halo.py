"""The banded near field in x-slabs with halos, one slab per mesh device.

PyTorch counterpart of ``pse_tpu/parallel/halo.py``.  The banded column
grid (C = ncx ncy columns, x-major) is split along x into D slabs of nxl =
ncx / D column layers.  Each slab works on its layers plus one periodic
halo layer per side, the global x-layers [d nxl - 1, (d + 1) nxl] mod ncx
(the geometry of ``make_slab_counts``), so that every kernel call is local
to its device: the halo rows are throwaway duplicates that cost 2 / nxl
more build work.  Per step, each slab on its device:

  * takes its extended layers of the global column binning (``exchange_x``;
    x coordinates seam-shifted by -Lx on slab 0's left halo and +Lx on
    slab D - 1's right halo, so that the slab's coordinates are physically
    contiguous and the kernels' per-column x image shift never applies to
    an interior column's pairs);
  * computes its band windows, raising the band overflow only from its
    interior columns (x in [1, nxl]), and on CUDA, with slab occupancy
    classes, packs its columns by class (``class_assignment``);
  * runs the fused build of A with the first matvec once (``build_mv``, one
    or two right-hand sides) and the stored-A matvec in every Lanczos
    iteration; its A stays on its device for the step.

After each near-field call the interior [:, 1:-1] in x comes back to the
home device and the slabs are concatenated in order.  The binnings, the far
field, the Lanczos vectors and the update stay global on the home device
(``parallel.sharding``); the halo engine swaps in for the banded engine in
``integrator.step_impl`` / ``mobility_impl``.  On the CPU the wrappers run
their plain versions (all 9 offsets, classes ignored), as the JAX package's
off-TPU path does.  The JAX package moves one halo layer per side with
``ppermute``; here the slab's layers are taken from the global binning on
the home device and moved to the slab's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import integrator, trace
from ..cellbins import CellBins, bin_columns
from ..integrator import OVF_BAND, OVF_CLASS, StepConfig, _ovf
from ..ops import banded_nearfield as bdn
from .sharding import Mesh, _check_mesh, on_device, shard_state


class Slab(NamedTuple):
    """One slab's per-step data, on its device."""

    device: torch.device
    bins: CellBins         # the extended slab's px, py, pz, mask (C_loc, S)
    j0: torch.Tensor       # (O, C_loc, T) window starts
    n_valid: torch.Tensor  # (C_loc,)
    zsh: torch.Tensor      # (O, C_loc, T)
    cls: object = None     # (perm, inv) class packing (CUDA), or None
    blocks: object = None  # the slab's A after build_mv (None on CPU)


class HaloCtx(NamedTuple):
    """Per-step data of the halo engine: the global binnings and far field
    on the home device, and the slabs."""

    nf_bins: object
    ff_bins: object
    ff_factors: object
    tilt: float
    slabs: tuple
    nf_f: object = None
    ff_f: object = None


class HaloEngine(integrator.BandedEngine):
    """The banded engine with its near field in x-slabs over ``mesh``."""

    def __init__(self, config: StepConfig, mesh: Mesh):
        super().__init__(config, mesh.home)
        bs = config.band_spec
        ncx, ncy, _ = bs.bins.n_cells
        D = len(mesh.devices)
        self.mesh, self.ncy, self.nxl = mesh, ncy, ncx // D
        self.c_loc = (self.nxl + 2) * ncy
        # the slab classes are sized on the extended slab grid for the
        # worst slab; sized for another slab count (make_config's
        # shard_slabs != D) they do not fit it: one class
        slab_cls = bs.slab_classes
        if slab_cls is not None and sum(c for _, c in slab_cls) != self.c_loc:
            slab_cls = None
        self.spec = bs._replace(
            bins=bs.bins._replace(n_cells=(self.nxl + 2, ncy, 1)),
            classes=slab_cls, slab_classes=None)
        cx = torch.arange(self.c_loc) // ncy
        # each slab's interior columns, on its device
        self.interior = [((cx >= 1) & (cx <= self.nxl)).to(dev)
                         for dev in mesh.devices]
        # each slab's global x-layers, halos included, on the home device
        self.layers = [(torch.arange(d * self.nxl - 1, (d + 1) * self.nxl + 1)
                        % ncx).to(self.device) for d in range(D)]

    def exchange_x(self, arr: torch.Tensor, d: int, seam_shift=False):
        """(..., C, S) global -> slab d's (..., C_loc, S) on its device.
        ``seam_shift``: for x coordinates, -Lx on slab 0's left halo and
        +Lx on slab D - 1's right halo."""
        ncy = self.ncy
        a = arr.reshape(arr.shape[:-2] + (-1, ncy, arr.shape[-1]))
        ext = torch.index_select(a, -3, self.layers[d])
        if seam_shift:
            Lx = float(np.float32(self.config.params.L[0]))
            D = len(self.mesh.devices)
            parts = [ext[..., :1, :, :], ext[..., 1:-1, :, :],
                     ext[..., -1:, :, :]]
            if d == 0:
                parts[0] = parts[0] - Lx
            if d == D - 1:
                parts[2] = parts[2] + Lx
            ext = torch.cat(parts, dim=-3)
        return ext.reshape(arr.shape[:-2] + (self.c_loc, arr.shape[-1])).to(
            self.mesh.devices[d])

    def _interior(self, u: torch.Tensor) -> torch.Tensor:
        """(NR, C_loc, S) slab output -> its interior (NR, nxl ncy, S) on
        the home device."""
        NR, _, S = u.shape
        u = u.reshape(NR, self.nxl + 2, self.ncy, S)[:, 1:-1]
        return u.reshape(NR, self.nxl * self.ncy, S).to(self.device)

    def prepare(self, pos, box, forces=None):
        """The global binnings and far-field factors, then each slab's
        layers, windows and class packing; returns (ctx, overflow mask)
        with OVF_BAND and OVF_CLASS ORed over the slabs."""
        cfg = self.config
        nf_bins, ff_bins, nf_f, ff_f = integrator._bin_both(
            cfg, pos, box, bin_columns, forces)
        factors = integrator._ff_shared(cfg, ff_bins, box)
        overflow = (_ovf(nf_bins.overflow, integrator.OVF_NF)
                    | _ovf(ff_bins.overflow, integrator.OVF_FF))
        slabs, band, cls = [], [], []
        for d, dev in enumerate(self.mesh.devices):
            with on_device(dev):
                with trace.span("halo.exchange"):
                    bins = CellBins(
                        self.exchange_x(nf_bins.px, d, seam_shift=True),
                        self.exchange_x(nf_bins.py, d),
                        self.exchange_x(nf_bins.pz, d),
                        self.exchange_x(nf_bins.mask, d), None, None, None,
                        None)
                # the kernels read the half stencil's windows; the plain
                # matvec (CPU) all 9
                offs = (self.spec.offsets if dev.type == "cpu"
                        else self.spec.offsets[:bdn.N_HALF])
                with trace.span("prepare.windows"):
                    j0, nv, ovf, zsh = bdn.compute_windows(
                        bins, self.spec, box, cfg.params.ewald_cut,
                        col_mask=self.interior[d], offsets=offs)
                pack = None
                if self.spec.classes is not None and dev.type != "cpu":
                    with trace.span("prepare.classes"):
                        perm, inv, covf = bdn.class_assignment(self.spec, nv)
                    pack = (perm, inv)
                    cls.append(covf.to(self.device))
                band.append(ovf.to(self.device))
                slabs.append(Slab(dev, bins, j0, nv, zsh, pack))
        overflow = overflow | _ovf(torch.stack(band).any(), OVF_BAND)
        if cls:
            overflow = overflow | _ovf(torch.stack(cls).any(), OVF_CLASS)
        return HaloCtx(nf_bins, ff_bins, factors, box.tilt_xy, tuple(slabs),
                       nf_f, ff_f), overflow

    def _slab_args(self, ctx: HaloCtx, s: Slab):
        p = self.config.params
        return (s.bins, ctx.tilt, self.spec, self.config.cheb, p.L,
                p.ewald_cut, p.ewald_dr, s.j0, s.n_valid, s.zsh)

    def build_mv(self, ctx, ft):
        """Per slab the fused build of its A + matvec on ft (3 or 6, C, S):
        (ctx with the slabs' A, M_real ft)."""
        slabs, us = [], []
        for d, s in enumerate(ctx.slabs):
            with on_device(s.device):
                blocks, u = bdn.build_mv_banded(
                    *self._slab_args(ctx, s), self.exchange_x(ft, d),
                    self.config.params.self_mobility, pack=s.cls)
                slabs.append(s._replace(blocks=blocks))
                us.append(self._interior(u))
        return ctx._replace(slabs=tuple(slabs)), torch.cat(us, dim=1)

    def mreal_t(self, ctx, cells):
        """M_real cells (3 or 6, C, S): each slab's stored-A matvec."""
        us = []
        for d, s in enumerate(ctx.slabs):
            with on_device(s.device):
                us.append(self._interior(bdn.matvec_banded(
                    s.blocks, *self._slab_args(ctx, s),
                    self.exchange_x(cells, d),
                    self.config.params.self_mobility, pack=s.cls)))
        return torch.cat(us, dim=1)


def make_halo_engine(config: StepConfig, mesh: Mesh, axis: str = "dp"):
    """The halo engine of a banded config whose ncx the mesh size divides
    (``make_config(..., shard_slabs=D)`` rounds ncx to a multiple of D)."""
    if config.engine != "banded":
        raise ValueError("the halo engine needs the banded near field")
    D = _check_mesh(config, mesh, axis)
    ncx = config.band_spec.bins.n_cells[0]
    if ncx % D != 0:
        raise ValueError(f"ncx={ncx} is not divisible by the mesh size {D}; "
                         f"build the config with make_config(..., "
                         f"shard_slabs={D})")
    return HaloEngine(config, mesh)


def make_halo_step(config: StepConfig, mesh: Mesh, axis: str = "dp"):
    """The PSE step with the halo near field: run(state, forces, T, dt,
    shear_rate, new_tilt=None, uniforms=None), ``integrator.step``'s
    call; the state is placed on the home device."""
    eng = make_halo_engine(config, mesh, axis)

    def run(state, forces, T, dt, shear_rate, new_tilt=None, uniforms=None):
        return integrator.step_impl(config, eng, shard_state(state, mesh),
                                    forces, T, dt, shear_rate, new_tilt,
                                    uniforms)

    return run


def make_halo_mobility(config: StepConfig, mesh: Mesh, axis: str = "dp"):
    """U = M F with the halo near field: run(pos, forces, tilt_xy=0.0) ->
    (velocities (N, 3), overflow mask) on the home device."""
    eng = make_halo_engine(config, mesh, axis)

    def run(pos, forces, tilt_xy=0.0):
        return integrator.mobility_impl(config, eng, pos, forces, tilt_xy)

    return run
