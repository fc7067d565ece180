"""User-facing scene/simulation API, shaped like the reference's Python layer.

PyTorch counterpart of ``pse_tpu/api.py``:

    import pse_tpu_torch as pse

    sim = pse.Simulation(positions=pos, L=L, dt=1e-3)      # device="cuda"
    sim.set_integrator(pse.integrate.PSEv1(T=1.0, seed=1, xi=0.5,
                                           error=1e-3))
    sim.run(1000)

``run`` steps on the device from a host loop; at chunk boundaries it reads
the sticky overflow mask and, if a capacity overflowed, rewinds the chunk,
grows the named capacities and runs it again.  ``force_fn(pos, step)``
returns the (N, 3) forces at the current positions as a tensor on the
simulation's device (it is called every step, with no host sync);
``mobility_matvec`` is the deterministic U = M F.  The port runs the
blocked engine (the default), the banded one and the gather (neighbor
list) one, and ``make_config`` picks the JAX package's engine for the box
(banded -> blocked -> gather where the geometry is too small).  A
``PSEv1.group``
integrates a subset: the hydrodynamic system is the group's members, and
the other particles stay where they are (``force_fn`` still sees them).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import shear as shear_function
from . import trace
from .box import Box, make_box
from .integrator import (
    OVF_BAND, OVF_CLASS, OVF_FF, OVF_LANCZOS, OVF_NBR, OVF_NF, State,
    StepConfig, _size_slab_classes, grow_config, make_config, make_state,
    mobility, state_from_arrays, step as _step,
)
from .ops import banded_nearfield as bdn
from .params import make_params


# the overflow mask's flags by name, as ``overflow.<name>`` counts them
_OVF_FLAGS = (("OVF_NF", OVF_NF), ("OVF_BAND", OVF_BAND), ("OVF_FF", OVF_FF),
              ("OVF_LANCZOS", OVF_LANCZOS), ("OVF_NBR", OVF_NBR),
              ("OVF_CLASS", OVF_CLASS))


@dataclasses.dataclass
class PSEv1:
    """Integration-method description (the reference's integrate.PSEv1
    arguments, integrate.py:32).  ``nlist_type``: "cell" is the rcut-sized
    27-stencil cell list; "stencil" the finer-cell backend (rcut/2 cells,
    125-stencil, the analogue of the reference's CellListStencil,
    integrate.py:69-74), both used by the gather engine's neighbor
    enumeration (the banded and blocked engines bin directly); "tree" maps
    to "cell" with a warning.  ``group``: None for all particles, or an
    index array of the subset to integrate (Stokes.cc:85-111)."""

    T: float | Callable = 1.0
    seed: int = 0
    xi: float = 0.5
    error: float = 1e-3
    function_form: Optional[shear_function.ShearFunction] = None
    max_strain: float = 0.5
    nlist_type: str = "cell"
    group: object = None

    def __post_init__(self):
        if self.nlist_type.upper() not in ("CELL", "TREE", "STENCIL"):
            raise ValueError(
                "Invalid neighborlist method. Valid options are: cell, tree, stencil."
            )
        if self.nlist_type.upper() == "TREE":
            import warnings

            # The reference's tree backend (NeighborListGPUTree) has no
            # counterpart here: the gather engine enumerates neighbours
            # from a cell list, and the banded and blocked engines bin the
            # particles into cells each step.  Accepted for API parity.
            warnings.warn(
                "nlist_type='tree' has no counterpart on the GPU banded "
                "engine, the blocked one or the gather one; using the "
                "cell-list backend (results identical to 'cell')",
                stacklevel=2,
            )

    def temperature(self, timestep):
        if callable(self.T):
            return self.T(timestep)
        return self.T

    def shear_rate(self, timestep):
        if self.function_form is None:
            return 0.0
        return self.function_form.shear_rate(timestep)


def _device(device) -> str:
    """The device the entry points run on: CUDA unless the caller asks for
    another; never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pse_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return str(dev)


class Simulation:
    """Owns the state, the step configuration and the host run loop."""

    def __init__(
        self,
        positions,
        L,
        dt: float,
        images=None,
        tilt_xy: float = 0.0,
        force_fn: Optional[Callable] = None,
        sync_every: int = 100,
        device="cuda",
    ):
        self.device = _device(device)
        self.positions0 = np.asarray(positions, np.float32)
        self.n = self.positions0.shape[0]
        self.L = (float(L),) * 3 if np.isscalar(L) else tuple(float(x) for x in L)
        self.dt = float(dt)
        self.force_fn = force_fn
        self.sync_every = int(sync_every)
        self.method: Optional[PSEv1] = None
        self.config: Optional[StepConfig] = None
        self._group: Optional[torch.Tensor] = None
        self.shear_variant: Optional[shear_function.ShearVariant] = None
        self.state = make_state(self.positions0, tilt_xy=tilt_xy,
                                device=self.device)
        if images is not None:
            self.state = self.state._replace(images=torch.as_tensor(
                np.asarray(images, np.int32), device=self.device))
        self.step_timing = []
        self.metrics = {"m_lanczos_hist": {}, "overflow_retries": 0, "steps": 0}
        self._class_regrows = 0

    # -- setup ------------------------------------------------------------

    def set_integrator(
        self,
        method: PSEv1,
        max_neighbors: int | None = None,
        verbose: bool = True,
        engine: str = "blocked",
    ):
        if method.function_form is not None:
            method = dataclasses.replace(
                method,
                function_form=shear_function.resolve_now(
                    method.function_form, int(self.state.step)
                ),
            )
        self.method = method
        params = make_params(
            xi=method.xi, error=method.error, L=self.L, max_strain=method.max_strain
        )
        thermal = callable(method.T) or float(method.T) != 0.0
        self._group, n_hydro = None, self.n
        if method.group is not None:
            g = np.unique(np.asarray(method.group, np.int32).ravel())
            if g.size == 0 or g.min() < 0 or g.max() >= self.n:
                raise ValueError(
                    f"group indices must be unique and in [0, {self.n})"
                )
            if g.size < self.n:         # a group of everyone is no subset
                self._group = torch.as_tensor(g, dtype=torch.int64,
                                              device=self.device)
                n_hydro = int(g.size)
        self.config = make_config(
            params, n_hydro, thermal=thermal, seed=method.seed, engine=engine,
            max_tilt=method.max_strain, max_neighbors=max_neighbors,
            has_forces=self.force_fn is not None,
            # "stencil": rcut/2 cells with a 125-stencil; only the gather
            # engine enumerates neighbours
            nbr_subdiv=2 if method.nlist_type.upper() == "STENCIL" else 1,
            # the measured column occupancy sizes the banded engine's
            # occupancy classes
            positions=self._hydro_positions(self.state),
            device=self.device,
        )
        self._built_max_strain = float(method.max_strain)
        if verbose:
            print(params.summary())
        return self

    def set_params(self, T=None, function_form=None, max_strain: float = 0.5):
        """Change T / the shear protocol on the fly (integrate.py:108-118);
        xi and error are fixed at construction."""
        if self.method is None:
            raise RuntimeError("set_integrator first")
        if T is not None:
            self.method = dataclasses.replace(self.method, T=T)
            thermal = callable(T) or float(T) != 0.0
            if thermal != self.config.thermal:
                # going athermal on a zero-force Simulation keeps the (M·0)
                # deterministic path, as make_config would have built it
                changes = {"thermal": thermal}
                if not thermal and not self.config.has_forces:
                    changes["has_forces"] = True
                self.config = dataclasses.replace(self.config, **changes)
        if function_form is not None:
            if float(max_strain) > self._built_max_strain:
                raise ValueError(
                    f"max_strain={max_strain:g} exceeds the value the "
                    f"integrator was built with ({self._built_max_strain:g}); "
                    "call set_integrator again to rebuild for a larger strain"
                )
            self.method = dataclasses.replace(
                self.method,
                function_form=shear_function.resolve_now(
                    function_form, int(self.state.step)
                ),
                max_strain=max_strain,
            )
        return self

    def stop_shear(self, max_strain: float | None = None):
        """Replace the shear protocol with zero steady shear
        (integrate.py:121-123).  Defaults to the max_strain the integrator
        was built with (a larger value would be rejected by set_params)."""
        if max_strain is None:
            max_strain = self._built_max_strain
        return self.set_params(
            function_form=shear_function.steady(dt=0.0), max_strain=max_strain
        )

    def enable_shear_box(self, total_timesteps: int, max_strain: float = 0.5):
        """Register the box-tilting variant (variant.py:15-32 and the
        hoomd.update.box_resize analogue)."""
        if self.method is None or self.method.function_form is None:
            raise RuntimeError("set_integrator with a function_form first")
        self.shear_variant = shear_function.ShearVariant(
            self.method.function_form, total_timesteps, max_strain
        )
        return self

    def _hydro_positions(self, state: State) -> np.ndarray:
        """The hydrodynamic system's positions on the host (a group's
        rows)."""
        pos = state.pos if self._group is None else state.pos[self._group]
        trace.count("read.positions")
        with trace.span("sync.positions"):
            return pos.cpu().numpy()

    def _remeasure_classes(self, snapshot: State):
        """Occupancy classes sized anew from the snapshot's positions at its
        tilt, after grow_config dropped them on OVF_CLASS."""
        pos = self._hydro_positions(snapshot)
        cfg = self.config
        bs = cfg.band_spec
        counts = bdn.measure_col_counts(bs, pos, cfg.params.L,
                                        tilt=snapshot.tilt_xy)
        bs = bdn.make_band_classes(bs, pos.shape[0], counts)
        bs = _size_slab_classes(bs, cfg.shard_slabs, pos.shape[0], counts)
        self.config = dataclasses.replace(cfg, band_spec=bs)

    # -- one step ---------------------------------------------------------

    def _advance(self, state: State):
        t = state.step
        method = self.method
        new_tilt = (float(self.shear_variant.value(t + 1))
                    if self.shear_variant is not None else None)
        forces = (self.force_fn(state.pos, t) if self.force_fn is not None
                  else None)
        args = (float(method.temperature(t)), self.dt,
                float(method.shear_rate(t)), new_tilt)
        g = self._group
        if g is None:
            return _step(self.config, state, forces, *args)
        # the group's members are the hydrodynamic system; the others stay
        # where they are
        sub = state._replace(pos=state.pos[g], images=state.images[g])
        new_sub, info = _step(self.config, sub,
                              None if forces is None else forces[g], *args)
        pos, images = state.pos.clone(), state.images.clone()
        pos[g], images[g] = new_sub.pos, new_sub.images
        return new_sub._replace(pos=pos, images=images), info

    # -- host loop --------------------------------------------------------

    def run(self, n_steps: int, callback: Optional[Callable] = None,
            max_regrow: int = 8):
        """Advance n_steps with overflow-safe chunking (hoomd.run analogue)."""
        if self.config is None:
            raise RuntimeError("set_integrator first")
        remaining = int(n_steps)
        regrows = 0
        while remaining > 0:
            chunk = min(self.sync_every, remaining)
            with trace.span("run.chunk"):
                snapshot = self.state
                t0 = time.perf_counter()
                state = self.state
                ms = []
                for _ in range(chunk):
                    state, info = self._advance(state)
                    ms.append(info["m_lanczos"])
                trace.count("read.overflow")
                with trace.span("sync.overflow"):
                    flags = int(state.nbr_overflow)   # synchronizes the device
                elapsed = time.perf_counter() - t0
                if flags:
                    regrows += 1
                    if regrows > max_regrow:
                        raise RuntimeError(
                            f"capacity overflow persists after {max_regrow} "
                            "regrows; the configuration density is outside "
                            f"what the {self.config.engine} engine's layout "
                            "can absorb"
                        )
                    with trace.span("run.rewind"):
                        self._rewind(snapshot, flags)
                    continue
            self.state = state
            self.step_timing.append((chunk, elapsed))
            hist = self.metrics["m_lanczos_hist"]
            for m in ms:
                hist[int(m)] = hist.get(int(m), 0) + 1
            self.metrics["steps"] += chunk
            remaining -= chunk
            if callback is not None:
                callback(self)
        return self

    def _rewind(self, snapshot: State, flags: int):
        """Back to ``snapshot`` with the capacities ``flags`` names grown:
        OVF_NBR the neighbor list, OVF_NF / OVF_BAND / OVF_FF the cell caps
        and the band, OVF_LANCZOS m_max; OVF_CLASS drops the occupancy
        classes."""
        for name, bit in _OVF_FLAGS:
            if flags & bit:
                trace.count(f"overflow.{name}")
        self.config = grow_config(self.config, flags=flags)
        if (flags & OVF_CLASS and self.config.band_spec is not None
                and self._class_regrows < 2):
            # the density drifted past the classes sized at
            # set_integrator: size them from the positions the
            # chunk restarts from (after two, keep one class)
            self._class_regrows += 1
            self._remeasure_classes(snapshot)
        self.state = snapshot
        self.metrics["overflow_retries"] += 1

    def metrics_summary(self) -> str:
        """One-line run statistics: steps, wall time, retries, m histogram."""
        m = self.metrics
        hist = " ".join(
            f"m={k}:{v}" for k, v in sorted(m["m_lanczos_hist"].items())
        )
        wall = sum(e for _, e in self.step_timing)
        sps = m["steps"] / wall if wall > 0 else float("nan")
        return (
            f"steps={m['steps']} wall={wall:.3f}s ({sps:.1f} steps/s) "
            f"overflow_retries={m['overflow_retries']} lanczos[{hist}]"
        )

    # -- observables ------------------------------------------------------

    @property
    def box(self) -> Box:
        return make_box(self.L, self.state.tilt_xy)

    def mobility_matvec(self, forces):
        """Deterministic U = M F (N, 3) at the current configuration."""
        u, overflow = mobility(self.config, self.state.pos, forces,
                               self.state.tilt_xy)
        trace.count("read.mobility_overflow")
        with trace.span("sync.mobility_overflow"):
            flags = int(overflow)
        if flags:
            cfg = self.config
            specs = ((OVF_NF, "band_spec" if cfg.engine == "banded"
                      else "nf_spec"), (OVF_BAND, "band_spec window"),
                     (OVF_FF, "colff_spec" if cfg.colff_spec is not None
                      else "ff_spec"), (OVF_NBR, "nbr_spec"),
                     (OVF_CLASS, "band_spec classes"))
            raise RuntimeError(
                "capacity overflow in mobility ("
                + ", ".join(name for bit, name in specs if flags & bit)
                + "); enlarge it (integrator.grow_config)")
        return u

    def snapshot(self) -> dict:
        """Checkpoint payload, the same keys as pse_tpu's snapshot()."""
        return {
            "pos": self.state.pos.cpu().numpy(),
            "images": self.state.images.cpu().numpy(),
            "step": int(self.state.step),
            "tilt_xy": float(self.state.tilt_xy),
            "m_lanczos": int(self.state.m_lanczos),
            "L": np.asarray(self.L),
            "dt": self.dt,
        }

    def save(self, path: str):
        np.savez(path, **self.snapshot())

    def restore(self, path: str):
        """Resume from a .npz written by ``save`` here or by pse_tpu."""
        with np.load(path) as d:
            self.state = state_from_arrays(d, device=self.device)
        if self.method is not None and self.method.function_form is not None:
            ff = shear_function.resolve_now(
                self.method.function_form, int(self.state.step)
            )
            if ff is not self.method.function_form:
                self.method = dataclasses.replace(self.method, function_form=ff)
                if self.shear_variant is not None:
                    self.shear_variant = dataclasses.replace(
                        self.shear_variant, func=ff
                    )
        return self


def create_lattice(n_per_side: int, L: float) -> np.ndarray:
    """Simple-cubic lattice positions (examples/run.py:27-34 analogue)."""
    a = L / n_per_side
    grid = (np.arange(n_per_side) + 0.5) * a - L / 2.0
    x, y, z = np.meshgrid(grid, grid, grid, indexing="ij")
    return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1).astype(np.float32)
