"""User-facing scene/simulation API, shaped like the reference's Python layer.

PyTorch counterpart of ``pse_tpu/api.py``:

    import pse_tpu_torch as pse

    sim = pse.Simulation(positions=pos, L=L, dt=1e-3)      # device="cuda"
    sim.set_integrator(pse.PSEv1(T=1.0, seed=1, xi=0.5, error=1e-3),
                       engine="banded")
    sim.run(1000)

``run`` steps on the device from a host loop; at chunk boundaries it reads
the sticky overflow mask and, if a capacity overflowed, rewinds the chunk,
grows the named capacities and runs it again.  The port covers the thermal,
force-free banded engine: ``force_fn``, athermal runs and the other engines
raise ``NotImplementedError`` (see integrator.make_config).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import shear as shear_function
from .box import Box, make_box
from .integrator import (
    State, StepConfig, grow_config, make_config, make_state,
    state_from_arrays, step as _step,
)
from .params import make_params


@dataclasses.dataclass
class PSEv1:
    """Integration-method description (the reference's integrate.PSEv1
    arguments, integrate.py:32).  ``nlist_type`` is checked as the JAX
    package checks it; the banded engine bins directly and uses none.
    ``group`` (a particle subset) is not ported: set_integrator raises."""

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
        self.shear_variant: Optional[shear_function.ShearVariant] = None
        self.state = make_state(self.positions0, tilt_xy=tilt_xy,
                                device=self.device)
        if images is not None:
            self.state = self.state._replace(images=torch.as_tensor(
                np.asarray(images, np.int32), device=self.device))
        self.step_timing = []
        self.metrics = {"m_lanczos_hist": {}, "overflow_retries": 0, "steps": 0}

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
        if method.group is not None:
            raise NotImplementedError(
                "PSEv1.group subsets are not ported to pse_tpu_torch yet "
                "(ROADMAP.md, Queue A)"
            )
        self.config = make_config(
            params, self.n, thermal=thermal, seed=method.seed, engine=engine,
            max_tilt=method.max_strain, max_neighbors=max_neighbors,
            has_forces=self.force_fn is not None, device=self.device,
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
            if not callable(T) and float(T) == 0.0:
                raise NotImplementedError(
                    "an athermal step is the with-forces path (M·0), not "
                    "ported to pse_tpu_torch yet (ROADMAP.md, Queue A)"
                )
            self.method = dataclasses.replace(self.method, T=T)
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

    def enable_shear_box(self, total_timesteps: int, max_strain: float = 0.5):
        """Register the box-tilting variant (variant.py:15-32 and the
        hoomd.update.box_resize analogue)."""
        if self.method is None or self.method.function_form is None:
            raise RuntimeError("set_integrator with a function_form first")
        self.shear_variant = shear_function.ShearVariant(
            self.method.function_form, total_timesteps, max_strain
        )
        return self

    # -- one step ---------------------------------------------------------

    def _advance(self, state: State):
        t = state.step
        method = self.method
        new_tilt = (float(self.shear_variant.value(t + 1))
                    if self.shear_variant is not None else None)
        return _step(self.config, state, float(method.temperature(t)),
                     self.dt, float(method.shear_rate(t)), new_tilt)

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
            snapshot = self.state
            t0 = time.perf_counter()
            state = self.state
            ms = []
            for _ in range(chunk):
                state, info = self._advance(state)
                ms.append(info["m_lanczos"])
            flags = int(state.nbr_overflow)       # synchronizes the device
            elapsed = time.perf_counter() - t0
            if flags:
                regrows += 1
                if regrows > max_regrow:
                    raise RuntimeError(
                        f"capacity overflow persists after {max_regrow} "
                        "regrows; the configuration density is outside what "
                        "the banded layout can absorb"
                    )
                self.config = grow_config(self.config, flags=flags)
                self.state = snapshot
                self.metrics["overflow_retries"] += 1
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
        """Deterministic U = M F: not ported yet (the with-forces slice)."""
        from .integrator import mobility

        return mobility(self.config, self.state.pos, forces,
                        self.state.tilt_xy)

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
