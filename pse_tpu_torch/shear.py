"""Time-dependent shear protocols (pure functions of the timestep).

Counterpart of ``pse_tpu/shear.py``, evaluated on the host with numpy: the
reference's ShearFunction class family (SpecificShearFunction.h) and the
VariantShearFunction strain wrapping (VariantShearFunction.h:46-48) as
stateless dataclasses whose ``shear_rate`` and ``strain`` are pure functions
of the timestep, called once per step by the host loop.

The two cooperating mechanisms of the reference (SURVEY.md §3.4) are kept:
  1. per-step rate: the integrator adds the affine velocity
     ``vel_x += rate(t)·y`` (Stokes.cu:168);
  2. box tilt: ``wrap_strain(strain(t))`` drives the xy tilt factor
     (variant.py:13-32 + hoomd box_resize).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

TWO_PI = 2.0 * math.pi


class ShearFunction:
    """Interface: shear_rate(t), strain(t), offset (ShearFunction.h:19-36)."""

    offset: int = 0

    def shear_rate(self, timestep):
        raise NotImplementedError

    def strain(self, timestep):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SteadyShear(ShearFunction):
    """Constant shear rate (SpecificShearFunction.h:49-75)."""

    rate: float
    offset: int = 0
    dt: float = 0.0

    def shear_rate(self, timestep):
        del timestep
        return self.rate

    def strain(self, timestep):
        return self.rate * (timestep - self.offset) * self.dt


@dataclasses.dataclass(frozen=True)
class SinShear(ShearFunction):
    """Sinusoidal oscillatory shear; ``freq`` is a real (not angular)
    frequency (SpecificShearFunction.h:16-46)."""

    max_rate: float
    freq: float
    offset: int = 0
    dt: float = 0.0

    def shear_rate(self, timestep):
        t = (timestep - self.offset) * self.dt
        return self.max_rate * np.cos(self.freq * TWO_PI * t)

    def strain(self, timestep):
        t = (timestep - self.offset) * self.dt
        return self.max_rate * np.sin(self.freq * TWO_PI * t) / (self.freq * TWO_PI)


@dataclasses.dataclass(frozen=True)
class ChirpShear(ShearFunction):
    """Exponential frequency sweep (SpecificShearFunction.h:80-124)."""

    amplitude: float
    omega_0: float
    omega_f: float
    periodT: float
    offset: int = 0
    dt: float = 0.0

    def _phase_and_omega(self, timestep):
        t = (timestep - self.offset) * self.dt
        lnr = math.log(self.omega_f / self.omega_0)
        omega = self.omega_0 * np.exp(t * lnr / self.periodT)
        phase = self.periodT * self.omega_0 / lnr * (
            np.exp(t * lnr / self.periodT) - 1.0
        )
        return phase, omega

    def shear_rate(self, timestep):
        phase, omega = self._phase_and_omega(timestep)
        return self.amplitude * omega * np.cos(phase)

    def strain(self, timestep):
        phase, _ = self._phase_and_omega(timestep)
        return self.amplitude * np.sin(phase)


@dataclasses.dataclass(frozen=True)
class TukeyWindow(ShearFunction):
    """Tukey window; used to window other shear functions
    (SpecificShearFunction.h:134-191)."""

    periodT: float
    tukey_param: float
    offset: int = 0
    dt: float = 0.0

    def __post_init__(self):
        if not (0.0 < self.tukey_param <= 1.0):
            raise ValueError("Tukey parameter must be within (0, 1]")

    @property
    def _omega(self):
        return TWO_PI / self.tukey_param

    def shear_rate(self, timestep):
        rel = (timestep - self.offset) * self.dt / self.periodT
        om = self._omega
        rising = -np.sin(om * (rel - self.tukey_param / 2.0)) / 2.0 * om / self.periodT
        falling = (
            -np.sin(om * (rel - 1.0 + self.tukey_param / 2.0)) / 2.0 * om / self.periodT
        )
        inside_flat = (rel >= self.tukey_param / 2.0) & (rel <= 1.0 - self.tukey_param / 2.0)
        outside = (rel <= 0.0) | (rel >= 1.0)
        val = np.where(rel < 0.5, rising, falling)
        return np.where(outside | inside_flat, 0.0, val)

    def strain(self, timestep):
        rel = (timestep - self.offset) * self.dt / self.periodT
        om = self._omega
        rising = (1.0 + np.cos(om * (rel - self.tukey_param / 2.0))) / 2.0
        falling = (1.0 + np.cos(om * (rel - 1.0 + self.tukey_param / 2.0))) / 2.0
        inside_flat = (rel >= self.tukey_param / 2.0) & (rel <= 1.0 - self.tukey_param / 2.0)
        outside = (rel <= 0.0) | (rel >= 1.0)
        val = np.where(rel < 0.5, rising, falling)
        val = np.where(inside_flat, 1.0, val)
        return np.where(outside, 0.0, val)


@dataclasses.dataclass(frozen=True)
class WindowedShear(ShearFunction):
    """Product of a base shear function and a window; the rate follows the
    product rule (SpecificShearFunction.h:198-223)."""

    base: ShearFunction
    window: ShearFunction

    @property
    def offset(self):
        return self.base.offset

    def shear_rate(self, timestep):
        return self.base.shear_rate(timestep) * self.window.strain(
            timestep
        ) + self.base.strain(timestep) * self.window.shear_rate(timestep)

    def strain(self, timestep):
        return self.base.strain(timestep) * self.window.strain(timestep)


def wrap_strain(value, min_value: float = -0.5, max_value: float = 0.5):
    """Wrap a strain into [min, max) (VariantShearFunction.h:46-48)."""
    rng = max_value - min_value
    return value - rng * np.floor((value - min_value) / rng)


@dataclasses.dataclass(frozen=True)
class ShearVariant:
    """Strain variant driving box tilt, with wrap + clamped time range
    (VariantShearFunction.cc:17-43, variant.py:15-32)."""

    func: ShearFunction
    total_timestep: int
    max_strain: float = 0.5

    def value(self, timestep):
        offset = self.func.offset
        wrapped = wrap_strain(
            self.func.strain(timestep), -self.max_strain, self.max_strain
        )
        end_value = wrap_strain(
            self.func.strain(offset + self.total_timestep),
            -self.max_strain,
            self.max_strain,
        )
        out = np.where(timestep < offset, 0.0, wrapped)
        return np.where(timestep >= offset + self.total_timestep, end_value, out)


# ---------------------------------------------------------------------------
# Reference-shaped constructors (shear_function.py:44-114).  ``zero`` is the
# absolute timestep of the protocol's t=0; the reference's default 'now'
# resolves against the global HOOMD step counter (shear_function.py:13-26).
# We have no global context at construction time, so 'now' produces a
# NowOffset marker (an int) that Simulation rebinds to its CURRENT step when
# the protocol is attached (set_integrator / set_params) or the state is
# restored — so 'now' means "when the protocol starts", even on resumed
# simulations.  An explicit int never rebinds.
# ---------------------------------------------------------------------------


class NowOffset(int):
    """An offset created from zero='now': behaves as its int value but is
    rebound to the simulation's current step at attach/restore time."""

    __slots__ = ()


def resolve_now(func: ShearFunction, step: int) -> ShearFunction:
    """Return ``func`` with any 'now'-constructed offsets rebound to
    ``step`` (recursing through WindowedShear).  No-op for explicit ints."""
    if isinstance(func, WindowedShear):
        base = resolve_now(func.base, step)
        window = resolve_now(func.window, step)
        if base is func.base and window is func.window:
            return func
        return dataclasses.replace(func, base=base, window=window)
    off = getattr(func, "offset", 0)
    if isinstance(off, NowOffset) and int(off) != int(step):
        return dataclasses.replace(func, offset=NowOffset(int(step)))
    return func


def _resolve_zero(zero) -> int:
    if zero == "now":
        return NowOffset(0)
    zero = int(zero)
    if zero < 0:
        raise ValueError("Cannot create a shear_function with a negative zero")
    return zero


def steady(dt, shear_rate=0.0, zero="now") -> SteadyShear:
    return SteadyShear(rate=shear_rate, offset=_resolve_zero(zero), dt=dt)


def sine(dt, shear_rate, shear_freq, zero="now") -> SinShear:
    if shear_rate <= 0:
        raise ValueError("Shear rate must be positive (use steady for zero shear)")
    if shear_freq <= 0:
        raise ValueError("Shear frequency must be positive (use steady for steady shear)")
    return SinShear(
        max_rate=shear_rate, freq=shear_freq, offset=_resolve_zero(zero), dt=dt
    )


def chirp(dt, amplitude, omega_0, omega_f, periodT, zero="now") -> ChirpShear:
    return ChirpShear(
        amplitude=amplitude,
        omega_0=omega_0,
        omega_f=omega_f,
        periodT=periodT,
        offset=_resolve_zero(zero),
        dt=dt,
    )


def tukey_window(dt, periodT, tukey_param, zero="now") -> TukeyWindow:
    return TukeyWindow(
        periodT=periodT, tukey_param=tukey_param, offset=_resolve_zero(zero), dt=dt
    )


def windowed(function_form, window) -> WindowedShear:
    return WindowedShear(base=function_form, window=window)


def shear_variant(function_form, total_timestep, max_strain=0.5) -> ShearVariant:
    """variant.shear_variant analogue (variant.py:15-32)."""
    if total_timestep <= 0:
        raise ValueError("Cannot create a shear_variant with 0 or negative points")
    return ShearVariant(function_form, int(total_timestep), max_strain)
