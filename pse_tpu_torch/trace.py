"""Spans and counters of the program, on the clock the profiler stamps.

    from pse_tpu_torch import trace

    with trace.recording() as rec:
        sim.run(100)
    rec.spans          # [(name, parent, t0_ns, t1_ns)], in the order they end
    rec.counts         # {"read.lanczos": ..., "launch.matvec_banded": ...}
    rec.steps          # the steps the recording covered
    trace.counters()   # every count since the process started

``span(name)`` marks a stretch of host time.  It is recorded only while a
recording is on: inside ``recording()``, or while a ``torch.profiler`` is
active.  A profiled stretch is one recording; it starts at the first span
that finds the profiler on after a span that found it off, and
``last_recording()`` is the latest.  Both ends of a span are
``time.time_ns()``, the clock the profiler stamps its own host and device
records with, so the spans line up with a profile; a span never makes a
profiler record of its own.  Off, a span costs one check of the profiler's
state and returns a shared null context.  A recording keeps at most
``MAX_SPANS`` spans and counts the rest in ``dropped``.

Spans (parent: children):

    run.chunk: sync.overflow, run.rewind            (Simulation.run, a chunk)
    step: prepare, far_field, near_field.build_mv, near_field.matvec,
          lanczos, update          (integrator.step_impl, mobility_impl,
                                    brownian_displacement)
    prepare: prepare.bin, prepare.windows, prepare.classes,
             prepare.pair_blocks, prepare.pair_coeffs, prepare.ff_factors,
             halo.exchange
    far_field: far_field.spread, far_field.fft, far_field.green,
               far_field.ifft, far_field.contract
    lanczos: near_field.matvec, sync.lanczos, lanczos.eigh

``sync.<site>`` is a host read of device data (the host waits for the
device there), each counted as ``read.<site>``.  Counters:
``launch.<kernel wrapper>`` (a launch of a hand-written kernel),
``read.<site>``, ``near_field.rhs`` (the right-hand sides of each
``build_mv``: 1 in an athermal or a force-free step, 2 in a thermal banded
step with forces), ``lanczos.iterations``, ``lanczos.eigh``,
``overflow.<OVF_* name>`` (one per rewind for each flag set),
``kernels.build`` and ``kernels.reuse`` (the kernel library compiled or
found).
"""

from __future__ import annotations

import contextlib
import time

import torch

MAX_SPANS = 1 << 18

_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class Recording:
    """What one recording kept: ``spans`` [(name, parent name or None,
    t0_ns, t1_ns)], ``counts`` made while it was on, ``steps`` (its
    ``step`` spans) and ``dropped`` (spans past ``MAX_SPANS``)."""

    def __init__(self):
        self.spans = []
        self.counts = {}
        self.steps = 0
        self.dropped = 0

    def _add(self, name, parent, t0, t1):
        if name == "step":
            self.steps += 1
        if len(self.spans) < MAX_SPANS:
            self.spans.append((name, parent, t0, t1))
        else:
            self.dropped += 1


class _State:
    """The process's tracing state: ``forced`` open ``recording()``s, the
    recording spans go to (None after a span found tracing off), the
    latest recording, the names of the open recorded spans, and the
    always-on counters."""

    def __init__(self):
        self.forced = 0
        self.current = None
        self.last = None
        self.stack = []
        self.counters = {}


_state = _State()


class _Span:
    __slots__ = ("name", "rec", "parent", "t0")

    def __init__(self, name, rec):
        self.name, self.rec = name, rec

    def __enter__(self):
        stack = _state.stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _state.stack.pop()
        self.rec._add(self.name, self.parent, self.t0, t1)
        return False


def span(name: str):
    """A context manager marking ``name``'s stretch of host time in the
    current recording; the shared null context when none is on."""
    st = _state
    if not (st.forced or _profiling()):
        st.current = None
        return _NULL
    rec = st.current
    if rec is None:
        rec = st.current = st.last = Recording()
    return _Span(name, rec)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, and to the current recording's."""
    st = _state
    st.counters[name] = st.counters.get(name, 0) + n
    rec = st.current
    if rec is not None and (st.forced or _profiling()):
        rec.counts[name] = rec.counts.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter since the process started."""
    return dict(_state.counters)


@contextlib.contextmanager
def recording():
    """Record every span and count inside, profiler or not; yields the
    ``Recording``."""
    st = _state
    rec, outer = Recording(), st.current
    st.forced += 1
    st.current = st.last = rec
    try:
        yield rec
    finally:
        st.forced -= 1
        st.current = outer if st.forced else None


def last_recording() -> Recording | None:
    """The latest recording (the one in progress, if any), or None."""
    return _state.last
