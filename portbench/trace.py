"""Layer spans around the program's entry points, and the reduction of a
``torch.profiler`` trace to device records.

The spans are applied from the benchmark's side at run time, only around
the traced part of a ``--trace 1`` window: ``Spans`` wraps the module
attributes and engine methods listed in ``SPANS`` with
``torch.profiler.record_function`` and puts the originals back on exit.
The program's files are not touched.

``reduce`` turns a finished profile into ``DeviceRecords``: every device
operation (kernel, copy, set) with its start, duration and the innermost
span that was open on the host when it was launched.
"""

from __future__ import annotations

import functools
import importlib
from typing import NamedTuple

# span name -> what it wraps: ("module", "attribute") or
# ("module", "Class.method").  The innermost open span names an operation.
SPANS = {
    "step": [("pse_tpu_torch.api", "_step")],
    "prepare": [("pse_tpu_torch.integrator", f"{cls}.prepare")
                for cls in ("BandedEngine", "BlockedEngine", "GatherEngine")],
    "near_field": ([("pse_tpu_torch.integrator", "bnf.build_pair_blocks")]
                   + [("pse_tpu_torch.integrator", f"{cls}.build_mv")
                      for cls in ("_Engine", "BandedEngine")]),
    "nf_matvec": [("pse_tpu_torch.integrator", f"{cls}.mreal_t")
                  for cls in ("BandedEngine", "BlockedEngine", "GatherEngine")],
    "far_field": [("pse_tpu_torch.integrator", "_far_field")],
    "lanczos": [("pse_tpu_torch.integrator", "lanczos.sqrt_mreal")],
}
# spans whose device time is the near field's
NEAR_FIELD = ("near_field", "nf_matvec")


def _targets(name: str, module: str, path: str):
    """(owner, attribute) that the span ``name`` wraps for one entry of
    ``SPANS``: a module attribute, or a method at the class of the MRO that
    defines it.  Raises where the program has no such callable, so that a
    renamed or moved entry point cannot drop out of its span unseen."""
    obj = importlib.import_module(module)
    parts = path.split(".")
    try:
        for p in parts[:-1]:
            obj = getattr(obj, p)
        attr = parts[-1]
        if isinstance(obj, type):
            owner = next(k for k in obj.__mro__ if attr in k.__dict__)
            return owner, attr, owner.__dict__[attr]
        return obj, attr, getattr(obj, attr)
    except (AttributeError, StopIteration):
        raise RuntimeError(f"span {name!r}: the program has no {module}."
                           f"{path} to wrap") from None


class Spans:
    """Context manager: every entry of ``SPANS`` wrapped in a
    ``record_function`` of its span's name while inside.  A method that
    several entries reach through inheritance is wrapped once."""

    def __enter__(self):
        from torch.profiler import record_function

        self._saved = []
        for name, targets in SPANS.items():
            for module, path in targets:
                owner, attr, fn = _targets(name, module, path)
                if not callable(fn):
                    raise RuntimeError(f"span {name!r}: {module}.{path} is "
                                       f"not callable")
                if any(o is owner and a == attr for o, a, _ in self._saved):
                    continue

                def wrapped(*a, _fn=fn, _name=name, **k):
                    with record_function(_name):
                        return _fn(*a, **k)

                functools.update_wrapper(wrapped, fn)
                self._saved.append((owner, attr, fn))
                setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        return False


def missing_spans(rec, names) -> list:
    """The spans of ``names`` that the traced stretch never entered."""
    return sorted(n for n in set(names) if rec.span_counts.get(n, 0) == 0)


class Op(NamedTuple):
    name: str
    start_us: float
    dur_us: float
    kind: str            # "kernel", "d2h", "copy" or "set"
    span: str            # innermost span open at launch ("host_loop" if none)


class DeviceRecords(NamedTuple):
    ops: list            # [Op], sorted by start
    span_counts: dict    # span name -> number of times it was entered
    window_us: float     # the traced window's length on the host clock


def _kind(name: str) -> str:
    n = name.lower()
    if "memcpy" in n:
        return "d2h" if "dtoh" in n or "device -> host" in n or \
            "d2h" in n else "copy"
    if "memset" in n:
        return "set"
    return "kernel"


def reduce(prof, window_s: float) -> DeviceRecords:
    """The device operations of a finished ``torch.profiler`` profile, each
    with the innermost span open on the host when it was launched."""
    events = prof.profiler.kineto_results.events()
    spans, runtime, cpu_ops, device = [], {}, {}, []
    span_names = set(SPANS)
    for e in events:
        dt = str(e.device_type())
        if dt.endswith("CPU"):
            name = e.name()
            if name in span_names and e.is_user_annotation():
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name))
            elif name.startswith(("cuda", "cu")) and not name.startswith(
                    "cudnn"):
                runtime[e.correlation_id()] = e.start_ns()
            else:
                cpu_ops[e.correlation_id()] = e.start_ns()
        elif dt.endswith("CUDA") and not e.is_user_annotation() and \
                e.name() not in span_names:
            # (a span also leaves a device-side range: not an operation)
            device.append(e)
    launches = []
    for e in device:
        t = runtime.get(e.correlation_id())
        if t is None:
            t = cpu_ops.get(e.linked_correlation_id(), e.start_ns())
        launches.append((t, e))
    # innermost open span at each launch: one sweep over the sorted times
    spans.sort()
    launches.sort(key=lambda x: x[0])
    ops, stack, k = [], [], 0
    for t, e in launches:
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] <= spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        span = stack[-1][2] if stack else "host_loop"
        ops.append(Op(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3,
                      _kind(e.name()), span))
    ops.sort(key=lambda o: o.start_us)
    counts = {}
    for _, _, name in spans:
        counts[name] = counts.get(name, 0) + 1
    return DeviceRecords(ops, counts, window_s * 1e6)


def merged_busy_us(ops) -> float:
    """Microseconds in which some device operation ran (overlaps merged)."""
    import numpy as np

    if not ops:
        return 0.0
    start = np.array([o.start_us for o in ops])
    return _merged(start, start + np.array([o.dur_us for o in ops]))


def _merged(start, end) -> float:
    import numpy as np

    order = np.argsort(start, kind="stable")
    start, end = start[order], end[order]
    reach = np.maximum.accumulate(end)
    prev = np.concatenate([[-np.inf], reach[:-1]])
    return float(np.clip(end - np.maximum(start, prev), 0.0, None).sum())


def device_busy_us(prof) -> float:
    """Merged busy microseconds of every device operation of a profile that
    recorded device activity alone (no spans to attribute)."""
    import numpy as np

    start, dur = [], []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and \
                not e.is_user_annotation():
            start.append(e.start_ns())
            dur.append(e.duration_ns())
    if not start:
        return 0.0
    s = np.array(start, dtype=np.float64) / 1e3
    return _merged(s, s + np.array(dur, dtype=np.float64) / 1e3)


def breakdown(rec: DeviceRecords, top: int = 10) -> dict:
    """The device operations that took most time (by span and name), and
    the longest idle gaps, summed by what the host was doing: the span
    open when the operation after the gap was launched, marked when the
    operation before it was a device-to-host copy."""
    by_op = {}
    for o in rec.ops:
        key = f"{o.span}/{o.name}"[:64]
        by_op[key] = by_op.get(key, 0.0) + o.dur_us / 1e6
    gaps, end, last = {}, None, None
    for o in sorted(rec.ops, key=lambda o: o.start_us):
        if end is not None and o.start_us > end:
            key = o.span + ("_after_a_device-to-host_copy"
                            if last is not None and last.kind == "d2h" else "")
            gaps[key] = gaps.get(key, 0.0) + (o.start_us - end) / 1e6
        if end is None or o.start_us + o.dur_us > end:
            end, last = o.start_us + o.dur_us, o
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order(by_op)],
            "idle_gaps": [[k, v] for k, v in order(gaps)]}
