"""Helpers the readers of the program's own recording share (not a metric:
no ``read``).

``pse_tpu_torch.trace`` keeps the program's spans and counts while a
``torch.profiler`` runs, both ends of a span on the clock the profiler
stamps its records with, and makes no profiler record of its own; in a
``--trace 1`` run ``trace.last_recording()`` is the traced stretch.  A
program without that module, or a stretch it did not record, gives every
reader None.  Times here are microseconds on the profiler's clock, as in
``win.records.ops``.
"""

from __future__ import annotations

import numpy as np


def recording(win):
    """The program's recording of the traced stretch, or None (untraced,
    no device record, a program without ``pse_tpu_torch.trace``, no step
    recorded, or spans dropped past the recording's bound)."""
    if win.records is None or not win.records.ops:
        return None
    try:
        from pse_tpu_torch import trace
    except ImportError:
        return None
    rec = trace.last_recording()
    if rec is None or not rec.steps or rec.dropped:
        return None
    return rec


def merged(starts, ends):
    """The union of intervals as sorted, disjoint (starts, ends) arrays."""
    starts = np.asarray(starts, dtype=np.float64)
    ends = np.asarray(ends, dtype=np.float64)
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], np.maximum.accumulate(ends[order])
    new = np.concatenate([[True], starts[1:] > ends[:-1]])
    last = np.concatenate([new[1:], [True]])
    return starts[new], ends[last]


def _us(t_ns: int) -> float:
    """Integer ns since the epoch as us (a float of the ns would round to
    256 ns)."""
    return t_ns // 1000 + t_ns % 1000 / 1e3


def _spans(rec, keep):
    """(starts, ends) in us of the recording's spans that ``keep`` takes
    (it gets the name and the parent), merged."""
    sel = [(_us(t0), _us(t1)) for name, parent, t0, t1 in rec.spans
           if keep(name, parent)]
    return merged([s for s, _ in sel], [e for _, e in sel])


def in_program(rec):
    """Where the host was inside one of the program's spans."""
    return _spans(rec, lambda name, parent: parent is None)


def in_sync(rec):
    """Where the host was blocked in a host read (a ``sync.*`` span)."""
    return _spans(rec, lambda name, parent: name.startswith("sync."))


def minus(a, b):
    """The intervals of ``a`` outside those of ``b`` (both merged)."""
    out_s, out_e = [], []
    j = 0
    bs, be = b
    for s, e in zip(*a):
        while j < len(bs) and be[j] <= s:
            j += 1
        k, cur = j, s
        while k < len(bs) and bs[k] < e:
            if bs[k] > cur:
                out_s.append(cur)
                out_e.append(bs[k])
            cur = max(cur, be[k])
            k += 1
        if cur < e:
            out_s.append(cur)
            out_e.append(e)
    return np.array(out_s), np.array(out_e)


def length(iv) -> float:
    return float(np.sum(iv[1] - iv[0]))


def covered(iv, t):
    """For each time of ``t``, the length of the merged intervals ``iv``
    before it."""
    s, e = iv
    t = np.asarray(t, dtype=np.float64)
    if s.size == 0:
        return np.zeros_like(t)
    before = np.concatenate([[0.0], np.cumsum(e - s)])
    i = np.searchsorted(s, t, side="right")        # intervals started by t
    last = np.maximum(i - 1, 0)
    part = np.clip(t - s[last], 0.0, e[last] - s[last])
    return np.where(i > 0, before[last] + part, 0.0)


def device_gaps(ops):
    """The device's idle gaps between its operations (overlaps merged)."""
    s, e = merged([o.start_us for o in ops],
                  [o.start_us + o.dur_us for o in ops])
    return e[:-1], s[1:]
