"""device_idle_pct: 100 x (1 - merged device busy time / the traced
stretch's host-clock length)."""

from portbench.trace import merged_busy_us


def read(win):
    rec = win.records
    if rec is None or not rec.ops or rec.window_us <= 0:
        return None
    return 100.0 * (1.0 - merged_busy_us(rec.ops) / rec.window_us)
