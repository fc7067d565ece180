"""Helpers the metric readers share (not a metric: no ``read``)."""


def per_step_ms(win, spans) -> float | None:
    """Device milliseconds per traced step of the operations launched
    inside ``spans`` (innermost open span), or None untraced."""
    rec = win.records
    if rec is None or not rec.ops or not win.traced_steps:
        return None
    us = sum(o.dur_us for o in rec.ops if o.span in spans)
    return us / 1e3 / win.traced_steps
