"""host_wait_ms_per_step: host milliseconds per recorded step blocked in
the program's host reads (its ``sync.*`` spans: the Lanczos scalars, the
overflow mask), from the program's own recording of the traced stretch."""

from portbench.metrics import _program


def read(win):
    rec = _program.recording(win)
    if rec is None:
        return None
    return _program.length(_program.in_sync(rec)) / 1e3 / rec.steps
