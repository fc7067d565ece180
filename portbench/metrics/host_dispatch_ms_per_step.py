"""host_dispatch_ms_per_step: host milliseconds per recorded step inside
the program's spans, less those blocked in its host reads (``sync.*``),
from the program's own recording of the traced stretch
(``pse_tpu_torch.trace``): the host's work of issuing the step."""

from portbench.metrics import _program


def read(win):
    rec = _program.recording(win)
    if rec is None:
        return None
    work = _program.minus(_program.in_program(rec), _program.in_sync(rec))
    return _program.length(work) / 1e3 / rec.steps
