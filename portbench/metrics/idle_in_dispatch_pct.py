"""idle_in_dispatch_pct: of the device's idle time in the traced stretch
(the gaps between its operations, overlaps merged), the share in which
the host was inside one of the program's spans and not blocked in a host
read (``sync.*``): idle the host's dispatch leaves, not its waits."""

import numpy as np

from portbench.metrics import _program


def read(win):
    rec = _program.recording(win)
    if rec is None:
        return None
    g0, g1 = _program.device_gaps(win.records.ops)
    idle = float(np.sum(g1 - g0))
    if idle <= 0:
        return None
    work = _program.minus(_program.in_program(rec), _program.in_sync(rec))
    during = _program.covered(work, g1) - _program.covered(work, g0)
    return 100.0 * float(np.sum(during)) / idle
