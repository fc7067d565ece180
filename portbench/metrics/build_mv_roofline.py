"""build_mv_roofline: the share of its memory bound that the banded
build_mv reaches, in %: its two kernels launched under the ``near_field``
span (``build_tiles`` writes A, ``matvec_kernel`` reads it back against
the right-hand sides).

Bytes: ``yardstick_mf.build_mv_bytes`` (A's live tiles written once and
read once, f and u per right-hand side), at the right-hand sides per call
that the program's recording counts (``near_field.rhs`` over its
``near_field.build_mv`` spans).  Time: the two kernels' device time over
the number of builds.  Stated against the published 3.35 TB/s.  None off
the banded engine, or where the stretch holds no build or the program
counts no right-hand sides."""

from portbench import yardstick_mf
from portbench.metrics import _program
from portbench.yardstick import bound_us

KERNELS = ("build_tiles", "matvec_kernel")
# the spans a traced run has to enter for this reading
SPANS = ("near_field",)


def read(win):
    rec = _program.recording(win)
    if rec is None or win.engine != "banded" or win.nf_bytes is None:
        return None
    rhs = rec.counts.get("near_field.rhs")
    calls = sum(1 for s in rec.spans if s[0] == "near_field.build_mv")
    ops = [o for o in win.records.ops if o.kind == "kernel"
           and o.span == "near_field" and any(k in o.name for k in KERNELS)]
    builds = sum(1 for o in ops if KERNELS[0] in o.name)
    busy = sum(o.dur_us for o in ops)
    if not rhs or not calls or not builds or busy <= 0:
        return None
    nbytes = yardstick_mf.build_mv_bytes(win.nf_bytes, win.n, rhs / calls)
    return 100.0 * bound_us(nbytes) * builds / busy
