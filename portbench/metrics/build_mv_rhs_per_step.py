"""build_mv_rhs_per_step: the right-hand sides that the step's build_mv
calls carry, per recorded step (the program's ``near_field.rhs`` counter
over its recording's steps): 1 in an athermal step, 1 in a force-free
thermal one, 2 in a thermal banded step with forces.  None where the
program counts none."""

from portbench.metrics import _program


def read(win):
    rec = _program.recording(win)
    rhs = None if rec is None else rec.counts.get("near_field.rhs")
    if not rhs:
        return None
    return rhs / rec.steps
