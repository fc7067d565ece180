"""mf_dispatch_ms_per_step: host milliseconds per recorded step inside the
program's ``far_field`` and ``near_field.build_mv`` spans (the M F path's
spread, transforms, Green and contract, and the build of A with its
matvec), less those blocked in its host reads (``sync.*``), from the
program's own recording of the traced stretch (``pse_tpu_torch.trace``)."""

from portbench.metrics import _program

SPANS_READ = ("far_field", "near_field.build_mv")


def read(win):
    rec = _program.recording(win)
    if rec is None:
        return None
    mf = _program._spans(rec, lambda name, parent: name in SPANS_READ)
    work = _program.minus(mf, _program.in_sync(rec))
    return _program.length(work) / 1e3 / rec.steps
