"""untracked_reads_per_step: device-to-host copies per recorded step that
the program does not count as its own host reads: the copies of the
traced stretch (torch.profiler) less the recording's ``read.*`` counts
(``pse_tpu_torch.trace``), over its steps."""

from portbench.metrics import _program


def read(win):
    rec = _program.recording(win)
    if rec is None:
        return None
    copies = sum(o.kind == "d2h" for o in win.records.ops)
    counted = sum(n for name, n in rec.counts.items()
                  if name.startswith("read."))
    return (copies - counted) / rec.steps
