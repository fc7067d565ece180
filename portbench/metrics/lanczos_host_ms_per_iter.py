"""lanczos_host_ms_per_iter: host milliseconds per Lanczos iteration of
the Lanczos loop's own work: its ``lanczos`` spans with their
``lanczos.eigh`` children, less the near-field matvecs and the host reads
they hold, over ``lanczos.iterations``, from the program's own recording
of the traced stretch."""

from portbench.metrics import _program


def read(win):
    rec = _program.recording(win)
    iters = None if rec is None else rec.counts.get("lanczos.iterations")
    if not iters:
        return None
    ns = sum(t1 - t0 for name, parent, t0, t1 in rec.spans
             if name == "lanczos")
    ns -= sum(t1 - t0 for name, parent, t0, t1 in rec.spans
              if parent == "lanczos"
              and name in ("near_field.matvec", "sync.lanczos"))
    return ns / 1e6 / iters
