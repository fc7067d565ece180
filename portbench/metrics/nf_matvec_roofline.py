"""nf_matvec_roofline: the share of its memory bound that one application
of the stored near-field operator reaches, in %.

Bytes: ``yardstick.nf_application_bytes`` (the least an application needs,
each counted once).  Time: the device time of the applications' own
kernels, by name where the engine has a kernel of its own (banded: every
``matvec_kernel`` launch, inside build_mv or the Lanczos loop), else the
kernels launched inside the ``nf_matvec`` span (blocked: library kernels
only), over the number of applications.  Stated against the published
3.35 TB/s; the run prints the card's power limit beside it."""

from portbench.yardstick import bound_us

KERNEL = {"banded": "matvec_kernel"}
# the spans a traced run has to enter for this reading (blocked: its time)
SPANS = ("nf_matvec",)


def read(win):
    rec = win.records
    if rec is None or win.nf_bytes is None:
        return None
    name = KERNEL.get(win.engine)
    if name is not None:
        ops = [o for o in rec.ops if o.kind == "kernel" and name in o.name]
        count = len(ops)
    else:
        ops = [o for o in rec.ops if o.span == "nf_matvec"]
        count = rec.span_counts.get("nf_matvec", 0)
    busy = sum(o.dur_us for o in ops)
    if not count or busy <= 0:
        return None
    return 100.0 * bound_us(win.nf_bytes) * count / busy
