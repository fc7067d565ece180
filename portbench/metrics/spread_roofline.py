"""spread_roofline: the share of its memory bound that the z-column spread
kernel (``csrc/spread.cu``, every ``spread_kernel`` launch of the traced
stretch) reaches, in %.

Bytes: ``yardstick_mf.spread_bytes`` (each particle's force and
coordinates read, the force grid written once, at the configuration the
window ran): the least a spread must move, whatever layout the kernel
writes.  Time: the launches' device time over their number.  Stated against the published 3.35 TB/s; the run prints the
card's power limit beside it.  None where no launch was traced."""

from portbench import yardstick_mf
from portbench.yardstick import bound_us

KERNEL = "spread_kernel"


def read(win):
    rec = win.records
    if rec is None:
        return None
    ops = [o for o in rec.ops if o.kind == "kernel" and KERNEL in o.name]
    busy = sum(o.dur_us for o in ops)
    if not ops or busy <= 0:
        return None
    nbytes = yardstick_mf.spread_bytes_of(win)
    if nbytes is None:
        return None
    return 100.0 * bound_us(nbytes) * len(ops) / busy
