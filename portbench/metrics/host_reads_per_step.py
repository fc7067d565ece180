"""host_reads_per_step: device-to-host copies per traced step
(torch.profiler); each is a point where the host waits for the card."""


def read(win):
    rec = win.records
    if rec is None or not rec.ops or not win.traced_steps:
        return None
    return sum(o.kind == "d2h" for o in rec.ops) / win.traced_steps
