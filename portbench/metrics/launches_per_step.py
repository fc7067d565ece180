"""launches_per_step: device kernels per traced step (torch.profiler)."""


def read(win):
    rec = win.records
    if rec is None or not rec.ops or not win.traced_steps:
        return None
    return sum(o.kind == "kernel" for o in rec.ops) / win.traced_steps
