"""device_ms_per_step: the card's busy time over the whole window
(kernels, copies and sets, overlaps merged, from the profiler's device
activity records alone) / the steps completed (end-to-end)."""


def read(win):
    if win.device_busy_us is None or not win.steps:
        return None
    return win.device_busy_us / 1e3 / win.steps
