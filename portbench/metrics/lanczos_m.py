"""lanczos_m: mean Lanczos iterations per step over the window
(``sim.metrics["m_lanczos_hist"]``); None for an athermal mix."""


def read(win):
    total = sum(win.m_hist.values())
    if not total or not any(m for m in win.m_hist if m):
        return None
    return sum(m * c for m, c in win.m_hist.items()) / total
