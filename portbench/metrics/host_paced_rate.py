"""host_paced_rate: N x steps completed in the window / its wall time on
the host clock, read in the traced run (whose window runs untraced)."""


def read(win):
    return win.n * win.steps / win.wall_s
