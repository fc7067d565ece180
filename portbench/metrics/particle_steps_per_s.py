"""particle_steps_per_s: N x steps completed in the window / the window's
wall time on the host clock, to the last synchronize (end-to-end)."""


def read(win):
    return win.n * win.steps / win.wall_s
