"""setup_s: seconds from the start of the run to the window: imports,
inputs, the Simulation and its config, kernel build or load, warm-up
(end-to-end)."""


def read(win):
    return win.setup_s
