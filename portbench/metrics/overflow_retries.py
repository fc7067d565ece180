"""overflow_retries: chunks the host loop rewound and ran again after a
capacity overflow, over the window (``sim.metrics``)."""


def read(win):
    return float(win.retries)
