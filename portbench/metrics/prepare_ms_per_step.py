"""prepare_ms_per_step: device ms per step under the ``prepare`` span: the
engines' binnings, band windows, occupancy classes and far-field
factors."""

from portbench.metrics._common import per_step_ms

# the spans a traced run has to enter for this reading
SPANS = ("prepare",)


def read(win):
    return per_step_ms(win, SPANS)
