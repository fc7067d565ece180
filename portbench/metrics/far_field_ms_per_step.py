"""far_field_ms_per_step: device ms per step under the ``far_field`` span:
spread, FFTs, Green's function, wave-space noise, contract."""

from portbench.metrics._common import per_step_ms

# the spans a traced run has to enter for this reading
SPANS = ("far_field",)


def read(win):
    return per_step_ms(win, SPANS)
