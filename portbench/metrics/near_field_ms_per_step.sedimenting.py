"""near_field_ms_per_step.sedimenting: device ms per step under the
``near_field`` and ``nf_matvec`` spans, as ``near_field_ms_per_step``
reads it, in a cell whose step has no matvec outside its build_mv (an
athermal banded step: one build_mv and no Lanczos), so that a traced run
has to enter ``near_field`` alone."""

from portbench.metrics._common import per_step_ms
from portbench.trace import NEAR_FIELD

# the spans a traced run has to enter for this reading
SPANS = ("near_field",)


def read(win):
    return per_step_ms(win, NEAR_FIELD)
