"""near_field_ms_per_step: device ms per step under the ``near_field`` and
``nf_matvec`` spans: the banded build_mv and matvecs, or the blocked pair
blocks and cell matvecs."""

from portbench.metrics._common import per_step_ms
from portbench.trace import NEAR_FIELD

# the spans a traced run has to enter for this reading
SPANS = NEAR_FIELD


def read(win):
    return per_step_ms(win, SPANS)
