"""Card-only cases: the traced stretch's reduction on real device records.
They skip without a CUDA device (decided inside the test)."""

import time

import pytest

from portbench import run, trace
from portbench.tests.test_bench_check import CFG, LIMITS, SEED, traffic


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device records and the "
                    "port's kernels exist only on the card")
    return "cuda:0"


@pytest.mark.cuda
def test_traced_stretch_on_the_card(card):
    t = traffic("banded.brownian")
    win, step = run.run_cell(CFG, t, SEED, 2.0, True, card,
                             time.perf_counter())
    rec = win.records
    assert rec is not None and win.traced_steps >= 3
    assert any(o.kind == "kernel" for o in rec.ops)
    assert any("matvec_kernel" in o.name and o.span in ("near_field",
                                                        "nf_matvec")
               for o in rec.ops)
    assert not trace.missing_spans(rec, ("step", "prepare", "near_field",
                                         "nf_matvec", "far_field", "lanczos"))
    roof = run.reader("nf_matvec_roofline")(win)
    assert roof is not None and 0 < roof <= 100
    idle = run.reader("device_idle_pct")(win)
    assert 0 <= idle < 100
    c = run.judge(step, CFG, t, LIMITS, SEED)
    assert all(v["value"] <= v["limit"] for v in c.values()), c
