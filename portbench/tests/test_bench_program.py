"""The readers of the program's own recording (``metrics/_program.py``) on
a synthetic recording and synthetic device operations, and on a stretch
traced as the harness traces one, on the CPU."""

import sys

import pytest

from portbench import run
from portbench.trace import DeviceRecords, Op
from pse_tpu_torch import trace

MS = 1_000_000        # ns


def _win(ops, steps=2):
    return run.Window(records=DeviceRecords(ops, {}, 20_000.0),
                      traced_steps=steps)


def _op(start_us, end_us, kind="kernel"):
    return Op("k", float(start_us), float(end_us - start_us), kind,
              "host_loop")


@pytest.fixture
def synthetic(monkeypatch):
    """One chunk of two steps (us): the chunk [0, 10000], steps [0, 4500]
    and [4500, 9000], Lanczos [2000, 8000] in the second with a matvec
    [3000, 4000], a read [5000, 6000] and an eigh [6500, 7000], the
    overflow read [9500, 9900]; device operations with idle gaps in
    dispatch, in reads and outside the program."""
    rec = trace.Recording()
    t0 = 1_700_000_000 * 1000 * MS
    for name, parent, a, b in (
            ("step", "run.chunk", 0, 4500),
            ("near_field.matvec", "lanczos", 3000, 4000),
            ("sync.lanczos", "lanczos", 5000, 6000),
            ("lanczos.eigh", "lanczos", 6500, 7000),
            ("lanczos", "step", 2000, 8000),
            ("step", "run.chunk", 4500, 9000),
            ("sync.overflow", "run.chunk", 9500, 9900),
            ("run.chunk", None, 0, 10000)):
        rec._add(name, parent, t0 + a * 1000, t0 + b * 1000)
    rec.counts.update({"read.lanczos": 1, "read.overflow": 1,
                       "lanczos.iterations": 2, "launch.matvec_banded": 1})
    monkeypatch.setattr(trace, "last_recording", lambda: rec)
    base = t0 / 1000
    ops = [_op(base + a, base + b, kind) for a, b, kind in (
        (0, 1000, "kernel"),
        (1500, 5100, "kernel"),      # gap [1000, 1500]: dispatch
        (5900, 5950, "d2h"),         # gap [5100, 5900]: in the read
        (9200, 9500, "kernel"),      # gap [5950, 9200]: 50 read, 3200 not
        (9800, 9810, "d2h"),         # gap [9500, 9800]: in the read
        (10500, 10600, "kernel"),    # gap [9810, 10500]: 90 read, 100
        (10700, 10710, "d2h"))]      # dispatch, 500 outside; then 100 out
    return rec, ops


def test_a_gap_in_dispatch_counts_and_one_in_a_read_does_not(synthetic):
    _, ops = synthetic
    idle = 500 + 800 + 3250 + 300 + 690 + 100
    dispatch = 500 + 3200 + 100
    got = run.reader("idle_in_dispatch_pct")(_win(ops))
    assert got == pytest.approx(100.0 * dispatch / idle, rel=1e-9)


def test_dispatch_and_wait_per_step(synthetic):
    _, ops = synthetic
    win = _win(ops)
    # the chunk's 10 ms less the 1.4 ms of reads, over 2 steps
    assert run.reader("host_dispatch_ms_per_step")(win) == pytest.approx(4.3)
    assert run.reader("host_wait_ms_per_step")(win) == pytest.approx(0.7)


def test_lanczos_self_time_excludes_matvecs_and_reads(synthetic):
    _, ops = synthetic
    # 6 ms of Lanczos less the 1 ms matvec and the 1 ms read (its eigh
    # kept), over 2 iterations
    assert run.reader("lanczos_host_ms_per_iter")(_win(ops)) == \
        pytest.approx(2.0)


def test_untracked_reads_are_copies_less_counts(synthetic):
    rec, ops = synthetic
    # 3 copies, 2 counted reads (the launch count is no read), 2 steps
    assert run.reader("untracked_reads_per_step")(_win(ops)) == 0.5
    rec.counts["read.tap_width"] = 1
    assert run.reader("untracked_reads_per_step")(_win(ops)) == 0.0


def test_no_recording_no_reading(synthetic, monkeypatch):
    """Untraced, a recording that dropped spans, or a program without
    ``pse_tpu_torch.trace`` (as before it had one): every reader gives
    None and raises nothing."""
    rec, ops = synthetic
    names = ("host_dispatch_ms_per_step", "host_wait_ms_per_step",
             "idle_in_dispatch_pct", "lanczos_host_ms_per_iter",
             "untracked_reads_per_step")
    untraced = run.Window(records=None, traced_steps=0)
    assert all(run.reader(n)(untraced) is None for n in names)
    rec.dropped = 1
    assert all(run.reader(n)(_win(ops)) is None for n in names)
    rec.dropped = 0
    import pse_tpu_torch

    monkeypatch.delattr(pse_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "pse_tpu_torch.trace", None)
    assert all(run.reader(n)(_win(ops)) is None for n in names)


def test_readers_declare_no_spans():
    """``run.py`` refuses a traced run that never entered a reader's
    ``SPANS``, which name the harness's own wrappers only."""
    for n in ("host_dispatch_ms_per_step", "host_wait_ms_per_step",
              "idle_in_dispatch_pct", "lanczos_host_ms_per_iter",
              "untracked_reads_per_step"):
        assert not hasattr(run.metric_module(n), "SPANS")


def test_the_traced_stretch_is_one_recording_beside_the_wrappers():
    """As a ``--trace 1`` run traces (the harness's wrappers, then the
    profiler) on the CPU: the program's recording covers the stretch's
    steps, chunks and their overflow reads; the profile holds the
    wrappers' spans and nothing the program names; a step after the
    stretch starts no recording."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import pse_tpu_torch as pse
    from portbench import trace as trace_mod

    box = 10.0
    pos = np.random.default_rng(1).uniform(-box / 2, box / 2, (107, 3))
    sim = pse.Simulation(positions=pos.astype(np.float32), L=box, dt=1e-3,
                         device="cpu", sync_every=2)
    sim.set_integrator(pse.PSEv1(T=1.0, seed=3), engine="gather",
                       verbose=False)
    sim.run(1)
    with trace_mod.Spans(), profile(activities=[ProfilerActivity.CPU]) as p:
        sim.run(5)
    rec = trace.last_recording()
    assert rec.steps == 5 and not rec.dropped
    assert rec.counts["read.overflow"] == 3 == sum(
        s[0] == "run.chunk" for s in rec.spans)
    names = {e.name() for e in p.profiler.kineto_results.events()}
    assert {"step", "prepare", "lanczos"} <= names
    assert not names & ({s[0] for s in rec.spans} - set(trace_mod.SPANS))
    sim.run(1)
    assert trace.last_recording() is rec
