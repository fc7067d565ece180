"""The port's spans and counters (``pse_tpu_torch.trace``) on the CPU.

Off by default and without effect on a step; the span tree of a banded
step (Lanczos: one read per iteration, a matvec per iteration after the
first); the same layer spans on the blocked, gather and halo engines; one
recording per ``torch.profiler`` stretch, on the profiler's clock and
without a profiler record of its own; the overflow counts of a rewind; the
recording's memory bound.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile   # noqa: E402

import pse_tpu_torch as P                               # noqa: E402
from pse_tpu_torch import integrator as pi, trace      # noqa: E402
from pse_tpu_torch.parallel import halo, sharding       # noqa: E402

N, L = 1080, 24.0
LAYERS = {"step", "prepare", "prepare.bin", "prepare.ff_factors",
          "far_field", "far_field.fft", "far_field.ifft",
          "far_field.contract", "near_field.build_mv", "lanczos",
          "near_field.matvec", "sync.lanczos", "update"}
NAMES = LAYERS | {"run.chunk", "sync.overflow", "run.rewind",
                  "prepare.windows", "prepare.classes", "prepare.pair_blocks",
                  "prepare.pair_coeffs", "far_field.spread", "far_field.green",
                  "sync.tap_width", "sync.positions", "halo.exchange",
                  "lanczos.eigh"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _positions(n, box, seed=0):
    return np.random.default_rng(seed).uniform(
        -box / 2, box / 2, (n, 3)).astype(np.float32)


def _config(engine, n=N, box=L, **kw):
    params = P.make_params(xi=0.5, error=1e-3, L=box)
    return pi.make_config(params, n, engine=engine, seed=3, device="cpu",
                          **kw)


def _small_sim():
    """A gather-engine Simulation on 107 particles (all pairs): ~20 ms a
    step."""
    box = 10.0
    sim = P.Simulation(positions=_positions(107, box), L=box, dt=1e-3,
                       device="cpu")
    return sim.set_integrator(P.PSEv1(T=1.0, seed=2), engine="gather",
                              verbose=False)


def _children(rec, parent):
    return [s for s in rec.spans if s[1] == parent]


@pytest.fixture(scope="module")
def banded_step():
    """A thermal banded step outside any recording, the same step in a
    recording, and the recording."""
    cfg = _config("banded", has_forces=False)
    assert cfg.engine == "banded"
    st = pi.make_state(_positions(N, L), 5, 0.0, "cpu")
    last = trace.last_recording()
    off = pi.step(cfg, st, None, 1.0, 1e-3, 0.0)
    assert trace.last_recording() is last
    with trace.recording() as rec:
        on = pi.step(cfg, st, None, 1.0, 1e-3, 0.0)
    return off, on, rec


def test_off_by_default_and_a_step_is_bitwise_the_same(banded_step):
    """Off, a span is the one shared null context and records nothing;
    the recorded step equals the unrecorded one bitwise."""
    assert trace.span("step") is trace.span("lanczos")
    (s_off, i_off), (s_on, i_on), rec = banded_step
    assert torch.equal(s_off.pos, s_on.pos)
    assert torch.equal(s_off.images, s_on.images)
    assert torch.equal(i_off["velocities"], i_on["velocities"])
    assert i_off["m_lanczos"] == i_on["m_lanczos"]
    assert trace.last_recording() is rec and rec.steps == 1


def test_span_tree_of_a_banded_step(banded_step):
    """The step's layers in their parents, Lanczos' m - 1 matvecs and m
    reads under ``lanczos``, every child's interval inside its parent's."""
    _, (_, info), rec = banded_step
    m = info["m_lanczos"]
    assert {s[0] for s in rec.spans} >= LAYERS | {"prepare.windows"}
    assert {s[0] for s in _children(rec, "step")} == {
        "prepare", "far_field", "near_field.build_mv", "lanczos", "update"}
    assert {s[0] for s in _children(rec, "prepare")} == {
        "prepare.bin", "prepare.windows", "prepare.ff_factors"}
    assert {s[0] for s in _children(rec, "far_field")} == {
        "far_field.fft", "far_field.ifft", "far_field.contract"}
    under = [s[0] for s in _children(rec, "lanczos")]
    assert under.count("near_field.matvec") == m - 1
    assert under.count("sync.lanczos") == m
    assert under.count("lanczos.eigh") == rec.counts["lanczos.eigh"]
    assert set(under) == {"near_field.matvec", "sync.lanczos", "lanczos.eigh"}
    assert rec.counts["read.lanczos"] == rec.counts["lanczos.iterations"] == m
    # nested: each span lies in the interval of an open span of its
    # parent's name that ends after it
    for name, parent, t0, t1 in rec.spans:
        assert t0 <= t1
        if parent is not None:
            assert any(p[0] == parent and p[2] <= t0 and t1 <= p[3]
                       for p in rec.spans), (name, parent)
    (step,) = [s for s in rec.spans if s[0] == "step"]
    assert step[1] is None and rec.spans[-1] is step


@pytest.mark.parametrize("engine,n,box,child", [
    ("blocked", N, L, "prepare.pair_blocks"),
    ("gather", 600, 18.0, "prepare.pair_coeffs"),
])
def test_blocked_and_gather_steps_enter_the_same_layers(engine, n, box,
                                                        child):
    cfg = _config(engine, n, box, has_forces=False)
    assert cfg.engine == engine
    st = pi.make_state(_positions(n, box), 5, 0.0, "cpu")
    with trace.recording() as rec:
        _, info = pi.step(cfg, st, None, 1.0, 1e-3, 0.0)
    names = [s[0] for s in rec.spans]
    assert set(names) >= LAYERS | {child}
    assert names.count("sync.lanczos") == info["m_lanczos"]
    assert rec.steps == 1


@pytest.mark.parametrize("thermal,rhs", [(False, 1), (True, 2)])
def test_build_mv_right_hand_sides_counted(thermal, rhs):
    """A banded step with forces: the athermal one builds A against the
    forces alone (one right-hand side), the thermal one against the forces
    and the first Lanczos vector (two); each calls build_mv once."""
    cfg = _config("banded", thermal=thermal)
    assert cfg.engine == "banded" and cfg.has_forces
    st = pi.make_state(_positions(N, L), 5, 0.0, "cpu")
    forces = torch.tensor([0.0, 0.0, -1.0]).expand(N, 3)
    before = trace.counters().get("near_field.rhs", 0)
    with trace.recording() as rec:
        pi.step(cfg, st, forces, 1.0 if thermal else 0.0, 1e-3, 0.0)
    assert rec.counts["near_field.rhs"] == rhs
    assert trace.counters()["near_field.rhs"] == before + rhs
    assert [s[0] for s in rec.spans].count("near_field.build_mv") == 1
    assert ("lanczos" in {s[0] for s in rec.spans}) == thermal


def test_green_has_a_span_of_its_own(monkeypatch):
    """An athermal banded step with forces: the far field's spans in
    order, and the Green multiply runs inside ``far_field.green``, outside
    ``far_field.fft``, whose interval does not overlap it."""
    open_at_green = []
    real = pi.apply_green

    def green(*a, **k):
        open_at_green.append(list(trace._state.stack))
        return real(*a, **k)

    monkeypatch.setattr(pi, "apply_green", green)
    cfg = _config("banded", thermal=False)
    st = pi.make_state(_positions(N, L), 5, 0.0, "cpu")
    with trace.recording() as rec:
        pi.step(cfg, st, torch.ones(N, 3), 0.0, 1e-3, 0.0)
    assert open_at_green == [["step", "far_field", "far_field.green"]]
    under = _children(rec, "far_field")
    assert [s[0] for s in under] == [
        "far_field.spread", "far_field.fft", "far_field.green",
        "far_field.ifft", "far_field.contract"]
    (fft,), (g,) = ([s for s in under if s[0] == name]
                    for name in ("far_field.fft", "far_field.green"))
    assert fft[3] <= g[2]
    assert {s[0] for s in _children(rec, "step")} == {
        "prepare", "far_field", "near_field.build_mv", "update"}


def test_halo_engine_enters_the_same_layers():
    """The halo engine's U = M F on 2 CPU slabs: the layers of a mobility
    call, each slab's exchange and windows under ``prepare``."""
    n, box = 1500, 33.0
    cfg = _config("banded", n, box, shard_slabs=2)
    assert cfg.engine == "banded"
    mesh = sharding.make_mesh([torch.device("cpu")] * 2)
    forces = _positions(n, box, seed=1)
    with trace.recording() as rec:
        halo.make_halo_mobility(cfg, mesh)(_positions(n, box), forces)
    names = [s[0] for s in rec.spans]
    assert {s[0] for s in _children(rec, "step")} == {
        "prepare", "near_field.build_mv", "far_field"}
    assert {s[0] for s in _children(rec, "far_field")} == {
        "far_field.spread", "far_field.fft", "far_field.green",
        "far_field.ifft", "far_field.contract"}
    prep = [s[0] for s in _children(rec, "prepare")]
    assert prep.count("halo.exchange") == prep.count("prepare.windows") == 2
    assert names.count("step") == rec.steps == 1


def test_one_recording_per_profiled_stretch():
    """Two chunks in one profile are one recording; a span outside ends
    it; the next profile is a new recording, and last_recording() is it."""
    sim = _small_sim()
    sim.run(1)
    with profile(activities=[ProfilerActivity.CPU]):
        sim.run(2)
        sim.run(2)
    first = trace.last_recording()
    assert first.steps == 4 and first.counts["read.overflow"] == 2
    trace.count("read.after_the_profile")       # no longer on
    assert "read.after_the_profile" not in first.counts
    assert [s[0] for s in first.spans].count("run.chunk") == 2
    sim.run(1)                                  # spans find it off
    assert trace.last_recording() is first and first.steps == 4
    with profile(activities=[ProfilerActivity.CPU]):
        sim.run(3)
    second = trace.last_recording()
    assert second is not first and second.steps == 3
    assert second.counts["read.overflow"] == 1
    assert second.counts["read.lanczos"] == second.counts[
        "lanczos.iterations"]
    assert first.steps == 4


def test_profiler_records_lie_in_the_spans_that_ran_them():
    """On the profiler's clock: each host read of a scalar (aten::item)
    lies in a sync.* span, each inverse FFT in far_field.ifft, each op of
    the chunk in run.chunk, within 1 ms; the profile holds no record
    named by the program."""
    sim = _small_sim()
    sim.run(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(2)
    rec = trace.last_recording()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    tol = 1_000_000

    def inside(a, b, names):
        return any(s[0] in names and s[2] - tol <= a and b <= s[3] + tol
                   for s in rec.spans)

    reads = [e for e in events if e[0] == "aten::item"]
    ffts = [e for e in events if e[0] == "aten::fft_irfftn"]
    assert len(reads) == 3 and len(ffts) == 2     # 2 tap widths, 1 mask
    syncs = {s[0] for s in rec.spans if s[0].startswith("sync.")}
    assert all(inside(a, b, syncs) for _, a, b in reads)
    assert all(inside(a, b, {"far_field.ifft"}) for _, a, b in ffts)
    assert all(inside(a, b, {"run.chunk"}) for n, a, b in events
               if n.startswith("aten::"))
    assert not {n for n, _, _ in events} & (NAMES | {
        s[0] for s in rec.spans})


def test_overflow_counted_on_a_rewind():
    """A chunk whose Lanczos hits m_max rewinds: overflow.OVF_LANCZOS
    once, in the counters and the recording, under run.rewind."""
    sim = _small_sim()
    sim.config = dataclasses.replace(sim.config, m_max=2)
    before = trace.counters()
    with trace.recording() as rec:
        sim.run(1)
    after = trace.counters()
    assert sim.metrics["overflow_retries"] == 1
    assert after.get("overflow.OVF_LANCZOS", 0) == before.get(
        "overflow.OVF_LANCZOS", 0) + 1
    assert rec.counts["overflow.OVF_LANCZOS"] == 1
    assert not [k for k in rec.counts if k.startswith("overflow.")
                and k != "overflow.OVF_LANCZOS"]
    assert [s[0] for s in rec.spans].count("run.rewind") == 1
    assert rec.steps == 2                       # the rewound step counts


def test_counters_are_always_on():
    before = trace.counters()
    trace.count("test.counter", 3)
    with trace.recording() as rec:
        trace.count("test.counter")
    trace.count("test.counter")
    assert trace.counters()["test.counter"] == before.get(
        "test.counter", 0) + 5
    assert rec.counts == {"test.counter": 1}


def test_recording_memory_bound(monkeypatch):
    """Past MAX_SPANS a recording keeps no more spans and counts them in
    ``dropped``; its steps are still counted."""
    monkeypatch.setattr(trace, "MAX_SPANS", 10)
    sim = _small_sim()
    with trace.recording() as rec:
        sim.run(3)
    assert len(rec.spans) == 10 and rec.dropped > 0 and rec.steps == 3
    assert rec.counts["read.lanczos"] > 0
