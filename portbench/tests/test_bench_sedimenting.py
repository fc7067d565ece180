"""The athermal M F step's check (``banded.sedimenting``) on the CPU at a
size a test run holds: a sound run passes, the control fails it, and so
does a step that leaves out the wave space's M F; the M F path's readers
and byte counts on synthetic records.

As in ``test_bench_check.py``, the harness's look for a card is skipped
(``run_cell`` on the CPU, where the port runs its plain PyTorch versions);
the rest of a run is the benchmark's own.  The suspension is a full 16^3
jittered lattice at phi 0.45 (the 1M cell's full 100^3, at 4,096), where
hindered settling leaves M F at ~0.12 of a lone sphere's speed.
"""

import json
import time

import pytest
import torch

from portbench import run, yardstick_mf
from portbench.trace import DeviceRecords, Op
from pse_tpu_torch import trace

CFG = {"name": "tiny", "n": 4096, "phi": 0.45, "radius": 1.0, "xi": 0.5,
       "error": 1e-3, "dt": 1e-3, "jitter": 0.05,
       "precision": {"near_field_pairs": "bfloat16", "wave_space": "float32"}}
# the 1M cell's limits
LIMITS = run.load_json(run.HERE / "limits"
                       / "phi045-n1m.banded.sedimenting.json")
SEED = 2 ** 31 + 4242


def traffic():
    t = run.load_json(run.HERE / "traffic" / "banded.sedimenting.json")
    t.update(warmup_steps=1, warmup_chunk=1, warmup_quiet_seconds=0.0,
             timing_steps=2, chunk_seconds=0.5, check_rows=2000)
    return t


def kept_step():
    t = traffic()
    win, step = run.run_cell(CFG, t, SEED, 1.0, False, "cpu",
                             time.perf_counter())
    assert win.engine == "banded" and step.psi is None
    return step


def judged(step, lower=False):
    return run.judge(step, CFG, traffic(), LIMITS, SEED, lower=lower)


def passes(c):
    return all(v["value"] <= v["limit"] for v in c.values())


@pytest.fixture(scope="module")
def sound():
    return kept_step()


def test_sound_run_passes(sound):
    c = judged(sound)
    assert passes(c), c
    assert set(c) == {"gap", "largest_move", "replay"}
    assert c["replay"]["value"] == 0.0
    # the suspension settles, hindered: M F along the force, ~0.12 of a
    # lone sphere's speed
    v = sound.d_prog[:, 2].mean() / CFG["dt"]
    assert -0.2 < float(v) < -0.05


def test_control_fails(sound):
    c = judged(sound, lower=True)
    assert c["gap"]["value"] > 2 * judged(sound)["gap"]["value"], c
    assert not passes(c), c


def test_wave_space_left_out_fails(monkeypatch):
    from pse_tpu_torch import integrator

    real = integrator._far_field

    def no_wave_space(*a):
        return 0.0 * real(*a)

    monkeypatch.setattr(integrator, "_far_field", no_wave_space)
    c = judged(kept_step())
    assert c["replay"]["value"] == 0.0
    assert c["gap"]["value"] > LIMITS["gap"]["limit"], c


def test_window_step_off_by_a_percent_fails_replay(monkeypatch):
    """The step Simulation.run takes moves every particle 1 % further than
    the program's step does: the replay, through the program's own step,
    lands elsewhere."""
    from pse_tpu_torch import api

    real = api._step

    def further(config, state, *a, **k):
        new, info = real(config, state, *a, **k)
        return new._replace(pos=state.pos + 1.01 * (new.pos - state.pos)), \
            info

    monkeypatch.setattr(api, "_step", further)
    c = judged(kept_step())
    assert c["replay"]["value"] > 10 * LIMITS["replay"]["limit"], c


def _win(ops, n=CFG["n"], steps=2, nf_bytes=None, engine="banded"):
    return run.Window(records=DeviceRecords(ops, {"near_field": steps},
                                            20_000.0),
                      traced_steps=steps, n=n, L=run.box_length(CFG),
                      nf_bytes=nf_bytes, engine=engine)


def _op(name, dur_us, span="near_field"):
    return Op(name, 0.0, float(dur_us), "kernel", span)


def test_spread_bytes_count_the_slots_and_the_windows():
    from pse_tpu_torch.ops.column_farfield import make_col_spec
    from pse_tpu_torch.params import make_params

    L = run.box_length(CFG)
    p = make_params(0.5, 1e-3, L)
    spec = make_col_spec(p, CFG["n"], device="cuda")
    sx, sy = spec.s
    ncx, ncy, _ = spec.bins.n_cells
    # the grid written once (not the kernel's 9-fold window moments), the
    # particles' forces and coordinates read, padding slots left out
    grid = 3 * p.Nx * p.Ny * p.Nz * 4
    assert grid == ncx * sx * ncy * sy * 3 * p.Nz * 4
    assert yardstick_mf.spread_bytes(CFG["n"], L, 0.5, 1e-3) == \
        grid + CFG["n"] * 24
    # a window matches the configuration files by N and box length alone:
    # the 1M Brownian and sedimentation deployments, one xi and error
    assert yardstick_mf.config_of(1_000_000, 210.0) is None
    cfg = yardstick_mf.config_of(1_000_000,
                                 run.box_length({"n": 1_000_000,
                                                 "phi": 0.45}))
    assert (cfg["xi"], cfg["error"]) == (0.5, 1e-3)


def test_config_of_refuses_matches_that_disagree(tmp_path, monkeypatch):
    base = {"n": 1000, "phi": 0.45, "xi": 0.5, "error": 1e-3}
    (tmp_path / "configs").mkdir()
    for name, error in (("a", 1e-3), ("b", 1e-3)):
        (tmp_path / "configs" / f"{name}.json").write_text(
            json.dumps(dict(base, name=name, error=error)))
    monkeypatch.setattr(yardstick_mf, "HERE", tmp_path)
    L = run.box_length(base)
    assert yardstick_mf.config_of(1000, L)["error"] == 1e-3
    (tmp_path / "configs" / "b.json").write_text(
        json.dumps(dict(base, name="b", error=1e-4)))
    assert yardstick_mf.config_of(1000, L) is None


def test_sedimentation_config_is_the_traffic_and_the_1m_suspension():
    """The deployment states what its traffic runs (kT, the body force)
    and is the 1M Brownian cell's suspension, uncut."""
    sed = run.load_json(run.HERE / "configs"
                        / "phi045-n1m-sedimentation.json")
    brownian = run.load_json(run.HERE / "configs" / "phi045-n1m.json")
    t = run.load_json(run.HERE / "traffic" / "banded.sedimenting.json")
    assert sed["kT"] == t["kT"] == 0.0
    assert sed["body_force"] == t["body_force"] == [0.0, 0.0, -1.0]
    for key in ("n", "phi", "radius", "xi", "error", "dt", "jitter",
                "precision"):
        assert sed[key] == brownian[key], key
    assert sed["reduced"] == []


def test_build_mv_bytes_write_and_read_a_once():
    n, a = 1000, 5_000_000
    nf = a + 2 * n * 12                      # one application, one RHS
    assert yardstick_mf.build_mv_bytes(nf, n, 1) == 2 * a + 2 * n * 12
    assert yardstick_mf.build_mv_bytes(nf, n, 2) == 2 * a + 4 * n * 12


def test_readers_return_none_without_their_kernels_or_counts(monkeypatch):
    ops = [_op("void cutlass_gemm", 10.0, "far_field")]
    win = _win(ops, nf_bytes=1e6)
    for name in ("spread_roofline", "build_mv_roofline",
                 "build_mv_rhs_per_step", "mf_dispatch_ms_per_step"):
        assert run.reader(name)(run.Window(records=None, traced_steps=0,
                                           n=1, L=1.0, nf_bytes=None,
                                           engine="banded")) is None
    # the configuration of the window is not among the files
    assert run.reader("spread_roofline")(
        _win([_op("spread_kernel<true>", 5.0, "far_field")], n=4096)) is None
    rec = trace.Recording()
    rec._add("step", None, 0, 10)
    monkeypatch.setattr(trace, "last_recording", lambda: rec)
    # a program that counts no right-hand sides (the parent's)
    assert run.reader("build_mv_rhs_per_step")(win) is None
    assert run.reader("build_mv_roofline")(win) is None


def test_readers_on_a_synthetic_stretch(monkeypatch):
    """Two steps, each a 2 ms far field and a 1 ms build_mv on the host,
    and a build of one right-hand side whose two kernels take 3 us."""
    n, a = 10_000, 3_350_000                  # A: 1 us at 3.35 TB/s
    rec = trace.Recording()
    t0 = 1_700_000_000 * 10 ** 9
    for k in range(2):
        s = t0 + k * 10_000_000
        rec._add("far_field", "step", s, s + 2_000_000)
        rec._add("near_field.build_mv", "step", s + 3_000_000,
                 s + 4_000_000)
        rec._add("step", None, s, s + 9_000_000)
    rec.counts["near_field.rhs"] = 2
    monkeypatch.setattr(trace, "last_recording", lambda: rec)
    ops = [_op("void (anonymous namespace)::build_tiles<bf16>", 1.5),
           _op("void (anonymous namespace)::matvec_kernel<1, bf16>", 1.5),
           _op("void (anonymous namespace)::build_tiles<bf16>", 1.5),
           _op("void (anonymous namespace)::matvec_kernel<1, bf16>", 1.5),
           _op("void (anonymous namespace)::matvec_kernel<1, bf16>", 9.0,
               "nf_matvec")]
    win = _win(ops, n=n, nf_bytes=a + 2 * n * 12)
    assert run.reader("build_mv_rhs_per_step")(win) == 1.0
    assert run.reader("mf_dispatch_ms_per_step")(win) == pytest.approx(3.0)
    bound = (2 * a + 2 * n * 12) / 3.35e12 * 1e6
    assert run.reader("build_mv_roofline")(win) == pytest.approx(
        100.0 * bound / 3.0)
