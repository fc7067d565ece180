"""The check on the CPU at a size a test run holds: a sound run passes; the
control and runs with the timed path broken underneath do not.

The harness's look for a card is skipped (``run_cell`` on the CPU, where
the port runs its plain PyTorch versions); the rest of a run is the
benchmark's own: inputs from the seed, warm-up, the window with its kept
step, the replays, the reference and the comparison.
"""

import time

import pytest
import torch

from portbench import run

CFG = {"name": "tiny", "n": 3000, "phi": 0.3, "radius": 1.0, "xi": 0.5,
       "error": 1e-3, "dt": 1e-3, "jitter": 0.05,
       "precision": {"near_field_pairs": "bfloat16", "wave_space": "float32"}}
# the cells' limits, but the draws' (whose statistical spread grows as
# 1/sqrt(N)) widened to this N
LIMITS = {"gap": {"limit": 0.006}, "near_gap": {"limit": 0.002},
          "largest_move": {"limit": 30.0}, "replay": {"limit": 0.001},
          "draws": {"limit": 0.06}, "psi_map": {"limit": 0}}
SEED = 2 ** 31 + 12345


def traffic(name):
    t = run.load_json(run.HERE / "traffic" / f"{name}.json")
    t.update(warmup_steps=1, warmup_chunk=1, warmup_quiet_seconds=0.0,
             timing_steps=2, chunk_seconds=0.5, check_rows=2000)
    return t


def checks(mix, lower=False, seconds=1.5):
    t = traffic(mix)
    _, step = run.run_cell(CFG, t, SEED, seconds, False, "cpu",
                           time.perf_counter())
    return run.judge(step, CFG, t, LIMITS, SEED, lower=lower)


def passes(c):
    return all(v["value"] <= v["limit"] for v in c.values())


@pytest.mark.parametrize("mix", ["blocked.forces", "banded.brownian",
                                 "banded-uniform.brownian"])
def test_sound_run_passes(mix):
    c = checks(mix)
    assert passes(c), c
    assert {"gap", "near_gap", "replay", "draws", "largest_move",
            "psi_map"} <= set(c)


def test_control_fails():
    c = checks("blocked.forces", lower=True)
    assert c["near_gap"]["value"] > LIMITS["near_gap"]["limit"], c


def _patched_step(monkeypatch, change):
    """Break the step that Simulation.run calls: ``change(old, new)``
    returns the positions the broken step hands back."""
    from pse_tpu_torch import api

    real = api._step

    def broken(config, state, *a, **k):
        new, info = real(config, state, *a, **k)
        return new._replace(pos=change(state.pos, new.pos)), info

    monkeypatch.setattr(api, "_step", broken)


def test_unchanged_state_fails(monkeypatch):
    _patched_step(monkeypatch, lambda old, new: old.clone())
    assert not passes(checks("blocked.forces"))


def test_half_the_particles_left_out_fails(monkeypatch):
    def half(old, new):
        out = new.clone()
        out[::2] = old[::2]
        return out

    _patched_step(monkeypatch, half)
    assert not passes(checks("banded.brownian"))


def test_altered_answer_fails(monkeypatch):
    # the Lanczos square root's answer altered where it is produced
    from pse_tpu_torch.ops import lanczos

    real = lanczos.sqrt_mreal

    def altered(*a, **k):
        u, m, hit = real(*a, **k)
        return u * 1.01, m, hit

    monkeypatch.setattr(lanczos, "sqrt_mreal", altered)
    c = checks("banded.brownian")
    assert not passes(c) and c["near_gap"]["value"] > 0.002, c


def test_one_particle_thrown_fails(monkeypatch):
    def thrown(old, new):
        out = new.clone()
        out[7] += 1.0
        return out

    _patched_step(monkeypatch, thrown)
    assert not passes(checks("blocked.forces"))


def test_psi_mapping_that_repeats_a_draw_fails(monkeypatch):
    # two particles handed one slot's draw, where the psi is mapped
    from pse_tpu_torch import integrator

    real = integrator.BandedEngine.psi_result_to_particles

    def repeated(self, ctx, cells):
        psi = real(self, ctx, cells).clone()
        psi[1] = psi[0]
        return psi

    monkeypatch.setattr(integrator.BandedEngine, "psi_result_to_particles",
                        repeated)
    c = checks("banded.brownian")
    assert c["psi_map"]["value"] >= 1 and not passes(c), c


def test_mapping_faults_counts_rows():
    from portbench.check import mapping_faults

    g = torch.Generator().manual_seed(5)
    slots = torch.rand((3, 4, 6), generator=g)
    slots[:, :, 4:] = 0.0                       # empty slots
    live = slots.reshape(3, -1).t()
    live = live[(live != 0).any(1)]
    perm = torch.randperm(live.shape[0], generator=g)
    assert mapping_faults(live[perm], slots) == 0
    dup = live[perm].clone()
    dup[3] = dup[2]
    assert mapping_faults(dup, slots) == 1      # one row repeated
    empty = live[perm].clone()
    empty[0] = 0.0
    assert mapping_faults(empty, slots) == 1
    assert mapping_faults(live[perm][:-1], slots) == 1
