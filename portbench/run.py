"""Run one benchmark cell of ``pse_tpu_torch`` on the card and print its
result as one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
a configuration (``portbench/configs/<config>.json``: the suspension) and a
traffic mix (``portbench/traffic/<traffic>.json``: the engine, the start,
the capacities grown up front, kT, forces, warm-up and check sizes);
``portbench/limits/<cell>.json`` holds the limits of the cell's
correctness check, and each metric is read by
``portbench/metrics/<name>.py`` (a name with a suffix after its first dot
falls back to the reader of the part before it).  A new cell, mix or
metric is a new file.

One run: positions (and forces) from ``--seed`` on the device; a
``Simulation`` with the mix's engine (and the capacities the mix names
grown to the steady state's); a warm-up of the cell's own shapes
(on N = 1M it runs through the column cap's regrow, as a user's run
would); then ``Simulation.run`` in chunks for ``--seconds``, one of them
a single step at a point drawn from the seed, whose input and output
state the check keeps.  With ``--trace 1`` one stretch of the window runs
under ``torch.profiler`` with the layer spans of ``portbench.trace``, and
the per-layer metrics are printed instead of the end-to-end ones; a
traced run that never enters a span its metrics read prints no result.
A regrow in the window or the traced stretch is reported on standard
error and counted by ``overflow_retries``.  After
the window the check (``portbench.check``) holds the kept step against
the float64 reference (``portbench.reference``).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pse_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str):
    """(cell entry, configuration, traffic mix, limits) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    return (cell, load_json(HERE / "configs" / f"{cell['config']}.json"),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            load_json(HERE / "limits" / f"{workload}.json"))


def metric_module(name: str):
    """The module that reads metric ``name``: metrics/<name>.py, else the
    file of the name's part before its first dot.  Its ``read(win)`` gives
    the number; its ``SPANS``, where it has one, the spans a traced run has
    to enter for it."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"portbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r}")


def reader(name: str):
    """The ``read`` function of metric ``name``."""
    return metric_module(name).read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics the cell reports: end-to-end ones untraced, per-layer
    ones traced; a metric with ``workloads`` only in those cells."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def box_length(cfg: dict) -> float:
    """The cubic box of N spheres of radius 1 at volume fraction phi."""
    return (cfg["n"] * 4.0 / 3.0 * math.pi / cfg["phi"]) ** (1.0 / 3.0)


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    """Positions (N, 3) and forces (N, 3) or None, from ``seed``, made on
    ``device`` in a few calls.  The mix's ``start``: "lattice" (the
    default), the vacancy-diluted simple-cubic lattice at the
    configuration's phi (sites chosen at random, jittered by ``jitter`` of
    the spacing); "uniform", positions uniform in the box, the stationary
    distribution of spheres with no forces between them.  Then the mix's
    forces (standard normal components, or a body force on every
    particle)."""
    import torch

    n, L = cfg["n"], box_length(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    start = traffic.get("start", "lattice")
    if start == "uniform":
        pos = (torch.rand((n, 3), generator=g, device=device,
                          dtype=torch.float64) - 0.5) * L
    elif start == "lattice":
        n_side = int(math.ceil(n ** (1.0 / 3.0)))
        a = L / n_side
        keep = torch.sort(torch.randperm(n_side ** 3, generator=g,
                                         device=device)[:n]).values
        ijk = torch.stack([keep // (n_side * n_side),
                           (keep // n_side) % n_side, keep % n_side], dim=1)
        pos = (ijk.double() + 0.5) * a - L / 2.0
        pos = pos + cfg["jitter"] * a * torch.randn(
            (n, 3), generator=g, device=device, dtype=torch.float64)
    else:
        raise ValueError(f"unknown start {start!r}")
    pos = pos.float()
    forces = None
    kind = traffic["forces"]
    if kind == "normal":
        forces = torch.randn((n, 3), generator=g, device=device)
    elif kind == "body":
        forces = torch.tensor(traffic["body_force"], dtype=torch.float32,
                              device=device).expand(n, 3).contiguous()
    elif kind != "none":
        raise ValueError(f"unknown forces {kind!r}")
    return pos, forces


class Window:
    """What the measured window leaves for the readers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _counters(sim):
    m = sim.metrics
    return m["steps"], m["overflow_retries"], dict(m["m_lanczos_hist"])


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             device_window: bool = False):
    """Set up, warm up and measure one cell; returns (window, the kept
    step), the program freed.  ``t_start``: when the run began (set-up
    counts from it); ``device_window``: record the device's activity over
    the whole window (for an end-to-end metric read from the device
    trace)."""
    import torch

    import pse_tpu_torch as pse
    from portbench import check as check_mod
    from portbench import reference
    from portbench import trace as trace_mod
    from portbench import yardstick

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    n, L = cfg["n"], box_length(cfg)
    pos, forces = make_inputs(cfg, traffic, seed, dev)
    force_fn = None if forces is None else (lambda p, t: forces)
    sim = pse.Simulation(positions=pos.cpu().numpy(), L=L, dt=cfg["dt"],
                         force_fn=force_fn, device=str(dev))
    kw = {"engine": traffic["engine"]} if traffic.get("engine") else {}
    sim.set_integrator(pse.PSEv1(T=traffic["kT"], seed=int(seed),
                                 xi=cfg["xi"], error=cfg["error"]),
                       verbose=False, **kw)
    if sim.config.engine != traffic.get("engine", sim.config.engine):
        raise RuntimeError(f"the program chose the {sim.config.engine} "
                           f"engine, not the mix's {traffic['engine']}")
    if traffic.get("grow"):
        # the capacities that the mix's steady state overflows early in
        # every run (Simulation.run grows them on a rewind): grown at the
        # start, so that no run changes its configuration partway
        from pse_tpu_torch import integrator

        flags = 0
        for name in traffic["grow"]:
            flags |= getattr(integrator, name)
        sim.config = integrator.grow_config(sim.config, flags=flags)

    # warm-up: the cell's shapes, through any regrow, until no retry for
    # the mix's quiet stretch; then a timed chunk sizes the window's chunks
    warm, quiet_since = 0, time.perf_counter()
    while True:
        r0 = sim.metrics["overflow_retries"]
        sim.run(traffic["warmup_chunk"])
        warm += traffic["warmup_chunk"]
        if sim.metrics["overflow_retries"] != r0:
            quiet_since = time.perf_counter()
        if warm >= traffic["warmup_steps"] and time.perf_counter() - \
                quiet_since >= traffic.get("warmup_quiet_seconds", 0.0):
            break
    k = max(2, traffic["timing_steps"])
    sync()
    t0 = time.perf_counter()
    sim.run(k)
    step_s = (time.perf_counter() - t0) / k
    sync()
    setup_s = time.perf_counter() - t_start

    # the window: chunks of Simulation.run, one of them the kept step
    rng = torch.Generator().manual_seed(int(seed) + 1)
    check_at = seconds * (0.25 + 0.5 * float(torch.rand((), generator=rng)))
    chunk = max(1, int(round(traffic["chunk_seconds"] / step_s)))
    steps0, retries0, hist0 = _counters(sim)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    activity = None
    if device_window and cuda and not trace:
        from torch.profiler import ProfilerActivity, profile

        activity = profile(activities=[ProfilerActivity.CUDA])
        activity.__enter__()
    kept = None
    config0 = sim.config
    t0 = time.perf_counter()
    while True:
        el = time.perf_counter() - t0
        done = el >= seconds - 0.5 * step_s
        if done and kept is not None:
            break
        if kept is None and (el >= check_at or done):
            pre = sim.state
            sim.run(1)
            # the config the step ran under (a rewound step reruns grown)
            kept = (pre, sim.state, sim.config)
            continue
        sim.run(max(1, min(chunk, int((seconds - el) / step_s))))
    sync()
    wall = time.perf_counter() - t0
    if activity is not None:
        activity.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    steps1, retries1, hist1 = _counters(sim)
    win = Window(
        n=n, L=L, seconds=seconds, wall_s=wall, setup_s=setup_s,
        steps=steps1 - steps0, retries=retries1 - retries0,
        m_hist={m: hist1.get(m, 0) - hist0.get(m, 0) for m in hist1},
        peak_bytes=peak, step_s=step_s, engine=sim.config.engine,
        records=None, traced_steps=0, device_busy_us=None,
        nf_bytes=yardstick.nf_application_bytes(sim.config, sim.state.pos,
                                                (L, L, L)),
        power_limit_w=None, config_changed=sim.config is not config0)
    if activity is not None:
        win.device_busy_us = trace_mod.device_busy_us(activity)
        del activity
    if trace:
        # the traced stretch follows the window, on the same Simulation,
        # so that the window itself runs as in an untraced run
        from torch.profiler import ProfilerActivity, profile

        k = max(3, int(round(traffic["trace_seconds"] / step_s)))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        s0 = sim.metrics["steps"]
        with trace_mod.Spans(), profile(activities=acts) as prof:
            tt = time.perf_counter()
            sim.run(k)
            sync()
            traced_s = time.perf_counter() - tt
        win.traced_steps = sim.metrics["steps"] - s0
        win.config_changed |= sim.config is not config0
        win.records = trace_mod.reduce(prof, traced_s)
        del prof

    pre, post, cfg_at = kept
    grid = reference.derive(cfg["xi"], cfg["error"], (L, L, L)).grid
    psi, wave, replay, near, psi_map = check_mod.draws(cfg_at, pre, forces,
                                              traffic["kT"], cfg["dt"], grid)
    step = Kept(pre_pos=pre.pos, post_pos=post.pos, replay_pos=replay,
                d_prog=check_mod.displacement(pre.pos, pre.images, post.pos,
                                              post.images, L),
                d_near=near,
                psi=psi, wave=wave, forces=forces, psi_map=psi_map)
    # the reference runs once the program's state is freed
    del sim, pre, post, kept, cfg_at
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return win, step


class Kept(NamedTuple):
    """The kept step: its input and output positions, the replay's, the
    unwrapped displacement and that of the replay without the wave draw,
    its draws and forces, and ``check.mapping_faults`` of its psi."""

    pre_pos: object
    post_pos: object
    replay_pos: object
    d_prog: object
    d_near: object
    psi: object
    wave: object
    forces: object
    psi_map: object


def judge(step: Kept, cfg, traffic, limits, seed, lower=False):
    from portbench import check as check_mod

    return check_mod.judge(step.pre_pos, step.d_prog, step.d_near,
                           step.replay_pos,
                           step.post_pos, step.psi, step.wave, step.forces,
                           step.psi_map, cfg, traffic, limits, seed, lower=lower)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    bench = load_json(root / "BENCHMARK.json")
    cell, cfg, traffic, limits = cell_files(bench, args.workload)
    # every build and kernel cache inside the checkout, at fixed paths
    cache = root / "portbench" / "_cache"
    os.environ["PSE_TPU_TORCH_BUILD_DIR"] = str(root / "pse_tpu_torch"
                                                / "_build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(cache / sub)
        (cache / sub).mkdir(parents=True, exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    import torch

    from portbench import trace as trace_mod

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    metrics_of_cell = cell_metrics(bench, args.workload, bool(args.trace))
    win, step = run_cell(
        cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda:0",
        t_start,
        device_window=any(m["source"] == "device_trace"
                          for m in cell_metrics(bench, args.workload, False)))
    if args.trace:
        need = [s for m in metrics_of_cell
                for s in getattr(metric_module(m["name"]), "SPANS", ())]
        missing = (sorted(set(need)) if win.records is None
                   else trace_mod.missing_spans(win.records, need))
        if missing:
            print(f"the traced stretch entered no {missing} span: their "
                  f"metrics would read the work outside them", file=sys.stderr)
            return 4
    checks = judge(step, cfg, traffic, limits, args.seed)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"modules that must not load: {found}", file=sys.stderr)
        return 3
    win.power_limit_w = power_limit()
    metrics = {}
    for m in metrics_of_cell:
        value = reader(m["name"])(win)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(win.peak_bytes)}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": int(win.steps), "failed": 0,
           "metrics": metrics, "device": device}
    if args.trace and win.records is not None:
        device["busy_s"] = trace_mod.merged_busy_us(win.records.ops) / 1e6
        device["window_s"] = win.records.window_us / 1e6
        out["breakdown"] = trace_mod.breakdown(win.records)
    out["power_limit_w"] = win.power_limit_w
    out["checks"] = checks
    print(f"window {win.wall_s!r} s, {win.steps} steps, {win.retries} "
          f"overflow retries, warm step {win.step_s!r} s", file=sys.stderr)
    if win.config_changed:
        print("the configuration changed in the window or the traced "
              "stretch (a regrow): overflow_retries counts it",
              file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


def power_limit():
    """The card's power limit in W from nvidia-smi, or None."""
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=20)
        return float(p.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    sys.exit(main())
