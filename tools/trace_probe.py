"""What the port's own spans and counters (``pse_tpu_torch.trace``) read in
a benchmark cell, and what keeping them costs.  On the card only:

    python3 tools/trace_probe.py --workload phi045-n1m.banded.brownian \
        --seed 4200000001 [--pairs 6] [--chunk-seconds 1.5] [--sync-steps 3]

From the root of a checkout.  Sets the cell up as ``portbench.run`` does
(inputs from the seed, the mix's engine and grown capacities, the warm-up
through any regrow), then:

  * cost: ``Simulation.run`` chunks of ~``--chunk-seconds`` in turns with
    tracing off and with ``trace.recording()`` open (off, on, on, off per
    pair, no profiler), each to a synchronize: ms per step of each side,
    and the host's dispatch and wait per step the recordings read without
    a profiler;
  * the traced stretch as a ``--trace 1`` run takes it (the harness's
    wrappers and ``torch.profiler``): the recording's steps against the
    profiled ones, the five readers of the program's recording and the
    harness's launches and host reads per step; the clock check (each
    counted read's ``sync.*`` span against the device-to-host copy whose
    end lies nearest it, and against the host's copy call); each copy no ``sync.*`` span holds, by the
    innermost program span open at its start; the host's time in the CUDA
    runtime's synchronizing calls, by program span;
  * ``--sync-steps`` steps under ``torch.cuda.set_sync_debug_mode("warn")``:
    every synchronizing call by its Python line.

Prints one JSON line (also written to ``chiprun_out/trace_probe_<cell>.json``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

READERS = ("host_dispatch_ms_per_step", "host_wait_ms_per_step",
           "idle_in_dispatch_pct", "lanczos_host_ms_per_iter",
           "untracked_reads_per_step", "launches_per_step",
           "host_reads_per_step", "device_idle_pct")


def setup(cfg, traffic, seed, dev):
    """The cell's Simulation after its warm-up (``portbench.run``'s)."""
    import pse_tpu_torch as pse
    from pse_tpu_torch import integrator
    from portbench import run

    pos, forces = run.make_inputs(cfg, traffic, seed, dev)
    force_fn = None if forces is None else (lambda p, t: forces)
    sim = pse.Simulation(positions=pos.cpu().numpy(), L=run.box_length(cfg),
                         dt=cfg["dt"], force_fn=force_fn, device=str(dev))
    sim.set_integrator(pse.PSEv1(T=traffic["kT"], seed=int(seed),
                                 xi=cfg["xi"], error=cfg["error"]),
                       verbose=False, engine=traffic["engine"])
    flags = 0
    for name in traffic.get("grow", ()):
        flags |= getattr(integrator, name)
    if flags:
        sim.config = integrator.grow_config(sim.config, flags=flags)
    warm, quiet = 0, time.perf_counter()
    while True:
        r0 = sim.metrics["overflow_retries"]
        sim.run(traffic["warmup_chunk"])
        warm += traffic["warmup_chunk"]
        if sim.metrics["overflow_retries"] != r0:
            quiet = time.perf_counter()
        if warm >= traffic["warmup_steps"] and time.perf_counter() - quiet \
                >= traffic.get("warmup_quiet_seconds", 0.0):
            return sim


def timed(sim, steps, on, host=None):
    """ms per step of ``steps`` steps to a synchronize; with ``on`` in a
    recording, whose host dispatch and wait ms per step go to ``host``."""
    import torch

    from portbench.metrics import _program
    from pse_tpu_torch import trace

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if on:
        with trace.recording() as rec:
            sim.run(steps)
    else:
        sim.run(steps)
    torch.cuda.synchronize()
    if on and host is not None:
        sync = _program.in_sync(rec)
        work = _program.minus(_program.in_program(rec), sync)
        host["dispatch_ms"].append(_program.length(work) / 1e3 / rec.steps)
        host["wait_ms"].append(_program.length(sync) / 1e3 / rec.steps)
    return (time.perf_counter() - t0) / steps * 1e3


def cost(sim, pairs, chunk):
    off, on = [], []
    host = {"dispatch_ms": [], "wait_ms": []}
    for _ in range(pairs):
        off.append(timed(sim, chunk, False))
        on.append(timed(sim, chunk, True, host))
        on.append(timed(sim, chunk, True, host))
        off.append(timed(sim, chunk, False))
    return {"steps_per_chunk": chunk, "off_ms": off, "on_ms": on,
            "off_median": statistics.median(off),
            "on_median": statistics.median(on),
            "on_over_off": statistics.median(on) / statistics.median(off),
            "untraced_dispatch_ms": statistics.median(host["dispatch_ms"]),
            "untraced_wait_ms": statistics.median(host["wait_ms"])}


def innermost(spans, t_ns):
    """The innermost recorded span open at ``t_ns`` (shortest holding it)."""
    best = None
    for name, _, t0, t1 in spans:
        if t0 <= t_ns <= t1 and (best is None or t1 - t0 < best[1]):
            best = (name, t1 - t0)
    return best[0] if best else "outside"


def traced(sim, steps):
    """The traced stretch of a ``--trace 1`` run, read as the harness
    reads it, with the clock check."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import run, trace as trace_mod
    from pse_tpu_torch import trace

    s0 = sim.metrics["steps"]
    with trace_mod.Spans(), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        sim.run(steps)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    win = run.Window(records=trace_mod.reduce(p, traced_s),
                     traced_steps=sim.metrics["steps"] - s0)
    rec = trace.last_recording()
    out = {"traced_steps": win.traced_steps, "recording_steps": rec.steps,
           "spans": len(rec.spans), "dropped": rec.dropped,
           "counts": rec.counts,
           "readers": {n: run.reader(n)(win) for n in READERS}}
    # clock check: each sync span against the copy whose end is nearest
    # (the device's clock), and against the host's copy call nearest it
    syncs = [s for s in rec.spans if s[0].startswith("sync.")]
    copies = sorted((o for o in win.records.ops if o.kind == "d2h"),
                    key=lambda o: o.start_us)
    ends = [(o.start_us + o.dur_us) * 1e3 for o in copies]
    calls = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in p.profiler.kineto_results.events()
             if str(e.device_type()).endswith("CPU")
             and e.name() in ("cudaMemcpyAsync", "cudaMemcpy")]
    first = min(s[2] for s in rec.spans)
    used, offsets, host_off, late = set(), [], [], []
    for name, _, a, b in syncs:
        best = None
        for i, e in enumerate(ends):
            d = 0.0 if a <= e <= b else min(abs(e - a), abs(e - b))
            if best is None or d < best[0]:
                best = (d, i)
        if best is not None:
            used.add(best[1])
            offsets.append(best[0] / 1e3)
            if best[0] > 50e3:
                late.append({"span": name, "at_ms": (a - first) / 1e6,
                             "span_us": (b - a) / 1e3,
                             "copy_end_from_span_start_us":
                                 (ends[best[1]] - a) / 1e3,
                             "copy_us": copies[best[1]].dur_us})
        hd = [0.0 if a <= c0 and c1 <= b else max(a - c0, c1 - b, 0.0)
              for c0, c1 in calls]
        if hd:
            host_off.append(min(hd) / 1e3)
    out["clock_check"] = {
        "reads_checked": len(syncs), "copies": len(copies),
        "largest_offset_us": max(offsets) if offsets else None,
        "outside_50us": len(late),
        "inside": sum(o == 0.0 for o in offsets), "outliers": late,
        "host_calls_inside": sum(o == 0.0 for o in host_off),
        "largest_host_call_offset_us": max(host_off) if host_off else None}
    where = {}
    for i, o in enumerate(copies):
        if i not in used:
            k = innermost(rec.spans, int(o.start_us * 1e3))
            where[k] = where.get(k, 0) + 1
    out["untracked_copies_by_span"] = where
    out["host_blocked_ms_per_step"] = blocked(p, rec, win.traced_steps)
    out["breakdown"] = trace_mod.breakdown(win.records)
    return out


BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
            "cudaMemcpyAsync")


def blocked(prof, rec, steps):
    """Host ms per step in the CUDA runtime's synchronizing calls (a
    stream synchronize, a copy), by the innermost program span they ran
    in: the waits of the host reads fall in ``sync.*``; a copy to the card
    from pageable memory also waits for the stream, wherever it is."""
    by = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CPU") and e.name() in BLOCKING:
            k = innermost(rec.spans, e.start_ns())
            by[k] = by.get(k, 0.0) + e.duration_ns() / 1e6 / steps
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def sync_lines(sim, steps):
    """Every synchronizing call of ``steps`` steps by its Python line."""
    import torch

    lines = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.run(steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        key = f"{Path(w.filename).name}:{w.lineno}"
        lines[key] = lines.get(key, 0) + 1
    return {"steps": steps, "by_line": lines}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--chunk-seconds", type=float, default=1.5)
    ap.add_argument("--sync-steps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    from portbench import run

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json(ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = run.cell_files(bench, args.workload)
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    sim = setup(cfg, traffic, args.seed, dev)
    step_ms = timed(sim, traffic["timing_steps"], False)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0),
           "power_limit_w": run.power_limit(),
           "setup_s": time.perf_counter() - t0, "step_ms": step_ms}
    chunk = max(2, int(round(args.chunk_seconds * 1e3 / step_ms)))
    out["cost"] = cost(sim, args.pairs, chunk)
    steps = max(3, int(round(traffic["trace_seconds"] * 1e3 / step_ms)))
    out["traced"] = traced(sim, steps)
    out["sync"] = sync_lines(sim, args.sync_steps)
    out["retries"] = sim.metrics["overflow_retries"]
    line = json.dumps(out)
    dest = ROOT / "chiprun_out" / f"trace_probe_{args.workload}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
