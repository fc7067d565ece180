#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure makes the script exit non-zero without the result line):
  1. build the CUDA kernels from pse_tpu_torch/csrc (nvcc, sm_90a) and print
     the build seconds and the ptxas resource lines;
  2. a small-input check: the port's step on the card (bf16 and f32 blocks)
     against the same step on the CPU (the plain PyTorch versions) with the
     same raw uniforms;
  3. the main path: Simulation(N=100k, phi=0.45) with
     PSEv1(T=1, seed=1, xi=0.5, error=1e-3) on engine="banded", a warm-up,
     then 20 timed steps with every kernel's launch count set to 0 before
     and read after (each must be > 0); prints particle-steps/s, ms/step,
     the Lanczos m histogram and the overflow retries;
  4. each kernel against its plain version at the main path's shapes, at
     tilt 0 and 0.3: fill bitwise; build_mv and matvec <= 1e-5 (float32 A)
     and <= 2e-3 (bfloat16 A) against the unrounded float32
     matvec_banded_reference; contract <= 1e-5 (float32) and <= 5e-3
     (bfloat16) against contract_col (max |diff| / max |plain|);
  5. CUDA-event times of each kernel wrapper and its plain version, with
     the least time the card could take (bytes at 3.35 TB/s, operations at
     the peak rate of their type), printed as one JSON line;
then the card's name and power limit (nvidia-smi) and, last, the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs the repository's pse_tpu_torch package beside it and a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, per type
N, PHI, XI, ERROR, SEED, DT = 100_000, 0.45, 0.5, 1e-3, 1, 1e-3
WARM_STEPS, TIMED_STEPS = 5, 20


def make_positions(n, phi, seed=0):
    """Vacancy-diluted simple-cubic lattice at volume fraction phi, the
    JAX package's bench configuration (bench.py make_positions)."""
    vol = n * (4.0 / 3.0) * math.pi / phi
    L = vol ** (1.0 / 3.0)
    n_side = int(math.ceil(n ** (1.0 / 3.0)))
    a = L / n_side
    grid = (np.arange(n_side) + 0.5) * a - L / 2.0
    x, y, z = np.meshgrid(grid, grid, grid, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    rng = np.random.default_rng(seed)
    keep = rng.choice(pos.shape[0], size=n, replace=False)
    pos = pos[np.sort(keep)]
    pos += rng.normal(scale=0.05 * a, size=pos.shape)
    return pos.astype(np.float32), L


def rel_max(a, b):
    """max |a - b| / max |b| (the JAX bench gate's residual) and max |a - b|."""
    d = (a.double() - b.double()).abs().max().item()
    return d / max(b.double().abs().max().item(), 1e-300), d


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


class Phases:
    def __init__(self):
        self.failed = []

    def check(self, name, value, bound):
        ok = value <= bound
        print(f"  {name}: {value:.3e} (bound {bound:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)
        return ok


def phase_build():
    from pse_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {kernels.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    for line in kernels.BUILD_INFO.get("log", "").splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("  " + line.strip())


def _raw_uniforms(config, seed):
    bs, p = config.band_spec.bins, config.params
    rng = np.random.default_rng(seed)
    C = bs.n_cells[0] * bs.n_cells[1]
    psi = rng.uniform(-math.sqrt(3), math.sqrt(3), (3, C, bs.cap))
    wave = rng.uniform(-math.sqrt(1.5), math.sqrt(1.5),
                       (6, p.Nx, p.Ny, p.Nz // 2 + 1))
    return psi.astype(np.float32), wave.astype(np.float32)


def phase_small(ph):
    """The port's step on the card vs on the CPU at N=1080, L=24."""
    import dataclasses

    import torch

    from pse_tpu_torch import integrator, make_params

    print("[small] step on the card vs the CPU plain path (N=1080, L=24)")
    rng = np.random.default_rng(9)
    n, L = 1080, 24.0
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    params = make_params(xi=XI, error=ERROR, L=L)
    cpu = integrator.make_config(params, n, engine="banded", has_forces=False,
                                 seed=3, device="cpu")
    draws = _raw_uniforms(cpu, 4)
    for dtype, bound in (("float32", 1e-4), ("bfloat16", 5e-3)):
        gpu = integrator.make_config(
            params, n, engine="banded", has_forces=False, seed=3,
            block_dtype=dtype, ff_weight_dtype=dtype, device="cuda")
        cpu_d = dataclasses.replace(cpu, cheb=gpu.cheb)
        for tilt, rate in ((0.0, 0.0), (0.3, 0.5)):
            s_c, i_c = integrator.step(
                cpu_d, integrator.make_state(pos, 3, tilt, "cpu"), 1.0, DT,
                rate, None, uniforms=draws)
            s_g, i_g = integrator.step(
                gpu, integrator.make_state(pos, 3, tilt, "cuda"), 1.0, DT,
                rate, None, uniforms=draws)
            r, _ = rel_max(i_g["velocities"].cpu(), i_c["velocities"])
            ph.check(f"step {dtype} tilt={tilt} m={i_g['m_lanczos']}/"
                     f"{i_c['m_lanczos']}", r, bound)
            if int(s_g.nbr_overflow) or not torch.isfinite(s_g.pos).all():
                ph.failed.append(f"small step {dtype} tilt={tilt} overflow")


def phase_main(ph):
    """The main path through the user entry points; returns the run data."""
    import torch

    import pse_tpu_torch as pse
    from pse_tpu_torch.cellbins import fill_cells
    from pse_tpu_torch.ops.banded_nearfield import build_mv_banded, matvec_banded
    from pse_tpu_torch.ops.column_farfield import contract_col_kernel

    wrappers = {"fill_cells": fill_cells, "build_mv_banded": build_mv_banded,
                "matvec_banded": matvec_banded,
                "contract_col": contract_col_kernel}
    pos, L = make_positions(N, PHI, seed=0)
    print(f"[main] Simulation N={N} phi={PHI} L={L:.4f} xi={XI} "
          f"error={ERROR} engine=banded")
    sim = pse.Simulation(positions=pos, L=L, dt=DT, sync_every=10,
                         device="cuda")
    sim.set_integrator(pse.PSEv1(T=1.0, seed=SEED, xi=XI, error=ERROR),
                       engine="banded", verbose=False)
    t0 = time.perf_counter()
    sim.run(WARM_STEPS)
    torch.cuda.synchronize()
    print(f"  warm-up {WARM_STEPS} steps: {time.perf_counter() - t0:.2f} s, "
          f"overflow retries {sim.metrics['overflow_retries']}")
    for w in wrappers.values():
        w.launches = 0
    retries0 = sim.metrics["overflow_retries"]
    hist0 = dict(sim.metrics["m_lanczos_hist"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    hist = {m: c - hist0.get(m, 0)
            for m, c in sim.metrics["m_lanczos_hist"].items()
            if c - hist0.get(m, 0)}
    retries = sim.metrics["overflow_retries"] - retries0
    ms_step = 1e3 * wall / TIMED_STEPS
    print(f"  {TIMED_STEPS} steps: {ms_step:.3f} ms/step, "
          f"{N * TIMED_STEPS / wall:.6g} particle-steps/s (host clock, "
          f"includes overflow retries: {retries})")
    print(f"  m_lanczos histogram {dict(sorted(hist.items()))}; overflow "
          f"retries total {sim.metrics['overflow_retries']}")
    print(f"  launches in the timed run: {launches}")
    for k, v in launches.items():
        if v <= 0:
            ph.failed.append(f"{k} never launched on the main path")
    snap = sim.snapshot()
    if snap["pos"].shape != (N, 3) or not np.isfinite(snap["pos"]).all():
        ph.failed.append("main path positions not finite (N, 3)")
    if int(sim.state.nbr_overflow):
        ph.failed.append("main path ended with an overflow")
    bs = sim.config.band_spec
    print(f"  final config: band cap {bs.bins.cap} W {bs.window} R {bs.rows} "
          f"{bs.block_dtype}; far-field cap {sim.config.colff_spec.bins.cap} "
          f"{sim.config.colff_spec.weight_dtype}; m_max {sim.config.m_max}")
    return sim, launches, ms_step


def phase_profile(sim, ms_step, steps=3):
    """Where the main path's step time goes: torch.profiler over a few more
    steps (after the launch counts were read), device time by kernel, and
    the device's busy share of the unprofiled ms/step.  Reports only: a
    profiler that cannot trace the card here fails no phase."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"[profile] torch.profiler over {steps} main-path steps")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.run(steps)
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            if ev.device_type == DeviceType.CUDA and dev_us > 0:
                rows.append((dev_us / steps / 1e3, ev.count / steps, ev.key))
    except RuntimeError as e:                 # tracing unavailable
        print(f"  profiler unavailable: {e}")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"  device kernels {busy:.3f} ms/step of {ms_step:.3f} ms/step "
          f"unprofiled wall: busy {100 * busy / ms_step:.1f}%, idle "
          f"{100 * (1 - busy / ms_step):.1f}%")
    for ms, count, key in rows[:16]:
        print(f"  {ms:8.4f} ms/step  x{count:<6.1f} {key[:88]}")


def _band_operands(config, pos, tilt):
    import torch

    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.cellbins import bin_columns, vec_to_cells
    from pse_tpu_torch.ops import banded_nearfield as bdn

    p, bs = config.params, config.band_spec
    box = make_box(p.L, tilt)
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, _, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    f = vec_to_cells(bins, bs.bins,
                     torch.randn(pos.shape, generator=g, device="cuda"))
    return bins, box, j0, nv, zsh, f


def phase_kernels(ph, sim, results):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from pse_tpu_torch import cellbins as cb
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.ops import banded_nearfield as bdn
    from pse_tpu_torch.ops import column_farfield as cff

    config = sim.config
    p = config.params
    pos = sim.state.pos
    print("[kernels] against the plain versions at the main path's shapes")
    for tilt in (0.0, 0.3):
        box = make_box(p.L, tilt)
        for name, spec, columns in (
                ("near", config.band_spec.bins, True),
                ("far", config.colff_spec.bins, False)):
            ops = cb.fill_operands(pos, box, spec, columns)
            got = cb.fill_cells(*ops, spec.cap)
            want = cb.fill_cells_reference(*ops, spec.cap)
            bad = sum(int((a != b).sum()) for a, b in zip(got, want))
            ph.check(f"fill {name} tilt={tilt} (mismatched slots)", bad, 0)
            results["fill_cells"]["err"].append(0.0 if bad == 0 else math.inf)

        bins, box, j0, nv, zsh, f = _band_operands(config, pos, tilt)
        for dtype, bound in (("float32", 1e-5), ("bfloat16", 2e-3)):
            bs = config.band_spec._replace(block_dtype=dtype)
            args = (bins, tilt, bs, config.cheb, p.L, p.ewald_cut, p.ewald_dr,
                    j0, nv, zsh)
            ref = bdn.matvec_banded_reference(*args[:9], f, p.self_mobility)
            blocks, u_b = bdn.build_mv_banded(*args, f, p.self_mobility)
            u_m = bdn.matvec_banded(blocks, *args, f, p.self_mobility)
            r_b, d_b = rel_max(u_b, ref)
            r_m, d_m = rel_max(u_m, ref)
            ph.check(f"build_mv {dtype} tilt={tilt}", r_b, bound)
            ph.check(f"matvec {dtype} tilt={tilt}", r_m, bound)
            if dtype == config.band_spec.block_dtype:
                results["build_mv_banded"]["err"].append(d_b)
                results["matvec_banded"]["err"].append(d_m)
            del blocks

        ff = cb.bin_particles(pos, box, config.colff_spec.bins)
        g = torch.Generator(device="cuda")
        g.manual_seed(11)
        grid = torch.randn((3, p.Nx, p.Ny, p.Nz), generator=g, device="cuda")
        for dtype, bound in (("float32", 1e-5), ("bfloat16", 5e-3)):
            spec = config.colff_spec._replace(weight_dtype=dtype)
            fac = cff.build_col_factors(ff, box, spec, p)
            want = cff.contract_col(grid, spec, p, fac)
            got = cff.contract_col_kernel(grid, spec, p, fac)
            r, d = rel_max(got, want)
            ph.check(f"contract {dtype} tilt={tilt}", r, bound)
            if dtype == config.colff_spec.weight_dtype:
                results["contract_col"]["err"].append(d)
        torch.cuda.synchronize()


def phase_timing(sim, results):
    """CUDA-event times of each wrapper and its plain version at the main
    path's shapes (tilt 0.3), with the least time the card could take."""
    import torch

    from pse_tpu_torch import cellbins as cb
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.ops import banded_nearfield as bdn
    from pse_tpu_torch.ops import column_farfield as cff

    config, p = sim.config, sim.config.params
    pos = sim.state.pos
    tilt = 0.3
    box = make_box(p.L, tilt)
    bs, cs = config.band_spec, config.colff_spec
    C, S, W = bs.bins.n_cells_total, bs.bins.cap, bs.window
    T = S // bs.rows
    a_item = torch.empty((), dtype=getattr(torch, bs.block_dtype)).element_size()
    print("[timing] CUDA events, wrapper calls at the main path's shapes")

    ops = cb.fill_operands(pos, box, bs.bins, True)
    # read: sorted xyz + pid (16 B/particle), starts + counts; write: 5
    # (C, S) slot arrays of 4 B
    nbytes = (16 * N + 8 * C) + 20 * C * S
    results["fill_cells"].update(
        ms=cuda_ms(lambda: cb.fill_cells(*ops, S), 50),
        plain_ms=cuda_ms(lambda: cb.fill_cells_reference(*ops, S), 20),
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes")

    bins, box, j0, nv, zsh, f = _band_operands(config, pos, tilt)
    args = (bins, tilt, bs, config.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    blocks, _ = bdn.build_mv_banded(*args, f, p.self_mobility)
    a_bytes = blocks.numel() * a_item
    pairs = int((blocks[:, :, 0] != 0).sum())
    plain = cuda_ms(lambda: bdn.matvec_banded_reference(
        *args[:9], f, p.self_mobility), 3)
    # besides A: slot coordinates + mask and f read, j0 + zsh tables read,
    # u written (4 B each)
    small = 4 * C * S * 4 + 3 * C * S * 4 + 2 * 5 * C * T * 4 + 3 * C * S * 4
    # operations on this run's valid pairs (nonzero A): ~40 flops forward +
    # transposed; the build adds the geometry and two degree-`deg` Clenshaw
    # recurrences
    deg = config.cheb.degree
    ops_mv = 40 * pairs
    ops_build = (40 + 20 + 8 * deg) * pairs
    for name, fn, ops_n in (
            ("build_mv_banded",
             lambda: bdn.build_mv_banded(*args, f, p.self_mobility), ops_build),
            ("matvec_banded",
             lambda: bdn.matvec_banded(blocks, *args, f, p.self_mobility),
             ops_mv)):
        t_bytes = (a_bytes + small) / HBM_BYTES_PER_S
        t_ops = ops_n / PEAK_FLOPS["float32"]
        results[name].update(
            ms=cuda_ms(fn, 20), plain_ms=plain,
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"  A: {a_bytes / 1e6:.1f} MB, valid pairs {pairs}")
    del blocks

    ff = cb.bin_particles(pos, box, cs.bins)
    fac = cff.build_col_factors(ff, box, cs, p)
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    grid = torch.randn((3, p.Nx, p.Ny, p.Nz), generator=g, device="cuda")
    Cf, cap = cs.bins.n_cells_total, cs.bins.cap
    nn = 9 * cs.s[0] * cs.s[1]
    w_item = fac.wxy.element_size()
    nbytes = (grid.numel() * 4 + (fac.wxy.numel() + fac.wz.numel()) * w_item
              + 3 * Cf * cap * 4)
    flops = 2 * Cf * nn * 3 * p.Nz * cap + 2 * 3 * p.Nz * Cf * cap
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[cs.weight_dtype]
    results["contract_col"].update(
        ms=cuda_ms(lambda: cff.contract_col_kernel(grid, cs, p, fac), 20),
        plain_ms=cuda_ms(lambda: cff.contract_col(grid, cs, p, fac), 5),
        bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations")


def device_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi gave no output (rc {out.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


KERNELS = (
    ("fill_cells", "pse_tpu_torch/csrc/fill.cu", "pse_tpu/cellbins.py:123"),
    ("build_mv_banded", "pse_tpu_torch/csrc/banded.cu",
     "pse_tpu/ops/banded_nearfield.py:1472"),
    ("matvec_banded", "pse_tpu_torch/csrc/banded.cu",
     "pse_tpu/ops/banded_nearfield.py:1147"),
    ("contract_col", "pse_tpu_torch/csrc/contract.cu",
     "pse_tpu/ops/column_farfield.py:307"),
)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "pse_tpu_torch", "csrc")):
        print("chip_smoke: pse_tpu_torch/ (with csrc/) must sit beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False      # plain versions: f32
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    ph = Phases()
    t_start = time.perf_counter()
    phase_build()
    phase_small(ph)
    sim, launches, ms_step = phase_main(ph)
    phase_profile(sim, ms_step)
    results = {name: {"err": []} for name, _, _ in KERNELS}
    phase_kernels(ph, sim, results)
    phase_timing(sim, results)

    line = []
    for name, src, replaces in KERNELS:
        r = results[name]
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["err"]) if r["err"] else None,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
        })
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}), "
              f"launches {launches[name]} in {TIMED_STEPS} steps")
    print(f"total {time.perf_counter() - t_start:.1f} s; main path "
          f"{ms_step:.3f} ms/step")
    if ph.failed:
        print("FAILED: " + "; ".join(map(str, ph.failed)))
        return 1
    print(json.dumps({"kernels": line}))
    print(device_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
