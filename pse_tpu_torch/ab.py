#!/usr/bin/env python3
"""A/B timing of the port's kernels against another checkout's, on one CUDA
device, at chip_smoke.py's main-path shapes (N = 100k, phi = 0.45, tilt 0.3).

    python3 pse_tpu_torch/ab.py [--other DIR] [--contract] [--only PART]

``--other DIR`` is the root of another checkout of the port (e.g. the
parent commit unpacked by ``git archive`` into the gitignored
``scratch_tree/``).  Its ``pse_tpu_torch`` is imported under another name,
``pse_tpu_torch_other``, so its own wrappers and kernels (built into its own
tree) run as they are there, on this checkout's operands.  Without it, this
checkout is timed alone.

Far field: ``spread_moments_kernel`` (float32 factors from the slots'
node-space coordinates; this checkout only, as the spread's C interface
changed with them) and ``contract_col_kernel`` (the default bfloat16
factors), held against their plain versions and a rerun, with the library
yardsticks ``torch.bmm`` of the float32 wxy with a pre-built X (the
spread's product) and of the pre-gathered windows with the bfloat16 wxy
(the contract's H).

Banded matvec: ``matvec_banded`` (one right-hand side, the default
bfloat16 blocks), timed as the wrapper (with its torch work on the kernel's
planes) and as the kernel launch alone.  Both checkouts apply the same
stored A; their raw planes and u are compared (max |diff|, bitwise
equality) at tilts 0 and 0.3, one and two right-hand sides, bfloat16 and
float32 blocks.  The bounds count the A rows of the non-empty tiles (those
the kernel reads) and all of A.

Build: ``build_mv_banded`` at one and two right-hand sides and
``build_banded_blocks`` (the build alone).  At tilts 0 and 0.3, bfloat16
and float32 blocks, one and two right-hand sides, the two checkouts' A,
build-alone A, raw planes and u are compared (max |diff|, bitwise
equality), and each side's build-alone A against its build_mv A and its
build_mv u against its own matvec's u on that A.  Each of the three is
timed at tilt 0.3, bfloat16, as the wrapper by CUDA events and as its
kernel launches alone (``_launch_banded``: in checkouts where build_mv is
the build kernel and then the matvec kernel, both) by CUDA-graph replay.
With ``--contract`` a third library is built whose build rounds with
plain (contractible) arithmetic in place of its explicit ``__fmul_rn``,
``__fadd_rn`` and ``__fsub_rn``, which nvcc contracts into fused
multiply-adds; it is timed beside the others, and this checkout's float32
build and the contracted one are held against the plain build (max |diff|
/ max |plain|) at the main path's shapes and at the small configurations
of tests/test_torch_cuda.py.

Binning: ``bin_columns`` and ``bin_particles`` (the near field's and the
far field's configuration), each without and with values (bench.py's
fixed random forces).  At tilts 0 and 0.3 the two checkouts' CellBins
fields and binned values are compared (bitwise equality, max |diff|); at
tilt 0.3 each call is timed by CUDA events, its device kernels counted and
summed per call by torch.profiler, and, last, timed by CUDA-graph replay
where the whole binning, sort included, captures (else the error is kept);
the fill wrapper alone (with values) is timed by CUDA-graph replay: the
binning's whole tail after the sort, or in checkouts before it the slot
fill of the sorted rows.

Step: each checkout's ``Simulation`` on the two main paths, wall ms per
step (20 steps after 5 of warm-up) and its device kernels per step (count
and summed time, torch.profiler over 3 more), twice per side.

``--only far|matvec|build|bin|step`` (repeatable) runs only those parts.

The sides run in alternating rounds in the order other, this, this, other
(then contract, contract), each call timed by CUDA events around a loop of
calls (as chip_smoke.py times them) and by replaying a CUDA graph of the
same calls (the device time alone, without the host's work).  Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N, PHI, XI, ERROR, TILT = 100_000, 0.45, 0.5, 1e-3, 0.3
ROUNDS, REPS = 5, 20
# (n, L, tilt, window) of test_two_rhs_and_build_only_banded_kernels
SMALL = ((1080, 24.0, 0.0, None), (5300, 40.0, 0.3, None),
         (5300, 40.0, 0.1, 256))
ROUNDINGS = {"__fmul_rn(": "ab_mul(", "__fadd_rn(": "ab_add(",
             "__fsub_rn(": "ab_sub("}
PLAIN_OPS = (
    "__device__ __forceinline__ float ab_mul(float a, float b) "
    "{ return a * b; }\n"
    "__device__ __forceinline__ float ab_add(float a, float b) "
    "{ return a + b; }\n"
    "__device__ __forceinline__ float ab_sub(float a, float b) "
    "{ return a - b; }\n")


def load_other(root: Path):
    """Import another checkout's pse_tpu_torch as the package
    ``pse_tpu_torch_other`` (its kernels build into its own tree)."""
    pkg = root / "pse_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "pse_tpu_torch_other", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def contract_library(kernels, where: Path):
    """Load a second kernel library whose build (the source that defines
    ``pse_banded_build``) rounds with plain (contractible) arithmetic;
    returns it and leaves the first loaded."""
    first = kernels.library()
    csrc = kernels.CSRC
    shutil.copytree(csrc, where)
    holders = [n for n in kernels.SOURCES if 'extern "C" int pse_banded_build('
               in (where / n).read_text()]
    if len(holders) != 1:
        raise RuntimeError(f"no single source defines pse_banded_build: "
                           f"{holders}")
    path = where / holders[0]
    src = path.read_text()
    for old, new in ROUNDINGS.items():
        if old not in src:
            raise RuntimeError(f"{holders[0]} has no {old}")
        src = src.replace(old, new)
    src = src.replace("namespace {", PLAIN_OPS + "namespace {", 1)
    path.write_text(src)
    kernels.CSRC, kernels._lib = where, None
    second = kernels.library()
    kernels.CSRC, kernels._lib = csrc, first
    return second


def operands(pos, n, L, tilt, window=None, dtype=None):
    """The banded wrappers' arguments at (n, L, tilt), a random f and the
    self mobility; ``dtype``: the block dtype, with its own pair-function
    fit (degree 8 at bfloat16, 12 at float32)."""
    import torch

    from pse_tpu_torch import integrator, make_params
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.cellbins import bin_columns, vec_to_cells
    from pse_tpu_torch.ops import banded_nearfield as bdn

    p = make_params(xi=XI, error=ERROR, L=L)
    cfg = integrator.make_config(p, n, engine="banded", has_forces=False,
                                 device="cuda",
                                 block_dtype=dtype or "bfloat16")
    bs = cfg.band_spec
    if "classes" in bs._fields:          # the kernels' single-class layout
        bs = bs._replace(classes=None, slab_classes=None)
    if window is not None:
        bs = bs._replace(window=window)
    box = make_box(p.L, tilt)
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, _, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    f = vec_to_cells(bins, bs.bins,
                     torch.randn(pos.shape, generator=g, device="cuda"))
    return (bins, tilt, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh), f, p.self_mobility


def kernel_launch(bdn, blocks, args, f):
    """The matvec kernel launch alone (its raw planes) of a checkout's
    banded_nearfield module; in checkouts where the matvec is a mode of
    csrc/banded.cu, through that launcher."""
    bins, tilt, bs, cheb, L, cut, dr, j0, nv, zsh = args
    if hasattr(bdn, "_launch_matvec"):
        def run():
            return bdn._launch_matvec(blocks, bins, tilt, bs, L, j0, nv, zsh,
                                      f)
    else:
        def run():
            _, uo, rc = bdn._launch_banded(bdn.MODE_MATVEC, *args, f,
                                           blocks=blocks)
            return uo, rc

    def launch():
        uo, rc = run()
        if rc:
            raise RuntimeError(f"matvec launch failed: CUDA error {rc}")
        return uo
    return launch


def ab_matvec(sides, order, pos, L):
    """The matvec A/B: the checks between and per side, timings, bounds."""
    import torch

    from chip_smoke import HBM_BYTES_PER_S, PEAK_FLOPS, cuda_ms, graph_ms
    from chip_smoke import rel_max
    from pse_tpu_torch.ops import banded_nearfield as bdn

    out = {"checks": {}, "between": {}}
    for tilt in (0.0, TILT):
        for dtype in ("bfloat16", "float32"):
            args, f, self_mob = operands(pos, N, L, tilt, dtype=dtype)
            g = torch.Generator(device="cuda")
            g.manual_seed(8)
            f2 = torch.cat([f, torch.randn(f.shape, generator=g,
                                           device="cuda") * (f != 0)])
            blocks, _ = bdn.build_mv_banded(*args, f, self_mob)
            for nrhs, rhs in ((1, f), (2, f2)):
                key = f"tilt={tilt} {dtype} nrhs={nrhs}"
                ref = bdn._reference_per_rhs(rhs, lambda fk: (
                    bdn.matvec_banded_reference(*args[:9], fk, self_mob)))
                got = {}
                for k, m in sides.items():
                    uo = kernel_launch(m, blocks, args, rhs)()
                    u = m.matvec_banded(blocks, *args, rhs, self_mob)
                    got[k] = (uo, u)
                    out["checks"].setdefault(k, {})[key] = {
                        "rel_max_vs_plain": rel_max(u, ref)[0],
                        "rerun_bitwise": bool(torch.equal(
                            m.matvec_banded(blocks, *args, rhs, self_mob),
                            u))}
                if "other" in got:
                    (uo_a, u_a), (uo_b, u_b) = got["this"], got["other"]
                    out["between"][key] = {
                        "planes_max_abs_diff": rel_max(uo_a, uo_b)[1],
                        "planes_bitwise": bool(torch.equal(uo_a, uo_b)),
                        "u_max_abs_diff": rel_max(u_a, u_b)[1],
                        "u_rel_max": rel_max(u_a, u_b)[0],
                        "u_bitwise": bool(torch.equal(u_a, u_b))}
            if tilt == TILT and dtype == "bfloat16":
                timed = (args, f, self_mob, blocks)
            else:
                del blocks

    args, f, self_mob, blocks = timed
    bs = args[2]
    times = {k: {"wrapper_events": [], "wrapper_graph": [],
                 "kernel_graph": []} for k in sides}
    for _ in range(ROUNDS):
        for k in order:
            m = sides[k]
            wrapper = (lambda m=m: m.matvec_banded(blocks, *args, f,
                                                   self_mob))
            times[k]["wrapper_events"].append(cuda_ms(wrapper, REPS))
            times[k]["wrapper_graph"].append(graph_ms(wrapper, REPS))
            times[k]["kernel_graph"].append(
                graph_ms(kernel_launch(m, blocks, args, f), REPS))
    C, S, R, W = (bs.bins.n_cells_total, bs.bins.cap, bs.rows, bs.window)
    T = S // R
    row_bytes = 2 * 5 * W * blocks.element_size()     # both planes of a row
    nv = args[8].long()
    live_rows = int(((nv + R - 1) // R * R).sum())
    pairs = int((blocks[:, :, 0] != 0).sum())
    # besides A: slot coordinates and f read, u written, j0 + zsh tables
    other_bytes = 4 * C * S * 4 + 2 * 5 * C * T * 4 + 2 * 3 * C * S * 4
    t_ops = 40 * pairs / PEAK_FLOPS["float32"]
    bound = {k: 1e3 * max((a + other_bytes) / HBM_BYTES_PER_S, t_ops)
             for k, a in (("nonempty_tiles", live_rows * row_bytes),
                          ("full_A", C * S * row_bytes))}
    out.update({
        "shapes": {"C": C, "S": S, "R": R, "W": W, "T": T,
                   "block_dtype": bs.block_dtype, "tilt": TILT, "nrhs": 1,
                   "live_tiles": live_rows // R, "all_tiles": C * T},
        "ms": times,
        "median_ms": {k: {n: float(np.median(t)) for n, t in per.items()}
                      for k, per in times.items()},
        "bound_ms": bound})
    return out


def build_residual(args):
    """max |A - plain| / max |plain| of the float32 build, both planes."""
    from pse_tpu_torch.ops import banded_nearfield as bdn

    a = (*args[:2], args[2]._replace(block_dtype="float32"), *args[3:])
    A = bdn.build_banded_blocks(*a)
    plain = bdn.build_banded_blocks_reference(*a)
    return max(float((A[:, :, k] - plain[:, :, k]).abs().max()
                     / plain[:, :, k].abs().max()) for k in range(2))


def build_launch(bdn, args, f=None):
    """The build kernel launch alone of a checkout's banded_nearfield module:
    build_mv on the right-hand sides ``f``, or the build alone without;
    the launch returns (blocks, raw planes or None)."""
    mode = bdn.MODE_BUILD if f is None else bdn.MODE_BUILD_MV

    def launch():
        blocks, uo, rc = bdn._launch_banded(mode, *args, f)
        if rc:
            raise RuntimeError(f"build launch failed: CUDA error {rc}")
        return blocks, uo
    return launch


def ab_build_mv(sides, order, pos, L, contract=None):
    """The build A/B: build_mv at one and two right-hand sides and the
    build alone, per side against the other side's (A, raw planes, u) and
    against its own matvec, at tilts 0 and 0.3, bf16 and f32 blocks;
    timings at tilt 0.3, bf16.  ``contract``: the library with plain
    arithmetic in the build's roundings, run through this checkout's
    wrapper."""
    import torch

    from chip_smoke import cuda_ms, graph_ms, rel_max
    from pse_tpu_torch import kernels

    out = {"checks": {}, "between": {}}
    for tilt in (0.0, TILT):
        for dtype in ("bfloat16", "float32"):
            args, f, self_mob = operands(pos, N, L, tilt, dtype=dtype)
            g = torch.Generator(device="cuda")
            g.manual_seed(8)
            f2 = torch.cat([f, torch.randn(f.shape, generator=g,
                                           device="cuda") * (f != 0)])
            alone = {k: build_launch(m, args)()[0] for k, m in sides.items()}
            for nrhs, rhs in ((1, f), (2, f2)):
                key = f"tilt={tilt} {dtype} nrhs={nrhs}"
                got = {}
                for k, m in sides.items():
                    blocks, uo = build_launch(m, args, rhs)()
                    _, u = m.build_mv_banded(*args, rhs, self_mob)
                    u_m = m.matvec_banded(blocks, *args, rhs, self_mob)
                    got[k] = (blocks, uo, u)
                    out["checks"].setdefault(k, {})[key] = {
                        "build_alone_A_bitwise": bool(torch.equal(
                            alone[k], blocks)),
                        "u_vs_matvec_u_rel_max": rel_max(u, u_m)[0],
                        "u_bitwise_matvec_u": bool(torch.equal(u, u_m)),
                        "rerun_bitwise": bool(torch.equal(
                            m.build_mv_banded(*args, rhs, self_mob)[1], u))}
                    del u_m
                if "other" in got:
                    (a_a, uo_a, u_a), (a_b, uo_b, u_b) = (got["this"],
                                                          got["other"])
                    out["between"][key] = {
                        "A_max_abs_diff": float(
                            (a_a.float() - a_b.float()).abs().max()),
                        "A_bitwise": bool(torch.equal(a_a, a_b)),
                        "build_alone_A_bitwise": bool(torch.equal(
                            alone["this"], alone["other"])),
                        "planes_max_abs_diff": rel_max(uo_a, uo_b)[1],
                        "planes_bitwise": bool(torch.equal(uo_a, uo_b)),
                        "u_max_abs_diff": rel_max(u_a, u_b)[1],
                        "u_rel_max": rel_max(u_a, u_b)[0],
                        "u_bitwise": bool(torch.equal(u_a, u_b))}
                del got
            del alone

    args, f, self_mob = operands(pos, N, L, TILT)
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    f2 = torch.cat([f, torch.randn(f.shape, generator=g, device="cuda")
                    * (f != 0)])
    runs = {k: (m, None) for k, m in sides.items()}
    if contract is not None:
        runs["contract"] = (sides["this"], contract)
        order = order + ["contract", "contract"]
    first = kernels.library()
    names = ("mv1", "mv2", "build")
    times = {k: {f"{n}_{how}": [] for n in names
                 for how in ("wrapper_events", "kernel_graph")}
             for k in runs}
    for _ in range(ROUNDS):
        for k in order:
            m, lib = runs[k]
            kernels._lib = lib or first
            calls = {
                "mv1": (lambda m=m: m.build_mv_banded(*args, f, self_mob),
                        build_launch(m, args, f)),
                "mv2": (lambda m=m: m.build_mv_banded(*args, f2, self_mob),
                        build_launch(m, args, f2)),
                "build": (lambda m=m: m.build_banded_blocks(*args),
                          build_launch(m, args))}
            for n, (wrapper, kernel) in calls.items():
                times[k][f"{n}_wrapper_events"].append(cuda_ms(wrapper, REPS))
                times[k][f"{n}_kernel_graph"].append(graph_ms(kernel, REPS))
    kernels._lib = first
    out.update({"ms": times,
                "median_ms": {k: {n: float(np.median(t))
                                  for n, t in per.items()}
                              for k, per in times.items()}})
    if contract is not None:
        res = {}
        for k, lib in (("this", first), ("contract", contract)):
            kernels._lib = lib
            r = {"main tilt=0.0": build_residual(
                     operands(pos, N, L, 0.0)[0]),
                 f"main tilt={TILT}": build_residual(args)}
            for n, Ls, tilt, window in SMALL:
                rng = np.random.default_rng(0)
                p_small = torch.as_tensor(rng.uniform(
                    -Ls / 2, Ls / 2, size=(n, 3)).astype(np.float32),
                    device="cuda")
                r[f"{n}/{Ls}/{tilt}/W={window}"] = build_residual(
                    operands(p_small, n, Ls, tilt, window)[0])
            res[k] = r
        kernels._lib = first
        out["f32_build_vs_plain"] = res
    return out


def device_profile(fn, reps=5):
    """Device kernels per call of fn(), by torch.profiler: the count of
    kernel launches (and of copies and memsets), their summed time, and the
    launches per call by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name, ms = {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            name = ev.key[:80]
            by_name[name] = by_name.get(name, 0.0) + ev.count / reps
            ms += getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0)) / reps / 1e3
    copies = sum(c for k, c in by_name.items()
                 if k.startswith(("Memcpy", "Memset")))
    return {"launches": sum(by_name.values()) - copies, "copies": copies,
            "device_ms": ms, "by_name": by_name}


def fill_launch(cb, pos, box, spec, columns, F):
    """A checkout's fill wrapper on its own operands with the values F: the
    whole tail after the sort (``fill_cells(sorted_cid, order, coords, C,
    cap, values)``), or, in checkouts before it, the slot fill alone on
    the sorted rows (``fill_cells(pos_t, order, starts, counts, cap,
    values_t)``)."""
    ops = cb.fill_operands(pos, box, spec, columns)
    if hasattr(cb, "Fill"):
        return lambda: cb.fill_cells(*ops, spec.n_cells_total, spec.cap, F)
    vals_t = F.t()[:, ops[1].long()].contiguous()
    return lambda: cb.fill_cells(*ops, spec.cap, vals_t)


def ab_bin(sides, order, pos, L):
    """The binning A/B: both binnings with and without values, the sides'
    outputs against each other at tilts 0 and 0.3; timings, launch counts
    and device time at tilt 0.3."""
    import torch

    from chip_smoke import cuda_ms, graph_ms
    from pse_tpu_torch import integrator, make_params
    from pse_tpu_torch.box import make_box

    p = make_params(xi=XI, error=ERROR, L=L)
    cfg = integrator.make_config(p, N, engine="banded", device="cuda")
    specs = {"bin_columns": cfg.band_spec.bins,
             "bin_particles": cfg.colff_spec.bins}
    F = torch.as_tensor(np.random.default_rng(1).normal(size=(N, 3))
                        .astype(np.float32), device="cuda")
    calls = [(name, v) for name in specs for v in (False, True)]

    def call(m, name, with_values, box):
        fn, spec = getattr(m, name), specs[name]
        if with_values:
            return lambda: fn(pos, box, spec, values=F)
        return lambda: fn(pos, box, spec)

    def fields(out, with_values):
        bins, vals = out if with_values else (out, None)
        got = dict(bins._asdict())
        if with_values:
            got["values"] = vals
        return got

    between = {}
    for tilt in (0.0, TILT):
        box = make_box(p.L, tilt)
        for name, v in calls:
            key = f"tilt={tilt} {name}{' values' if v else ''}"
            got = {k: fields(call(m, name, v, box)(), v)
                   for k, m in sides.items()}
            if "other" not in got:
                continue
            between[key] = {}
            for f, a in got["this"].items():
                b = got["other"][f]
                between[key][f] = {
                    "bitwise": a.dtype == b.dtype and bool(torch.equal(a, b)),
                    "max_abs_diff": float((a.double() - b.double())
                                          .abs().max())}
    box = make_box(p.L, TILT)
    labels = [f"{name}{'+values' if v else ''}" for name, v in calls]
    times = {k: {n: [] for n in labels} for k in sides}
    for _ in range(ROUNDS):
        for k in order:
            for n, (name, v) in zip(labels, calls):
                times[k][n].append(cuda_ms(call(sides[k], name, v, box),
                                           REPS))
    device = {k: {n: device_profile(call(m, name, v, box))
                  for n, (name, v) in zip(labels, calls)}
              for k, m in sides.items()}
    fill = {k: {} for k in sides}
    for _ in range(ROUNDS):
        for k in order:
            for name, spec in specs.items():
                launch = fill_launch(sides[k], pos, box, spec,
                                     name == "bin_columns", F)
                fill[k].setdefault(f"{name}_graph", []).append(
                    graph_ms(launch, REPS))
                fill[k].setdefault(f"{name}_events", []).append(
                    cuda_ms(launch, REPS))
    graph = {k: {} for k in sides}
    for k in sides:                     # this checkout's first
        for n, (name, v) in zip(labels, calls):
            try:
                graph[k][n] = graph_ms(call(sides[k], name, v, box), REPS)
            except RuntimeError as e:       # the binning does not capture
                graph[k][n] = f"no capture: {str(e)[:120]}"
    return {
        "shapes": {k: {"C": s.n_cells_total, "cap": s.cap}
                   for k, s in specs.items()},
        "between": between,
        "all_bitwise": all(f["bitwise"] for case in between.values()
                           for f in case.values()),
        "ms": times,
        "median_ms": {k: {n: float(np.median(t)) for n, t in per.items()}
                      for k, per in times.items()},
        "device": device, "graph_ms": graph,
        "fill_ms": {k: {n: float(np.median(t)) for n, t in per.items()}
                    for k, per in fill.items()}}


def ab_step(pkgs, order, pos, L):
    """The step A/B: each side's Simulation on the main paths (brownian and
    with bench.py's fixed random forces), wall ms per step over 20 steps
    after 5 of warm-up, then its device kernels per step by torch.profiler
    over 3 more."""
    import time

    import torch

    from chip_smoke import DT, SEED

    F = torch.as_tensor(np.random.default_rng(1).normal(size=(N, 3))
                        .astype(np.float32), device="cuda")
    out = {k: {} for k in pkgs}
    for k in order:
        pse = pkgs[k]
        for path in ("brownian", "forces"):
            force_fn = (lambda p, t: F) if path == "forces" else None
            sim = pse.Simulation(positions=pos, L=L, dt=DT, sync_every=10,
                                 force_fn=force_fn, device="cuda")
            sim.set_integrator(pse.PSEv1(T=1.0, seed=SEED, xi=XI,
                                         error=ERROR),
                               engine="banded", verbose=False)
            sim.run(5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run(20)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 20
            prof = device_profile(lambda: sim.run(1), reps=3)
            run = out[k].setdefault(path, {"wall_ms": [], "device_ms": [],
                                           "launches": [], "copies": []})
            run["wall_ms"].append(wall)
            for key in ("device_ms", "launches", "copies"):
                run[key].append(prof[key])
            run["by_name"] = prof["by_name"]
            del sim
            torch.cuda.empty_cache()
    return out


def ab_far_field(libs, order, pos, L):
    """The far-field A/B: timings, checks and yardsticks."""
    import torch

    from chip_smoke import cuda_ms, graph_ms, rel_max
    from pse_tpu_torch import cellbins as cb
    from pse_tpu_torch import integrator, kernels, make_params
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.ops import column_farfield as cff

    p = make_params(xi=XI, error=ERROR, L=L)
    cs = integrator.make_config(p, N, engine="banded", device="cuda"
                                ).colff_spec
    box = make_box(p.L, TILT)
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    bins, f = cb.bin_particles(
        pos, box, cs.bins,
        values=torch.randn(pos.shape, generator=g, device="cuda"))
    fac = cff.build_col_factors(bins, box, cs, p)
    nodes = cff.spread_nodes(bins, box, p)
    grid = torch.randn((3, p.Nx, p.Ny, p.Nz), generator=g, device="cuda")
    calls = {
        "spread": lambda: cff.spread_moments_kernel(f, cs, p, nodes, TILT),
        "contract": lambda: cff.contract_col_kernel(grid, cs, p, fac),
    }
    plain = {"spread": cff.spread_moments(f, cs, p, nodes, TILT),
             "contract": cff.contract_col(grid, cs, p, fac)}

    def calls_of(k):
        return {n: fn for n, fn in calls.items()
                if k == "this" or n != "spread"}

    times = {k: {name: [] for name in calls_of(k)} for k in libs}
    device = {k: {name: [] for name in calls_of(k)} for k in libs}
    checks = {}
    for k, lib in libs.items():
        kernels._lib = lib
        checks[k] = {}
        for name, fn in calls_of(k).items():
            out = fn()
            checks[k][name] = {"rel_max": rel_max(out, plain[name])[0],
                               "rerun_bitwise": bool(torch.equal(fn(), out))}
    for _ in range(ROUNDS):
        for k in order:
            kernels._lib = libs[k]
            for name, fn in calls_of(k).items():
                times[k][name].append(cuda_ms(fn, REPS))
                device[k][name].append(graph_ms(fn, REPS))
    kernels._lib = libs["this"]

    cap, C = cs.bins.cap, cs.bins.n_cells_total
    wxy32, wz32 = cff._factors_f32(nodes[:3], nodes[3], TILT, cs, p)
    X = ((f * float(np.float32(p.spread_prefac))).permute(1, 0, 2)[:, :, None]
         * wz32[:, None]).reshape(C, 3 * p.Nz, cap)
    Xt = X.transpose(1, 2)
    vt = cff._grid_to_windows(grid, cs, p, fac.wxy.dtype).transpose(1, 2)
    library = {"spread_bmm": cuda_ms(lambda: torch.bmm(wxy32, Xt), REPS),
               "contract_bmm": cuda_ms(lambda: torch.bmm(vt, fac.wxy), REPS)}
    return {
        "shapes": {"C": C, "NN": fac.wxy.shape[1], "Nz": p.Nz, "cap": cap,
                   "dtype": str(fac.wxy.dtype)},
        "ms": times, "device_ms": device,
        "median_ms": {k: {n: float(np.median(t)) for n, t in per.items()}
                      for k, per in times.items()},
        "median_device_ms": {k: {n: float(np.median(t))
                                 for n, t in per.items()}
                             for k, per in device.items()},
        "checks": checks, "library_ms": library}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", default=None,
                    help="root of another checkout whose kernels to time")
    ap.add_argument("--contract", action="store_true",
                    help="also time build_mv with contracted arithmetic")
    ap.add_argument("--only", choices=("far", "matvec", "build", "bin",
                                       "step"),
                    action="append", help="run only these parts (repeatable)")
    a = ap.parse_args()
    parts = set(a.only or ("far", "matvec", "build", "bin", "step"))
    sys.path[0] = str(ROOT)          # not this script's own directory
    import torch

    if not torch.cuda.is_available():
        print("ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import make_positions
    from pse_tpu_torch import cellbins, kernels
    from pse_tpu_torch.ops import banded_nearfield as bdn

    pos_np, L = make_positions(N, PHI, seed=0)
    pos = torch.as_tensor(pos_np, device="cuda")
    libs = {"this": kernels.library()}
    for line in kernels.BUILD_INFO.get("log", "").splitlines():
        if "Function properties" in line or "registers" in line \
                or "spill" in line:
            print("ptxas " + line.strip(), file=sys.stderr)
    import pse_tpu_torch

    sides = {"this": bdn}
    bin_sides = {"this": cellbins}
    pkgs = {"this": pse_tpu_torch}
    order = ["this", "this"]
    if a.other:
        other = load_other(Path(a.other).resolve())
        libs["other"] = other.kernels.library()
        sides["other"] = importlib.import_module(
            "pse_tpu_torch_other.ops.banded_nearfield")
        bin_sides["other"] = importlib.import_module(
            "pse_tpu_torch_other.cellbins")
        pkgs["other"] = other
        order = ["other", "this", "this", "other"]
    result = {"other": a.other, "order": order, "rounds": ROUNDS,
              "reps": REPS}
    if "far" in parts:
        result["far"] = ab_far_field(libs, order, pos, L)
    if "matvec" in parts:
        result["matvec"] = ab_matvec(sides, order, pos, L)
    if "bin" in parts:
        result["bin"] = ab_bin(bin_sides, order, pos, L)
    if "step" in parts:
        result["step"] = ab_step(pkgs, order, pos_np, L)
    if "build" in parts:
        tmp = tempfile.mkdtemp(prefix="ab_contract_")
        try:
            contract = (contract_library(kernels, Path(tmp) / "csrc")
                        if a.contract else None)
            result["build"] = ab_build_mv(sides, order, pos, L, contract)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
