#!/usr/bin/env python3
"""A/B timing of the far-field kernels (csrc/spread.cu, csrc/contract.cu)
on one CUDA device, at chip_smoke.py's main-path shapes.

    python3 pse_tpu_torch/ab_far.py [--other DIR]

Times ``spread_moments_kernel`` and ``contract_col_kernel`` (CUDA events,
tilt 0.3, the default bfloat16 factors) with this checkout's kernel
library and, with ``--other``, with a second library built from the
``pse_tpu_torch/csrc`` of another checkout (e.g. the parent unpacked by
``git archive`` into the gitignored ``scratch_tree/``), whose C entry points
take the same arguments.  The two libraries run in alternating rounds in
the order other, this, this, other, each call timed twice: by CUDA
events around a loop of wrapper calls (as chip_smoke.py times them) and
by replaying a CUDA graph of the same calls (the device time alone,
without the wrapper's host work).  Each library's results are held
against the plain versions (max |diff| / max |plain|) and against a
rerun (bitwise).  Also times the library yardsticks, ``torch.bmm`` of wxy
with a pre-built X (the spread's product) and of the pre-gathered
windows with wxy (the contract's H).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N, PHI, XI, ERROR, TILT = 100_000, 0.45, 0.5, 1e-3, 0.3
ROUNDS, REPS = 5, 20


def graph_ms(fn, reps):
    """Mean milliseconds of fn() on the device: reps calls captured in a
    CUDA graph, one replay timed by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def load_library(kernels, csrc: Path):
    """Build and load the kernel library of another csrc/ directory; the
    module's own library stays loaded."""
    first = kernels.library()
    saved = kernels.CSRC, kernels.SOURCES, kernels.HEADERS
    try:
        kernels.CSRC = csrc
        kernels.SOURCES = tuple(s for s in saved[1] if (csrc / s).exists())
        kernels.HEADERS = tuple(sorted(p.name for p in csrc.glob("*.cuh")))
        kernels._lib = None
        other = kernels.library()
    finally:
        kernels.CSRC, kernels.SOURCES, kernels.HEADERS = saved
        kernels._lib = first
    return other


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", default=None,
                    help="root of another checkout whose kernels to time")
    a = ap.parse_args()
    sys.path[0] = str(ROOT)          # not this script's own directory
    import torch

    if not torch.cuda.is_available():
        print("ab_far: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import cuda_ms, make_positions, rel_max
    from pse_tpu_torch import integrator, kernels, make_params
    from pse_tpu_torch import cellbins as cb
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.ops import column_farfield as cff

    pos, L = make_positions(N, PHI, seed=0)
    pos = torch.as_tensor(pos, device="cuda")
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
    grid = torch.randn((3, p.Nx, p.Ny, p.Nz), generator=g, device="cuda")

    libs = {"this": kernels.library()}
    order = ["this", "this"]
    if a.other:
        libs["other"] = load_library(
            kernels, Path(a.other).resolve() / "pse_tpu_torch" / "csrc")
        order = ["other", "this", "this", "other"]
    calls = {
        "spread": lambda: cff.spread_moments_kernel(f, cs, p, fac),
        "contract": lambda: cff.contract_col_kernel(grid, cs, p, fac),
    }
    plain = {"spread": cff.spread_moments(f, cs, p, fac),
             "contract": cff.contract_col(grid, cs, p, fac)}
    times = {k: {name: [] for name in calls} for k in libs}
    device = {k: {name: [] for name in calls} for k in libs}
    checks = {}
    for k, lib in libs.items():
        kernels._lib = lib
        checks[k] = {}
        for name, fn in calls.items():
            out = fn()
            checks[k][name] = {"rel_max": rel_max(out, plain[name])[0],
                               "rerun_bitwise": bool(torch.equal(fn(), out))}
    for _ in range(ROUNDS):
        for k in order:
            kernels._lib = libs[k]
            for name, fn in calls.items():
                times[k][name].append(cuda_ms(fn, REPS))
                device[k][name].append(graph_ms(fn, REPS))
    kernels._lib = libs["this"]

    cap, C = cs.bins.cap, cs.bins.n_cells_total
    X = ((f * float(np.float32(p.spread_prefac))).permute(1, 0, 2)[:, :, None]
         * fac.wz.float()[:, None]).reshape(C, 3 * p.Nz, cap
                                            ).to(fac.wxy.dtype)
    Xt = X.transpose(1, 2)
    vt = cff._grid_to_windows(grid, cs, p, fac.wxy.dtype).transpose(1, 2)
    library = {"spread_bmm": cuda_ms(lambda: torch.bmm(fac.wxy, Xt), REPS),
               "contract_bmm": cuda_ms(lambda: torch.bmm(vt, fac.wxy), REPS)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({
        "other": a.other, "order": order, "rounds": ROUNDS, "reps": REPS,
        "shapes": {"C": C, "NN": fac.wxy.shape[1], "Nz": p.Nz, "cap": cap,
                   "dtype": str(fac.wxy.dtype)},
        "ms": times, "device_ms": device,
        "median_ms": {k: {n: float(np.median(t)) for n, t in per.items()}
                      for k, per in times.items()},
        "median_device_ms": {k: {n: float(np.median(t))
                                 for n, t in per.items()}
                             for k, per in device.items()},
        "checks": checks, "library_ms": library, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
