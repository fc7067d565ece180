#!/usr/bin/env python3
"""A/B timing of the one-RHS build_mv kernel (csrc/banded.cu) on one CUDA
device, at chip_smoke.py's brownian main-path shapes.

    python3 pse_tpu_torch/ab_build_mv.py [--root DIR] [--contract]

Times ``build_mv_banded`` with one right-hand side (CUDA events, tilt 0.3,
the default bfloat16 blocks) from the ``pse_tpu_torch`` package under
``--root`` (default: the checkout holding this script; an older checkout
of the port serves as well, its build_mv_banded taking the same arguments).
With ``--contract`` it also builds banded.cu with its explicit roundings
(``__fmul_rn``, ``__fadd_rn``, ``__fsub_rn``) replaced by plain arithmetic,
which nvcc contracts into fused multiply-adds, times the two libraries in
alternating rounds, and gives each one's float32 A against the plain build
(max |diff| / max |plain|) at the main path's shapes and at the small
configurations of tests/test_torch_cuda.py.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

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


def cuda_ms(fn, reps):
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


def operands(pos, n, L, tilt, window=None, dtype=None):
    """build_mv_banded's arguments at (n, L, tilt) and a random f."""
    import torch

    from pse_tpu_torch import integrator, make_params
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.cellbins import bin_columns, vec_to_cells
    from pse_tpu_torch.ops import banded_nearfield as bdn

    p = make_params(xi=XI, error=ERROR, L=L)
    cfg = integrator.make_config(p, n, engine="banded", has_forces=False,
                                 device="cuda")
    bs = cfg.band_spec
    if window is not None:
        bs = bs._replace(window=window)
    if dtype is not None:
        bs = bs._replace(block_dtype=dtype)
    box = make_box(p.L, tilt)
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, _, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    f = vec_to_cells(bins, bs.bins,
                     torch.randn(pos.shape, generator=g, device="cuda"))
    return (bins, tilt, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh), f, p.self_mobility


def build_residual(args):
    """max |A - plain| / max |plain| of the float32 build, both planes."""
    from pse_tpu_torch.ops import banded_nearfield as bdn

    a = (*args[:2], args[2]._replace(block_dtype="float32"), *args[3:])
    A = bdn.build_banded_blocks(*a)
    plain = bdn.build_banded_blocks_reference(*a)
    return max(float((A[:, :, k] - plain[:, :, k]).abs().max()
                     / plain[:, :, k].abs().max()) for k in range(2))


def contract_library(kernels, where: Path):
    """Load a second kernel library whose banded.cu rounds with plain
    (contractible) arithmetic; returns it and leaves the first loaded."""
    first = kernels.library()
    shutil.copytree(kernels.CSRC, where)
    src = (where / "banded.cu").read_text()
    for old, new in ROUNDINGS.items():
        if old not in src:
            raise RuntimeError(f"banded.cu has no {old}")
        src = src.replace(old, new)
    src = src.replace("namespace {", PLAIN_OPS + "namespace {", 1)
    (where / "banded.cu").write_text(src)
    kernels.CSRC, kernels._lib = where, None
    second = kernels.library()
    kernels._lib = first
    return first, second


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--contract", action="store_true")
    a = ap.parse_args()
    root = str(Path(a.root).resolve())
    sys.path[0] = root               # not this script's own directory
    import torch

    if not torch.cuda.is_available():
        print("ab_build_mv: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import make_positions
    from pse_tpu_torch import kernels
    from pse_tpu_torch.ops import banded_nearfield as bdn

    pos, L = make_positions(N, PHI, seed=0)
    pos = torch.as_tensor(pos, device="cuda")
    args, f, self_mob = operands(pos, N, L, TILT)
    libs = {"as_is": kernels.library()}
    tmp = tempfile.mkdtemp(prefix="ab_build_mv_")
    try:
        if a.contract:
            libs["as_is"], libs["contract"] = contract_library(
                kernels, Path(tmp) / "csrc")
        times = {k: [] for k in libs}
        for _ in range(ROUNDS):
            for k, lib in libs.items():
                kernels._lib = lib
                times[k].append(cuda_ms(
                    lambda: bdn.build_mv_banded(*args, f, self_mob), REPS))
        out = {"root": root, "shapes": {
            "C": args[2].bins.n_cells[0] * args[2].bins.n_cells[1],
            "S": args[2].bins.cap, "R": args[2].rows, "W": args[2].window,
            "block_dtype": args[2].block_dtype},
            "build_mv_1rhs_ms": times,
            "median_ms": {k: float(np.median(v)) for k, v in times.items()}}
        if a.contract:
            res = {}
            for k, lib in libs.items():
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
            out["f32_build_vs_plain"] = res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out["card"] = card
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
