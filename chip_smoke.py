#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure makes the script exit non-zero without the result line):
  [build]   build the CUDA kernels from pse_tpu_torch/csrc (nvcc, sm_90a) and
            print the build seconds and the ptxas resource lines;
  [small]   the force-free step on the card (bf16 and f32 blocks) against the
            same step on the CPU (the plain PyTorch versions), same uniforms;
  [forces-small]  the thermal step with forces, the athermal step and
            mobility() on the card against the CPU (N=1080, L=24, tilts 0 and
            0.3), same uniforms: <= 1e-4 (float32) and <= 5e-3 (bfloat16);
  [oracle]  mobility() on the card at tests/data/oracle_gate.npz (bf16 blocks
            and far-field factors) against the float64 direct-Ewald u_ref:
            relative 2-norm <= 5e-3;
  [blocked-small]  the blocked engine on the card against the CPU (N=1080,
            L=24, tilts 0 and 0.3, same uniforms): matvec_cells
            (csrc/blocked.cu) against matvec_cells_reference on the card's
            bf16 and f32 blocks (<= 2e-6, one launch a call, a rerun
            bitwise), then the thermal step without
            and with forces, the athermal step and mobility(), at error 1e-3
            (bf16 blocks) <= 5e-3 and at 1e-4 (f32 blocks, where banded
            falls back to blocked) <= 1e-4, and at 1e-3 with colff_spec=None
            (the stored-weight far field) <= 5e-3;
  [blocked-oracle]  mobility() with engine="blocked" at oracle_gate.npz
            against u_ref: relative 2-norm <= 5e-3;
  [gather-small]  the gather engine on the card against the CPU, float32,
            on the fallback box (L=10 at phi=0.45, N=107, through
            Simulation's default engine: all-pairs), the oracle gate's box
            with engine="gather" (a 3x5x5 cell list) and the same box with
            nlist_type="stencil", tilts 0 and 0.3: the neighbor idx equal,
            the brownian, with-forces and athermal steps and mobility()
            <= 1e-4 at equal m, step and tap-spread reruns bitwise;
  [gather-oracle]  mobility() with engine="gather" at oracle_gate.npz
            against u_ref: relative 2-norm <= 5e-3;
  [classes-small]  the class-packed build_mv and matvec (occupancy classes
            ((t_cap-1, C-2), (t_cap, 2)) at N=1080, L=24, tilts 0, 0.07 and
            0.3, float32 and bfloat16 A, one and two right-hand sides): u
            bitwise the single-class kernels' u and <= 1e-5 (float32) /
            <= 2e-3 (bfloat16) of the plain matvec in the 2-norm, the packed
            A bitwise the single-class A's tiles of its columns (and, at
            float32, the plain build's), perm / inv / flag equal to a numpy
            emulation of class_assignment, reruns bitwise, an overfull
            split flagging OVF_CLASS, and the step with classes bitwise the
            step without;
  [halo-small]  the halo engine (parallel.halo) on the card, D = 1, 2 and 4
            x-slabs on cuda:0 (a mesh whose device repeats), at N=4800,
            L=33 (W = 192), tilts 0 and 0.3, float32 and bfloat16 A: halo
            mobility against integrator.mobility <= 1e-4 / 2e-3 (2-norm),
            with two slab classes bitwise without, reruns bitwise, at D = 4
            the card against the CPU halo <= 1e-4 / 5e-3 (max-norm); the
            thermal step with forces at equal uniforms against one device
            (displacement, 2-norm, equal m) and its rerun bitwise; mreal_t2
            against two mreal_t <= 1e-4; an overfull slab class flagging
            OVF_CLASS;
  [sharded-small]  make_sharded_step / make_sharded_mobility (blocked and
            gather, D = 4 on cuda:0) on tests/test_sharding.py's 8^3
            lattice, thermal (equal uniforms) and athermal, tilt 0.03,
            against the one-device step: positions <= 2e-5, velocities
            <= 5e-4 of their scale, mobility <= 1e-5 of its scale, gather
            bitwise;
  [main]    the brownian main path: Simulation(N=100k, phi=0.45) with
            PSEv1(T=1, seed=1, xi=0.5, error=1e-3) on engine="banded", one
            occupancy class (set_integrator's classes dropped), a
            warm-up, then 20 timed steps with every kernel's launch count set
            to 0 before and read after (each kernel of the path must be > 0;
            build_mv once per step, the matvec m - 1 times);
            particle-steps/s, ms/step, the Lanczos m histogram, the overflow
            retries, the A bytes and the peak device memory;
  [main-forces]  the same with force_fn returning bench.py's fixed random
            forces (default_rng(1).normal): the spread and the two-RHS build
            join the path;
  [main-mobility] Simulation.mobility_matvec once at the main path's state;
  [main-blocks]   build_banded_blocks once per tilt (0, 0.3) at the main
            path's state, the standalone build's entry point;
  [main-classes], [main-classes-forces]  the same with occupancy classes,
            as bench.py times them: 200 steps on one class, the classes
            sized from the relaxed histogram, then the warm-up and 20 timed
            steps (the class-packed kernels); the classes, the packed A
            bytes against the single class's, the peak device memory, the
            class re-measures, one more step's device memory above the
            live baseline with the classes and with one class, and
            alternated 10-step runs with and without them (4 pairs, ms/step
            by the host clock, in one process state);
  [main-classes-mobility]  mobility_matvec at that state with its classes
            against one class: <= 1e-6 (and the mismatched elements);
  [classes-run]  Simulation with the classes set_integrator sizes from the
            lattice, 300 steps: the OVF_CLASS retries, the re-measures
            (<= 2), the final classes, finite positions;
  [blocked], [blocked-forces]  the same Simulation with no engine argument:
            the default, blocked engine (asserted), a warm-up and 10 timed
            steps; ms/step, particle-steps/s, the m histogram, the retries,
            the pair-block bytes, the peak device memory and every kernel's
            launches (the fill, build_pair_blocks, matvec_cells (m a
            step, 1 + m with forces), the contract and, with forces, the
            spread > 0; the banded kernels 0; on the banded, gather and halo
            paths build_pair_blocks and matvec_cells 0);
  [blocked-mobility]  Simulation.mobility_matvec at the blocked state;
  [gather], [gather-forces]  the same Simulation with engine="gather", a
            warm-up and 10 timed steps: ms/step, particle-steps/s, the m
            histogram, the peak device memory and the kernel launches (the
            fill of the neighbor list's cell binning > 0, the others 0);
  [halo-main]  make_halo_step at the main path's config with
            shard_slabs=4, D = 4 on cuda:0 (slab classes from the lattice
            where they form): one mobility against the one-device engine
            (<= 2e-3, 2-norm); build_mv (1 and 2 RHS) and the matvec on
            the first and the last slab's own operands (C_loc 90, the
            seam-shifted halos) against matvec_banded_reference on the
            interior columns (float32 <= 1e-5, bfloat16 <= 2e-3, as
            [kernels]) and against the one-device kernel on the same
            columns; a warm-up that must flag no overflow and 10 timed
            thermal steps with forces that must flag none (counts set to 0
            before and read after: build_mv D and the matvec D (m - 1) per
            step), ms/step, each slab's A bytes, the peak device memory,
            and torch.profiler over 3 more steps;
  [halo-1m]  BASELINE config 5 on one card: N = 1,000,000 (bench.py's
            lattice, phi 0.45), D = 4 on cuda:0: one mobility against the
            one-device banded engine (<= 2e-3) and the slab kernel checks
            of [halo-main] (C_loc 320, S 1184, W 192, the slab classes), a
            warm-up of 5 steps and 3 timed thermal steps with forces as in
            [halo-main], except that a warm-up step that flags an overflow
            is redone on grow_config's config, as Simulation.run does (the
            lattice fills columns to 1158 of the 1184 slots and the 4th
            step overflows them on either engine); the retries are printed,
            and a grown config gets the mobility and kernel checks again
            at the state the timed steps start from; each slab's A against
            the global A, the peak device memory, the profile;
  [sharded-main]  make_sharded_step at N = 100k (blocked and gather, D = 4
            on cuda:0): one mobility against the one-device engine (<= 1e-5
            of its scale), a warm-up and 3 timed thermal steps with forces,
            each shard's bytes of pair data;
  [sedimentation]  the twin of examples/sedimentation.py on the card (N=10k,
            L=64, athermal, mobility_matvec and 20 steps);
  [profile] torch.profiler over 3 more steps of each main path (with and
            without classes), of the blocked path with forces and of both
            gather paths: device time
            by kernel, kernel launches per step and the device's idle share;
  [kernels] each kernel against its plain version at the main path's shapes
            (and the spread and the contract at the oracle's), at tilt 0 and
            0.3: the fill bitwise on every output (slots, value rows, ranks,
            overflow, starts, counts) for both binnings, and for both in an
            overfull case; build_mv and matvec <= 1e-5
            (float32 A) and <= 2e-3 (bfloat16 A) against the unrounded
            float32 matvec_banded_reference, two right-hand sides <= 1e-4
            against two one-RHS launches; build_banded_blocks bitwise
            build_mv's A and <= 1e-6 (float32) / 2^-8 (bfloat16) of the
            float32 plain build, the float32 build bitwise; contract <= 1e-5
            (float32) and <= 5e-3 (bfloat16); the spread (float32 factors
            of its own) <= 1e-5 of its plain version, also at the 1M cells'
            shapes ([spread-1m]) (max |diff| / max |plain|); build_mv u vs
            matvec u <= 1e-6 and bitwise (build_mv ends in the matvec); matvec
            (one and two right-hand sides), spread and contract reruns
            bitwise equal; the fill also at the blocked near field's 3-D
            cells (tilts 0 and 0.3, and overfull), and matvec_cells on the
            card against its CPU run on the same blocks, <= 1e-5 (float32
            blocks) and <= 2e-3 (bfloat16);
  [timing]  CUDA-event times of each kernel wrapper and its plain version,
            with the least time the card could take (bytes at 3.35 TB/s,
            operations at the peak rate of their type; the spread's bound
            is its layout's bytes: forces and node coordinates read, window
            moments written), and torch.bmm as the library yardstick of the
            spread (float32 wxy with a pre-built X) and of the contract
            (the pre-gathered windows with wxy); [spread-1m]: the spread
            kernel, its plain version and its bound at N = 1M; printed as one
            JSON line; the fill and the banded kernels also as their kernel
            launches alone (CUDA-graph replay, without the wrapper's torch
            work): the fill, the matvec, build_mv at two right-hand sides
            (one beside it: the build and the matvec) and the build alone;
            bin_columns and bin_particles with values (CUDA events); the
            matvec's bound counts the A rows of the non-empty tiles, the
            ones the kernel reads, and the bound of all of A is kept beside
            it; the fill at the blocked near field's shape (wrapper, kernel
            alone, bound); [blocked-build]: build_pair_blocks
            (csrc/blocked.cu) at the [blocked-forces] state (N=100k, cells
            (9, 13, 13), cap 112, bf16): the blocks torch.equal and bit for
            bit build_pair_blocks_reference's at tilts 0 and 0.3, a rerun
            bitwise, one launch a call, the kernel alone (CUDA-graph
            replay), its wrapper and its plain version (CUDA events) at tilt
            0.3 beside its bound by bytes; matvec_cells on those blocks
            against its plain version (<= 2e-6, a rerun bitwise), alone
            (graph replay) and through its wrapper beside its bounds by
            bytes (the live slot pairs, every stored byte), its plain
            version and torch.bmm on pre-upcast operands (library_ms);
            then build_pair_blocks and matvec_cells by CUDA events, with
            the bytes each must move and their kernel launches per call by
            torch.profiler;
            the gather step's parts
            (the neighbor build, the pair coefficients, one matvec, the
            taps, the tap spread and contract) by CUDA events beside the
            bytes each must move; the class-packed build_mv (two
            right-hand sides) and matvec beside the single-class ones at
            the [main-classes-forces] state (u bitwise; wrapper by CUDA
            events, kernel alone by graph replay, single, packed, packed,
            single; bounds on the live tiles' A read and the packed A
            written);
each kernel's line also carries launches_halo, its launches in
[halo-main]'s timed steps;
then the card's name and power limit (nvidia-smi) and, last, the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs the repository's pse_tpu_torch package beside it and a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, per type
N, PHI, XI, ERROR, SEED, DT = 100_000, 0.45, 0.5, 1e-3, 1, 1e-3
WARM_STEPS, TIMED_STEPS = 5, 20
RELAX_STEPS = 200                 # bench.py's relaxation on one class
CLASS_RUN_STEPS = 300
BLOCKED_WARM, BLOCKED_TIMED = 3, 10
GATHER_WARM, GATHER_TIMED = 3, 10
ORACLE = os.path.join(HERE, "tests", "data", "oracle_gate.npz")


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


def graph_ms(fn, reps):
    """Mean milliseconds of fn() on the device: reps calls captured in a
    CUDA graph, one replay timed by CUDA events (no host work inside)."""
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
        if "Function properties for" in line:
            # the kernel's name and template arguments, from the mangled name
            name = line.split("Function properties for")[-1].strip()
            print("  " + re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_\d+_\w+?_cu_\w{8}",
                                "", name)[:48])
        elif line.startswith("==") or "registers" in line or "spill" in line:
            print("  " + line.strip())


def _raw_uniforms(config, seed):
    bs, p = (config.band_spec or config.nf_spec).bins, config.params
    rng = np.random.default_rng(seed)
    C = bs.n_cells_total
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
                cpu_d, integrator.make_state(pos, 3, tilt, "cpu"), None, 1.0,
                DT, rate, None, uniforms=draws)
            s_g, i_g = integrator.step(
                gpu, integrator.make_state(pos, 3, tilt, "cuda"), None, 1.0,
                DT, rate, None, uniforms=draws)
            r, _ = rel_max(i_g["velocities"].cpu(), i_c["velocities"])
            ph.check(f"step {dtype} tilt={tilt} m={i_g['m_lanczos']}/"
                     f"{i_c['m_lanczos']}", r, bound)
            if int(s_g.nbr_overflow) or not torch.isfinite(s_g.pos).all():
                ph.failed.append(f"small step {dtype} tilt={tilt} overflow")


def phase_forces_small(ph):
    """The with-forces step, the athermal step and mobility() on the card vs
    on the CPU at N=1080, L=24, with the same uniforms."""
    import dataclasses

    import torch

    from pse_tpu_torch import integrator, make_params

    print("[forces-small] with-forces paths on the card vs the CPU plain path "
          "(N=1080, L=24)")
    rng = np.random.default_rng(12)
    n, L = 1080, 24.0
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    forces = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    params = make_params(xi=XI, error=ERROR, L=L)
    for thermal in (True, False):
        cpu = integrator.make_config(params, n, engine="banded",
                                     thermal=thermal, seed=3, device="cpu")
        draws = _raw_uniforms(cpu, 5) if thermal else None
        for dtype, bound in (("float32", 1e-4), ("bfloat16", 5e-3)):
            gpu = integrator.make_config(
                params, n, engine="banded", thermal=thermal, seed=3,
                block_dtype=dtype, ff_weight_dtype=dtype, device="cuda")
            cpu_d = dataclasses.replace(cpu, cheb=gpu.cheb)
            for tilt, rate in ((0.0, 0.0), (0.3, 0.5)):
                s_c, i_c = integrator.step(
                    cpu_d, integrator.make_state(pos, 3, tilt, "cpu"),
                    forces, 1.0, DT, rate, None, uniforms=draws)
                s_g, i_g = integrator.step(
                    gpu, integrator.make_state(pos, 3, tilt, "cuda"),
                    forces.cuda(), 1.0, DT, rate, None, uniforms=draws)
                r, _ = rel_max(i_g["velocities"].cpu(), i_c["velocities"])
                kind = "thermal+forces" if thermal else "athermal"
                ph.check(f"{kind} step {dtype} tilt={tilt} m={i_g['m_lanczos']}"
                         f"/{i_c['m_lanczos']}", r, bound)
                if i_g["m_lanczos"] != i_c["m_lanczos"]:
                    ph.failed.append(f"{kind} {dtype} tilt={tilt}: m differs")
                if int(s_g.nbr_overflow) or not torch.isfinite(s_g.pos).all():
                    ph.failed.append(f"{kind} step {dtype} tilt={tilt} "
                                     "overflow")
                if thermal:
                    continue
                u_c, _ = integrator.mobility(cpu_d, pos, forces, tilt)
                u_g, o_g = integrator.mobility(gpu, pos, forces.cuda(), tilt)
                r, _ = rel_max(u_g.cpu(), u_c)
                ph.check(f"mobility {dtype} tilt={tilt}", r, bound)
                if int(o_g):
                    ph.failed.append(f"mobility {dtype} tilt={tilt} overflow")


def _class_assignment_numpy(spec, n_valid):
    """class_assignment emulated in numpy: columns by descending tile need,
    ties by ascending id; overflow on a segment's first member."""
    from pse_tpu_torch.ops import banded_nearfield as bdn

    R = spec.rows
    need = (np.maximum(n_valid, 1) + R - 1) // R
    perm = np.lexsort((np.arange(need.size), -need))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    over = any(need[perm[off]] > tk for tk, _, off in bdn.class_segments(spec))
    return perm.astype(np.int32), inv.astype(np.int32), over


def _norm_rel(a, b):
    """||a - b|| / ||b|| (tests/test_torch_cuda.py's banded residual)."""
    return float((a.double() - b.double()).norm() / b.double().norm())


def phase_classes_small(ph):
    """The class-packed build_mv and matvec at the banded test setup
    (N=1080, L=24, a manual 2-class split, tests/test_banded.py's
    class-packed case) against the single-class kernels and the plain
    matvec; the packed A against the single-class A's live tiles; the
    assignment against a numpy emulation; an overfull split flags
    OVF_CLASS; the step with classes against the step without."""
    import dataclasses

    import torch

    from pse_tpu_torch import integrator, make_box, make_params
    from pse_tpu_torch.cellbins import bin_columns, vec_to_cells
    from pse_tpu_torch.ops import banded_nearfield as bdn

    print("[classes-small] class-packed build_mv and matvec (N=1080, L=24, "
          "classes ((t_cap-1, C-2), (t_cap, 2)))")
    rng = np.random.default_rng(31)
    n, L = 1080, 24.0
    pos = torch.as_tensor(rng.uniform(-L / 2, L / 2, size=(n, 3))
                          .astype(np.float32), device="cuda")
    forces = torch.as_tensor(rng.normal(size=(2, n, 3)).astype(np.float32),
                             device="cuda")
    params = make_params(xi=XI, error=ERROR, L=L)
    checked = 0
    for dtype, bound in (("float32", 1e-5), ("bfloat16", 2e-3)):
        cfg = integrator.make_config(params, n, thermal=False,
                                     engine="banded", block_dtype=dtype,
                                     device="cuda")
        p, bs1 = cfg.params, cfg.band_spec
        C = bs1.bins.n_cells_total
        t_cap = bs1.bins.cap // bs1.rows
        bs = bs1._replace(classes=((t_cap - 1, C - 2), (t_cap, 2)))
        for tilt in (0.0, 0.07, 0.3):
            box = make_box(p.L, tilt)
            bins = bin_columns(pos, box, bs.bins)
            j0, nv, _, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
            perm, inv, ovf = bdn.class_assignment(bs, nv)
            want = _class_assignment_numpy(bs, nv.cpu().numpy())
            if (not np.array_equal(perm.cpu().numpy(), want[0])
                    or not np.array_equal(inv.cpu().numpy(), want[1])
                    or bool(ovf) != want[2] or want[2]):
                ph.failed.append(f"classes-small class_assignment {dtype} "
                                 f"tilt={tilt} (flag {bool(ovf)})")
            pack = (perm, inv)
            f = [vec_to_cells(bins, bs.bins, forces[k]) for k in range(2)]
            args = (bins, tilt, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr,
                    j0, nv, zsh)
            args1 = (bins, tilt, bs1) + args[3:]
            tag = f"{dtype} tilt={tilt}"
            for rhs in (f[0], torch.cat(f)):
                nr = rhs.shape[0] // 3
                blocks, u_b = bdn.build_mv_banded(*args, rhs, p.self_mobility,
                                                  pack=pack)
                u_m = bdn.matvec_banded(blocks, *args, rhs, p.self_mobility,
                                        pack=pack)
                blocks1, u_b1 = bdn.build_mv_banded(*args1, rhs,
                                                    p.self_mobility)
                u_m1 = bdn.matvec_banded(blocks1, *args1, rhs,
                                         p.self_mobility)
                ref = bdn._reference_per_rhs(
                    rhs, lambda fk: bdn.matvec_banded_reference(
                        *args1[:9], fk, p.self_mobility))
                ph.check(f"packed build_mv u vs single-class {nr}-RHS {tag} "
                         "(mismatched elements)", int((u_b != u_b1).sum()), 0)
                ph.check(f"packed matvec u vs single-class {nr}-RHS {tag} "
                         "(mismatched elements)", int((u_m != u_m1).sum()), 0)
                ph.check(f"packed build_mv vs plain {nr}-RHS {tag} (2-norm)",
                         _norm_rel(u_b, ref), bound)
                ph.check(f"packed matvec vs plain {nr}-RHS {tag} (2-norm)",
                         _norm_rel(u_m, ref), bound)
                want_a = bdn.pack_blocks_reference(blocks1, bs, perm)
                bad = sum(int((a != b).sum()) for a, b in zip(blocks, want_a))
                ph.check(f"packed A vs single-class A's tiles {nr}-RHS {tag} "
                         "(mismatched elements)", bad, 0)
                _check_rerun(ph, f"packed matvec {nr}-RHS {tag}", u_m,
                             lambda rhs=rhs: bdn.matvec_banded(
                                 blocks, *args, rhs, p.self_mobility,
                                 pack=pack))
                again = bdn.build_mv_banded(*args, rhs, p.self_mobility,
                                            pack=pack)
                ph.check(f"packed build_mv {nr}-RHS {tag} rerun (mismatched "
                         "elements)", int((again[1] != u_b).sum())
                         + sum(int((a != b).sum())
                               for a, b in zip(again[0], blocks)), 0)
                checked += 1
            if dtype == "float32":
                # the float32 build is its plain version bit for bit
                plain = bdn.pack_blocks_reference(
                    bdn.build_banded_blocks_reference(*args1), bs, perm)
                ph.check(f"packed A vs plain build {tag} (mismatched "
                         "elements)", sum(int((a != b).sum())
                                          for a, b in zip(blocks, plain)), 0)
        # a top class too small: the step's mask carries OVF_CLASS, and the
        # packed kernels still run (their columns past the class are cut)
        over = bs1._replace(classes=((2, C - 1), (t_cap, 1)))
        ocfg = dataclasses.replace(cfg, band_spec=over)
        box = make_box(p.L, 0.3)
        eng = integrator.engine_of(ocfg)
        ctx, mask = eng.prepare(pos, box, forces[0])
        ctx, u = eng.build_mv(ctx, ctx.nf_f)
        ph.check(f"overfull classes {dtype}: OVF_CLASS set (0 = set)",
                 0 if int(mask) & integrator.OVF_CLASS else 1, 0)
        if not bool(torch.isfinite(u).all()):
            ph.failed.append(f"overfull classes {dtype}: u not finite")
        # the steps: classes against one class, same uniforms, bitwise
        ccfg = dataclasses.replace(cfg, band_spec=bs, thermal=True, seed=3)
        scfg = dataclasses.replace(cfg, thermal=True, seed=3)
        draws = _raw_uniforms(scfg, 6)
        for tilt, rate in ((0.0, 0.0), (0.3, 0.5)):
            outs = [integrator.step(c, integrator.make_state(
                pos.cpu().numpy(), 3, tilt, "cuda"), forces[0], 1.0, DT, rate,
                None, uniforms=draws) for c in (ccfg, scfg)]
            (s_c, i_c), (s_s, i_s) = outs
            ph.check(f"step with classes vs one class {dtype} tilt={tilt} "
                     f"m={i_c['m_lanczos']}/{i_s['m_lanczos']} (mismatched "
                     "elements)", int((s_c.pos != s_s.pos).sum()), 0)
            if int(s_c.nbr_overflow):
                ph.failed.append(f"classes-small step {dtype} tilt={tilt}: "
                                 f"overflow {int(s_c.nbr_overflow)}")
    print(f"  {checked} packed build_mv / matvec cases")


def phase_oracle(ph):
    """mobility() on the card (the defaults: bf16 blocks and factors)
    against the float64 direct-Ewald oracle (the JAX bench gate's check)."""
    from pse_tpu_torch import integrator, make_params

    d = np.load(ORACLE)
    n = int(d["n"])
    params = make_params(xi=float(d["xi"]), error=ERROR, L=float(d["L"]))
    cfg = integrator.make_config(params, n, thermal=False, engine="banded",
                                 device="cuda")
    print(f"[oracle] mobility() at oracle_gate.npz: N={n} L={float(d['L']):.4f}"
          f" grid {params.Nx}^3, far-field columns "
          f"{cfg.colff_spec.bins.n_cells[:2]} s={cfg.colff_spec.s} cap "
          f"{cfg.colff_spec.bins.cap}, A {cfg.band_spec.block_dtype}, "
          f"factors {cfg.colff_spec.weight_dtype}")
    u, ovf = integrator.mobility(cfg, d["pos"], d["forces"])
    u = u.double().cpu().numpy()
    rel = float(np.linalg.norm(u - d["u_ref"]) / np.linalg.norm(d["u_ref"]))
    ph.check("mobility vs f64 oracle (relative 2-norm)", rel, 5e-3)
    if int(ovf) or not np.isfinite(u).all():
        ph.failed.append("oracle mobility overflowed or is not finite")


def _check_matvec_kernel(ph, label, blocks, spec, bins, self_mobility):
    """matvec_cells (csrc/blocked.cu) against matvec_cells_reference on the
    same CUDA tensors: max |diff| / max |plain| <= 2e-6 (sums in another
    order), one launch a call, a rerun bitwise."""
    import torch

    from pse_tpu_torch import trace
    from pse_tpu_torch.ops import blocked_nearfield as bnf

    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    f = torch.randn((3,) + tuple(bins.mask.shape), generator=g,
                    device="cuda") * bins.mask
    n0 = trace.counters().get("launch.matvec_cells", 0)
    u = bnf.matvec_cells(blocks, spec, bins, f, self_mobility)
    if trace.counters().get("launch.matvec_cells", 0) != n0 + 1:
        ph.failed.append(f"{label}: matvec_cells not one launch")
    want = bnf.matvec_cells_reference(blocks, spec, bins, f, self_mobility)
    ph.check(f"{label}: matvec_cells kernel vs plain (max rel)",
             rel_max(u, want)[0], 2e-6)
    _check_rerun(ph, f"{label} matvec_cells", u, lambda: bnf.matvec_cells(
        blocks, spec, bins, f, self_mobility))


def phase_blocked_small(ph):
    """The blocked engine on the card vs on the CPU at N=1080, L=24: the
    matvec kernel against its plain version on the card's blocks, then the
    thermal step without and with forces, the athermal step and mobility(),
    same uniforms."""
    import dataclasses

    import torch

    from pse_tpu_torch import integrator, make_box, make_params
    from pse_tpu_torch.cellbins import bin_particles
    from pse_tpu_torch.ops import blocked_nearfield as bnf

    print("[blocked-small] the blocked engine on the card vs the CPU plain "
          "path (N=1080, L=24)")
    rng = np.random.default_rng(14)
    n, L = 1080, 24.0
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    forces = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    for error in (1e-3, 1e-4):
        cfg = integrator.make_config(make_params(xi=XI, error=error, L=L), n,
                                     device="cuda")
        spec, p = cfg.nf_spec, cfg.params
        for tilt in (0.0, 0.3):
            box = make_box(L, tilt)
            bins = bin_particles(torch.as_tensor(pos, device="cuda"), box,
                                 spec.bins)
            blocks = bnf.build_pair_blocks(bins, box, spec, cfg.cheb,
                                           p.ewald_cut, p.ewald_dr)
            _check_matvec_kernel(ph, f"{spec.block_dtype} blocks tilt={tilt}",
                                 blocks, spec, bins, p.self_mobility)
    for error, bound, far in ((1e-3, 5e-3, "column"), (1e-4, 1e-4, "column"),
                              (1e-3, 5e-3, "stored")):
        params = make_params(xi=XI, error=error, L=L)
        # at 1e-4 ask for banded: the geometry is too small to band there
        engine = "banded" if error < 1e-3 else "blocked"
        for thermal, has_forces in ((True, False), (True, True),
                                    (False, True)):
            cpu, gpu = (integrator.make_config(
                params, n, engine=engine, thermal=thermal,
                has_forces=has_forces, seed=3, device=dev) for dev in
                ("cpu", "cuda"))
            if far == "stored":
                cpu, gpu = (dataclasses.replace(c, colff_spec=None)
                            for c in (cpu, gpu))
            if gpu.engine != "blocked":
                ph.failed.append(f"error={error:g} engine={engine}: got "
                                 f"{gpu.engine}, expected blocked")
                continue
            draws = _raw_uniforms(cpu, 6) if thermal else None
            f_c = forces if has_forces else None
            f_g = forces.cuda() if has_forces else None
            kind = ("athermal" if not thermal else
                    "thermal+forces" if has_forces else "brownian")
            label = (f"blocked {kind} error={error:g} {far} far field, "
                     f"{gpu.nf_spec.block_dtype} blocks")
            for tilt, rate in ((0.0, 0.0), (0.3, 0.5)):
                s_c, i_c = integrator.step(
                    cpu, integrator.make_state(pos, 3, tilt, "cpu"), f_c,
                    1.0 if thermal else 0.0, DT, rate, None, uniforms=draws)
                s_g, i_g = integrator.step(
                    gpu, integrator.make_state(pos, 3, tilt, "cuda"), f_g,
                    1.0 if thermal else 0.0, DT, rate, None, uniforms=draws)
                r, _ = rel_max(i_g["velocities"].cpu(), i_c["velocities"])
                ph.check(f"{label} step tilt={tilt} m={i_g['m_lanczos']}/"
                         f"{i_c['m_lanczos']}", r, bound)
                if i_g["m_lanczos"] != i_c["m_lanczos"]:
                    ph.failed.append(f"{label} tilt={tilt}: m differs")
                if int(s_g.nbr_overflow) or not torch.isfinite(s_g.pos).all():
                    ph.failed.append(f"{label} tilt={tilt} overflow")
                if kind != "athermal":
                    continue
                u_c, _ = integrator.mobility(cpu, pos, forces, tilt)
                u_g, o_g = integrator.mobility(gpu, pos, forces.cuda(), tilt)
                r, _ = rel_max(u_g.cpu(), u_c)
                ph.check(f"blocked mobility error={error:g} {far} far field "
                         f"tilt={tilt}", r, bound)
                if int(o_g):
                    ph.failed.append(f"{label} mobility tilt={tilt} overflow")


def phase_blocked_oracle(ph):
    """mobility() on the blocked engine against the float64 oracle."""
    from pse_tpu_torch import integrator, make_params

    d = np.load(ORACLE)
    n = int(d["n"])
    params = make_params(xi=float(d["xi"]), error=ERROR, L=float(d["L"]))
    cfg = integrator.make_config(params, n, thermal=False, engine="blocked",
                                 device="cuda")
    print(f"[blocked-oracle] blocked mobility() at oracle_gate.npz: N={n}, "
          f"cells {cfg.nf_spec.bins.n_cells} cap {cfg.nf_spec.bins.cap} "
          f"{cfg.nf_spec.block_dtype} blocks, far-field factors "
          f"{cfg.colff_spec.weight_dtype}")
    u, ovf = integrator.mobility(cfg, d["pos"], d["forces"])
    u = u.double().cpu().numpy()
    rel = float(np.linalg.norm(u - d["u_ref"]) / np.linalg.norm(d["u_ref"]))
    ph.check("blocked mobility vs f64 oracle (relative 2-norm)", rel, 5e-3)
    if int(ovf) or not np.isfinite(u).all():
        ph.failed.append("blocked oracle mobility overflowed or not finite")


def phase_gather_small(ph):
    """The gather engine on the card vs on the CPU, float32 throughout, on
    three boxes: the fallback box (L = 10 at phi = 0.45, Simulation's
    default engine, all-pairs), the oracle gate's box with
    engine="gather" (a 3 x 5 x 5 cell list) and the same box with
    nlist_type="stencil"; tilts 0 and 0.3."""
    import dataclasses

    import torch

    import pse_tpu_torch as pse
    from pse_tpu_torch import integrator, make_params
    from pse_tpu_torch import neighbors as nb
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.ops import farfield as ff

    print("[gather-small] the gather engine on the card vs the CPU plain "
          "path (float32)")
    d = np.load(ORACLE)
    rng = np.random.default_rng(15)
    L_f = 10.0
    n_f = int(round(PHI * L_f ** 3 / (4.0 / 3.0 * math.pi)))
    pos_f = rng.uniform(-L_f / 2, L_f / 2, (n_f, 3)).astype(np.float32)
    method = dict(T=1.0, seed=3, xi=XI, error=ERROR)
    sim = pse.Simulation(positions=pos_f, L=L_f, dt=DT, device="cuda")
    sim.set_integrator(pse.PSEv1(**method), verbose=False)
    cases = [("fallback box, default engine", sim.config, pos_f)]
    params = make_params(xi=XI, error=ERROR, L=float(d["L"]))
    cases.append(("oracle box, engine=gather", integrator.make_config(
        params, int(d["n"]), seed=3, engine="gather", device="cuda"),
        d["pos"]))
    sim = pse.Simulation(positions=d["pos"], L=float(d["L"]), dt=DT,
                         device="cuda")
    sim.set_integrator(pse.PSEv1(nlist_type="stencil", **method),
                       engine="gather", verbose=False)
    cases.append(("oracle box, stencil", sim.config, d["pos"]))
    for label, base, pos in cases:
        if base.engine != "gather":
            ph.failed.append(f"gather-small {label}: engine {base.engine}")
            continue
        n, p, spec = pos.shape[0], base.params, base.nbr_spec
        print(f"  {label}: N={n} L={p.L[0]:.4f} cells {spec.n_cells} "
              f"subdiv {spec.subdiv} cap {spec.cell_capacity} "
              f"max_neighbors {spec.max_neighbors}")
        pos_g = torch.as_tensor(pos, device="cuda")
        f_c = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
        f_g = f_c.cuda()
        draws = (rng.uniform(-math.sqrt(3), math.sqrt(3), (3, n)
                             ).astype(np.float32),
                 rng.uniform(-math.sqrt(1.5), math.sqrt(1.5),
                             (6, p.Nx, p.Ny, p.Nz // 2 + 1)
                             ).astype(np.float32))
        for tilt in (0.0, 0.3):
            box = make_box(p.L, tilt)
            lg = nb.build_neighbor_list(pos_g, box, spec)
            lc = nb.build_neighbor_list(torch.as_tensor(pos), box, spec)
            ph.check(f"{label} tilt={tilt} neighbor idx (mismatched "
                     "elements)", _mismatches(lg.idx.cpu(), lc.idx), 0)
            if bool(lg.overflow) or bool(lc.overflow):
                ph.failed.append(f"{label} tilt={tilt}: neighbor overflow")
            taps = ff.compute_taps(pos_g, box, p)
            _check_rerun(ph, f"{label} tilt={tilt} tap spread",
                         ff.spread(taps, f_g, p),
                         lambda: ff.spread(taps, f_g, p))
            for thermal, has_forces in ((True, False), (True, True),
                                        (False, True)):
                gpu = dataclasses.replace(base, thermal=thermal,
                                          has_forces=has_forces)
                cpu = dataclasses.replace(gpu, device="cpu")
                kind = ("athermal" if not thermal else
                        "thermal+forces" if has_forces else "brownian")

                def run(cfg, dev, f):
                    return integrator.step(
                        cfg, integrator.make_state(pos, 3, tilt, dev),
                        f if has_forces else None, 1.0 if thermal else 0.0,
                        DT, 0.5 * tilt, None,
                        uniforms=draws if thermal else None)
                s_c, i_c = run(cpu, "cpu", f_c)
                s_g, i_g = run(gpu, "cuda", f_g)
                r, _ = rel_max(i_g["velocities"].cpu(), i_c["velocities"])
                ph.check(f"{label} {kind} step tilt={tilt} "
                         f"m={i_g['m_lanczos']}/{i_c['m_lanczos']}", r, 1e-4)
                if i_g["m_lanczos"] != i_c["m_lanczos"]:
                    ph.failed.append(f"{label} {kind} tilt={tilt}: m differs")
                if int(s_g.nbr_overflow) or not torch.isfinite(s_g.pos).all():
                    ph.failed.append(f"{label} {kind} tilt={tilt} overflow")
                _check_rerun(ph, f"{label} {kind} step tilt={tilt}",
                             i_g["velocities"],
                             lambda: run(gpu, "cuda", f_g)[1]["velocities"])
                if thermal:
                    continue
                u_c, _ = integrator.mobility(cpu, pos, f_c, tilt)
                u_g, o_g = integrator.mobility(gpu, pos, f_g, tilt)
                ph.check(f"{label} mobility tilt={tilt}",
                         rel_max(u_g.cpu(), u_c)[0], 1e-4)
                if int(o_g):
                    ph.failed.append(f"{label} mobility tilt={tilt} overflow")


def phase_gather_oracle(ph):
    """mobility() with engine="gather" against the float64 oracle."""
    from pse_tpu_torch import integrator, make_params

    d = np.load(ORACLE)
    n = int(d["n"])
    params = make_params(xi=float(d["xi"]), error=ERROR, L=float(d["L"]))
    cfg = integrator.make_config(params, n, thermal=False, engine="gather",
                                 device="cuda")
    print(f"[gather-oracle] gather mobility() at oracle_gate.npz: N={n}, "
          f"neighbor cells {cfg.nbr_spec.n_cells} cap "
          f"{cfg.nbr_spec.cell_capacity} max_neighbors "
          f"{cfg.nbr_spec.max_neighbors}, grid {params.Nx}^3 P = "
          f"{params.gauss_P}")
    u, ovf = integrator.mobility(cfg, d["pos"], d["forces"])
    u = u.double().cpu().numpy()
    rel = float(np.linalg.norm(u - d["u_ref"]) / np.linalg.norm(d["u_ref"]))
    ph.check("gather mobility vs f64 oracle (relative 2-norm)", rel, 5e-3)
    if int(ovf) or not np.isfinite(u).all():
        ph.failed.append("gather oracle mobility overflowed or not finite")


def phase_gather_timing(simg, results):
    """The gather step's parts at N = 100k (tilt 0.3) by CUDA events, each
    beside the bytes it must move (its inputs read once, its outputs
    written once) over 3.35 TB/s."""
    import torch

    from pse_tpu_torch import cellbins as cb
    from pse_tpu_torch import neighbors as nb
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.cellbins import BinSpec, bin_particles
    from pse_tpu_torch.ops import farfield as ff
    from pse_tpu_torch.ops import nearfield as nf
    from pse_tpu_torch.params import ewald_table_on

    config, p = simg.config, simg.config.params
    spec = config.nbr_spec
    pos = simg.state.pos
    box = make_box(p.L, 0.3)
    n, K = pos.shape[0], spec.max_neighbors
    stencil = (2 * spec.subdiv + 1) ** 3
    print(f"[timing] gather path: cells {spec.n_cells} cap "
          f"{spec.cell_capacity}, {stencil * spec.cell_capacity} candidates "
          f"per particle ({n * stencil * spec.cell_capacity / 1e6:.1f} M), "
          f"max_neighbors {K} ({n * K / 1e6:.2f} M pair slots)")
    nlist = nb.build_neighbor_list(pos, box, spec)
    counts = (nlist.idx < n).sum(dim=1)
    table = ewald_table_on(p, pos.device)
    coeffs = nf.precompute_pair_coeffs(pos, nlist.idx, box, table,
                                       p.ewald_cut, p.ewald_dr, p.ewald_n)
    taps = ff.compute_taps(pos, box, p)
    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    ft = torch.randn((3, n), generator=g, device="cuda")
    grid = torch.randn((3, p.Nx, p.Ny, p.Nz), generator=g, device="cuda")
    f = ft.t().contiguous()
    P3, G = p.gauss_P ** 3, p.n_grid_total
    width = taps.node_taps.shape[1]
    item = coeffs.nbr.element_size()
    # bytes each must move: inputs read once, outputs written once
    parts = (
        ("build_neighbor_list",
         lambda: nb.build_neighbor_list(pos, box, spec), 12 * n + 4 * n * K),
        ("precompute_pair_coeffs",
         lambda: nf.precompute_pair_coeffs(pos, nlist.idx, box, table,
                                           p.ewald_cut, p.ewald_dr,
                                           p.ewald_n),
         12 * n + 4 * n * K + 16 * (p.ewald_n + 1) + (5 * 4 + item) * n * K),
        ("mreal_matvec_t",
         lambda: nf.mreal_matvec_t(coeffs, ft, p.self_mobility),
         (5 * 4 + item) * n * K + 2 * 12 * n),
        ("compute_taps", lambda: ff.compute_taps(pos, box, p),
         12 * n + (8 + 4) * P3 * n + 8 * G * width),
        ("spread", lambda: ff.spread(taps, f, p),
         12 * n + 4 * P3 * n + 8 * G * width + 12 * G),
        ("contract", lambda: ff.contract(taps, grid, p),
         12 * G + (8 + 4) * P3 * n + 12 * n),
    )
    out = {}
    for name, fn, nbytes in parts:
        ms = cuda_ms(fn, 3)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        out[name] = {"ms": ms, "bytes": nbytes, "bound_ms": bound}
        print(f"  {name}: {ms:.4f} ms (CUDA events), must move "
              f"{nbytes / 1e9:.4f} GB: bound {bound:.4f} ms by bytes, "
              f"{100 * bound / ms:.2f} % of it")
    print(f"  neighbors per particle: max {int(counts.max())}, mean "
          f"{float(counts.float().mean()):.2f} of {K}; taps per grid node: "
          f"at most {width} (the spread table's width)")
    # the neighbor build's parts on this build's own data: the cell binning
    # (the fill kernel's path), then the candidates with their distance
    # mask and the compaction, each timed on the build's first row chunk
    # and scaled to N rows; the rest (joining the chunks) by difference
    _, per_row, block = nb._candidates(pos, box, spec)
    r0, r1 = nb._row_chunks(n, per_row)[0]
    cand, mask = block(r0, r1)
    scale = n / (r1 - r0)
    bspec = BinSpec(tuple(spec.n_cells), spec.cell_capacity)
    split = {
        "bin_particles": cuda_ms(lambda: bin_particles(pos, box, bspec), 5),
        "candidates_and_filter": cuda_ms(lambda: block(r0, r1), 3) * scale,
        "compact_rows": cuda_ms(lambda: nb._compact_rows(cand, mask, n, K), 3)
        * scale}
    del cand, mask
    split["rest"] = out["build_neighbor_list"]["ms"] - sum(split.values())
    out["build_neighbor_list"]["parts_ms"] = split
    print(f"  the neighbor build's parts (the middle two timed on its first "
          f"chunk, {r1 - r0} of {n} rows, scaled to N): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in split.items())
          + " (the last by difference)")
    # the fill at this path's shape, without values: each particle's key,
    # order entry and coordinates read and rank written, five 4-byte planes
    # per slot, starts and counts per cell, the flag
    ops = cb.fill_operands(pos, box, bspec, False)
    C, cap = bspec.n_cells_total, bspec.cap
    fl = results["fill_cells"]
    fl.update(
        gather_ms=cuda_ms(lambda: cb.fill_cells(*ops, C, cap), 50),
        gather_plain_ms=cuda_ms(
            lambda: cb.fill_cells_reference(*ops, C, cap), 20),
        gather_kernel_ms=graph_ms(lambda: cb.fill_cells(*ops, C, cap), 20),
        gather_bound_ms=1e3 * (28 * n + 20 * C * cap + 8 * C + 1)
        / HBM_BYTES_PER_S)
    print(f"  fill (neighbor cells, no values): wrapper "
          f"{fl['gather_ms']:.4f} ms (CUDA events), kernel alone "
          f"{fl['gather_kernel_ms']:.4f} ms (CUDA-graph replay), bound "
          f"{fl['gather_bound_ms']:.4f} ms by bytes, plain "
          f"{fl['gather_plain_ms']:.4f} ms")
    out["host_syncs"] = _sync_idle(simg)
    results["gather"] = out
    torch.cuda.empty_cache()


def _sync_idle(sim, steps=3):
    """The device idle that follows the host's reads of device values in a
    step (torch.profiler, on the host's clock): for each device-to-host
    copy, the gap from its end to the start of the next device activity,
    summed per step, in all and for the copy inside compute_taps (the tap
    table's width).  A lower bound of what each read costs: the host may
    stay behind for a few launches more.  Reports only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from pse_tpu_torch.ops import farfield as ff

    taps_fn = ff.compute_taps

    def traced(*a, **k):
        with record_function("compute_taps"):
            return taps_fn(*a, **k)
    ff.compute_taps = traced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.run(steps)
            torch.cuda.synchronize()
        events = list(prof.events())
        dev = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in events if e.device_type == DeviceType.CUDA)
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == "compute_taps"
                 and e.device_type == DeviceType.CPU]
    except (RuntimeError, AttributeError) as e:   # tracing unavailable
        print(f"  host-sync idle not measured: {e}")
        return None
    finally:
        ff.compute_taps = taps_fn
    gaps = []                       # (copy start, idle after the copy)
    for i, (t0, t1, name) in enumerate(dev):
        if "DtoH" in name and i + 1 < len(dev):
            gaps.append((t0, max(0.0, dev[i + 1][0] - t1)))
    taps = [g for t0, g in gaps if any(a <= t0 <= b for a, b in spans)]
    r = {"copies_per_step": len(gaps) / steps,
         "idle_ms_per_step": sum(g for _, g in gaps) / steps / 1e3,
         "tap_width_copies_per_step": len(taps) / steps,
         "tap_width_idle_ms_per_step": sum(taps) / steps / 1e3}
    print(f"  host reads of device values (torch.profiler, {steps} steps): "
          f"{r['copies_per_step']:.1f} device-to-host copies per step, "
          f"{r['idle_ms_per_step']:.4f} ms/step of device idle right after "
          f"them; the tap-width read {r['tap_width_copies_per_step']:.1f} "
          f"per step, {r['tap_width_idle_ms_per_step']:.4f} ms/step")
    return r


def _step_wrappers(forces: bool, engine: str = "banded"):
    """The kernel wrappers a main-path step launches, by their launch
    counters (on the blocked engine: the fills, the pair-block build and
    matvec, the contract and, with forces, the spread; on the gather
    engine: the fill of the neighbor list's cell binning)."""
    if engine == "gather":
        return {"fill_cells": "launch.fill_cells"}
    w = {"fill_cells": "launch.fill_cells",
         "contract_col": "launch.contract_col_kernel"}
    if engine == "blocked":
        w.update(build_pair_blocks="launch.build_pair_blocks",
                 matvec_cells="launch.matvec_cells")
    if engine == "banded":
        w.update(build_mv_banded="launch.build_mv_banded",
                 matvec_banded="launch.matvec_banded")
    if forces:
        w["spread_col"] = "launch.spread_moments_kernel"
    return w


def _all_wrappers():
    return {**_step_wrappers(True),
            **_step_wrappers(True, "blocked"),
            "build_banded_blocks": "launch.build_banded_blocks"}


def _counted(ph, label, expected, fn):
    """Run fn() and count every kernel's launches in it (the counters of
    ``pse_tpu_torch.trace`` read just before and just after); each kernel
    named in ``expected`` must have launched."""
    import torch

    from pse_tpu_torch import trace

    wrappers = _all_wrappers()
    torch.cuda.synchronize()
    before = trace.counters()
    out = fn()
    torch.cuda.synchronize()
    after = trace.counters()
    launches = {k: after.get(c, 0) - before.get(c, 0)
                for k, c in wrappers.items()}
    print(f"  launches in the {label} run: {launches}")
    for k in expected:
        if launches[k] <= 0:
            ph.failed.append(f"{k} never launched on the {label} path")
    return out, launches


def _band_bytes(bs):
    """Bytes of A under ``bs``: per class, or (1, C, 2, S, 5W) without."""
    import torch

    item = torch.empty((), dtype=getattr(torch, bs.block_dtype)).element_size()
    classes = bs.classes or ((bs.bins.cap // bs.rows, bs.bins.n_cells_total),)
    return sum(c * 2 * t * bs.rows * 5 * bs.window * item for t, c in classes)


def _step_peak(sim):
    """Device memory one more step of ``sim`` allocates above what is live
    before it (torch.cuda.max_memory_allocated - memory_allocated)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sim.run(1)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _ab_classes(sim, pairs=4, steps=10):
    """ms/step of ``steps``-step runs of ``sim`` with its classes and with
    one class, alternated in ``pairs`` pairs (the first side alternating
    too), in one process state; returns {side: [ms/step, ...]}."""
    import dataclasses

    import torch

    cfg = sim.config
    sides = {"classes": cfg, "one class": dataclasses.replace(
        cfg, band_spec=cfg.band_spec._replace(classes=None,
                                              slab_classes=None))}
    out = {k: [] for k in sides}
    for i in range(pairs):
        for name in (("classes", "one class") if i % 2 == 0
                     else ("one class", "classes")):
            sim.config = sides[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run(steps)
            torch.cuda.synchronize()
            out[name].append(1e3 * (time.perf_counter() - t0) / steps)
    sim.config = cfg
    return out


def _single_class(sim):
    """Drop the occupancy classes of sim's banded config (one class)."""
    import dataclasses

    sim.config = dataclasses.replace(sim.config, band_spec=(
        sim.config.band_spec._replace(classes=None, slab_classes=None)))


def phase_main(ph, forces: bool, engine: str = "banded",
               classes: bool = False):
    """A main path through the user entry points; returns the run data.
    ``engine``: "banded", "blocked" (set_integrator without an engine,
    i.e. the default, blocked engine, asserted) or "gather", the last two
    with fewer steps (their near fields are plain PyTorch).  On banded,
    ``classes=False`` runs one occupancy class (set_integrator's classes
    dropped), ``classes=True`` follows bench.py: RELAX_STEPS on one class,
    then the classes sized from the relaxed histogram for the warm-up and
    the timed steps."""
    import dataclasses

    import torch

    import pse_tpu_torch as pse
    from pse_tpu_torch.ops import banded_nearfield as bdn

    pos, L = make_positions(N, PHI, seed=0)
    label = ("main" if engine == "banded" else engine) + (
        "-classes" if classes else "") + ("-forces" if forces else "")
    warm, timed = {"banded": (WARM_STEPS, TIMED_STEPS),
                   "blocked": (BLOCKED_WARM, BLOCKED_TIMED),
                   "gather": (GATHER_WARM, GATHER_TIMED)}[engine]
    force_fn = None
    if forces:
        # bench.py's with-forces workload: one fixed random force array
        F = torch.as_tensor(np.random.default_rng(1).normal(size=(N, 3))
                            .astype(np.float32), device="cuda")

        def force_fn(pos, t):
            return F
    print(f"[{label}] Simulation N={N} phi={PHI} L={L:.4f} xi={XI} "
          f"error={ERROR} engine="
          f"{'default' if engine == 'blocked' else engine} "
          f"force_fn={'fixed random' if forces else None}")
    sim = pse.Simulation(positions=pos, L=L, dt=DT, sync_every=10,
                         force_fn=force_fn, device="cuda")
    method = pse.integrate.PSEv1(T=1.0, seed=SEED, xi=XI, error=ERROR)
    if engine == "blocked":
        sim.set_integrator(method, verbose=False)
    else:
        sim.set_integrator(method, engine=engine, verbose=False)
    if sim.config.engine != engine:
        ph.failed.append(f"{label}: the engine is {sim.config.engine}, "
                         f"expected {engine}")
    if engine == "banded":
        print(f"  set_integrator's classes (lattice histogram): "
              f"{sim.config.band_spec.classes}")
        _single_class(sim)
    if classes:
        t0 = time.perf_counter()
        sim.run(RELAX_STEPS)
        bs = sim.config.band_spec
        counts = bdn.measure_col_counts(bs, sim.state.pos.cpu().numpy(),
                                        sim.config.params.L,
                                        tilt=sim.state.tilt_xy)
        sim.config = dataclasses.replace(sim.config, band_spec=(
            bdn.make_band_classes(bs, N, counts)))
        print(f"  relaxed {RELAX_STEPS} steps on one class in "
              f"{time.perf_counter() - t0:.2f} s (retries "
              f"{sim.metrics['overflow_retries']}); classes from the relaxed "
              f"histogram (std {counts.std():.1f}): "
              f"{sim.config.band_spec.classes}")
        if sim.config.band_spec.classes is None:
            ph.failed.append(f"{label}: no classes from the relaxed state")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.run(warm)
    torch.cuda.synchronize()
    print(f"  warm-up {warm} steps: {time.perf_counter() - t0:.2f} s, "
          f"overflow retries {sim.metrics['overflow_retries']}")
    retries0 = sim.metrics["overflow_retries"]
    hist0 = dict(sim.metrics["m_lanczos_hist"])
    t0 = time.perf_counter()
    _, launches = _counted(ph, label, _step_wrappers(forces, engine),
                           lambda: sim.run(timed))
    wall = time.perf_counter() - t0
    hist = {m: c - hist0.get(m, 0)
            for m, c in sim.metrics["m_lanczos_hist"].items()
            if c - hist0.get(m, 0)}
    retries = sim.metrics["overflow_retries"] - retries0
    ms_step = 1e3 * wall / timed
    print(f"  {timed} steps: {ms_step:.3f} ms/step, "
          f"{N * timed / wall:.6g} particle-steps/s (host clock, "
          f"includes overflow retries: {retries})")
    print(f"  m_lanczos histogram {dict(sorted(hist.items()))}; overflow "
          f"retries total {sim.metrics['overflow_retries']}")
    snap = sim.snapshot()
    if snap["pos"].shape != (N, 3) or not np.isfinite(snap["pos"]).all():
        ph.failed.append(f"{label} positions not finite (N, 3)")
    if int(sim.state.nbr_overflow):
        ph.failed.append(f"{label} ended with an overflow")
    cfg = sim.config
    peak = (f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
            " GB (torch.cuda.max_memory_allocated)")
    unused = () if engine == "blocked" else ("build_pair_blocks",
                                             "matvec_cells")
    if engine != "banded":
        unused += ("build_mv_banded", "matvec_banded", "build_banded_blocks")
    if engine == "gather":
        unused += ("contract_col", "spread_col")
    for k in unused:
        if launches[k]:
            ph.failed.append(f"{k} launched on the {label} path")
    if engine == "blocked":
        # the matvec kernel 1 + m times a step with forces (build_mv, M F,
        # m - 1 Lanczos iterations), m without
        want_mv = sum((m + forces) * c for m, c in hist.items())
        if retries == 0 and launches["matvec_cells"] != want_mv:
            ph.failed.append(f"{label}: matvec_cells launched "
                             f"{launches['matvec_cells']} times (expected "
                             f"{want_mv})")
        print(f"  per step: matvec_cells {launches['matvec_cells'] / timed:g}"
              f" ({'1 + m' if forces else 'm'} = {want_mv / timed:g})")
        nf = cfg.nf_spec
        C, cap = nf.bins.n_cells_total, nf.bins.cap
        item = torch.empty((), dtype=getattr(torch, nf.block_dtype)
                           ).element_size()
        print(f"  final config: near-field cells {nf.bins.n_cells} cap {cap}, "
              f"{len(nf.offsets)} offsets, pair blocks "
              f"{len(nf.offsets) * 6 * C * cap * cap * item / 1e9:.3f} GB "
              f"{nf.block_dtype}; far-field cap {cfg.colff_spec.bins.cap} "
              f"{cfg.colff_spec.weight_dtype}; m_max {cfg.m_max}; {peak}")
    elif engine == "gather":
        ns, p = cfg.nbr_spec, cfg.params
        print(f"  final config: neighbor cells {ns.n_cells} cap "
              f"{ns.cell_capacity} subdiv {ns.subdiv}, max_neighbors "
              f"{ns.max_neighbors}; grid {p.Nx}x{p.Ny}x{p.Nz}, P = "
              f"{p.gauss_P}; m_max {cfg.m_max}; {peak}")
    else:
        bs = cfg.band_spec
        one = _band_bytes(bs._replace(classes=None))
        print(f"  final config: band cap {bs.bins.cap} W {bs.window} R "
              f"{bs.rows} {bs.block_dtype}, classes {bs.classes}: A "
              f"{_band_bytes(bs) / 1e6:.1f} MB ({100 * _band_bytes(bs) / one:.1f}"
              f" % of the single class's {one / 1e6:.1f} MB); far-field cap "
              f"{cfg.colff_spec.bins.cap} {cfg.colff_spec.weight_dtype}; "
              f"m_max {cfg.m_max}; class re-measures {sim._class_regrows}; "
              f"{peak}")
        # the step's own peak, and with classes the same step on one class
        peaks = {"classes" if bs.classes else "one class": _step_peak(sim)}
        if bs.classes:
            sim.config = dataclasses.replace(cfg, band_spec=bs._replace(
                classes=None, slab_classes=None))
            peaks["one class"] = _step_peak(sim)
            sim.config = cfg
        print("  one more step's device memory above the live baseline: "
              + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in peaks.items()))
        if bs.classes:
            ab = _ab_classes(sim)
            print("  alternated 10-step runs, ms/step (host clock): " + "; ".join(
                f"{k} {' / '.join(f'{x:.3f}' for x in v)} (median "
                f"{float(np.median(v)):.3f})" for k, v in ab.items())
                + f"; retries {sim.metrics['overflow_retries'] - retries0}")
        # build_mv once per step, the matvec m - 1 times (Lanczos)
        want_mv = sum((m - 1) * c for m, c in hist.items())
        if retries == 0 and (launches["build_mv_banded"] != timed
                             or launches["matvec_banded"] != want_mv):
            ph.failed.append(
                f"{label}: launches build_mv {launches['build_mv_banded']} "
                f"(expected {timed}), matvec {launches['matvec_banded']} "
                f"(expected {want_mv})")
        print(f"  per step: build_mv {launches['build_mv_banded'] / timed:g}, "
              f"matvec {launches['matvec_banded'] / timed:g} (m - 1 = "
              f"{want_mv / timed:g})")
    return sim, launches, ms_step


def phase_mobility(ph, sim, label="main-mobility"):
    """Simulation.mobility_matvec at a main path's state: finite, and
    the fixed forces' U = M F is the near field plus the far field."""
    import torch

    print(f"[{label}] Simulation.mobility_matvec at the "
          f"{sim.config.engine} path's state")
    F = sim.force_fn(sim.state.pos, sim.state.step)
    expected = ["fill_cells", "contract_col", "spread_col"]
    if sim.config.engine == "banded":
        expected.append("build_mv_banded")
    else:
        expected.append("matvec_cells")
    u, launches = _counted(ph, label, expected,
                           lambda: sim.mobility_matvec(F))
    if sim.config.engine == "banded" and launches["matvec_cells"]:
        ph.failed.append(f"{label}: matvec_cells launched on banded")
    if u.shape != (N, 3) or not bool(torch.isfinite(u).all()):
        ph.failed.append(f"{label}: mobility_matvec not finite (N, 3)")
    # U.F = F.M.F > 0 for the SPD mobility
    print(f"  |U| max {float(u.abs().max()):.4f}, F.U/N {float((u * F).sum()) / N:.6f}")
    if not float((u * F).sum()) > 0:
        ph.failed.append(f"{label}: F.M.F is not positive")
    return launches


def phase_classes_mobility(ph, simc):
    """Simulation.mobility_matvec at the relaxed [main-classes-forces]
    state with its classes against the same call with one class."""
    import dataclasses

    import torch

    print("[main-classes-mobility] mobility_matvec with the classes "
          f"{simc.config.band_spec.classes} vs one class")
    F = simc.force_fn(simc.state.pos, simc.state.step)
    cfg = simc.config
    try:
        u_c, _ = _counted(ph, "main-classes-mobility",
                          ("fill_cells", "build_mv_banded"),
                          lambda: simc.mobility_matvec(F))
        simc.config = dataclasses.replace(cfg, band_spec=(
            cfg.band_spec._replace(classes=None, slab_classes=None)))
        u_1 = simc.mobility_matvec(F)
    except RuntimeError as e:
        ph.failed.append(f"main-classes-mobility: {e}")
        return
    finally:
        simc.config = cfg
    bad = int((u_c != u_1).sum())
    r, _ = rel_max(u_c, u_1)
    print(f"  mismatched elements {bad} of {u_c.numel()}")
    ph.check("mobility with classes vs one class (max rel)", r, 1e-6)
    if not bool(torch.isfinite(u_c).all()):
        ph.failed.append("main-classes-mobility: not finite")


def phase_classes_run(ph):
    """The Simulation path with classes from the start: set_integrator on
    the N = 100k lattice sizes them from its histogram, and the lattice
    melts past them; run() rewinds, re-measures (at most twice) and
    finishes."""
    import torch

    import pse_tpu_torch as pse

    pos, L = make_positions(N, PHI, seed=0)
    print(f"[classes-run] Simulation N={N} on engine=banded with the "
          f"lattice's classes, {CLASS_RUN_STEPS} steps (sync_every 25)")
    sim = pse.Simulation(positions=pos, L=L, dt=DT, sync_every=25,
                         device="cuda")
    sim.set_integrator(pse.integrate.PSEv1(T=1.0, seed=SEED, xi=XI,
                                           error=ERROR),
                       engine="banded", verbose=False)
    first = sim.config.band_spec.classes
    t0 = time.perf_counter()
    sim.run(CLASS_RUN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bs = sim.config.band_spec
    print(f"  classes at set_integrator {first}; after the run {bs.classes}; "
          f"overflow retries {sim.metrics['overflow_retries']}, class "
          f"re-measures {sim._class_regrows}; {wall:.2f} s; "
          f"{sim.metrics_summary()}")
    snap = sim.snapshot()
    if (first is None or sim._class_regrows > 2
            or snap["step"] != CLASS_RUN_STEPS
            or not np.isfinite(snap["pos"]).all()):
        ph.failed.append("classes-run: no classes at the start, more than 2 "
                         "re-measures, not finished, or not finite")
    return {"first": first, "final": bs.classes,
            "retries": sim.metrics["overflow_retries"],
            "remeasures": sim._class_regrows}


def phase_sedimentation(ph):
    """The port's twin of examples/sedimentation.py on the card, cut to 20
    steps: N=10k, L=64, athermal, on the default engine."""
    import torch

    from pse_tpu_torch.examples import sedimentation

    print("[sedimentation] pse_tpu_torch/examples/sedimentation.py on the "
          "card, 20 steps")
    t0 = time.perf_counter()
    (sim, u), launches = _counted(
        ph, "sedimentation", ("fill_cells", "contract_col", "spread_col",
                              "matvec_cells"),
        lambda: sedimentation.main("cuda", 20))
    print(f"  {time.perf_counter() - t0:.2f} s, engine {sim.config.engine}, "
          f"{sim.metrics_summary()}")
    pos = sim.snapshot()["pos"]
    if (sim.config.engine != "blocked" or sim.snapshot()["step"] != 20
            or not np.isfinite(pos).all() or not np.isfinite(u).all()
            or not u[:, 2].mean() < 0):
        ph.failed.append("sedimentation: not blocked, not 20 steps, not "
                         "finite, or not settling")
    del sim
    torch.cuda.empty_cache()


def phase_blocks(ph, sim):
    """The standalone build entry point at the main path's state."""
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.cellbins import bin_columns
    from pse_tpu_torch.ops import banded_nearfield as bdn

    config, p = sim.config, sim.config.params
    bs = config.band_spec
    print("[main-blocks] build_banded_blocks at the main path's state")
    inputs = []
    for tilt in (0.0, 0.3):
        box = make_box(p.L, tilt)
        bins = bin_columns(sim.state.pos, box, bs.bins)
        j0, nv, _, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
        inputs.append((bins, tilt, bs, config.cheb, p.L, p.ewald_cut,
                       p.ewald_dr, j0, nv, zsh))
    blocks, launches = _counted(
        ph, "main-blocks", ("build_banded_blocks",),
        lambda: [bdn.build_banded_blocks(*a) for a in inputs])
    for A in blocks:
        if not bool(A.float().isfinite().all()):
            ph.failed.append("build_banded_blocks: A not finite")
    return launches


def phase_profile(run, ms_step, label, steps=3):
    """Where a main path's step time goes: torch.profiler over ``run(steps)``
    (a few more steps after the launch counts were read), device time by
    kernel, and
    the device's busy share of the unprofiled ms/step.  Reports only: a
    profiler that cannot trace the card here fails no phase."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"[profile] torch.profiler over {steps} {label} steps")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(steps)
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            if ev.device_type == DeviceType.CUDA and dev_us > 0:
                rows.append((dev_us / steps / 1e3, ev.count / steps, ev.key))
    except RuntimeError as e:                 # tracing unavailable
        print(f"  profiler unavailable: {e}")
        return None
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    copies = sum(r[1] for r in rows if r[2].startswith(("Memcpy", "Memset")))
    launches = sum(r[1] for r in rows) - copies
    print(f"  device kernels {busy:.3f} ms/step of {ms_step:.3f} ms/step "
          f"unprofiled wall: busy {100 * busy / ms_step:.1f}%, idle "
          f"{100 * (1 - busy / ms_step):.1f}%; "
          f"{launches:.1f} kernel launches per step "
          f"(and {copies:.1f} copies and memsets)")
    for ms, count, key in rows[:16]:
        print(f"  {ms:8.4f} ms/step  x{count:<6.1f} {key[:88]}")
    return {"device_ms": busy, "idle": 1 - busy / ms_step,
            "launches": launches}


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
    f2 = vec_to_cells(bins, bs.bins,
                      torch.randn(pos.shape, generator=g, device="cuda"))
    return bins, box, j0, nv, zsh, f, f2


def _far_operands(config, pos, tilt, dtype, seed=11):
    """The far field's spec in ``dtype``, the slots' node-space coordinates
    (the spread's operand), binned random forces and the contract's
    factors."""
    import torch

    from pse_tpu_torch import cellbins as cb
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.ops import column_farfield as cff

    p = config.params
    spec = config.colff_spec._replace(weight_dtype=dtype)
    box = make_box(p.L, tilt)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bins, f = cb.bin_particles(
        pos, box, spec.bins,
        values=torch.randn(pos.shape, generator=g, device="cuda"))
    return (spec, cff.spread_nodes(bins, box, p), f,
            cff.build_col_factors(bins, box, spec, p))


def _check_rerun(ph, label, got, fn):
    """A second launch on the same inputs must be bitwise the first."""
    ph.check(f"{label} rerun (mismatched elements)", int((fn() != got).sum()),
             0)


def _check_spread(ph, results, config, pos, tilt, where):
    """The spread kernel (float32 factors of its own, whatever the
    contract's dtype) against its plain version, and a rerun."""
    from pse_tpu_torch.ops import column_farfield as cff

    p = config.params
    spec, nodes, f, _ = _far_operands(config, pos, tilt,
                                      config.colff_spec.weight_dtype)

    def run():
        return cff.spread_moments_kernel(f, spec, p, nodes, tilt)
    got = run()
    r, d = rel_max(got, cff.spread_moments(f, spec, p, nodes, tilt))
    ph.check(f"spread tilt={tilt} {where}", r, 1e-5)
    _check_rerun(ph, f"spread tilt={tilt} {where}", got, run)
    if where == "main":
        results["spread_col"]["err"].append(d)
    return spec, nodes, f


def _spread_bound_bytes(spec, params):
    """The bytes the spread kernel's layout moves at least: the slot forces
    (3 float32) and node-space coordinates and mask (4) read, the window
    moments (C x 9 sx sy x 3 Nz float32) written."""
    C, cap = spec.bins.n_cells_total, spec.bins.cap
    return (C * cap * 7 + C * 9 * spec.s[0] * spec.s[1] * 3 * params.Nz) * 4


def phase_spread_1m(ph, results):
    """The spread kernel at the 1M cells' shapes (BASELINE config 5's
    vacancy lattice): against its plain version at tilts 0 and 0.3 with a
    rerun, then kernel and plain time and its bound at tilt 0."""
    import torch

    from pse_tpu_torch import integrator, make_params
    from pse_tpu_torch.ops import column_farfield as cff

    pos_np, L = make_positions(HALO_1M_N, PHI, seed=0)
    pos = torch.as_tensor(pos_np, device="cuda")
    cfg = integrator.make_config(make_params(xi=XI, error=ERROR, L=L),
                                 HALO_1M_N, thermal=False, engine="banded",
                                 positions=pos_np, device="cuda")
    p = cfg.params
    for tilt in (0.3, 0.0):
        spec, nodes, f = _check_spread(ph, results, cfg, pos, tilt, "1M")
    r = results["spread_col"]
    r.update(
        ms_1m=cuda_ms(lambda: cff.spread_moments_kernel(f, spec, p, nodes,
                                                        0.0), 20),
        plain_ms_1m=cuda_ms(lambda: cff.spread_moments(f, spec, p, nodes,
                                                       0.0), 3),
        bound_ms_1m=1e3 * _spread_bound_bytes(spec, p) / HBM_BYTES_PER_S)
    print(f"[spread-1m] C {spec.bins.n_cells_total} cap {spec.bins.cap} "
          f"grid {p.Nx}x{p.Ny}x{p.Nz}: kernel {r['ms_1m']:.4f} ms, bound "
          f"{r['bound_ms_1m']:.4f} ms (its layout's bytes), plain "
          f"{r['plain_ms_1m']:.4f} ms")
    del pos, f, nodes
    torch.cuda.empty_cache()


def _check_contract(ph, results, config, pos, tilt, where):
    import torch

    from pse_tpu_torch import cellbins as cb
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.ops import column_farfield as cff

    p = config.params
    box = make_box(p.L, tilt)
    ff = cb.bin_particles(pos, box, config.colff_spec.bins)
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    grid = torch.randn((3, p.Nx, p.Ny, p.Nz), generator=g, device="cuda")
    for dtype, bound in (("float32", 1e-5), ("bfloat16", 5e-3)):
        spec = config.colff_spec._replace(weight_dtype=dtype)
        fac = cff.build_col_factors(ff, box, spec, p)

        def run():
            return cff.contract_col_kernel(grid, spec, p, fac)
        got = run()
        r, d = rel_max(got, cff.contract_col(grid, spec, p, fac))
        ph.check(f"contract {dtype} tilt={tilt} {where}", r, bound)
        _check_rerun(ph, f"contract {dtype} tilt={tilt} {where}", got, run)
        if dtype == config.colff_spec.weight_dtype and where == "main":
            results["contract_col"]["err"].append(d)


def _mismatches(a, b):
    """Elements of a that differ from b (all of them, plus one, when the
    shapes or types differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return a.numel() + 1
    return int((a != b).sum())


def _fill_binnings(config):
    """(name, BinSpec, columns) of every binning of the config's engine
    that goes through the fill: the near field's (banded columns or blocked
    cells) and the column far field's, or the gather engine's neighbor
    cells."""
    from pse_tpu_torch.cellbins import BinSpec

    if config.engine == "gather":
        s = config.nbr_spec
        return (("neighbor cells", BinSpec(tuple(s.n_cells),
                                           s.cell_capacity), False),)
    near = (("near", config.band_spec.bins, True) if config.band_spec
            else ("near blocked", config.nf_spec.bins, False))
    return near, ("far", config.colff_spec.bins, False)


def _check_fill(ph, results, config, pos, box, vals, label, overfull):
    """The fill kernel against its plain version on the same sort, every
    output bitwise (slots, value rows, ranks, overflow, starts, counts),
    for each binning of the config's engine (``vals`` None: the fill
    without values, as the gather path calls it)."""
    from pse_tpu_torch import cellbins as cb

    for name, spec, columns in _fill_binnings(config):
        ops = cb.fill_operands(pos, box, spec, columns)
        C, cap = spec.n_cells_total, spec.cap
        got = cb.fill_cells(*ops, C, cap, vals)
        want = cb.fill_cells_reference(*ops, C, cap, vals)
        bad = {k: _mismatches(a, b)
               for k, a, b in zip(cb.Fill._fields, got, want)
               if a is not None or b is not None}
        ph.check(f"fill {name} {label} (mismatched elements over all "
                 f"outputs; overflow {bool(got.overflow)}, largest count "
                 f"{int(got.counts.max())} of cap {cap})", sum(bad.values()),
                 0)
        if bool(got.overflow) != overfull:
            ph.failed.append(f"fill {name} {label}: overflow "
                             f"{bool(got.overflow)}, expected {overfull}")
        if sum(bad.values()):
            print(f"  mismatches by output: {bad}")
        results["fill_cells"]["err"].append(
            0.0 if sum(bad.values()) == 0 else math.inf)


def _check_blocked(ph, results, sim, vals):
    """At the blocked path's shapes: the fill bitwise for its 3-D cells and
    its far-field columns at tilts 0 and 0.3 and overfull, and
    matvec_cells on the card against its CPU run on the same blocks."""
    import torch

    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.cellbins import bin_particles
    from pse_tpu_torch.ops import blocked_nearfield as bnf

    config, p = sim.config, sim.config.params
    pos = sim.state.pos
    lump = pos.clone()
    lump[:2000] = 0.5                   # one overfull cell
    for tilt, where, at in ((0.0, "blocked", pos), (0.3, "blocked", pos),
                            (0.3, "blocked overfull", lump)):
        _check_fill(ph, results, config, at, make_box(p.L, tilt), vals,
                    f"tilt={tilt} {where}", where.endswith("overfull"))
    box = make_box(p.L, 0.3)
    bins = bin_particles(pos, box, config.nf_spec.bins)
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    f = torch.randn((3,) + tuple(bins.px.shape), generator=g,
                    device="cuda") * bins.mask
    cpu_bins = bins._replace(**{k: getattr(bins, k).cpu()
                                for k in bins._fields})
    for dtype, bound in (("float32", 1e-5), ("bfloat16", 2e-3)):
        spec = config.nf_spec._replace(block_dtype=dtype)
        blocks = bnf.build_pair_blocks(bins, box, spec, config.cheb,
                                       p.ewald_cut, p.ewald_dr)
        u_g = bnf.matvec_cells(blocks, spec, bins, f, p.self_mobility)
        blocks = blocks.cpu()
        u_c = bnf.matvec_cells(blocks, spec, cpu_bins, f.cpu(),
                               p.self_mobility)
        del blocks
        ph.check(f"matvec_cells card vs CPU, {dtype} blocks, blocked shapes "
                 f"tilt=0.3", rel_max(u_g.cpu(), u_c)[0], bound)
        _check_rerun(ph, f"matvec_cells {dtype}", u_g, lambda: bnf.matvec_cells(
            bnf.build_pair_blocks(bins, box, spec, config.cheb, p.ewald_cut,
                                  p.ewald_dr), spec, bins, f,
            p.self_mobility))
        torch.cuda.empty_cache()


def phase_kernels(ph, sim, results, simb=None, simg=None):
    """Each kernel against its plain version at the main path's shapes (and
    the fill and the blocked matvec at the blocked path's, from ``simb``,
    and the fill at the gather path's, from ``simg``)."""
    import torch

    from pse_tpu_torch import integrator, make_params
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.ops import banded_nearfield as bdn

    config = sim.config
    p = config.params
    pos = sim.state.pos
    print("[kernels] against the plain versions at the main path's shapes")
    vals = sim.force_fn(pos, 0)
    lump = pos.clone()
    lump[:2000, :2] = 0.5               # one overfull column and cell
    for tilt, where, at in ((0.0, "main", pos), (0.3, "main", pos),
                            (0.3, "overfull", lump)):
        _check_fill(ph, results, config, at, make_box(p.L, tilt), vals,
                    f"tilt={tilt} {where}", where == "overfull")
    for tilt in (0.0, 0.3):
        bins, box, j0, nv, zsh, f, f2 = _band_operands(config, pos, tilt)
        for dtype, bound in (("float32", 1e-5), ("bfloat16", 2e-3)):
            bs = config.band_spec._replace(block_dtype=dtype)
            args = (bins, tilt, bs, config.cheb, p.L, p.ewald_cut, p.ewald_dr,
                    j0, nv, zsh)
            ref = bdn.matvec_banded_reference(*args[:9], f, p.self_mobility)
            ref2 = bdn.matvec_banded_reference(*args[:9], f2, p.self_mobility)
            blocks, u_b = bdn.build_mv_banded(*args, f, p.self_mobility)
            u_m = bdn.matvec_banded(blocks, *args, f, p.self_mobility)
            u_m2 = bdn.matvec_banded(blocks, *args, f2, p.self_mobility)
            _, u_b1 = bdn.build_mv_banded(*args, f2, p.self_mobility)
            blocks2, u_b2 = bdn.build_mv_banded(
                *args, torch.cat([f, f2]), p.self_mobility)
            u_mm = bdn.matvec_banded(blocks, *args, torch.cat([f, f2]),
                                     p.self_mobility)
            A = bdn.build_banded_blocks(*args)
            r_b, _ = rel_max(u_b, ref)
            r_m, d_m = rel_max(u_m, ref)
            r_b2, d_b2 = rel_max(u_b2, torch.cat([ref, ref2]))
            ph.check(f"build_mv {dtype} tilt={tilt}", r_b, bound)
            ph.check(f"matvec {dtype} tilt={tilt}", r_m, bound)
            ph.check(f"build_mv 2-RHS vs plain {dtype} tilt={tilt}", r_b2,
                     bound)
            for name, two, one in (("build_mv", u_b2, torch.cat([u_b, u_b1])),
                                   ("matvec", u_mm, torch.cat([u_m, u_m2]))):
                r, _ = rel_max(two, one)
                ph.check(f"{name} 2-RHS vs two 1-RHS {dtype} tilt={tilt} "
                         f"(bitwise {bool(torch.equal(two, one))})", r, 1e-4)
            ph.check(f"build_mv u vs matvec u {dtype} tilt={tilt}",
                     rel_max(u_m, u_b)[0], 1e-6)
            # build_mv is the build kernel, then the matvec kernel on its A
            ph.check(f"build_mv u vs matvec u {dtype} tilt={tilt} "
                     "(mismatched elements)", int((u_m != u_b).sum()), 0)
            for fk, got, nrhs in ((f, u_m, 1), (torch.cat([f, f2]), u_mm, 2)):
                _check_rerun(ph, f"matvec {nrhs}-RHS {dtype} tilt={tilt}",
                             got, lambda fk=fk: bdn.matvec_banded(
                                 blocks, *args, fk, p.self_mobility))
            same = bool(torch.equal(A, blocks)) and bool(torch.equal(A, blocks2))
            ph.check(f"build_banded_blocks A == build_mv A {dtype} "
                     f"tilt={tilt} (mismatches)",
                     0 if same else int((A != blocks).sum()), 0)
            plain = bdn.build_banded_blocks_reference(
                *args[:2], bs._replace(block_dtype="float32"), *args[3:])
            a_bound = 1e-6 if dtype == "float32" else 2.0 ** -8
            r_a = max(rel_max(A[:, :, k].float(), plain[:, :, k])[0]
                      for k in range(2))
            ph.check(f"build_banded_blocks vs plain build {dtype} "
                     f"tilt={tilt}", r_a, a_bound)
            if dtype == "float32":
                ph.check(f"build_banded_blocks vs plain build {dtype} "
                         f"tilt={tilt} (mismatched elements)",
                         int((A != plain).sum()), 0)
            if dtype == config.band_spec.block_dtype:
                results["build_mv_banded"]["err"].append(d_b2)
                results["matvec_banded"]["err"].append(d_m)
                results["build_banded_blocks"]["err"].append(
                    float((A.float() - plain.to(A.dtype).float()).abs().max()))
            del blocks, blocks2, A, plain

        _check_contract(ph, results, config, pos, tilt, "main")
        _check_spread(ph, results, config, pos, tilt, "main")
        torch.cuda.synchronize()

    if simb is not None:
        _check_blocked(ph, results, simb, vals)
    if simg is not None:
        # the gather path's fill: the neighbor cells, without values
        gpos = simg.state.pos
        lump = gpos.clone()
        lump[:2000] = 0.5                   # one overfull cell
        for tilt, where, at in ((0.0, "gather", gpos), (0.3, "gather", gpos),
                                (0.3, "gather overfull", lump)):
            _check_fill(ph, results, simg.config, at,
                        make_box(simg.config.params.L, tilt), None, f"tilt={tilt} {where}",
                        where.endswith("overfull"))
        del lump

    d = np.load(ORACLE)
    params = make_params(xi=float(d["xi"]), error=ERROR, L=float(d["L"]))
    ocfg = integrator.make_config(params, int(d["n"]), thermal=False,
                                  engine="banded", device="cuda")
    opos = torch.as_tensor(d["pos"], device="cuda")
    for tilt in (0.0, 0.3):
        _check_contract(ph, results, ocfg, opos, tilt, "oracle shapes")
        _check_spread(ph, results, ocfg, opos, tilt, "oracle shapes")


def phase_timing(sim, results):
    """CUDA-event times of each wrapper and its plain version at the main
    path's shapes (tilt 0.3), with the least time the card could take."""
    import torch

    from pse_tpu_torch import cellbins as cb
    from pse_tpu_torch import kernels
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

    def bound(name, nbytes, ops_n, dtype="float32"):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops_n / PEAK_FLOPS[dtype]
        results[name].update(
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")

    ops = cb.fill_operands(pos, box, bs.bins, True)
    vals = sim.force_fn(pos, 0)
    fl = results["fill_cells"]
    fl.update(
        ms=cuda_ms(lambda: cb.fill_cells(*ops, C, S, vals), 50),
        plain_ms=cuda_ms(lambda: cb.fill_cells_reference(*ops, C, S, vals),
                         20),
        kernel_ms=graph_ms(lambda: cb.fill_cells(*ops, C, S, vals), 20),
        bin_columns_ms=cuda_ms(lambda: cb.bin_columns(pos, box, bs.bins,
                                                      values=vals), 20),
        bin_particles_ms=cuda_ms(lambda: cb.bin_particles(
            pos, box, cs.bins, values=vals), 20))
    # read: the sorted cid (4 B) and order (8 B), 12 B of coordinates and
    # 12 of values per particle; write: 8 slot arrays of 4 B, the rank of
    # every particle, starts, counts and the flag
    bound("fill_cells", 36 * N + 32 * C * S + 4 * N + 8 * C + 1, 0)
    print(f"  fill (near field, with values): wrapper {fl['ms']:.4f} ms (CUDA "
          f"events), kernel alone {fl['kernel_ms']:.4f} ms (CUDA-graph "
          f"replay), bound {fl['bound_ms']:.4f} ms, plain {fl['plain_ms']:.4f}"
          f" ms; bin_columns {fl['bin_columns_ms']:.4f} ms, bin_particles "
          f"{fl['bin_particles_ms']:.4f} ms with values (CUDA events)")

    bins, box, j0, nv, zsh, f, f2 = _band_operands(config, pos, tilt)
    f12 = torch.cat([f, f2])
    args = (bins, tilt, bs, config.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    blocks, _ = bdn.build_mv_banded(*args, f, p.self_mobility)
    a_bytes = blocks.numel() * a_item
    pairs = int((blocks[:, :, 0] != 0).sum())
    plain = cuda_ms(lambda: bdn.matvec_banded_reference(
        *args[:9], f, p.self_mobility), 3)
    # besides A: slot coordinates + mask read, j0 + zsh tables read, and per
    # right-hand side f read and u written (4 B each)
    geo = 4 * C * S * 4 + 2 * 5 * C * T * 4
    rhs = 2 * 3 * C * S * 4
    # operations on this run's valid pairs (nonzero A): ~40 flops forward +
    # transposed per right-hand side; the build adds the geometry and two
    # degree-`deg` Clenshaw recurrences
    deg = config.cheb.degree
    ops_build = (20 + 8 * deg) * pairs
    results["build_mv_banded"].update(
        ms=cuda_ms(lambda: bdn.build_mv_banded(*args, f12, p.self_mobility),
                   20),
        plain_ms=cuda_ms(lambda: bdn._reference_per_rhs(
            f12, lambda fk: bdn.matvec_banded_reference(
                *args[:9], fk, p.self_mobility)), 3))
    bound("build_mv_banded", a_bytes + geo + 2 * rhs, ops_build + 80 * pairs)
    ms1 = cuda_ms(lambda: bdn.build_mv_banded(*args, f, p.self_mobility), 20)
    results["matvec_banded"].update(
        ms=cuda_ms(lambda: bdn.matvec_banded(blocks, *args, f,
                                             p.self_mobility), 20),
        plain_ms=plain)
    # the kernel skips the tiles past ceil(n_valid / R): the A it must read
    # is the rows of the non-empty tiles; all of A is kept beside it
    live_rows = int(((nv.long() + bs.rows - 1) // bs.rows * bs.rows).sum())
    live_bytes = a_bytes * live_rows // (C * S)
    bound("matvec_banded", a_bytes + geo + rhs, 40 * pairs)
    mv = results["matvec_banded"]
    mv["bound_full_A_ms"] = mv["bound_ms"]
    bound("matvec_banded", live_bytes + geo + rhs, 40 * pairs)

    def matvec_kernel():
        uo, rc = bdn._launch_matvec(blocks, bins, tilt, bs, p.L, j0, nv, zsh,
                                    f)
        kernels.check("matvec_banded", rc)
        return uo
    mv["kernel_ms"] = graph_ms(matvec_kernel, 20)
    print(f"  matvec: wrapper {mv['ms']:.4f} ms (CUDA events), kernel alone "
          f"{mv['kernel_ms']:.4f} ms (CUDA-graph replay); bound "
          f"{mv['bound_ms']:.4f} ms by {mv['bound_by']} (A rows of the "
          f"{live_rows // bs.rows} non-empty of {C * T} tiles, "
          f"{live_bytes / 1e6:.1f} MB), {mv['bound_full_A_ms']:.4f} ms for "
          f"all of A ({a_bytes / 1e6:.1f} MB); kernel at "
          f"{100 * mv['bound_ms'] / mv['kernel_ms']:.1f} % / "
          f"{100 * mv['bound_full_A_ms'] / mv['kernel_ms']:.1f} % of them")
    ms_mm = cuda_ms(lambda: bdn.matvec_banded(blocks, *args, f12,
                                              p.self_mobility), 20)
    results["build_banded_blocks"].update(
        ms=cuda_ms(lambda: bdn.build_banded_blocks(*args), 20),
        plain_ms=cuda_ms(lambda: bdn.build_banded_blocks_reference(*args), 3))
    bound("build_banded_blocks", a_bytes + geo, ops_build)

    def build_kernel(mode, rhs=None):
        def launch():
            A, _, rc = bdn._launch_banded(mode, *args, rhs)
            kernels.check("build", rc)
            return A
        return launch
    mv, bb = results["build_mv_banded"], results["build_banded_blocks"]
    mv["kernel_ms"] = graph_ms(build_kernel(bdn.MODE_BUILD_MV, f12), 20)
    mv["kernel_ms_1rhs"] = graph_ms(build_kernel(bdn.MODE_BUILD_MV, f), 20)
    bb["kernel_ms"] = graph_ms(build_kernel(bdn.MODE_BUILD), 20)
    print(f"  A: {a_bytes / 1e6:.1f} MB, valid pairs {pairs}; build_mv one "
          f"RHS {ms1:.4f} ms, two {mv['ms']:.4f} ms (CUDA events); matvec "
          f"one RHS {results['matvec_banded']['ms']:.4f} ms, two "
          f"{ms_mm:.4f} ms")
    print(f"  kernels alone (CUDA-graph replay): build_mv two RHS "
          f"{mv['kernel_ms']:.4f} ms, one RHS {mv['kernel_ms_1rhs']:.4f} ms; "
          f"bound {mv['bound_ms']:.4f} ms by {mv['bound_by']}, the two-RHS "
          f"kernel at {100 * mv['bound_ms'] / mv['kernel_ms']:.1f} %; build "
          f"alone {bb['kernel_ms']:.4f} ms, bound {bb['bound_ms']:.4f} ms, at "
          f"{100 * bb['bound_ms'] / bb['kernel_ms']:.1f} %")
    del blocks

    ff = cb.bin_particles(pos, box, cs.bins)
    fac = cff.build_col_factors(ff, box, cs, p)
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    grid = torch.randn((3, p.Nx, p.Ny, p.Nz), generator=g, device="cuda")
    Cf, cap = cs.bins.n_cells_total, cs.bins.cap
    nn = 9 * cs.s[0] * cs.s[1]
    w_item = fac.wxy.element_size()
    w_bytes = (fac.wxy.numel() + fac.wz.numel()) * w_item
    flops = 2 * Cf * nn * 3 * p.Nz * cap
    results["contract_col"].update(
        ms=cuda_ms(lambda: cff.contract_col_kernel(grid, cs, p, fac), 20),
        plain_ms=cuda_ms(lambda: cff.contract_col(grid, cs, p, fac), 5))
    bound("contract_col", grid.numel() * 4 + w_bytes + 3 * Cf * cap * 4,
          flops + 2 * 3 * p.Nz * Cf * cap, cs.weight_dtype)
    # the library yardstick: one batched product of the pre-gathered
    # windows with wxy, the H = G^T wxy of the plain version
    vt = cff._grid_to_windows(grid, cs, p, fac.wxy.dtype).transpose(1, 2)
    results["contract_col"]["library_ms"] = cuda_ms(
        lambda: torch.bmm(vt, fac.wxy), 20)
    print(f"  contract: kernel {results['contract_col']['ms']:.4f} ms, "
          f"torch.bmm ({fac.wxy.dtype} in and out) "
          f"{results['contract_col']['library_ms']:.4f} ms")
    del vt

    spec, nodes, fs, _ = _far_operands(config, pos, tilt, cs.weight_dtype)
    results["spread_col"].update(
        ms=cuda_ms(lambda: cff.spread_moments_kernel(fs, spec, p, nodes,
                                                     tilt), 20),
        plain_ms=cuda_ms(lambda: cff.spread_moments(fs, spec, p, nodes,
                                                    tilt), 5))
    bound("spread_col", _spread_bound_bytes(spec, p), 0)
    # the library yardstick: one batched float32 product of wxy with a
    # pre-built X, the dense product over every slot of a column
    wxy, wz = cff._factors_f32(nodes[:3], nodes[3], tilt, spec, p)
    fp = fs * float(np.float32(p.spread_prefac))
    X = (fp.permute(1, 0, 2)[:, :, None, :] * wz[:, None]
         ).reshape(Cf, 3 * p.Nz, cap)
    Xt = X.transpose(1, 2)
    results["spread_col"]["library_ms"] = cuda_ms(
        lambda: torch.bmm(wxy, Xt), 20)
    fold_ms = cuda_ms(lambda: cff.spread_col_kernel(fs, spec, p, nodes,
                                                    tilt), 20)
    print(f"  spread: moments kernel {results['spread_col']['ms']:.4f} ms, "
          f"with the torch overlap-add {fold_ms:.4f} ms, torch.bmm "
          f"(float32) {results['spread_col']['library_ms']:.4f} ms")


def phase_packed_timing(ph, simc, results):
    """The class-packed build_mv (two RHS) and matvec (one RHS) beside the
    single-class kernels on the same inputs: the relaxed [main-classes-forces]
    state at its tilt with its classes; wrapper by CUDA events, kernel alone
    by CUDA-graph replay, single, packed, packed, single; bounds on the
    bytes each must move (the matvec reads the live tiles' A rows, the
    build writes the packed A)."""
    import torch

    from pse_tpu_torch import kernels
    from pse_tpu_torch.ops import banded_nearfield as bdn

    config, p = simc.config, simc.config.params
    bs = config.band_spec
    bs1 = bs._replace(classes=None, slab_classes=None)
    tilt = simc.state.tilt_xy
    print(f"[timing] class-packed kernels, classes {bs.classes}, at the "
          f"relaxed state (tilt {tilt})")
    bins, box, j0, nv, zsh, f, f2 = _band_operands(config, simc.state.pos,
                                                   tilt)
    perm, inv, ovf = bdn.class_assignment(bs, nv)
    if bool(ovf):
        ph.failed.append("packed timing: the classes overflow at the state")
        return
    pack = (perm, inv)
    f12 = torch.cat([f, f2])
    args = (bins, tilt, bs, config.cheb, p.L, p.ewald_cut, p.ewald_dr, j0,
            nv, zsh)
    args1 = (bins, tilt, bs1) + args[3:]
    blocks, u = bdn.build_mv_banded(*args, f12, p.self_mobility, pack=pack)
    blocks1, u1 = bdn.build_mv_banded(*args1, f12, p.self_mobility)
    ph.check("packed vs single-class build_mv u at the main path's state "
             "(mismatched elements)", int((u != u1).sum()), 0)
    ph.check("packed vs single-class matvec u at the main path's state "
             "(mismatched elements)", int((
                 bdn.matvec_banded(blocks, *args, f, p.self_mobility,
                                   pack=pack)
                 != bdn.matvec_banded(blocks1, *args1, f,
                                      p.self_mobility)).sum()), 0)
    C, S, R, W = bs.bins.n_cells_total, bs.bins.cap, bs.rows, bs.window
    T = S // R
    item = blocks1.element_size()
    live_rows = int(((nv.long() + R - 1) // R * R).sum())
    live_bytes = item * 2 * 5 * W * live_rows
    packed_bytes, one_bytes = _band_bytes(bs), _band_bytes(bs1)
    pairs = int((blocks1[:, :, 0] != 0).sum())
    geo = 4 * C * S * 4 + 2 * 5 * C * T * 4
    rhs = 2 * 3 * C * S * 4
    ops_build = (20 + 8 * config.cheb.degree) * pairs

    def bound_ms(nbytes, ops_n):
        return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops_n / PEAK_FLOPS["float32"])

    def mv_kernel(b, a, pk):
        def launch():
            uo, rc = bdn._launch_matvec(b, *a[:3], p.L, j0, nv, zsh, f, pk)
            kernels.check("matvec_banded", rc)
            return uo
        return launch

    def bmv_kernel(a, pk):
        def launch():
            A, _, rc = bdn._launch_banded(bdn.MODE_BUILD_MV, *a, f12, pk)
            kernels.check("build_mv_banded", rc)
            return A
        return launch

    cases = {
        "single": (blocks1, args1, None), "packed": (blocks, args, pack)}
    t = {k: {} for k in cases}
    for k in ("single", "packed", "packed", "single"):
        b, a, pk = cases[k]
        t[k].setdefault("mv", []).append(cuda_ms(
            lambda: bdn.matvec_banded(b, *a, f, p.self_mobility, pack=pk),
            20))
        t[k].setdefault("mv_k", []).append(graph_ms(mv_kernel(b, a, pk), 20))
        t[k].setdefault("bmv", []).append(cuda_ms(
            lambda: bdn.build_mv_banded(*a, f12, p.self_mobility, pack=pk),
            20))
        t[k].setdefault("bmv_k", []).append(graph_ms(bmv_kernel(a, pk), 20))
    mv, bmv = results["matvec_banded"], results["build_mv_banded"]
    mv.update(packed_ms=t["packed"]["mv"], packed_kernel_ms=t["packed"]["mv_k"],
              packed_single_ms=t["single"]["mv"],
              packed_single_kernel_ms=t["single"]["mv_k"],
              packed_bound_ms=bound_ms(live_bytes + geo + rhs, 40 * pairs))
    bmv.update(packed_ms=t["packed"]["bmv"],
               packed_kernel_ms=t["packed"]["bmv_k"],
               packed_single_ms=t["single"]["bmv"],
               packed_single_kernel_ms=t["single"]["bmv_k"],
               packed_bound_ms=bound_ms(packed_bytes + geo + 2 * rhs,
                                        ops_build + 80 * pairs),
               packed_a_bytes=packed_bytes, single_a_bytes=one_bytes,
               live_a_bytes=live_bytes)
    fmt = lambda xs: " / ".join(f"{x:.4f}" for x in xs)   # noqa: E731
    print(f"  A: packed {packed_bytes / 1e6:.1f} MB, single class "
          f"{one_bytes / 1e6:.1f} MB, live tiles {live_bytes / 1e6:.1f} MB "
          f"({live_rows // R} of {C * T} tiles)")
    print(f"  matvec (one RHS): wrapper packed {fmt(t['packed']['mv'])} ms, "
          f"single {fmt(t['single']['mv'])} ms; kernel alone packed "
          f"{fmt(t['packed']['mv_k'])} ms, single {fmt(t['single']['mv_k'])}"
          f" ms; bound {mv['packed_bound_ms']:.4f} ms (live tiles)")
    print(f"  build_mv (two RHS): wrapper packed {fmt(t['packed']['bmv'])} "
          f"ms, single {fmt(t['single']['bmv'])} ms; kernels alone packed "
          f"{fmt(t['packed']['bmv_k'])} ms, single "
          f"{fmt(t['single']['bmv_k'])} ms; bound "
          f"{bmv['packed_bound_ms']:.4f} ms (the packed A written once)")
    del blocks, blocks1
    torch.cuda.empty_cache()


def _time_matvec(ph, blocks, nf, bins, f, self_mobility):
    """[blocked-build]'s matvec: matvec_cells alone (CUDA-graph replay) and
    through its wrapper (CUDA events) beside its two bounds by bytes (the
    live slot pairs' coefficients, as portbench's yardstick counts them,
    and every stored byte), the plain version, and torch.bmm on operands
    upcast beforehand (the library yardstick: the plain version's forward
    and transposed GEMVs without its upcast, gathers and sums); the kernel
    against the plain version on the same blocks."""
    import torch

    from portbench.yardstick import live_slot_pairs
    from pse_tpu_torch.ops import blocked_nearfield as bnf

    noff, _, C, cap, _ = blocks.shape
    n = int(bins.mask.sum())
    vecs = 2 * 3 * n * 4                           # f read, u written
    counts = (bins.mask != 0).sum(1).view(*nf.bins.n_cells)
    live = live_slot_pairs(counts, nf.offsets) * 6 * blocks.element_size()
    stored = blocks.numel() * blocks.element_size()

    def matvec():
        return bnf.matvec_cells(blocks, nf, bins, f, self_mobility)
    _check_matvec_kernel(ph, "blocked-build", blocks, nf, bins,
                         self_mobility)
    alone = graph_ms(matvec, 10)
    wrapper = cuda_ms(matvec, 20)
    plain = cuda_ms(lambda: bnf.matvec_cells_reference(
        blocks, nf, bins, f, self_mobility), 3)
    a32 = blocks.float().view(noff * 6 * C, cap, cap)
    rhs = f.permute(1, 2, 0)[None, None].expand(noff, 6, C, cap, 3).reshape(
        noff * 6 * C, cap, 3)
    first_t = int(tuple(nf.offsets[0]) == (0, 0, 0))
    t0 = first_t * 6 * C

    def library():
        torch.bmm(a32, rhs)
        torch.bmm(a32[t0:].transpose(1, 2), rhs[t0:])
    lib = cuda_ms(library, 3)
    del a32, rhs
    torch.cuda.empty_cache()
    live_ms = 1e3 * (live + vecs) / HBM_BYTES_PER_S
    stored_ms = 1e3 * (stored + vecs) / HBM_BYTES_PER_S
    print(f"  matvec_cells: kernel alone {alone:.4f} ms (CUDA-graph replay),"
          f" wrapper {wrapper:.4f} ms (CUDA events); bounds by bytes: live "
          f"pairs {live_ms:.4f} ms ({(live + vecs) / 1e9:.3f} GB: "
          f"{100 * live_ms / alone:.1f} % of it alone), all stored "
          f"{stored_ms:.4f} ms ({(stored + vecs) / 1e9:.3f} GB: "
          f"{100 * stored_ms / alone:.1f} %); plain {plain:.3f} ms, "
          f"library (torch.bmm on float32 blocks upcast beforehand, forward "
          f"and transposed) {lib:.3f} ms")
    return {"ms": wrapper, "bytes": live + vecs, "alone_ms": alone,
            "bound_live_ms": live_ms, "bound_stored_ms": stored_ms,
            "plain_ms": plain, "library_ms": lib}


def phase_blocked_timing(ph, simb, results, launches_b):
    """The fill at the blocked near field's shape (tilt 0.3); [blocked-build]:
    build_pair_blocks at the [blocked-forces] state, bitwise its plain
    version at tilts 0 and 0.3, its kernel alone, wrapper and plain version
    timed at 0.3 beside its bound by bytes; matvec_cells on those blocks
    (``_time_matvec``); the bytes each must move and the launches per
    call."""
    import torch

    from pse_tpu_torch import cellbins as cb
    from pse_tpu_torch import trace
    from pse_tpu_torch.ab import device_profile
    from pse_tpu_torch.box import make_box
    from pse_tpu_torch.ops import blocked_nearfield as bnf

    config, p = simb.config, simb.config.params
    pos, nf = simb.state.pos, config.nf_spec
    box = make_box(p.L, 0.3)
    C, cap = nf.bins.n_cells_total, nf.bins.cap
    print(f"[timing] blocked path: cells {nf.bins.n_cells} cap {cap}")
    ops = cb.fill_operands(pos, box, nf.bins, False)
    vals = simb.force_fn(pos, 0)
    fl = results["fill_cells"]
    fl.update(
        blocked_ms=cuda_ms(lambda: cb.fill_cells(*ops, C, cap, vals), 50),
        blocked_plain_ms=cuda_ms(
            lambda: cb.fill_cells_reference(*ops, C, cap, vals), 20),
        blocked_kernel_ms=graph_ms(lambda: cb.fill_cells(*ops, C, cap, vals),
                                   20),
        blocked_bound_ms=1e3 * (40 * N + 32 * C * cap + 8 * C + 1)
        / HBM_BYTES_PER_S)
    print(f"  fill (blocked near field, with values): wrapper "
          f"{fl['blocked_ms']:.4f} ms (CUDA events), kernel alone "
          f"{fl['blocked_kernel_ms']:.4f} ms (CUDA-graph replay), bound "
          f"{fl['blocked_bound_ms']:.4f} ms by bytes, plain "
          f"{fl['blocked_plain_ms']:.4f} ms")
    item = torch.empty((), dtype=getattr(torch, nf.block_dtype)).element_size()
    block_bytes = len(nf.offsets) * 6 * C * cap * cap * item
    slots = 4 * C * cap * 4
    print(f"[blocked-build] build_pair_blocks at the [blocked-forces] state: "
          f"cells {nf.bins.n_cells} cap {cap} {nf.block_dtype}, "
          f"{len(nf.offsets)} offsets")
    if nf.block_dtype != "bfloat16":
        ph.failed.append(f"blocked-build: {nf.block_dtype} blocks")
    for tilt in (0.0, 0.3):            # timed below at the last, 0.3
        bins = cb.bin_particles(pos, make_box(p.L, tilt), nf.bins)
        args = (bins, make_box(p.L, tilt), nf, config.cheb, p.ewald_cut,
                p.ewald_dr)
        n0 = trace.counters().get("launch.build_pair_blocks", 0)
        got = bnf.build_pair_blocks(*args)
        if trace.counters().get("launch.build_pair_blocks", 0) != n0 + 1:
            ph.failed.append(f"blocked-build tilt={tilt}: not one launch")
        want = bnf.build_pair_blocks_reference(*args)
        bad = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        equal = torch.equal(got, want)
        print(f"  tilt={tilt}: blocks torch.equal {equal}, elements whose "
              f"bits differ {bad} of {got.numel()}, nonzero "
              f"{int(got.count_nonzero())}")
        if not equal or bad:
            ph.failed.append(f"blocked-build tilt={tilt}: blocks differ")
        del want
        rerun = bnf.build_pair_blocks(*args)
        if not torch.equal(rerun.view(torch.int16), got.view(torch.int16)):
            ph.failed.append(f"blocked-build tilt={tilt}: rerun differs")
        del got, rerun
        torch.cuda.empty_cache()

    def build():
        return bnf.build_pair_blocks(*args)
    alone = graph_ms(build, 5)
    torch.cuda.empty_cache()
    b_ms = cuda_ms(build, 10)
    plain = cuda_ms(lambda: bnf.build_pair_blocks_reference(*args), 2)
    bound = 1e3 * (slots + block_bytes) / HBM_BYTES_PER_S
    per_step = launches_b["build_pair_blocks"] / BLOCKED_TIMED
    print(f"  kernel alone {alone:.4f} ms (CUDA-graph replay), wrapper "
          f"{b_ms:.4f} ms (CUDA events), bound {bound:.4f} ms by bytes "
          f"({(slots + block_bytes) / 1e9:.3f} GB at 3.35 TB/s: "
          f"{100 * bound / alone:.1f} % of it alone), plain {plain:.2f} ms; "
          f"{per_step:g} launches a step on [blocked-forces]")
    blocks = build()
    f = torch.randn((3, C, cap), device="cuda") * bins.mask
    mv = _time_matvec(ph, blocks, nf, bins, f, p.self_mobility)

    def matvec():
        return bnf.matvec_cells(blocks, nf, bins, f, p.self_mobility)
    for name, ms, nbytes, fn in (
            ("build_pair_blocks", b_ms, slots + block_bytes, build),
            ("matvec_cells", mv["ms"], mv["bytes"], matvec)):
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        prof = device_profile(fn, reps=2)
        results.setdefault("blocked", {})[name] = {
            "ms": ms, "bytes": nbytes, "bound_ms": bound,
            "launches_per_call": prof["launches"],
            "copies_per_call": prof["copies"]}
        print(f"  {name}: {ms:.4f} ms (CUDA events), must move "
              f"{nbytes / 1e9:.3f} GB: bound {bound:.4f} ms by bytes, "
              f"{100 * bound / ms:.1f} % of it; {prof['launches']:.0f} "
              f"kernel launches and {prof['copies']:.0f} copies and "
              "memsets per call (torch.profiler)")
    results["blocked"]["build_pair_blocks"].update(
        alone_ms=alone, plain_ms=plain,
        launches_blocked=launches_b["build_pair_blocks"],
        launches_per_step=per_step)
    results["blocked"]["matvec_cells"].update(
        {k: v for k, v in mv.items() if k not in ("ms", "bytes")},
        launches_blocked=launches_b["matvec_cells"],
        launches_per_step=launches_b["matvec_cells"] / BLOCKED_TIMED)
    del blocks
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# parallel/: the halo x-slab engine and the sharded step on one card, D
# slabs or shards on cuda:0 (a mesh whose device repeats)

HALO_N, HALO_L = 4800, 33.0        # tests/test_halo.py's box
HALO_WARM, HALO_TIMED = 2, 10
HALO_1M_N, HALO_1M_WARM, HALO_1M_TIMED = 1_000_000, 5, 3
SHARDED_TIMED = 3


def _cuda_mesh(d):
    import torch

    from pse_tpu_torch.parallel import sharding

    return sharding.make_mesh([torch.device("cuda:0")] * d)


def _fitting_slab_classes(config, pos, tilts):
    """Two slab classes that hold every slab at these tilts: the top two
    columns of each slab at the cap's tiles, the rest at the most any
    slab's third column needs (or None where that is the cap)."""
    from pse_tpu_torch.ops import banded_nearfield as bdn

    bs, D = config.band_spec, config.shard_slabs
    ncx, ncy, _ = bs.bins.n_cells
    c_loc, t_cap = (ncx // D + 2) * ncy, bs.bins.cap // bs.rows
    low = 0
    for tilt in tilts:
        counts = bdn.measure_col_counts(bs, pos, config.params.L, tilt)
        for c in bdn.make_slab_counts(bs, D, counts):
            need = np.sort(-(-np.maximum(c, 1) // bs.rows))[::-1]
            low = max(low, int(need[2]))
    return None if low >= t_cap else ((low, c_loc - 2), (t_cap, 2))


def _halo_config(n, L, D, dtype, thermal=True, seed=3, device="cuda",
                 positions=None):
    from pse_tpu_torch import integrator, make_params

    params = make_params(xi=XI, error=ERROR, L=L)
    return integrator.make_config(
        params, n, thermal=thermal, engine="banded", seed=seed,
        shard_slabs=D, block_dtype=dtype, ff_weight_dtype=dtype,
        positions=positions, device=device)


def phase_halo_small(ph):
    """The halo engine on the card at N=4800, L=33 (tests/test_halo.py's
    box), D = 1, 2 and 4 slabs on cuda:0, tilts 0 and 0.3, float32 and
    bfloat16 A, slab classes on and off."""
    import dataclasses

    import torch

    from pse_tpu_torch import integrator
    from pse_tpu_torch.parallel import halo, sharding

    t0 = time.perf_counter()
    print(f"[halo-small] the halo engine on the card (N={HALO_N}, "
          f"L={HALO_L}, D = 1, 2, 4 slabs on cuda:0)")
    rng = np.random.default_rng(1)
    pos = rng.uniform(-HALO_L / 2, HALO_L / 2, (HALO_N, 3)).astype(np.float32)
    F = rng.normal(size=(HALO_N, 3)).astype(np.float32)
    Fg = torch.from_numpy(F).cuda()
    bounds = {"float32": (1e-4, 1e-4), "bfloat16": (2e-3, 5e-3)}
    for D in (1, 2, 4):
        mesh = _cuda_mesh(D)
        for dtype, (b_one, b_cpu) in bounds.items():
            cfg = _halo_config(HALO_N, HALO_L, D, dtype)
            bs = cfg.band_spec
            cls = _fitting_slab_classes(cfg, pos, (0.0, 0.3))
            with_cls = dataclasses.replace(cfg, band_spec=bs._replace(
                slab_classes=cls))
            no_cls = dataclasses.replace(cfg, band_spec=bs._replace(
                slab_classes=None))
            print(f"  D={D} {dtype}: columns {bs.bins.n_cells[:2]} S "
                  f"{bs.bins.cap} W {bs.window}, slab classes {cls}")
            for tilt in (0.0, 0.3):
                tag = f"D={D} {dtype} tilt={tilt}"
                u1, o1 = integrator.mobility(no_cls, pos, F, tilt)
                u_n, o_n = halo.make_halo_mobility(no_cls, mesh)(pos, F, tilt)
                u_c, o_c = halo.make_halo_mobility(with_cls, mesh)(pos, F,
                                                                  tilt)
                u_r, _ = halo.make_halo_mobility(with_cls, mesh)(pos, F, tilt)
                ph.check(f"{tag}: halo mobility vs one device (2-norm)",
                         _norm_rel(u_n, u1), b_one)
                if int(o1) or int(o_n) or int(o_c):
                    ph.failed.append(f"halo-small {tag}: overflow "
                                     f"{int(o1)} / {int(o_n)} / {int(o_c)}")
                if cls is not None and not torch.equal(u_c, u_n):
                    ph.failed.append(f"halo-small {tag}: slab classes not "
                                     "bitwise one class")
                if not torch.equal(u_c, u_r):
                    ph.failed.append(f"halo-small {tag}: rerun not bitwise")
                if D == 4:
                    cpu = _halo_config(HALO_N, HALO_L, D, dtype,
                                       device="cpu")
                    cpu = dataclasses.replace(cpu, cheb=cfg.cheb)
                    u_h, _ = halo.make_halo_mobility(
                        cpu, sharding.make_mesh(
                            [torch.device("cpu")] * D))(pos, F, tilt)
                    ph.check(f"{tag}: card halo vs CPU halo (max)",
                             rel_max(u_c.cpu(), u_h)[0], b_cpu)
            # the thermal step with forces at equal uniforms, halo vs one
            # device, and its rerun
            draws = _raw_uniforms(cfg, 7)
            st = integrator.make_state(pos, 5, 0.3, "cuda")
            s1, i1 = integrator.step(no_cls, st, Fg, 1.0, DT, 0.5, 0.31,
                                     uniforms=draws)
            run = halo.make_halo_step(with_cls, mesh)
            s2, i2 = run(st, Fg, 1.0, DT, 0.5, 0.31, uniforms=draws)
            s3, _ = run(st, Fg, 1.0, DT, 0.5, 0.31, uniforms=draws)
            d1, d2 = s1.pos - st.pos, s2.pos - st.pos
            ph.check(f"D={D} {dtype}: halo step vs one device, displacement "
                     f"(2-norm), m {i2['m_lanczos']}/{i1['m_lanczos']}",
                     _norm_rel(d2, d1), b_one)
            if i1["m_lanczos"] != i2["m_lanczos"] or int(s2.nbr_overflow):
                ph.failed.append(f"halo-small D={D} {dtype}: step m or "
                                 "overflow")
            if not torch.equal(s2.pos, s3.pos):
                ph.failed.append(f"halo-small D={D} {dtype}: step rerun not "
                                 "bitwise")
            # the two-RHS matvec against two singles
            eng = halo.make_halo_engine(with_cls, mesh)
            box = integrator._box_of(cfg, 0.3)
            ctx, _ = eng.prepare(st.pos, box, Fg)
            fa = eng.f_slots_t(ctx, Fg)
            fb = eng.f_slots_t(ctx, Fg.flip(0))
            ctx, _ = eng.build_mv(ctx, fa)
            u2 = eng.mreal_t2(ctx, torch.cat([fa, fb]))
            ph.check(f"D={D} {dtype}: mreal_t2 vs two mreal_t (2-norm)",
                     max(_norm_rel(u2[:3], eng.mreal_t(ctx, fa)),
                         _norm_rel(u2[3:], eng.mreal_t(ctx, fb))), 1e-4)
            # an overfull slab: a top class of one column
            C_loc = eng.c_loc
            over = dataclasses.replace(cfg, band_spec=bs._replace(
                slab_classes=((2, C_loc - 1), (bs.bins.cap // bs.rows, 1))))
            oeng = halo.make_halo_engine(over, mesh)
            octx, mask = oeng.prepare(st.pos, box, Fg)
            _, u = oeng.build_mv(octx, octx.nf_f)
            ph.check(f"D={D} {dtype}: overfull slab classes flag OVF_CLASS "
                     "(0 = set)", 0 if int(mask) & integrator.OVF_CLASS
                     else 1, 0)
            if not bool(torch.isfinite(u).all()):
                ph.failed.append(f"halo-small D={D} {dtype}: overfull u not "
                                 "finite")
    print(f"  [halo-small] {time.perf_counter() - t0:.1f} s")


def _halo_steps(ph, label, cfg, pos, F, D, warm, timed, may_grow=False):
    """A warm-up and ``timed`` thermal steps with forces through
    make_halo_step at D slabs on cuda:0.  A warm-up step that flags an
    overflow is redone on the config grow_config gives, as Simulation.run
    does (a failure of the phase unless ``may_grow``), and the grown config
    is checked (mobility against one device, the slab kernels against
    their plain version) at the state the timed steps start from.  The timed
    steps run with every launch count set to 0 just before and read
    after, and must flag none.  Then torch.profiler over 3 more steps.
    Returns (launches, ms/step, the profile or None, each slab's A bytes,
    the peak memory)."""
    import torch

    from pse_tpu_torch import integrator
    from pse_tpu_torch.parallel import halo

    mesh = _cuda_mesh(D)
    run = halo.make_halo_step(cfg, mesh)
    cur = [integrator.make_state(pos, 0, 0.0, "cuda")]
    ms_hist = []

    def advance(k):
        for _ in range(k):
            cur[0], info = run(cur[0], F, 1.0, DT, 0.0)
            ms_hist.append(info["m_lanczos"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    retries, done = [], 0
    while done < warm and len(retries) <= 3:
        new, info = run(cur[0], F, 1.0, DT, 0.0)
        flags = int(info["nbr_overflow"])
        if flags:
            retries.append((done, flags))
            cfg = integrator.grow_config(cfg, flags=flags)
            run = halo.make_halo_step(cfg, mesh)
            continue
        cur[0], done = new, done + 1
    bs = cfg.band_spec
    print(f"  warm-up {warm} steps: overflow retries {retries} ((step, "
          f"mask) each, redone on grow_config's config); the timed steps "
          f"run at S {bs.bins.cap} W {bs.window}")
    if retries and not may_grow:
        ph.failed.append(f"{label}: warm-up overflow retries {retries}")
    if retries:
        _halo_vs_one(ph, f"{label} grown", cfg, cur[0].pos, F, D)
        _check_halo_kernels(ph, f"{label} grown", cfg, cur[0].pos, D)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, launches = _counted(ph, label, ("fill_cells", "contract_col",
                                       "spread_col", "build_mv_banded",
                                       "matvec_banded"),
                           lambda: advance(timed))
    ms = 1e3 * (time.perf_counter() - t0) / timed
    peak = torch.cuda.max_memory_allocated()
    for k in ("build_pair_blocks", "matvec_cells"):
        if launches[k]:
            ph.failed.append(f"{k} launched on the {label} path")
    state = cur[0]
    if int(state.nbr_overflow) or not bool(torch.isfinite(state.pos).all()):
        ph.failed.append(f"{label}: timed steps flag overflow "
                         f"{int(state.nbr_overflow)} or positions not finite")
    want_mv = D * sum(m - 1 for m in ms_hist)
    if (launches["build_mv_banded"] != D * timed
            or launches["matvec_banded"] != want_mv):
        ph.failed.append(f"{label}: launches build_mv "
                         f"{launches['build_mv_banded']} (expected "
                         f"{D * timed}), matvec {launches['matvec_banded']} "
                         f"(expected {want_mv})")
    spec = halo.make_halo_engine(cfg, mesh).spec
    slab_a = _band_bytes(spec)
    print(f"  {timed} steps: {ms:.3f} ms/step, {pos.shape[0] * 1e3 / ms:.6g} "
          f"particle-steps/s (host clock); m {ms_hist}; per step build_mv "
          f"{launches['build_mv_banded'] / timed:g} (D = {D}), matvec "
          f"{launches['matvec_banded'] / timed:g} (D (m - 1) = "
          f"{want_mv / timed:g}); slab classes {spec.classes}, each slab's "
          f"A {slab_a / 1e6:.1f} MB ({D} x {slab_a / 1e6:.1f} = "
          f"{D * slab_a / 1e6:.1f} MB against the global single class's "
          f"{_band_bytes(bs._replace(classes=None)) / 1e6:.1f} MB); peak "
          f"device memory {peak / 1e9:.3f} GB")
    prof = phase_profile(advance, ms, f"{label} halo")
    return launches, ms, prof, slab_a, peak


def _halo_vs_one(ph, label, cfg, pos, F, D):
    """One halo mobility at D slabs against the one-device engine on the
    same config: <= 2e-3 in the 2-norm, no overflow."""
    from pse_tpu_torch import integrator
    from pse_tpu_torch.parallel import halo

    u1, o1 = integrator.mobility(cfg, pos, F)
    u, o = halo.make_halo_mobility(cfg, _cuda_mesh(D))(pos, F)
    ph.check(f"{label}: halo mobility vs the one-device engine (2-norm)",
             _norm_rel(u, u1), 2e-3)
    if int(o) or int(o1):
        ph.failed.append(f"{label}: mobility overflow {int(o)} / {int(o1)}")


def _check_halo_kernels(ph, label, cfg, pos, D):
    """The banded kernels at the halo's own shapes: the first and the last
    slab's operands from HaloEngine.prepare at tilt 0 (the seam-shifted
    halos; the slab classes where the config has them), build_mv at one
    and two right-hand sides and the stored-A matvec on its A, against
    matvec_banded_reference on the slab's interior columns (max abs / max
    |ref|): float32 <= 1e-5, bfloat16 <= 2e-3, the bounds of [kernels];
    and the slab's two-RHS u against the one-device kernel's (build_mv on
    the global operands, one class) on the same columns, within the same
    bounds, with whether they are bitwise equal."""
    import torch

    from pse_tpu_torch import integrator
    from pse_tpu_torch.ops import banded_nearfield as bdn
    from pse_tpu_torch.parallel import halo

    p = cfg.params
    eng = halo.make_halo_engine(cfg, _cuda_mesh(D))
    box = integrator._box_of(cfg, 0.0)
    pos = torch.as_tensor(pos, device="cuda")
    ctx, mask = eng.prepare(pos, box)
    if int(mask):
        ph.failed.append(f"{label}: slab operands flag overflow {int(mask)}")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    ft = torch.cat([eng.f_slots_t(ctx, torch.randn(
        pos.shape, generator=g, device="cuda")) for _ in range(2)])

    def interior(u):
        return u.reshape(u.shape[0], eng.nxl + 2, eng.ncy, -1)[:, 1:-1]

    # the one-device kernel on the global operands, per block dtype
    gs = cfg.band_spec._replace(classes=None, slab_classes=None)
    j0g, nvg, _, zshg = bdn.compute_windows(
        ctx.nf_bins, gs, box, p.ewald_cut, offsets=gs.offsets[:bdn.N_HALF])
    one = {}
    for dtype in ("float32", "bfloat16"):
        _, u = bdn.build_mv_banded(
            ctx.nf_bins, ctx.tilt, gs._replace(block_dtype=dtype), cfg.cheb,
            p.L, p.ewald_cut, p.ewald_dr, j0g, nvg, zshg, ft,
            p.self_mobility)
        one[dtype] = u.reshape(6, gs.bins.n_cells[0], eng.ncy, -1)
        torch.cuda.empty_cache()

    for d in sorted({0, D - 1}):
        s = ctx.slabs[d]
        f = eng.exchange_x(ft, d)
        j0, _, _, _ = bdn.compute_windows(s.bins, eng.spec, box, p.ewald_cut,
                                          col_mask=eng.interior[d])
        ref = interior(bdn._reference_per_rhs(
            f, lambda fk: bdn.matvec_banded_reference(
                s.bins, ctx.tilt, eng.spec, cfg.cheb, p.L, p.ewald_cut,
                p.ewald_dr, j0, s.n_valid, fk, p.self_mobility)))
        for dtype, bound in (("float32", 1e-5), ("bfloat16", 2e-3)):
            args = (s.bins, ctx.tilt, eng.spec._replace(block_dtype=dtype),
                    cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, s.j0, s.n_valid,
                    s.zsh)
            blocks, u1 = bdn.build_mv_banded(*args, f[:3], p.self_mobility,
                                             pack=s.cls)
            _, u2 = bdn.build_mv_banded(*args, f, p.self_mobility, pack=s.cls)
            m1 = bdn.matvec_banded(blocks, *args, f[:3], p.self_mobility,
                                   pack=s.cls)
            m2 = bdn.matvec_banded(blocks, *args, f, p.self_mobility,
                                   pack=s.cls)
            tag = (f"{label} slab {d} C_loc {eng.c_loc} S "
                   f"{eng.spec.bins.cap} W {eng.spec.window} classes "
                   f"{s.cls is not None} {dtype}")
            for name, u, want in (("build_mv 1-RHS", u1, ref[:3]),
                                  ("build_mv 2-RHS", u2, ref),
                                  ("matvec 1-RHS", m1, ref[:3]),
                                  ("matvec 2-RHS", m2, ref)):
                ph.check(f"{tag}: {name} vs plain (max abs / max)",
                         rel_max(interior(u), want)[0], bound)
            want = one[dtype][:, d * eng.nxl:(d + 1) * eng.nxl]
            for name, u in (("build_mv", u2), ("matvec", m2)):
                got = interior(u)
                ph.check(f"{tag}: {name} 2-RHS vs the one-device kernel on "
                         f"its columns (bitwise {bool(torch.equal(got, want))}"
                         ")", rel_max(got, want)[0], bound)
            del blocks, u1, u2, m1, m2
    del ctx
    torch.cuda.empty_cache()


def phase_halo_main(ph):
    """The halo step at the main path's config (N=100k, shard_slabs=4,
    D = 4 on cuda:0): mobility against one device, then the timed steps."""
    import torch

    t0 = time.perf_counter()
    pos, L = make_positions(N, PHI, seed=0)
    cfg = _halo_config(N, L, 4, None, seed=SEED, positions=pos)
    bs = cfg.band_spec
    print(f"[halo-main] make_halo_step N={N} phi={PHI} L={L:.4f}, "
          f"shard_slabs=4, D=4 on cuda:0: columns {bs.bins.n_cells[:2]} S "
          f"{bs.bins.cap} W {bs.window} {bs.block_dtype}, slab classes "
          f"{bs.slab_classes}")
    F = torch.as_tensor(np.random.default_rng(1).normal(size=(N, 3))
                        .astype(np.float32), device="cuda")
    _halo_vs_one(ph, "halo-main", cfg, pos, F, 4)
    _check_halo_kernels(ph, "halo-main", cfg, pos, 4)
    out = _halo_steps(ph, "halo-main", cfg, pos, F, 4, HALO_WARM, HALO_TIMED)
    torch.cuda.empty_cache()
    print(f"  [halo-main] {time.perf_counter() - t0:.1f} s")
    return out


def phase_halo_1m(ph):
    """BASELINE config 5 on one card: N = 1,000,000, phi 0.45, D = 4 slabs
    on cuda:0; mobility against the one-device banded engine, then timed
    thermal steps with forces."""
    import torch

    t0 = time.perf_counter()
    pos, L = make_positions(HALO_1M_N, PHI, seed=0)
    cfg = _halo_config(HALO_1M_N, L, 4, None, seed=SEED, positions=pos)
    bs = cfg.band_spec
    print(f"[halo-1m] make_halo_step N={HALO_1M_N} phi={PHI} L={L:.4f}, D=4 "
          f"on cuda:0: columns {bs.bins.n_cells[:2]} S {bs.bins.cap} W "
          f"{bs.window} {bs.block_dtype}, slab classes {bs.slab_classes}; "
          f"the global A {_band_bytes(bs) / 1e9:.3f} GB")
    F = torch.as_tensor(np.random.default_rng(1).normal(
        size=(HALO_1M_N, 3)).astype(np.float32), device="cuda")
    _halo_vs_one(ph, "halo-1m", cfg, pos, F, 4)
    torch.cuda.empty_cache()
    _check_halo_kernels(ph, "halo-1m", cfg, pos, 4)
    out = _halo_steps(ph, "halo-1m", cfg, pos, F, 4, HALO_1M_WARM,
                      HALO_1M_TIMED, may_grow=True)
    torch.cuda.empty_cache()
    print(f"  [halo-1m] {time.perf_counter() - t0:.1f} s")
    return out


def _sharded_uniforms(config, n, seed):
    """Raw uniforms for a step: psi in the engine's slots, the wave."""
    if config.engine != "gather":
        return _raw_uniforms(config, seed)
    p = config.params
    rng = np.random.default_rng(seed)
    return (rng.uniform(-math.sqrt(3), math.sqrt(3), (3, n))
            .astype(np.float32),
            rng.uniform(-math.sqrt(1.5), math.sqrt(1.5),
                        (6, p.Nx, p.Ny, p.Nz // 2 + 1)).astype(np.float32))


def phase_sharded_small(ph):
    """The sharded step and mobility (blocked, gather) at D = 4 on cuda:0
    against the one-device ones on the card: tests/test_sharding.py's
    8^3 lattice, thermal and athermal, tilt 0.03."""
    import torch

    import pse_tpu_torch as pse
    from pse_tpu_torch import integrator
    from pse_tpu_torch.parallel import sharding

    t0 = time.perf_counter()
    print("[sharded-small] the sharded step on the card (8^3 lattice, "
          "L=24, D=4 on cuda:0)")
    n, L = 512, 24.0
    rng = np.random.default_rng(0)
    pos = pse.create_lattice(8, L)
    pos = (pos + rng.normal(scale=0.08, size=pos.shape)).astype(np.float32)
    F = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32),
                        device="cuda")
    mesh = _cuda_mesh(4)
    for engine in ("blocked", "gather"):
        for thermal in (True, False):
            cfg = integrator.make_config(pse.make_params(xi=XI, error=ERROR,
                                                         L=L), n,
                                         thermal=thermal, seed=1,
                                         engine=engine, device="cuda")
            tag = f"{engine} {'thermal' if thermal else 'athermal'}"
            draws = _sharded_uniforms(cfg, n, 3) if thermal else None
            st = integrator.make_state(pos, 0, 0.03, "cuda")
            s1, i1 = integrator.step(cfg, st, F, 1.0, DT, 0.2, 0.031,
                                     uniforms=draws)
            s2, i2 = sharding.make_sharded_step(cfg, mesh)(
                st, F, 1.0, DT, 0.2, 0.031, uniforms=draws)
            scale = float(i1["velocities"].abs().max())
            ph.check(f"{tag}: sharded step positions vs one device (max "
                     "abs)", float((s2.pos - s1.pos).abs().max()), 2e-5)
            ph.check(f"{tag}: velocities (max abs / scale)",
                     float((i2["velocities"] - i1["velocities"]).abs().max())
                     / scale, 5e-4)
            if i1["m_lanczos"] != i2["m_lanczos"] or int(s2.nbr_overflow):
                ph.failed.append(f"sharded-small {tag}: m or overflow")
            if engine == "gather" and not torch.equal(s1.pos, s2.pos):
                ph.failed.append(f"sharded-small {tag}: not bitwise")
        u1, _ = integrator.mobility(cfg, pos, F, 0.05)
        u2, o2 = sharding.make_sharded_mobility(cfg, mesh)(pos, F, 0.05)
        ph.check(f"{engine}: sharded mobility vs one device (max abs / "
                 "scale)", float((u2 - u1).abs().max())
                 / float(u1.abs().max()), 1e-5)
        if int(o2) or (engine == "gather" and not torch.equal(u1, u2)):
            ph.failed.append(f"sharded-small {engine} mobility: overflow or "
                             "not bitwise")
    print(f"  [sharded-small] {time.perf_counter() - t0:.1f} s")


def phase_sharded_main(ph):
    """The sharded step at N=100k (blocked, gather; D = 4 on cuda:0):
    mobility against the one-device engine, then timed thermal steps with
    forces, and each device's bytes of pair data."""
    import torch

    import pse_tpu_torch as pse
    from pse_tpu_torch import integrator
    from pse_tpu_torch.parallel import sharding

    t0 = time.perf_counter()
    pos, L = make_positions(N, PHI, seed=0)
    F = torch.as_tensor(np.random.default_rng(1).normal(size=(N, 3))
                        .astype(np.float32), device="cuda")
    mesh = _cuda_mesh(4)
    out = {}
    for engine in ("blocked", "gather"):
        cfg = integrator.make_config(pse.make_params(xi=XI, error=ERROR, L=L),
                                     N, seed=SEED, engine=engine,
                                     device="cuda")
        print(f"[sharded-main] make_sharded_step N={N} engine={engine}, D=4 "
              "on cuda:0")
        u1, _ = integrator.mobility(cfg, pos, F)
        u2, o2 = sharding.make_sharded_mobility(cfg, mesh)(pos, F)
        ph.check(f"sharded-main {engine}: mobility vs one device (max abs / "
                 "scale)", float((u2 - u1).abs().max())
                 / float(u1.abs().max()), 1e-5)
        if int(o2):
            ph.failed.append(f"sharded-main {engine}: mobility overflow")
        del u1, u2
        eng = sharding.make_sharded_engine(cfg, mesh)
        ctx, _ = eng.prepare(torch.as_tensor(pos, device="cuda"),
                             integrator._box_of(cfg, 0.0), F)
        if engine == "blocked":
            nbytes = [b.numel() * b.element_size() for *_, b in ctx.parts]
        else:
            nbytes = [sum(t.numel() * t.element_size() for t in c)
                      for *_, c in ctx.parts]
        del ctx
        torch.cuda.empty_cache()
        run = sharding.make_sharded_step(cfg, mesh)
        st = integrator.make_state(pos, 0, 0.0, "cuda")
        st, _ = run(st, F, 1.0, DT, 0.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        ms_hist = []
        for _ in range(SHARDED_TIMED):
            st, info = run(st, F, 1.0, DT, 0.0)
            ms_hist.append(info["m_lanczos"])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1) / SHARDED_TIMED
        if int(st.nbr_overflow) or not bool(torch.isfinite(st.pos).all()):
            ph.failed.append(f"sharded-main {engine}: overflow or not finite")
        print(f"  {SHARDED_TIMED} steps: {ms:.3f} ms/step (host clock), m "
              f"{ms_hist}; each device's pair data "
              f"{[round(b / 1e6, 1) for b in nbytes]} MB; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        out[engine] = ms
        torch.cuda.empty_cache()
    print(f"  [sharded-main] {time.perf_counter() - t0:.1f} s")
    return out


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
    ("spread_col", "pse_tpu_torch/csrc/spread.cu",
     "pse_tpu/ops/column_farfield.py:417"),
    ("build_banded_blocks", "pse_tpu_torch/csrc/banded.cu",
     "pse_tpu/ops/banded_nearfield.py:733"),
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
    phase_forces_small(ph)
    phase_oracle(ph)
    phase_blocked_small(ph)
    phase_blocked_oracle(ph)
    phase_gather_small(ph)
    phase_gather_oracle(ph)
    phase_classes_small(ph)
    phase_halo_small(ph)
    phase_sharded_small(ph)
    sim, _, ms_b = phase_main(ph, forces=False)
    phase_profile(sim.run, ms_b, "brownian main-path")
    del sim
    simf, launches, ms_f = phase_main(ph, forces=True)
    phase_profile(simf.run, ms_f, "with-forces main-path")
    phase_mobility(ph, simf)
    launches["build_banded_blocks"] = phase_blocks(
        ph, simf)["build_banded_blocks"]
    sim, _, ms_cb = phase_main(ph, forces=False, classes=True)
    prof_cb = phase_profile(sim.run, ms_cb, "brownian main-classes")
    del sim
    simc, launches_c, ms_cf = phase_main(ph, forces=True, classes=True)
    prof_cf = phase_profile(simc.run, ms_cf, "with-forces main-classes")
    phase_classes_mobility(ph, simc)
    class_run = phase_classes_run(ph)
    sim, _, ms_bb = phase_main(ph, forces=False, engine="blocked")
    del sim
    simb, launches_b, ms_bf = phase_main(ph, forces=True, engine="blocked")
    phase_profile(simb.run, ms_bf, "with-forces blocked")
    phase_mobility(ph, simb, "blocked-mobility")
    sim, _, ms_gb = phase_main(ph, forces=False, engine="gather")
    prof_gb = phase_profile(sim.run, ms_gb, "brownian gather")
    del sim
    simg, launches_g, ms_gf = phase_main(ph, forces=True, engine="gather")
    prof_gf = phase_profile(simg.run, ms_gf, "with-forces gather")
    launches_h, ms_h, prof_h, slab_a, peak_h = phase_halo_main(ph)
    _, ms_h1m, prof_h1m, slab_a1m, peak_h1m = phase_halo_1m(ph)
    ms_sh = phase_sharded_main(ph)
    phase_sedimentation(ph)
    results = {name: {"err": [], "library_ms": None}
               for name, _, _ in KERNELS}
    phase_kernels(ph, simf, results, simb, simg)
    phase_timing(simf, results)
    phase_spread_1m(ph, results)
    phase_packed_timing(ph, simc, results)
    phase_blocked_timing(ph, simb, results, launches_b)
    phase_gather_timing(simg, results)

    line = []
    for name, src, replaces in KERNELS:
        r = results[name]
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["err"]) if r["err"] else None,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "launches_blocked": launches_b[name],
            "launches_gather": launches_g[name],
            "launches_classes": launches_c[name],
            "launches_halo": launches_h[name],
            **{k: r[k] for k in ("kernel_ms", "kernel_ms_1rhs",
                                 "bound_full_A_ms", "bin_columns_ms",
                                 "bin_particles_ms", "blocked_ms",
                                 "blocked_kernel_ms", "blocked_bound_ms",
                                 "blocked_plain_ms", "gather_ms",
                                 "gather_kernel_ms", "gather_bound_ms",
                                 "gather_plain_ms", "packed_ms",
                                 "packed_kernel_ms", "packed_single_ms",
                                 "packed_single_kernel_ms", "packed_bound_ms",
                                 "packed_a_bytes", "single_a_bytes",
                                 "live_a_bytes", "ms_1m", "plain_ms_1m",
                                 "bound_ms_1m") if k in r},
        })
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}), "
              f"launches {launches[name]}")
    print("blocked near field (build_pair_blocks, matvec_cells: "
          f"csrc/blocked.cu): {json.dumps(results['blocked'])}")
    print(f"gather engine (not kernels): {json.dumps(results['gather'])}")
    print(f"classes-run: {json.dumps(class_run)}")
    for name, n, ms, prof, a, peak in (
            ("halo-main", N, ms_h, prof_h, slab_a, peak_h),
            ("halo-1m", HALO_1M_N, ms_h1m, prof_h1m, slab_a1m, peak_h1m)):
        print(f"{name}: {ms:.3f} ms/step, {1e3 * n / ms:.6g} "
              f"particle-steps/s" + ("" if prof is None else
                                     f", device {prof['device_ms']:.3f} "
                                     f"ms/step, idle {100 * prof['idle']:.1f}"
                                     f" %, {prof['launches']:.1f} kernel "
                                     "launches per step")
              + f"; each slab's A {a / 1e6:.1f} MB; peak {peak / 1e9:.3f} GB")
    print("sharded-main: " + ", ".join(f"{k} {v:.3f} ms/step"
                                       for k, v in ms_sh.items()))
    for name, ms, prof in (("main-classes", ms_cb, prof_cb),
                           ("main-classes-forces", ms_cf, prof_cf),
                           ("gather", ms_gb, prof_gb),
                           ("gather-forces", ms_gf, prof_gf)):
        print(f"{name}: {ms:.3f} ms/step, {1e3 * N / ms:.6g} particle-steps/s"
              + ("" if prof is None else
                 f", device {prof['device_ms']:.3f} ms/step, idle "
                 f"{100 * prof['idle']:.1f} %, {prof['launches']:.1f} kernel "
                 "launches per step"))
    print(f"total {time.perf_counter() - t_start:.1f} s; main paths "
          f"{ms_b:.3f} ms/step (brownian), {ms_f:.3f} ms/step (with forces); "
          f"with classes {ms_cb:.3f} ms/step (brownian), {ms_cf:.3f} ms/step "
          f"(with forces); "
          f"blocked {ms_bb:.3f} ms/step (brownian), {ms_bf:.3f} ms/step "
          f"(with forces); gather {ms_gb:.3f} ms/step (brownian), "
          f"{ms_gf:.3f} ms/step (with forces)")
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
