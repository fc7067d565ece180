"""The check that decides ``correct``: one step of the measured window,
held against the float64 reference.

The window keeps one step's input and output state (a one-step chunk at a
point drawn from the seed).  The step's draws are random numbers the
program takes from a generator keyed by its seed and the step number, so
``draws`` reads them again through the program's documented hooks
(``integrator.step_generator``, the engine's ``slots_of_psi`` and
``psi_result_to_particles``, in the order ``integrator.step`` draws them)
and proves it by replaying the step with those draws through
``integrator.step(..., uniforms=...)``: the replay has to land where the
window's step did.  Then the program is freed, and ``judge`` computes the
reference's displacement of that step from the step's input positions,
draws and forces alone, and compares:

* ``gap``: |dx - dx_ref|_2 / |dx_ref|_2 over the compared particles (all,
  or a sample drawn from the seed where the mix caps ``check_rows``);
* ``near_gap``: the same for the step replayed with its wave-space draw
  set to zero, against the reference's M F and near-field Brownian
  parts: the near field and the Lanczos square root without the wave
  space's own approximation error, which dominates ``gap``;
* ``largest_move``: the largest displacement of any particle, over the
  reference's rms displacement (a particle thrown away shows here);
* ``replay``: the replay's largest distance from the window's output,
  over the same rms (a misread draw shows here);
* ``draws``: how far the draws' variances are from the uniform
  distributions they are drawn from (psi: 1; each wave part: 1/2), or
  infinite if a draw lies outside its range;
* ``psi_map``: the particles' psi, as the program's slot-to-particle
  mapping hands it to the reference, against the draws of the occupied
  slots, as sets of rows: the rows duplicated, the rows drawn in no
  occupied slot, and the difference of the two counts.  Nought means each
  particle got a draw of its own, so the reference's psi is a sample of
  independent draws whatever the mapping; ``gap`` then holds the program's
  step to the reference on that very sample.  A mapping that the step
  and ``psi_result_to_particles`` share need not be trusted.

The draw order (the wave draw, then psi, from ``step_generator``) is the
program's; a program that draws otherwise has to keep the hooks above
consistent with its step, or ``replay`` fails.
"""

from __future__ import annotations

import math

import torch

from portbench import reference

SQRT3 = math.sqrt(3.0)
SQRT3D2 = math.sqrt(1.5)


def draws(config, pre, forces, kT: float, dt: float, grid):
    """(psi (N, 3), raw wave draw (6, Nx, Ny, Nz//2+1), the replayed
    step's positions, the displacement of the step replayed with a zero
    wave draw, ``psi_map``) of the step that starts from ``pre``; all but
    the positions are None for an athermal step."""
    from pse_tpu_torch import integrator
    from pse_tpu_torch.box import make_box

    if not config.thermal:
        new, _ = integrator.step(config, pre, forces, kT, dt, 0.0, None)
        return None, None, new.pos, None, None
    eng = integrator.engine_of(config)
    box = make_box(config.params.L, pre.tilt_xy)
    f = None
    if config.has_forces:
        f = torch.zeros_like(pre.pos) if forces is None else forces
    ctx, _ = eng.prepare(pre.pos, box, f)
    gen = integrator.step_generator(config, pre.step)
    Nx, Ny, Nz = grid
    lo, hi = -SQRT3D2, SQRT3D2
    wave = torch.rand((6, Nx, Ny, Nz // 2 + 1), generator=gen,
                      device=pre.pos.device, dtype=torch.float32)
    wave = wave * (hi - lo) + lo
    psi_slots = eng.slots_of_psi(ctx, gen, None)
    psi = eng.psi_result_to_particles(ctx, psi_slots)
    faults = mapping_faults(psi, psi_slots)
    del ctx
    new, _ = integrator.step(config, pre, forces, kT, dt, 0.0, None,
                             uniforms=(psi_slots, wave))
    near, _ = integrator.step(config, pre, forces, kT, dt, 0.0, None,
                              uniforms=(psi_slots, torch.zeros_like(wave)))
    return psi, wave, new.pos, displacement(
        pre.pos, pre.images, near.pos, near.images, config.params.L[0]), faults


def mapping_faults(psi, psi_slots) -> int:
    """Rows of ``psi`` (N, 3) that are not the draws of N distinct occupied
    slots of ``psi_slots`` (3, ...), zero in empty slots: duplicated rows,
    rows found in no occupied slot, and the difference of the counts."""
    rows = psi_slots.reshape(3, -1).t()
    live = rows[(rows != 0).any(1)]
    psi = psi.to(live.dtype)
    n_live = torch.unique(live, dim=0).shape[0]
    dup = psi.shape[0] - torch.unique(psi, dim=0).shape[0]
    stray = torch.unique(torch.cat([live, psi]), dim=0).shape[0] - n_live
    return int(dup + stray + abs(live.shape[0] - psi.shape[0]))


def compared_rows(n: int, cap, seed: int, device):
    """All rows, or ``cap`` of them drawn from the seed."""
    if cap is None or cap >= n:
        return torch.arange(n, device=device)
    g = torch.Generator().manual_seed(int(seed) + 2)
    return torch.sort(torch.randperm(n, generator=g)[:cap]).values.to(device)


def displacement(pre_pos, pre_img, post_pos, post_img, L: float):
    """The step's unwrapped displacement in float64 (an untilted box)."""
    return ((post_pos.double() - pre_pos.double())
            + (post_img - pre_img).double() * L)


def judge(pre_pos, d_prog, d_near, replay_pos, post_pos, psi, wave, forces,
          psi_map, cfg: dict, traffic: dict, limits: dict, seed: int,
          lower=False):
    """The compared numbers, each with its limit.  ``d_near`` is the
    displacement of the step replayed with a zero wave draw (None for an
    athermal step).  ``lower=True`` puts the reference at the precision one
    step below the configuration's ``precision`` (the control) in the
    program's place: ``d_prog`` and ``d_near`` are then ignored."""
    L = (cfg["n"] * 4.0 / 3.0 * math.pi / cfg["phi"]) ** (1.0 / 3.0)
    p = reference.derive(cfg["xi"], cfg["error"], (L, L, L))
    n = pre_pos.shape[0]
    rows = compared_rows(n, traffic.get("check_rows"), seed, pre_pos.device)
    kT, dt = traffic["kT"], cfg["dt"]
    det, near_th, wave_th = reference.step_parts(pre_pos, psi, wave, forces,
                                                 kT, dt, p, rows)
    ref, ref_near = det + near_th + wave_th, det + near_th
    if lower:
        c = reference.step_parts(
            pre_pos, psi, wave, forces, kT, dt, p, rows,
            lower=reference.control_precision(cfg["precision"]))
        d_prog = torch.zeros((n, 3), dtype=torch.float64,
                             device=pre_pos.device)
        d_prog[rows] = c[0] + c[1] + c[2]
        d_near = None if psi is None else d_prog.clone()
        if d_near is not None:
            d_near[rows] = c[0] + c[1]
        replay_pos = post_pos
    rms = float(torch.linalg.vector_norm(ref)) / math.sqrt(ref.numel())
    out = {}
    if psi is not None:
        v = max(abs(float(psi.double().var()) - 1.0),
                abs(float(wave.double().var()) / 0.5 - 1.0))
        # (float32 rounding may carry a draw a few ulps past its bound)
        if float(psi.abs().max()) > SQRT3 * (1 + 1e-6) or \
                float(wave.abs().max()) > SQRT3D2 * (1 + 1e-6):
            v = math.inf
        out["draws"] = v
        out["psi_map"] = psi_map
    out["replay"] = float((replay_pos.double() - post_pos.double()).abs()
                          .max()) / rms
    out["largest_move"] = (float(d_prog.abs().max()) / rms
                           if torch.isfinite(d_prog).all() else math.inf)
    out["gap"] = _rel(d_prog[rows], ref)
    if d_near is not None:
        out["near_gap"] = _rel(d_near[rows], ref_near)
    return {k: {"value": v, "limit": limits[k]["limit"]}
            for k, v in out.items()}


def _rel(x, ref) -> float:
    """|x - ref|_2 / |ref|_2, infinite where not finite."""
    v = float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))
    return v if math.isfinite(v) else math.inf
