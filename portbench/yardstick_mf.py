"""The yardstick of the deterministic M F path's kernels: the least bytes
one spread of forces onto the grid (``csrc/spread.cu``'s launch) and one
banded ``build_mv`` (``csrc/banded.cu``: the build, then the matvec on
the A it wrote) must move, each byte counted once, padding left out.

The spread's sizes are the program's FFT grid (``params.make_params``)
for the xi and error of the configuration the window ran, found among
``portbench/configs/*.json`` by its N and box length; the build_mv's
come from the window's ``nf_bytes`` (``yardstick.nf_application_bytes``:
A's live tiles, f and u).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

from portbench.run import box_length

HERE = Path(__file__).resolve().parent


def config_of(n: int, L: float):
    """A configuration file's dict whose N and box length are the
    window's, or None unless some are and all of those state one xi and
    one error (two deployments of one suspension share its grid)."""
    found = []
    for path in sorted((HERE / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        if cfg.get("n") == n and math.isclose(box_length(cfg), L,
                                              rel_tol=1e-12):
            found.append(cfg)
    if len({(cfg["xi"], cfg["error"]) for cfg in found}) != 1:
        return None
    return found[0]


def spread_bytes(n: int, L: float, xi: float, error: float) -> float:
    """Least bytes of one spread of forces for N particles in a cube of
    side L: each particle's force and coordinates (3 + 3 float32) read,
    and the force grid (3 Nx Ny Nz float32) written once.  The kernel's
    own layout writes more (the 9-fold overlapping window moments, 27 Nx
    Ny Nz floats, which torch then adds onto the grid); those bytes are a
    cost of that layout, not of the spread, and are not counted."""
    from pse_tpu_torch.params import make_params

    p = make_params(xi=xi, error=error, L=L)
    return n * (3 + 3) * 4 + 3 * p.Nx * p.Ny * p.Nz * 4


def spread_bytes_of(win):
    """``spread_bytes`` at the window's configuration, or None."""
    cfg = config_of(win.n, win.L)
    if cfg is None:
        return None
    return spread_bytes(win.n, win.L, cfg["xi"], cfg["error"])


def build_mv_bytes(nf_bytes: float, n: int, nrhs: float) -> float:
    """Least bytes of one banded build_mv at ``nrhs`` right-hand sides: A's
    live tiles written by the build and read once by the matvec, f read and
    u written (N x 3 float32 each, per right-hand side).  ``nf_bytes``: one
    application at one right-hand side (A's live tiles, f and u)."""
    a = nf_bytes - 2 * n * 3 * 4
    return 2 * a + 2 * nrhs * n * 3 * 4
