"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
neither jax nor pse_tpu, so it runs on a machine that has only the port's
dependencies; the repository's conftest imports jax, so run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Sizes are small (the banded test config, N = 1080 in L = 24, and N = 5300
in L = 40); chip_smoke.py holds the kernels at the main path's shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pse_tpu_torch import integrator as pi              # noqa: E402
from pse_tpu_torch import make_box, make_params         # noqa: E402
from pse_tpu_torch.cellbins import (                    # noqa: E402
    bin_columns, bin_particles, fill_cells, fill_cells_reference,
    fill_operands, vec_to_cells)
from pse_tpu_torch.ops import banded_nearfield as bdn   # noqa: E402
from pse_tpu_torch.ops import column_farfield as cff    # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _rel(a, b):
    """||a - b|| / ||b||: at these small sizes the max-norm residual of
    bf16 coefficients is one element's rounding (~2^-9), so the banded
    bounds are held in the 2-norm (chip_smoke.py holds the max-norm ones
    at the main path's shapes)."""
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _setup(n, L, tilt, seed=0):
    params = make_params(xi=0.5, error=1e-3, L=L)
    cfg = pi.make_config(params, n, engine="banded", has_forces=False,
                         device="cuda")
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(
        rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32),
        device="cuda")
    return cfg, pos, make_box(L, tilt)


@pytest.mark.parametrize("columns", [True, False])
def test_fill_kernel_is_bitwise_the_plain_version(cuda, columns):
    cfg, pos, box = _setup(5300, 40.0, 0.2)
    spec = cfg.band_spec.bins if columns else cfg.colff_spec.bins
    ops = fill_operands(pos, box, spec, columns)
    vals = torch.randn((3, pos.shape[0]), device=cuda)
    for a, b in zip(fill_cells(*ops, spec.cap, vals),
                    fill_cells_reference(*ops, spec.cap, vals)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5),
                                         ("bfloat16", 2e-3)])
@pytest.mark.parametrize("n,L,tilt,window", [
    (1080, 24.0, 0.0, None), (5300, 40.0, 0.3, None),
    (5300, 40.0, 0.1, 192), (5300, 40.0, 0.0, 256)])
def test_banded_kernels_match_plain_version(cuda, dtype, bound, n, L, tilt,
                                            window):
    """build_mv and matvec against the unrounded float32 plain version,
    at the default window and the grown ones (W = 192, 256)."""
    cfg, pos, box = _setup(n, L, tilt)
    p = cfg.params
    bs = cfg.band_spec._replace(block_dtype=dtype)
    if window is not None:
        bs = bs._replace(window=window)
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, ovf, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    assert not bool(ovf)
    f = vec_to_cells(bins, bs.bins, torch.randn(pos.shape, device=cuda))
    args = (bins, tilt, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    ref = bdn.matvec_banded_reference(*args[:9], f, p.self_mobility)
    blocks, u_b = bdn.build_mv_banded(*args, f, p.self_mobility)
    u_m = bdn.matvec_banded(blocks, *args, f, p.self_mobility)
    assert _rel(u_b, ref) < bound
    assert _rel(u_m, ref) < bound
    # the build's in-register coefficients are the stored ones
    assert _rel_max(u_b, u_m) < 1e-6


def test_banded_kernels_at_16_rows(cuda):
    """grow_config halves the row tile when W cannot widen."""
    cfg, pos, box = _setup(5300, 40.0, 0.05)
    cfg = pi.grow_config(pi.grow_config(pi.grow_config(
        cfg, flags=pi.OVF_BAND), flags=pi.OVF_BAND), flags=pi.OVF_BAND)
    bs, p = cfg.band_spec._replace(block_dtype="float32"), cfg.params
    assert bs.rows == 16
    bins = bin_columns(pos, box, bs.bins)
    j0, nv, _, zsh = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    f = vec_to_cells(bins, bs.bins, torch.randn(pos.shape, device=cuda))
    args = (bins, 0.05, bs, cfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    ref = bdn.matvec_banded_reference(*args[:9], f, p.self_mobility)
    _, u = bdn.build_mv_banded(*args, f, p.self_mobility)
    assert _rel_max(u, ref) < 1e-5


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5),
                                         ("bfloat16", 5e-3)])
def test_contract_kernel_matches_plain_version(cuda, dtype, bound):
    cfg, pos, box = _setup(5300, 40.0, 0.25)
    p = cfg.params
    spec = cfg.colff_spec._replace(weight_dtype=dtype)
    fac = cff.build_col_factors(bin_particles(pos, box, spec.bins), box,
                                spec, p)
    grid = torch.randn((3, p.Nx, p.Ny, p.Nz), device=cuda)
    got = cff.contract_col_kernel(grid, spec, p, fac)
    want = cff.contract_col(grid, spec, p, fac)
    assert _rel_max(got, want) < bound


def test_step_on_card_matches_cpu_step(cuda):
    """The whole step, float32 blocks and factors, card vs CPU."""
    n, L = 1080, 24.0
    params = make_params(xi=0.5, error=1e-3, L=L)
    gpu = pi.make_config(params, n, engine="banded", has_forces=False,
                         block_dtype="float32", ff_weight_dtype="float32",
                         device="cuda")
    cpu = pi.make_config(params, n, engine="banded", has_forces=False,
                         block_dtype="float32", device="cpu")
    rng = np.random.default_rng(3)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    bs, p = cpu.band_spec.bins, params
    draws = (rng.uniform(-1.7, 1.7, (3, bs.n_cells[0] * bs.n_cells[1],
                                     bs.cap)).astype(np.float32),
             rng.uniform(-1.2, 1.2, (6, p.Nx, p.Ny, p.Nz // 2 + 1)
                         ).astype(np.float32))
    _, ic = pi.step(cpu, pi.make_state(pos, device="cpu"), 1.0, 1e-3, 0.3,
                    uniforms=draws)
    _, ig = pi.step(gpu, pi.make_state(pos, device="cuda"), 1.0, 1e-3, 0.3,
                    uniforms=draws)
    assert ig["m_lanczos"] == ic["m_lanczos"]
    assert _rel_max(ig["velocities"].cpu(), ic["velocities"]) < 1e-4
