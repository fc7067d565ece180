"""The port's small public helpers against the JAX package, on the CPU:
``cellbins.choose_cap`` / ``to_cells`` / ``from_cells``, ``Box.hi`` /
``volume`` / ``with_tilt`` and ``make_box(dtype=)``, ``noise.particle_noise``
and the full-spectrum ``noise.wave_space_noise_hat`` (on injected uniforms:
jax's threefry bits cannot be reproduced in torch)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

import pse_tpu as J                          # noqa: E402
from pse_tpu import box as jbox              # noqa: E402
from pse_tpu import cellbins as jcb          # noqa: E402
from pse_tpu.ops import noise as jn          # noqa: E402

import pse_tpu_torch as P                    # noqa: E402
from pse_tpu_torch import box as tbox        # noqa: E402
from pse_tpu_torch import cellbins as tcb    # noqa: E402
from pse_tpu_torch.ops import noise as tn    # noqa: E402
from pse_tpu_torch.params import gridk_arrays   # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mu,multiple,sigmas", [
    (0.0, 8, 5.0), (0.4, 8, 5.0), (12.7, 8, 5.0), (463.0, 32, 4.0),
    (90.0, 16, 3.0)])
def test_choose_cap_matches_jax(mu, multiple, sigmas):
    assert tcb.choose_cap(mu, multiple, sigmas) == jcb.choose_cap(
        mu, multiple, sigmas)


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_to_and_from_cells_match_jax(tilt):
    """Per-particle values into the (C, cap) layout of bin_particles and
    back, with a fill value in the empty slots, as in the JAX package."""
    rng = np.random.default_rng(4)
    n, L = 700, 20.0
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    vals = rng.normal(size=n).astype(np.float32)
    jspec = jcb.BinSpec(n_cells=(5, 5, 5), cap=24)
    tspec = tcb.BinSpec(n_cells=(5, 5, 5), cap=24)
    jbins = jcb.bin_particles(jnp.asarray(pos), jbox.make_box(L, tilt), jspec)
    tbins = tcb.bin_particles(torch.as_tensor(pos), tbox.make_box(L, tilt),
                              tspec)
    assert not bool(jbins.overflow) and not bool(tbins.overflow)
    want = np.asarray(jcb.to_cells(jbins, jspec, jnp.asarray(vals), -7.0))
    got = tcb.to_cells(tbins, tspec, torch.as_tensor(vals), -7.0)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tcb.from_cells(tbins, tspec, got)
    np.testing.assert_array_equal(back.numpy(), vals)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcb.from_cells(jbins, jspec,
                                                jnp.asarray(want))))


@pytest.mark.parametrize("L", [24.0, (20.0, 31.5, 17.25)])
def test_box_helpers_match_jax(L):
    jb = jbox.make_box(L, 0.1)
    tb = tbox.make_box(L, 0.1)
    np.testing.assert_array_equal(np.asarray(tb.hi, np.float32),
                                  np.asarray(jb.hi))
    assert tb.volume == pytest.approx(float(jb.volume), rel=1e-6)
    jt, tt = jb.with_tilt(0.37), tb.with_tilt(0.37)
    assert tt.L == tb.L and tt.tilt_xy == float(jt.tilt_xy)
    j64 = jbox.make_box(L, 1.0 / 3.0, dtype=jnp.float32)
    assert tbox.make_box(L, 1.0 / 3.0, dtype=torch.float32).tilt_xy == float(
        j64.tilt_xy)
    # float64 keeps the lengths and tilt unrounded
    b64 = tbox.make_box(L, 1.0 / 3.0, dtype=torch.float64)
    assert b64.tilt_xy == 1.0 / 3.0
    assert b64.L == ((L,) * 3 if np.isscalar(L) else tuple(L))
    assert P.make_box(L, 0.1) == tb


def test_particle_noise_matches_jax_on_its_uniforms():
    """particle_noise (N, 3): U(-sqrt 3, sqrt 3), the JAX draw passed
    through unchanged; a generator draw has the same range and unit
    variance and reruns bitwise."""
    key = jax.random.PRNGKey(3)
    want = np.asarray(jn.particle_noise(key, 5000))
    got = tn.particle_noise(5000, "cpu", uniforms=want)
    np.testing.assert_array_equal(got.numpy(), want)
    g = torch.Generator().manual_seed(2)
    a = tn.particle_noise(5000, "cpu", generator=g)
    b = tn.particle_noise(5000, "cpu",
                          generator=torch.Generator().manual_seed(2))
    assert a.shape == (5000, 3) and torch.equal(a, b)
    assert float(a.abs().max()) <= np.sqrt(3.0)
    assert abs(float(a.var()) - 1.0) < 0.05


@pytest.mark.parametrize("L,tilt", [(12.0, 0.0), ((12.0, 13.0, 14.0), 0.2),
                                    (15.0, 0.3)])
def test_full_spectrum_wave_noise_matches_jax(L, tilt):
    """wave_space_noise_hat (3, Nx, Ny, Nz) on the JAX package's own
    uniforms (its key's draw), on even (12^3), mixed (12 x 15 x 15) and odd
    (15^3) grids, untilted and tilted."""
    params = J.make_params(xi=0.5, error=1e-3, L=L)
    tparams = P.make_params(xi=0.5, error=1e-3, L=L)
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    assert (tparams.Nx, tparams.Ny, tparams.Nz) == (Nx, Ny, Nz)
    key = jax.random.PRNGKey(7)
    from pse_tpu.params import gridk_arrays as jgridk

    jk, jW = jgridk(params, tilt)
    want = np.asarray(jn.wave_space_noise_hat(key, params, jk, jW, 1.0, 1e-3))
    u = np.asarray(jax.random.uniform(key, (6, Nx, Ny, Nz), jnp.float32,
                                      -jn.SQRT3D2, jn.SQRT3D2))
    tk, tW = gridk_arrays(tparams, float(np.float32(tilt)), "cpu")
    got = tn.wave_space_noise_hat(tparams, tk, tW, 1.0, 1e-3, uniforms=u)
    assert got.shape == (3, Nx, Ny, Nz) and got.dtype == torch.complex64
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale)
    assert float(got[:, 0, 0, 0].abs().max()) == 0.0       # k = 0
