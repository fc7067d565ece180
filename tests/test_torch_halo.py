"""The port's halo engine (pse_tpu_torch.parallel.halo) against the JAX
package's, and against the port's one-device banded engine.

The port runs D x-slabs over a mesh of torch devices in one process (here
``[torch.device("cpu")] * D``); the JAX side runs on the virtual CPU
devices that tests/conftest.py provisions.  Halo mobility and the thermal
step with JAX's draws injected, the fused two-RHS matvec, the guards,
``make_config(shard_slabs=D)``'s slab classes at N = 100k and
``compute_windows(col_mask=)``.  CPU only: the port's kernel wrappers run
their plain versions here (the card's halo is in test_torch_cuda.py).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

import pse_tpu as J                          # noqa: E402
from pse_tpu import integrator as ji         # noqa: E402
from pse_tpu.cellbins import bin_columns as j_bin_columns   # noqa: E402
from pse_tpu.ops import banded_nearfield as jb   # noqa: E402
from pse_tpu.ops import noise as jn          # noqa: E402
from pse_tpu.parallel import halo as jh      # noqa: E402
from pse_tpu.parallel import sharding as jsh  # noqa: E402

import pse_tpu_torch as P                    # noqa: E402
from pse_tpu_torch import integrator as pi   # noqa: E402
from pse_tpu_torch.cellbins import bin_columns as t_bin_columns  # noqa: E402
from pse_tpu_torch.ops import banded_nearfield as tb   # noqa: E402
from pse_tpu_torch.parallel import halo as th          # noqa: E402
from pse_tpu_torch.parallel import sharding as tsh     # noqa: E402

N, L = 4_800, 33.0          # tests/test_halo.py's box: 4 slabs of one layer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _problem(seed, slabs=4, thermal=False, **kw):
    """(JAX config, the port's, positions, forces) at N = 4800, L = 33."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-L / 2, L / 2, size=(N, 3)).astype(np.float32)
    forces = rng.normal(size=(N, 3)).astype(np.float32)
    jcfg = ji.make_config(J.make_params(xi=0.5, error=1e-3, L=L), N,
                          thermal=thermal, seed=5, engine="banded",
                          shard_slabs=slabs, **kw)
    tcfg = pi.make_config(P.make_params(xi=0.5, error=1e-3, L=L), N,
                          thermal=thermal, seed=5, engine="banded",
                          shard_slabs=slabs, device="cpu", **kw)
    assert tcfg.engine == jcfg.engine == "banded"
    assert tcfg.band_spec == jcfg.band_spec
    assert tcfg.band_spec.bins.n_cells[0] % slabs == 0
    return jcfg, tcfg, pos, forces


def _mesh(d):
    return tsh.make_mesh([torch.device("cpu")] * d)


def _jax_mesh(d=4):
    return jsh.make_mesh(jax.devices("cpu")[:d])


def test_halo_mobility_matches_jax_at_four_slabs():
    """D = 4 one-layer slabs (every slab a seam neighbour): the port's halo
    mobility within 2e-5 of pse_tpu's halo on 4 JAX CPU devices, float32
    blocks."""
    jcfg, tcfg, pos, forces = _problem(1, block_dtype="float32")
    ju, jov = jh.make_halo_mobility(jcfg, _jax_mesh())(pos, forces)
    tu, tov = th.make_halo_mobility(tcfg, _mesh(4))(pos, forces)
    assert int(tov) == 0 and not bool(jov)
    assert _rel(tu.numpy(), ju) < 2e-5


@pytest.mark.parametrize("slabs", [1, 2])
def test_halo_mobility_matches_one_device(slabs):
    """D = 1 (both halos the seam's) and D = 2: within 2e-5 of the port's
    one-device mobility on the same config."""
    _, tcfg, pos, forces = _problem(1, slabs=slabs, block_dtype="float32")
    u, ov = th.make_halo_mobility(tcfg, _mesh(slabs))(pos, forces, 0.3)
    u1, ov1 = pi.mobility(tcfg, pos, forces, 0.3)
    assert int(ov) == int(ov1) == 0
    assert _rel(u.numpy(), u1.numpy()) < 2e-5


def _jax_draws(cfg, step):
    """The uniforms pse_tpu's banded step draws (integrator.step_impl)."""
    key = jax.random.fold_in(jax.random.PRNGKey(ji.hash_seed(cfg.seed)),
                             jnp.asarray(step, jnp.int32))
    k_psi, k_grid = jax.random.split(key)
    bs, p = cfg.band_spec.bins, cfg.params
    psi = jn.particle_noise_t(k_psi, (bs.n_cells[0] * bs.n_cells[1], bs.cap))
    wave = jax.random.uniform(k_grid, (6, p.Nx, p.Ny, p.Nz // 2 + 1),
                              dtype=jnp.float32, minval=-jn.SQRT3D2,
                              maxval=jn.SQRT3D2)
    return np.asarray(psi), np.asarray(wave)


def test_halo_thermal_step_matches_jax():
    """The thermal step with forces at D = 4 (bf16 blocks), JAX's draws
    injected: equal m_lanczos, displacements within 5e-3 of pse_tpu's halo
    step (tests/test_halo.py's tolerance)."""
    jcfg, tcfg, pos, forces = _problem(2, thermal=True)
    jmesh = _jax_mesh()
    js = jsh.shard_state(ji.make_state(pos), jmesh)
    jf = jax.device_put(jnp.asarray(forces), jsh.particle_sharding(jmesh))
    jnew, _ = jh.make_halo_step(jcfg, jmesh)(js, jf, 1.0, 1e-3, 0.1,
                                             new_tilt=0.01)
    ts = tsh.shard_state(pi.make_state(pos, device="cpu"), _mesh(4))
    tnew, tinfo = th.make_halo_step(tcfg, _mesh(4))(
        ts, torch.from_numpy(forces), 1.0, 1e-3, 0.1, new_tilt=0.01,
        uniforms=_jax_draws(jcfg, 0))
    assert int(tnew.nbr_overflow) == int(jnew.nbr_overflow) == 0
    assert tnew.m_lanczos == int(jnew.m_lanczos)
    dj = np.asarray(jnew.pos, np.float64) - pos
    dt = tnew.pos.numpy().astype(np.float64) - pos
    assert np.linalg.norm(dt - dj) / np.linalg.norm(dj) < 5e-3
    assert tnew.tilt_xy == float(jnew.tilt_xy) and tnew.step == 1


def test_halo_mreal_t2_matches_two_singles():
    """The fused two-RHS matvec (6 rows through exchange_x and the
    interior slice) equals two single matvecs on the port."""
    _, tcfg, pos, forces = _problem(3, thermal=True)
    eng = th.make_halo_engine(tcfg, _mesh(4))
    ctx, ovf = eng.prepare(torch.from_numpy(pos), P.make_box(L, 0.0))
    assert int(ovf) == 0
    fa = eng.f_slots_t(ctx, torch.from_numpy(forces))
    fb = eng.f_slots_t(ctx, torch.from_numpy(forces[::-1].copy()))
    u2 = eng.mreal_t2(ctx, torch.cat([fa, fb]))
    assert _rel(u2[0:3].numpy(), eng.mreal_t(ctx, fa).numpy()) < 1e-6
    assert _rel(u2[3:6].numpy(), eng.mreal_t(ctx, fb).numpy()) < 1e-6


def test_halo_engine_guards():
    """A gather config and a mesh size that does not divide ncx raise
    ValueError, as in pse_tpu."""
    tp = P.make_params(xi=0.5, error=1e-3, L=24.0)
    cfg = pi.make_config(tp, 128, engine="gather", device="cpu")
    with pytest.raises(ValueError, match="banded"):
        th.make_halo_engine(cfg, _mesh(4))
    _, tcfg, _, _ = _problem(1, slabs=1)          # ncx = 4
    with pytest.raises(ValueError, match="divisible"):
        th.make_halo_engine(tcfg, _mesh(3))
    with pytest.raises(ValueError, match="divisible"):
        jh.make_halo_engine(ji.make_config(
            J.make_params(xi=0.5, error=1e-3, L=L), N, engine="banded"),
            _jax_mesh(3))


def _bench_lattice(n=100_000, phi=0.45, seed=0):
    """bench.py's make_positions: a vacancy-diluted simple-cubic lattice."""
    L_ = (n * (4.0 / 3.0) * math.pi / phi) ** (1.0 / 3.0)
    n_side = int(math.ceil(n ** (1.0 / 3.0)))
    a = L_ / n_side
    grid = (np.arange(n_side) + 0.5) * a - L_ / 2.0
    x, y, z = np.meshgrid(grid, grid, grid, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    rng = np.random.default_rng(seed)
    pos = pos[np.sort(rng.choice(pos.shape[0], size=n, replace=False))]
    pos += rng.normal(scale=0.05 * a, size=pos.shape)
    return pos.astype(np.float32), L_


@pytest.mark.parametrize("slabs", [2, 4])
def test_slab_classes_match_jax_and_fit_every_slab(slabs):
    """make_config(shard_slabs=D, positions=) at N = 100k, from relaxed
    (uniform) positions and from bench.py's lattice: pse_tpu's band_spec
    field by field, no one-device classes at D > 1, and (where the slab
    classes form) a numpy emulation of class_assignment fits on every
    slab (tests/test_halo.py's check)."""
    n = 100_000
    lattice, L_ = _bench_lattice(n)
    uniform = np.random.default_rng(11).uniform(
        -L_ / 2, L_ / 2, size=(n, 3)).astype(np.float32)
    jp = J.make_params(xi=0.5, error=1e-3, L=L_)
    tp = P.make_params(xi=0.5, error=1e-3, L=L_)
    for positions in (uniform, lattice, None):
        jc = ji.make_config(jp, n, engine="banded", shard_slabs=slabs,
                            positions=positions)
        tc = pi.make_config(tp, n, engine="banded", shard_slabs=slabs,
                            positions=positions, device="cpu")
        assert tc.engine == jc.engine == "banded"
        assert tc.band_spec._fields == jc.band_spec._fields
        for f in jc.band_spec._fields:
            assert getattr(tc.band_spec, f) == getattr(jc.band_spec, f), f
        assert tc.band_spec.classes is None
    bs = pi.make_config(tp, n, engine="banded", shard_slabs=slabs,
                        positions=uniform, device="cpu").band_spec
    assert bs.slab_classes is not None
    ncx, ncy, _ = bs.bins.n_cells
    nxl = ncx // slabs
    loc = bs._replace(bins=bs.bins._replace(n_cells=(nxl + 2, ncy, 1)),
                      classes=bs.slab_classes, slab_classes=None)
    assert sum(c for _, c in bs.slab_classes) == (nxl + 2) * ncy
    counts = tb.measure_col_counts(bs, uniform, tp.L)
    for need_counts in tb.make_slab_counts(bs, slabs, counts):
        need = -(-np.maximum(need_counts, 1) // bs.rows)
        need_desc = np.sort(need)[::-1]
        for tk, ck, off in tb.class_segments(loc):
            assert need_desc[off] <= tk


def test_compute_windows_col_mask_matches_jax():
    """compute_windows(col_mask=) equals pse_tpu's: windows and counts
    whatever the mask, the band overflow only from masked-in columns
    (a 128-lane window overflows 8 of the 24 columns here); col_mask=None is
    bitwise an all-true mask."""
    jcfg, tcfg, pos, _ = _problem(4, slabs=1)
    bs = tcfg.band_spec._replace(window=128)
    jbs = jcfg.band_spec._replace(window=128)
    tbox, jbox = P.make_box(L, 0.2), J.make_box(L, 0.2)
    tbins = t_bin_columns(torch.from_numpy(pos), tbox, bs.bins)
    jbins = j_bin_columns(jnp.asarray(pos), jbox, jbs.bins)
    C = bs.bins.n_cells_total
    # per column: does its band overflow the 128-lane window?
    over = np.array([bool(tb.compute_windows(
        tbins, bs, tbox, tcfg.params.ewald_cut,
        col_mask=torch.arange(C) == c)[2]) for c in range(C)])
    assert over.any() and not over.all()
    masks = (np.ones(C, bool), ~over, over & (np.arange(C) == over.argmax()),
             np.arange(C) % 6 < 3)
    for mask in masks:
        tout = tb.compute_windows(tbins, bs, tbox, tcfg.params.ewald_cut,
                                  col_mask=torch.from_numpy(mask))
        jout = jb.compute_windows(jbins, jbs, jbox, jcfg.params.ewald_cut,
                                  col_mask=jnp.asarray(mask))
        for t, j in zip(tout, jout):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert bool(tout[2]) == bool(over[mask].any())
    plain = tb.compute_windows(tbins, bs, tbox, tcfg.params.ewald_cut)
    for a, b in zip(plain, tb.compute_windows(
            tbins, bs, tbox, tcfg.params.ewald_cut,
            col_mask=torch.ones(C, dtype=torch.bool))):
        assert torch.equal(a, b)
