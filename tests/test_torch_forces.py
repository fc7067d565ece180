"""The PyTorch port's with-forces slice against the JAX package.

The spread and the Green's function, ``mobility()``, the thermal step with
forces (JAX's own draws injected), the athermal step, the float64 oracle of
``tests/data/oracle_gate.npz``, the plain build of the banded coefficients,
and ``Simulation`` with a ``force_fn``.  The same numpy inputs go through
both packages on the CPU, where the port's kernel wrappers run their plain
PyTorch versions.  Configuration: N = 1080 in L = 24 (3 x 4 near-field
columns, cap 160, W = 128; 27^3 grid, 3 x 3 far-field columns).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                   # noqa: E402
import jax.numpy as jnp                      # noqa: E402

import pse_tpu as J                          # noqa: E402
from pse_tpu import cellbins as jc           # noqa: E402
from pse_tpu import integrator as ji         # noqa: E402
from pse_tpu import params as jparams        # noqa: E402
from pse_tpu.ops import column_farfield as jf    # noqa: E402
from pse_tpu.ops import farfield as jff      # noqa: E402
from pse_tpu.ops import noise as jn          # noqa: E402

import pse_tpu_torch as P                    # noqa: E402
from pse_tpu_torch import cellbins as pc     # noqa: E402
from pse_tpu_torch import integrator as pi   # noqa: E402
from pse_tpu_torch import params as pparams  # noqa: E402
from pse_tpu_torch.ops import banded_nearfield as pb   # noqa: E402
from pse_tpu_torch.ops import column_farfield as pf    # noqa: E402
from pse_tpu_torch.ops.farfield import apply_green     # noqa: E402

ORACLE = pathlib.Path(__file__).resolve().parent / "data" / "oracle_gate.npz"
N, L = 1080, 24.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(a).astype(np.complex128).ravel()
    b = np.asarray(b).astype(np.complex128).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _positions(seed, n=N):
    rng = np.random.default_rng(seed)
    return rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)


def _forces(seed, n=N):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def _configs(thermal=True, seed=5):
    """JAX and port configs of the with-forces banded step."""
    jp = J.make_params(xi=0.5, error=1e-3, L=L)
    tp = P.make_params(xi=0.5, error=1e-3, L=L)
    return (ji.make_config(jp, N, thermal=thermal, engine="banded",
                           has_forces=True, seed=seed),
            pi.make_config(tp, N, thermal=thermal, engine="banded",
                           has_forces=True, seed=seed, device="cpu"))


def _far_operands(jcfg, tcfg, tilt, dtype, seed=7):
    """Binned far-field slots, factors in ``dtype`` and slot forces of both
    packages, and the port's node-space coordinates of the slots."""
    jspec = jcfg.colff_spec._replace(weight_dtype=dtype)
    tspec = tcfg.colff_spec._replace(weight_dtype=dtype)
    pos, forces = _positions(seed), _forces(seed + 1)
    jbox, tbox = J.make_box(L, tilt), P.make_box(L, tilt)
    jbins, jfc = jc.bin_particles(jnp.asarray(pos), jbox, jspec.bins,
                                  values=jnp.asarray(forces))
    tbins, tfc = pc.bin_particles(torch.as_tensor(pos), tbox, tspec.bins,
                                  values=torch.as_tensor(forces))
    np.testing.assert_array_equal(tfc.numpy(), np.asarray(jfc))
    jfac = jf.build_col_factors(jbins, jbox, jspec, jcfg.params)
    tfac = pf.build_col_factors(tbins, tbox, tspec, tcfg.params)
    tnodes = pf.spread_nodes(tbins, tbox, tcfg.params)
    return (jspec, jbins, jbox, jfc, jfac), (tspec, tfc, tfac, tnodes)


def _jax_spread(jcfg, tilt, dtype):
    """The JAX package's XLA spread_col with factors in ``dtype``."""
    (jspec, jbins, jbox, jfc, jfac), _ = _far_operands(jcfg, _configs()[1],
                                                       tilt, dtype)
    return jf.spread_col(jbins, jfc, jbox, jspec, jcfg.params, jfac)


@pytest.mark.parametrize("tilt", [0.0, 0.25])
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5),
                                         ("bfloat16", 1e-4)])
def test_spread_col_matches_jax(tilt, dtype, bound):
    """The plain spread (float32 factors of the slots' node-space
    coordinates, f32 sums, the offset-major overlap-add) with the
    contract's factors in ``dtype`` against the JAX package's XLA spread_col
    at float32 factors: the port's spread does not round to the weight
    dtype."""
    jcfg, tcfg = _configs()
    _, (tspec, tfc, _, tnodes) = _far_operands(jcfg, tcfg, tilt, dtype)
    gj = _jax_spread(jcfg, tilt, "float32")
    gt = pf.spread_col_kernel(tfc, tspec, tcfg.params, tnodes, tilt)
    assert gt.shape == (3, tcfg.params.Nx, tcfg.params.Ny, tcfg.params.Nz)
    assert _rel(gt.numpy(), gj) < bound


@pytest.mark.parametrize("tilt", [0.0, 0.25])
def test_spread_of_forces_keeps_float32_moments(tilt):
    """With bfloat16 factors for the contract, the spread of forces is the
    JAX package's float32 spread (within 1e-5), where the JAX package's own
    bfloat16 spread, one bfloat16 product, is off by more than 1e-3; the
    contract's factors are the float32 ones rounded once."""
    jcfg, tcfg = _configs()
    _, (spec, tfc, fac, nodes) = _far_operands(jcfg, tcfg, tilt, "bfloat16")
    _, (spec32, _, fac32, _) = _far_operands(jcfg, tcfg, tilt, "float32")
    p = tcfg.params
    gj = _jax_spread(jcfg, tilt, "float32")
    assert _rel(pf.spread_col_kernel(tfc, spec, p, nodes, tilt).numpy(),
                gj) < 1e-5
    assert _rel(np.asarray(_jax_spread(jcfg, tilt, "bfloat16")), gj) > 1e-3
    assert torch.equal(fac.wxy, fac32.wxy.to(torch.bfloat16))
    assert torch.equal(fac.wz, fac32.wz.to(torch.bfloat16))
    assert nodes.shape == (4, *fac.wz[:, 0].shape)


@pytest.mark.parametrize("tilt", [0.0, 0.25])
def test_spread_is_the_transpose_of_the_contract(tilt):
    """<spread(f), g> = <f, contract(g)> / quadW at the spread's float32
    factors (centred node offsets) in both: the overlap-add rolls are the
    transposes of the window gathers."""
    jcfg, tcfg = _configs()
    _, (tspec, tfc, _, tnodes) = _far_operands(jcfg, tcfg, tilt, "float32")
    p = tcfg.params
    tfac = pf.ColFactors(*pf._factors_f32(tnodes[:3], tnodes[3], tilt, tspec,
                                          p, centred=True))
    g = torch.as_tensor(np.random.default_rng(9).normal(
        size=(3, p.Nx, p.Ny, p.Nz)).astype(np.float32))
    lhs = torch.sum(pf.spread_col(tfc, tspec, p, tnodes, tilt).double()
                    * g.double())
    rhs = torch.sum(tfc.double() * pf.contract_col(g, tspec, p, tfac).double())
    assert abs(float(lhs - rhs * (1.0 / p.quadW))) < 1e-5 * abs(float(lhs))


def test_apply_green_matches_jax():
    jp = J.make_params(xi=0.5, error=1e-3, L=(24.0, 20.0, 30.0))
    tp = P.make_params(xi=0.5, error=1e-3, L=(24.0, 20.0, 30.0))
    rng = np.random.default_rng(4)
    shape = (3, tp.Nx, tp.Ny, tp.Nz // 2 + 1)
    ghat = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    jk, jw = jparams.gridk_arrays(jp, 0.3, half=True)
    tk, tw = pparams.gridk_arrays(tp, 0.3, "cpu", half=True)
    want = jff.apply_green(jnp.asarray(ghat), jk, jw)
    got = apply_green(torch.as_tensor(ghat), tk, tw)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_mobility_matches_jax(tilt):
    """U = M F (near field + spread/rfft/Green/irfft/contract) to 1e-5."""
    jcfg, tcfg = _configs(thermal=False)
    pos, forces = _positions(11), _forces(12)
    uj, oj = ji.mobility(jcfg, pos, forces, tilt)
    ut, ot = pi.mobility(tcfg, pos, forces, tilt)
    assert int(ot) == int(oj) == 0
    assert _rel(ut.numpy(), uj) < 1e-5


def _jax_draws(cfg, step):
    """The uniforms JAX's step draws (integrator.py step_impl)."""
    key = jax.random.fold_in(jax.random.PRNGKey(ji.hash_seed(cfg.seed)),
                             jnp.asarray(step, jnp.int32))
    k_psi, k_grid = jax.random.split(key)
    bs, p = cfg.band_spec.bins, cfg.params
    psi = jn.particle_noise_t(k_psi, (bs.n_cells[0] * bs.n_cells[1], bs.cap))
    wave = jax.random.uniform(k_grid, (6, p.Nx, p.Ny, p.Nz // 2 + 1),
                              dtype=jnp.float32, minval=-jn.SQRT3D2,
                              maxval=jn.SQRT3D2)
    return np.asarray(psi), np.asarray(wave)


def _steps_both(thermal, tilt, rate, new_tilt, step, m0):
    jcfg, tcfg = _configs(thermal=thermal)
    js = ji.make_state(_positions(3), step=step, tilt_xy=tilt)._replace(
        m_lanczos=jnp.asarray(m0, jnp.int32))
    ts = pi.state_from_arrays({k: np.asarray(v)
                               for k, v in js._asdict().items()},
                              device="cpu")
    forces = _forces(13)
    jnew, jinfo = ji.step(jcfg, js, jnp.asarray(forces), 1.0, 1e-3, rate,
                          new_tilt)
    tnew, tinfo = pi.step(tcfg, ts, torch.as_tensor(forces), 1.0, 1e-3, rate,
                          new_tilt,
                          uniforms=_jax_draws(jcfg, step) if thermal else None)
    return (jnew, jinfo), (tnew, tinfo)


@pytest.mark.parametrize("tilt,rate,new_tilt,step,m0", [
    (0.0, 0.0, None, 0, 2),
    (0.3, 0.7, 0.31, 5, 7),
])
def test_step_with_forces_matches_jax(tilt, rate, new_tilt, step, m0):
    """Thermal step with forces (the fused two-RHS build on the card):
    velocities to 1e-4 relative with equal m_lanczos."""
    (jnew, jinfo), (tnew, tinfo) = _steps_both(True, tilt, rate, new_tilt,
                                               step, m0)
    assert tinfo["m_lanczos"] == int(jinfo["m_lanczos"])
    assert _rel(tinfo["velocities"].numpy(), jinfo["velocities"]) < 1e-4
    np.testing.assert_allclose(tnew.pos.numpy(), np.asarray(jnew.pos),
                               atol=1e-5)
    assert int(tnew.nbr_overflow) == int(jnew.nbr_overflow) == 0


def test_athermal_step_matches_jax():
    """thermal=False: the step is M F plus shear advection, no draws, and
    the Lanczos warm start is carried unchanged."""
    (jnew, jinfo), (tnew, tinfo) = _steps_both(False, 0.3, 0.7, None, 2, 5)
    assert tinfo["m_lanczos"] == int(jinfo["m_lanczos"]) == 5
    assert _rel(tinfo["velocities"].numpy(), jinfo["velocities"]) < 1e-5
    np.testing.assert_allclose(tnew.pos.numpy(), np.asarray(jnew.pos),
                               atol=1e-5)


def test_mobility_matches_the_f64_oracle():
    """The composed U = M F against the float64 direct-Ewald oracle at the
    JAX bench gate's configuration (N = 2048: 3 x 3 far-field columns that
    wrap onto themselves, a 27^3 grid, no tile-multiple shapes); the gate's
    bound is 5e-3."""
    d = np.load(ORACLE)
    n = int(d["n"])
    params = P.make_params(xi=float(d["xi"]), error=1e-3, L=float(d["L"]))
    cfg = pi.make_config(params, n, thermal=False, engine="banded",
                         device="cpu")
    assert cfg.colff_spec.s == (9, 9) and cfg.colff_spec.bins.n_cells[:2] == (
        3, 3)
    u, ovf = pi.mobility(cfg, d["pos"], d["forces"])
    assert int(ovf) == 0
    assert _rel(u.numpy(), d["u_ref"]) < 5e-3


def _rcut_edge_positions(seed, pairs=80):
    """Uniform positions whose first ``pairs`` pairs straddle a periodic
    face at a distance within a few float32 ulps of rcut."""
    rng = np.random.default_rng(seed)
    pos = _positions(seed)
    rcut = P.make_params(xi=0.5, error=1e-3, L=L).ewald_cut
    h = L / 2
    for k in range(pairs):
        d = rng.normal(size=3)
        a = rng.uniform(-h, h, 3)
        a[k % 3] = (h - rng.uniform(0, 1)) * (1 if k % 2 else -1)
        b = a + rcut * (1 + rng.integers(-6, 7) * 2.0 ** -24) * d \
            / np.linalg.norm(d)
        pos[2 * k], pos[2 * k + 1] = a, (b + h) % L - h
    return pos


def _plain_build_applied(tcfg, pos, tilt):
    """The float32 plain build's A applied forward and transposed over the
    5 stored offsets with the kernels' window geometry, the 9-offset
    matvec_banded_reference, and both A."""
    p = tcfg.params
    bs = tcfg.band_spec._replace(block_dtype="float32")
    box = P.make_box(L, tilt)
    bins = pc.bin_columns(torch.as_tensor(pos), box, bs.bins)
    j0, nv, ovf, zsh = pb.compute_windows(bins, bs, box, p.ewald_cut)
    assert not bool(ovf)
    f = pc.vec_to_cells(bins, bs.bins, torch.as_tensor(_forces(16)))
    args = (bins, tilt, bs, tcfg.cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            zsh)
    A = pb.build_banded_blocks(*args)                # CPU: the plain build
    C, S, W = bs.bins.n_cells_total, bs.bins.cap, bs.window
    assert A.shape == (1, C, 2, S, 5 * W) and A.dtype == torch.float32
    u = p.self_mobility * f
    for h in range(pb.N_HALF):
        dx, dy, dz, _, _, _, nbr, slot = pb.window_geometry(
            bins, tilt, bs, p.L, j0, nv, zsh, h)
        F1, Bq = (A[0, :, k, :, h * W:(h + 1) * W].reshape(dx.shape)
                  for k in range(2))
        d = (dx, dy, dz)
        fw = f[:, nbr[:, None, None], slot][:, :, :, None, :]  # window
        fi = f.reshape(3, *dx.shape[:3], 1)                    # own rows
        g = Bq * sum(d[k] * fw[k] for k in range(3))
        u += torch.stack([torch.sum(F1 * fw[k] + g * d[k], dim=3)
                          for k in range(3)]).reshape(3, C, S)
        if h == 0:
            continue
        gi = Bq * sum(d[k] * fi[k] for k in range(3))
        flat = (nbr[:, None, None] * S + slot)[:, :, None, :].expand_as(dx)
        for k in range(3):
            u[k].view(-1).index_add_(0, flat.reshape(-1),
                                     (F1 * fi[k] + gi * d[k]).reshape(-1))
    ref = pb.matvec_banded_reference(*args[:9], f, p.self_mobility)
    Ab = pb.build_banded_blocks(*args[:2], bs._replace(
        block_dtype="bfloat16"), *args[3:])
    return u, ref, A, Ab


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_plain_build_applied_matches_plain_matvec(tilt):
    """build_banded_blocks_reference's A (float32), applied forward and
    transposed over the 5 stored offsets with the kernels' window geometry,
    against the 9-offset matvec_banded_reference: 2e-6 of max |u|."""
    _, tcfg = _configs()
    u, ref, A, Ab = _plain_build_applied(tcfg, _positions(15), tilt)
    assert float((u - ref).abs().max() / ref.abs().max()) < 2e-6
    assert Ab.dtype == torch.bfloat16 and torch.equal(Ab, A.to(torch.bfloat16))


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_plain_build_decides_rcut_edge_pairs_as_the_plain_matvec(tilt):
    """As above, with 80 pairs across the periodic faces within float32
    rounding of rcut: the plain build takes each pair's d^2 from the
    minimum image of its separation, as the 9-offset version does, so both
    include the same pairs (d^2 from the window's shifted coordinates
    decides some of them otherwise and misses by 1.4e-3 to 2.1e-3)."""
    _, tcfg = _configs()
    u, ref, _, _ = _plain_build_applied(tcfg, _rcut_edge_positions(17),
                                        tilt)
    assert float((u - ref).abs().max() / ref.abs().max()) < 2e-6


def test_simulation_with_force_fn_runs_saves_and_restores(tmp_path):
    """force_fn(pos, step) is called every step on the device tensors; an
    athermal step moves the particles by M F dt; save/restore round trip of
    a thermal run; mobility_matvec is U = M F at the current
    configuration."""
    pos = _positions(17)
    calls = []

    def force_fn(p, t):
        calls.append(t)
        return -0.5 * p                                  # a harmonic trap

    def make(T):
        sim = P.Simulation(positions=pos, L=L, dt=1e-3, sync_every=2,
                           force_fn=force_fn, device="cpu")
        return sim.set_integrator(P.PSEv1(T=T, seed=4), engine="banded",
                                  verbose=False)

    cold = make(0.0)
    assert cold.config.has_forces and not cold.config.thermal
    F = force_fn(torch.as_tensor(pos), 0)
    u = cold.mobility_matvec(F)
    want, _ = pi.mobility(cold.config, pos, F)
    assert torch.equal(u, want)
    cold.run(1)
    moved = cold.snapshot()["pos"] - (pos + 1e-3 * u.numpy())
    moved -= L * np.round(moved / L)                # the wrap into the box
    assert np.abs(moved).max() < 1e-5

    calls.clear()
    sim = make(1.0)
    assert sim.config.has_forces and sim.config.thermal
    sim.run(1)
    path = tmp_path / "forces.npz"
    sim.save(str(path))
    sim.run(1)
    after = sim.snapshot()["pos"]
    assert np.isfinite(after).all()
    sim.restore(str(path))
    sim.run(1)
    np.testing.assert_array_equal(sim.snapshot()["pos"], after)
    assert calls == [0, 1, 1]


def test_set_params_to_zero_temperature_goes_athermal_like_jax():
    """set_params(T=0) switches the config to athermal (with the M·0
    path on a force-free run) exactly as pse_tpu's does, and back."""
    pos = _positions(19)
    tsim = P.Simulation(positions=pos, L=L, dt=1e-3, device="cpu")
    tsim.set_integrator(P.PSEv1(T=1.0), engine="banded", verbose=False)
    jsim = J.Simulation(positions=pos, L=L, dt=1e-3)
    jsim.set_integrator(J.integrate.PSEv1(T=1.0), engine="banded",
                        verbose=False)
    for T in (0.0, 2.0):
        tsim.set_params(T=T)
        jsim.set_params(T=T)
        assert ((tsim.config.thermal, tsim.config.has_forces)
                == (jsim.config.thermal, jsim.config.has_forces))
    tsim.set_params(T=0.0)
    assert (tsim.config.thermal, tsim.config.has_forces) == (False, True)
    tsim.run(2)                                   # M·0: the particles stay
    np.testing.assert_array_equal(tsim.snapshot()["pos"], pos)
