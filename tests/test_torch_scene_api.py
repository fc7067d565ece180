"""The JAX package's Simulation / PSEv1 scene-API tests (tests/test_api.py)
run on the PyTorch port, on the CPU: the same scenes, the same assertions,
with the port's device argument and torch tensors where the JAX tests use
jax arrays."""

import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pse_tpu_torch as pse                  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(n_side=4, L=20.0, dt=1e-3, T=1.0, seed=3, **kw):
    sim = pse.Simulation(
        positions=pse.create_lattice(n_side, L), L=L, dt=dt, sync_every=5,
        device="cpu",
    )
    sim.set_integrator(
        pse.integrate.PSEv1(T=T, seed=seed, xi=0.5, error=1e-3, **kw),
        verbose=False, engine="gather",
    )
    return sim


def test_run_advances_and_moves_particles():
    sim = _sim()
    p0 = sim.snapshot()["pos"].copy()
    sim.run(12)
    s = sim.snapshot()
    assert s["step"] == 12
    assert np.abs(s["pos"] - p0).max() > 1e-4


def test_athermal_zero_force_is_static():
    sim = _sim(T=0.0)
    p0 = sim.snapshot()["pos"].copy()
    sim.run(5)
    np.testing.assert_allclose(sim.snapshot()["pos"], p0, atol=1e-7)


def test_checkpoint_roundtrip_determinism():
    sim = _sim()
    sim.run(5)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        sim.save(path)
        sim.run(5)
        target = sim.snapshot()["pos"]

        sim2 = _sim()
        sim2.restore(path)
        sim2.run(5)
        np.testing.assert_array_equal(sim2.snapshot()["pos"], target)


def test_bad_thermal_forces_config_raises():
    """thermal=False + has_forces=False must fail loudly, including via
    dataclasses.replace (the api.set_params path that used to bypass
    make_config's guard)."""
    import dataclasses

    from pse_tpu_torch import integrator

    params = pse.make_params(xi=0.5, error=1e-3, L=20.0)
    config = integrator.make_config(params, 64, thermal=True, has_forces=False,
                                    device="cpu")
    with pytest.raises(ValueError, match="thermal=False"):
        dataclasses.replace(config, thermal=False)


def test_set_params_athermal_keeps_invariant():
    """Going athermal on a zero-force Simulation re-enables the M·0 path."""
    sim = _sim(T=1.0)
    assert not sim.config.has_forces
    sim.set_params(T=0.0)
    assert not sim.config.thermal and sim.config.has_forces
    sim.run(2)  # compiles and runs


def test_set_params_max_strain_guard():
    sim = _sim(T=1.0, max_strain=0.3)
    with pytest.raises(ValueError, match="max_strain"):
        sim.set_params(
            function_form=pse.shear_function.steady(dt=1.0), max_strain=0.5
        )
    # at or below the built value is fine, and stop_shear defaults safely
    sim.set_params(
        function_form=pse.shear_function.steady(dt=1.0), max_strain=0.3
    )
    sim.stop_shear()


def test_block_dtype_tracks_requested_error():
    from pse_tpu_torch import integrator

    L = 30.0
    n = 500
    loose = integrator.make_config(
        pse.make_params(xi=0.5, error=1e-3, L=L), n, engine="blocked",
        device="cpu"
    )
    tight = integrator.make_config(
        pse.make_params(xi=0.5, error=1e-4, L=L), n, engine="blocked",
        device="cpu"
    )
    assert loose.nf_spec.block_dtype == "bfloat16"
    assert tight.nf_spec.block_dtype == "float32"
    with pytest.warns(UserWarning, match="bfloat16"):
        integrator.make_config(
            pse.make_params(xi=0.5, error=1e-4, L=L), n,
            engine="blocked", block_dtype="bfloat16", device="cpu",
        )


def test_set_params_changes_temperature():
    sim = _sim(T=1.0)
    sim.run(2)
    sim.set_params(T=0.0)
    p0 = sim.snapshot()["pos"].copy()
    sim.run(3)
    np.testing.assert_allclose(sim.snapshot()["pos"], p0, atol=1e-7)


def test_stop_shear():
    ff = pse.shear_function.sine(dt=1e-3, shear_rate=1.0, shear_freq=1.0, zero=0)
    sim = _sim(T=0.0, function_form=ff)
    sim.run(3)
    sim.stop_shear()
    assert float(sim.method.function_form.shear_rate(100)) == 0.0


def test_shear_box_tilts_and_advects():
    ff = pse.shear_function.steady(dt=1e-3, shear_rate=2.0, zero=0)
    sim = _sim(T=0.0, function_form=ff)
    sim.enable_shear_box(total_timesteps=10000)
    sim.run(10)
    s = sim.snapshot()
    # tilt follows strain = rate * t * dt
    np.testing.assert_allclose(s["tilt_xy"], 2.0 * 10 * 1e-3, atol=1e-5)
    # particles advected in x proportionally to y
    disp_x = s["pos"][:, 0] - pse.create_lattice(4, 20.0)[:, 0]
    y = pse.create_lattice(4, 20.0)[:, 1]
    np.testing.assert_allclose(disp_x, 2.0 * y * 10 * 1e-3, atol=1e-4)


def test_mobility_matvec_surface():
    sim = _sim(T=0.0)
    F = np.zeros((64, 3), np.float32)
    F[:, 2] = 1.0
    u = np.asarray(sim.mobility_matvec(F))
    assert u.shape == (64, 3)
    # equal forces on a lattice: velocities equal by symmetry, pointing +z
    assert u[:, 2].std() < 1e-4 * abs(u[:, 2].mean())
    assert u[:, 2].mean() > 0


def test_particle_group_subset():
    """group=indices integrates only that subset (Stokes.cc:85-111): members
    move under Brownian dynamics, non-members stay frozen, and a full group
    is identical to group=None."""
    L, n_side = 20.0, 4
    pos0 = pse.create_lattice(n_side, L)
    n = pos0.shape[0]
    g = np.arange(0, n, 2)

    sim = pse.Simulation(positions=pos0, L=L, dt=1e-3, sync_every=5,
                         device="cpu")
    sim.set_integrator(
        pse.integrate.PSEv1(T=1.0, seed=3, xi=0.5, error=1e-3, group=g),
        verbose=False, engine="gather",
    )
    assert sim._group is not None and int(sim._group.shape[0]) == g.size
    sim.run(6)
    p = sim.snapshot()["pos"]
    moved = np.abs(p - pos0).max(axis=1)
    assert moved[g].min() > 1e-5
    non_group = np.setdiff1d(np.arange(n), g)
    np.testing.assert_array_equal(p[non_group], pos0[non_group])

    # group covering everything == no group (bitwise: same config/step path)
    sim_all = _sim(group=np.arange(64))
    sim_none = _sim()
    sim_all.run(5)
    sim_none.run(5)
    np.testing.assert_array_equal(
        sim_all.snapshot()["pos"], sim_none.snapshot()["pos"]
    )

    with pytest.raises(ValueError, match="group"):
        bad = pse.Simulation(positions=pos0, L=L, dt=1e-3, device="cpu")
        bad.set_integrator(
            pse.integrate.PSEv1(T=1.0, group=np.array([n + 3])), verbose=False
        )


def test_invalid_nlist_type():
    with pytest.raises(ValueError):
        pse.integrate.PSEv1(nlist_type="octree")


def test_trajectory_writer_roundtrip(tmp_path):
    from pse_tpu_torch.utils.trajectory import (TrajectoryWriter,
                                                load_trajectory)

    sim = _sim(T=1.0)
    writer = TrajectoryWriter(str(tmp_path / "traj.npz"), every=1)
    sim.run(15, callback=writer)  # sync_every=5 -> 3 frames
    path = writer.close()
    d = load_trajectory(path)
    assert d["pos"].shape == (3, 64, 3)
    assert list(d["step"]) == [5, 10, 15]
    # unwrapping data present
    assert d["images"].shape == (3, 64, 3)
    assert d["tilt_xy"].shape == (3,)


def test_run_metrics_accumulate():
    sim = _sim(T=1.0)
    sim.run(10)
    m = sim.metrics
    assert m["steps"] == 10
    assert sum(m["m_lanczos_hist"].values()) == 10
    assert all(k >= 2 for k in m["m_lanczos_hist"])
    assert "lanczos[" in sim.metrics_summary()


def test_zero_now_reanchors_on_restore(tmp_path):
    """zero='now' means "when the protocol starts": attach at step 0 -> 0,
    restore to step 5 -> 5; explicit ints never rebind (VERDICT r2 weak #6)."""
    path = str(tmp_path / "ck.npz")
    ff_now = pse.shear_function.sine(dt=1e-3, shear_rate=1.0, shear_freq=1.0)
    sim = _sim(T=0.0, function_form=ff_now)
    assert int(sim.method.function_form.offset) == 0
    sim.run(5)
    sim.save(path)

    sim2 = _sim(T=0.0, function_form=ff_now)
    sim2.restore(path)
    assert int(sim2.method.function_form.offset) == 5

    ff_fixed = pse.shear_function.sine(
        dt=1e-3, shear_rate=1.0, shear_freq=1.0, zero=0
    )
    sim3 = _sim(T=0.0, function_form=ff_fixed)
    sim3.restore(path)
    assert int(sim3.method.function_form.offset) == 0

    # set_params with a 'now' protocol on a running sim anchors at the
    # current step, and windowed protocols rebind recursively
    win = pse.shear_function.windowed(
        pse.shear_function.sine(dt=1e-3, shear_rate=1.0, shear_freq=1.0),
        pse.shear_function.tukey_window(dt=1e-3, periodT=1.0, tukey_param=0.5),
    )
    sim.set_params(function_form=win)
    assert int(sim.method.function_form.base.offset) == 5
    assert int(sim.method.function_form.window.offset) == 5


def test_grow_config_preserves_band_invariant():
    """Repeated regrowth must keep window <= 256 and cap >= window — the
    limits make_band_spec validates the kernels under (VERDICT r2 weak #5)."""
    from pse_tpu_torch import integrator

    params = pse.make_params(xi=0.5, error=1e-3, L=24.0)
    cfg = integrator.make_config(params, 1080, thermal=False, engine="banded",
                                 device="cpu")
    assert cfg.engine == "banded"
    for _ in range(4):
        cfg = integrator.grow_config(cfg)
        bs = cfg.band_spec
        assert bs.window <= 256
        assert bs.bins.cap >= bs.window
        assert bs.bins.cap % bs.rows == 0


def test_banded_step_after_regrow():
    """A post-regrow banded config still produces correct mobility (the
    regrown window/cap shapes compile and agree with the gather engine)."""
    from pse_tpu_torch import integrator

    rng = np.random.default_rng(21)
    n, L = 1080, 24.0
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg_g = integrator.make_config(params, n, thermal=False, engine="gather",
                                   device="cpu")
    cfg_b = integrator.make_config(params, n, thermal=False, engine="banded",
                                   device="cpu")
    cfg_b = integrator.grow_config(cfg_b)
    assert cfg_b.engine == "banded" and cfg_b.band_spec.window <= 256
    ug, _ = integrator.mobility(cfg_g, pos, forces)
    ub, ob = integrator.mobility(cfg_b, pos, forces)
    assert not bool(ob)
    rel = np.linalg.norm(np.asarray(ub) - np.asarray(ug)) / np.linalg.norm(
        np.asarray(ug)
    )
    assert rel < 1e-3


def test_run_raises_on_persistent_overflow():
    import dataclasses

    sim = _sim(T=1.0)
    # shrink neighbor capacity so the first chunk overflows
    sim.config = dataclasses.replace(
        sim.config,
        nbr_spec=sim.config.nbr_spec._replace(max_neighbors=1),
    )
    with pytest.raises(RuntimeError, match="overflow persists"):
        sim.run(5, max_regrow=0)


def test_nlist_tree_warns_stencil_is_genuine():
    """tree is accepted for reference API parity (integrate.py:60-68) but
    maps to the cell backend with the port's documented warning; stencil is
    a genuine finer-cell backend (neighbors.NeighborSpec.subdiv=2) and
    builds a subdivided neighbor spec without warning."""
    import warnings

    with pytest.warns(UserWarning, match="no counterpart"):
        m = pse.integrate.PSEv1(nlist_type="tree")
    assert m.nlist_type == "tree"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pse.integrate.PSEv1(nlist_type="stencil")

    n, L = 400, 20.0
    rng = np.random.default_rng(5)
    pos0 = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    sim = pse.Simulation(positions=pos0, L=L, dt=1e-3, device="cpu")
    sim.set_integrator(
        pse.integrate.PSEv1(T=0.0, nlist_type="stencil"), verbose=False
    )
    assert sim.config.nbr_spec.subdiv == 2


def test_lanczos_m_shrinks_after_transient():
    """m_lanczos is not a ratchet: the periodic shrink probe
    (integrator.M_SHRINK_PERIOD) lets a transiently-inflated warm start
    decay back to the true requirement (the reference's is one-way,
    Brownian.cu:604-736)."""
    from pse_tpu_torch import integrator

    rng = np.random.default_rng(7)
    n, L = 256, 24.0                      # dilute: true m is small
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg = integrator.make_config(
        params, n, thermal=True, seed=3, engine="gather", device="cpu"
    )
    zeros = torch.zeros((n, 3))

    # Baseline: what does a cold start settle to?
    st = integrator.make_state(pos, device="cpu")
    st, info = integrator.step(cfg, st, zeros, 1.0, 1e-3, 0.0)
    m_true = int(info["m_lanczos"])

    # Inflate the warm start well past the requirement, step at a probe
    # index (step 0 hits step % K == 0): m must come down by one.
    st = integrator.make_state(pos, device="cpu")
    st = st._replace(m_lanczos=m_true + 3)
    st, info = integrator.step(cfg, st, zeros, 1.0, 1e-3, 0.0)
    assert int(info["m_lanczos"]) == m_true + 2

    # Non-probe steps keep the floor (no shrink, no growth).
    st2 = st._replace(m_lanczos=m_true + 2)
    st2, info2 = integrator.step(cfg, st2, zeros, 1.0, 1e-3, 0.0)
    assert int(info2["m_lanczos"]) == m_true + 2

    # Probing every K steps decays all the way back to m_true.
    st = integrator.make_state(pos, device="cpu")
    st = st._replace(m_lanczos=m_true + 3)
    for k in range(4):
        st = st._replace(step=k * integrator.M_SHRINK_PERIOD)
        st, info = integrator.step(cfg, st, zeros, 1.0, 1e-3, 0.0)
    assert int(info["m_lanczos"]) == m_true
