"""The port's utils/ against the JAX package's, and the oscillatory-shear
twin.

GSD files written by the port read in pse_tpu and the other way round, a
TrajectoryWriter round trip from the port's Simulation (its files load in
pse_tpu), the device probe and the compilation-cache no-op, and
pse_tpu_torch/examples/oscillatory_shear.py for 3 steps at a small N.
CPU only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pse_tpu.utils import gsd as jgsd                  # noqa: E402
from pse_tpu.utils import trajectory as jtraj          # noqa: E402

import pse_tpu_torch as P                              # noqa: E402
from pse_tpu_torch.utils import backend, cache         # noqa: E402
from pse_tpu_torch.utils import gsd as pgsd            # noqa: E402
from pse_tpu_torch.utils import trajectory as ptraj    # noqa: E402

BOX = 10.0          # too small to block: the gather engine, fast on CPU
N = 107


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(seed=0):
    pos = np.random.default_rng(seed).uniform(
        -BOX / 2, BOX / 2, (N, 3)).astype(np.float32)
    sim = P.Simulation(positions=pos, L=BOX, dt=1e-3, sync_every=1,
                       device="cpu")
    sim.set_integrator(P.PSEv1(T=1.0, seed=1), verbose=False)
    assert sim.config.engine == "gather"
    return sim


def test_gsd_written_by_the_port_reads_in_pse_tpu_and_back(tmp_path):
    """A trajectory the port's GSDWriter streams from Simulation.run reads
    in pse_tpu's read_gsd; a file pse_tpu writes reads in the port's."""
    sim = _sim(1)
    path = str(tmp_path / "port.gsd")
    writer = pgsd.GSDWriter(path, L=BOX)
    sim.run(3, callback=writer)
    writer.close()
    got = jgsd.read_gsd(path)
    mine = pgsd.read_gsd(path)
    assert got["pos"].shape == (3, N, 3)
    np.testing.assert_array_equal(got["step"], [1, 2, 3])
    np.testing.assert_array_equal(got["pos"][-1], sim.snapshot()["pos"])
    np.testing.assert_array_equal(got["images"][-1],
                                  sim.snapshot()["images"])
    for k in ("pos", "images", "step", "tilt_xy", "box"):
        np.testing.assert_array_equal(mine[k], got[k])

    rng = np.random.default_rng(2)
    path = str(tmp_path / "jax.gsd")
    jw = jgsd.GSDWriter(path, L=(BOX, BOX, 12.0))
    frames = [rng.uniform(-5, 5, (N, 3)).astype(np.float32) for _ in range(2)]
    for i, f in enumerate(frames):
        jw.append(f, np.full((N, 3), i, np.int32), step=10 * i,
                  tilt_xy=0.1 * i)
    jw.close()
    back = pgsd.read_gsd(path)
    np.testing.assert_array_equal(back["pos"], np.stack(frames))
    np.testing.assert_array_equal(back["step"], [0, 10])
    np.testing.assert_allclose(back["tilt_xy"], [0.0, 0.1], rtol=1e-6)
    np.testing.assert_array_equal(back["box"][:3], [BOX, BOX, 12.0])


def test_trajectory_writer_round_trip_from_the_port(tmp_path):
    """TrajectoryWriter frames from the port's Simulation (every=2), loaded
    by both packages' load_trajectory and iter_frames."""
    sim = _sim(3)
    path = str(tmp_path / "traj.npz")
    writer = ptraj.TrajectoryWriter(path, every=2)
    sim.run(4, callback=writer)
    assert writer.close() == path and writer.n_frames == 2
    for mod in (ptraj, jtraj):
        d = mod.load_trajectory(path)
        np.testing.assert_array_equal(d["step"], [2, 4])
        np.testing.assert_array_equal(d["pos"][-1], sim.snapshot()["pos"])
        assert d["images"].shape == (2, N, 3)
    frames = list(ptraj.iter_frames(path))
    assert [f[2] for f in frames] == [2, 4]


def test_device_probe_and_cache_shim(monkeypatch, tmp_path):
    """The probe reports; the cache shim returns a path and makes none."""
    assert backend.probable_device() == (
        "cuda" if torch.cuda.is_available() else "cpu")
    want = str(tmp_path / "cache")
    assert cache.enable_compilation_cache(want) == want
    monkeypatch.setenv("PSE_TPU_TORCH_BUILD_DIR", want)
    assert cache.enable_compilation_cache() == want
    monkeypatch.delenv("PSE_TPU_TORCH_BUILD_DIR")
    assert cache.enable_compilation_cache().endswith("_build")
    assert not (tmp_path / "cache").exists()


def test_oscillatory_shear_twin_runs_on_cpu(tmp_path):
    """The twin of examples/oscillatory_shear.py for 3 steps at N = 500:
    sheared, tilted box, one frame (one sync chunk) that pse_tpu loads."""
    from pse_tpu_torch.examples import oscillatory_shear

    out = str(tmp_path / "shear.npz")
    sim, path = oscillatory_shear.main("cpu", 3, n=500, out=out)
    s = sim.snapshot()
    assert s["step"] == 3 and np.isfinite(s["pos"]).all()
    assert s["tilt_xy"] != 0.0
    d = jtraj.load_trajectory(path)
    np.testing.assert_array_equal(d["step"], [3])
    np.testing.assert_array_equal(d["pos"][-1], s["pos"])
    assert d["tilt_xy"][-1] == s["tilt_xy"]
