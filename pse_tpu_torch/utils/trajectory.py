"""Streaming trajectory writer (npz container, one npy member per frame).

A numpy copy of the JAX package's ``utils/trajectory.py`` (files written by
either load in the other); the writer reads a Simulation's state through
``snapshot()``, which copies it from the device.

The reference delegates trajectory IO to HOOMD's GSD machinery; this framework
needs only a small self-contained recorder: wrapped positions + images (so
trajectories can be unwrapped exactly), box tilt, and step numbers.

An .npz file is just a zip of .npy members, so frames are appended to the
open zip as they arrive — RAM usage is one frame, not the whole trajectory
(a N=1M float32 run writes ~12 MB/frame; buffering thousands of frames like
an earlier writer did would not fit).  The result is still readable with
plain ``np.load`` (members ``pos_00000000`` ...) or, more conveniently,
``load_trajectory`` / ``iter_frames`` below.
"""

from __future__ import annotations

import zipfile

import numpy as np


class TrajectoryWriter:
    """Streams frames to disk via Simulation.run callbacks.

    Usage:
        writer = TrajectoryWriter("traj.npz", every=1)
        sim.run(n, callback=writer)   # called once per sync chunk
        writer.close()
    """

    def __init__(self, path: str, every: int = 1, compress: bool = False):
        self.path = path
        self.every = int(every)
        self._count = 0
        self.n_frames = 0
        method = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
        self._zip = zipfile.ZipFile(path, "w", method, allowZip64=True)
        self._steps = []
        self._tilts = []

    def _write(self, name: str, arr: np.ndarray):
        with self._zip.open(name + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(
                f, np.ascontiguousarray(arr), allow_pickle=False
            )

    def __call__(self, sim):
        self._count += 1
        if self._count % self.every:
            return
        s = sim.snapshot()
        i = self.n_frames
        self._write(f"pos_{i:08d}", s["pos"])
        self._write(f"images_{i:08d}", s["images"])
        self._steps.append(int(s["step"]))
        self._tilts.append(float(s["tilt_xy"]))
        self.n_frames += 1

    def close(self):
        # Per-trajectory metadata members (step/tilt arrays are tiny).
        self._write("step", np.asarray(self._steps, np.int64))
        self._write("tilt_xy", np.asarray(self._tilts, np.float64))
        self._zip.close()
        return self.path


def iter_frames(path: str):
    """Yield (pos, images, step, tilt_xy) per frame without loading all."""
    with np.load(path) as d:
        steps = d["step"]
        tilts = d["tilt_xy"]
        for i in range(len(steps)):
            yield (
                d[f"pos_{i:08d}"],
                d[f"images_{i:08d}"],
                int(steps[i]),
                float(tilts[i]),
            )


def load_trajectory(path: str) -> dict:
    """Load a full trajectory as stacked arrays (the older stacked dict layout)."""
    with np.load(path) as d:
        if "pos" in d.files:  # the older stacked layout
            return {k: d[k] for k in d.files}
        steps = d["step"]
        n = len(steps)
        return {
            "pos": (
                np.stack([d[f"pos_{i:08d}"] for i in range(n)])
                if n
                else np.zeros((0,))
            ),
            "images": (
                np.stack([d[f"images_{i:08d}"] for i in range(n)])
                if n
                else np.zeros((0,))
            ),
            "step": np.asarray(steps, np.int64),
            "tilt_xy": np.asarray(d["tilt_xy"], np.float64),
        }
