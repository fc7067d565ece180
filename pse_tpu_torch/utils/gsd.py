"""GSD (HOOMD) trajectory IO — minimal, dependency-free writer/reader.

A numpy copy of the JAX package's ``utils/gsd.py`` (files written by either
read in the other); the writer reads a Simulation's state through
``snapshot()``, which copies it from the device.

The reference plugin delegates trajectory output to HOOMD's GSD dumper; this
module provides the interoperable equivalent so trajectories from this
framework open in the HOOMD/gsd ecosystem tooling.

Implements the GSD 1.0 binary container (the format HOOMD 2.3.3 — the
reference's tested envelope, README.md:29-32 — writes) with the ``hoomd``
schema, restricted to the chunks PSE produces:

  configuration/step      uint64 (1,)
  configuration/dimensions uint8 (1,)
  configuration/box       float32 (6,)   [lx, ly, lz, xy, xz, yz]
  particles/N             uint32 (1,)
  particles/position      float32 (N, 3)
  particles/image         int32  (N, 3)
  particles/typeid        uint32 (N,)    (frame 0; all zeros, one type "A")
  particles/types         int8   (1, 63) (frame 0; "A")

File container layout (gsd.h v1): 256-byte header, data chunks appended as
frames stream in (constant RAM), then the index block (32-byte entries) and
the namelist block (64-byte zero-padded names) written at close, and the
header last.  Readers tolerate missing per-frame chunks by falling back to
frame 0, which this writer relies on for the static chunks.

A matching ``read_gsd``/``iter_gsd_frames`` reader validates round trips in
the test suite and doubles as a loader when the ``gsd`` package is absent.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

_MAGIC = 0x65DF65DF65DF65DF
_HEADER = struct.Struct("<QQQQQII64s64s80s")          # 256 bytes
_INDEX_ENTRY = struct.Struct("<QQqIHBB")              # 32 bytes
_NAME_SIZE = 64

_TYPE_CODES = {
    np.dtype(np.uint8): 1, np.dtype(np.uint16): 2, np.dtype(np.uint32): 3,
    np.dtype(np.uint64): 4, np.dtype(np.int8): 5, np.dtype(np.int16): 6,
    np.dtype(np.int32): 7, np.dtype(np.int64): 8, np.dtype(np.float32): 9,
    np.dtype(np.float64): 10,
}
_CODE_DTYPES = {v: k for k, v in _TYPE_CODES.items()}


def _version(major, minor):
    return (major << 16) | minor


class GSDWriter:
    """Stream frames into a GSD 1.0 / hoomd-schema file.

    Same callback shape as utils.trajectory.TrajectoryWriter:

        writer = GSDWriter("traj.gsd", L=box_lengths, every=1)
        sim.run(n, callback=writer)
        writer.close()
    """

    def __init__(self, path: str, L, every: int = 1,
                 application: str = "pse_tpu_torch"):
        self.path = path
        self.L = tuple(float(x) for x in (L if hasattr(L, "__len__") else (L,) * 3))
        self.every = int(every)
        self._count = 0
        self.n_frames = 0
        self._names: list[str] = []
        self._name_ids: dict[str, int] = {}
        self._index: list[tuple] = []
        self._f = open(path, "wb")
        self._f.write(b"\0" * _HEADER.size)            # placeholder header
        self._application = application

    def _name_id(self, name: str) -> int:
        if name not in self._name_ids:
            self._name_ids[name] = len(self._names)
            self._names.append(name)
        return self._name_ids[name]

    def write_chunk(self, name: str, data: np.ndarray):
        """Append one data chunk to the current frame."""
        data = np.ascontiguousarray(data)
        if data.dtype not in _TYPE_CODES:
            raise TypeError(f"unsupported GSD dtype {data.dtype}")
        if data.ndim == 1:
            n_rows, n_cols = data.shape[0], 1
        elif data.ndim == 2:
            n_rows, n_cols = data.shape
        else:
            raise ValueError("GSD chunks are 1-D or 2-D")
        location = self._f.tell()
        self._f.write(data.tobytes())
        self._index.append((
            self.n_frames, n_rows, location, n_cols,
            self._name_id(name), _TYPE_CODES[data.dtype], 0,
        ))

    def _write_frame(self, pos, images, step, tilt_xy):
        lx, ly, lz = self.L
        if self.n_frames == 0:
            n = pos.shape[0]
            self.write_chunk("configuration/dimensions",
                             np.asarray([3], np.uint8))
            self.write_chunk("particles/N", np.asarray([n], np.uint32))
            self.write_chunk("particles/typeid", np.zeros(n, np.uint32))
            types = np.zeros((1, _NAME_SIZE - 1), np.int8)
            types[0, 0] = ord("A")
            self.write_chunk("particles/types", types)
        self.write_chunk("configuration/step",
                         np.asarray([step], np.uint64))
        self.write_chunk("configuration/box", np.asarray(
            [lx, ly, lz, float(tilt_xy), 0.0, 0.0], np.float32))
        self.write_chunk("particles/position", np.asarray(pos, np.float32))
        if images is not None:
            self.write_chunk("particles/image", np.asarray(images, np.int32))
        self.n_frames += 1

    def __call__(self, sim):
        self._count += 1
        if self._count % self.every:
            return
        s = sim.snapshot()
        self._write_frame(s["pos"], s["images"], s["step"], s["tilt_xy"])

    def append(self, pos, images=None, step=0, tilt_xy=0.0):
        """Direct frame append (no Simulation needed)."""
        self._write_frame(np.asarray(pos), images, int(step), float(tilt_xy))

    def close(self) -> str:
        # index block: sorted by (frame, id) as gsd requires
        index_location = self._f.tell()
        for entry in sorted(self._index, key=lambda e: (e[0], e[4])):
            self._f.write(_INDEX_ENTRY.pack(*entry))
        namelist_location = self._f.tell()
        for name in self._names:
            self._f.write(name.encode()[: _NAME_SIZE - 1].ljust(_NAME_SIZE, b"\0"))
        self._f.seek(0)
        # schema_version 1.0: the lowest version the emitted chunks require
        # — readers from the reference envelope (HOOMD 2.3.3, gsd 1.5/1.6)
        # reject files stamped above the schema they support.
        self._f.write(_HEADER.pack(
            _MAGIC, index_location, len(self._index), namelist_location,
            len(self._names), _version(1, 0), _version(1, 0),
            self._application.encode().ljust(64, b"\0"),
            b"hoomd".ljust(64, b"\0"), b"\0" * 80,
        ))
        self._f.close()
        return self.path


class _GSDFile(NamedTuple):
    index: list           # (frame, N, location, M, name, typecode)
    names: list
    n_frames: int


def _read_structure(f) -> _GSDFile:
    header = _HEADER.unpack(f.read(_HEADER.size))
    if header[0] != _MAGIC:
        raise ValueError("not a GSD file (bad magic)")
    (index_location, index_n, namelist_location, namelist_n) = header[1:5]
    f.seek(namelist_location)
    names = []
    for _ in range(namelist_n):
        raw = f.read(_NAME_SIZE)
        names.append(raw.split(b"\0", 1)[0].decode())
    f.seek(index_location)
    index = []
    for _ in range(index_n):
        frame, n, loc, m, nid, typ, _fl = _INDEX_ENTRY.unpack(
            f.read(_INDEX_ENTRY.size))
        if loc == 0:
            break
        index.append((frame, n, loc, m, names[nid], typ))
    n_frames = 1 + max((e[0] for e in index), default=-1)
    return _GSDFile(index=index, names=names, n_frames=n_frames)


def read_chunk(path_or_file, frame: int, name: str, _struct=None):
    """Read one chunk, falling back to frame 0 (GSD reader contract)."""
    close = False
    f = path_or_file
    if isinstance(f, str):
        f = open(f, "rb")
        close = True
    try:
        st = _struct or _read_structure(f)
        for want in (frame, 0):
            for (fr, n, loc, m, nm, typ) in st.index:
                if fr == want and nm == name:
                    f.seek(loc)
                    dtype = _CODE_DTYPES[typ]
                    data = np.frombuffer(
                        f.read(n * m * dtype.itemsize), dtype)
                    return data.reshape(n, m) if m > 1 else data
        raise KeyError(f"chunk {name!r} not found in frame {frame} or 0")
    finally:
        if close:
            f.close()


def iter_gsd_frames(path: str):
    """Yield (pos, images, step, box6) per frame."""
    with open(path, "rb") as f:
        st = _read_structure(f)
        for fr in range(st.n_frames):
            pos = read_chunk(f, fr, "particles/position", st)
            try:
                images = read_chunk(f, fr, "particles/image", st)
            except KeyError:
                images = None
            step = int(read_chunk(f, fr, "configuration/step", st)[0])
            box = read_chunk(f, fr, "configuration/box", st)
            yield pos, images, step, box


def read_gsd(path: str) -> dict:
    """Load a whole PSE trajectory written by GSDWriter."""
    frames = list(iter_gsd_frames(path))
    # position-only files (append(pos) / external writers) have no image
    # chunks; stacking None would crash the loader
    have_images = frames and all(fr[1] is not None for fr in frames)
    return {
        "pos": np.stack([fr[0] for fr in frames]),
        "images": np.stack([fr[1] for fr in frames]) if have_images else None,
        "step": np.asarray([fr[2] for fr in frames], np.int64),
        "tilt_xy": np.asarray([float(fr[3][3]) for fr in frames]),
        "box": frames[0][3] if frames else None,
    }
