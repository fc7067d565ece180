"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into an object
file, all sources at once in parallel, and the objects are linked into one
shared library with a plain C interface that ``ctypes`` loads.  The build
runs at the first kernel launch of a process (or when ``build()`` is called),
into a directory named after a digest of the sources and flags, so a changed
source is rebuilt and an unchanged one is reused.  Nothing here runs at
import: the CPU tests import every module on machines without ``nvcc``.

The build directory is ``pse_tpu_torch/_build`` unless the environment sets
``PSE_TPU_TORCH_BUILD_DIR``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fill.cu", "banded.cu", "blocked.cu", "contract.cu", "spread.cu")
HEADERS = ("common.cuh", "mma.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points (csrc/*.cu): each launches on the given stream and returns
# cudaGetLastError() as an int.
_SIGNATURES = {
    "pse_fill_cells": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "pse_banded_build": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F,
                         _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P,
                         _P, _I, _P, _P, _P],
    "pse_banded_matvec": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _F, _F, _F, _F, _I, _P, _P,
                          _P, _I, _P, _P, _P],
    "pse_blocked_build": [_P, _P, _P, _P, _P, _I, _F, _F, _F, _I, _I, _I,
                          _I, _F, _F, _F, _F, _F, _F, _F, _I, _P, _I, _P,
                          _P],
    "pse_blocked_matvec": [_P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _I, _I,
                           _P, _P, _P, _P],
    "pse_contract_col": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _P, _P],
    "pse_spread_col": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                       _F, _F, _F, _I, _P, _P],
}

_lib = None
BUILD_INFO = {}


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME/bin): the port's CUDA kernels "
            "are built from csrc/ at first use"
        )
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_root() -> Path:
    """The root the kernel library is built under."""
    root = os.environ.get("PSE_TPU_TORCH_BUILD_DIR")
    return Path(root) if root else Path(__file__).resolve().parent / "_build"


def build_dir() -> Path:
    return build_root() / _digest()


def build() -> Path:
    """Compile every source in parallel, link, and return the library path
    (an existing library for the same digest is reused).  Records the
    seconds taken and the ptxas resource report in ``BUILD_INFO``."""
    from . import trace

    out = build_dir()
    lib = out / "libpse_kernels.so"
    if lib.exists():
        trace.count("kernels.reuse")
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", "(reused)")
        return lib
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = out / (name + f".{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for name, obj, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {name}\n{text}")
        objs.append(str(obj))
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out / f"libpse_kernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", NVCC_FLAGS[0], "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib)
    for o in objs:
        os.remove(o)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = "\n".join(logs)
    trace.count("kernels.build")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pse_error_string.argtypes = [ctypes.c_int]
        lib.pse_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, rc: int) -> None:
    """Raise if a launch reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        msg = library().pse_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
