"""The compilation cache: a documented no-op in the port.

The JAX package turns on XLA's persistent compilation cache here.  The port
compiles no XLA program; its CUDA kernels are built once by ``nvcc`` into
``pse_tpu_torch/_build/<digest>/`` (``PSE_TPU_TORCH_BUILD_DIR`` overrides
the root) and reused while the sources are unchanged (``kernels.py``).
"""

from __future__ import annotations

from .. import kernels


def enable_compilation_cache(path: str | None = None) -> str:
    """Changes nothing; returns ``path``, or the root the kernel library is
    built under when ``path`` is None."""
    return str(path) if path is not None else str(kernels.build_root())
