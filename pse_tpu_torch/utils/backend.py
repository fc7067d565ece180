"""Which device the port's entry points can run on, found without
initializing CUDA.

The JAX package's ``probable_backend`` reads the pinned JAX platform list;
the port's entry points take an explicit ``device`` (CUDA unless the caller
asks for the CPU) and never move to the CPU on their own.  This probe only
reports: ``torch.cuda.is_available()`` reads the device count and creates
no CUDA context.
"""

from __future__ import annotations


def probable_device() -> str:
    """"cuda" when a CUDA device is visible, else "cpu"."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"
