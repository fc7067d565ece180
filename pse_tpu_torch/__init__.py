"""pse_tpu_torch: the PyTorch/CUDA port of pse_tpu (Positively Split Ewald
Brownian dynamics) for one NVIDIA H100.

It runs the thermal, force-free step of the banded engine (z-sorted column
near field + z-column far field) with hand-written CUDA kernels
(``csrc/``, built by ``nvcc`` for sm_90a at first use), and a plain PyTorch
version of every kernel that the wrappers run on CPU tensors.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.  This package
imports ``torch``, numpy and scipy; it never imports ``jax`` or ``pse_tpu``.
"""

from . import box
from . import params
from . import tables
from . import shear as shear_function
from . import integrator
from .api import PSEv1, Simulation, create_lattice
from .box import Box, make_box
from .integrator import State, StepConfig, make_state, state_from_arrays, step
from .params import PSEParams, make_params

__version__ = "0.1.0"
