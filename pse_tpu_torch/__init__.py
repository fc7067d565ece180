"""pse_tpu_torch: the PyTorch/CUDA port of pse_tpu (Positively Split Ewald
Brownian dynamics) for one NVIDIA H100.

It runs the step of the blocked engine (the default: 3-D cell pair blocks
+ z-column far field), of the banded engine (z-sorted column near field,
its A packed by occupancy class on the card) and of the gather engine (a neighbor list, the table-interpolated near
field and a tap far field, where the box is too small to block), thermal
or athermal, with or without external forces
(``Simulation(force_fn=...)``), on all particles or a ``PSEv1.group``
subset, and the deterministic U = M F (``integrator.mobility``,
``Simulation.mobility_matvec``), with hand-written CUDA kernels (``csrc/``,
built by ``nvcc`` for sm_90a at first use) and a plain PyTorch version of
every kernel that the wrappers run on CPU tensors.  The user surface is the
reference's::

    import pse_tpu_torch as pse

    sim = pse.Simulation(positions=pos, L=L, dt=1e-3)
    sim.set_integrator(pse.integrate.PSEv1(T=1.0, seed=1, xi=0.5,
                                           error=1e-3))
    sim.run(1000)

``parallel`` runs the step over a mesh of devices in one process
(``parallel.sharding.make_mesh``, where a device may repeat): the banded
near field in x-slabs with halos (``parallel.halo.make_halo_step``), or
the gather and blocked near fields split over the devices
(``parallel.sharding.make_sharded_step``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
This package imports ``torch``, numpy and scipy; it never imports ``jax``
or ``pse_tpu``.
"""

from . import box
from . import neighbors
from . import params
from . import tables
from . import shear as shear_function
from . import integrator
from . import integrate
from . import variant
from .api import PSEv1, Simulation, create_lattice
from .box import Box, make_box
from .integrator import (State, StepConfig, make_state, mobility,
                         state_from_arrays, step)
from .params import PSEParams, make_params

__version__ = "0.1.0"
