"""Reference-shaped entry point: ``pse_tpu_torch.integrate.PSEv1`` mirrors
``hoomd.PSEv1.integrate.PSEv1`` (PSEv1/integrate.py:32)."""

from .api import PSEv1, Simulation, create_lattice

__all__ = ["PSEv1", "Simulation", "create_lattice"]
