"""The step over several devices in one process: the halo x-slab banded
engine (``halo``) and the near field split over a mesh (``sharding``)."""
