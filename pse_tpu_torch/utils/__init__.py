"""Host-side helpers: trajectory writers (GSD, npz), the device probe and
the compilation-cache shim."""

from . import cache
