"""The port's top-level API against the JAX package's: the names it exports
and the warnings ``PSEv1`` gives.  CPU only; nothing here runs a step."""

import warnings

import pytest

torch = pytest.importorskip("torch")

import pse_tpu as J                          # noqa: E402

import pse_tpu_torch as P                    # noqa: E402
from pse_tpu_torch import integrator as pi   # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mobility_is_exported_at_the_top_level():
    """``pse_tpu.mobility`` has its counterpart in the port."""
    assert callable(J.mobility)
    assert P.mobility is pi.mobility


@pytest.mark.parametrize("pkg", [J, P], ids=["jax", "torch"])
def test_nlist_tree_warns_in_both_packages(pkg):
    """nlist_type='tree' is accepted for API parity and warns, in the JAX
    package and in the port alike; the port's warning speaks of its own
    engine, not of the TPU."""
    PSEv1 = J.integrate.PSEv1 if pkg is J else P.PSEv1
    with pytest.warns(UserWarning, match="tree") as rec:
        m = PSEv1(nlist_type="tree")
    assert m.nlist_type == "tree"
    if pkg is P:
        msg = str(rec[0].message)
        assert "TPU" not in msg and "GPU banded engine" in msg


@pytest.mark.parametrize("nlist_type", ["cell", "stencil", "CELL"])
def test_other_nlist_types_do_not_warn(nlist_type):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert P.PSEv1(nlist_type=nlist_type).nlist_type == nlist_type


def test_unknown_nlist_type_raises_as_in_the_jax_package():
    for PSEv1 in (J.integrate.PSEv1, P.PSEv1):
        with pytest.raises(ValueError, match="Invalid neighborlist"):
            PSEv1(nlist_type="octree")
