"""The port's ``core`` re-exports every public name of the reference's.

Code written against ``repro.core`` (the reference's cluster coordinator
imports ``Metric`` and ``ServiceDistribution`` from it) imports unchanged
from ``repro_torch.core``.  Each name resolves to an object of the port,
never of the reference.
"""

import inspect

import pytest

import repro.core as R
import repro_torch.core as T


def test_port_core_exports_every_reference_name():
    missing = [n for n in R.__all__ if not hasattr(T, n)]
    assert missing == []
    assert set(R.__all__) <= set(T.__all__)


@pytest.mark.parametrize("name", sorted(R.__all__))
def test_each_reference_name_resolves_in_the_port(name):
    obj = getattr(T, name)
    ref = getattr(R, name)
    if inspect.ismodule(obj):
        assert obj.__name__.startswith("repro_torch."), name
    elif inspect.isclass(obj) or inspect.isfunction(obj):
        assert obj.__module__.startswith("repro_torch."), (name, obj)
    if isinstance(ref, type):
        assert isinstance(obj, type) and obj.__name__ == ref.__name__
    elif callable(ref):
        assert callable(obj)
