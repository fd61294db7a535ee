"""The port's ``core`` re-exports every public name of the reference's.

Code written against ``repro.core`` (the reference's cluster coordinator
imports ``Metric`` and ``ServiceDistribution`` from it) imports unchanged
from ``repro_torch.core``.  Each name resolves to an object of the port,
never of the reference.

Every name ``repro.launch`` and ``repro.roofline`` export has a
counterpart in ``repro_torch.launch`` and ``repro_torch.roofline``: the
same name, or the one listed where the port's takes a mesh shape or the
port's counts in place of a compiled XLA module.  Not ported, and listed
with their reason: the names that read XLA's HLO or a TPU pod's links,
and the modules ``hlo_cost`` (a walker of XLA HLO text), ``kernel_model``
(imports jax and lowers the XLA attention) and ``hillclimb`` (reads their
reports).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import inspect

import pytest

import importlib.util

import repro.core as R
import repro.launch as RL
import repro.roofline as RR
import repro_torch.core as T
import repro_torch.launch as TL
import repro_torch.roofline as TR


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


# reference name -> the port's, where the port's differs
RENAMED = {
    "make_production_mesh": "production_mesh_shape",  # a mesh shape
    "make_rdp_production_mesh": "rdp_production_mesh_shape",
    "analyze_compiled": "analyze_cell",  # counts, not a compiled module
}
NOT_PORTED = {
    "parse_collectives": "reads the optimized XLA HLO text",
    "ICI_BW": "a TPU pod's links; one H100 rank runs no collective",
    "DCI_BW": "a TPU pod's links; one H100 rank runs no collective",
}
NOT_PORTED_MODULES = {
    "hlo_cost": "walks XLA HLO text",
    "kernel_model": "imports jax and lowers the XLA attention",
    "hillclimb": "reads hlo_cost's and kernel_model's reports",
}


@pytest.mark.parametrize("ref,port", [(RL, TL), (RR, TR)],
                         ids=["launch", "roofline"])
def test_launch_and_roofline_names_have_counterparts(ref, port):
    for name in ref.__all__:
        if name in NOT_PORTED:
            assert not hasattr(port, name), name
            continue
        obj = getattr(port, RENAMED.get(name, name))
        assert RENAMED.get(name, name) in port.__all__, name
        if callable(obj):
            assert obj.__module__.startswith("repro_torch."), (name, obj)


@pytest.mark.parametrize("module", sorted(NOT_PORTED_MODULES))
def test_xla_roofline_modules_are_not_ported(module):
    assert importlib.util.find_spec(f"repro.roofline.{module}") is not None
    assert importlib.util.find_spec(f"repro_torch.roofline.{module}") is None
