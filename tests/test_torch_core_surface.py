"""The port's ``core`` re-exports every public name of the reference's.

Code written against ``repro.core`` (the reference's cluster coordinator
imports ``Metric`` and ``ServiceDistribution`` from it) imports unchanged
from ``repro_torch.core``.  Each name resolves to an object of the port,
never of the reference.

Every name ``repro.launch`` and ``repro.roofline`` export has a
counterpart in ``repro_torch.launch`` and ``repro_torch.roofline``: the
same name, or the one listed where the port's takes a mesh shape or the
port's counts in place of a compiled XLA module.  Not ported, and listed
with their reason: the names that read XLA's HLO or a TPU pod's links.
The roofline's modules ``hlo_cost``, ``kernel_model`` and ``hillclimb``
each have a counterpart (``hlo_cost``'s is ``op_cost``, a walker of the
aten ops a step dispatches) defining every public name of the
reference's module, or its listed rename.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import ast
import inspect

import pytest

import importlib

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
# reference roofline module -> the port's, and names the port renames
ROOFLINE_MODULES = {"hlo_cost": "op_cost", "kernel_model": "kernel_model",
                    "hillclimb": "hillclimb"}
RENAMED_IN_MODULES = {"walk_hlo": "walk_ops", "HloCost": "OpCost",
                      "top_instructions": "top_ops"}


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


def _public_names(module):
    """``__all__`` and the public functions, classes and constants the
    module's own source defines at its top level."""
    names = set(getattr(module, "__all__", ()))
    for node in ast.parse(inspect.getsource(module)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("module", sorted(ROOFLINE_MODULES))
def test_xla_roofline_modules_are_not_ported(module):
    """Each XLA-reading roofline module of the reference has its port's
    counterpart, defining every public name of it (or its rename).  The
    test keeps the name it had while these modules were pinned absent;
    what it now asserts is that they are ported."""
    ref = importlib.import_module(f"repro.roofline.{module}")
    port = importlib.import_module(
        f"repro_torch.roofline.{ROOFLINE_MODULES[module]}")
    names = _public_names(ref)
    assert names, module
    for name in sorted(names):
        ported = RENAMED_IN_MODULES.get(name, name)
        assert hasattr(port, ported), (
            f"{port.__name__} has no counterpart of "
            f"repro.roofline.{module}.{name} (looked for {ported})")
        obj = getattr(port, ported)
        if inspect.isfunction(obj) or inspect.isclass(obj):
            assert obj.__module__ == port.__name__, (name, obj)
    exported = {RENAMED_IN_MODULES.get(n, n)
                for n in getattr(ref, "__all__", ())}
    assert exported <= set(getattr(port, "__all__", exported))
