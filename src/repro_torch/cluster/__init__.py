"""Multi-process cluster runtime: the serving master on real sockets.

The simulated master (:mod:`repro_torch.serving.queueing`) and this package share
one policy layer; here the workers are OS processes, the clock is the wall
clock, and the telemetry that feeds :class:`~repro_torch.core.tuner.StragglerTuner`
is measured, censored at real cancellation instants.  The protocol, the
payloads and the failure model are the reference's (``repro_torch.cluster``);
here every planner of the control plane runs on a torch device
(``ClusterConfig.device``, None meaning ``"cuda"``), and so do the
workers' ``matmul`` payloads.  ``python -m repro_torch.launch.cluster
--help`` shows the CLI.
"""

import importlib

# the package's names load on first use: a worker process imports only
# ``protocol`` and ``payloads`` (stdlib and numpy), and its start-up never
# waits for torch and the control plane
_SOURCES = {
    "chaos": ("ChaosEvent", "ChaosInjector", "drive"),
    "coordinator": ("ClusterConfig", "ClusterCoordinator", "ClusterJob",
                    "WorkerHandle"),
    "harness": ("LocalCluster", "reap_orphans"),
    "payloads": ("coded_data_blocks", "make_coded_spec",
                 "make_deterministic_spec", "make_matmul_spec",
                 "make_sleep_spec", "payload_duration", "run_payload"),
    "protocol": ("FrameDecoder", "encode_message", "send_message"),
}
# NOTE: repro_torch.cluster.worker is deliberately NOT listed here — worker
# processes start via ``python -m repro_torch.cluster.worker`` and importing the
# module from the package would make runpy execute it twice.
_MODULE_OF = {name: mod for mod, names in _SOURCES.items() for name in names}

__all__ = [name for names in _SOURCES.values() for name in names]


def __getattr__(name):
    if name in _MODULE_OF:
        module = importlib.import_module(f"{__name__}.{_MODULE_OF[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
