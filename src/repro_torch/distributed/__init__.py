"""Distributed control and data plane of the port: replication-aware
collectives on ``torch.distributed``, elastic rescaling, fault tolerance
and straggler detection."""

from .collectives import (
    allreduce_bytes,
    hierarchical_allreduce,
    replication_aware_pmean,
)
from .elastic import RescaleExecutor, RuntimeTopology
from .fault import FaultDecision, FaultManager, StragglerDetector

__all__ = [
    "allreduce_bytes",
    "hierarchical_allreduce",
    "replication_aware_pmean",
    "RescaleExecutor",
    "RuntimeTopology",
    "FaultDecision",
    "FaultManager",
    "StragglerDetector",
]
