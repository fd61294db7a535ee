"""Discrete-event replicated serving of the port: arrivals -> queueing master
-> engine (``repro.serving``'s twin)."""

from .arrivals import (
    ArrivalProcess,
    DeterministicArrivals,
    MMPPArrivals,
    MultiTenantArrivals,
    PoissonArrivals,
    TraceArrivals,
    make_arrivals,
)
from .engine import (
    ReplicatedServingEngine,
    RequestStats,
    ServeEngineConfig,
)
from .queueing import (
    AdmissionQueue,
    BatchJob,
    ClonePolicy,
    EventDrivenMaster,
    HedgedDispatchPolicy,
    NoOpPolicy,
    QueuePolicy,
    RelaunchPolicy,
    Request,
    SpeculationPolicy,
    StragglerPolicy,
    partition_requests,
)

__all__ = [
    "AdmissionQueue",
    "ArrivalProcess",
    "BatchJob",
    "ClonePolicy",
    "DeterministicArrivals",
    "EventDrivenMaster",
    "HedgedDispatchPolicy",
    "MMPPArrivals",
    "MultiTenantArrivals",
    "NoOpPolicy",
    "PoissonArrivals",
    "QueuePolicy",
    "RelaunchPolicy",
    "ReplicatedServingEngine",
    "Request",
    "RequestStats",
    "ServeEngineConfig",
    "SpeculationPolicy",
    "StragglerPolicy",
    "TraceArrivals",
    "make_arrivals",
    "partition_requests",
]
