"""PyTorch and CUDA port of the replication planner (``repro``'s twin).

The package runs these paths on an NVIDIA GPU through hand-written CUDA
kernels:

* planning — ``ClusterSpec`` + ``Objective`` -> ``SimulatedPlanner.plan()``
  -> ``Plan`` — through the sojourn scan (``sojourn_cells``), the k-of-N
  selection (``coded_cells``) and the coded combine (``combine``); with
  ``Objective.slo_classes`` the multi-tenant serving sweep
  (``core.simulator.sweep_sojourn_serving``: a host-side WFQ formation
  pre-pass, then ``sojourn_cells``) picks B, policy, max_wait and shed;
* LM serving — ``launch.serve.generate`` / ``run_serving`` (prefill and
  greedy decode of the dense family, qwen2-0.5b, and of the hybrid
  family, zamba2-7b, then the fleet plan) — through flash attention
  (``flash_attention``) in prefill, split-KV decode attention
  (``decode_attention``) in decode, and the SSD chunked scan
  (``ssd_scan``) in every Mamba-2 block of prefill;
* the replicated serving engine — ``serving.ReplicatedServingEngine``:
  requests arrive (``serving.arrivals``), the event-driven master
  (``serving.queueing``) forms batches and dispatches each to r = N/B
  replica sets, the fastest wins, and the tuner re-plans B, the policy,
  ``max_wait`` and shedding from the engine's own telemetry — through
  ``sojourn_cells`` in every simulated plan and re-plan (the serving
  sweep with tenant classes), and, with ``execute_model``, prefill and
  decode of every completed batch on ``flash_attention``,
  ``decode_attention`` and (hybrid) ``ssd_scan``;
* the distributed control plane and the cluster runtime --
  ``distributed`` (``FaultManager``: heartbeats, mask or re-plan, recovery
  through the planner; ``RescaleExecutor``: re-plans, shrinks that shed the
  slowest workers; the replication-aware collectives on
  ``torch.distributed``), ``core.replication`` (the (replica, batch,
  model) ``DeviceMesh`` and straggler-drop gradient aggregation) and
  ``cluster`` (``ClusterCoordinator`` over real worker processes on
  localhost sockets, ``LocalCluster``, chaos injection;
  ``python -m repro_torch.launch.cluster``) -- through ``sojourn_cells`` in
  the coordinator's simulated plans and its tuner's load-aware re-plans,
  with recoveries and shrinks of rate-skewed fleets scored on the device by
  the coverage rule, and the workers' ``matmul`` payloads on the card.

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``;
``import repro_torch`` itself loads neither until a name is used.

Device rule: every entry point takes ``device=None``, which means
``"cuda"`` and raises ``RuntimeError`` when no card is visible; the CPU
runs only when asked for (``device="cpu"``), through the kernels' plain
PyTorch versions.
"""

__all__ = ["device_name", "resolve_device"]


def __getattr__(name):
    # the device rule imports torch on first use, so a process that needs
    # only the cluster's protocol and sleep payloads (a worker) starts
    # without it
    if name in __all__:
        from . import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
