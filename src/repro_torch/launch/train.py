"""End-to-end training driver with the paper's replication runtime, the
port of ``repro.launch.train``.

Execution model: the N workers are *virtual*: each is a data-axis
coordinate whose gradient work is actually executed on the device (grads
are real, one backward per distinct batch with a used replica, since
replicas are bit-identical) and whose service time is drawn from the
calibrated straggler model (``core.simulator.StepTimeSimulator``).  The
master applies the paper's completion rule (fastest replica per batch),
aggregates (``aggregate_host``, or the int8 error-feedback reduction),
steps AdamW, advances a SIMULATED wall clock, feeds the tuner, reacts to
faults, and checkpoints.  Every B decision (online tuning, fault recovery,
elastic restarts) routes through ONE ``Planner`` built from the
``TrainerConfig``; the active assignment is the single worker->batch map
used by the completion rule, the data feed, fault coverage, and gradient
aggregation.

On the card every attention layer's forward is the Hopper flash kernel
(``FlashAttentionFn``: causal, and whisper's bidirectional encoder and
cross attention) and every Mamba-2 block's scan the SSD scan kernel
(``SsdScanFn``), each with a tensor-op backward; the rest of the model is
PyTorch.  ``Trainer(tc, device=None)`` runs on CUDA and raises without a
card; ``device="cpu"`` runs on the host (the kernels' plain versions, the
planners' plain sweeps).  Every config trains: the dense (qwen2-0.5b,
qwen2.5-14b, command-r-plus-104b, granite-34b), MoE (olmoe-1b-7b,
deepseek-moe-16b), VLM (internvl2-76b: patch embeddings from the data
stream, loss on the text positions), audio (whisper-medium: frames to
the encoder, tokens to the decoder), xLSTM (xlstm-350m) and hybrid
(zamba2-7b) families.  A step drops its per-batch gradient trees once
they are aggregated, and AdamW updates the state and parameters in
place, so the update holds one float32 gradient tree and one state.

Run:  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
          --steps 100 --workers 8 --batches 4 [--device cpu]
      PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs.base import ShapeCell, get_config, reduced_config
from ..core import (
    ClusterSpec,
    Exponential,
    FaultEvent,
    ReplicationPlan,
    ShiftedExponential,
    StepTimeSimulator,
    StragglerTuner,
    TunerConfig,
    aggregate_host,
    censored_observations,
    completion_from_step_times,
    make_planner,
    replica_major_nonoverlapping,
)
from ..data import TokenPipeline
from ..device import resolve_device
from ..distributed import (
    FaultManager,
    RescaleExecutor,
    RuntimeTopology,
    StragglerDetector,
)
from ..models import init_params
from ..optim import AdamWConfig, init as opt_init, update_ as opt_update_
from ..optim import warmup_cosine
from ..optim.compression import compressed_reduce_host, init_error_state
from ..tree import tree_map
from .steps import value_and_grad

__all__ = ["TrainerConfig", "Trainer", "TrainResult", "main"]


@dataclasses.dataclass
class TrainerConfig:
    arch: str = "qwen2-0.5b"
    reduced: bool = True
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 32
    n_workers: int = 8  # the paper's N (virtual pods)
    n_batches: int = 4  # the paper's B (replication r = N/B)
    lr: float = 3e-4
    warmup: int = 20
    seed: int = 0
    # straggler model (per unit of data)
    service: str = "sexp"  # 'exp' | 'sexp'
    delta: float = 1.0
    mu: float = 2.0
    slow_workers: Optional[dict[int, float]] = None
    faults: tuple[FaultEvent, ...] = ()
    # control plane — every B decision routes through ONE Planner built from
    # these knobs (see repro_torch.core.planner.make_planner)
    tuner: bool = False
    tuner_metric: str = "mean"
    # 'empirical' plans over bootstrap resamples of the observed window
    planner_mode: str = "analytic"  # 'analytic' | 'simulate' | 'empirical'
    planner_heterogeneous: bool = False  # rate-aware simulated re-plans
    # KS goodness-of-fit gate: rejected parametric fits make the tuner
    # re-plan through the empirical path for that attempt (None = off)
    gof_alpha: Optional[float] = None
    drop_stragglers: bool = True
    grad_compression: bool = False
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50


@dataclasses.dataclass
class TrainResult:
    losses: list
    sim_times: list  # per-step completion time (simulated seconds)
    wall_time: float
    plan_history: list  # (step, B)
    events: list  # strings
    final_plan: ReplicationPlan

    @property
    def total_sim_time(self) -> float:
        return float(np.sum(self.sim_times))


class Trainer:
    def __init__(self, tc: TrainerConfig, device=None):
        self.tc = tc
        self.device = resolve_device(device)
        dev = self.device.type  # the planners' device argument
        cfg = get_config(tc.arch)
        if tc.reduced:
            cfg = reduced_config(cfg)
        self.cfg = cfg
        self.plan = ReplicationPlan(n_data=tc.n_workers, n_batches=tc.n_batches)
        cell = ShapeCell("driver", tc.seq_len, tc.global_batch, "train")
        self.pipeline = TokenPipeline(cfg, cell, seed=tc.seed)
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.params = init_params(gen, cfg, self.device)
        self.adamw = AdamWConfig()
        self.opt_state = opt_init(self.params, self.adamw)
        self.schedule = warmup_cosine(tc.lr, tc.warmup, tc.steps)
        if tc.service == "exp":
            self.dist = Exponential(mu=tc.mu)
        else:
            self.dist = ShiftedExponential(delta=tc.delta, mu=tc.mu)
        self.sim = StepTimeSimulator(
            self.dist,
            tc.n_workers,
            seed=tc.seed + 1,
            slow_workers=tc.slow_workers,
            faults=tc.faults,
        )
        # ONE ClusterSpec + ONE Planner drive the whole control plane:
        # the online tuner, fault recovery, and elastic re-plans all call
        # Planner.plan on (descendants of) this spec.
        self.cluster_spec = ClusterSpec(
            n_workers=tc.n_workers, dist=self.dist,
            batch_divisor=tc.global_batch,
        )
        self.planner = make_planner(
            mode=tc.planner_mode, heterogeneous=tc.planner_heterogeneous,
            device=dev,
        )
        self.assignment = replica_major_nonoverlapping(
            tc.n_workers, tc.n_batches
        )
        self.tuner = StragglerTuner(
            self.plan,
            TunerConfig(metric=tc.tuner_metric, gof_alpha=tc.gof_alpha,
                        device=dev),
            planner=self.planner,
            batch_divisor=self.cluster_spec.batch_divisor,
        )
        self.detector = StragglerDetector(tc.n_workers)
        self.faultmgr = self._make_faultmgr()
        # topology bookkeeper for every rescale (fault recovery + operator
        # shrink).  planner=None on a rate-incapable planner lets the
        # executor upgrade to a rate-aware one when live rates are present.
        self.rescaler = RescaleExecutor(
            RuntimeTopology(self.plan, generation=0,
                            assignment=self.assignment),
            planner=self.planner if self.planner.consumes_rates else None,
            device=dev,
        )
        self.ckpt = (
            Checkpointer(tc.checkpoint_dir) if tc.checkpoint_dir else None
        )
        self.error_state = (
            [init_error_state(self.params) for _ in range(tc.n_workers)]
            if tc.grad_compression
            else None
        )

    def _grad_fn(self, params, batch):
        """(loss, float32 grads) of one batch: one backward pass."""
        (loss, _), g = value_and_grad(self.cfg, params, batch)
        return loss, tree_map(lambda x: x.to(torch.float32), g)

    def _opt_fn(self, grad, opt_state, params, lr):
        return opt_update_(grad, opt_state, params, lr, self.adamw)

    def _device_batch(self, data: dict) -> dict:
        """The numpy batch on the trainer's device: the integer entries
        (tokens, labels) as ``long``, the float ones (audio frames, patch
        embeddings) float32 as drawn (the models cast them)."""
        return {k: torch.from_numpy(v).to(self.device,
                                          torch.long if v.dtype.kind in "iu"
                                          else torch.float32)
                for k, v in data.items()}

    # -- one step -----------------------------------------------------------
    def step(self, step_idx: int):
        tc = self.tc
        plan = self.plan
        # ONE worker->batch map (the active Plan's assignment) drives the
        # completion rule, the data feed, fault coverage, and aggregation.
        assignment = self.assignment
        loads = assignment.worker_load() / plan.replication  # data units
        times = self.sim.next_step(loads=loads)

        # straggler drops decided from PREVIOUS steps (one-step delay)
        keep = (
            self.detector.drop_mask() if tc.drop_stragglers else None
        )
        self.faultmgr.heartbeat(np.isfinite(times))
        decision = self.faultmgr.decide(keep, assignment=assignment)

        # apply the paper's completion rule on the surviving workers
        eff_times = times.copy()
        eff_times[~decision.alive] = np.inf
        completion, used = completion_from_step_times(eff_times, assignment)

        # gradients: one REAL backward per distinct batch with >=1 used worker
        losses, grads_per_worker = [], [None] * plan.n_data
        batch_grads = {}
        for w in range(plan.n_data):
            if not used[w]:
                continue
            b = assignment.worker_batch[w]
            if b not in batch_grads:
                data = self.pipeline.batch_for(step_idx, b, plan.n_batches)
                loss, batch_grads[b] = self._grad_fn(
                    self.params, self._device_batch(data))
                losses.append(float(loss))
            grads_per_worker[w] = batch_grads[b]

        alive_used = np.array([g is not None for g in grads_per_worker])
        if self.error_state is not None:
            # `used` marks exactly ONE worker per covered batch (the fastest
            # finite replica), so this mean is already a mean over batches
            trees = [g for g in grads_per_worker if g is not None]
            errs = [
                self.error_state[w]
                for w in range(plan.n_data)
                if grads_per_worker[w] is not None
            ]
            grad, new_errs = compressed_reduce_host(trees, errs)
            it = iter(new_errs)
            for w in range(plan.n_data):
                if grads_per_worker[w] is not None:
                    self.error_state[w] = next(it)
        else:
            grad, _ = aggregate_host(
                grads_per_worker, alive_used, plan,
                worker_batch=assignment.worker_batch,
            )
        del grads_per_worker, batch_grads  # only ``grad`` reaches AdamW

        lr = self.schedule(step_idx)
        self.params, self.opt_state, om = self._opt_fn(
            grad, self.opt_state, self.params, lr
        )

        # telemetry (normalized per unit of data): unused replicas are
        # cancelled at their batch's first response, so their times are
        # right-censored AT the cancellation point (core.censored_observations).
        # eff_times, not raw draws: the master only sees responses from
        # workers it still listens to, so cancellation clocks run on them.
        finite = np.isfinite(times)
        observed, censored = censored_observations(eff_times, assignment, used)
        observed = np.where(np.isfinite(observed), observed, completion)
        unit_times = observed / np.maximum(loads, 1e-9)
        self.detector.observe(np.where(finite, times, np.nan))
        self.tuner.observe(unit_times, censored)
        return float(np.mean(losses)), completion, decision

    # -- loop ---------------------------------------------------------------
    def run(self) -> TrainResult:
        tc = self.tc
        losses, sim_times, events = [], [], []
        plan_history = [(0, self.plan.n_batches)]
        t0 = time.time()
        step_idx = 0
        while step_idx < tc.steps:
            loss, completion, decision = self.step(step_idx)
            losses.append(loss)
            sim_times.append(completion)
            if decision.kind != "ok":
                events.append(f"step {step_idx}: fault decision {decision.kind}"
                              f" lost_batches={decision.lost_batches}")
            if decision.needs_restart:
                # whole replica group lost: restore + re-plan
                events.append(f"step {step_idx}: elastic re-plan triggered")
                self._elastic_replan(decision)
                plan_history.append((step_idx, self.plan.n_batches))
            if tc.tuner:
                rp = self.tuner.maybe_replan()
                if rp is not None:
                    events.append(
                        f"step {step_idx}: tuner B {rp.old_batches}->"
                        f"{rp.new_batches} (pred {rp.predicted_improvement:.1%})"
                    )
                    self.plan = self.tuner.apply(rp)
                    self._adopt_assignment(
                        rp.plan.assignment if rp.plan is not None else None
                    )
                    self.faultmgr = self._make_faultmgr()
                    plan_history.append((step_idx, self.plan.n_batches))
            if self.ckpt and (step_idx + 1) % tc.checkpoint_every == 0:
                self.ckpt.save_async(
                    step_idx + 1,
                    {"params": self.params, "opt": self.opt_state},
                    {"plan_batches": self.plan.n_batches, "step": step_idx + 1},
                )
            step_idx += 1
        if self.ckpt:
            self.ckpt.wait()
        return TrainResult(
            losses=losses,
            sim_times=sim_times,
            wall_time=time.time() - t0,
            plan_history=plan_history,
            events=events,
            final_plan=self.plan,
        )

    def _make_faultmgr(self) -> FaultManager:
        """A FaultManager whose recovery solver matches the trainer's planner.

        A rate-incapable planner is NOT pinned (planner=None): plan_recovery
        then upgrades to a rate-aware solver whenever live worker rates are
        available, falling back to the analytic one otherwise.
        """
        return FaultManager(
            self.plan,
            planner=self.planner if self.planner.consumes_rates else None,
            device=self.device.type,
        )

    def _live_rates(self):
        """Live per-worker rate estimates from the tuner's telemetry window.

        None until a clean window spanning the CURRENT fleet size exists —
        callers then recover homogeneously from the ground-truth dist.
        """
        rates = self.tuner.worker_rates()
        if rates is None or len(rates) != self.plan.n_data:
            return None
        return rates

    def shrink(self, n_lost: int) -> RuntimeTopology:
        """Operator-initiated elastic shrink: shed ``n_lost`` workers.

        Live tuner telemetry makes the shed RATE-AWARE: the n_lost slowest
        workers (by observed rates) are dropped and B re-planned for the
        survivors through the unified planner; without telemetry the fleet
        shrinks homogeneously.  Rebuilds the runtime state around the new
        topology (same path as fault recovery).
        """
        topo = self.rescaler.shrink(
            n_lost, self.dist, rates=self._live_rates(),
            metric=self.tc.tuner_metric,
            batch_divisor=self.cluster_spec.batch_divisor,
        )
        self.plan = topo.plan
        self.cluster_spec = dataclasses.replace(
            self.cluster_spec, n_workers=topo.n_workers,
            rates=None, feasible_b=None,
        )
        self._adopt_assignment(topo.assignment)
        self._rebuild_runtime(topo.n_workers)
        return topo

    def _rebuild_runtime(self, n_alive: int) -> None:
        """Re-create the per-fleet-size runtime companions after a rescale."""
        self.tuner = StragglerTuner(
            self.plan, self.tuner.config, planner=self.planner,
            batch_divisor=self.cluster_spec.batch_divisor,
        )
        self.faultmgr = self._make_faultmgr()
        self.detector = StragglerDetector(n_alive)
        self.sim = StepTimeSimulator(
            self.dist, n_alive, seed=self.tc.seed + 17
        )
        if self.error_state is not None:
            self.error_state = self.error_state[:n_alive]

    def _adopt_assignment(self, assignment=None):
        """Install the active worker->batch placement (from a planner Plan
        when its fleet size matches, replica-major balanced otherwise)."""
        if (
            assignment is not None
            and assignment.n_workers == self.plan.n_data
            and assignment.n_batches == self.plan.n_batches
        ):
            self.assignment = assignment
        else:
            self.assignment = replica_major_nonoverlapping(
                self.plan.n_data, self.plan.n_batches
            )

    def _elastic_replan(self, decision):
        """Restore from checkpoint (if any) and re-plan B for the surviving
        fleet through the unified planner (FaultManager.plan_recovery).

        Live per-worker rates from the tuner's telemetry window flow into
        the recovery spec, so a skew-aware solver places the survivors by
        their OBSERVED speeds instead of recovering homogeneously from the
        ground-truth dist.
        """
        recovery = self.faultmgr.plan_recovery(
            self.cluster_spec.dist,
            rates=self._live_rates(),
            batch_divisor=self.cluster_spec.batch_divisor,
        )
        n_alive = recovery.n_workers
        if self.ckpt is not None:
            try:
                state, meta = self.ckpt.restore(
                    {"params": self.params, "opt": self.opt_state}
                )
                self.params, self.opt_state = state["params"], state["opt"]
            except FileNotFoundError:
                pass
        self.plan = recovery.replication
        self.cluster_spec = recovery.spec  # the survivors are the fleet now
        self.rescaler.apply_plan(recovery)  # topology generation bump
        self._adopt_assignment(recovery.assignment)
        self._rebuild_runtime(n_alive)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="any of the ten configs, in its reduced form")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--service", default="sexp", choices=["exp", "sexp"])
    ap.add_argument("--delta", type=float, default=1.0)
    ap.add_argument("--mu", type=float, default=2.0)
    ap.add_argument("--tuner", action="store_true")
    ap.add_argument("--planner-mode", default="analytic",
                    choices=["analytic", "simulate", "empirical"])
    ap.add_argument("--rate-aware", action="store_true",
                    help="heterogeneous (rate-aware) simulated re-plans")
    ap.add_argument("--gof-alpha", type=float, default=None,
                    help="KS goodness-of-fit gate significance: rejected "
                         "parametric fits re-plan through the empirical path")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    tc = TrainerConfig(
        arch=args.arch,
        steps=args.steps,
        n_workers=args.workers,
        n_batches=args.batches,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        service=args.service,
        delta=args.delta,
        mu=args.mu,
        tuner=args.tuner,
        planner_mode=args.planner_mode,
        planner_heterogeneous=args.rate_aware,
        gof_alpha=args.gof_alpha,
        grad_compression=args.compress,
        checkpoint_dir=args.ckpt_dir,
    )
    res = Trainer(tc, device=args.device).run()
    print(f"final loss {res.losses[-1]:.4f} (from {res.losses[0]:.4f})")
    print(f"simulated time {res.total_sim_time:.1f}s over {len(res.losses)} steps")
    print(f"wall time {res.wall_time:.1f}s; plan history {res.plan_history}")
    for e in res.events[:20]:
        print(" ", e)


if __name__ == "__main__":
    main()
