#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card through its six hand-written
CUDA kernels, in the phases below; any failure raises and the script exits
non-zero:

1. ``build``          compile ``src/repro_torch/csrc/*.cu`` with nvcc
                      (one process per source, in parallel) into
                      ``build/repro_torch_kernels/``.
2. ``plan_policies``  the fleet's planner call: N=10,000 workers,
                      20,000 jobs, B in {50..2000}, four straggler
                      policies, p99 at utilization 0.7; one
                      ``sojourn_cells`` launch.  Then a small plan
                      run on the card and on the CPU (the kernels' plain
                      versions) must agree exactly.
2b. ``plan_wide``     a fleet wider than the staged ``sojourn_cells``
                      kernel holds (11,520 sets on the H100): first the
                      kernel, all four policy kinds, bit-equal to its plain
                      version on 1,000 jobs at G 11,520 (staged), 11,521,
                      16,384 and 65,536 (unstaged) and in one launch of
                      cells of 0, 1, 11,520, 11,521 and 16,384 sets, and
                      in one launch of cells of K - 1, K and K + 1 sets
                      padded to 65,536 (K its split there: the sets whose
                      hot words sit in shared memory); the unstaged kernel
                      forced onto phase 2's dispatch, and onto 12,000 jobs
                      over cells of 5,000 and 10,000 sets (sets revisited
                      in two and three groups of nodes), equal to the
                      staged one on every job; the build's ptxas figures
                      of each instantiation, the staged ones against PR
                      28's; phase 2's dispatch re-timed on the staged one
                      and on the unstaged one.  Then
                      ``SimulatedPlanner`` at N 16,384, SExp(0.05, 2.0), B
                      in {2,048, 4,096, 8,192, 16,384} (r = 1 included),
                      phase 2's objective, 4,000 trials: one
                      ``sojourn_cells`` launch, the reference's pinned
                      decision and points (``WIDE_FLEET``), its dispatch
                      bit-equal to the plain version on its first 1,000
                      jobs, its wall, stages and times.
3. ``fleet_grid``     ``sweep_sojourn_policies`` on the bootstrap grid of
                      ``benchmarks/bench_sweep_kernel.py``: 256 Empirical
                      resamples x B in {50, 100, 200} x 4 policies, J=300;
                      one ``sojourn_cells`` launch.
4. ``plan_coded``     the coded headline of ``benchmarks/bench_coding.py``
                      (mds s in {4, 8, 12}, overheads measured by the
                      ``combine`` kernel); the winner must be mds(s=12).
                      Then the same candidates under a load-aware p99.
                      Then ``coded_fleet``: ``sweep_coded`` at
                      plan_policies' fleet (N=10,000, SExp(0.05, 2.0), mds
                      s in {100, 1,000, 2,500}, 2,000 trials): one
                      ``coded_cells`` launch over 3 x 2,000 x 10,000 cells.
4b. ``plan_serving``  the multi-tenant serving plan of
                      ``benchmarks/bench_multitenant.py`` (16 groups,
                      SExp(0.02, 2.0), two tenant classes, utilization
                      0.95, max_waits {0.2, 0.5, inf}, sheds {none, cap 48,
                      expired}, policies {none, hedged 1.0}, 4,000
                      requests): on the card and on the CPU, the two plans
                      equal bit for bit and equal to the reference's
                      decision (B=2, max_wait inf, cap 48, policy none,
                      premium miss 0); 21 ``sojourn_cells`` launches (one
                      a (max_wait, shed) combo, one a (max_wait, split)
                      under cap).  Then ``serving_fleet``: the same
                      objective on 1,024 replicas, B in {16..256}, 40,000
                      requests (2 x 40,000 x 1,024 draws on the card), 21
                      launches; its cold and warm wall, stage seconds
                      (formation pre-pass, scoring) and, under the
                      profiler, the card's busy time and
                      ``sojourn_cells``' device time.
4c. ``tuner``        the re-plan loop: ``plan_heterogeneous``,
                      ``benchmarks/bench_planner.py``'s skewed fleet (N 64,
                      SExp(0.25, 1.0), rates [0.1] + linspace(0.7, 1.3,
                      63), 20,000 trials) under "mean" (the coverage rule,
                      float64), its ``drop_slowest(4)`` shrink, and a
                      load-aware p99 over {none, clone 0.9, relaunch 0.9,
                      hedged 0.1}: one ``sojourn_cells`` launch a B (7).
                      ``plan_empirical``: the bench's 2,000-draw pool at K
                      4, 16 and 64 under "mean", then K 16 under the p99
                      portfolio with mds s in {4, 8, 16} (overheads
                      measured by ``combine``): 2 ``sojourn_cells``
                      launches (the portfolio, the coded race's queue) and
                      one ``coded_cells``.  Each decision must be the
                      reference's (pinned by ``tests/test_torch_chip_
                      pins.py``) and the card's plans the CPU's (the
                      load-aware ones at 500 jobs).  ``tuner_switch``: the
                      online policy switch of ``benchmarks/bench_serving_
                      latency.py`` through ``StragglerTuner`` (the
                      reference's adopted policies, moves and final B).
                      ``tuner_fleet``: 1,024 workers from B 256, telemetry
                      from ``StepTimeSimulator`` (8 workers slowed 4x, a
                      fault, a lognormal pool from step 40), censored as
                      the paper's rule leaves it, re-planned by the
                      rate-aware planner and the goodness-of-fit gate's
                      empirical fallback (K 20 x 11 B x 4 policies in one
                      launch); each attempt's planner, wall against the
                      1 s budget, stages and launches, then each kind's
                      last re-plan under the profiler.  The widest
                      ``sojourn_cells`` dispatch of each p99 plan and of
                      each kind's last ``tuner_fleet`` re-plan is held
                      bit-equal to the plain version on its first 2,000
                      jobs at its own cells, groups and policies, and
                      ``plan_empirical``'s ``coded_cells`` call in full.
4d. ``engine``       the replicated serving engine
                      (``repro_torch.serving``).  ``engine_multitenant``:
                      ``benchmarks/bench_multitenant.py``'s two
                      deployments (16 groups, 4,000 requests): the FIFO
                      baseline misses the premium target, the swept
                      engine plans on the card (21 ``sojourn_cells``
                      launches: 3 x 2 + 3 x 5 feasible B) and holds both
                      class targets, and both
                      ``run_load`` results equal the reference's, pinned
                      by ``tests/test_torch_chip_pins.py``.
                      ``engine_fleet``: the same on 1,024 groups serving
                      40,000 requests, from the engine's own plan (4,000
                      trials, every B dividing 1,024: 3 x 2 + 3 x 11 = 39
                      launches), its widest ``sojourn_cells`` dispatch held
                      bit-equal to the plain version on its first 2,000
                      jobs; plan wall, event-loop wall and requests a
                      second.  ``engine_model``: the tuner-on engine
                      (qwen2-0.5b reduced, 16 groups from B 16, the p99
                      portfolio, 2,000 requests) with real prefill and
                      decode for every batch (``flash_attention``,
                      ``decode_attention``) and one ``sojourn_cells``
                      launch a re-plan: the reference's moves, final B,
                      policy and p99 sojourn, the launch counts the path
                      implies, every request's tokens, the first batch's
                      prefill logits within 0.125 of the CPU's; then
                      ``engine_hybrid`` (zamba2-7b reduced, 256 requests,
                      tuner off) adds ``ssd_scan``, its schedule the
                      model-free engine's on the CPU.
4e. ``cluster``      the distributed control plane and the cluster
                      runtime (``repro_torch.distributed``,
                      ``repro_torch.cluster``).  ``fault_fleet``: 1,024
                      workers from B 256 (SExp(0.05, 2.0), 32 at rate
                      0.25), one whole replica group dead: the port's
                      ``FaultManager`` decides ``replan`` and
                      ``plan_recovery(metric="p99")`` re-plans the 1,020
                      survivors on the card; ``RescaleExecutor.shrink(32)``
                      sheds the slow workers of the healthy fleet; both
                      make the reference's pinned decisions (B, the
                      worker->batch map's hash, the dropped ids; pinned by
                      ``tests/test_torch_chip_pins.py``), and the
                      recovery's coverage samples at its B equal the host
                      walk's on 2,000 trials.  ``cluster_live``:
                      ``benchmarks/bench_cluster.py``'s rows through the
                      port's ``LocalCluster`` (real worker processes on
                      localhost, the planners on the card): dispatch smoke,
                      the clone policy against r = 1 on 8 workers with an
                      8x straggler, the tuner re-plan with the bench's
                      analytic planner and with the default simulate one
                      (``sojourn_cells`` on the live path; its widest
                      dispatch bit-equal to the plain version on 2,000
                      jobs), and SIGKILL recovery, each held to the bench's
                      asserts.  ``cluster_matmul``: 2 workers serve 20
                      requests of 4 (2048 x 2048) matmuls on the card.
                      ``collectives``: in a one-rank NCCL group every
                      ``aggregate_gradients`` mode,
                      ``replication_aware_pmean`` and
                      ``hierarchical_allreduce`` return their input's mean
                      (their semantics across ranks are held on CPU gloo
                      only, in ``tests/test_torch_replication.py``).
5. ``serve``        qwen2-0.5b at full width (24 layers, d_model 896,
                      vocab 151,936; random bf16 weights from a seeded
                      generator) serves 8 prompts of 1,024 tokens and 32
                      new tokens each through ``generate`` (prefill on
                      ``flash_attention``, decode on ``decode_attention``),
                      with prefill and decode seconds and each one's idle
                      share under the profiler; the counted run's first
                      flash call and longest decode call (here and in every
                      serve path) held against the plain versions at
                      ATT_TOL, as phase 4d holds its calls.  Then the card
                      against the
                      CPU (full width, 2 layers, prompt 256, 4 decode
                      steps, the same weights): logits within 0.125, and
                      the same greedy token wherever the CPU's top-2
                      margin exceeds that.  Then ``run_serving`` at its
                      default (reduced model + fleet planner).
6. ``serve_hybrid``   zamba2-7b at full width and depth (81 layers,
                      d_model 3584, 13 shared-attention applications at
                      head dim 112; random bf16 weights) serves 8 prompts
                      of 1,024 tokens and 16 new tokens each: prefill on
                      ``ssd_scan`` (81 launches) and ``flash_attention``
                      (13), decode on ``decode_attention`` (195), with the
                      same measurements as ``serve`` and ``ssd_scan``'s
                      share of the profiled prefill's device time (its
                      bf16 tensor-core kernel must be there).  Then the card
                      against the CPU at full width and depth 7 (one
                      segment and one trailing block), prompt 256, 4
                      decode steps, as in ``serve``.  Then
                      ``run_serving(ServeConfig(arch="zamba2-7b"))``.
6b. ``train``         the training path (``repro_torch.launch.train``):
                      ``Trainer`` at qwen2-0.5b's full width and depth
                      (24 layers, d_model 896, vocab 151,936, random bf16
                      weights, float32 AdamW state), seq 512, global batch
                      32, 8 workers from B 4, worker 3 slowed 8x, the tuner
                      on the simulate planner, ``TRAIN_STEPS`` steps.
                      First, AdamW's float32 ``sqrt_`` on 2^26 values
                      (``torch.sqrt`` on the card) against the float64
                      root rounded back: none may differ.  Then, at step
                      0, every parameter leaf's gradient is
                      finite and every layer's attention projections get a
                      nonzero one (what a detached kernel output would
                      lose), and ``FlashAttentionFn``'s output and dq / dk /
                      dv at the path's shape (q 8 x 512 x 14 x 64, bf16,
                      causal) lie within 5e-2 x (1 + |plain|) of autograd
                      through the plain version.  Then the run: the loss
                      falls (mean of the last 5 below the first 5), the
                      tuner makes at least one re-plan attempt, and
                      ``flash_attention`` launches once a layer for each
                      distinct batch's backward pass; the plan history,
                      events, median step wall and peak memory are
                      printed, and after phase 7 two more steps run under
                      the profiler (busy time, idle share).
                      ``train_pins``: the reduced trainer on the card and
                      on the CPU from the same weights, workers 1 and 5
                      dead from step 3 and checkpoints every 2 steps, so
                      the card's elastic re-plan restores one: simulated
                      times, plan history, events, final plan and topology
                      generation equal exactly, losses within 2e-2.
6a. ``serve_dense``   the head-dim-128 dense configs at full width, random
                      bf16 weights: ``serve_qwen2_5_14b`` (48 layers, all
                      of them: 40 heads over 8 KV heads),
                      ``serve_command_r_plus`` (8 layers of 64: 96 over 8,
                      parallel blocks, LayerNorm, the tied 256,000-token
                      embedding) and ``serve_granite_34b`` (44 of 88: 48
                      heads over one KV head, GELU), one at a time, each
                      freed before the next: 8 prompts of 1,024 and 32 new
                      tokens as in ``serve``, flash launches = layers and
                      decode = layers x 31, the counted run's first flash
                      call and longest decode call held against the plain
                      versions, then the card against the CPU at full
                      width and depth 2 on prompts of 32.
6d. ``serve_families`` the last four families at full width, random bf16
                      weights, one model at a time, each freed before the
                      next, 8 prompts of 1,024 and 32 new tokens as in
                      ``serve`` (prefill and two decode steps profiled):
                      ``serve_olmoe`` (16 layers, 64 experts top-8) and
                      ``serve_deepseek_moe`` (28, dense layer 0, 64 routed
                      top-6 + 2 shared) through the MoE dispatch,
                      ``serve_internvl2`` (16 of 80 layers, 64 heads over
                      8) behind 256 projected patch slots, flash launches =
                      layers and decode = layers x 31; ``serve_xlstm``
                      (24 blocks, 21 mLSTM + 3 sLSTM), which runs no hand
                      kernel (every pin 0); ``serve_whisper`` (24 + 24
                      layers): ``encode`` of 1,500 frames, the cross cache
                      from ``_cross_kv``, 32 ``decode_step``s with
                      cross_len 1,500, then ``decode_train`` on those
                      tokens, held within 0.125 of the step logits (flash
                      72, decode 1,536).  The counted runs' first flash
                      and longest decode calls are held against the plain
                      versions; card against CPU at full width and small
                      depth (MoE 2, internvl2 2, whisper 2 + 2 on 128
                      frames, xLSTM 8 on prompts of 128, in float32: its
                      random-weight logits move by tenths at one bf16
                      rounding), logits within 0.125 (MoE: the card routed to the CPU's experts
                      call by call; the (token, layer) top-k sets the card
                      would have chosen otherwise, each a near-tie, and
                      the assignments dropped past capacity, printed).
6c. ``train_hybrid``  zamba2-7b trained at full width and depth 13 (two
                      segments of six Mamba-2 blocks and the shared block,
                      one trailing block; 1.45 G parameters) by ``Trainer``
                      for 24 steps: 4 workers from B 2, global batch 6 of
                      512 tokens, worker 3 slowed 8x, the simulate tuner.
                      At step 0 every leaf's gradient is finite, and each
                      Mamba-2 block's ``a_log``, ``dt_bias``, ``conv_w`` and
                      ``in_proj`` x / B / C / dt columns (which reach the
                      loss only through the scan) and the shared block's
                      wq and wk are nonzero; ``FlashAttentionFn`` at the
                      shared block's shape (3 x 512 x 32 x 112), output
                      and dq / dk / dv against autograd through the plain
                      version; ``SsdScanFn``'s forward at the path's shape
                      (views of one activation) against the plain version,
                      and its forward and forward + backward time.  Then
                      the run: the loss
                      falls, ``ssd_scan`` launches = Mamba-2 blocks x
                      distinct batches, flash = 2 x distinct batches, a
                      tuner attempt, median step and peak memory; two
                      profiled steps after phase 7.  ``train_hybrid_pins``:
                      reduced zamba2 at 4 and 5 layers, card against CPU as
                      ``train_pins``.
6e. ``train_families`` (runs last, after phase 7 and the profiled 6b / 6c
                      steps, with their trainers freed) the MoE, VLM,
                      audio and xLSTM families trained at full width by
                      ``Trainer(device=None)``, random bf16 weights, one
                      model at a time, each freed before the next:
                      ``train_olmoe`` (depth 4 of 16, 1.89 G parameters)
                      and ``train_deepseek_moe`` (depth 3: the dense layer
                      0 and two MoE layers, 1.68 G), seq 512, global batch
                      8, 4 workers from B 2, worker 3 slowed 8x, the
                      simulate tuner, 24 steps; ``train_internvl2`` (depth
                      1 of 80, 2.97 G: it must start with under 1 GB on
                      the card) 256 patch slots + 256 tokens, global batch
                      2, 2 workers at B 1, 10 steps; ``train_whisper``
                      (24 + 24 layers) 1,500 frames and 187 decoder tokens
                      with ``train_olmoe``'s traffic; ``train_xlstm`` (24
                      blocks) seq 512, global batch 8, 4 workers from B 2,
                      12 steps, no hand kernel.  Each prints its memory
                      reckoning (14 B a parameter, 4 B a distinct batch's
                      gradient tree, 4 B their aggregate) and fails with
                      under 5 GB of the card spare; at step 0 every leaf's
                      gradient is finite and the family's own leaves
                      (router and experts, projector, cross attention and
                      the encoder's, sLSTM ``r``) nonzero; MoE: two
                      backward passes from one state bit-equal, the
                      assignments dropped past capacity printed;
                      ``FlashAttentionFn`` at the path's shapes (the
                      layers at d 128; whisper's non-causal 1,500 x 1,500
                      encoder and 187 x 1,500 cross attention at d 64)
                      against autograd through the plain version; then the
                      run: the loss falls, flash launches = attention
                      layers (4, 3, 1, 72, 0) x distinct batches, tuner
                      attempts, median step wall, peak memory beside the
                      reckoning, two profiled steps.  Then
                      ``train_family_pins_<family>``: the reduced model,
                      card against CPU as ``train_pins``, beside the CPU's
                      own bf16-against-float32 step-0 loss gap.
7. ``kernels``        each kernel against its plain PyTorch version on the
                      card, at the shapes phases 2, 4, 5 and 6 gave it,
                      with its time, the plain version's, a library call's
                      where one exists (``torch.kthvalue``,
                      ``torch.matmul``, ``scaled_dot_product_attention``),
                      and its bound.  The attention kernels are held to
                      their plain versions at 5e-5 in float32; in bfloat16
                      ``flash_attention`` at 5e-2 and ``decode_attention``
                      at a tenth of its plain output's RMS (its outputs,
                      averages over about 1,000 keys, are of order 0.05),
                      at head dims 64 and 112 and at 128 (qwen2.5-14b's and
                      granite-34b's prefill and cache; olmoe's MHA and
                      internvl2's 64 over 8; whisper's non-causal encoder,
                      its cross attention and its 1,500-frame cross
                      cache at d 64), with each one's
                      achieved rate (flash TFLOP/s, decode GB/s) and
                      fraction of its bound.  ``ssd_scan`` also at
                      ``train_hybrid``'s shape, forward and forward +
                      backward through ``SsdScanFn`` (phase 6c's times);
                      ``FlashAttentionFn`` forward and forward + backward
                      at phase 6e's whisper encoder and cross attention
                      and internvl2 layer, beside SDPA's and the bounds.
                      ``ssd_scan`` is held
                      within 1e-4 (float32) and 5e-2 (bfloat16) times
                      1 + |plain| on mild-decay inputs, its final state
                      within 1e-4 in both, with its achieved TFLOP/s and
                      fraction of its bound.  ``coded_cells`` runs the
                      planner's cells (short rows), the fleet's cells and
                      duplicated 2 x 2,000 x 10,000 rows (radix select),
                      bit-equal to its plain version, with its events,
                      per-call and device times, the candidates each radix
                      pass left (the kernel's record, equal to the plain
                      version's), the device time of an empty kernel
                      launched as the short-row kernel is (the launch
                      floor), the host microseconds of each step of a call
                      beside costlier ways to take the same steps, and the
                      stack frames ptxas reports (none may use local
                      memory in a short-row kernel).  ``sojourn_cells``
                      runs plan_policies' one dispatch (every cell and
                      policy) and the widest cell's trigger and
                      trigger-free policies alone, and serving_fleet's
                      widest dispatch (5 cells x 2 policies, about 10,000
                      jobs, G=256), bit-equal to its plain
                      version on the first 2,000 jobs, beside its chain
                      bound (its longest program's dependent warp
                      reductions and shared-memory round trips, at
                      latencies the probe
                      ``src/repro_torch/csrc/probes/chain_latency.cu``
                      measures in phase 1).  ``combine`` gives its events time,
                      device time and per-call time beside matmul's, at
                      the planner's shape (strip kernel) and 1024 x 1024
                      x 2048 (tiled kernel).
8. ``dryrun``         the port's dry-run of the 40 (arch, shape) pairs on
                      the 16 x 16 mesh shape and the meta-device counts of
                      every train and prefill path above (each cell and
                      each count in a pool of spawned processes, one a
                      host core): each training path's memory
                      reckoning against its measured peak; each path's
                      model-FLOP share; its walked roofline
                      (``roofline.op_cost``: compute and memory terms, a
                      train step's backward passes with one AdamW update,
                      the whole-step share max(terms) / the measured median
                      wall, the five ops with the most walked bytes); the
                      hill-climb's terms (``roofline.hillclimb``: plain,
                      kernel-substituted, the bound that set it, and as
                      run) for its cells the dry-run wrote; zamba2's
                      prefill walk outside the matmul family and the hand
                      kernels (D1) and olmoe's dispatch backward (D2),
                      beside the profiled device time of their kernels.

Each path of phases 2-6, 2b, 4b-4e and 6a-6e runs with the launch counts and the sweeps'
stage seconds (``simulator.STAGE_SECONDS``) set to 0 just before it and
read just after; a kernel of the path that never launched fails the run.  One more
run of phases 2 and 3 under ``torch.profiler`` gives the card's busy time.
The last lines are the card (``nvidia-smi`` name and power limit), one
JSON object of kernels, and one JSON object ``{"ok": true, "device": ...}``.
Details go to ``chiprun_out/chip_smoke.json``.  The script exits non-zero,
printing no result, without a CUDA device or outside a checkout of the
repo.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16 dense, tensor cores
SOJOURN_PLAIN_JOBS = 2_000
# the probe of sojourn_cells' chain latencies (not a kernel of any path)
LATENCY_PROBE = os.path.join("src", "repro_torch", "csrc", "probes",
                             "chain_latency.cu")
PLANNER_KERNELS = ("sojourn_cells", "coded_cells", "combine")
# the fleet's coded sweep: plan_policies' N = 10,000 workers, mds tolerances
CODED_FLEET_N, CODED_FLEET_S = 10_000, (100, 1_000, 2_500)
CODED_FLEET_TRIALS = 2_000
# the plan_serving phase: benchmarks/bench_multitenant.py's swept engine as
# its planner sees it (16 groups, SExp(0.02, 2.0), utilization 0.95,
# job_load 0.96, batch 4, two tenant classes, 4,000 requests, seed 0), and
# the reference's decision there: repro.core.planner.SimulatedPlanner.plan
# (its numpy and pallas lanes agree), pinned on the CPU by
# tests/test_torch_serving_sweep.py::
# test_plan_serving_makes_the_bench_multitenant_decision
SERVING_DECISION = {"n_batches": 2, "policy": "none", "max_wait": math.inf,
                    "shed": ("cap", 48),
                    "class_report": (("premium", 0.0),
                                     ("standard", 0.3334582240539528))}
# one sojourn_cells launch a (max_wait, shed) combo: 3 max_waits x (none,
# expired), and under cap one a (max_wait, split): 3 x 5 splits
SERVING_LAUNCHES = 3 * 2 + 3 * 5
# the serving_fleet path: the same objective on 1,024 replicas,
# B in {16..256}, a 40,000-request Poisson trace
SERVING_FLEET_N, SERVING_FLEET_B = 1024, (16, 32, 64, 128, 256)
SERVING_FLEET_REQUESTS = 40_000
# phase 4c: benchmarks/bench_planner.py's skewed fleet (N 64, SExp(0.25,
# 1.0), rates [0.1] + linspace(0.7, 1.3, 63), 20,000 trials) and its
# 2,000-draw bootstrap pool; the reference's decisions there, pinned on the
# CPU by tests/test_torch_hetero_empirical.py::
# test_plan_heterogeneous_decisions_are_the_references and
# test_plan_empirical_decisions_are_the_references: B* under "mean", the
# shrink's B* and dropped workers, and (B*, policy kind, quantile) under the
# load-aware p99 portfolio; the empirical (B*, confidence, vote_share) by K
PLAN_N, PLAN_TRIALS = 64, 20_000
HETERO_DECISIONS = {"mean": 16, "shrink": (15, (0, 1, 2, 3)),
                    "p99": (32, "clone", 0.9)}
_ONE_B16 = ((1, 0.0), (2, 0.0), (4, 0.0), (8, 0.0), (16, 1.0), (32, 0.0),
            (64, 0.0))
EMPIRICAL_DECISIONS = {
    4: (16, 1.0, _ONE_B16), 16: (16, 1.0, _ONE_B16),
    64: (16, 0.96875, ((1, 0.0), (2, 0.0), (4, 0.0), (8, 0.0),
                       (16, 0.96875), (32, 0.03125), (64, 0.0)))}
# the load-aware plans also run on the CPU (the plain scan) for card ==
# CPU, at this many jobs: the plain scan takes ~150 s at 20,000
PLAN_CHECK_JOBS = 500
# the tuner_fleet path: 1,024 workers from B 256, slow workers (4x), a
# fault on worker 100 for steps 30-39, and from step 40 a lognormal pool;
# 60 steps (the fallback re-plans every step once its wall is in budget)
TUNER_FLEET_N, TUNER_FLEET_B0, TUNER_FLEET_STEPS = 1024, 256, 60
TUNER_FLEET_SLOW, TUNER_FLEET_DRIFT = tuple(range(8)), 40
# benchmarks/bench_serving_latency.py's online policy switch (N 16, 4,000
# trials): the reference's adopted (kind, quantile) in each regime, its
# moves (step, old B, new B) and final B, pinned on the CPU by
# tests/test_torch_chip_pins.py::test_tuner_switch_decision_is_the_references
SWITCH_DECISION = {"adopted": (("relaunch", 0.8), ("clone", 0.8)),
                   "moves": ((4, 4, 1), (44, 1, 16)), "final_b": 16}
# the serve phase: qwen2-0.5b at full width
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN = 8, 1024, 32, 2048
# card against CPU: full width, depth 2.  Either bf16 run rounds the
# logits (|logit| < 4) at eight bf16 ulps or less of that range
CHECK_LAYERS, CHECK_BATCH, CHECK_PROMPT, CHECK_STEPS = 2, 2, 256, 4
LOGIT_TOL = 0.125
# kernel against plain version, atol = rtol: tests/test_kernels.py's
# tolerances.  decode_attention's bf16 outputs average ~1,000 unit-variance
# rows (|out| ~ 0.05), where 5e-2 would be as large as the values: there
# every element must lie within a tenth of the plain output's RMS
ATT_TOL = {"float32": 5e-5, "bfloat16": 5e-2}
DECODE_BF16_RMS_FRAC = 0.1
# the train phase: qwen2-0.5b at full width and depth, the tuner on the
# simulate planner, one slow worker; TRAIN_STEPS steps, enough for the
# tuner's first re-plan attempts (its window fills after 8 steps of 8
# workers) and for the loss to fall (40 until the script neared its
# 1,200 s limit on a slow host)
TRAIN_CONFIG = dict(arch="qwen2-0.5b", reduced=False, seq_len=512,
                    global_batch=32, n_workers=8, n_batches=4,
                    slow_workers={3: 8.0}, tuner=True,
                    planner_mode="simulate")
TRAIN_STEPS = 30
# train_pins: reduced qwen2-0.5b, card against CPU through a whole-group
# fault (workers 1 and 5 from step 3) and a checkpoint restore.  The
# control plane must be equal exactly; the losses within this (the
# reference and the port agree within 2.5e-4 on the CPU over such runs,
# tests/test_torch_train_driver.py; the card's bf16 flash kernel rounds
# the attention weights per 64-key tile and cuBLAS sums in another order)
TRAIN_PIN_CONFIG = dict(arch="qwen2-0.5b", steps=10, seq_len=64,
                        global_batch=16, n_workers=8, n_batches=4, lr=1e-3,
                        checkpoint_every=2)
TRAIN_PIN_LOSS_TOL = 2e-2
# the serve_hybrid phase: zamba2-7b at full width and depth
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW, HYBRID_MAX_LEN = 8, 1024, 16, 2048
# card against CPU: full width, depth 7 (one segment of six Mamba-2 blocks
# and the shared block, then one trailing block), prompt 256 (two chunks)
HCHECK_LAYERS, HCHECK_PROMPT = 7, 256
# ssd_scan against its plain version: within tol * (1 + |plain|); the
# final state (float32 either way) at the float32 tolerance
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# the bf16 scan's tensor-core kernel, as the profiler names it
SSD_BF16_KERNEL = "ssd_mma_kernel"
# the backward kernels as the profiler names them: flash attention's
# launches (flash_bwd_dq_wgmma, flash_bwd_dkdv_wgmma and, where a group is
# split, flash_bwd_dkdv_sum) and the scan's three passes
# (ssd_bwd_carry_kernel, ssd_bwd_chunk_kernel, ssd_bwd_group_sum_kernel)
FLASH_BWD_KERNEL = "flash_bwd_"
SSD_BWD_KERNEL = "ssd_bwd_"
# a training path's profile: the forward and backward kernels' device time
TRAIN_SHARES = {"flash_attention": "flash_wgmma",
                "flash_attention_bwd": FLASH_BWD_KERNEL}
# phase 6c's float32 hold of SsdScanFn's gradients: (batch, positions)
SSD_F32_HOLD = (1, 200)
# phase 6a: the head-dim-128 dense configs at full width, random bf16
# weights, (arch, phase tag, layers on the card): qwen2.5-14b at full depth
# (48 layers, 29.5 GB); command-r-plus-104b at depth 8 of 64 (31.5 GB, 6.3
# GB of it the tied 256,000 x 12,288 embedding: the whole model is 208
# GB); granite-34b at depth 44 of 88 (34 GB: all 88 would be 67 GB)
DENSE_SERVE = (("qwen2.5-14b", "serve_qwen2_5_14b", 48),
               ("command-r-plus-104b", "serve_command_r_plus", 8),
               ("granite-34b", "serve_granite_34b", 44))
# card against CPU at full width and depth 2 (CHECK_LAYERS), on prompts
# of 32: the CPU's bf16 layers and unembedding (256,000 x 12,288 for
# command-r) then take seconds
DCHECK_PROMPT = 32
# phase 6d: the last four families at full width, random bf16 weights,
# (arch, phase tag, layers on the card or None for all): olmoe-1b-7b (16
# layers, 13.8 GB), deepseek-moe-16b (28, layer 0 dense, 32.8 GB),
# internvl2-76b at depth 16 of 80 (31.6 GB: 1.71 GB a layer and 4.2 GB of
# untied embeddings; all 80 would be 141 GB), xlstm-350m (24 blocks, 21
# mLSTM + 3 sLSTM); whisper-medium (24 + 24) is served by its own path
FAMILY_SERVE = (("olmoe-1b-7b", "serve_olmoe", None),
                ("deepseek-moe-16b", "serve_deepseek_moe", None),
                ("internvl2-76b", "serve_internvl2", 16),
                ("xlstm-350m", "serve_xlstm", None))
# card against CPU at full width and small depth, on these prompts: MoE
# at depth 2 (deepseek's dense layer 0 and one MoE layer) on prompts of 32
# (64 tokens, top-8 or top-6 of 64 experts at capacity factor 1.25: some
# experts overflow), internvl2 at depth 2 behind its 256 patch slots,
# xLSTM at depth 8 (one segment ending in its sLSTM) on prompts of 128, in
# float32 (xlstm_check says why)
FCHECK_LAYERS = {"serve_olmoe": 2, "serve_deepseek_moe": 2,
                 "serve_internvl2": 2, "serve_xlstm": 8}
FCHECK_PROMPT = {"serve_olmoe": 32, "serve_deepseek_moe": 32,
                 "serve_internvl2": 32, "serve_xlstm": 128}
# MoE card against CPU: the card routes to the CPU's experts call by call;
# a token whose own top-k set on the card differs (a routing flip) must be
# a near-tie, the CPU's k-th and (k+1)-th gate probabilities closer than
# this (1/64 is the mean gate probability over olmoe's 64 experts)
MOE_FLIP_MARGIN = 1e-2
# whisper: the stubbed frontend's 30 s window (1,500 frames of 128); the
# cross cache shares max_len with the self cache; decoding starts from
# whisper's start-of-transcript token; the check runs 128 frames
WHISPER_FRAMES, WHISPER_MAX_LEN, WHISPER_START = 1500, 1536, 50258
WCHECK_FRAMES = 128
# phase 6c: zamba2-7b trained at full width (d 3584, 112 SSM heads of 64,
# state 64, 32 attention heads of 112) and depth 13: two segments of six
# Mamba-2 blocks, each followed by the shared block, then one trailing
# block.  4 workers from B 2, global batch 6: B can reach 1 or 2 only,
# which keeps the step's memory (parameters, AdamW state, a float32
# gradient tree a distinct batch and their aggregation) well inside the
# card beside the qwen2-0.5b trainer that phase 6b keeps for its profile
HTRAIN_LAYERS = 13
HTRAIN_CONFIG = dict(arch="zamba2-7b", reduced=False, seq_len=512,
                     global_batch=6, n_workers=4, n_batches=2,
                     slow_workers={3: 8.0}, tuner=True,
                     planner_mode="simulate", lr=1e-3, warmup=5)
# 24 steps: the tuner's window (64 observations) fills after 16 steps of 4
# workers, so it makes its first re-plan attempt there
HTRAIN_STEPS = 24
# train_hybrid_pins: reduced zamba2 (4 layers) and a 5-layer variant with a
# trailing block, card against CPU through train_pins' fault and restore
HTRAIN_PIN_LAYERS = (4, 5)
# phase 6e: training of the MoE, VLM, audio and xLSTM families at full
# width, random bf16 weights, through Trainer(device=None), one model at a
# time, each freed before the next: (arch, phase tag, depth on the card or
# None for all, trainer config, steps).  Depth is cut where the parameters,
# the float32 AdamW state (14 bytes a parameter with the bf16 weights), a
# float32 gradient tree a distinct batch and their aggregate (4 bytes a
# parameter each) would not fit: olmoe 4 of 16 layers (1.89 G parameters),
# deepseek-moe 3 of 28 (the dense layer 0 and two MoE layers, 1.68 G),
# internvl2 1 of 80 (its two 128,256 x 8,192 embeddings alone hold 2.1 G;
# 2.97 G in all, 65 GB at one distinct batch).  The MoE and whisper paths
# keep HTRAIN_CONFIG's traffic (4 workers from B 2, worker 3 slowed 8x,
# the simulate tuner, whose window fills at step 16); whisper takes the 30
# s window of 1,500 frames and 187 decoder tokens; internvl2 256 patch
# slots and 256 text tokens, 2 workers at B 1, the tuner off; xlstm 6
# steps of about 8 s each (its sLSTM steps are host-paced).  Each
# path's learning rate is one at which its loss falls within its steps
# (whisper's token embeddings, of scale 0.02, sit under sinusoids of scale
# 1, so its loss moves slowly)
FTRAIN_TRAFFIC = dict(reduced=False, seq_len=512, global_batch=8,
                      n_workers=4, n_batches=2, slow_workers={3: 8.0},
                      tuner=True, planner_mode="simulate", lr=1e-3, warmup=5)
FAMILY_TRAIN = (
    ("olmoe-1b-7b", "train_olmoe", 4, FTRAIN_TRAFFIC, 24),
    ("deepseek-moe-16b", "train_deepseek_moe", 3, FTRAIN_TRAFFIC, 24),
    ("internvl2-76b", "train_internvl2", 1,
     dict(reduced=False, seq_len=512, global_batch=2, n_workers=2,
          n_batches=1, lr=3e-4, warmup=2), 10),
    ("whisper-medium", "train_whisper", None,
     dict(FTRAIN_TRAFFIC, seq_len=WHISPER_FRAMES, lr=1e-4), 24),
    ("xlstm-350m", "train_xlstm", None,
     dict(reduced=False, seq_len=512, global_batch=8, n_workers=4,
          n_batches=2, lr=1e-3, warmup=5), 6),
)
# internvl2 trains only with nothing of the earlier phases on the card
FTRAIN_START_LIMIT_GB = 1.0
# the step's reckoned memory must leave this much of the card spare, or
# the path's global batch is to be lowered (never its width)
FTRAIN_SPARE_GB = 5.0
# phase 4d: the serving engine.  engine_multitenant serves
# benchmarks/bench_multitenant.py's two deployments (16 groups, 4,000
# requests); engine_fleet the swept one on 1,024 groups (40,000 requests);
# engine_model the tuner-on engine with real prefill and decode (2,000
# requests), then its hybrid variant with the tuner off (256 requests)
ENGINE_REQUESTS = {"multitenant": 4_000, "fleet": 40_000, "model": 2_000,
                   "hybrid": 256}
ENGINE_FLEET_N = 1024
# the reference's run_load results there (engine_summary), pinned on the
# CPU on the reference's pallas lane by tests/test_torch_chip_pins.py::
# test_engine_multitenant_numbers_are_the_references,
# test_engine_fleet_numbers_are_the_references and
# test_engine_model_decision_is_the_references
ENGINE_MULTITENANT = {
    "fifo": {"final_B": 4, "max_wait": 0.5, "shed": "none", "policy": "none",
             "n_dropped": 0, "p99_sojourn": 2.1728785469115803,
             "classes": {
                 "premium": (971, 0, 0.7837281153450052, 1.3732898635598518,
                             2.185688634318429),
                 "standard": (3029, 0, 0.0, 1.3502471428310616,
                              2.1686648119370995)}},
    "swept": {"final_B": 2, "max_wait": math.inf, "shed": "cap",
              "policy": "none", "n_dropped": 607,
              "p99_sojourn": 1.1709038943726178,
              "classes": {
                  "premium": (971, 0, 0.0, 0.1821336183907882,
                              0.40423098197575863),
                  "standard": (2422, 607, 0.20039617035325188,
                               0.660503373499655, 1.1940035460334617)}}}
ENGINE_FLEET = {
    "fifo": {"final_B": 4, "max_wait": 0.5, "shed": "none", "policy": "none",
             "n_dropped": 0, "p99_sojourn": 47.06125397482628,
             "classes": {
                 "premium": (9850, 0, 0.9843654822335025, 23.703189052585653,
                             47.03173592663555),
                 "standard": (30150, 0, 0.9364510779436153, 23.7775919308912,
                              47.07750759734238)}},
    "swept": {"final_B": 64, "max_wait": 0.2, "shed": "cap", "policy": "none",
              "n_dropped": 12952, "p99_sojourn": 0.2153164663090504,
              "classes": {
                  "premium": (9850, 0, 0.0, 0.09832297135023539,
                              0.21077666090547134),
                  "standard": (17198, 12952, 0.42958540630182424,
                               0.10864217338827749, 0.21600152657788435)}}}
ENGINE_MODEL = {"moves": ((64, 16, 2), (320, 2, 4)), "final_B": 4,
                "policy": ("clone", 0.9), "p99_sojourn": 2.765449880444606}
# phase 4e: fault_fleet, the control plane's fleet-scale fault path: 1,024
# workers from B 256, SExp(0.05, 2.0), 32 of them at rate 0.25 (the rest
# 1.0), chosen by default_rng(0).choice(1024, 32, replace=False)
# (fault_fleet_rates); workers 0, 256, 512 and 768, one whole replica group,
# marked dead.  The reference's decisions there (repro.distributed, its
# default planners), each assignment's worker->batch map as
# assignment_hash: decide() (kind, lost batches, survivors) and
# plan_recovery(metric="p99") (survivors, B, map, predicted p99), pinned on
# the CPU by tests/test_torch_chip_pins.py::
# test_fault_fleet_recovery_is_the_references (slow: about 110 s on the
# reference's lane); RescaleExecutor.shrink(32, metric="mean") from the
# healthy fleet (workers, B, map, dropped ids), pinned by
# test_fault_fleet_shrink_is_the_references
FAULT_FLEET_N, FAULT_FLEET_B0, FAULT_FLEET_SLOW = 1024, 256, 32
FAULT_FLEET_DEAD = (0, 256, 512, 768)
FAULT_FLEET = {
    "decide": ("replan", (0,), 1020),
    "recovery": (1020, 102, "7a8c1eae32244868", 5.272800188400028),
    "shrink": (992, 124, "a292b2ea18983e06",
               (2, 16, 34, 40, 75, 175, 179, 268, 280, 306, 400, 506, 508,
                549, 564, 566, 610, 633, 637, 651, 680, 735, 745, 780, 814,
                827, 844, 866, 872, 916, 946, 977))}
# the recovery's coverage samples on the card, held bit-equal to the host
# walk (simulate_coverage_reference) at the chosen B on this many trials
FAULT_FLEET_CHECK_TRIALS = 2_000
# phase 2b, plan_wide: a fleet wider than the staged sojourn_cells kernel
# holds: N 16,384 workers, SExp(0.05, 2.0), B in {2,048 .. 16,384} (r = 8,
# 4, 2, 1), phase 2's four policies, p99 at utilization 0.7, 4,000 trials,
# seed 0.  The reference's decision and points there (plan_summary of
# repro.core.planner.SimulatedPlanner's plan on its pallas lane), pinned on
# the CPU by tests/test_torch_chip_pins.py::
# test_wide_fleet_decision_is_the_references
WIDE_FLEET_N, WIDE_FLEET_B = 16_384, (2_048, 4_096, 8_192, 16_384)
WIDE_FLEET_TRIALS = 4_000
WIDE_FLEET = {
    "n_batches": 2048, "policy": ("clone", 0.85, 1.0),
    "points": (
        (2048, 8, 0.1117496303603467, 0.003236382678895726,
         0.2909033820033073, 0.3702632533609841),
        (4096, 4, 0.16858859105760024, 0.010721338605621232,
         0.4729626163840289, 0.5916383626461006),
        (8192, 2, 0.276864408608526, 0.03994838953585716,
         0.879720829129219, 1.2733843674659726),
        (16384, 1, 0.5175963086934967, 0.1673918386389002,
         1.7116460025310507, 2.4445390894412937))}
# plan_wide's kernel checks: row widths on both sides of the staged limit
# (11,520 sets on the H100) and the mixed-n_groups launch, bit-equal to the
# plain version on their first jobs
WIDE_CHECK_GROUPS = (11_520, 11_521, 16_384, 65_536)
WIDE_MIXED_GROUPS = (0, 1, 11_520, 11_521, 16_384)
WIDE_CHECK_JOBS = 1_000
# and the unstaged kernel forced onto more jobs than sets, two and three
# groups of nodes, held bit-equal to the staged one
WIDE_REVISIT_GROUPS, WIDE_REVISIT_JOBS = (5_000, 10_000), 12_000
# ptxas's registers and static shared bytes of the staged instantiations,
# which the unstaged kernel's redesign leaves as they were (PR 28's build)
STAGED_PTXAS = {"sojourn_cells_kernel<1>": (71, 128),
                "sojourn_cells_kernel<3>": (92, 128)}
# phase 6b's check of AdamW's float32 square root on the card, on this
# many values
SQRT_CHECK_N = 1 << 26


def sqrt_mismatches(torch, dev, n: int = SQRT_CHECK_N) -> int:
    """How many of ``n`` float32 values (|N(0, 1)| scaled by 10^U(-40, 30),
    zeros and subnormals among them) AdamW's ``sqrt_`` on the card takes
    to another float32 than the float64 root rounded back, the CPU's
    route, which is correctly rounded: 0 lets the card keep CUDA's
    ``sqrtf``."""
    from repro_torch.optim import adamw

    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(n, generator=g, device=dev).abs()
         * torch.pow(10.0, torch.empty(n, device=dev).uniform_(
             -40.0, 30.0, generator=g))).float()
    x[:4] = torch.tensor([0.0, 1e-45, 1e-40, 3.4e38], device=dev)
    want = torch.sqrt(x.double()).float()
    return int((adamw.sqrt_(x.clone()) != want).sum().item())


def soj_ptxas_figures(log: str | None = None) -> dict:
    """{sojourn_cells kernel: (registers, static shared bytes)} from the
    ``-Xptxas -v`` log the build keeps beside the library (or ``log``)."""
    if log is None:
        from repro_torch.kernels import _build

        log = _build._lib_path("sojourn_cells").with_suffix(
            ".log").read_text()
    figures, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m[1]
            continue
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            s = re.search(r"sojourn_cells_kernel(_wide)?ILi(\d+)E", name)
            key = (f"sojourn_cells_kernel{s[1] or ''}<{s[2]}>" if s else
                   "sojourn_cells_kernel_wide"
                   if "sojourn_cells_kernel_wide" in name else name)
            figures[key] = (int(m[1]), int(m[2]))
            name = None
    return figures


def plan_summary(plan) -> dict:
    """A plan's decision and spectrum, as ``WIDE_FLEET`` pins them (the
    reference's and the port's plans name these fields alike)."""
    pol = plan.policy
    return {"n_batches": plan.n_batches,
            "policy": (pol.kind, pol.quantile, pol.hedge_fraction),
            "points": tuple((p.n_batches, p.replication, p.mean, p.var, p.p99,
                             p.p999) for p in plan.spectrum.points)}


def fault_fleet_rates(np):
    """phase 4e's fault_fleet rates: FAULT_FLEET_SLOW workers at 0.25."""
    rates = np.ones(FAULT_FLEET_N)
    rates[np.random.default_rng(0).choice(
        FAULT_FLEET_N, FAULT_FLEET_SLOW, replace=False)] = 0.25
    return rates


def assignment_hash(worker_batch) -> str:
    """16 hex digits of the SHA-256 of a worker->batch map as int64."""
    import hashlib

    import numpy as np

    return hashlib.sha256(
        np.asarray(worker_batch, dtype=np.int64).tobytes()).hexdigest()[:16]


def engine_kwargs(core, path: str, n_groups: int = 16) -> dict:
    """``ServeEngineConfig`` keywords of phase 4d's paths, built from
    ``core``'s ``SloClass``, ``ShedPolicy`` and ``PolicyCandidate`` (the
    port's on the card, the reference's where the pins are computed).

    ``fifo`` and ``swept`` are ``benchmarks/bench_multitenant.py``'s
    ``_engine(n_groups, swept=...)``; ``model`` the tuner-on engine (B 16
    of 16 groups, the p99 portfolio {none, clone 0.9, relaunch 0.9,
    hedged 0.1}, utilization 0.7); ``hybrid`` the same with
    ``arch="zamba2-7b"`` and the tuner off."""
    if path in ("fifo", "swept"):
        kw = dict(
            n_server_groups=n_groups, n_batches=4, delta=0.02, mu=2.0,
            batch_size=4, utilization=0.95, arrival_kind="multitenant",
            slo_classes=(
                core.SloClass("premium", share=0.25, weight=4.0,
                              deadline=0.8, miss_target=0.05),
                core.SloClass("standard", share=0.75, weight=1.0,
                              deadline=3.0, miss_target=0.5)),
            execute_model=False, straggler_policy="none", seed=0,
            max_wait=0.5)
        if path == "fifo":
            return dict(kw, queue_discipline="fifo")
        return dict(
            kw, queue_discipline="wfq",
            max_wait_candidates=(0.2, 0.5, math.inf),
            shed_candidates=(core.ShedPolicy("cap", cap=48),
                             core.ShedPolicy("expired")),
            policy_candidates=(core.PolicyCandidate(),
                               core.PolicyCandidate("hedged",
                                                    hedge_fraction=1.0)),
            plan_initial=True, planner_mode="simulate")
    kw = dict(
        arch="qwen2-0.5b", n_server_groups=16, n_batches=16, batch_size=4,
        prompt_len=16, gen_tokens=8, max_len=64, delta=0.02, mu=2.0,
        utilization=0.7, tuner=True, planner_mode="simulate", metric="p99",
        policy_candidates=(
            core.PolicyCandidate(), core.PolicyCandidate("clone", quantile=0.9),
            core.PolicyCandidate("relaunch", quantile=0.9),
            core.PolicyCandidate("hedged", hedge_fraction=0.1)),
        execute_model=True, seed=0)
    if path == "hybrid":
        return dict(kw, arch="zamba2-7b", tuner=False)
    return kw


def engine_summary(out: dict) -> dict:
    """The decision and numbers of one ``run_load`` result that phase 4d
    holds to the reference's: final B, max_wait, shed, policy, drops, p99
    sojourn and, per tenant class, (served, dropped, miss rate, mean and
    p99 sojourn).  The class means are ``math.fsum`` over the served
    requests' sojourns, correctly rounded: numpy's pairwise sum behind
    ``run_load``'s means can differ in the last bit from one host CPU to
    another."""
    sojourns: dict = {}
    for s in out["stats"]:
        if not s.dropped:
            sojourns.setdefault(s.slo, []).append(s.latency)
    return {
        "final_B": out["final_B"], "max_wait": out["max_wait"],
        "shed": out["shed"], "policy": out["policy"],
        "n_dropped": out["n_dropped"], "p99_sojourn": out["p99_sojourn"],
        "classes": {k: (v["served"], v["dropped"], v["miss_rate"],
                        math.fsum(sojourns[k]) / v["served"],
                        v["p99_sojourn"])
                    for k, v in (out["class_stats"] or {}).items()}}


def routed_to_cpu(orig_route):
    """A stand-in for ``repro_torch.models.moe.route`` for checking the card
    against the CPU where each MoE call on the CPU comes before the card's
    call of the same layer and step: a card call is routed to the experts
    the CPU chose in its matching call, weighted by the card's own gate
    probabilities, since a bf16 near-tie that the two roundings order
    differently (a routing flip) would send the two models apart by
    design.  Returns (route, state): ``state["pending"]`` holds the CPU
    calls not yet matched, ``state["flips"]`` the CPU's margin between its
    k-th and (k+1)-th gate probability at each token whose own top-k set
    on the card differs, ``state["sets"]`` the (token, layer) sets
    compared."""
    state = {"pending": [], "flips": [], "sets": 0}

    def route(moe, router, xt):
        probs, gate_w, gate_e = orig_route(moe, router, xt)
        if xt.device.type == "cpu":
            top = probs.topk(moe.top_k + 1, dim=-1).values
            state["pending"].append((gate_e, top[:, -2] - top[:, -1]))
            return probs, gate_w, gate_e
        cpu_e, margin = state["pending"].pop(0)
        state["sets"] += cpu_e.shape[0]
        flip = (gate_e.sort(-1).values.cpu()
                != cpu_e.sort(-1).values).any(-1)
        state["flips"].extend(margin[flip].tolist())
        forced = cpu_e.to(xt.device)
        w = probs.gather(-1, forced)
        return probs, w / w.sum(-1, keepdim=True).clamp_min(1e-9), forced

    return route, state


def replan_log(eng) -> list:
    """Wrap ``eng.tuner.maybe_replan`` (the port's or the reference's) to
    record each attempt as it was made: (step, wall seconds, the tuner's
    ``last_plan``, the ``RescalePlan`` or None)."""
    tuner, log = eng.tuner, []
    orig = tuner.maybe_replan

    def wrapped():
        before = tuner._last_attempt
        rp = orig()
        if tuner._last_attempt != before:
            log.append((tuner._last_attempt, tuner.last_replan_seconds,
                        tuner.last_plan, rp))
        return rp
    tuner.maybe_replan = wrapped
    return log


def attempt_summary(attempt) -> tuple:
    """One ``replan_log`` entry as (step, wall seconds, B, (policy kind,
    quantile) or None, the move (step, old B, new B) or None)."""
    step, seconds, plan, rp = attempt
    pol = plan.policy
    return (step, seconds, plan.n_batches,
            None if pol is None else (pol.kind, pol.quantile),
            None if rp is None else (rp.step, rp.old_batches,
                                     rp.new_batches))


def model_decision(out: dict, eng, log: list) -> dict:
    """engine_model's decision: the tuner's moves, the final B, the
    adopted policy and the p99 sojourn."""
    pol = eng.policy
    return {"moves": tuple((rp.step, rp.old_batches, rp.new_batches)
                           for *_, rp in log if rp is not None),
            "final_B": out["final_B"],
            "policy": None if pol is None else (pol.kind, pol.quantile),
            "p99_sojourn": out["p99_sojourn"]}


def _fail(msg: str, code: int) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


_T0 = time.perf_counter()
PHASE_STARTS: dict = {}  # phase -> seconds since the script started


def _phase(name: str) -> None:
    """The phase's banner, with the seconds since the script started and
    the card's allocated memory once CUDA is up (what earlier phases
    still hold)."""
    held = ""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        held = (f" (allocated on the card: "
                f"{torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    PHASE_STARTS[name] = time.perf_counter() - _T0
    print(f"\n=== {name} === (at {PHASE_STARTS[name]:.1f} s)"
          f"{held}", flush=True)


def main() -> int:
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        _fail("src/repro_torch not found next to this script: run it from "
              "a checkout of the repository", 2)
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device is visible (torch.cuda.is_available() is "
              "False); the port's smoke run needs one GPU", 1)
    sys.path.insert(0, src)
    import numpy as np

    from repro_torch.core.coding import CodingCandidate
    from repro_torch.core.order_stats import Empirical, ShiftedExponential
    from repro_torch.core.planner import ClusterSpec, Objective, SimulatedPlanner
    from repro_torch.core.policies import PolicyCandidate, ShedPolicy, SloClass
    from repro_torch.core import simulator as SIM
    from repro_torch.core.simulator import sweep_coded, sweep_sojourn_policies
    from repro_torch.kernels import _build
    from repro_torch.kernels.coded import kernel as CK
    from repro_torch.kernels.coded import ops as coded_ops
    from repro_torch.kernels.sojourn_sweep import kernel as SK
    from repro_torch.kernels.sojourn_sweep import ops as SOPS
    from repro_torch.kernels.ssm_scan import ops as SSD
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import ssm as SSM_MODEL
    from repro_torch.models import transformer as ATTN_MODEL

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report: dict = {"phases": {}, "profiler_fallbacks": []}
    path_counts: dict = {}  # path -> {kernel: launches in that path's run}

    def timed_stages(fn):
        """(result, wall s, stage s) of one call, counts and stages at 0."""
        _build.reset_launch_counts()
        SIM.reset_stage_seconds()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages = dict(SIM.STAGE_SECONDS)
        stages["rest"] = wall - sum(stages.values())
        return res, wall, stages

    def run_path(name: str, fn):
        """Drive one path of the main path; return (result, counts, wall,
        stage seconds)."""
        res, wall, stages = timed_stages(fn)
        counts = _build.launch_counts()
        path_counts[name] = counts
        print(f"[{name}] wall {wall:.3f} s, launches {counts}", flush=True)
        print(f"[{name}] stages (host s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
        return res, counts, wall, stages

    def capture(module, attr, sink):
        orig = getattr(module, attr)

        def wrapped(*args, **kw):
            out = orig(*args, **kw)
            sink.append((args, kw))
            return out

        setattr(module, attr, wrapped)
        return orig

    def att_err(kernel, out, ref, dtype_name):
        """(max |kernel - plain|, RMS of plain, whether every element is
        within the kernel's and dtype's tolerance)."""
        ref = ref.float()
        diff = (out.float() - ref).abs()
        rms = ref.square().mean().sqrt()
        if kernel == "decode_attention" and dtype_name == "bfloat16":
            limit = DECODE_BF16_RMS_FRAC * rms
        else:
            limit = ATT_TOL[dtype_name] * (1.0 + ref.abs())
        return diff.max().item(), rms.item(), bool((diff <= limit).all())

    def ssd_err(y_k, st_k, y_p, st_p, dtype_name):
        """(max |y - plain|, max |state - plain|, whether y lies within
        SSD_TOL[dtype] * (1 + |plain|), the state within the float32
        tolerance, and y is finite)."""
        ref = y_p.float()
        diff = (y_k.float() - ref).abs()
        sdiff = (st_k - st_p).abs()
        ok = (bool((diff <= SSD_TOL[dtype_name] * (1.0 + ref.abs())).all())
              and bool((sdiff <= SSD_TOL["float32"]
                        * (1.0 + st_p.abs())).all())
              and bool(torch.isfinite(y_k).all()))
        return diff.max().item(), sdiff.max().item(), ok

    def warm_up(fn, seconds: float = 0.05) -> None:
        """Call ``fn`` until ``seconds`` of synchronised wall time have
        passed (at least twice), so the card leaves its idle clocks."""
        t0, n = time.perf_counter(), 0
        while n < 2 or time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
            n += 1

    def cuda_ms(fn, reps: int) -> float:
        """CUDA events around ``reps`` back-to-back calls, per call: the
        stream's time, the host's gaps between launches included."""
        warm_up(fn)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def call_ms(fn, reps: int) -> float:
        """Median over ``reps`` calls of CUDA events recorded just before
        and just after each call: the device time of one call's launches,
        without the host's gaps between calls."""
        warm_up(fn)
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in pairs:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    def nbytes(*tensors) -> int:
        seen, total = set(), 0
        for t in tensors:
            if t.data_ptr() in seen:
                continue
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
        return total

    def bf16_bound(flops, nbytes_):
        """(ms, "operations" or "bytes"): the least time of a bf16 call,
        operations at 989 TFLOP/s or bytes at 3.35 TB/s."""
        by = ("operations" if flops / BF16_FLOP_PER_S
              > nbytes_ / HBM_BYTES_PER_S else "bytes")
        return max(flops / BF16_FLOP_PER_S,
                   nbytes_ / HBM_BYTES_PER_S) * 1e3, by

    def kernel_rates(flops, nbytes_, bound_ms, dev_ms):
        """Achieved TFLOP/s and GB/s at the device time, and the fraction
        of the bound that time reaches."""
        return {"tflops": flops / dev_ms / 1e9, "gbps": nbytes_ / dev_ms / 1e6,
                "bound_fraction": bound_ms / dev_ms}

    last_profile: list = []  # (start us, seconds, name) of the last one

    def device_busy(fn, reps: int = 1):
        """(wall s, busy s, device events, device s by event name, events
        by name) of ``reps`` back-to-back calls under torch.profiler; each
        device event's start, duration and name go to ``last_profile``.

        Busy is the union of the intervals of the device's own events
        (kernels and copies), so nothing is counted twice; None when the
        profiler recorded no device event."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        spans = sorted((e.time_range.start, e.time_range.end) for e in events)
        last_profile[:] = sorted(
            (e.time_range.start, (e.time_range.end - e.time_range.start) / 1e6,
             e.name) for e in events)
        by_name: dict = {}
        count: dict = {}
        for e in events:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + (e.time_range.end - e.time_range.start) / 1e6)
            count[e.name] = count.get(e.name, 0) + 1
        busy_us, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy_us += cur_e - cur_s
        busy = busy_us / 1e6 if spans else None
        return wall, busy, len(spans), by_name, count

    def busy_window(fn):
        """``device_busy(fn)``, its window run again while it recorded no
        device event (the profiler drops whole windows at random in a
        process that has run many profiler sessions), 3 windows in all."""
        for i in range(3):
            out = device_busy(fn)
            if out[2]:
                return out
            report["profiler_empty_windows"] = (
                report.get("profiler_empty_windows", 0) + 1)
            print(f"    (profiler: window {i + 1} of 3 recorded no device "
                  "event)")
        return out

    def device_ms(fn, reps: int) -> float:
        """Device time of one call after a warm-up: over ``reps`` calls
        under the profiler, the mean duration of each kernel name, summed
        over the names (each wrapper and library call here launches each
        of its kernels once a call).  The profiler can miss the first
        launches of a window, so a sum over the window divided by ``reps``
        would undercount; the events it recorded are printed.  The
        profiler also drops whole windows at random in a process that has
        run many profiler sessions, so an empty window is tried again, up
        to 5 in all; if every one is empty, the time is the
        median CUDA event pair around one call (``call_ms``: the device
        time of one call's launches), kept in the report's
        ``profiler_fallbacks``, and the line printed says so."""
        warm_up(fn)
        for _ in range(5):
            _, _, n_events, by_name, count = device_busy(fn, reps)
            print(f"    (profiler: {n_events} device events recorded for "
                  f"{reps} calls: {sorted(count.values())})")
            if by_name:
                return sum(by_name[k] / count[k] for k in by_name) * 1e3
        ms = call_ms(fn, max(reps, 20))
        report["profiler_fallbacks"].append({"reps": reps, "call_ms": ms})
        print(f"    (profiler: 5 windows of {reps} calls recorded no "
              f"device event; device time from CUDA event pairs around one "
              f"call: {ms:.5f} ms)")
        return ms

    def print_busy(name, wall, busy, n_events, by_name, count, top=6,
                   shares=None):
        """Print and return the profile's busy time, idle share and its
        heaviest kernel names; ``shares`` maps a label to a kernel-name
        substring whose device seconds and share are reported too."""
        idle = None if busy is None else 1.0 - busy / wall
        print(f"[{name}] under torch.profiler: wall {wall:.3f} s, device "
              f"busy {busy} s over {n_events} device events, idle share "
              f"{idle}")
        heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        total = sum(by_name.values()) or 1.0
        for kname, secs in heavy:
            print(f"    {secs:.6f} s ({secs / total:.1%} of device time, "
                  f"{count[kname]} events) {kname[:100]}")
        share = {}
        for label, sub in (shares or {}).items():
            names = [k for k in by_name if sub in k]
            secs = sum(by_name[k] for k in names)
            share[label] = {"device_s": secs, "share": secs / total,
                            "events": sum(count[k] for k in names)}
            print(f"    {label} ({sub}): {secs:.6f} s, {secs / total:.2%} of "
                  f"device time, {share[label]['events']} events")
        return {"profiled_wall_s": wall, "device_busy_s": busy,
                "device_events": n_events, "idle_share": idle,
                "device_s_by_name": dict(heavy),
                "events_by_name": {k: count[k] for k, _ in heavy},
                "shares": share}

    # -- 1. build ---------------------------------------------------------
    _phase("build")
    card = _card_line()
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe_lib = _build.BUILD_DIR / "libchain_latency.so"
    probe = subprocess.Popen(  # beside the kernels' own nvcc processes
        [_build._nvcc(), *_build.ARCH_FLAGS, *_build.BASE_FLAGS, "-o",
         str(probe_lib), os.path.join(ROOT, LATENCY_PROBE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    secs = _build.build_all(verbose=True)
    probe_log, _ = probe.communicate(timeout=300)
    if probe.returncode != 0:
        raise RuntimeError(f"latency probe build failed:\n{probe_log}")
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.2f} s wall, per kernel {secs}")
    # SM cycles a step of a walk's two dependent chains: a warp reduction,
    # and lane 0's store to shared memory then the warp's 16-byte loads
    lib = ctypes.CDLL(str(probe_lib))
    lib.chain_latency_probe.argtypes = [ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_double)]
    per_step = (ctypes.c_double * 2)()
    if lib.chain_latency_probe(4096, per_step) != 0:
        raise RuntimeError("latency probe failed")
    chain_cycles = {"redux": per_step[0], "sts_syncwarp_lds128": per_step[1]}
    print(f"[build] chain latency probe ({LATENCY_PROBE}), SM cycles a "
          f"step: {chain_cycles}")
    print(f"[build] card: {card}")
    print(f"[build] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    report["card"] = card
    report["phases"]["build"] = {"seconds": build_s, "per_kernel": secs,
                                 "chain_cycles": chain_cycles}

    # -- 2. plan_policies -------------------------------------------------
    _phase("plan_policies")
    policies = (PolicyCandidate("none"),
                PolicyCandidate("clone", quantile=0.85),
                PolicyCandidate("relaunch", quantile=0.9),
                PolicyCandidate("hedged", hedge_fraction=0.3))
    heavy = ShiftedExponential(0.05, 2.0)
    spec = ClusterSpec(n_workers=10_000, dist=heavy,
                       feasible_b=(50, 100, 200, 500, 1000, 2000))
    objective = Objective(metric="p99", utilization=0.7, policies=policies)

    def fleet_plan():
        return SimulatedPlanner(n_trials=20_000, seed=0, device="cuda").plan(
            spec, objective)

    soj_calls: list = []
    orig = capture(SK, "sojourn_cells", soj_calls)
    try:
        plan, counts, wall, stages = run_path("plan_policies", fleet_plan)
    finally:
        SK.sojourn_cells = orig
    if counts["sojourn_cells"] != 1:
        raise AssertionError(f"plan_policies launched sojourn_cells "
                             f"{counts['sojourn_cells']} times, want one")
    pts = plan.spectrum.points
    if not all(np.isfinite([p.mean, p.var, p.p99, p.p999]).all() for p in pts):
        raise AssertionError("non-finite spectrum point")
    if plan.n_batches not in spec.feasible_batches() or plan.backend != "cuda":
        raise AssertionError(f"bad plan {plan.n_batches} {plan.backend}")
    print(f"[plan_policies] B={plan.n_batches} policy={plan.policy} "
          f"p99={plan.predicted.p99:.6f} backend={plan.backend}")
    for p in pts:
        print(f"    B={p.n_batches:5d} mean={p.mean:.6f} p99={p.p99:.6f}")
    # a warm re-plan (kernels loaded, group minima from the cache the
    # first run filled): its wall and stages; then the card's busy time on
    # one more under the profiler
    _, warm_wall, warm_stages = timed_stages(fleet_plan)
    print(f"[plan_policies] warm re-plan: wall {warm_wall:.3f} s, stages "
          "(host s): " + ", ".join(f"{k} {v:.3f}"
                                   for k, v in warm_stages.items()))
    busy = print_busy("plan_policies", *busy_window(fleet_plan))

    # the card's plan equals the CPU plan (plain versions) on a small fleet;
    # a check, not part of the path, so its launches are not counted
    small = ClusterSpec(n_workers=16, dist=heavy, feasible_b=(2, 4, 8))
    plans = {d: SimulatedPlanner(n_trials=400, seed=0, device=d).plan(
        small, objective) for d in ("cuda", "cpu")}
    same = all(
        (a.mean, a.var, a.p99, a.p999) == (b.mean, b.var, b.p99, b.p999)
        for a, b in zip(plans["cuda"].spectrum.points,
                        plans["cpu"].spectrum.points))
    if not same or plans["cuda"].policy != plans["cpu"].policy:
        raise AssertionError("small plan differs between the card and the CPU")
    print(f"[plan_policies] small fleet: card plan == CPU plan "
          f"(B={plans['cuda'].n_batches}, policy={plans['cuda'].policy})")
    report["phases"]["plan_policies"] = {
        "wall_s": wall, "stages_s": stages, "launches": counts,
        "warm_wall_s": warm_wall, "warm_stages_s": warm_stages,
        "n_batches": plan.n_batches, "policy": repr(plan.policy),
        "points": [[p.n_batches, p.mean, p.var, p.p99, p.p999] for p in pts],
        "sojourn_dispatches": [
            {"cells": int(a[1].shape[0]), "policies": int(a[3].shape[0]),
             "jobs": int(a[1].shape[1]), "groups": int(a[1].shape[2]),
             "resolve": bool(kw.get("resolve", True))}
            for a, kw in soj_calls],
        "small_plan_card_equals_cpu": same, **busy,
    }

    # sojourn_cells' chain bound, for phases 2b and 4c's checks and phase 7's
    # rows
    sm_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])

    def resolving_programs(a_, kw):
        """(C, P) mask of the programs that resolve triggers: clone or
        relaunch at a finite threshold, when the launch resolves."""
        thr_ = a_[4]
        armed = torch.tensor([k in (1, 2) for k in a_[3].tolist()],
                             device=thr_.device)[None, :] & (thr_ < math.inf)
        return armed & bool(kw.get("resolve", True))

    def chain_bound_ms(a_, kw, extra):
        """The least time of the launch's longest program on the chain of
        dependent steps its code runs (``csrc/sojourn_cells.cu``): each of
        J dispatches stores the picked set and reloads its node (L cycles),
        then needs the free root's key and then its index (two dependent
        warp reductions, R each) before the next can pick; a program that
        resolves triggers waits on the trigger root's key, job id and set
        instead (3 R), and on one more walk (L + 2 R) for each trigger that
        fired in this run.  L and R from the probe, at the card's top SM
        clock; the kernel's other instructions are left out."""
        lat, red = chain_cycles["sts_syncwarp_lds128"], chain_cycles["redux"]
        ng_ = a_[6]
        n_jobs = a_[1].shape[1]
        resolving = resolving_programs(a_, kw)
        cycles = torch.where(
            resolving, n_jobs * (lat + 3 * red) + extra.double() * (lat + 2 * red),
            torch.full_like(extra, n_jobs, dtype=torch.float64)
            * (lat + 2 * red))
        cycles = torch.where(ng_[:, None] > 0, cycles, torch.zeros_like(cycles))
        return cycles.max().item() / (sm_clock_mhz * 1e6) * 1e3

    def soj_bytes_ms(a_, out_, x_):
        """The least time to move the bytes a launch needs: the arrivals
        and hedge masks once, one 32-byte sector of svc for each job of
        each cell of at least one set (the draw it is dispatched on; a
        cell's programs read one row), ``out`` and ``extra`` once.  Not
        the whole of svc and alt: a program reads a few draws of a row.
        alt's sectors are left out (a hedged job reads one only when its
        runner-up is idle), and so is the unstaged kernel's scratch (its
        own traffic, not the function's)."""
        arr_, svc_, hm_, ng_ = a_[0], a_[1], a_[5], a_[6]
        sectors = int((ng_ > 0).sum().item()) * svc_.shape[1]
        total = (32 * sectors + arr_.numel() * arr_.element_size()
                 + hm_.numel() * hm_.element_size()
                 + out_.numel() * out_.element_size()
                 + x_.numel() * x_.element_size())
        return total / HBM_BYTES_PER_S * 1e3

    def soj_prefix_check(tag, a_, kw_, jobs=SOJOURN_PLAIN_JOBS):
        """Hold one ``sojourn_cells`` dispatch bit-equal to the plain
        version on its first ``jobs`` jobs, at the dispatch's own cells,
        groups and policies (the plain version loops over jobs in
        Python); time both there."""
        j_ = min(jobs, a_[1].shape[1])
        cut_ = (a_[0][:j_].contiguous(), a_[1][:, :j_].contiguous(),
                a_[2][:, :j_].contiguous(), a_[3], a_[4],
                a_[5][:, :j_].contiguous(), a_[6])
        out_c, x_c = SK.sojourn_cells(*cut_, **kw_)
        k_ms = cuda_ms(lambda: SK.sojourn_cells(*cut_, **kw_), 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p, x_p = SK.sojourn_cells_plain(*cut_, **kw_)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(out_c, out_p) and torch.equal(x_c, x_p)):
            diff = (out_c - out_p).abs().max().item()
            raise AssertionError(f"sojourn_cells ({tag}) differs from its "
                                 f"plain version: max |diff| {diff}")
        chain = chain_bound_ms(cut_, kw_, x_c)
        bytes_ = soj_bytes_ms(cut_, out_c, x_c)
        return {"plain_jobs": j_, "ms_at_plain_jobs": k_ms, "plain_ms": p_ms,
                "max_abs_err": 0.0,
                "bound_ms_at_plain_jobs": max(chain, bytes_),
                "bound_by_at_plain_jobs": ("operations" if chain >= bytes_
                                           else "bytes")}

    # -- 2b. plan_wide ---------------------------------------------------
    _phase("plan_wide")
    t_wide = time.perf_counter()
    wide_entries: list = []  # kernel rows of the unstaged instantiation

    def wide_cells(seed, n_jobs, n_g, n_groups):
        """A launch's inputs made on the card: every cell padded to n_g,
        phase 2's four policy kinds, finite clone and relaunch thresholds
        (about svc's 0.67 and 0.83 quantiles), a 0.3 hedge mask."""
        g_ = torch.Generator(device=dev).manual_seed(seed)
        n_c = len(n_groups)
        arr_ = torch.cumsum(torch.empty(n_jobs, device=dev).exponential_(
            1.0, generator=g_) * (1.6 / n_g), 0)
        svc_, alt_ = (torch.empty(n_c, n_jobs, n_g, device=dev).exponential_(
            1.0, generator=g_) + 0.1 for _ in range(2))
        kinds_ = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=dev)
        thr_ = torch.tensor([[math.inf, 1.2, 1.9, math.inf]] * n_c,
                            device=dev)
        hm_ = torch.as_tensor(np.stack([SOPS.hedge_mask(n_jobs, f)
                                        for f in (0, 0, 0, 0.3)])).to(dev)
        ng_ = torch.tensor(n_groups, dtype=torch.int32, device=dev)
        return (arr_, svc_, alt_, kinds_, thr_, hm_, ng_)

    def wide_row(tag, a_, kw_):
        """One sojourn_cells call held bit-equal to the plain version on
        its first WIDE_CHECK_JOBS jobs (soj_prefix_check), then the whole
        call's event times and bounds: a kernel row."""
        e = {"name": "sojourn_cells", "case": tag,
             "shape": [int(v) for v in a_[1].shape] + [int(a_[3].shape[0])],
             "n_groups": a_[6].tolist(),
             "staged": a_[1].shape[2] <= SK._max_groups(),
             "resolve": bool(kw_.get("resolve", True)),
             **soj_prefix_check(tag, a_, kw_, WIDE_CHECK_JOBS)}
        fn = lambda: SK.sojourn_cells(*a_, **kw_)  # noqa: E731
        out_, x_ = fn()
        chain = chain_bound_ms(a_, kw_, x_)
        bytes_ = soj_bytes_ms(a_, out_, x_)
        e.update({"ms": cuda_ms(fn, 3), "call_ms": call_ms(fn, 3),
                  "bound_ms": max(chain, bytes_),
                  "bound_by": "operations" if chain >= bytes_ else "bytes",
                  "chain_bound_ms": chain, "bytes_bound_ms": bytes_,
                  "fired": int(x_[resolving_programs(a_, kw_)].sum().item()),
                  "library_ms": None})
        print(f"[plan_wide] {tag} C,J,G,P={e['shape']} "
              f"({'staged' if e['staged'] else 'unstaged'}): first "
              f"{e['plain_jobs']} jobs bit-equal to plain (kernel "
              f"{e['ms_at_plain_jobs']:.3f} ms, plain {e['plain_ms']:.1f} "
              f"ms); {e['ms']:.3f} ms (per call {e['call_ms']:.3f} ms), "
              f"chain bound {chain:.4f} ms ({e['fired']} triggers fired), "
              f"bytes bound {bytes_:.4f} ms", flush=True)
        return e

    # (a) both sides of the staged limit, and the mixed launch
    if SK._max_groups() != WIDE_CHECK_GROUPS[0]:
        print(f"[plan_wide] this card stages up to {SK._max_groups()} sets "
              f"(the H100's limit is {WIDE_CHECK_GROUPS[0]})")
    for n_g_ in WIDE_CHECK_GROUPS:
        # two cells, the second padded, but at the widest: one cell
        groups = ((n_g_,) if n_g_ == WIDE_CHECK_GROUPS[-1]
                  else (n_g_ // 2, n_g_))
        a_ = wide_cells(n_g_, WIDE_CHECK_JOBS, n_g_, groups)
        e = wide_row(f"G {n_g_}", a_, {"resolve": True})
        if n_g_ == WIDE_CHECK_GROUPS[-1]:
            wide_entries.append(e)
        del a_
    a_ = wide_cells(7, WIDE_CHECK_JOBS, WIDE_MIXED_GROUPS[-1],
                    WIDE_MIXED_GROUPS)
    wide_row("mixed n_groups", a_, {"resolve": True})
    del a_
    # the split at 65,536 sets (the hot words of the sets below K on chip):
    # cells of K - 1, K and K + 1 sets padded to 65,536, one launch
    k_split = SK._wide_split(WIDE_CHECK_GROUPS[-1])[0]
    a_ = wide_cells(11, WIDE_CHECK_JOBS, WIDE_CHECK_GROUPS[-1],
                    (k_split - 1, k_split, k_split + 1))
    soj_prefix_check("split", a_, {"resolve": True}, WIDE_CHECK_JOBS)
    print(f"[plan_wide] cells of K - 1, K and K + 1 sets (K = {k_split}, "
          f"the split at {WIDE_CHECK_GROUPS[-1]}): first {WIDE_CHECK_JOBS} "
          f"jobs bit-equal to plain", flush=True)
    del a_
    # the unstaged kernel forced past its sets, every job held bit-equal to
    # the staged kernel: phase 2's dispatch (20,000 jobs on 2,000 sets, one
    # table entry a lane), and more jobs than sets where a lane keeps two
    # and three entries (cells of 5,000 and 10,000 sets, 12,000 jobs), so
    # that sets are revisited in every slot of the table
    (p2_args, p2_kw), = soj_calls
    a_ = wide_cells(10, WIDE_REVISIT_JOBS, WIDE_REVISIT_GROUPS[-1],
                    WIDE_REVISIT_GROUPS)
    for tag, (args_, kw_) in (("phase 2's dispatch", (p2_args, p2_kw)),
                              (f"{WIDE_REVISIT_JOBS} jobs on "
                               f"{WIDE_REVISIT_GROUPS} sets",
                               (a_, {"resolve": True}))):
        wide_o = SK.sojourn_cells(*args_, **kw_, force_wide=True)
        staged_o = SK.sojourn_cells(*args_, **kw_)
        if not all(torch.equal(u, v) for u, v in zip(wide_o, staged_o)):
            raise AssertionError(f"the unstaged sojourn_cells differs from "
                                 f"the staged one on {tag}")
        print(f"[plan_wide] the unstaged kernel forced onto {tag}: every job "
              f"bit-equal to the staged one", flush=True)
    # the loop's names too: they hold the last inputs (2 GB of the card)
    del a_, args_, kw_, wide_o, staged_o
    # ptxas's registers and shared memory of each instantiation, from the
    # build's log (the staged ones are to match the parent's)
    ptxas = soj_ptxas_figures()
    staged_same = all(ptxas.get(k) == v for k, v in STAGED_PTXAS.items())
    print(f"[plan_wide] ptxas: {ptxas}; the staged instantiations' as PR "
          f"28's build {STAGED_PTXAS}: {staged_same}")
    # (c) phase 2's dispatch on the staged kernel, re-timed here
    p2_fn = lambda: SK.sojourn_cells(*p2_args, **p2_kw)  # noqa: E731
    p2_wide_fn = lambda: SK.sojourn_cells(  # noqa: E731
        *p2_args, **p2_kw, force_wide=True)
    p2_ms, p2_call = cuda_ms(p2_fn, 3), call_ms(p2_fn, 3)
    p2_wide_ms, p2_wide_call = cuda_ms(p2_wide_fn, 3), call_ms(p2_wide_fn, 3)
    print(f"[plan_wide] phase 2's dispatch C,J,G,P="
          f"{list(p2_args[1].shape) + [int(p2_args[3].shape[0])]}: staged "
          f"{p2_ms:.3f} ms (per call {p2_call:.3f} ms); the unstaged kernel "
          f"forced there {p2_wide_ms:.3f} ms (per call {p2_wide_call:.3f} "
          f"ms), bit-equal to the staged one")

    # (b) the wide fleet's plan: one launch over 4 B x 4 policies at r = 1's
    # 16,384 sets
    wide_spec = ClusterSpec(n_workers=WIDE_FLEET_N, dist=heavy,
                            feasible_b=WIDE_FLEET_B)

    def wide_plan():
        return SimulatedPlanner(n_trials=WIDE_FLEET_TRIALS, seed=0,
                                device="cuda").plan(wide_spec, objective)

    wide_calls: list = []
    # the later phases find the sweeps' group-minima cache as phase 2 left
    # it (the wide fleet's entry alone holds 2 GB of the card)
    cached = dict(SIM._GROUP_MIN_CACHE)
    orig = capture(SK, "sojourn_cells", wide_calls)
    try:
        wplan, wcounts, wwall, wstages = run_path("plan_wide", wide_plan)
    finally:
        SK.sojourn_cells = orig
        SIM._GROUP_MIN_CACHE.clear()
        SIM._GROUP_MIN_CACHE.update(cached)
    if wcounts["sojourn_cells"] != 1:
        raise AssertionError(f"plan_wide launched sojourn_cells "
                             f"{wcounts['sojourn_cells']} times, want one")
    got = plan_summary(wplan)
    if got != WIDE_FLEET or wplan.backend != "cuda":
        raise AssertionError(f"plan_wide: {got} on {wplan.backend}, want the "
                             f"reference's {WIDE_FLEET}")
    print(f"[plan_wide] B={wplan.n_batches} policy={wplan.policy} "
          f"p99={wplan.predicted.p99!r}: the reference's decision and "
          f"points")
    (wa, wkw), = wide_calls
    fleet_e = wide_row("WIDE_FLEET dispatch", wa, wkw)
    fleet_e["launches"] = {"plan_wide": wcounts["sojourn_cells"]}
    wide_entries.append(fleet_e)
    wide_wall = time.perf_counter() - t_wide
    print(f"[plan_wide] phase 2b: {wide_wall:.1f} s")
    report["phases"]["plan_wide"] = {
        "wall_s": wwall, "stages_s": wstages, "launches": wcounts,
        "decision": got, "kernels": wide_entries,
        "phase2_dispatch_ms": p2_ms, "phase2_dispatch_call_ms": p2_call,
        "phase2_dispatch_forced_unstaged_ms": p2_wide_ms,
        "phase2_dispatch_forced_unstaged_call_ms": p2_wide_call,
        "split_65536": k_split, "ptxas": ptxas,
        "staged_ptxas_as_parent": staged_same, "phase_wall_s": wide_wall}
    # phase 2's captured inputs stay in soj_calls alone, which phase 7
    # clears: a name here would keep 2 GB of the card until the script ends
    del wa, wkw, wide_calls, cached, p2_args, p2_kw, p2_fn, p2_wide_fn
    del wplan
    torch.cuda.empty_cache()

    # -- 3. fleet_grid ----------------------------------------------------
    _phase("fleet_grid")
    rng = np.random.default_rng(0)
    pool = rng.gamma(2.0, 0.5, 10_000)
    dists = [Empirical(rng.choice(pool, pool.size)) for _ in range(256)]

    def fleet():
        return sweep_sojourn_policies(
            dists, n_workers=10_000, arrival_rate=40.0, policies=policies,
            n_jobs=300, seed=3, feasible_b=[50, 100, 200], device="cuda")

    res, counts, cold, _ = run_path("fleet_grid", fleet)
    if counts["sojourn_cells"] != 1:
        raise AssertionError(f"fleet_grid launched sojourn_cells "
                             f"{counts['sojourn_cells']} times, want one")
    if res.samples.shape != (256, 3, 4, 270) or not np.isfinite(
            res.samples).all():
        raise AssertionError(f"bad fleet samples {res.samples.shape}")
    warm = [timed_stages(fleet)[1:] for _ in range(3)]
    best_wall, best_stages = min(warm, key=lambda w: w[0])
    print(f"[fleet_grid] 3072 (cell, policy) programs: cold {cold:.3f} s, "
          f"warm best-of-3 {best_wall:.3f} s (all "
          f"{[round(w[0], 4) for w in warm]})")
    print("[fleet_grid] best warm run's stages (host s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in best_stages.items()))
    busy = print_busy("fleet_grid", *busy_window(fleet))
    report["phases"]["fleet_grid"] = {
        "cold_s": cold, "warm_s": [w[0] for w in warm],
        "warm_stages_s": best_stages, "launches": counts, **busy}

    # -- 4. plan_coded ----------------------------------------------------
    _phase("plan_coded")
    cands = tuple(CodingCandidate("mds", s) for s in (4, 8, 12))
    coded_calls: list = []
    combine_calls: list = []
    o1 = capture(SK, "coded_cells", coded_calls)
    o2 = capture(coded_ops, "combine", combine_calls)
    try:
        cplan, counts, wall, _ = run_path(
            "plan_coded", lambda: SimulatedPlanner(
                n_trials=6_000, seed=0, device="cuda").plan(
                    ClusterSpec(n_workers=16, dist=heavy),
                    Objective(metric="mean", coding=cands)))
        if cplan.coding is None or cplan.coding.describe() != "mds(s=12)":
            raise AssertionError(f"coded winner {cplan.coding}, want mds(s=12)")
        best_rep = min(p.mean for p in cplan.spectrum.points)
        print(f"[plan_coded] winner {cplan.coding.describe()} "
              f"mean={cplan.predicted.mean:.6f} vs best replication "
              f"{best_rep:.6f}; enc={cplan.coding.encode_overhead:.3e} s "
              f"dec={cplan.coding.decode_overhead:.3e} s")
        for k in ("combine", "coded_cells"):
            if counts[k] <= 0:
                raise AssertionError(f"plan_coded never launched {k}")
        lplan, lcounts, lwall, _ = run_path(
            "plan_coded_sojourn", lambda: SimulatedPlanner(
                n_trials=6_000, seed=0, device="cuda").plan(
                    ClusterSpec(n_workers=16, dist=heavy),
                    Objective(metric="p99", utilization=0.7, coding=cands)))
        for k in PLANNER_KERNELS:
            if lcounts[k] <= 0:
                raise AssertionError(f"plan_coded_sojourn never launched {k}")
    finally:
        SK.coded_cells, coded_ops.combine = o1, o2
    print(f"[plan_coded] load-aware p99: B={lplan.n_batches} "
          f"coding={lplan.coding} p99={lplan.predicted.p99:.6f}")
    # the fleet's coded sweep through the simulator's entry point: one
    # coded_cells launch over 3 x 2,000 x 10,000 cells (240 MB)
    fleet_cands = tuple(CodingCandidate("mds", s_) for s_ in CODED_FLEET_S)
    fleet_coded_calls: list = []
    o1 = capture(SK, "coded_cells", fleet_coded_calls)
    try:
        fsweep, fcounts, fwall, fstages = run_path(
            "coded_fleet", lambda: sweep_coded(
                heavy, CODED_FLEET_N, fleet_cands,
                n_trials=CODED_FLEET_TRIALS, seed=0, device="cuda"))
    finally:
        SK.coded_cells = o1
    if fcounts["coded_cells"] != 1:
        raise AssertionError(f"coded_fleet launched coded_cells "
                             f"{fcounts['coded_cells']} times, want one")
    if (fsweep.samples.shape != (1, len(CODED_FLEET_S), CODED_FLEET_TRIALS)
            or not np.isfinite(fsweep.samples).all()
            or not (fsweep.samples > 0).all()):
        raise AssertionError(f"bad coded_fleet samples {fsweep.samples.shape}")
    fleet_means = fsweep.means()[0].tolist()
    print(f"[coded_fleet] N={CODED_FLEET_N}, mds s={CODED_FLEET_S}, "
          f"{CODED_FLEET_TRIALS} trials: mean completion {fleet_means}")
    report["phases"]["plan_coded"] = {
        "wall_s": wall, "launches": counts, "winner": cplan.coding.describe(),
        "mean": cplan.predicted.mean, "best_replication_mean": best_rep,
        "encode_s": cplan.coding.encode_overhead,
        "decode_s": cplan.coding.decode_overhead,
        "sojourn_wall_s": lwall, "sojourn_launches": lcounts,
        "sojourn_plan": [lplan.n_batches, repr(lplan.coding),
                         lplan.predicted.p99],
        "fleet": {"wall_s": fwall, "stages_s": fstages, "launches": fcounts,
                  "s": list(CODED_FLEET_S), "means": fleet_means},
    }

    # -- 4b. plan_serving and serving_fleet -------------------------------
    _phase("plan_serving")
    serving_classes = (
        SloClass("premium", share=0.25, weight=4.0, deadline=0.8,
                 miss_target=0.05),
        SloClass("standard", share=0.75, weight=1.0, deadline=3.0,
                 miss_target=0.5))
    sexp = ShiftedExponential(0.02, 2.0)
    serving_objective = Objective(
        metric="mean", utilization=0.95, job_load=0.96, batch_size=4,
        slo_classes=serving_classes,
        policies=(PolicyCandidate(),
                  PolicyCandidate("hedged", hedge_fraction=1.0)),
        max_waits=(0.2, 0.5, math.inf),
        sheds=(ShedPolicy("cap", cap=48), ShedPolicy("expired")))

    def decision(p):
        return {"n_batches": p.n_batches, "policy": p.policy.kind,
                "max_wait": p.max_wait, "shed": (p.shed.kind, p.shed.cap),
                "class_report": p.class_report}

    def spectrum_points(p):
        return [(q.n_batches, q.mean, q.var, q.p99, q.p999)
                for q in p.spectrum.points]

    def serving_plan(spec_, n_requests, device):
        return SimulatedPlanner(n_trials=n_requests, seed=0,
                                device=device).plan(spec_, serving_objective)

    def check_serving_launches(tag, counts, calls):
        if counts["sojourn_cells"] != SERVING_LAUNCHES:
            raise AssertionError(
                f"{tag} launched sojourn_cells {counts['sojourn_cells']} "
                f"times, want {SERVING_LAUNCHES}")
        # programs (one warp each) and jobs of every dispatch
        return [{"cells": int(a[1].shape[0]), "policies": int(a[3].shape[0]),
                 "jobs": int(a[1].shape[1]), "groups": int(a[1].shape[2]),
                 "resolve": bool(kw.get("resolve", True))} for a, kw in calls]

    bench_spec = ClusterSpec(n_workers=16, dist=sexp)
    bench_calls: list = []
    orig = capture(SK, "sojourn_cells", bench_calls)
    try:
        splan, scounts, swall, sstages = run_path(
            "plan_serving", lambda: serving_plan(bench_spec, 4_000, "cuda"))
    finally:
        SK.sojourn_cells = orig
    bench_dispatches = check_serving_launches("plan_serving", scounts,
                                              bench_calls)
    del bench_calls
    cpu_splan = serving_plan(bench_spec, 4_000, "cpu")
    if (decision(splan) != decision(cpu_splan)
            or spectrum_points(splan) != spectrum_points(cpu_splan)
            or splan.policy != cpu_splan.policy
            or splan.shed != cpu_splan.shed):
        raise AssertionError(
            f"plan_serving differs between the card and the CPU: "
            f"{decision(splan)} {spectrum_points(splan)} against "
            f"{decision(cpu_splan)} {spectrum_points(cpu_splan)}")
    if decision(splan) != SERVING_DECISION or splan.backend != "cuda":
        raise AssertionError(f"plan_serving decided {decision(splan)} on "
                             f"{splan.backend}, the reference "
                             f"{SERVING_DECISION}")
    print(f"[plan_serving] card plan == CPU plan == the reference's "
          f"decision: {decision(splan)}")
    for q in splan.spectrum.points:
        print(f"    B={q.n_batches:3d} mean={q.mean:.6f} p99={q.p99:.6f}")
    report["phases"]["plan_serving"] = {
        "wall_s": swall, "stages_s": sstages, "launches": scounts,
        "decision": {**decision(splan), "max_wait": repr(splan.max_wait)},
        "points": spectrum_points(splan), "card_equals_cpu": True,
        "sojourn_dispatches": bench_dispatches}

    # the same objective on a 1,024-replica fleet: 40,000 requests, about
    # 10,000 jobs a combo
    _phase("serving_fleet")
    fleet_spec = ClusterSpec(n_workers=SERVING_FLEET_N, dist=sexp,
                             feasible_b=SERVING_FLEET_B)

    def fleet_serving():
        return serving_plan(fleet_spec, SERVING_FLEET_REQUESTS, "cuda")

    fleet_serving_calls: list = []
    orig = capture(SK, "sojourn_cells", fleet_serving_calls)
    try:
        fsplan, fscounts, fscold, fsstages = run_path("serving_fleet",
                                                      fleet_serving)
    finally:
        SK.sojourn_cells = orig
    fleet_dispatches = check_serving_launches("serving_fleet", fscounts,
                                              fleet_serving_calls)
    # keep the widest dispatch's inputs for phase 7, drop the rest
    serving_widest = [max(fleet_serving_calls,
                          key=lambda c: c[0][1].numel())]
    del fleet_serving_calls
    fpts = spectrum_points(fsplan)
    if (fsplan.n_batches not in SERVING_FLEET_B or fsplan.backend != "cuda"
            or not np.isfinite(np.asarray(fpts)).all()
            or not all(0.0 <= m <= 1.0 for _, m in fsplan.class_report)):
        raise AssertionError(f"bad serving_fleet plan {decision(fsplan)} "
                             f"{fpts} on {fsplan.backend}")
    rate = serving_objective.request_rate(fleet_spec)
    print(f"[serving_fleet] N={SERVING_FLEET_N}, "
          f"{SERVING_FLEET_REQUESTS} requests at {rate:.1f} a time unit: "
          f"{decision(fsplan)}, cold wall {fscold:.3f} s")
    for q in fsplan.spectrum.points:
        print(f"    B={q.n_batches:3d} mean={q.mean:.6f} p99={q.p99:.6f}")
    print("[serving_fleet] dispatches (cells x policies programs of one "
          "warp, jobs, groups): "
          + ", ".join(f"{d['cells']}x{d['policies']} J={d['jobs']} "
                      f"G={d['groups']}" for d in fleet_dispatches))
    _, fswarm, fswarm_stages = timed_stages(fleet_serving)
    print(f"[serving_fleet] warm re-plan: wall {fswarm:.3f} s, stages "
          "(host s): " + ", ".join(f"{k} {v:.3f}"
                                   for k, v in fswarm_stages.items()))
    fs_busy = print_busy("serving_fleet", *busy_window(fleet_serving),
                         shares={"sojourn_cells": "sojourn_cells_kernel"})
    if fs_busy["device_busy_s"] is None:
        raise AssertionError("the profiler saw no device work in "
                             "serving_fleet")
    # each launch's device time in the profiled plan, in launch order
    fs_launch_s = [sec for _, sec, name in last_profile
                   if "sojourn_cells_kernel" in name]
    if len(fs_launch_s) == len(fleet_dispatches):
        for d_, sec in zip(fleet_dispatches, fs_launch_s):
            d_["device_ms"] = sec * 1e3
        print("[serving_fleet] sojourn_cells device ms a launch in the "
              "profiled plan: " + ", ".join(
                  f"{d_['cells']}x{d_['policies']} J={d_['jobs']} "
                  f"G={d_['groups']}: {d_['device_ms']:.3f}"
                  for d_ in fleet_dispatches))
    else:
        print(f"[serving_fleet] the profiler recorded {len(fs_launch_s)} "
              f"sojourn_cells launches of {len(fleet_dispatches)}")
    report["phases"]["serving_fleet"] = {
        "cold_s": fscold, "stages_s": fsstages, "launches": fscounts,
        "warm_s": fswarm, "warm_stages_s": fswarm_stages,
        "request_rate": rate,
        "decision": {**decision(fsplan), "max_wait": repr(fsplan.max_wait)},
        "points": fpts, "sojourn_dispatches": fleet_dispatches, **fs_busy}

    # -- 4c. tuner: the rate-aware and bootstrap planners, the online tuner -
    from repro_torch.core.order_stats import Exponential
    from repro_torch.core.planner import (EmpiricalPlanner,
                                          HeterogeneousPlanner, make_planner)
    from repro_torch.core.policies import replica_major_nonoverlapping
    from repro_torch.core.replication import ReplicationPlan
    from repro_torch.core.simulator import (FaultEvent, StepTimeSimulator,
                                            censored_observations,
                                            completion_from_step_times)
    from repro_torch.core.tuner import StragglerTuner, TunerConfig

    def plan_decision(p):
        return {"n_batches": p.n_batches,
                "policy": None if p.policy is None else (p.policy.kind,
                                                         p.policy.quantile),
                "speculation_quantile": p.speculation_quantile,
                "coding": None if p.coding is None else p.coding.describe(),
                "confidence": p.confidence, "vote_share": p.vote_share,
                "closed_form_mean": p.closed_form_mean}

    def same_plans(tag, card_plan, cpu_plan):
        if (plan_decision(card_plan) != plan_decision(cpu_plan)
                or spectrum_points(card_plan) != spectrum_points(cpu_plan)):
            raise AssertionError(
                f"{tag} differs between the card and the CPU: "
                f"{plan_decision(card_plan)} against "
                f"{plan_decision(cpu_plan)}")
        print(f"[{tag}] card plan == CPU plan: {plan_decision(card_plan)}")

    # the new paths' profiled re-plans run after phase 7, so that phase 7's
    # profiler windows follow the same profiler sessions as before
    deferred_profiles: list = []  # (phase, key, tag, fn)

    def busy_of(tag, fn):
        out = print_busy(tag, *busy_window(fn),
                         shares={"sojourn_cells": "sojourn_cells_kernel",
                                 "coded_cells": "coded_",
                                 "combine": "combine"})
        if out["device_busy_s"] is None:
            raise AssertionError(f"the profiler saw no device work in {tag}")
        return out

    # the widest sojourn_cells dispatch (and the coded_cells calls) of each
    # 4c path, held against the plain versions at the path's own shapes
    plain_checks: list = []

    def hold_widest(tag, calls):
        (a_, kw_) = max(calls, key=lambda c: c[0][1].numel())
        e = {"name": "sojourn_cells", "case": tag,
             "shape": [int(v) for v in a_[1].shape] + [int(a_[3].shape[0])],
             "resolve": bool(kw_.get("resolve", True)),
             **soj_prefix_check(tag, a_, kw_)}
        print(f"[{tag}] sojourn_cells widest dispatch C,J,G,P={e['shape']}: "
              f"first {e['plain_jobs']} jobs bit-equal to the plain version "
              f"(kernel {e['ms_at_plain_jobs']:.3f} ms, bound "
              f"{e['bound_ms_at_plain_jobs']:.4f} ms "
              f"({e['bound_by_at_plain_jobs']}), plain {e['plain_ms']:.1f} "
              "ms)")
        plain_checks.append(e)
        return e

    def hold_coded(tag, calls):
        out_ = []
        for (times_, ks_), _ in calls:
            if not torch.equal(SK.coded_cells(times_, ks_),
                               SK.coded_cells_plain(times_, ks_.to(dev))):
                raise AssertionError(f"coded_cells ({tag}) differs from its "
                                     f"plain version at {tuple(times_.shape)}")
            out_.append({"name": "coded_cells", "case": tag,
                         "shape": list(times_.shape), "ks": ks_.tolist(),
                         "max_abs_err": 0.0})
        print(f"[{tag}] coded_cells {[e['shape'] for e in out_]}: bit-equal "
              "to the plain version")
        plain_checks.extend(out_)
        return out_

    bench_dist = ShiftedExponential(0.25, 1.0)
    bench_pols = (PolicyCandidate("none"),
                  PolicyCandidate("clone", quantile=0.9),
                  PolicyCandidate("relaunch", quantile=0.9),
                  PolicyCandidate("hedged", hedge_fraction=0.1))
    p99_objective = Objective(metric="p99", utilization=0.7,
                              policies=bench_pols)

    t_4c = time.perf_counter()
    _phase("plan_heterogeneous")
    skew = ClusterSpec(n_workers=PLAN_N, dist=bench_dist, rates=tuple(
        np.concatenate([[0.1], np.linspace(0.7, 1.3, PLAN_N - 1)])))
    shrunk, dropped = skew.drop_slowest(4)

    def hetero(spec_, objective_, device, trials=PLAN_TRIALS):
        return HeterogeneousPlanner(n_trials=trials, seed=0,
                                    device=device).plan(spec_, objective_)

    def hetero_path():
        parts, walls = {}, {}
        for name, spec_, obj_ in (
                ("mean", skew, Objective(metric="mean")),
                ("shrink", shrunk, Objective(metric="mean")),
                ("p99", skew, p99_objective)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts[name] = hetero(spec_, obj_, "cuda")
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        return parts, walls

    hetero_calls: list = []
    orig = capture(SK, "sojourn_cells", hetero_calls)
    try:
        (hplans, hwalls), hcounts, hwall, hstages = run_path(
            "plan_heterogeneous", hetero_path)
    finally:
        SK.sojourn_cells = orig
    if hcounts["sojourn_cells"] != len(skew.feasible_batches()):
        raise AssertionError(
            f"plan_heterogeneous launched sojourn_cells "
            f"{hcounts['sojourn_cells']} times, want one a B "
            f"({len(skew.feasible_batches())})")
    got = {"mean": hplans["mean"].n_batches,
           "shrink": (hplans["shrink"].n_batches, dropped),
           "p99": (hplans["p99"].n_batches, hplans["p99"].policy.kind,
                   hplans["p99"].policy.quantile)}
    if got != HETERO_DECISIONS or any(p.backend != "cuda"
                                      for p in hplans.values()):
        raise AssertionError(f"plan_heterogeneous decided {got}, the "
                             f"reference {HETERO_DECISIONS}")
    print(f"[plan_heterogeneous] N={PLAN_N}, {PLAN_TRIALS} trials: the "
          f"reference's decisions {got}; walls (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in hwalls.items()))
    for name in ("mean", "shrink"):
        same_plans(f"plan_heterogeneous {name}", hplans[name], hetero(
            skew if name == "mean" else shrunk, Objective(metric="mean"),
            "cpu"))
    same_plans(f"plan_heterogeneous p99 at {PLAN_CHECK_JOBS} jobs",
               hetero(skew, p99_objective, "cuda", PLAN_CHECK_JOBS),
               hetero(skew, p99_objective, "cpu", PLAN_CHECK_JOBS))
    hetero_widest = hold_widest("plan_heterogeneous p99", hetero_calls)
    del hetero_calls
    deferred_profiles.append(("plan_heterogeneous", "p99_profile",
                              "plan_heterogeneous p99",
                              lambda: hetero(skew, p99_objective, "cuda")))
    report["phases"]["plan_heterogeneous"] = {
        "wall_s": hwall, "walls_s": hwalls, "stages_s": hstages,
        "launches": hcounts, "decisions": got,
        "points": {k: spectrum_points(p) for k, p in hplans.items()},
        "card_equals_cpu": True, "plain_check": hetero_widest}

    _phase("plan_empirical")
    pool = Empirical(tuple(bench_dist.sample(np.random.default_rng(0),
                                             2_000)))
    pool_spec = ClusterSpec(n_workers=PLAN_N, dist=pool)
    emp_codes = tuple(CodingCandidate("mds", s_) for s_ in (4, 8, 16))
    emp_objective = Objective(metric="p99", utilization=0.7,
                              policies=bench_pols, coding=emp_codes)

    def empirical(k, objective_, device, trials=PLAN_TRIALS):
        return EmpiricalPlanner(n_trials=trials, seed=0, n_resamples=k,
                                device=device).plan(pool_spec, objective_)

    def empirical_path():
        parts, walls = {}, {}
        for name, k, obj_ in ((4, 4, Objective(metric="mean")),
                              (16, 16, Objective(metric="mean")),
                              (64, 64, Objective(metric="mean")),
                              ("p99", 16, emp_objective)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts[name] = empirical(k, obj_, "cuda")
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        return parts, walls

    emp_calls: list = []
    emp_coded_calls: list = []
    orig = capture(SK, "sojourn_cells", emp_calls)
    orig_coded = capture(SK, "coded_cells", emp_coded_calls)
    try:
        (eplans, ewalls), ecounts, ewall, estages = run_path(
            "plan_empirical", empirical_path)
    finally:
        SK.sojourn_cells, SK.coded_cells = orig, orig_coded
    # the portfolio's one launch of 16 x 7 x 4 programs, and the coded
    # race's queue (sojourn_cells at G = 1) on its k-of-N service column
    if (ecounts["sojourn_cells"] != 2 or ecounts["coded_cells"] != 1
            or ecounts["combine"] <= 0):
        raise AssertionError(f"plan_empirical launched {ecounts}, want "
                             "sojourn_cells 2, coded_cells 1, combine > 0")
    got = {k: (eplans[k].n_batches, eplans[k].confidence,
               eplans[k].vote_share) for k in (4, 16, 64)}
    if got != EMPIRICAL_DECISIONS:
        raise AssertionError(f"plan_empirical decided {got}, the reference "
                             f"{EMPIRICAL_DECISIONS}")
    ep = eplans["p99"]
    print(f"[plan_empirical] the reference's votes at K 4, 16, 64: {got}; "
          f"K 16 load-aware p99: B={ep.n_batches} policy={ep.policy} "
          f"coding={ep.coding} confidence={ep.confidence}; walls (s) "
          + ", ".join(f"K{k} {v:.3f}" if k != "p99" else f"p99 {v:.3f}"
                      for k, v in ewalls.items()))
    for k in (4, 16, 64):
        same_plans(f"plan_empirical K {k}", eplans[k],
                   empirical(k, Objective(metric="mean"), "cpu"))
    # the coded race with the card's measured overheads on both sides
    resolved = SimulatedPlanner(device="cuda")._resolved_coding(
        emp_objective, PLAN_N, dev)
    check_obj = dataclasses.replace(emp_objective, coding=resolved)
    same_plans(f"plan_empirical p99 at {PLAN_CHECK_JOBS} jobs",
               empirical(16, check_obj, "cuda", PLAN_CHECK_JOBS),
               empirical(16, check_obj, "cpu", PLAN_CHECK_JOBS))
    emp_checks = [hold_widest("plan_empirical p99", emp_calls),
                  *hold_coded("plan_empirical p99", emp_coded_calls)]
    del emp_calls, emp_coded_calls
    deferred_profiles.append(("plan_empirical", "p99_profile",
                              "plan_empirical p99",
                              lambda: empirical(16, check_obj, "cuda")))
    report["phases"]["plan_empirical"] = {
        "wall_s": ewall, "walls_s": {str(k): v for k, v in ewalls.items()},
        "stages_s": estages, "launches": ecounts,
        "decisions": {str(k): v for k, v in got.items()},
        "p99_decision": plan_decision(ep), "card_equals_cpu": True,
        "plain_checks": emp_checks}

    _phase("tuner_switch")
    switch_pols = (
        *(PolicyCandidate("clone", quantile=q) for q in (0.8, 0.9)),
        *(PolicyCandidate("relaunch", quantile=q) for q in (0.8, 0.9)),
        PolicyCandidate("hedged", hedge_fraction=0.1),
        PolicyCandidate("hedged", hedge_fraction=0.3))

    def tuner_switch():
        tuner = StragglerTuner(
            ReplicationPlan(n_data=16, n_batches=4),
            TunerConfig(mode="simulate", sim_trials=4_000, sim_seed=0,
                        min_samples=64, cooldown_steps=8, window_steps=16,
                        improvement_threshold=0.05, metric="p99",
                        device="cuda"),
            policy_candidates=switch_pols)
        rng = np.random.default_rng(0)
        adopted, moves, attempts = [], [], []
        for dist_, steps in ((Exponential(2.0), 24),
                             (ShiftedExponential(0.5, 2.0), 32)):
            for _ in range(steps):
                tuner.observe(dist_.sample(rng, 16))
                tuner.observe_load(13.0)
                before = tuner._last_attempt
                rp = tuner.maybe_replan()
                if tuner._last_attempt != before:
                    attempts.append((tuner._last_attempt,
                                     tuner.last_replan_seconds))
                if rp is not None:
                    moves.append((rp.step, rp.old_batches, rp.new_batches))
                    tuner.apply(rp)
            pol = tuner.last_plan.policy
            adopted.append((pol.kind, pol.quantile))
        return {"adopted": tuple(adopted), "moves": tuple(moves),
                "final_b": tuner.plan.n_batches}, attempts

    (switch, switch_attempts), scounts4, swall4, sstages4 = run_path(
        "tuner_switch", tuner_switch)
    if switch != SWITCH_DECISION:
        raise AssertionError(f"tuner_switch decided {switch}, the reference "
                             f"{SWITCH_DECISION}")
    if scounts4["sojourn_cells"] != len(switch_attempts):
        raise AssertionError(f"tuner_switch launched sojourn_cells "
                             f"{scounts4['sojourn_cells']} times in "
                             f"{len(switch_attempts)} re-plans")
    print(f"[tuner_switch] the reference's decision {switch}; re-plans "
          "(step, wall s): "
          + ", ".join(f"{s_} {w:.3f}" for s_, w in switch_attempts))
    report["phases"]["tuner_switch"] = {
        "wall_s": swall4, "stages_s": sstages4, "launches": scounts4,
        "decision": switch, "attempts": switch_attempts}

    _phase("tuner_fleet")
    fleet_n, fleet_b0, fleet_steps = (TUNER_FLEET_N, TUNER_FLEET_B0,
                                      TUNER_FLEET_STEPS)
    fleet_dist = ShiftedExponential(0.05, 2.0)
    drift_pool = Empirical(tuple(np.random.default_rng(1).lognormal(
        -1.1, 1.0, 2_000)))
    fleet_rate = Objective(utilization=0.7).offered_rate(
        ClusterSpec(n_workers=fleet_n, dist=fleet_dist))
    fleet_cfg = TunerConfig(
        mode="simulate", heterogeneous=True, sim_trials=4_000,
        window_steps=50, cooldown_steps=20, metric="p99", gof_alpha=0.01,
        bootstrap_resamples=20, replan_time_budget=1.0, device="cuda")
    n_splits = len(ClusterSpec(n_workers=fleet_n,
                               dist=fleet_dist).feasible_batches())
    cells_bytes = (2 * fleet_cfg.bootstrap_resamples * n_splits
                   * fleet_cfg.sim_trials * fleet_n * 4)
    print(f"[tuner_fleet] N={fleet_n}, B0={fleet_b0}, {fleet_steps} steps, "
          f"job rate {fleet_rate:.4f} (utilization 0.7 of the unreplicated "
          f"fleet); the empirical fallback's svc + alt cells: "
          f"{fleet_cfg.bootstrap_resamples} x {n_splits} x "
          f"{fleet_cfg.sim_trials} x {fleet_n} float32 x 2 = "
          f"{cells_bytes / 1e9:.2f} GB")
    fleet_attempts: list = []
    last_by_planner: dict = {}
    # the widest sojourn_cells dispatch of the last re-plan of each kind
    fleet_calls: list = []
    fleet_widest: dict = {}

    def tuner_fleet():
        slow = {w: 4.0 for w in TUNER_FLEET_SLOW}
        # the fault ends before the drift, so the drifted fleet has none
        sims = (StepTimeSimulator(
            fleet_dist, fleet_n, seed=0, slow_workers=slow,
            faults=[FaultEvent(worker=100, start_step=30, end_step=40)]),
                StepTimeSimulator(drift_pool, fleet_n, seed=1,
                                  slow_workers=slow))
        tuner = StragglerTuner(
            ReplicationPlan(n_data=fleet_n, n_batches=fleet_b0), fleet_cfg,
            policy_candidates=bench_pols[1:])
        layout = replica_major_nonoverlapping(fleet_n, fleet_b0)
        for step in range(fleet_steps):
            loads = np.full(fleet_n, fleet_n / tuner.plan.n_batches)
            times = sims[step >= TUNER_FLEET_DRIFT].next_step(loads)
            _, used = completion_from_step_times(times, layout)
            obs, cens = censored_observations(times, layout, used)
            tuner.observe(obs / loads, cens)
            tuner.observe_load(fleet_rate)
            c0, s0 = _build.launch_counts(), dict(SIM.STAGE_SECONDS)
            before = tuner._last_attempt
            fleet_calls.clear()
            rp = tuner.maybe_replan()
            if tuner._last_attempt == before:
                continue
            c1 = _build.launch_counts()
            plan_ = tuner.last_plan
            if fleet_calls:
                fleet_widest[plan_.planner] = max(
                    fleet_calls, key=lambda c: c[0][1].numel())
                fleet_calls.clear()
            attempt = {
                "step": tuner._last_attempt, "planner": plan_.planner,
                "gof_rejected": tuner.last_gof.rejected,
                "gof_statistic": tuner.last_gof.statistic,
                "gof_threshold": tuner.last_gof.threshold,
                "wall_s": tuner.last_replan_seconds,
                "within_budget": tuner.last_replan_seconds
                <= fleet_cfg.replan_time_budget,
                "stages_s": {k: v - s0.get(k, 0.0)
                             for k, v in SIM.STAGE_SECONDS.items()},
                "launches": {k: c1[k] - c0.get(k, 0) for k in c1},
                "old_b": tuner.plan.n_batches, "plan_b": plan_.n_batches,
                "policy": (plan_.policy.kind, plan_.policy.quantile),
                "moved": rp is not None}
            fleet_attempts.append(attempt)
            last_by_planner[plan_.planner] = (plan_.spec, plan_.objective)
            print(f"[tuner_fleet] step {attempt['step']}: "
                  f"{attempt['planner']} (KS {attempt['gof_statistic']:.4f}"
                  f" against {attempt['gof_threshold']:.4f}"
                  f"{', rejected' if attempt['gof_rejected'] else ''}), "
                  f"wall {attempt['wall_s']:.3f} s against the "
                  f"{fleet_cfg.replan_time_budget} s budget, at B "
                  f"{attempt['old_b']} the plan's B {attempt['plan_b']} "
                  f"{'(moved)' if rp is not None else '(no move)'}, policy "
                  f"{attempt['policy']}, launches "
                  f"{ {k: v for k, v in attempt['launches'].items() if v} }, "
                  "stages (host s): " + ", ".join(
                      f"{k} {v:.3f}" for k, v in attempt["stages_s"].items()
                      if v))
            if rp is not None:
                tuner.apply(rp)
                layout = rp.plan.assignment
        return tuner

    orig = capture(SK, "sojourn_cells", fleet_calls)
    try:
        fleet_tuner, fcounts4, fwall4, fstages4 = run_path("tuner_fleet",
                                                           tuner_fleet)
    finally:
        SK.sojourn_cells = orig
    kinds = {a["planner"] for a in fleet_attempts}
    if not {"heterogeneous", "empirical"} <= kinds:
        raise AssertionError(f"tuner_fleet re-planned only through {kinds}")
    want = sum(n_splits if a["planner"] == "heterogeneous" else 1
               for a in fleet_attempts)
    if fcounts4["sojourn_cells"] != want:
        raise AssertionError(f"tuner_fleet launched sojourn_cells "
                             f"{fcounts4['sojourn_cells']} times, want {want}")
    fleet_checks = {
        kind_: hold_widest(f"tuner_fleet last {kind_} re-plan", [call_])
        for kind_, call_ in sorted(fleet_widest.items())}
    del fleet_widest
    report["phases"]["tuner_fleet"] = {
        "wall_s": fwall4, "stages_s": fstages4, "launches": fcounts4,
        "job_rate": fleet_rate, "cells_bytes": cells_bytes,
        "attempts": fleet_attempts, "final_b": fleet_tuner.plan.n_batches,
        "plain_checks": fleet_checks}
    # the last re-plan of each kind again, under the profiler (after 7)
    for kind_, (spec_, obj_) in last_by_planner.items():
        planner_ = make_planner(
            "empirical" if kind_ == "empirical" else "simulate",
            heterogeneous=True, n_trials=fleet_cfg.sim_trials,
            n_resamples=fleet_cfg.bootstrap_resamples, device="cuda")
        deferred_profiles.append((
            "tuner_fleet", f"{kind_}_profile", f"tuner_fleet {kind_} re-plan",
            lambda p_=planner_, s_=spec_, o_=obj_: p_.plan(s_, o_)))
    print(f"[tuner] phase 4c: {time.perf_counter() - t_4c:.1f} s")

    # -- 4d. engine: the replicated serving engine -----------------------
    from repro_torch import core as CORE
    from repro_torch.models import params_to, prefill
    from repro_torch.serving import ReplicatedServingEngine, ServeEngineConfig

    t_4d = time.perf_counter()

    def serving_engine(path, n_groups=16, **kw):
        return ReplicatedServingEngine(ServeEngineConfig(
            **{**engine_kwargs(CORE, path, n_groups), **kw}, device="cuda"))

    def deployment(tag, n_groups, n_requests, pins):
        """The FIFO baseline, then the swept engine (its plan on the card
        under the launch counts, then its event loop); both held to the
        reference's pinned run_load results.  Returns the report and the
        plan's sojourn_cells dispatches."""
        t0 = time.perf_counter()
        fifo = serving_engine("fifo", n_groups).run_load(n_requests)
        fifo_s = time.perf_counter() - t0
        calls: list = []
        orig_ = capture(SK, "sojourn_cells", calls)
        try:
            eng, pcounts, plan_s, _ = run_path(
                tag, lambda: serving_engine("swept", n_groups))
        finally:
            SK.sojourn_cells = orig_
        # one launch a (max_wait, shed) combo, 3 x (none, expired), and
        # under the cap one a (max_wait, split): 3 x the feasible B
        n_splits = len(ClusterSpec(n_workers=n_groups,
                                   dist=sexp).feasible_batches())
        want_launches = 3 * 2 + 3 * n_splits
        if pcounts["sojourn_cells"] != want_launches:
            raise AssertionError(
                f"{tag}'s plan launched sojourn_cells "
                f"{pcounts['sojourn_cells']} times, want {want_launches}")
        t0 = time.perf_counter()
        swept = eng.run_load(n_requests)
        loop_s = time.perf_counter() - t0
        got = {"fifo": engine_summary(fifo), "swept": engine_summary(swept)}
        for c in eng.sc.slo_classes:
            miss = swept["class_stats"][c.name]["miss_rate"]
            print(f"[{tag}] {c.name}: FIFO miss "
                  f"{fifo['class_stats'][c.name]['miss_rate']:.4f} "
                  f"dropped {fifo['class_stats'][c.name]['dropped']}; "
                  f"swept miss {miss:.4f} (target {c.miss_target}) dropped "
                  f"{swept['class_stats'][c.name]['dropped']}")
            if miss > c.miss_target:
                raise AssertionError(f"{tag}: the swept plan misses "
                                     f"{c.name}'s target: {miss}")
        if fifo["class_stats"]["premium"]["miss_rate"] <= 0.05:
            raise AssertionError(f"{tag}: the FIFO baseline holds the "
                                 "premium target")
        if got != pins:
            raise AssertionError(f"{tag} differs from the reference: {got} "
                                 f"against {pins}")
        print(f"[{tag}] {n_groups} groups, {n_requests} requests: plan wall "
              f"{plan_s:.3f} s ({pcounts['sojourn_cells']} sojourn_cells "
              f"launches), event loop {loop_s:.3f} s "
              f"({n_requests / loop_s:.0f} requests/s; FIFO "
              f"{fifo_s:.3f} s); swept B {swept['final_B']}, max_wait "
              f"{swept['max_wait']}, shed {swept['shed']}, policy "
              f"{swept['policy']}, p99 sojourn {swept['p99_sojourn']:.6f} "
              f"(FIFO {fifo['p99_sojourn']:.6f}): the reference's")
        return {"plan_s": plan_s, "loop_s": loop_s, "fifo_s": fifo_s,
                "requests_per_s": n_requests / loop_s, "launches": pcounts,
                "summary": got}, calls

    _phase("engine_multitenant")
    mt_report, _ = deployment("engine_multitenant", 16,
                              ENGINE_REQUESTS["multitenant"],
                              ENGINE_MULTITENANT)
    report["phases"]["engine_multitenant"] = mt_report

    _phase("engine_fleet")
    fleet_report, fleet_engine_calls = deployment(
        "engine_fleet", ENGINE_FLEET_N, ENGINE_REQUESTS["fleet"],
        ENGINE_FLEET)
    fleet_report["plain_check"] = hold_widest("engine_fleet plan",
                                              fleet_engine_calls)
    del fleet_engine_calls
    report["phases"]["engine_fleet"] = fleet_report

    _phase("engine_model")

    def record_call(seen, mod, attr, key=None):
        """Patch the model's ``mod.attr`` to keep (key, args, kw, output)
        of its first call, or, with ``key``, of the first call with the
        largest key(args).  Outputs are cloned (decode updates the scan's
        final state in place), and so are a keyed call's inputs (the
        decode caches are written again by later steps).  Returns the
        original."""
        orig = getattr(mod, attr)

        def copy(ts):
            return tuple(t.clone() if torch.is_tensor(t) else t for t in ts)

        def wrapped(*args, **kw):
            out = orig(*args, **kw)
            k_ = 0 if key is None else key(args)
            if attr not in seen or k_ > seen[attr][0]:
                seen[attr] = (k_, args if key is None else copy(args), kw,
                              copy(out) if isinstance(out, tuple)
                              else out.clone())
            return out

        setattr(mod, attr, wrapped)
        return orig

    def hold_model_calls(tag, seen):
        """Hold each kernel call ``record_call`` kept, its output as the
        path got it, against the plain version on the same inputs:
        attention at ATT_TOL (decode in bf16 within DECODE_BF16_RMS_FRAC of
        the plain output's RMS), ssd_scan at SSD_TOL; time both."""
        plains = {"flash_attention": FA.flash_attention_plain,
                  "decode_attention": DA.decode_attention_plain,
                  "ssd_scan": SSD.ssd_scan_plain}
        kernels = {"flash_attention": FA.flash_attention,
                   "decode_attention": DA.decode_attention,
                   "ssd_scan": SSD.ssd_scan}
        out_ = []
        for name in sorted(seen):
            _, args_, kw_, got = seen[name]
            dname = str(args_[0].dtype).split(".")[1]
            want = plains[name](*args_, **kw_)
            if name == "ssd_scan":
                err, serr, ok = ssd_err(*got, *want, dname)
                extra = {"max_abs_err_state": serr, "tolerance": SSD_TOL}
            else:
                err, rms, ok = att_err(name, got, want, dname)
                extra = {"plain_rms": rms, "tolerance": (
                    {"bfloat16_rms_frac": DECODE_BF16_RMS_FRAC}
                    if name == "decode_attention" and dname == "bfloat16"
                    else ATT_TOL)}
                if name == "decode_attention":
                    extra["cache_len"] = args_[3]
            if not ok:
                raise AssertionError(f"{name} ({tag}) differs from its plain "
                                     f"version: {err} ({extra})")
            e = {"name": name, "case": tag, "dtype": dname,
                 "shape": [list(a.shape) for a in args_ if torch.is_tensor(a)],
                 "max_abs_err": err, **extra,
                 "ms": cuda_ms(lambda: kernels[name](*args_, **kw_), 10),
                 "plain_ms": cuda_ms(lambda: plains[name](*args_, **kw_), 3)}
            print(f"[{tag}] {name} {e['shape']} {dname} as the path ran it: "
                  f"within tolerance of the plain version (max err "
                  f"{err:.3e}; kernel {e['ms']:.4f} ms, plain "
                  f"{e['plain_ms']:.4f} ms)")
            out_.append(e)
        plain_checks.extend(out_)
        return out_

    def model_path(path, want_replans):
        """Serve on the card with real prefill and decode; check the
        tokens, the launch counts the path implies, the path's first
        prefill attention and scan and its longest decode attention against
        the plain versions, and the first batch's prefill logits against
        the same batch on the CPU."""
        eng = serving_engine(path)
        cfg_ = eng.cfg
        log = replan_log(eng) if eng.sc.tuner else []
        model_s = [0.0]
        orig_gen = eng._generate_for_job

        def timed_gen(job):
            t0 = time.perf_counter()
            orig_gen(job)
            model_s[0] += time.perf_counter() - t0
        eng._generate_for_job = timed_gen
        n_req = ENGINE_REQUESTS[path]
        seen: dict = {}
        origs = [(ATTN_MODEL, "flash_attention", record_call(
                     seen, ATTN_MODEL, "flash_attention")),
                 (ATTN_MODEL, "decode_attention", record_call(
                     seen, ATTN_MODEL, "decode_attention", lambda a: a[3])),
                 (SSM_MODEL, "ssd_scan", record_call(
                     seen, SSM_MODEL, "ssd_scan"))]
        try:
            out, counts, wall, _ = run_path(f"engine_{path}",
                                            lambda: eng.run_load(n_req))
        finally:
            for mod, attr, orig in origs:
                setattr(mod, attr, orig)
        jobs = eng.last_master.completed_jobs
        served = [s for s in out["stats"] if not s.dropped]
        if len(served) != n_req or not all(
                s.tokens.shape == (eng.sc.gen_tokens,)
                and ((s.tokens >= 0) & (s.tokens < cfg_.vocab_size)).all()
                for s in served):
            raise AssertionError(f"engine_{path}: a served request lacks "
                                 "its tokens")
        if cfg_.family == "hybrid":
            n_attn = segment_layout(cfg_)[0]
            want = {"ssd_scan": len(jobs) * cfg_.n_layers}
        else:
            n_attn, want = cfg_.n_layers, {}
        want.update({
            "flash_attention": len(jobs) * n_attn,
            "decode_attention": len(jobs) * (eng.sc.gen_tokens - 1) * n_attn,
            "sojourn_cells": len(log)})
        for k, n in want.items():
            if counts[k] != n:
                raise AssertionError(f"engine_{path} launched {k} "
                                     f"{counts[k]} times, want {n}")
        if want_replans and not log:
            raise AssertionError(f"engine_{path} never re-planned")
        held = hold_model_calls(f"engine_{path}", seen)
        if {e["name"] for e in held} != {k for k in want
                                         if k != "sojourn_cells"}:
            raise AssertionError(f"engine_{path} held {sorted(seen)}, not "
                                 "every model kernel of the path")
        del seen
        # the first completed batch's prefill, card against CPU
        prompts = eng._prompts([r.request_id for r in jobs[0].requests])
        logits_c, _ = prefill(cfg_, eng.params, {"tokens": prompts},
                              eng.sc.max_len)
        logits_h, _ = prefill(cfg_, params_to(eng.params, "cpu"),
                              {"tokens": prompts.cpu()}, eng.sc.max_len)
        err = (logits_c.float().cpu() - logits_h.float()).abs().max().item()
        if not err <= LOGIT_TOL:
            raise AssertionError(f"engine_{path}: the first batch's prefill "
                                 f"logits differ from the CPU's by {err}")
        replan_s = sum(a[1] for a in log)
        print(f"[engine_{path}] {cfg_.name}, {n_req} requests in "
              f"{len(jobs)} batches: wall {wall:.3f} s, model "
              f"{model_s[0]:.3f} s ({model_s[0] / wall:.1%} of the wall), "
              f"{len(log)} re-plans in {replan_s:.3f} s; launches "
              f"{ {k: counts[k] for k in want} } = the path's "
              f"{ {k: n for k, n in want.items()} } (prefill: batches x "
              f"{n_attn} attention layers; decode: batches x "
              f"{eng.sc.gen_tokens - 1} steps x {n_attn}, one launch a "
              f"step and layer); first batch's prefill logits within "
              f"{err:.5f} of the CPU's (tolerance {LOGIT_TOL})")
        return eng, out, log, {
            "wall_s": wall, "model_s": model_s[0],
            "model_share": model_s[0] / wall, "replans": len(log),
            "replan_s": replan_s, "batches": len(jobs), "launches": counts,
            "prefill_logit_err": err, "p99_sojourn": out["p99_sojourn"],
            "plain_checks": held,
            "attempts": [list(attempt_summary(a)) for a in log]}

    from repro_torch.models.zamba import segment_layout

    eng_m, out_m, log_m, model_report = model_path("model", True)
    decided = model_decision(out_m, eng_m, log_m)
    if decided != ENGINE_MODEL:
        raise AssertionError(f"engine_model decided {decided}, the "
                             f"reference {ENGINE_MODEL}")
    print(f"[engine_model] the reference's decision: {decided}")
    model_report["decision"] = decided
    del eng_m
    _, out_h, _, hybrid_engine_report = model_path("hybrid", False)
    # the hybrid schedule is the model-free engine's on the CPU
    cpu_h = ReplicatedServingEngine(ServeEngineConfig(
        **{**engine_kwargs(CORE, "hybrid"), "execute_model": False},
        device="cpu")).run_load(ENGINE_REQUESTS["hybrid"])
    if ([(s.arrival, s.dispatched, s.completion) for s in out_h["stats"]]
            != [(s.arrival, s.dispatched, s.completion)
                for s in cpu_h["stats"]]):
        raise AssertionError("engine_hybrid's schedule differs from the "
                             "model-free engine's on the CPU")
    print("[engine_hybrid] schedule == the model-free engine's on the CPU")
    report["phases"]["engine_model"] = {"model": model_report,
                                        "hybrid": hybrid_engine_report}
    print(f"[engine] phase 4d: {time.perf_counter() - t_4d:.1f} s")

    # -- 4e. cluster: the distributed control plane and cluster runtime --
    import socket

    import torch.distributed as dist

    from repro_torch.cluster import (ChaosEvent, ChaosInjector,
                                     ClusterConfig, LocalCluster, drive,
                                     make_deterministic_spec,
                                     make_matmul_spec, make_sleep_spec)
    from repro_torch.core.replication import (aggregate_gradients,
                                              make_rdp_mesh)
    from repro_torch.core.simulator import (simulate_coverage,
                                            simulate_coverage_reference)
    from repro_torch.distributed import (FaultManager, RescaleExecutor,
                                         RuntimeTopology,
                                         hierarchical_allreduce,
                                         replication_aware_pmean)
    from repro_torch.serving.queueing import Request

    t_4e = time.perf_counter()
    cluster_report: dict = {}

    _phase("fault_fleet")
    ff_dist = ShiftedExponential(0.05, 2.0)
    ff_rates = fault_fleet_rates(np)

    def fault_recovery():
        fm = FaultManager(ReplicationPlan(FAULT_FLEET_N, FAULT_FLEET_B0),
                          heartbeat_misses_fatal=1, device="cuda")
        for w in FAULT_FLEET_DEAD:
            fm.mark_dead(w)
        decision = fm.decide()
        return fm, decision, fm.plan_recovery(ff_dist, rates=ff_rates,
                                              metric="p99")

    def fault_shrink():
        ex = RescaleExecutor(RuntimeTopology(
            ReplicationPlan(FAULT_FLEET_N, FAULT_FLEET_B0), 0),
            device="cuda")
        return ex.shrink(FAULT_FLEET_SLOW, dist=ff_dist, rates=ff_rates,
                         metric="mean")

    (ff_fm, ff_dec, ff_plan), ff_counts, ff_wall, ff_stages = run_path(
        "fault_fleet recovery", fault_recovery)
    got_dec = (ff_dec.kind, ff_dec.lost_batches, int(ff_dec.alive.sum()))
    got_rec = (ff_plan.n_workers, ff_plan.n_batches,
               assignment_hash(ff_plan.assignment.worker_batch),
               ff_plan.predicted.p99)
    if (got_dec != FAULT_FLEET["decide"] or got_rec != FAULT_FLEET["recovery"]
            or ff_plan.planner != "heterogeneous"
            or ff_plan.backend != "cuda"):
        raise AssertionError(f"fault_fleet recovery decided {got_dec}, "
                             f"{got_rec} ({ff_plan.planner} on "
                             f"{ff_plan.backend}); the reference "
                             f"{FAULT_FLEET['decide']}, "
                             f"{FAULT_FLEET['recovery']}")
    print(f"[fault_fleet] decide() {got_dec}; plan_recovery(p99) of "
          f"{ff_plan.n_workers} survivors: B {ff_plan.n_batches}, map "
          f"{got_rec[2]}, predicted p99 {ff_plan.predicted.p99!r}: the "
          "reference's")
    # the recovery's coverage samples at the chosen B against the host
    # walk, on the same draws (made on the card)
    surv = tuple(float(r) for r in ff_rates[ff_dec.alive])
    cov_k = simulate_coverage(ff_dist, ff_plan.assignment,
                              n_trials=FAULT_FLEET_CHECK_TRIALS, rates=surv,
                              device="cuda")
    t0 = time.perf_counter()
    cov_p = simulate_coverage_reference(
        ff_dist, ff_plan.assignment, n_trials=FAULT_FLEET_CHECK_TRIALS,
        rates=surv, device="cuda")
    cov_walk_s = time.perf_counter() - t0
    if not np.array_equal(cov_k.samples, cov_p.samples):
        raise AssertionError("fault_fleet: the card's coverage samples "
                             "differ from the host walk's")
    print(f"[fault_fleet] coverage rule at B {ff_plan.n_batches}: the "
          f"card's first {FAULT_FLEET_CHECK_TRIALS} trials bit-equal to the "
          f"host walk ({cov_walk_s:.2f} s)")
    ff_shrink, fs_counts, fs_wall, fs_stages = run_path(
        "fault_fleet shrink", fault_shrink)
    got_shrink = (ff_shrink.plan.n_data, ff_shrink.plan.n_batches,
                  assignment_hash(ff_shrink.assignment.worker_batch),
                  ff_shrink.dropped_workers)
    if got_shrink != FAULT_FLEET["shrink"]:
        raise AssertionError(f"fault_fleet shrink made {got_shrink}, the "
                             f"reference {FAULT_FLEET['shrink']}")
    print(f"[fault_fleet] shrink({FAULT_FLEET_SLOW}) under mean: "
          f"{ff_shrink.plan}, map {got_shrink[2]}, dropped the "
          f"{len(got_shrink[3])} slow workers: the reference's")
    # the rate-aware recovery under a plain metric is the coverage rule
    # (float64 torch ops on the card), not a sojourn scan: count, do not
    # assume, the hand kernels' launches
    print(f"[fault_fleet] hand-kernel launches: recovery {ff_counts}, "
          f"shrink {fs_counts}")
    cluster_report["fault_fleet"] = {
        "recovery_wall_s": ff_wall, "recovery_stages_s": ff_stages,
        "recovery_launches": ff_counts, "decide": list(got_dec),
        "recovery": list(got_rec), "coverage_check_trials":
        FAULT_FLEET_CHECK_TRIALS, "coverage_walk_s": cov_walk_s,
        "shrink_wall_s": fs_wall, "shrink_stages_s": fs_stages,
        "shrink_launches": fs_counts, "shrink": [*got_shrink[:3],
                                                 list(got_shrink[3])]}
    del ff_fm

    def cluster_serve(cfg, n_requests, interarrival, *, slowdowns=None,
                      events=None, timeout=120.0):
        """benchmarks/bench_cluster.py's _serve through the port's
        LocalCluster; returns (summary, coordinator, wall s)."""
        t0 = time.perf_counter()
        with LocalCluster(cfg, slowdowns=slowdowns or {}) as cluster:
            coord = cluster.coordinator
            base = coord.now()
            for i in range(n_requests):
                coord.submit(Request(request_id=i,
                                     arrival=base + (i + 1) * interarrival))
            drive(cluster, ChaosInjector(
                cluster, events(base) if events is not None else []),
                timeout=timeout)
            return coord.summary(), coord, time.perf_counter() - t0

    def live_row(tag, *args, **kw):
        """One cluster run as a path of the main path: its summary, the
        coordinator's hand-kernel launches (the device warm-up's apart),
        printed and kept."""
        (s, coord, wall), counts, _, stages = run_path(
            tag, lambda: cluster_serve(*args, **kw))
        served_by = {k: counts[k] - coord.warmup_launches.get(k, 0)
                     for k in counts}
        print(f"[{tag}] {s['served']}/{s['requests']} served in {wall:.2f} "
              f"s: sojourn mean {s['mean_sojourn'] * 1e3:.2f} ms, p50 "
              f"{s['p50_sojourn'] * 1e3:.2f} ms, p99 "
              f"{s['p99_sojourn'] * 1e3:.2f} ms; final B {s['final_B']}, "
              f"generation {s['generation']}, deaths {s['deaths']}, "
              f"rejoins {s['rejoins']}, redispatches {s['redispatches']}, "
              f"stale {s['stale_results']}, clones {s['clones']}, replans "
              f"{s['replans']}; launches {counts} (warm-up "
              f"{coord.warmup_launches})")
        cluster_report[tag] = {"summary": s, "wall_s": wall,
                               "stages_s": stages, "launches": counts,
                               "warmup_launches": coord.warmup_launches,
                               "launches_after_warmup": served_by}
        return s, coord, served_by

    _phase("cluster_live")
    s, _, _ = live_row("cluster_dispatch_smoke", ClusterConfig(
        n_workers=2, n_batches=1, batch_size=1, max_wait=0.01,
        payload=make_deterministic_spec(0.02), device="cuda"), 20, 0.025)
    if s["served"] != 20:
        raise AssertionError(f"cluster_dispatch_smoke: {s}")
    # bench_cluster.py's straggler row: 8 workers at u~0.5, worker 0
    # slowed 8x; r=1 baseline against the clone policy on the same fleet
    common = dict(n_workers=8, n_batches=8, batch_size=1, max_wait=0.01,
                  payload=make_sleep_spec("sexp", work=1.0, delta=0.02,
                                          mu=50.0),
                  heartbeat_timeout=0.5, seed=17, device="cuda")
    s_base, _, _ = live_row("cluster_straggler_baseline",
                            ClusterConfig(**common), 200, 0.01,
                            slowdowns={0: 8.0})
    s_pol, _, _ = live_row("cluster_straggler_policy", ClusterConfig(
        **common, policy=PolicyCandidate(kind="clone", quantile=0.85),
        clone_budget=2, min_policy_observations=8), 200, 0.01,
        slowdowns={0: 8.0})
    if not (s_base["served"] == s_pol["served"] == 200
            and s_pol["clones"] >= 1
            and s_pol["p99_sojourn"] < s_base["p99_sojourn"]):
        raise AssertionError(f"cluster_straggler_policy: {s_pol} against "
                             f"the baseline {s_base}")
    # the tuner row, with the bench's analytic planner and then with the
    # config's default simulate planner (sojourn_cells on the live path)
    tuner_common = dict(n_workers=8, n_batches=8, batch_size=1,
                        max_wait=0.01,
                        payload=make_sleep_spec("exp", work=1.0, mu=25.0),
                        metric="p99", tuner=True, min_samples=40,
                        cooldown=10, seed=3, device="cuda")
    live_calls: list = []
    tuner_rows = {}
    for mode in ("analytic", "simulate"):
        tag = f"cluster_tuner_{mode}"
        live_calls.clear()
        # each re-plan attempt's wall inside the coordinator's event loop,
        # against the heartbeat timeout it must stay under
        attempt_walls: list = []
        orig_replan = StragglerTuner.maybe_replan

        def timed_replan(self, _orig=orig_replan, _walls=attempt_walls):
            before, t0 = self._last_attempt, time.perf_counter()
            out = _orig(self)
            if self._last_attempt != before:
                _walls.append(time.perf_counter() - t0)
            return out

        StragglerTuner.maybe_replan = timed_replan
        orig = capture(SK, "sojourn_cells", live_calls)
        try:
            s_t, coord_t, served_by = live_row(
                tag, ClusterConfig(**tuner_common, planner_mode=mode), 120,
                0.015)
        finally:
            SK.sojourn_cells = orig
            StragglerTuner.maybe_replan = orig_replan
        fit = coord_t.tuner.last_fit
        if not (s_t["served"] == 120 and fit is not None
                and s_t["replans"] >= 1 and s_t["final_B"] < 8):
            raise AssertionError(f"{tag}: {s_t}")
        print(f"[{tag}] fit {type(fit.dist).__name__}(mu={fit.dist.mu:.2f})"
              f", censored {fit.n_censored}/{fit.n_samples}; "
              f"B 8 -> {s_t['final_B']}; {len(attempt_walls)} re-plan "
              f"attempts in the event loop, {sum(attempt_walls):.4f} s in "
              f"all, the longest {max(attempt_walls, default=0.0):.4f} s "
              f"(heartbeat timeout {coord_t.config.heartbeat_timeout} s)")
        cluster_report[tag]["replan_attempt_walls_s"] = attempt_walls
        tuner_rows[mode] = served_by
    if tuner_rows["simulate"]["sojourn_cells"] < 1:
        raise AssertionError("cluster_tuner_simulate's re-plans launched no "
                             "sojourn_cells")
    cluster_report["cluster_tuner_simulate"]["plain_check"] = hold_widest(
        "cluster_tuner_simulate re-plan", live_calls)
    del live_calls
    s_k, _, _ = live_row("cluster_kill_recovery", ClusterConfig(
        n_workers=4, n_batches=4, batch_size=1, max_wait=0.01,
        payload=make_sleep_spec("sexp", work=1.0, delta=0.02, mu=50.0),
        heartbeat_timeout=0.4, seed=5, device="cuda"), 80, 0.02,
        events=lambda base: [ChaosEvent(at=base + 0.4, kind="kill",
                                        worker=1)])
    if not (s_k["served"] == 80 and s_k["deaths"] == 1
            and s_k["generation"] >= 1):
        raise AssertionError(f"cluster_kill_recovery: {s_k}")

    _phase("cluster_matmul")
    # the first matmul initialises each worker's CUDA context, which holds
    # the interpreter lock (and so the heartbeat thread) for about a second;
    # and a matmul worker imports torch before it registers, which took
    # over the default 15 s on a shared host's loaded cores
    mm_cfg = ClusterConfig(
        n_workers=2, n_batches=2, batch_size=1, max_wait=0.01,
        payload=make_matmul_spec(size=2048, repeats=4),
        heartbeat_timeout=5.0, register_timeout=60.0, device="cuda")
    (s_m, coord_m, mm_wall), mm_counts, _, _ = run_path(
        "cluster_matmul", lambda: cluster_serve(mm_cfg, 20, 0.05))
    worker_devices = {w: h.device for w, h in coord_m.workers.items()}
    elapsed = [job.attempts[-1].reported[job.winner_worker]
               for job in sorted(coord_m.completed_jobs,
                                 key=lambda j: j.job_id)]
    if not (s_m["served"] == 20 and worker_devices
            and all(str(d).startswith("cuda") for d in
                    worker_devices.values())):
        raise AssertionError(f"cluster_matmul: {s_m}, worker devices "
                             f"{worker_devices}")
    print(f"[cluster_matmul] 2 workers, 20 requests of 4 (2048 x 2048) "
          f"matmuls in {mm_wall:.2f} s; worker devices {worker_devices}; "
          f"per-request elapsed (s) {[round(e, 4) for e in elapsed]}; "
          f"deaths {s_m['deaths']}")
    cluster_report["cluster_matmul"] = {
        "summary": s_m, "wall_s": mm_wall, "launches": mm_counts,
        "worker_devices": worker_devices, "elapsed_s": elapsed}

    _phase("collectives")
    # one H100 holds one NCCL rank: a one-rank group, where each
    # aggregation must return its input's mean (the input itself); the
    # semantics across ranks are held on CPU gloo in the tests
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        free_port = probe.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port}", rank=0, world_size=1)
    try:
        mesh = make_rdp_mesh(ReplicationPlan(1, 1), 1)
        gen = torch.Generator(device="cuda").manual_seed(5)
        tree = {"w": torch.randn((1024, 1024), generator=gen, device=dev),
                "b": [torch.randn(4097, generator=gen, device=dev)]}
        outs = {f"aggregate_gradients {m}": aggregate_gradients(
            tree, 1.0, m, mesh=mesh)[0]
            for m in ("psum_all", "hierarchical", "weighted")}
        batch_group = mesh.get_group("batch")
        outs["replication_aware_pmean"] = replication_aware_pmean(
            tree, batch_group)
        outs["hierarchical_allreduce"] = hierarchical_allreduce(
            tree, batch_group)
        torch.cuda.synchronize()
        errs = {k: max((o["w"] - tree["w"]).abs().max().item(),
                       (o["b"][0] - tree["b"][0]).abs().max().item())
                for k, o in outs.items()}
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if backend != "nccl" or any(e != 0.0 for e in errs.values()):
        raise AssertionError(f"one-rank {backend} collectives differ from "
                             f"their input's mean: {errs}")
    print(f"[collectives] one-rank NCCL group on the card: every mode "
          f"returns its input's mean exactly: {errs}")
    cluster_report["collectives"] = {"backend": backend, "max_abs_err": errs}
    cluster_report["wall_s"] = time.perf_counter() - t_4e
    report["phases"]["cluster"] = cluster_report
    print(f"[cluster] phase 4e: {cluster_report['wall_s']:.1f} s")

    # -- 5. serve and 6. serve_hybrid -------------------------------------
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeConfig, generate, run_serving
    from repro_torch.models import (count_params, decode_step,
                                    init_decode_state, init_params,
                                    params_to, prefill)

    def serve_cell(tag, cfg, params, prompts, n_new, max_len, want,
                   prefill_shares=None, patch_embeds=None,
                   held=("flash_attention", "decode_attention"),
                   profile_steps=None):
        """Greedy generation at full width: three runs (the first with the
        launch counts at 0, which must equal ``want``), rates, peak memory
        and each part's idle share under the profiler against its own
        fastest unprofiled run (``profile_steps`` decode steps profiled, all
        of them by default); ``prefill_shares`` as ``print_busy``'s
        ``shares``, for the prefill.  The counted run's first flash call
        and longest decode call, as it made them, are held against the
        plain versions (``hold_model_calls``; ``held`` names the kernels
        the path runs).  vlm: ``patch_embeds`` sit ahead of the prompt."""
        batch, plen = prompts.shape
        offset = cfg.n_patches if patch_embeds is not None else 0
        pbatch = {"tokens": prompts}
        if patch_embeds is not None:
            pbatch["patch_embeds"] = patch_embeds
        print(f"[{tag}] {cfg.name}: {count_params(params):,} parameters in "
              f"bf16 on the card ({cfg.n_layers} layers, d {cfg.d_model}, "
              f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV of "
              f"{cfg.head_dim}); batch {batch}, prompt {plen}"
              + (f" behind {offset} patch slots" if offset else "")
              + f", {n_new} new tokens, max_len {max_len}")
        # warm-up at a small size: loads the kernels and cuBLAS's handles
        generate(cfg, params, prompts[:, :64], 2, offset + 128, patch_embeds)
        torch.cuda.reset_peak_memory_stats()

        def serve():
            return generate(cfg, params, prompts, n_new, max_len,
                            patch_embeds)

        seen: dict = {}
        origs = [(ATTN_MODEL, "flash_attention", record_call(
                     seen, ATTN_MODEL, "flash_attention")),
                 (ATTN_MODEL, "decode_attention", record_call(
                     seen, ATTN_MODEL, "decode_attention", lambda a: a[3]))]
        try:
            gen, counts, wall, _ = run_path(tag, serve)
        finally:
            for mod, attr, orig in origs:
                setattr(mod, attr, orig)
        for k, n in want.items():
            if counts[k] != n:
                raise AssertionError(f"{tag} launched {k} {counts[k]} times, "
                                     f"expected {n}")
        toks = gen.tokens
        if toks.shape != (batch, n_new) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
        runs = [gen] + [serve() for _ in range(2)]
        by_total = sorted(runs, key=lambda g: g.prefill_s + g.decode_s)
        best, median = by_total[0], by_total[len(runs) // 2]
        if not all(torch.equal(g.tokens, toks) for g in runs):
            raise AssertionError("greedy generation is not deterministic")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # after the peak is read: the plain versions hold full score rows
        held_calls = hold_model_calls(tag, seen)
        if {e["name"] for e in held_calls} != set(held):
            raise AssertionError(f"{tag} held {sorted(seen)}, not "
                                 f"{sorted(held)}")
        del seen

        def rates(g):
            return {"prefill_s": g.prefill_s,
                    "decode_s_per_token": g.decode_s / (n_new - 1),
                    "prefill_tokens_per_s": batch * plen / g.prefill_s,
                    "decode_tokens_per_s": batch * (n_new - 1) / g.decode_s,
                    "new_tokens_per_s": batch * n_new
                    / (g.prefill_s + g.decode_s)}

        best_rates = rates(best)
        print(f"[{tag}] runs (prefill s, decode s): "
              f"{[(g.prefill_s, g.decode_s) for g in runs]}; median run "
              f"{rates(median)}")
        print(f"[{tag}] best: prefill {best.prefill_s:.5f} s, decode "
              f"{best_rates['decode_s_per_token'] * 1e3:.3f} ms per step, "
              f"{best_rates['decode_tokens_per_s']:.1f} decode tokens/s, "
              f"{best_rates['new_tokens_per_s']:.1f} new tokens/s end to "
              f"end; peak {peak_gb:.2f} GB; launches "
              + ", ".join(f"{k} {counts[k]}" for k in want))
        print(f"[{tag}] tokens[0, :8] = {toks[0, :8].tolist()}")

        # idle share of prefill and of the decode loop, each under the
        # profiler
        n_prof = n_new - 1 if profile_steps is None else profile_steps

        def decode_loop():
            logits, state = prefill_state
            tok = logits[:, -1].argmax(-1, keepdim=True)
            for i in range(n_prof):
                logits, state = decode_step(cfg, params, state, tok,
                                            offset + plen + i)
                tok = logits[:, -1].argmax(-1, keepdim=True)

        busy_prefill = print_busy(f"{tag} prefill", *busy_window(
            lambda: prefill(cfg, params, pbatch, max_len)),
            top=10, shares=prefill_shares)
        prefill_state = prefill(cfg, params, pbatch, max_len)
        busy_decode = print_busy(f"{tag} decode ({n_prof} steps)",
                                 *busy_window(decode_loop), top=10)
        del prefill_state
        for part, busy, unprofiled in (
                ("prefill", busy_prefill, min(g.prefill_s for g in runs)),
                ("decode", busy_decode, min(g.decode_s for g in runs)
                 * n_prof / (n_new - 1))):
            if busy["device_busy_s"] is None:
                raise AssertionError(f"the profiler saw no device work in "
                                     f"{tag} {part}")
            idle = 1.0 - busy["device_busy_s"] / unprofiled
            busy["idle_share_of_unprofiled_wall"] = idle
            flag = ("" if idle >= 0 else " (NEGATIVE: the profiled busy time "
                    "exceeds the unprofiled wall; the two runs disagree)")
            print(f"[{tag} {part}] device busy {busy['device_busy_s']:.5f} s "
                  f"against the fastest unprofiled {unprofiled:.5f} s: idle "
                  f"share {idle:.4f}{flag}")
        return {"wall_s": wall, "launches": counts,
                "runs": [[g.prefill_s, g.decode_s] for g in runs],
                **best_rates, "median_run": rates(median),
                "peak_memory_gb": peak_gb, "busy_prefill": busy_prefill,
                "busy_decode": busy_decode, "plain_checks": held_calls}

    def as_float32(tree):
        if isinstance(tree, dict):
            return {k: as_float32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [as_float32(v) for v in tree]
        return tree.float()

    def card_vs_cpu(tag, small, batch, plen, steps, float32=False):
        """The same weights (drawn on the card, copied to the host: the
        host's generator takes most of a minute for command-r's 6.3 G
        parameters) on the card and on the CPU: logits within LOGIT_TOL at
        prefill and each decode step, and the same greedy token wherever
        the CPU's top-2 margin exceeds that.  vlm: behind seeded patch
        embeddings.  ``float32``: the weights, and so the activations, in
        float32 on both."""
        t0 = time.perf_counter()
        on_card = init_params(torch.Generator(device="cuda").manual_seed(2),
                              small, dev)
        if float32:
            on_card = as_float32(on_card)
        host = params_to(on_card, "cpu")
        t_init = time.perf_counter() - t0
        cgen = torch.Generator().manual_seed(3)
        ctoks = torch.randint(0, small.vocab_size, (batch, plen),
                              generator=cgen)
        cbatch = {"tokens": ctoks}
        offset = 0
        if small.family == "vlm":
            cbatch["patch_embeds"] = torch.randn(
                (batch, small.n_patches, small.frontend_dim), generator=cgen)
            offset = small.n_patches
        max_len = offset + plen + steps
        lh, sh = prefill(small, host, cbatch, max_len)
        lc, sc = prefill(small, on_card, cbatch, max_len)
        logit_errs, decided, agreed = [], 0, 0
        for i in range(steps + 1):
            err = (lc.float().cpu() - lh.float()).abs().max().item()
            logit_errs.append(err)
            if not err <= LOGIT_TOL:
                raise AssertionError(f"card and CPU logits differ by {err} "
                                     f"at step {i} (tolerance {LOGIT_TOL})")
            top2 = lh[:, -1].float().topk(2).values
            sure = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
            tok_h = lh[:, -1].argmax(-1)
            tok_c = lc[:, -1].argmax(-1).cpu()
            decided += int(sure.sum())
            agreed += int((tok_h == tok_c)[sure].sum())
            if not torch.equal(tok_h[sure], tok_c[sure]):
                raise AssertionError(f"greedy tokens differ at step {i} "
                                     f"where the CPU's top-2 margin exceeds "
                                     f"{LOGIT_TOL}")
            if i < steps:  # both fed the CPU's greedy token
                lh, sh = decode_step(small, host, sh, tok_h[:, None],
                                     offset + plen + i)
                lc, sc = decode_step(small, on_card, sc,
                                     tok_h[:, None].to(dev),
                                     offset + plen + i)
        print(f"[{tag}] card vs CPU ({small.n_layers} layers, prompt {plen}, "
              f"{steps} decode steps): max |logit diff| per step "
              f"{[round(e, 5) for e in logit_errs]} (tolerance {LOGIT_TOL}); "
              f"greedy tokens agree at {agreed}/{decided} positions whose "
              f"CPU top-2 margin exceeds it; {time.perf_counter() - t0:.1f} "
              f"s, {t_init:.1f} of it drawing the weights and copying them "
              f"to the host")
        return {"card_vs_cpu_logit_err": logit_errs, "tokens_decided": decided,
                "tokens_agreed": agreed}

    def serve_fleet(tag, sc, kernels):
        """``run_serving`` on the card (reduced model + fleet planner)."""
        out, fcounts, fwall, _ = run_path(tag, lambda: run_serving(sc))
        for k in kernels:
            if fcounts[k] <= 0:
                raise AssertionError(f"run_serving({sc.arch}) never launched "
                                     f"{k}")
        if out["backend"] != "cuda" or out["generated"].shape != (
                sc.batch, sc.gen_tokens):
            raise AssertionError(f"bad run_serving result {out['backend']}")
        print(f"[{tag}] B*={out['sojourn_best_B']} policy={out['policy']} "
              f"p99={out['speculative_p99']:.6f}; latency_by_B "
              f"{ {b: round(v['p99'], 6) for b, v in out['latency_by_B'].items()} }")
        return {"fleet_wall_s": fwall, "fleet_launches": fcounts,
                "fleet_plan": [out["sojourn_best_B"], repr(out["policy"]),
                               out["speculative_p99"]]}

    _phase("serve")
    cfg = get_config("qwen2-0.5b")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device=dev,
        generator=torch.Generator(device="cuda").manual_seed(1))
    serve_report = serve_cell(
        "serve", cfg, params, prompts, SERVE_NEW, SERVE_MAX_LEN,
        {"flash_attention": cfg.n_layers,
         "decode_attention": cfg.n_layers * (SERVE_NEW - 1)})
    serve_report.update(card_vs_cpu(
        "serve", dataclasses.replace(cfg, n_layers=CHECK_LAYERS), CHECK_BATCH,
        CHECK_PROMPT, CHECK_STEPS))
    serve_report.update(serve_fleet(
        "serve_fleet", ServeConfig(),
        ("flash_attention", "decode_attention", "sojourn_cells")))
    report["phases"]["serve"] = serve_report
    del params

    _phase("serve_hybrid")
    from repro_torch.models.zamba import segment_layout

    hcfg = get_config("zamba2-7b")
    n_seg, _, _ = segment_layout(hcfg)
    hparams = init_params(torch.Generator(device="cuda").manual_seed(0), hcfg,
                          dev)
    hprompts = torch.randint(
        0, hcfg.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT), device=dev,
        generator=torch.Generator(device="cuda").manual_seed(1))
    ssd_shapes: list = []  # (x shape, b shape) of each call; no tensors
    o_ssd = SSM_MODEL.ssd_scan

    def ssd_shape_probe(x, dt, a_log, b, *args, **kw):
        ssd_shapes.append((tuple(x.shape), tuple(b.shape)))
        return o_ssd(x, dt, a_log, b, *args, **kw)

    SSM_MODEL.ssd_scan = ssd_shape_probe
    try:
        hybrid_report = serve_cell(
            "serve_hybrid", hcfg, hparams, hprompts, HYBRID_NEW,
            HYBRID_MAX_LEN,
            {"ssd_scan": hcfg.n_layers, "flash_attention": n_seg,
             "decode_attention": n_seg * (HYBRID_NEW - 1)},
            prefill_shares={"ssd_scan": SSD_BF16_KERNEL,
                            "elementwise": "elementwise_kernel"})
    finally:
        SSM_MODEL.ssd_scan = o_ssd
    ssd_share = hybrid_report["busy_prefill"]["shares"]["ssd_scan"]
    if ssd_share["events"] == 0:
        raise AssertionError(f"the profiled bf16 prefill ran no "
                             f"{SSD_BF16_KERNEL}")
    del hparams
    hybrid_report.update(card_vs_cpu(
        "serve_hybrid", dataclasses.replace(hcfg, n_layers=HCHECK_LAYERS),
        CHECK_BATCH, HCHECK_PROMPT, CHECK_STEPS))
    hybrid_report.update(serve_fleet(
        "serve_hybrid_fleet", ServeConfig(arch="zamba2-7b"),
        ("ssd_scan", "flash_attention", "decode_attention", "sojourn_cells")))
    report["phases"]["serve_hybrid"] = hybrid_report

    # -- 6a. the head-dim-128 dense configs at full width -----------------
    t_dense = time.perf_counter()
    dense_cfgs = {}  # arch -> the config served (its depth cut)
    for arch, tag, depth in DENSE_SERVE:
        _phase(tag)
        dcfg = dataclasses.replace(get_config(arch), n_layers=depth)
        dense_cfgs[arch] = dcfg
        dparams = init_params(torch.Generator(device="cuda").manual_seed(0),
                              dcfg, dev)
        dprompts = torch.randint(
            0, dcfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device=dev,
            generator=torch.Generator(device="cuda").manual_seed(1))
        dense_report = serve_cell(
            tag, dcfg, dparams, dprompts, SERVE_NEW, SERVE_MAX_LEN,
            {"flash_attention": dcfg.n_layers,
             "decode_attention": dcfg.n_layers * (SERVE_NEW - 1)})
        dense_report["layers_served"] = depth
        dense_report["layers_published"] = get_config(arch).n_layers
        del dparams, dprompts
        torch.cuda.empty_cache()
        dense_report.update(card_vs_cpu(
            tag, dataclasses.replace(dcfg, n_layers=CHECK_LAYERS),
            CHECK_BATCH, DCHECK_PROMPT, CHECK_STEPS))
        report["phases"][tag] = dense_report
        torch.cuda.empty_cache()
    print(f"[serve_dense] phase 6a: {time.perf_counter() - t_dense:.1f} s")

    # -- 6d. the MoE, VLM, audio and xLSTM families at full width ---------
    t_fam = time.perf_counter()
    from repro_torch.models import moe as MOE_MODEL
    from repro_torch.models import whisper as WHISPER

    held_gb = torch.cuda.memory_allocated() / 1e9
    print(f"[serve_families] phase 6d starts with {held_gb:.2f} GB "
          f"allocated on the card")
    report["phases"]["serve_families_start_gb"] = held_gb
    family_cfgs = {}  # tag -> the config served (its depth cut)

    def moe_routing(fn):
        """Run ``fn`` with the card routed to the CPU's experts
        (``routed_to_cpu``), counting the assignments each side dropped
        past capacity.  Returns (fn's result, the CPU's margin at each
        routing flip, the (token, layer) sets compared, {device type:
        assignments dropped})."""
        dropped = {"cpu": 0, "cuda": 0}
        o_route, o_dispatch = MOE_MODEL.route, MOE_MODEL.dispatch
        route, state = routed_to_cpu(o_route)

        def dispatch(moe, gate_e, cap):
            out = o_dispatch(moe, gate_e, cap)
            dropped[gate_e.device.type] += int((~out[4]).sum())
            return out

        MOE_MODEL.route, MOE_MODEL.dispatch = route, dispatch
        try:
            res = fn()
        finally:
            MOE_MODEL.route, MOE_MODEL.dispatch = o_route, o_dispatch
        if state["pending"] or not state["sets"]:
            raise AssertionError(f"{len(state['pending'])} CPU MoE calls "
                                 f"without a card call ({state['sets']} "
                                 f"sets compared)")
        return res, state["flips"], state["sets"], dropped

    def xlstm_check(tag, small, plen):
        """xLSTM card against CPU in float32 (``card_vs_cpu``), and the bf16
        prefill's spread printed beside the CPU's own bf16-against-float32
        gap: with random weights the mLSTM's normaliser max(|q.n|,
        exp(-m)) divides by near-cancelling sums, so at full width one bf16
        rounding anywhere moves the logits by tenths (a one-ulp nudge of
        one block's w_up moves them by 0.85 on the CPU), and a bf16 check
        at LOGIT_TOL would test the rounding, not the port."""
        out = card_vs_cpu(tag, small, CHECK_BATCH, plen, CHECK_STEPS,
                          float32=True)
        on_card = init_params(torch.Generator(device="cuda").manual_seed(2),
                              small, dev)
        host = params_to(on_card, "cpu")
        toks = torch.randint(0, small.vocab_size, (CHECK_BATCH, plen),
                             generator=torch.Generator().manual_seed(3))
        lc = prefill(small, on_card, {"tokens": toks}, plen)[0].float().cpu()
        lh = prefill(small, host, {"tokens": toks}, plen)[0].float()
        l32 = prefill(small, as_float32(host), {"tokens": toks}, plen)[0]
        spread = {"bf16_card_vs_cpu": (lc - lh).abs().max().item(),
                  "cpu_bf16_vs_float32": (lh - l32).abs().max().item(),
                  "logit_scale": lh.abs().max().item()}
        print(f"[{tag}] bf16 prefill logits (not held; the check above ran "
              f"in float32): card vs CPU {spread['bf16_card_vs_cpu']:.5f}, "
              f"the CPU's bf16 vs its float32 "
              f"{spread['cpu_bf16_vs_float32']:.5f}, |logits| up to "
              f"{spread['logit_scale']:.3f}")
        out["bf16_spread"] = spread
        return out

    def family_check(tag, small, plen):
        """``card_vs_cpu`` at full width and small depth; MoE: the card
        routed to the CPU's experts call by call (``moe_routing``), the
        (token, layer) top-k sets the card would have chosen otherwise
        (routing flips, each a near-tie: the CPU's margin below
        MOE_FLIP_MARGIN) and the assignments dropped past capacity,
        printed; the check's prompts must overflow some expert."""
        if small.family == "ssm":
            return xlstm_check(tag, small, plen)
        if small.family != "moe":
            return card_vs_cpu(tag, small, CHECK_BATCH, plen, CHECK_STEPS)
        out, flips, n_sets, dropped = moe_routing(lambda: card_vs_cpu(
            tag, small, CHECK_BATCH, plen, CHECK_STEPS))
        print(f"[{tag}] routing: {len(flips)} of {n_sets} (token, layer) "
              f"top-{small.moe.top_k} sets the card chose otherwise than "
              f"the CPU (routed to the CPU's for the check), at CPU margins "
              f"{[round(m, 6) for m in flips]} (limit {MOE_FLIP_MARGIN}); "
              f"assignments dropped past capacity: CPU {dropped['cpu']}, "
              f"card {dropped['cuda']}")
        if dropped["cpu"] == 0 or dropped["cpu"] != dropped["cuda"]:
            raise AssertionError(f"{tag}: dropped assignments CPU "
                                 f"{dropped['cpu']}, card {dropped['cuda']} "
                                 f"(the check's prompts must overflow)")
        if any(m >= MOE_FLIP_MARGIN for m in flips):
            raise AssertionError(f"{tag}: a routing flip at a CPU margin "
                                 f"of {max(flips)}: not a near-tie")
        out.update({"routing_flips": len(flips), "routing_sets": n_sets,
                    "routing_flip_margins": flips,
                    "dropped_cpu": dropped["cpu"],
                    "dropped_card": dropped["cuda"]})
        return out

    for arch, tag, depth in FAMILY_SERVE:
        _phase(tag)
        fcfg = get_config(arch)
        if depth is not None:
            fcfg = dataclasses.replace(fcfg, n_layers=depth)
        family_cfgs[tag] = fcfg
        fparams = init_params(torch.Generator(device="cuda").manual_seed(0),
                              fcfg, dev)
        fgen = torch.Generator(device="cuda").manual_seed(1)
        fprompts = torch.randint(0, fcfg.vocab_size,
                                 (SERVE_BATCH, SERVE_PROMPT), device=dev,
                                 generator=fgen)
        patches = None
        if fcfg.family == "vlm":
            patches = torch.randn(
                (SERVE_BATCH, fcfg.n_patches, fcfg.frontend_dim), device=dev,
                generator=fgen)
        layers = fcfg.n_layers
        if fcfg.family == "ssm":
            want, held = {k: 0 for k in _build.SOURCES}, ()
            print(f"[{tag}] xLSTM runs no hand kernel: its mLSTM and sLSTM "
                  f"are tensor ops in the reference too (no pallas_call "
                  f"computes them), so every kernel's pin is 0")
        else:
            want = {"flash_attention": layers,
                    "decode_attention": layers * (SERVE_NEW - 1)}
            held = ("flash_attention", "decode_attention")
        fam_report = serve_cell(tag, fcfg, fparams, fprompts, SERVE_NEW,
                                SERVE_MAX_LEN, want, patch_embeds=patches,
                                held=held, profile_steps=2)
        fam_report["layers_served"] = layers
        fam_report["layers_published"] = get_config(arch).n_layers
        fam_report["parameters"] = count_params(fparams)
        del fparams, fprompts, patches
        torch.cuda.empty_cache()
        small = dataclasses.replace(fcfg, n_layers=FCHECK_LAYERS[tag])
        if fcfg.family == "ssm":  # one segment ending in its sLSTM
            small = dataclasses.replace(small, ssm=dataclasses.replace(
                small.ssm, slstm_layers=(FCHECK_LAYERS[tag] - 1,)))
        fam_report.update(family_check(tag, small, FCHECK_PROMPT[tag]))
        report["phases"][tag] = fam_report
        torch.cuda.empty_cache()

    # serve_whisper: encode 1,500 frames, fill the cross cache, decode 32
    # tokens with cross_len 1,500, then decode_train on those tokens
    _phase("serve_whisper")
    wcfg = get_config("whisper-medium")
    family_cfgs["serve_whisper"] = wcfg
    wparams = init_params(torch.Generator(device="cuda").manual_seed(0), wcfg,
                          dev)
    frames = torch.randn((SERVE_BATCH, WHISPER_FRAMES, wcfg.frontend_dim),
                         device=dev,
                         generator=torch.Generator(device="cuda").manual_seed(1))
    print(f"[serve_whisper] {wcfg.name}: {count_params(wparams):,} "
          f"parameters in bf16 on the card ({wcfg.n_layers} + "
          f"{wcfg.n_layers} layers, d {wcfg.d_model}, {wcfg.n_heads} heads "
          f"of {wcfg.head_dim}); batch {SERVE_BATCH}, {WHISPER_FRAMES} "
          f"frames, {SERVE_NEW} tokens, max_len {WHISPER_MAX_LEN}")

    def whisper_serve(frames_, n_tok, max_len):
        """(tokens (b, n_tok), step logits, decode_train logits, seconds
        of encode + cross fill, of the decode steps, of decode_train)."""
        b, t = frames_.shape[:2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = WHISPER.encode(wcfg, wparams, frames_)
        cache = init_decode_state(wcfg, b, max_len, dev)
        for i, lp in enumerate(wparams["dec_blocks"]):
            k, v = WHISPER._cross_kv(wcfg, lp, enc)
            cache["cross_k"][i][:, :t] = k
            cache["cross_v"][i][:, :t] = v
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = torch.full((b, 1), WHISPER_START, dtype=torch.long, device=dev)
        toks, step_logits = [tok], []
        for i in range(n_tok):
            logits, cache = WHISPER.decode_step(wcfg, wparams, cache, tok, i,
                                                t)
            step_logits.append(logits)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        inputs = torch.cat(toks[:-1], dim=1)
        full = WHISPER.decode_train(wcfg, wparams, inputs, enc)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return (inputs, torch.cat(step_logits, dim=1), full, t1 - t0,
                t2 - t1, t3 - t2)

    whisper_serve(frames[:, :128], 2, 256)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    wseen: dict = {}
    worigs = [(ATTN_MODEL, "flash_attention", record_call(
                  wseen, ATTN_MODEL, "flash_attention")),
              (ATTN_MODEL, "decode_attention", record_call(
                  wseen, ATTN_MODEL, "decode_attention", lambda a: a[3]))]
    try:
        wout, wcounts, wwall, _ = run_path("serve_whisper", lambda: whisper_serve(
            frames, SERVE_NEW, WHISPER_MAX_LEN))
    finally:
        for mod, attr, orig in worigs:
            setattr(mod, attr, orig)
    wtoks, wsteps, wfull = wout[:3]
    wpins = {"flash_attention": 3 * wcfg.n_layers,
             "decode_attention": 2 * wcfg.n_layers * SERVE_NEW}
    for k, n in wpins.items():
        if wcounts[k] != n:
            raise AssertionError(f"serve_whisper launched {k} {wcounts[k]} "
                                 f"times, expected {n}")
    w_err = (wsteps.float() - wfull.float()).abs().max().item()
    if not (torch.isfinite(wfull).all() and w_err <= LOGIT_TOL):
        raise AssertionError(f"whisper decode_train differs from its decode "
                             f"steps by {w_err} (tolerance {LOGIT_TOL})")
    wpeak = torch.cuda.max_memory_allocated() / 1e9
    wheld = hold_model_calls("serve_whisper", wseen)
    if {e["name"] for e in wheld} != set(wpins):
        raise AssertionError(f"serve_whisper held {sorted(wseen)}")
    del wseen
    wruns = [wout[3:]] + [whisper_serve(frames, SERVE_NEW,
                                        WHISPER_MAX_LEN)[3:]
                          for _ in range(2)]
    w_enc, w_dec, w_train = (min(r[i] for r in wruns) for i in range(3))
    print(f"[serve_whisper] runs (encode + cross s, decode s, decode_train "
          f"s): {wruns}; best: encode {w_enc:.5f} s, decode "
          f"{w_dec / SERVE_NEW * 1e3:.3f} ms per step, "
          f"{SERVE_BATCH * SERVE_NEW / w_dec:.1f} decode tokens/s, "
          f"decode_train {w_train:.5f} s; decode_train vs the step logits "
          f"{w_err:.3e} (tolerance {LOGIT_TOL}); peak {wpeak:.2f} GB; "
          f"launches " + ", ".join(f"{k} {wcounts[k]}" for k in wpins))

    def whisper_steps(n):
        enc = WHISPER.encode(wcfg, wparams, frames)
        cache = init_decode_state(wcfg, SERVE_BATCH, WHISPER_MAX_LEN, dev)
        for i, lp in enumerate(wparams["dec_blocks"]):
            k, v = WHISPER._cross_kv(wcfg, lp, enc)
            cache["cross_k"][i][:, :WHISPER_FRAMES] = k
            cache["cross_v"][i][:, :WHISPER_FRAMES] = v
        tok = torch.full((SERVE_BATCH, 1), WHISPER_START, dtype=torch.long,
                         device=dev)
        return lambda: [WHISPER.decode_step(wcfg, wparams, cache, tok, i,
                                            WHISPER_FRAMES)
                        for i in range(n)]

    wbusy_enc = print_busy("serve_whisper encode", *busy_window(
        lambda: WHISPER.encode(wcfg, wparams, frames)), top=10)
    wbusy_dec = print_busy("serve_whisper decode (2 steps)",
                           *busy_window(whisper_steps(2)), top=10)
    for part, busy, unprofiled in (("encode", wbusy_enc, w_enc),
                                   ("decode", wbusy_dec,
                                    w_dec * 2 / SERVE_NEW)):
        if busy["device_busy_s"] is None:
            raise AssertionError(f"the profiler saw no device work in "
                                 f"serve_whisper {part}")
        busy["idle_share_of_unprofiled_wall"] = (
            1.0 - busy["device_busy_s"] / unprofiled)
        print(f"[serve_whisper {part}] device busy "
              f"{busy['device_busy_s']:.5f} s against the fastest "
              f"unprofiled {unprofiled:.5f} s: idle share "
              f"{busy['idle_share_of_unprofiled_wall']:.4f}")
    whisper_report = {
        "wall_s": wwall, "launches": wcounts, "runs": wruns,
        "encode_s": w_enc, "decode_s_per_token": w_dec / SERVE_NEW,
        "decode_tokens_per_s": SERVE_BATCH * SERVE_NEW / w_dec,
        "decode_train_s": w_train, "decode_train_vs_steps": w_err,
        "peak_memory_gb": wpeak, "busy_encode": wbusy_enc,
        "busy_decode": wbusy_dec, "plain_checks": wheld,
        "parameters": count_params(wparams)}
    del wparams, frames, wout, wtoks, wsteps, wfull
    torch.cuda.empty_cache()

    # card against CPU: 2 + 2 layers at full width on WCHECK_FRAMES frames
    t0 = time.perf_counter()
    wsmall = dataclasses.replace(wcfg, n_layers=2)
    on_card = init_params(torch.Generator(device="cuda").manual_seed(2),
                          wsmall, dev)
    host = params_to(on_card, "cpu")
    cframes = torch.randn((CHECK_BATCH, WCHECK_FRAMES, wcfg.frontend_dim),
                          generator=torch.Generator().manual_seed(3))
    outs, cpu_toks = {}, []
    for where, p_ in (("cpu", host), ("cuda", on_card)):
        enc = WHISPER.encode(wsmall, p_, cframes.to(where))
        cache = init_decode_state(wsmall, CHECK_BATCH, WCHECK_FRAMES, where)
        for i, lp in enumerate(p_["dec_blocks"]):
            k, v = WHISPER._cross_kv(wsmall, lp, enc)
            cache["cross_k"][i][:, :WCHECK_FRAMES] = k
            cache["cross_v"][i][:, :WCHECK_FRAMES] = v
        tok = torch.full((CHECK_BATCH, 1), WHISPER_START, dtype=torch.long)
        logits = []
        for i in range(CHECK_STEPS + 1):
            lg, cache = WHISPER.decode_step(wsmall, p_, cache, tok.to(where),
                                            i, WCHECK_FRAMES)
            logits.append(lg.float().cpu())
            if where == "cpu":
                cpu_toks.append(lg[:, -1].argmax(-1, keepdim=True))
            tok = cpu_toks[i]  # both fed the CPU's greedy tokens
        outs[where] = (enc.float().cpu(), logits)
    enc_err = (outs["cuda"][0] - outs["cpu"][0]).abs().max().item()
    w_logit_errs = [(a - b).abs().max().item()
                    for a, b in zip(outs["cuda"][1], outs["cpu"][1])]
    if not (enc_err <= LOGIT_TOL and max(w_logit_errs) <= LOGIT_TOL):
        raise AssertionError(f"whisper card vs CPU: encoder {enc_err}, "
                             f"logits {w_logit_errs} (tolerance {LOGIT_TOL})")
    print(f"[serve_whisper] card vs CPU (2 + 2 layers, {WCHECK_FRAMES} "
          f"frames, {CHECK_STEPS + 1} decode steps): encoder output "
          f"{enc_err:.5f}, max |logit diff| per step "
          f"{[round(e, 5) for e in w_logit_errs]} (tolerance {LOGIT_TOL}); "
          f"{time.perf_counter() - t0:.1f} s")
    whisper_report.update({"card_vs_cpu_encoder_err": enc_err,
                           "card_vs_cpu_logit_err": w_logit_errs})
    report["phases"]["serve_whisper"] = whisper_report
    del on_card, host, outs
    torch.cuda.empty_cache()
    fam_wall = time.perf_counter() - t_fam
    report["phases"]["serve_families_wall_s"] = fam_wall
    print(f"[serve_families] phase 6d: {fam_wall:.1f} s")

    # -- 6b. train: the training path at qwen2-0.5b's full width ----------
    _phase("train")
    import tempfile

    # AdamW's float32 square root: torch.sqrt on the card must round as
    # the float64 route the CPU takes does (the reference's rounding)
    sqrt_bad = sqrt_mismatches(torch, dev)
    print(f"[train] AdamW's sqrt_ on the card against the float64 root "
          f"rounded back, {SQRT_CHECK_N} float32 values: {sqrt_bad} differ")
    if sqrt_bad:
        raise AssertionError(f"torch.sqrt on the card is not correctly "
                             f"rounded on {sqrt_bad} values: AdamW's sqrt_ "
                             f"must take the float64 route there too")
    report["phases"]["train_sqrt_mismatches"] = sqrt_bad

    import torch.nn.functional as F

    from repro_torch.core import FaultEvent, StragglerTuner
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    def att_rand(shape, seed, dtype):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def tuner_attempts():
        """Record every tuner attempt of every trainer tuner (a trainer
        rebuilds its tuner after a rescale): (step, wall s, moved?)."""
        log: list = []
        orig = StragglerTuner.maybe_replan

        def wrapped(self):
            before = self._last_attempt
            rp = orig(self)
            if self._last_attempt != before:
                log.append((self._last_attempt, self.last_replan_seconds,
                            rp is not None))
            return rp

        StragglerTuner.maybe_replan = wrapped
        return log, lambda: setattr(StragglerTuner, "maybe_replan", orig)

    def fn_err(got, want):
        """(max |got - want|, the largest |got - want| / (min(1, RMS(want))
        + |want|)): an error and its reading against ATT_TOL's bf16 limit
        scaled to the tensor's own size.  Over 1,500 keys a non-causal
        output's RMS is about 0.04, so a limit of 5e-2 x (1 + |want|)
        would pass a kernel that skipped a key."""
        want = want.float()
        diff = (got.float() - want).abs()
        floor = min(1.0, want.square().mean().sqrt().item())
        return diff.max().item(), (diff / (floor + want.abs())).max().item()

    def hold_flash_fn(tag, cfg_, tc_, sq=None, skv=None, causal=True):
        """FlashAttentionFn at a training path's own shape (one batch of
        the trainer's n_batches, ``sq`` queries over ``skv`` keys, both
        the sequence length by default; bf16), not counted (a check, not
        the path).  Its output against the plain version within 5e-2 x
        (1 + |plain|), and within 5e-2 x (min(1, RMS) + |plain|) of the
        plain version in float32 on the same inputs (``fn_err``; the bf16
        plain version rounds its logits, the kernel does not, which can
        leave the two near that limit); dq, dk, dv (the backward kernel's)
        within 5e-2 x (min(1, RMS) + |plain|) of autograd through the
        plain version in float32 (the kernel keeps S and dP in float32,
        where the bf16 plain autograd rounds them), their distance from
        the bf16 plain autograd and that autograd's own from float32
        printed beside, and a second backward pass bit-equal to the
        first.
        Non-causal, the plain output without the last key must read past
        that limit: the check would fail a kernel that skipped it.
        Returns the shapes, the inputs and dO, the max |err|s against the
        bf16 plain version and the readings."""
        fb_ = tc_.global_batch // tc_.n_batches
        sq, skv = sq or tc_.seq_len, skv or tc_.seq_len
        shapes = ((fb_, sq, cfg_.n_heads, cfg_.head_dim),
                  (fb_, skv, cfg_.n_kv_heads, cfg_.head_dim))
        q_ = att_rand(shapes[0], 41, torch.bfloat16)
        k_ = att_rand(shapes[1], 42, torch.bfloat16)
        v_ = att_rand(shapes[1], 43, torch.bfloat16)
        do_ = att_rand(shapes[0], 44, torch.bfloat16)
        plain_in = [t.clone().requires_grad_(True) for t in (q_, k_, v_)]
        fn_in = [t.clone().requires_grad_(True) for t in (q_, k_, v_)]
        want = FA.flash_attention_plain(*plain_in, causal=causal)
        want.backward(do_)
        got = FA.FlashAttentionFn.apply(*fn_in, causal, 0)
        got.backward(do_)
        with torch.no_grad():
            want32 = FA.flash_attention_plain(q_.float(), k_.float(),
                                              v_.float(), causal=causal)
        torch.cuda.synchronize()
        tol = ATT_TOL["bfloat16"]
        errs, reading = {}, {}
        errs["out"], _, ok = att_err("flash_attention", got.detach(),
                                     want.detach(), "bfloat16")
        reading["out"] = fn_err(got.detach(), want32)[1]
        if not ok or not reading["out"] <= tol:
            raise AssertionError(
                f"{tag}: FlashAttentionFn's output differs from the plain "
                f"version's by {errs['out']}, from its float32 by "
                f"{reading['out']} of min(1, RMS) + |plain| (tolerance "
                f"{tol})")
        # the gradients (the backward kernel's) are held to the float32
        # plain autograd, as the output is: the bf16 plain autograd rounds
        # its logits, dP and dS products, which puts it itself up to about
        # 6e-2 of this reading from the float32 gradients at these shapes
        # (printed as plain_vs_f32)
        ref32 = [t.float().requires_grad_(True) for t in (q_, k_, v_)]
        FA.flash_attention_plain(*ref32, causal=causal).backward(do_.float())
        for i, name in enumerate(("dq", "dk", "dv")):
            errs[name], reading[f"{name}_vs_bf16_plain"] = fn_err(
                fn_in[i].grad, plain_in[i].grad)
            reading[name] = fn_err(fn_in[i].grad, ref32[i].grad)[1]
            reading[f"{name}_plain_vs_f32"] = fn_err(plain_in[i].grad,
                                                     ref32[i].grad)[1]
            if not reading[name] <= tol:
                raise AssertionError(
                    f"{tag}: FlashAttentionFn {name} differs from the plain "
                    f"version's float32 autograd by {reading[name]} of "
                    f"min(1, RMS) + |plain| (tolerance {tol}); the bf16 "
                    f"plain autograd reads {reading[f'{name}_plain_vs_f32']}")
        del ref32
        again = [t.clone().requires_grad_(True) for t in (q_, k_, v_)]
        FA.FlashAttentionFn.apply(*again, causal, 0).backward(do_)
        if not all(torch.equal(a.grad, b.grad) for a, b in zip(again, fn_in)):
            raise AssertionError(f"{tag}: two FlashAttentionFn backward "
                                 f"passes differ")
        del again
        planted = ""
        if not causal:
            with torch.no_grad():
                cut = FA.flash_attention_plain(q_, k_[:, :-1], v_[:, :-1],
                                               causal=False)
            reading["out_without_last_key"] = fn_err(cut, want32)[1]
            if not reading["out_without_last_key"] > tol:
                raise AssertionError(
                    f"{tag}: the limit passes an output without the last of "
                    f"{skv} keys ({reading['out_without_last_key']})")
            planted = (f"; the plain output without the last of the {skv} "
                       f"keys reads {reading['out_without_last_key']:.4f}, "
                       f"past the limit")
        print(f"[{tag}] FlashAttentionFn at q {list(shapes[0])} k/v "
              f"{list(shapes[1])} bf16 {'causal' if causal else 'non-causal'}"
              f": max |err| against the plain version's autograd {errs} "
              f"(out within {tol} x (1 + |plain|)); largest |err| / "
              f"(min(1, RMS) + |plain|), the output against the plain "
              f"version in float32 "
              f"{ {k: round(v, 5) for k, v in reading.items()} } (tolerance "
              f"{tol} on out, dq, dk, dv; the _vs_bf16_plain and "
              f"_plain_vs_f32 readings printed, not held){planted}; a "
              f"second backward pass bit-equal")
        return shapes, (q_, k_, v_, do_), errs, reading

    def flash_fn_row(tag, case, fq, fk, fv, fdo, causal, fn_errs, reading):
        """FlashAttentionFn's forward, backward and forward + backward
        times at one shape (bf16), beside the plain version's, SDPA's and
        the bound of each; and, in the same call, the trainable form as it
        ran before the backward kernel (the forward kernel, then the plain
        backward ``flash_attention_grad``).  ``fn_errs`` and ``reading``
        are hold_flash_fn's."""
        leaves3 = [t.detach().requires_grad_(True) for t in (fq, fk, fv)]
        st = [t.detach().transpose(1, 2).contiguous().requires_grad_(True)
              for t in (fq, fk, fv)]
        sdo = fdo.transpose(1, 2).contiguous()

        def fwd_bwd(fn, ins, dout):
            return torch.autograd.grad(fn(*ins), ins, dout)

        def sdpa_t(a, b_, c):
            return F.scaled_dot_product_attention(a, b_, c, is_causal=causal,
                                                  enable_gqa=True)

        with torch.no_grad():
            tf_ms = cuda_ms(lambda: FA.flash_attention(fq, fk, fv,
                                                       causal=causal), 20)
            tf_plain = cuda_ms(lambda: FA.flash_attention_plain(
                fq, fk, fv, causal=causal), 5)
            tf_lib = cuda_ms(lambda: sdpa_t(*st), 20)
        tb_ms = cuda_ms(lambda: fwd_bwd(
            lambda a, b_, c: FA.FlashAttentionFn.apply(a, b_, c, causal, 0),
            leaves3, fdo), 10)
        tb_plain = cuda_ms(lambda: fwd_bwd(
            lambda a, b_, c: FA.flash_attention_plain(a, b_, c,
                                                      causal=causal),
            leaves3, fdo), 5)
        tb_lib = cuda_ms(lambda: fwd_bwd(sdpa_t, st, sdo), 10)
        with torch.no_grad():
            tb_old = cuda_ms(lambda: (
                FA.flash_attention(fq, fk, fv, causal=causal),
                FA.flash_attention_grad(fq, fk, fv, fdo, causal=causal)), 5)
            # the backward alone: the kernel from the forward's output and
            # LSE, the plain backward, SDPA's backward through its graph
            out_, lse_, lo_ = FA._attend(fq, fk, fv, causal, 0,
                                         with_lse=True)
            bk_ms = cuda_ms(lambda: FA._attend_grad(fq, fk, fv, out_, lo_,
                                                    lse_, fdo, causal, 0), 10)
            bk_plain = cuda_ms(lambda: FA.flash_attention_grad(
                fq, fk, fv, fdo, causal=causal), 5)
        so = sdpa_t(*st)
        bk_lib = cuda_ms(lambda: torch.autograd.grad(so, st, sdo,
                                                     retain_graph=True), 10)
        del so, out_, lse_, lo_
        b_, sq_, hh_, hd_ = fq.shape
        work = (b_, sq_, fk.shape[1], hh_, fk.shape[2], hd_, causal, 0,
                fq.element_size())
        t_flops, t_bytes = FA.flash_attention_work(*work)
        k_flops, k_bytes = FA.flash_attention_grad_work(*work)

        t_bound, t_by = bf16_bound(t_flops, t_bytes)
        k_bound, k_by = bf16_bound(k_flops, k_bytes)
        tb_bound, tb_by = bf16_bound(t_flops + k_flops, t_bytes + k_bytes)
        row = {
            "name": "flash_attention", "case": case, "causal": causal,
            "shape": [list(fq.shape), list(fk.shape)], "ms": tf_ms,
            "plain_ms": tf_plain, "library_ms": tf_lib, "bound_ms": t_bound,
            "bound_by": t_by,
            "bwd_ms": bk_ms, "bwd_plain_ms": bk_plain,
            "bwd_library_ms": bk_lib, "bwd_bound_ms": k_bound,
            "bwd_bound_by": k_by,
            "fwd_bwd_ms": tb_ms, "fwd_bwd_plain_ms": tb_plain,
            "fwd_bwd_library_ms": tb_lib, "fwd_bwd_bound_ms": tb_bound,
            "fwd_bwd_bound_by": tb_by, "fwd_bwd_tensor_op_bwd_ms": tb_old,
            "max_abs_err": fn_errs, "err_reading": reading,
            "tolerance": (f"out {ATT_TOL['bfloat16']} x (1 + |plain|), and x "
                          f"(min(1, RMS) + |plain|) of the float32 plain "
                          f"version; dq, dk, dv x (min(1, RMS) + |plain|)")}
        print(f"[{tag}] flash_attention at {row['shape']} "
              f"{'causal' if causal else 'non-causal'}: forward {tf_ms:.4f} "
              f"ms (plain {tf_plain:.4f}, SDPA {tf_lib:.4f}, bound "
              f"{t_bound:.5f}); backward kernel {bk_ms:.4f} ms (plain "
              f"backward {bk_plain:.4f}, SDPA's backward {bk_lib:.4f}, bound "
              f"{k_bound:.5f}); forward + backward through FlashAttentionFn "
              f"{tb_ms:.4f} ms (plain autograd {tb_plain:.4f}, SDPA "
              f"{tb_lib:.4f}, bound {tb_bound:.5f}; the forward kernel and "
              f"the tensor-op backward, as before the backward kernel, "
              f"{tb_old:.4f})")
        return row

    step_rows: dict = {}  # a training path's rows a backward pass, by step

    def pin_backwards(tag, counts, kernels=("flash_attention", "ssd_scan")):
        """Every forward launch of a trainable kernel on a training path is
        under grad, so each has its backward: the backward kernel's count
        (one a backward call) must equal the forward's."""
        for k in kernels:
            if counts[f"{k}_bwd"] != counts[k]:
                raise AssertionError(f"{tag}: {k}_bwd launched "
                                     f"{counts[f'{k}_bwd']} times against "
                                     f"{counts[k]} forward launches under "
                                     f"grad")
        return {k: counts[f"{k}_bwd"] for k in kernels}

    def counted_run(tag, trainer):
        """``trainer.run()`` through its public loop, counting the distinct
        batches' backward passes and timing each step (synchronised); each
        step's backward passes' rows go to ``step_rows[tag]`` (the dryrun
        phase's reckoning and FLOP count).  Returns (result, launches, wall
        s, backward passes, step walls, tuner attempts, peak GB
        allocated)."""
        grad_calls, step_walls = [0], []
        rows = step_rows[tag] = []
        o_grad, o_step = trainer._grad_fn, trainer.step

        def counted_grad(params, batch):
            grad_calls[0] += 1
            rows[-1].append(int(batch["tokens"].shape[0]))
            return o_grad(params, batch)

        def timed_step(i):
            rows.append([])
            t0 = time.perf_counter()
            out = o_step(i)
            torch.cuda.synchronize()
            step_walls.append(time.perf_counter() - t0)
            return out

        trainer._grad_fn, trainer.step = counted_grad, timed_step
        attempts, restore_tuner = tuner_attempts()
        torch.cuda.reset_peak_memory_stats()
        try:
            res, counts, wall, _ = run_path(tag, trainer.run)
        finally:
            restore_tuner()
            del trainer._grad_fn, trainer.step  # the class's methods again
        return (res, counts, wall, grad_calls[0], step_walls, attempts,
                torch.cuda.max_memory_allocated() / 1e9)

    # train_pins: the reduced trainer on the card and on the CPU, from the
    # same weights, through a whole-group fault whose elastic re-plan
    # restores the last checkpoint: the control plane equal exactly, the
    # losses within TRAIN_PIN_LOSS_TOL
    def trainer_at_depth(tc_, n_layers=None, device=None):
        """``Trainer(tc_, device)``, its model cut to ``n_layers`` where
        given: the trainer takes its config from the registry
        (``get_config``, or ``reduced_config`` when ``tc_.reduced``), whose
        depth its config has no field for, so the lookup is narrowed while
        the trainer is built."""
        import repro_torch.launch.train as TRAIN

        if n_layers is None:
            return Trainer(tc_, device=device)
        name = "reduced_config" if tc_.reduced else "get_config"
        orig = getattr(TRAIN, name)
        setattr(TRAIN, name, lambda c: dataclasses.replace(orig(c),
                                                           n_layers=n_layers))
        try:
            return Trainer(tc_, device=device)
        finally:
            setattr(TRAIN, name, orig)

    def train_pins(tag, pin_config, n_layers=None):
        """The reduced trainer on the card and on the CPU from the same
        weights, workers 1 and 5 dead from step 3, checkpoints every 2
        steps: the control plane equal, losses within TRAIN_PIN_LOSS_TOL,
        and the card's elastic re-plan restoring a checkpoint."""
        with tempfile.TemporaryDirectory() as tmp:
            ptc = TrainerConfig(
                **pin_config, faults=(FaultEvent(1, 3, 10**9),
                                      FaultEvent(5, 3, 10**9)),
                checkpoint_dir=os.path.join(tmp, "cpu"))
            pin_host = trainer_at_depth(ptc, n_layers, device="cpu")
            pin_card = trainer_at_depth(dataclasses.replace(
                ptc, checkpoint_dir=os.path.join(tmp, "cuda")), n_layers)
            pin_card.params = params_to(pin_host.params, dev)
            pin_card.opt_state = params_to(pin_host.opt_state, dev)
            restores = []
            o_restore = pin_card.ckpt.restore

            def spy_restore(example, step=None):
                out = o_restore(example, step)
                restores.append(out[1]["step"])
                return out

            pin_card.ckpt.restore = spy_restore
            t0 = time.perf_counter()
            rh = pin_host.run()
            host_wall = time.perf_counter() - t0
            rc, pcounts, pwall, _ = run_path(tag, pin_card.run)
        loss_err = float(np.max(np.abs(np.array(rc.losses)
                                       - np.array(rh.losses))))
        pins = {"sim_times": rc.sim_times == rh.sim_times,
                "plan_history": rc.plan_history == rh.plan_history,
                "events": rc.events == rh.events,
                "final_plan": (rc.final_plan.n_data, rc.final_plan.n_batches)
                == (rh.final_plan.n_data, rh.final_plan.n_batches),
                "generation": pin_card.rescaler.topology.generation
                == pin_host.rescaler.topology.generation}
        if not all(pins.values()):
            raise AssertionError(f"{tag}: the card's control plane differs "
                                 f"from the CPU's: {pins}")
        if not restores or not any("replan" in e for e in rc.events):
            raise AssertionError(f"{tag}: no elastic re-plan restored a "
                                 "checkpoint on the card")
        if not loss_err <= TRAIN_PIN_LOSS_TOL:
            raise AssertionError(f"{tag}: card and CPU losses differ by "
                                 f"{loss_err} (tolerance "
                                 f"{TRAIN_PIN_LOSS_TOL})")
        kernels = {"hybrid": ("flash_attention", "ssd_scan"),
                   "ssm": ()}.get(pin_card.cfg.family, ("flash_attention",))
        for k in kernels:
            if pcounts[k] <= 0:
                raise AssertionError(f"{tag} never launched {k}")
        pin_backwards(tag, pcounts)
        print(f"[{tag}] {ptc.arch} reduced ({pin_card.cfg.n_layers} layers), "
              f"{ptc.steps} steps, workers 1 and 5 dead from step 3, "
              f"checkpoints every {ptc.checkpoint_every}: card == CPU for "
              f"{sorted(pins)}; the card's re-plan restored step {restores}; "
              f"plan_history {rc.plan_history}; events {rc.events}; max "
              f"|loss diff| {loss_err:.3e} (tolerance {TRAIN_PIN_LOSS_TOL}); "
              f"launches {pcounts}; card wall {pwall:.3f} s, CPU wall "
              f"{host_wall:.3f} s")
        return {"layers": pin_card.cfg.n_layers, "equal": pins,
                "restored_steps": restores, "loss_max_abs_diff": loss_err,
                "plan_history": rc.plan_history, "events": rc.events,
                "launches": pcounts, "card_wall_s": pwall,
                "cpu_wall_s": host_wall, "card_losses": rc.losses,
                "cpu_losses": rh.losses}

    def train_profile(tag, trainer, rep, med, shares, n_steps=2):
        """``n_steps`` more steps of a full-width trainer under the
        profiler: the card's busy time and idle share against as many
        median unprofiled steps."""
        n0 = len(rep["losses"])
        prof = print_busy(f"{tag} {n_steps} steps", *busy_window(
            lambda: [trainer.step(n0 + i) for i in range(n_steps)]), top=10,
            shares=shares)
        if prof["device_busy_s"] is None:
            raise AssertionError(f"the profiler saw no device work in {tag}")
        unprofiled = n_steps * med
        prof["steps"] = n_steps
        prof["idle_share_of_unprofiled_wall"] = (
            1.0 - prof["device_busy_s"] / unprofiled)
        print(f"[{tag}] {n_steps} steps: device busy "
              f"{prof['device_busy_s']:.5f} s against {n_steps} median "
              f"unprofiled steps {unprofiled:.5f} s: idle share "
              f"{prof['idle_share_of_unprofiled_wall']:.4f}")
        rep["profile"] = prof

    trainer_profiles: list = []  # profiled steps, run after phase 7

    def train_phase():
        """Phase 6b: qwen2-0.5b at full width through ``Trainer.run``.
        Returns FlashAttentionFn's row at its shape; queues its profiled
        steps."""
        t_train = time.perf_counter()
        held_gb = torch.cuda.memory_allocated() / 1e9  # earlier phases' hold
        tc = TrainerConfig(steps=TRAIN_STEPS, **TRAIN_CONFIG)
        tr = Trainer(tc)
        tcfg = tr.cfg
        n_params = count_params(tr.params)
        print(f"[train] {tcfg.name} at full width: {tcfg.n_layers} layers, "
              f"d {tcfg.d_model}, {tcfg.n_heads} heads / {tcfg.n_kv_heads} "
              f"KV of {tcfg.head_dim}, vocab {tcfg.vocab_size}: "
              f"{n_params:,} parameters (bf16), float32 AdamW moments and "
              f"master; {TRAIN_STEPS} steps of {TRAIN_CONFIG}")

        # every parameter leaf gets a finite gradient at step 0, and the
        # attention projections a nonzero one: wq and wk reach the loss
        # only through the attention weights, so a kernel output detached
        # from the graph would leave them at exactly 0 (not counted:
        # before the path)
        b0 = tr._device_batch(tr.pipeline.batch_for(0, 0, tc.n_batches))
        loss0, g0 = tr._grad_fn(tr.params, b0)
        torch.cuda.synchronize()
        leaves = tree_leaves(g0)
        if len(leaves) != len(tree_leaves(tr.params)) or not all(
                bool(torch.isfinite(g).all()) for g in leaves):
            raise AssertionError("a parameter leaf got no finite gradient")
        zero_attn = [(i, n) for i, lp in enumerate(g0["blocks"])
                     for n in ("wq", "wk", "wv", "bq", "bk", "bv")
                     if not lp["attn"][n].abs().max().item() > 0]
        if zero_attn:
            raise AssertionError(f"zero attention gradients at "
                                 f"{zero_attn[:6]}")
        grad_norms = {
            "wq_layer0": g0["blocks"][0]["attn"]["wq"].norm().item(),
            "wk_layer0": g0["blocks"][0]["attn"]["wk"].norm().item(),
            "embed": g0["embed"]["tokens"].norm().item()}
        print(f"[train] step-0 gradients: {len(leaves)} leaves, all finite; "
              f"every layer's wq/wk/wv/bq/bk/bv nonzero; loss {loss0:.4f}; "
              f"norms {grad_norms}")
        del g0, leaves

        # FlashAttentionFn at the path's shape, held against the plain
        # version's autograd, then timed forward and forward + backward
        # beside the plain version's autograd and SDPA
        _, (fq, fk, fv, fdo), fn_errs, fn_reading = hold_flash_fn(
            "train", tcfg, tc)
        train_flash_row = flash_fn_row("train", "train (forward)", fq, fk,
                                       fv, fdo, True, fn_errs, fn_reading)
        del fq, fk, fv, fdo

        res, tcounts, twall, n_grads, step_walls, attempts, peak_gb = (
            counted_run("train", tr))
        want_flash = tcfg.n_layers * n_grads
        if tcounts["flash_attention"] != want_flash:
            raise AssertionError(f"train launched flash_attention "
                                 f"{tcounts['flash_attention']} times, "
                                 f"expected {tcfg.n_layers} layers x "
                                 f"{n_grads} distinct batches = "
                                 f"{want_flash}")
        pin_backwards("train", tcounts)
        if not attempts:
            raise AssertionError("the tuner made no re-plan attempt")
        losses = res.losses
        first5, last5 = (float(np.mean(losses[:5])),
                         float(np.mean(losses[-5:])))
        if not all(np.isfinite(losses)) or not last5 < first5:
            raise AssertionError(f"the loss did not fall: first 5 {first5}, "
                                 f"last 5 {last5}")
        med_step = statistics.median(step_walls)
        print(f"[train] losses first {losses[0]:.5f}, last {losses[-1]:.5f}; "
              f"mean of the last 5 {last5:.5f} < mean of the first 5 "
              f"{first5:.5f}: the loss falls")
        finite_sim = float(np.sum([t for t in res.sim_times
                                   if np.isfinite(t)]))
        print(f"[train] simulated time {res.total_sim_time:.4f} s over "
              f"{len(losses)} steps ({finite_sim:.4f} s over the steps that "
              f"completed; a step that lost a whole batch takes inf); "
              f"plan_history {res.plan_history}")
        print(f"[train] events {res.events}")
        print(f"[train] tuner attempts (tuner step, wall s, moved B): "
              f"{attempts}")
        print(f"[train] wall {twall:.3f} s; median step wall {med_step:.4f} "
              f"s (min {min(step_walls):.4f}, max {max(step_walls):.4f}); "
              f"peak memory allocated {peak_gb:.2f} GB ({held_gb:.2f} GB of "
              f"it held by earlier phases' tensors when the phase began)")
        others = {k: v for k, v in tcounts.items()
                  if k not in ("flash_attention", "flash_attention_bwd",
                               "sojourn_cells")}
        print(f"[train] launches: flash_attention "
              f"{tcounts['flash_attention']} = {tcfg.n_layers} layers x "
              f"{n_grads} distinct batches over {len(losses)} steps, "
              f"flash_attention_bwd {tcounts['flash_attention_bwd']} (one a "
              f"forward under grad); "
              f"sojourn_cells {tcounts['sojourn_cells']} (the tuner's "
              f"{len(attempts)} re-plan attempt(s) score a plain metric, the "
              f"mean completion: sweep_simulated's torch ops, no sojourn "
              f"scan); others {others}")
        train_report = {
            "config": {**TRAIN_CONFIG, "steps": TRAIN_STEPS,
                       "slow_workers": {str(k): v for k, v in
                                        TRAIN_CONFIG["slow_workers"].items()}},
            "parameters": n_params, "step0_loss": loss0,
            "step0_grad_norms": grad_norms, "flash_fn_max_abs_err": fn_errs,
            "flash_fn_err_reading": fn_reading,
            "flash_train_shape": train_flash_row,
            "losses": losses, "sim_times": res.sim_times,
            "total_sim_time": res.total_sim_time,
            "finite_sim_time": finite_sim,
            "plan_history": res.plan_history, "events": res.events,
            "tuner_attempts": attempts, "wall_s": twall,
            "step_walls_s": step_walls, "median_step_s": med_step,
            "peak_memory_gb": peak_gb, "held_before_gb": held_gb,
            "launches": tcounts, "distinct_batch_grads": n_grads}
        train_report["train_pins"] = train_pins("train_pins",
                                                TRAIN_PIN_CONFIG)
        print(f"[train] phase 6b: {time.perf_counter() - t_train:.1f} s")
        report["phases"]["train"] = train_report
        trainer_profiles.append(lambda: train_profile(
            "train", tr, train_report, med_step, TRAIN_SHARES))
        return train_flash_row

    train_flash_row = train_phase()

    # -- 6c. train_hybrid: zamba2-7b at full width, depth 13 --------------
    _phase("train_hybrid")

    def train_hybrid_phase():
        """Phase 6c: zamba2-7b at full width and depth 13 through
        ``Trainer.run``.  Returns SsdScanFn's row at its shape, and
        queues its profiled steps."""
        t_htrain = time.perf_counter()
        held_h = torch.cuda.memory_allocated() / 1e9
        htc = TrainerConfig(steps=HTRAIN_STEPS, **HTRAIN_CONFIG)
        tr_h = trainer_at_depth(htc, HTRAIN_LAYERS)
        hc = tr_h.cfg
        n_seg_h, seg_h, trail_h = segment_layout(hc)
        n_mamba = n_seg_h * seg_h + trail_h
        hn = count_params(tr_h.params)
        max_b = max(tr_h.cluster_spec.feasible_batches())
        # 2 bytes (bf16) + 12 (float32 master, m, v) a parameter, a float32
        # gradient tree (4 bytes a parameter) a distinct batch until
        # aggregate_host, and their float32 mean; AdamW then updates the state
        # and the parameters in place, one leaf's temporaries at a time
        reckon = {"state_gb": 14 * hn / 1e9, "grad_tree_gb": 4 * hn / 1e9,
                  "largest_b": max_b,
                  "state_and_trees_gb": (14 + 4 * max_b) * hn / 1e9,
                  "aggregation_gb": (14 + 4 * (max_b + 1)) * hn / 1e9,
                  "held_before_gb": held_h}
        print(f"[train_hybrid] {hc.name} at full width, depth {hc.n_layers} "
              f"of {get_config(htc.arch).n_layers}: {n_seg_h} segments of "
              f"{seg_h} Mamba-2 blocks and the shared block, {trail_h} "
              f"trailing; d {hc.d_model}, "
              f"{hc.ssm.expansion * hc.d_model // hc.ssm.head_dim} SSM heads "
              f"of {hc.ssm.head_dim} (state {hc.ssm.state_dim}), {hc.n_heads} "
              f"attention heads of {hc.head_dim}: {hn:,} parameters; "
              f"{HTRAIN_STEPS} steps of {HTRAIN_CONFIG}; memory reckoned "
              f"{reckon} (GB)")

        # every leaf's step-0 gradient finite; the leaves that reach the loss
        # only through the scan (a_log, dt_bias, conv_w, in_proj's x, B, C and
        # dt columns) and the shared block's wq, wk nonzero: a detached kernel
        # output would leave them at exactly 0 (not counted)
        hb0 = tr_h._device_batch(tr_h.pipeline.batch_for(0, 0, htc.n_batches))
        hloss0, hg0 = tr_h._grad_fn(tr_h.params, hb0)
        torch.cuda.synchronize()
        hleaves = tree_leaves(hg0)
        if len(hleaves) != len(tree_leaves(tr_h.params)) or not all(
                bool(torch.isfinite(g).all()) for g in hleaves):
            raise AssertionError("train_hybrid: a parameter leaf got no "
                                 "finite gradient")
        d_inner = hc.ssm.expansion * hc.d_model
        hblocks = [lp for seg in hg0["mamba_segments"] for lp in seg]
        hblocks += hg0.get("mamba_trailing", [])
        zero = []
        for j, lp in enumerate(hblocks):
            zero += [(j, n) for n in ("a_log", "dt_bias", "conv_w")
                     if not lp[n].abs().max().item() > 0]
            cols = lp["in_proj"][:, d_inner:]  # x, B, C and dt
            n_zero = int((cols.abs().amax(dim=0) == 0).sum())
            if n_zero:
                zero.append((j, f"{n_zero} in_proj x/B/C/dt columns"))
        zero += [("shared_attn", n) for n in ("wq", "wk")
                 if not hg0["shared_attn"]["attn"][n].abs().max().item() > 0]
        if zero or len(hblocks) != n_mamba:
            raise AssertionError(f"train_hybrid: zero gradients at {zero[:8]}")
        hnorms = {"a_log_block0": hblocks[0]["a_log"].norm().item(),
                  "conv_w_block0": hblocks[0]["conv_w"].norm().item(),
                  "in_proj_block0": hblocks[0]["in_proj"].norm().item(),
                  "shared_wq": hg0["shared_attn"]["attn"]["wq"].norm().item(),
                  "shared_wk": hg0["shared_attn"]["attn"]["wk"].norm().item()}
        print(f"[train_hybrid] step-0 gradients: {len(hleaves)} leaves, all "
              f"finite; every Mamba-2 block's a_log, dt_bias, conv_w and "
              f"in_proj x/B/C/dt columns and the shared wq / wk nonzero; loss "
              f"{hloss0:.4f}; norms {hnorms}")
        del hg0, hleaves, hblocks

        # FlashAttentionFn at the shared block's shape, as phase 6b holds it
        hfshape, _, hflash_errs, hflash_reading = hold_flash_fn(
            "train_hybrid", hc, htc)

        # SsdScanFn at the path's shape (x, B, C as views of one
        # activation, mild-decay dt): its forward against the plain version;
        # its seven gradients (an initial state and a final-state cotangent
        # given) against the plain backward ssd_scan_grad, in bf16 here and
        # in float32 at a smaller shape, and a second backward pass
        # bit-equal; then its times, forward, backward and forward +
        # backward (not counted)
        hrows = htc.global_batch // htc.n_batches
        sh_h = hc.ssm
        n_hh, gn = d_inner // sh_h.head_dim, sh_h.n_groups * sh_h.state_dim

        def scan_inputs(rows_, seq_, dtype, seed):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            act_ = torch.randn((rows_, seq_, d_inner + 2 * gn),
                               generator=gen, device=dev).to(dtype)
            act_[..., d_inner:] *= 0.3
            dt_ = 0.01 + 0.09 * torch.rand((rows_, seq_, n_hh),
                                           generator=gen, device=dev)
            al_ = 0.5 * torch.randn((n_hh,), generator=gen, device=dev)
            ds_ = 1.0 + 0.2 * torch.randn((n_hh,), generator=gen, device=dev)
            init_ = 0.5 * torch.randn((rows_, n_hh, sh_h.state_dim,
                                       sh_h.head_dim), generator=gen,
                                      device=dev)
            dy_ = torch.randn((rows_, seq_, n_hh, sh_h.head_dim),
                              generator=gen, device=dev).to(dtype)
            dst_ = torch.randn(init_.shape, generator=gen, device=dev)
            return act_, dt_, al_, ds_, init_, dy_, dst_

        act, hdt, halog, hds, hinit, hdy, hdst = scan_inputs(
            hrows, htc.seq_len, torch.bfloat16, 51)

        def scan_views(a):
            xs, b_, c_ = a.split([d_inner, gn, gn], dim=-1)
            lead = a.shape[:2]
            return (xs.reshape(*lead, n_hh, sh_h.head_dim),
                    b_.reshape(*lead, sh_h.n_groups, sh_h.state_dim),
                    c_.reshape(*lead, sh_h.n_groups, sh_h.state_dim))

        def scan_leaves():
            return [t.detach().clone().requires_grad_(True)
                    for t in (act, hdt, halog, hds)]

        def scan_fwd(fn, leaves):
            a, dt_, al, ds = leaves
            xs, b_, c_ = scan_views(a)
            return fn(xs, dt_, al, b_, c_, ds)

        def fn_scan(xs, dt_, al, b_, c_, ds):
            return SSD.SsdScanFn.apply(xs, dt_, al, b_, c_, ds, None,
                                       sh_h.chunk)

        def plain_scan(xs, dt_, al, b_, c_, ds):
            return SSD.ssd_scan_plain(xs, dt_, al, b_, c_, ds,
                                      chunk=sh_h.chunk)

        with torch.no_grad():
            yw, sw = scan_fwd(plain_scan, scan_leaves())
        yg, sg = scan_fwd(fn_scan, scan_leaves())
        torch.cuda.synchronize()
        ssd_fn_errs = {"y": None, "state": None}
        ssd_fn_errs["y"], ssd_fn_errs["state"], ok = ssd_err(
            yg.detach(), sg.detach(), yw, sw, "bfloat16")
        if not ok:
            raise AssertionError(f"SsdScanFn's forward differs from the plain "
                                 f"version: {ssd_fn_errs}")
        xs_shape = [hrows, htc.seq_len, n_hh, sh_h.head_dim]
        bc_shape = [hrows, htc.seq_len, sh_h.n_groups, sh_h.state_dim]
        print(f"[train_hybrid] SsdScanFn at x {xs_shape} b/c {bc_shape} bf16 "
              f"(views of one activation) against the plain version: max "
              f"|err| {ssd_fn_errs} (tolerance {SSD_TOL['bfloat16']} x (1 + "
              f"|plain|); the state {SSD_TOL['float32']})")
        del yw, sw, yg, sg

        names7 = ("x", "dt", "a_log", "b", "c", "d_skip", "initial_state")

        def hold_scan_grads(ins, tol_name):
            """SsdScanFn's seven gradients (the backward kernel) against
            ssd_scan_grad on float32 views of the same activation, within
            tol x (1 + |plain|); a second pass bit-equal.  In bf16 the
            plain backward on the bf16 views is read too, not held: it
            rounds each head's dB and dC to bf16 before the group sum over
            112 heads, which puts its dc about 0.11 of this reading from
            the float32 one.  Returns the max |err|s and the readings."""
            a0, dt0, al0, ds0, init0, dy0, dst0 = ins

            def kernel_grads():
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in (a0, dt0, al0, ds0, init0)]
                xs, b_, c_ = scan_views(leaves[0])
                y_, st_ = SSD.SsdScanFn.apply(xs, leaves[1], leaves[2], b_,
                                              c_, leaves[3], leaves[4],
                                              sh_h.chunk)
                g_ = torch.autograd.grad([y_, st_], leaves, [dy0, dst0])
                gx, gb, gc = scan_views(g_[0])
                return (gx, g_[1], g_[2], gb, gc, g_[3], g_[4])

            got = kernel_grads()
            again = kernel_grads()
            bit_equal = all(torch.equal(u, w) for u, w in zip(got, again))
            del again

            def plain_grads(a_, dy_):
                xs, b_, c_ = scan_views(a_)
                return SSD.ssd_scan_grad(xs, dt0, al0, b_, c_, ds0, init0,
                                         dy_, dst0, sh_h.chunk)

            def read(g_, w):
                diff = (g_.float() - w.float()).abs()
                return diff.max().item(), (diff / (1 + w.float().abs())
                                           ).max().item()

            want = plain_grads(a0.float(), dy0.float())
            tol = SSD_TOL[tol_name]
            errs, reading = {}, {}
            for nm, g_, w in zip(names7, got, want):
                errs[nm], reading[nm] = read(g_, w)
            if a0.dtype == torch.bfloat16:
                for nm, g_, w in zip(names7, got, plain_grads(a0, dy0)):
                    reading[f"{nm}_vs_bf16_plain"] = read(g_, w)[1]
            bad = {nm: reading[nm] for nm in names7
                   if not reading[nm] <= tol}
            if bad or not bit_equal:
                raise AssertionError(
                    f"SsdScanFn's gradients ({tol_name}) against "
                    f"ssd_scan_grad in float32: {bad} past {tol} x (1 + "
                    f"|plain|); two passes bit-equal: {bit_equal}")
            return errs, reading

        ssd_grad_errs, ssd_grad_reading = hold_scan_grads(
            (act, hdt, halog, hds, hinit, hdy, hdst), "bfloat16")
        f32_in = scan_inputs(*SSD_F32_HOLD, torch.float32, 52)
        ssd_grad_errs_f32, ssd_grad_reading_f32 = hold_scan_grads(
            f32_in, "float32")
        del f32_in
        print(f"[train_hybrid] SsdScanFn's seven gradients (the backward "
              f"kernel; an initial state and a final-state cotangent given) "
              f"against ssd_scan_grad on float32 views: bf16 at the path's "
              f"shape "
              f"max |err| { {k: round(v, 6) for k, v in ssd_grad_errs.items()} }"
              f", largest |err| / (1 + |plain|) "
              f"{ {k: round(v, 6) for k, v in ssd_grad_reading.items()} } "
              f"(tolerance {SSD_TOL['bfloat16']}); float32 at "
              f"{list(SSD_F32_HOLD)} rows x positions "
              f"{ {k: round(v, 8) for k, v in ssd_grad_reading_f32.items()} } "
              f"(tolerance {SSD_TOL['float32']}); two backward passes "
              f"bit-equal in each")

        base = [t.detach() for t in (act, hdt, halog, hds)]
        fb_leaves = scan_leaves()

        def fwd_bwd_scan(fn):
            y_, _ = scan_fwd(fn, fb_leaves)
            return torch.autograd.grad(y_, fb_leaves, hdy)

        xv, bv, cv = scan_views(act)
        with torch.no_grad():
            hs_ms = cuda_ms(lambda: scan_fwd(SSD.ssd_scan, base), 20)
            hs_plain = cuda_ms(lambda: scan_fwd(plain_scan, base), 5)
            # the backward alone: the kernel from the forward's chunk
            # states, and the plain backward
            _, _, hstates = SSD._scan(xv, hdt, halog, bv, cv, hds, None,
                                      sh_h.chunk, with_states=True)
            hbk_ms = cuda_ms(lambda: SSD._scan_grad(
                xv, hdt, halog, bv, cv, hds, None, hstates, hdy, None,
                sh_h.chunk, (True,) * 6 + (False,)), 10)
        hbk_plain = cuda_ms(lambda: SSD.ssd_scan_grad(
            xv, hdt, halog, bv, cv, hds, None, hdy, None, sh_h.chunk), 5)
        hsb_ms = cuda_ms(lambda: fwd_bwd_scan(fn_scan), 10)
        hsb_plain = cuda_ms(lambda: fwd_bwd_scan(plain_scan), 5)
        # the trainable form as it ran before the backward kernel: the
        # forward kernel, then the plain backward
        hsb_old = cuda_ms(lambda: (
            scan_fwd(SSD.ssd_scan, base),
            SSD.ssd_scan_grad(xv, hdt, halog, bv, cv, hds, None, hdy, None,
                              sh_h.chunk)), 5)
        del hstates
        hs_flops = SSD.ssd_scan_work(hrows, htc.seq_len, n_hh, sh_h.n_groups,
                                     sh_h.head_dim, sh_h.state_dim)[0]
        in_bytes = (xv.numel() + bv.numel() + cv.numel()) * 2 + nbytes(
            hdt, halog, hds)
        out_bytes = (xv.numel() * 2
                     + hrows * n_hh * sh_h.state_dim * sh_h.head_dim * 4)
        hb_flops, hb_bytes = SSD.ssd_scan_grad_work(
            hrows, htc.seq_len, n_hh, sh_h.n_groups, sh_h.head_dim,
            sh_h.state_dim)

        hs_bound, hs_by = bf16_bound(hs_flops, in_bytes + out_bytes)
        hb_bound, hb_by = bf16_bound(hb_flops, hb_bytes)
        hsb_bound, hsb_by = bf16_bound(hs_flops + hb_flops,
                                   in_bytes + out_bytes + hb_bytes)
        htrain_ssd_row = {
            "name": "ssd_scan", "case": "train_hybrid (forward; SsdScanFn)",
            "shape": [xs_shape, bc_shape], "ms": hs_ms, "plain_ms": hs_plain,
            "library_ms": None, "bound_ms": hs_bound, "bound_by": hs_by,
            "bwd_ms": hbk_ms, "bwd_plain_ms": hbk_plain,
            "bwd_library_ms": None, "bwd_bound_ms": hb_bound,
            "bwd_bound_by": hb_by,
            "fwd_bwd_ms": hsb_ms, "fwd_bwd_plain_ms": hsb_plain,
            "fwd_bwd_library_ms": None, "fwd_bwd_bound_ms": hsb_bound,
            "fwd_bwd_bound_by": hsb_by, "fwd_bwd_tensor_op_bwd_ms": hsb_old,
            "max_abs_err": ssd_fn_errs,
            "grad_max_abs_err": ssd_grad_errs,
            "grad_err_reading": ssd_grad_reading,
            "grad_max_abs_err_f32": ssd_grad_errs_f32,
            "grad_err_reading_f32": ssd_grad_reading_f32,
            "grad_f32_shape": list(SSD_F32_HOLD)}
        print(f"[train_hybrid] ssd_scan at the path's shape: forward "
              f"{hs_ms:.4f} ms (plain {hs_plain:.4f}, bound {hs_bound:.5f}); "
              f"backward kernel {hbk_ms:.4f} ms (plain backward "
              f"{hbk_plain:.4f}, bound {hb_bound:.5f}); forward + backward "
              f"through SsdScanFn {hsb_ms:.4f} ms (plain autograd "
              f"{hsb_plain:.4f}, bound {hsb_bound:.5f}; the forward kernel "
              f"and the tensor-op backward, as before the backward kernel, "
              f"{hsb_old:.4f}); no library call computes the scan")
        del act, hdt, halog, hds, hinit, hdy, hdst, base, fb_leaves, xv, bv, cv

        hres, hcounts, hwall, n_hgrads, hstep_walls, hattempts, hpeak = (
            counted_run("train_hybrid", tr_h))
        hwant = {"ssd_scan": n_mamba * n_hgrads,
                 "flash_attention": n_seg_h * n_hgrads}
        for k, n in hwant.items():
            if hcounts[k] != n:
                raise AssertionError(f"train_hybrid launched {k} "
                                     f"{hcounts[k]} times, expected {n}")
        pin_backwards("train_hybrid", hcounts)
        if not hattempts:
            raise AssertionError("train_hybrid: the tuner made no re-plan "
                                 "attempt")
        hlosses = hres.losses
        hfirst5, hlast5 = (float(np.mean(hlosses[:5])),
                           float(np.mean(hlosses[-5:])))
        if not all(np.isfinite(hlosses)) or not hlast5 < hfirst5:
            raise AssertionError(f"train_hybrid: the loss did not fall: first "
                                 f"5 {hfirst5}, last 5 {hlast5}")
        if not hpeak < 80:
            raise AssertionError(f"train_hybrid peaked at {hpeak} GB")
        hmed = statistics.median(hstep_walls)
        print(f"[train_hybrid] losses first {hlosses[0]:.5f}, last "
              f"{hlosses[-1]:.5f}; mean of the last 5 {hlast5:.5f} < mean of "
              f"the first 5 {hfirst5:.5f}: the loss falls")
        print(f"[train_hybrid] simulated time {hres.total_sim_time:.4f} s; "
              f"plan_history {hres.plan_history}; events {hres.events}; tuner "
              f"attempts (tuner step, wall s, moved B) {hattempts}")
        print(f"[train_hybrid] wall {hwall:.3f} s; median step wall "
              f"{hmed:.4f} s (min {min(hstep_walls):.4f}, max "
              f"{max(hstep_walls):.4f}); peak memory allocated {hpeak:.2f} GB "
              f"({held_h:.2f} GB of it held by earlier phases' tensors when "
              "the phase began)")
        hothers = {k: v for k, v in hcounts.items()
                   if k not in hwant and not k.endswith("_bwd")}
        print(f"[train_hybrid] launches: ssd_scan {hcounts['ssd_scan']} = "
              f"{n_mamba} Mamba-2 blocks x {n_hgrads} distinct batches, "
              f"flash_attention {hcounts['flash_attention']} = {n_seg_h} "
              f"shared applications x {n_hgrads}; their backwards "
              f"ssd_scan_bwd {hcounts['ssd_scan_bwd']}, flash_attention_bwd "
              f"{hcounts['flash_attention_bwd']}; others {hothers}")
        htrain_report = {
            "config": {**HTRAIN_CONFIG, "steps": HTRAIN_STEPS,
                       "layers": HTRAIN_LAYERS,
                       "slow_workers": {str(k): v for k, v in
                                        HTRAIN_CONFIG["slow_workers"].items()}},
            "parameters": hn, "memory_reckoning_gb": reckon,
            "step0_loss": hloss0, "step0_grad_norms": hnorms,
            "flash_fn_shape": [list(x) for x in hfshape],
            "flash_fn_max_abs_err": hflash_errs,
            "flash_fn_err_reading": hflash_reading,
            "ssd_fn_max_abs_err": ssd_fn_errs,
            "ssd_train_shape": htrain_ssd_row,
            "losses": hlosses, "sim_times": hres.sim_times,
            "total_sim_time": hres.total_sim_time,
            "plan_history": hres.plan_history, "events": hres.events,
            "tuner_attempts": hattempts, "wall_s": hwall,
            "step_walls_s": hstep_walls, "median_step_s": hmed,
            "peak_memory_gb": hpeak, "held_before_gb": held_h,
            "launches": hcounts, "distinct_batch_grads": n_hgrads}

        # train_hybrid_pins: reduced zamba2 at 4 layers and at 5 (a trailing
        # block), card against CPU through train_pins' fault and restore
        hpin = {**TRAIN_PIN_CONFIG, "arch": "zamba2-7b"}
        htrain_report["train_hybrid_pins"] = {
            n: train_pins(f"train_hybrid_pins_{n}l", hpin,
                          None if n == 4 else n)
            for n in HTRAIN_PIN_LAYERS}
        print(f"[train_hybrid] phase 6c: "
              f"{time.perf_counter() - t_htrain:.1f} s")
        report["phases"]["train_hybrid"] = htrain_report
        trainer_profiles.append(lambda: train_profile(
            "train_hybrid", tr_h, htrain_report, hmed,
            {**TRAIN_SHARES, "ssd_scan": SSD_BF16_KERNEL,
             "ssd_scan_bwd": SSD_BWD_KERNEL}))
        return htrain_ssd_row

    htrain_ssd_row = train_hybrid_phase()

    def launches(kernel: str, home: str) -> dict:
        """The kernel's launches on the path whose shapes its row times
        (``launches``) and on every path (``launches_by_path``)."""
        return {"launches": path_counts[home][kernel], "launches_path": home,
                "launches_by_path": {p: c[kernel]
                                     for p, c in path_counts.items()}}

    # -- 7. kernels -------------------------------------------------------
    _phase("kernels")

    def kernels_phase():
        """Phase 7: every kernel against its plain version at the
        paths' shapes, with its times, bound and library call.  Returns
        (kernel rows, every shape's row, phase 6e's FlashAttentionFn
        rows by key)."""

        rows = []
        extra_rows = []
        extra_rows.append(train_flash_row)

        # sojourn_cells: plan_policies' one dispatch (every cell and policy),
        # held bit-equal to the plain version on its first SOJOURN_PLAIN_JOBS
        # jobs (the plain version loops over jobs in Python); then the G=2000
        # cell alone under its two trigger policies and its two trigger-free
        # ones, the shapes of the earlier per-family dispatches
        (args, kw), = soj_calls
        arr, svc, alt, kinds, thr, hm, ng = args

        def soj_entry(tag, a_, kw, reps):
            out_k, x_k = SK.sojourn_cells(*a_, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(out_k).all():
                raise AssertionError("sojourn_cells produced non-finite "
                                     "sojourns")
            svc_ = a_[1]
            fn = lambda: SK.sojourn_cells(*a_, **kw)  # noqa: E731
            ms = cuda_ms(fn, reps)
            one_ms = call_ms(fn, reps)  # median event pair around one call
            # the profiler's time of the kernel, where one of three windows
            # records it
            for _ in range(3):
                _, _, n_ev, by_name, count = device_busy(fn, reps)
                names = [k for k in by_name if "sojourn_cells_kernel" in k]
                if names:
                    break
            dev_ms = (sum(by_name[k] / count[k] for k in names) * 1e3
                      if names else None)
            if not names:
                print(f"    (profiler: no sojourn_cells_kernel event among "
                      f"{n_ev} device events of {reps} calls: "
                      f"{sorted(by_name)})")
            chain = chain_bound_ms(a_, kw, x_k)
            nbytes_ = soj_bytes_ms(a_, out_k, x_k)
            return {
                "name": "sojourn_cells", "case": tag,
                "shape": [int(v) for v in svc_.shape] + [int(a_[3].shape[0])],
                "resolve": bool(kw.get("resolve", True)), "ms": ms,
                "call_ms": one_ms, "device_ms": dev_ms,
                "bound_ms": max(chain, nbytes_),
                "bound_by": "operations" if chain >= nbytes_ else "bytes",
                "chain_bound_ms": chain, "bytes_bound_ms": nbytes_,
                "fired": int(x_k[resolving_programs(a_, kw)].sum().item()),
                "library_ms": None}

        head = soj_entry("plan_policies dispatch", args, kw, 3)
        head.update(soj_prefix_check("plan_policies", args, kw))
        j = head["plain_jobs"]
        soj_entries = [head]
        # serving_fleet's widest dispatch (trigger-free), the same way
        (sargs, skw), = serving_widest
        serving_e = soj_entry("serving_fleet widest dispatch", sargs, skw, 3)
        serving_e.update(soj_prefix_check("serving_fleet", sargs, skw))
        sj = serving_e["plain_jobs"]
        # the same shape's launches in serving_fleet's profiled plan
        plan_ms = [d_["device_ms"] for d_ in fleet_dispatches
                   if "device_ms" in d_ and [d_["cells"], d_["jobs"],
                                             d_["groups"], d_["policies"]]
                   == serving_e["shape"]]
        serving_e["plan_device_ms"] = plan_ms
        print(f"[kernels] sojourn_cells first {sj} jobs of serving_fleet's "
              f"widest dispatch: kernel {serving_e['ms_at_plain_jobs']:.3f} "
              f"ms, plain {serving_e['plain_ms']:.1f} ms, bit-equal; the "
              f"shape's device ms in the profiled plan {plan_ms}")
        soj_entries.append(serving_e)
        widest = int(torch.argmax(ng).item())
        kind_list = kinds.tolist()
        for tag, fam in (("triggers", (1, 2)), ("trigger-free", (0, 3))):
            pidx = [i for i, kd in enumerate(kind_list) if kd in fam]
            if not pidx:
                continue
            sel = torch.tensor(pidx, device=dev)
            sub = (arr, svc[widest:widest + 1].contiguous(),
                   alt[widest:widest + 1].contiguous(),
                   kinds[sel].contiguous(),
                   thr[widest:widest + 1][:, sel].contiguous(),
                   hm[sel].contiguous(), ng[widest:widest + 1].contiguous())
            skw = {"resolve": SOPS.needs_resolve(sub[3], sub[4])}
            e = soj_entry(tag, sub, skw, 3)
            subcut = (arr[:j].contiguous(), sub[1][:, :j].contiguous(),
                      sub[2][:, :j].contiguous(), sub[3], sub[4],
                      sub[5][:, :j].contiguous(), sub[6])
            if not all(torch.equal(u, v) for u, v in zip(
                    SK.sojourn_cells(*subcut, **skw),
                    SK.sojourn_cells_plain(*subcut, **skw))):
                raise AssertionError(f"sojourn_cells ({tag}) differs from its "
                                     f"plain version")
            soj_entries.append(e)
        for e in soj_entries:
            print(f"[kernels] sojourn_cells {e['case']} C,J,G,P={e['shape']}: "
                  f"{e['ms']:.3f} ms (per call {e['call_ms']:.3f} ms, "
                  f"profiler {e['device_ms']}), chain bound "
                  f"{e['chain_bound_ms']:.4f} ms (bytes bound "
                  f"{e['bytes_bound_ms']:.4f} ms; {e['fired']} triggers "
                  "fired), bit-equal to plain")
        print(f"[kernels] sojourn_cells first {j} jobs of the plan_policies "
              f"dispatch: kernel {head['ms_at_plain_jobs']:.3f} ms, plain "
              f"{head['plain_ms']:.1f} ms; chain bound model: J x (L + 2R), "
              f"J x (L + 3R) + fired x (L + 2R) where triggers resolve, with "
              f"L {chain_cycles['sts_syncwarp_lds128']:.2f} and R "
              f"{chain_cycles['redux']:.2f} cycles at {sm_clock_mhz:.0f} MHz")
        rows.append({"name": "sojourn_cells", "route": "cuda",
                     "source": "src/repro_torch/csrc/sojourn_cells.cu",
                     "replaces": "src/repro/kernels/sojourn_sweep/kernel.py:222",
                     **launches("sojourn_cells", "plan_policies"),
                     "max_abs_err": 0.0, "ms": head["ms"],
                     "plain_ms": head["plain_ms"],
                     "bound_ms": head["bound_ms"],
                     "bound_by": head["bound_by"], "library_ms": None,
                     "shape": head["shape"], "plain_jobs": head["plain_jobs"],
                     "ms_at_plain_jobs": head["ms_at_plain_jobs"],
                     "call_ms": head["call_ms"],
                     "device_ms": head["device_ms"],
                     "chain_bound_ms": head["chain_bound_ms"],
                     "bytes_bound_ms": head["bytes_bound_ms"],
                     "bound_model": "latency chain of the longest program: J "
                                    "x (L + 2R), or J x (L + 3R) + fired x "
                                    "(L + 2R) where triggers resolve; L, R "
                                    "measured SM cycles",
                     "chain_cycles": chain_cycles,
                     "sm_clock_mhz": sm_clock_mhz,
                     "serving_fleet": serving_e,
                     "unstaged": wide_entries})
        extra_rows.extend(soj_entries)
        extra_rows.extend(wide_entries)  # phase 2b's
        # 4c's and 4d's dispatches, checked there
        extra_rows.extend(plain_checks)

        # coded_cells: the planner's shape, the fleet's cells, then long rows
        # with duplicates; beside them the launch floor, the radix passes'
        # candidates, the host's split of a call and the build's stack frames
        coded_lib = _build.load("coded_cells")

        def pass_summary(counts):
            """For each radix pass: the rows that ran it, and the mean and the
            largest count of candidates it left."""
            c = counts.reshape(-1, counts.shape[-1]).double()
            out = []
            for p_ in range(c.shape[1]):
                ran = c[:, p_] > 0
                n_ran = int(ran.sum().item())
                out.append({"rows": n_ran, "max": int(c[:, p_].max().item()),
                            "mean": c[ran, p_].mean().item() if n_ran else 0.0})
            return out

        def coded_row(times, ks, reps):
            ks_dev = ks.to(dev)
            out_k = SK.coded_cells(times, ks)
            out_p = SK.coded_cells_plain(times, ks_dev)
            if not torch.equal(out_k, out_p):
                raise AssertionError(
                    f"coded_cells differs from its plain version at "
                    f"{tuple(times.shape)}")
            fn = lambda: SK.coded_cells(times, ks)  # noqa: E731
            ms = cuda_ms(fn, reps)
            one_ms = call_ms(fn, reps)
            dev_ms = device_ms(fn, reps)
            plain_ms = cuda_ms(lambda: SK.coded_cells_plain(times, ks_dev),
                               reps)
            ks_host = ks.tolist()
            lib_ms = cuda_ms(lambda: [
                torch.kthvalue(times[c], ks_host[c], dim=1)
                for c in range(times.shape[0])], reps)
            bound_ms = nbytes(times, ks, out_k) / HBM_BYTES_PER_S * 1e3
            # the radix select's passes, recorded by the kernel, against the
            # plain version's
            r_out, counts = SK.coded_radix_counts(times, ks)
            if not (torch.equal(r_out, out_p) and torch.equal(
                    counts, SK.coded_radix_counts_plain(times, ks_dev))):
                raise AssertionError(f"coded_cells radix passes differ from "
                                     "the plain version at "
                                     f"{tuple(times.shape)}")
            entry = {"name": "coded_cells", "shape": list(times.shape),
                     "ks": ks_host, "ks_on": str(ks.device), "ms": ms,
                     "call_ms": one_ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound_ms,
                     "bound_fraction": bound_ms / dev_ms, "max_abs_err": 0.0,
                     "radix_passes": pass_summary(counts)}
            if times.shape[2] <= 64:
                # the same rows through the long-row radix path
                if not torch.equal(SK.coded_cells(times, ks, force_radix=True),
                                   out_p):
                    raise AssertionError("coded_cells radix path differs")
                rfn = lambda: SK.coded_cells(times, ks, force_radix=True)  # noqa
                entry["radix_ms"] = cuda_ms(rfn, reps)
                entry["radix_device_ms"] = device_ms(rfn, reps)
            return entry

        def coded_floor(times, ks, reps):
            """Device time and per-call events of an empty kernel launched as
            the short-row kernel is (its parameters and grid)."""
            out = torch.empty(tuple(times.shape[:2]), device=dev)
            on_host = not ks.is_cuda
            args = (times.data_ptr(), None if on_host else ks.data_ptr(),
                    ks.data_ptr() if on_host else None, out.data_ptr(), None,
                    *times.shape, 0,
                    torch._C._cuda_getCurrentRawStream(times.get_device()))

            def fn():
                _build.check(coded_lib,
                             coded_lib.coded_cells_floor_launch(*args),
                             "coded_cells floor launch")

            return device_ms(fn, reps), call_ms(fn, reps)

        def coded_host_split(times, ks, reps=2000):
            """Host microseconds a call of each step of the wrapper and the
            seam, each timed alone over ``reps`` calls (a launch enqueues only;
            the card keeps up), beside the costlier ways to take the same steps
            ("alt": full checks, a stream object, pointer objects, ``ks``
            copied to the card), and the whole calls."""
            n_c, n_t, n_w = times.shape
            tdev = times.device
            ks_np = np.asarray(ks.tolist(), dtype=np.int64)
            ks_dev = ks.to(tdev)
            out = torch.empty((n_c, n_t), device=dev)
            stream = torch._C._cuda_getCurrentRawStream(times.get_device())
            f32, i32 = torch.float32, torch.int32

            def host_us(fn):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                us = (time.perf_counter() - t0) / reps * 1e6
                torch.cuda.synchronize()
                return us

            steps = {
                "check (_coded_check)": lambda: SK._coded_check(times, ks),
                "output (new_empty)": lambda: times.new_empty((n_c, n_t)),
                "stream (raw accessor)": lambda:
                    torch._C._cuda_getCurrentRawStream(times.get_device()),
                "launch (ctypes, ks by value)": lambda:
                    coded_lib.coded_cells_launch(
                        times.data_ptr(), None, ks.data_ptr(), out.data_ptr(),
                        None, n_c, n_t, n_w, 0, stream),
                "seam: ks as a host tensor": lambda:
                    torch.from_numpy(ks_np.astype(np.int32)),
                "alt: _require x2": lambda: (
                    SK._require(times, "times", f32, (n_c, n_t, n_w), tdev),
                    SK._require(ks_dev, "ks", i32, (n_c,), tdev)),
                "alt: torch.empty": lambda: torch.empty((n_c, n_t), dtype=f32,
                                                           device=tdev),
                "alt: _stream() (a torch.cuda.Stream)": SK._stream,
                "alt: _ptr x3 (ctypes.c_void_p)": lambda: (
                    SK._ptr(times), SK._ptr(ks_dev), SK._ptr(out)),
                "alt: launch, ks on the card, via _ptr and _stream()": lambda:
                    coded_lib.coded_cells_launch(
                        SK._ptr(times), SK._ptr(ks_dev), None,
                        SK._ptr(out), None, n_c, n_t, n_w, 0, SK._stream()),
                "alt: the seam's ks copied to the card (pageable)": lambda:
                    SOPS._on(ks_np, tdev, i32),
                "call: coded_cells, ks on the host": lambda:
                    SK.coded_cells(times, ks),
                "call: coded_cells, ks on the card": lambda:
                    SK.coded_cells(times, ks_dev),
                "call: the seam coded_completion_cells": lambda:
                    SOPS.coded_completion_cells(times, ks_np),
            }
            return {k: host_us(fn) for k, fn in steps.items()}

        def stack_frames():
            """(stack frame, spill store, spill load) bytes of each coded_cells
            kernel, from ptxas -v in the build log."""
            log = _build._lib_path("coded_cells").with_suffix(
                ".log").read_text()
            named = {}
            for fn_, v in _build.stack_frames(log).items():
                m = re.search(r"(coded_[a-z_]+?kernel)(I(?:L[bi]\d+E)+E)?",
                              fn_)
                targs = re.findall(r"L[bi](\d+)E", m.group(2) or "")
                named[m.group(1) + (f"<{','.join(targs)}>" if targs else "")] = v
            return named

        planner_times, planner_ks = max(coded_calls,
                                        key=lambda c: c[0][0].numel())[0]
        e_plan = coded_row(planner_times, planner_ks, reps=50)
        e_plan["floor_device_ms"], e_plan["floor_call_ms"] = coded_floor(
            planner_times, planner_ks, 50)
        e_plan["host_split_us"] = coded_host_split(planner_times, planner_ks)
        (fleet_times, fleet_ks), = [c[0] for c in fleet_coded_calls]
        e_fleet = coded_row(fleet_times, fleet_ks, reps=10)
        e_fleet["path"] = "coded_fleet"
        e_fleet["path_wall_s"] = fwall
        g = torch.Generator(device="cpu").manual_seed(7)
        big = torch.empty((2, 2000, 10_000)).exponential_(generator=g)
        # every 7th value a copy
        big[:, :, ::7] = big[:, :, 1::7][:, :, : big[:, :, ::7].shape[2]]
        big = big.to(dev).contiguous()
        e_big = coded_row(big, torch.tensor([9000, 9988], dtype=torch.int32,
                                            device=dev), reps=10)
        frames = stack_frames()
        if any(v != (0, 0, 0) for k, v in frames.items()
               if k.startswith("coded_warp_kernel")):
            raise AssertionError(f"a short-row kernel uses local memory: "
                                 f"{frames}")
        for e in (e_plan, e_fleet, e_big):
            radix = (f"; radix path on the same rows {e['radix_ms']:.4f} ms, "
                     f"device {e['radix_device_ms']:.5f} ms"
                     if "radix_ms" in e else "")
            print(f"[kernels] coded_cells {e['shape']} ks {e['ks']} (on "
                  f"{e['ks_on']}): events {e['ms']:.4f} ms, per call "
                  f"{e['call_ms']:.4f} ms, device {e['device_ms']:.5f} "
                  f"ms{radix}; plain {e['plain_ms']:.4f} ms, kthvalue "
                  f"{e['library_ms']:.4f} ms; bound {e['bound_ms']:.5f} ms "
                  f"(bytes), {e['bound_fraction']:.3f} of it at the device "
                  f"time; bit-equal")
            print(f"    radix passes (rows that ran each, mean and largest "
                  f"candidates left): {e['radix_passes']}")
        fl = e_plan["floor_device_ms"]
        print(f"[kernels] coded_cells launch floor (an empty kernel, the "
              f"short-row kernel's parameters and grid at {e_plan['shape']}): "
              f"device {fl:.5f} ms, per call {e_plan['floor_call_ms']:.4f} "
              f"ms; the kernel's device time is "
              f"{e_plan['device_ms'] / fl:.2f}x it; bound + floor "
              f"{e_plan['bound_ms'] + fl:.5f} ms, "
              f"{(e_plan['bound_ms'] + fl) / e_plan['device_ms']:.3f} of the "
              "device time")
        print(f"[kernels] coded_cells fleet path (sweep_coded, N="
              f"{CODED_FLEET_N}): wall {fwall:.3f} s, kernel device "
              f"{e_fleet['device_ms']:.4f} ms, "
              f"{e_fleet['bound_fraction']:.3f} of its bound")
        print("[kernels] coded_cells host split at the planner's shape "
              "(us a call): " + ", ".join(
                  f"{k} {v:.2f}" for k, v in e_plan["host_split_us"].items()))
        print(f"[kernels] coded_cells build (ptxas: stack frame, spill "
              f"stores, spill loads bytes): {frames}")
        rows.append({"name": "coded_cells", "route": "cuda",
                     "source": "src/repro_torch/csrc/coded_cells.cu",
                     "replaces": "src/repro/kernels/sojourn_sweep/kernel.py:183",
                     **launches("coded_cells", "plan_coded"),
                     "max_abs_err": 0.0,
                     "ms": e_plan["ms"], "plain_ms": e_plan["plain_ms"],
                     "bound_ms": e_plan["bound_ms"], "bound_by": "bytes",
                     "library_ms": e_plan["library_ms"],
                     "shape": e_plan["shape"],
                     "radix_ms": e_plan["radix_ms"],
                     "device_ms": e_plan["device_ms"],
                     "call_ms": e_plan["call_ms"],
                     "floor_device_ms": e_plan["floor_device_ms"],
                     "fleet_device_ms": e_fleet["device_ms"],
                     "fleet_bound_ms": e_fleet["bound_ms"],
                     "stack_frames": frames})
        extra_rows.extend([e_plan, e_fleet, e_big])

        # combine: the planner's largest encode, then a square-ish GEMM
        def combine_row(a, b, reps):
            out_k = CK.combine(a, b)
            out_p = CK.combine_plain(a, b)
            bound = CK.COMBINE_RTOL * (a.double().abs() @ b.double().abs())
            err = (out_k.double() - out_p.double()).abs()
            if not bool((err <= bound).all()):
                raise AssertionError(
                    f"combine outside its bound at {tuple(a.shape)}x"
                    f"{tuple(b.shape)}: max err {err.max().item()}")
            ms = cuda_ms(lambda: CK.combine(a, b), reps)
            plain_ms = cuda_ms(lambda: CK.combine_plain(a, b),
                               max(1, reps // 10))
            lib_ms = cuda_ms(lambda: torch.matmul(a, b), reps)
            # the same two calls' device time and per-call event time, to split
            # the events time into device and host
            split = {"device_ms": device_ms(lambda: CK.combine(a, b), reps),
                     "call_ms": call_ms(lambda: CK.combine(a, b), reps),
                     "library_device_ms": device_ms(lambda: torch.matmul(a, b),
                                                    reps),
                     "library_call_ms": call_ms(lambda: torch.matmul(a, b),
                                                reps),
                     "path": "small-R" if _build.load("combine").combine_path(
                         *a.shape) == 0 else "tiled"}
            # again, after the matmul, so that clock drift shows
            ms2 = cuda_ms(lambda: CK.combine(a, b), reps)
            lib_ms2 = cuda_ms(lambda: torch.matmul(a, b), reps)
            r, k = a.shape
            d = b.shape[1]
            bound_ms = max(2.0 * r * k * d / FP32_FLOP_PER_S,
                           4.0 * (r * k + k * d + r * d) / HBM_BYTES_PER_S) * 1e3
            by = ("operations" if 2.0 * r * k * d / FP32_FLOP_PER_S
                  > 4.0 * (r * k + k * d + r * d) / HBM_BYTES_PER_S else "bytes")
            return {"name": "combine", "shape": [r, k, d], "ms": ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": by,
                    "max_abs_err": err.max().item(), **split,
                    "ms_again": ms2, "library_ms_again": lib_ms2,
                    "tflops": 2.0 * r * k * d / split["device_ms"] / 1e9}

        planner_ab = max(combine_calls,
                         key=lambda c: c[0][0].numel() * c[0][1].shape[1])[0]
        c_plan = combine_row(*planner_ab, reps=100)
        gen = torch.Generator(device="cpu").manual_seed(11)
        a = torch.randn((1024, 1024), generator=gen).to(dev)
        b = torch.randn((1024, 2048), generator=gen).to(dev)
        c_big = combine_row(a, b, reps=10)
        for e in (c_plan, c_big):
            print(f"[kernels] combine {e['shape']} ({e['path']}): events "
                  f"{e['ms']:.4f} / {e['ms_again']:.4f} ms, device "
                  f"{e['device_ms']:.4f} ms ({e['tflops']:.1f} TFLOP/s), per "
                  f"call {e['call_ms']:.4f} ms; matmul events "
                  f"{e['library_ms']:.4f} / {e['library_ms_again']:.4f} ms, "
                  f"device {e['library_device_ms']:.4f} ms, per call "
                  f"{e['library_call_ms']:.4f} ms; plain {e['plain_ms']:.4f} "
                  f"ms, bound {e['bound_ms']:.5f} ms ({e['bound_by']}), max "
                  f"err {e['max_abs_err']:.3e}")
        rows.append({"name": "combine", "route": "cuda",
                     "source": "src/repro_torch/csrc/combine.cu",
                     "replaces": "src/repro/kernels/coded/kernel.py:41",
                     **launches("combine", "plan_coded"),
                     "max_abs_err": c_plan["max_abs_err"], "ms": c_plan["ms"],
                     "plain_ms": c_plan["plain_ms"], "bound_ms": c_plan["bound_ms"],
                     "bound_by": c_plan["bound_by"],
                     "library_ms": c_plan["library_ms"],
                     "shape": c_plan["shape"],
                     "device_ms": c_plan["device_ms"],
                     "call_ms": c_plan["call_ms"]})
        extra_rows.extend([c_plan, c_big])

        # flash_attention and decode_attention at the serve phase's shapes
        import torch.nn.functional as F

        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        bf16 = torch.bfloat16
        q = att_rand((SERVE_BATCH, SERVE_PROMPT, h, hd), 21, bf16)
        k = att_rand((SERVE_BATCH, SERVE_PROMPT, kvh, hd), 22, bf16)
        v = att_rand((SERVE_BATCH, SERVE_PROMPT, kvh, hd), 23, bf16)
        flash_errs, flash_rms = {}, {}
        for dtype in (torch.float32, bf16):
            args = [t.to(dtype) for t in (q, k, v)]
            out = FA.flash_attention(*args, causal=True)
            ref = FA.flash_attention_plain(*args, causal=True)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[1]
            flash_errs[name], flash_rms[name], ok = att_err(
                "flash_attention", out, ref, name)
            if not ok:
                raise AssertionError(f"flash_attention differs from its plain "
                                     f"version in {name}: {flash_errs[name]}")
            del out, ref, args
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v, causal=True), 20)
        dev_ms = device_ms(lambda: FA.flash_attention(q, k, v, causal=True),
                           20)
        plain_ms = cuda_ms(lambda: FA.flash_attention_plain(q, k, v,
                                                            causal=True),
                           3)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        lib_ms, lib_dev = cuda_ms(sdpa, 20), device_ms(sdpa, 20)
        f_call = call_ms(lambda: FA.flash_attention(q, k, v, causal=True), 20)
        lib_call = call_ms(sdpa, 20)
        flops, f_bytes = FA.flash_attention_work(
            SERVE_BATCH, SERVE_PROMPT, k.shape[1], h, k.shape[2], hd, True,
            0, q.element_size())
        f_bound = max(flops / BF16_FLOP_PER_S, f_bytes / HBM_BYTES_PER_S) * 1e3
        f_by = ("operations" if flops / BF16_FLOP_PER_S
                > f_bytes / HBM_BYTES_PER_S else "bytes")
        f_rate = kernel_rates(flops, f_bytes, f_bound, dev_ms)
        print(f"[kernels] flash_attention q {list(q.shape)} k/v "
              f"{list(k.shape)} causal bf16: {ms:.4f} ms (device {dev_ms:.4f} "
              f"ms, per call {f_call:.4f} ms; {f_rate['tflops']:.1f} TFLOP/s, "
              f"{f_rate['bound_fraction']:.3f} of the bound), plain "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
              f"(device {lib_dev:.4f} ms, per call {lib_call:.4f} ms), bound "
              f"{f_bound:.5f} ms ({f_by}: {flops:.4g} FLOP, "
              f"{f_bytes} B); max err f32 {flash_errs['float32']:.3e}, bf16 "
              f"{flash_errs['bfloat16']:.3e} (tol {ATT_TOL}; plain output RMS "
              f"{flash_rms})")
        rows.append({"name": "flash_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
                     **launches("flash_attention", "serve"),
                     "max_abs_err": flash_errs["bfloat16"], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": f_bound,
                     "bound_by": f_by,
                     "library_ms": lib_ms,
                     "shape": [list(q.shape), list(k.shape)],
                     "max_abs_err_f32": flash_errs["float32"],
                     "plain_rms": flash_rms["bfloat16"],
                     "tolerance": ATT_TOL,
                     "device_ms": dev_ms, "library_device_ms": lib_dev,
                     "call_ms": f_call, "library_call_ms": lib_call, **f_rate})
        del q, k, v, qt, kt, vt

        # the last decode step's length
        cache_len = SERVE_PROMPT + SERVE_NEW - 1
        qd = att_rand((SERVE_BATCH, h, hd), 24, bf16)
        kc = att_rand((SERVE_BATCH, SERVE_MAX_LEN, kvh, hd), 25, bf16)
        vc = att_rand((SERVE_BATCH, SERVE_MAX_LEN, kvh, hd), 26, bf16)
        dec_errs, dec_rms = {}, {}
        for dtype in (torch.float32, bf16):
            args = [t.to(dtype) for t in (qd, kc, vc)]
            out = DA.decode_attention(*args, cache_len)
            ref = DA.decode_attention_plain(*args, cache_len)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[1]
            dec_errs[name], dec_rms[name], ok = att_err(
                "decode_attention", out, ref, name)
            if not ok:
                raise AssertionError(f"decode_attention differs from its "
                                     f"plain version in {name}: "
                                     f"{dec_errs[name]}")
            del out, ref, args
        d_ms = cuda_ms(lambda: DA.decode_attention(qd, kc, vc, cache_len), 200)
        d_dev = device_ms(lambda: DA.decode_attention(qd, kc, vc, cache_len),
                          50)
        d_plain = cuda_ms(lambda: DA.decode_attention_plain(qd, kc, vc,
                                                            cache_len), 20)
        q4 = qd[:, :, None].contiguous()
        k4, v4 = (t[:, :cache_len].transpose(1, 2).contiguous()
                  for t in (kc, vc))
        def sdpa_decode():
            return F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True)

        d_lib = cuda_ms(sdpa_decode, 200)
        d_lib_dev = device_ms(sdpa_decode, 50)
        d_call = call_ms(lambda: DA.decode_attention(qd, kc, vc, cache_len),
                         50)
        d_lib_call = call_ms(sdpa_decode, 50)
        d_flops, d_bytes = DA.decode_attention_work(
            SERVE_BATCH, h, kvh, hd, cache_len, kc.element_size())
        d_bound = max(d_flops / BF16_FLOP_PER_S,
                      d_bytes / HBM_BYTES_PER_S) * 1e3
        d_by = ("operations" if d_flops / BF16_FLOP_PER_S
                > d_bytes / HBM_BYTES_PER_S else "bytes")
        d_rate = kernel_rates(d_flops, d_bytes, d_bound, d_dev)
        print(f"[kernels] decode_attention q {list(qd.shape)} cache "
              f"{list(kc.shape)} at length {cache_len} bf16: {d_ms:.4f} ms "
              f"(one launch; device {d_dev:.4f} ms, per call {d_call:.4f} "
              f"ms; {d_rate['gbps']:.0f} GB/s, {d_rate['bound_fraction']:.3f} "
              f"of the bound), plain {d_plain:.4f} ms, SDPA {d_lib:.4f} ms "
              f"(device "
              f"{d_lib_dev:.4f} ms, per call {d_lib_call:.4f} ms), bound "
              f"{d_bound:.5f} ms ({d_by}: {d_bytes} B); max err f32 "
              f"{dec_errs['float32']:.3e} (tol {ATT_TOL['float32']}), bf16 "
              f"{dec_errs['bfloat16']:.3e} (tol {DECODE_BF16_RMS_FRAC} x "
              f"plain output RMS; RMS {dec_rms})")
        rows.append({"name": "decode_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/decode_attention.cu",
                     "replaces": "src/repro/kernels/decode_attention/kernel.py:75",
                     **launches("decode_attention", "serve"),
                     "max_abs_err": dec_errs["bfloat16"], "ms": d_ms,
                     "plain_ms": d_plain, "bound_ms": d_bound,
                     "bound_by": d_by,
                     "library_ms": d_lib,
                     "shape": [list(qd.shape), list(kc.shape), cache_len],
                     "max_abs_err_f32": dec_errs["float32"],
                     "plain_rms": dec_rms["bfloat16"],
                     "tolerance": {"float32": ATT_TOL["float32"],
                                   "bfloat16_rms_frac": DECODE_BF16_RMS_FRAC},
                     "device_ms": d_dev, "library_device_ms": d_lib_dev,
                     "call_ms": d_call, "library_call_ms": d_lib_call,
                     **d_rate})


        # flash_attention and decode_attention at other paths' shapes, next
        # to SDPA: zamba2's head dim 112 (the shared block of serve_hybrid),
        # head dim 128 at qwen2.5-14b's (40 heads over 8 KV heads) and
        # granite-34b's (48 over 1) prefill and cache, and phase 6d's:
        # olmoe's MHA, internvl2's 64 over 8 behind its patch slots,
        # whisper's non-causal encoder and cross attention (d 64) and its
        # 1,500-frame cross cache
        def print_entry(e, what):
            print(f"[kernels] {e['name']} {what} ({e['case']}) {e['shape']} "
                  f"bf16: {e['ms']:.4f} ms (device {e['device_ms']:.4f} ms, "
                  f"per call {e['call_ms']:.4f} ms; {e['tflops']:.1f} "
                  f"TFLOP/s, {e['gbps']:.0f} GB/s, {e['bound_fraction']:.3f} "
                  f"of the bound), plain {e['plain_ms']:.4f} "
                  f"ms, SDPA {e['library_ms']:.4f} ms (device "
                  f"{e['library_device_ms']:.4f} ms, per call "
                  f"{e['library_call_ms']:.4f} ms), bound "
                  f"{e['bound_ms']:.5f} ms ({e['bound_by']}); max err f32 "
                  f"{e['max_abs_err_f32']:.3e}, bf16 {e['max_abs_err']:.3e} "
                  f"(plain RMS {e['plain_rms']}); launches "
                  f"{e['launches']} on {e['case']}")

        def flash_at(path, b, sq, skv, hh, hkv, hdd, causal, seed):
            q = att_rand((b, sq, hh, hdd), seed, bf16)
            k = att_rand((b, skv, hkv, hdd), seed + 1, bf16)
            v = att_rand((b, skv, hkv, hdd), seed + 2, bf16)
            errs, rms = {}, {}
            for dtype in (torch.float32, bf16):
                args = [t.to(dtype) for t in (q, k, v)]
                name = str(dtype).split(".")[1]
                errs[name], rms[name], ok = att_err(
                    "flash_attention",
                    FA.flash_attention(*args, causal=causal),
                    FA.flash_attention_plain(*args, causal=causal), name)
                if not ok:
                    raise AssertionError(f"flash_attention d={hdd} ({path}) "
                                         f"differs from its plain version in "
                                         f"{name}: {errs[name]}")
                del args
            fn = lambda: FA.flash_attention(  # noqa: E731
                q, k, v, causal=causal)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            flops, fbytes = FA.flash_attention_work(
                b, sq, skv, hh, k.shape[2], hdd, causal, 0, q.element_size())
            flash = {"name": "flash_attention", "case": path, "head_dim": hdd,
                     "causal": causal, "shape": [list(q.shape), list(k.shape)],
                     **launches("flash_attention", path),
                     "ms": cuda_ms(fn, 10), "device_ms": device_ms(fn, 10),
                     "call_ms": call_ms(fn, 10), "library_call_ms": call_ms(lib, 10),
                     "plain_ms": cuda_ms(lambda: FA.flash_attention_plain(
                         q, k, v, causal=causal), 2),
                     "library_ms": cuda_ms(lib, 10),
                     "library_device_ms": device_ms(lib, 10),
                     "bound_ms": max(flops / BF16_FLOP_PER_S,
                                     fbytes / HBM_BYTES_PER_S) * 1e3,
                     "bound_by": ("operations" if flops / BF16_FLOP_PER_S
                                  > fbytes / HBM_BYTES_PER_S else "bytes"),
                     "max_abs_err": errs["bfloat16"],
                     "max_abs_err_f32": errs["float32"], "plain_rms": rms}
            flash.update(kernel_rates(flops, fbytes, flash["bound_ms"],
                                      flash["device_ms"]))
            print_entry(flash, f"d={hdd}" + ("" if causal else " non-causal"))
            return flash

        def decode_at(path, b, max_len, cl, hh, hkv, hdd, seed):
            qd = att_rand((b, hh, hdd), seed + 3, bf16)
            kc = att_rand((b, max_len, hkv, hdd), seed + 4, bf16)
            vc = att_rand((b, max_len, hkv, hdd), seed + 5, bf16)
            errs, rms = {}, {}
            for dtype in (torch.float32, bf16):
                args = [t.to(dtype) for t in (qd, kc, vc)]
                name = str(dtype).split(".")[1]
                errs[name], rms[name], ok = att_err(
                    "decode_attention", DA.decode_attention(*args, cl),
                    DA.decode_attention_plain(*args, cl), name)
                if not ok:
                    raise AssertionError(f"decode_attention d={hdd} ({path}) "
                                         f"differs from its plain version in "
                                         f"{name}: {errs[name]}")
                del args
            fn = lambda: DA.decode_attention(qd, kc, vc, cl)  # noqa: E731
            q4 = qd[:, :, None].contiguous()
            k4, v4 = (t[:, :cl].transpose(1, 2).contiguous() for t in (kc, vc))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, enable_gqa=True)
            dflops, dbytes = DA.decode_attention_work(
                b, hh, hkv, hdd, cl, kc.element_size())
            decode = {"name": "decode_attention", "case": path,
                      "head_dim": hdd,
                      "shape": [list(qd.shape), list(kc.shape), cl],
                      **launches("decode_attention", path),
                      "ms": cuda_ms(fn, 100), "device_ms": device_ms(fn, 50),
                      "call_ms": call_ms(fn, 50), "library_call_ms": call_ms(lib, 50),
                      "plain_ms": cuda_ms(lambda: DA.decode_attention_plain(
                          qd, kc, vc, cl), 10),
                      "library_ms": cuda_ms(lib, 100),
                      "library_device_ms": device_ms(lib, 50),
                      "bound_ms": max(dflops / BF16_FLOP_PER_S,
                                      dbytes / HBM_BYTES_PER_S) * 1e3,
                      "bound_by": ("operations" if dflops / BF16_FLOP_PER_S
                                   > dbytes / HBM_BYTES_PER_S else "bytes"),
                      "max_abs_err": errs["bfloat16"],
                      "max_abs_err_f32": errs["float32"], "plain_rms": rms}
            decode.update(kernel_rates(dflops, dbytes, decode["bound_ms"],
                                       decode["device_ms"]))
            print_entry(decode, f"d={hdd}")
            return decode

        def attention_at(path, b, plen, n_new, max_len, hh, hkv, hdd, seed):
            """Causal flash over the prompt and decode at the last step's
            length (prompt + n_new - 1)."""
            return (flash_at(path, b, plen, plen, hh, hkv, hdd, True, seed),
                    decode_at(path, b, max_len, plen + n_new - 1, hh, hkv, hdd,
                              seed))

        flash112, decode112 = attention_at(
            "serve_hybrid", HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW,
            HYBRID_MAX_LEN, hcfg.n_heads, hcfg.n_kv_heads, hcfg.head_dim, 31)
        rows[-2]["d112"] = flash112
        rows[-1]["d112"] = decode112
        extra_rows.extend([flash112, decode112])
        for i, (arch, tag, _) in enumerate(DENSE_SERVE):
            if arch == "command-r-plus-104b":
                continue  # its calls are held on the path (hold_model_calls)
            dc = dense_cfgs[arch]
            f128, d128 = attention_at(
                tag, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN,
                dc.n_heads, dc.n_kv_heads, dc.head_dim, 61 + 10 * i)
            rows[-2][f"d128_{arch}"] = f128
            rows[-1][f"d128_{arch}"] = d128
            extra_rows.extend([f128, d128])
        # phase 6d's shapes
        oc, ic = family_cfgs["serve_olmoe"], family_cfgs["serve_internvl2"]
        fam_rows = {
            "olmoe": attention_at("serve_olmoe", SERVE_BATCH, SERVE_PROMPT,
                                  SERVE_NEW, SERVE_MAX_LEN, oc.n_heads,
                                  oc.n_kv_heads, oc.head_dim, 91),
            "internvl2": attention_at("serve_internvl2", SERVE_BATCH,
                                      ic.n_patches + SERVE_PROMPT, SERVE_NEW,
                                      SERVE_MAX_LEN, ic.n_heads, ic.n_kv_heads,
                                      ic.head_dim, 101),
            "whisper": (
                flash_at("serve_whisper", SERVE_BATCH, WHISPER_FRAMES,
                         WHISPER_FRAMES, wcfg.n_heads, wcfg.n_kv_heads,
                         wcfg.head_dim, False, 111),
                decode_at("serve_whisper", SERVE_BATCH, WHISPER_MAX_LEN,
                          WHISPER_FRAMES, wcfg.n_heads, wcfg.n_kv_heads,
                          wcfg.head_dim, 111)),
            "whisper_cross": (
                flash_at("serve_whisper", SERVE_BATCH, SERVE_NEW,
                         WHISPER_FRAMES,
                         wcfg.n_heads, wcfg.n_kv_heads, wcfg.head_dim, False,
                         121), None)}
        for key, (f_e, d_e) in fam_rows.items():
            rows[-2][key] = f_e
            extra_rows.append(f_e)
            if d_e is not None:
                rows[-1][key] = d_e
                extra_rows.append(d_e)
        # phase 6e's training shapes: FlashAttentionFn forward and forward +
        # backward at whisper's non-causal encoder and cross attention and at
        # internvl2's layer (their launches are filled in after phase 6e)
        ftrain_conf = {tag: (arch, TrainerConfig(arch=arch, steps=n, **conf))
                       for arch, tag, _, conf, n in FAMILY_TRAIN}
        ftrain_flash_rows = {}
        for key, tag, causal, sq in (
                ("train_whisper", "train_whisper", False, None),
                ("train_whisper_cross", "train_whisper", False,
                 max(WHISPER_FRAMES // 8, 8)),
                ("train_internvl2", "train_internvl2", True, None)):
            arch, ftc_ = ftrain_conf[tag]
            _, (fq_, fk_, fv_, fdo_), ferrs, freading = hold_flash_fn(
                f"kernels {key}", get_config(arch), ftc_, sq=sq,
                causal=causal)
            row = flash_fn_row("kernels", key, fq_, fk_, fv_, fdo_, causal,
                               ferrs, freading)
            ftrain_flash_rows[key] = (tag, row)
            rows[-2][key] = row
            extra_rows.append(row)
            del fq_, fk_, fv_, fdo_

        # ssd_scan at serve_hybrid's shape, on mild-decay inputs (dt in
        # [0.01, 0.1]: the random model's dt = softplus(N(0, 1)) decays so fast
        # that the state carried across chunks would not be tested)
        xs_shape, bc_shape = max(ssd_shapes, key=lambda sh: sh[0][1])
        bsz, s_len, n_h, p_dim = xs_shape
        n_g, n_dim = bc_shape[2], bc_shape[3]
        gen = torch.Generator(device="cuda").manual_seed(41)
        sx = torch.randn(xs_shape, generator=gen, device=dev).to(bf16)
        sdt = 0.01 + 0.09 * torch.rand((bsz, s_len, n_h), generator=gen,
                                        device=dev)
        salog = 0.5 * torch.randn((n_h,), generator=gen, device=dev)
        sb = (0.3 * torch.randn(bc_shape, generator=gen, device=dev)).to(bf16)
        sc_ = (0.3 * torch.randn(bc_shape, generator=gen, device=dev)).to(bf16)
        sd = 1.0 + 0.2 * torch.randn((n_h,), generator=gen, device=dev)
        ssd_errs = {}
        for dtype in (torch.float32, bf16):
            args = (sx.to(dtype), sdt, salog, sb.to(dtype), sc_.to(dtype), sd)
            y_k, st_k = SSD.ssd_scan(*args)
            y_p, st_p = SSD.ssd_scan_plain(*args)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[1]
            err, serr, ok = ssd_err(y_k, st_k, y_p, st_p, name)
            if not ok:
                raise AssertionError(f"ssd_scan differs from its plain "
                                     f"version in {name}: y {err}, state "
                                     f"{serr}")
            ssd_errs[name], ssd_errs[name + "_state"] = err, serr
            del args, y_k, st_k, y_p, st_p
        fn = lambda: SSD.ssd_scan(sx, sdt, salog, sb, sc_, sd)  # noqa: E731
        s_ms = cuda_ms(fn, 20)
        s_dev = device_ms(fn, 20)
        s_call = call_ms(fn, 20)
        s_plain = cuda_ms(
            lambda: SSD.ssd_scan_plain(sx, sdt, salog, sb, sc_, sd), 3)
        # work at the reference's chunk (128): ssd_scan_work's formula
        s_flops, s_bytes = SSD.ssd_scan_work(bsz, s_len, n_h, n_g, p_dim,
                                             n_dim, sx.element_size())
        s_bound = max(s_flops / BF16_FLOP_PER_S,
                      s_bytes / HBM_BYTES_PER_S) * 1e3
        s_by = ("operations" if s_flops / BF16_FLOP_PER_S
                > s_bytes / HBM_BYTES_PER_S else "bytes")
        s_rates = kernel_rates(s_flops, s_bytes, s_bound, s_dev)
        print(f"[kernels] ssd_scan x {list(xs_shape)} b/c {list(bc_shape)} "
              f"bf16: {s_ms:.4f} ms (device {s_dev:.4f} ms, per call "
              f"{s_call:.4f} ms), plain {s_plain:.4f} ms, "
              f"no library call, bound {s_bound:.5f} ms ({s_by}: "
              f"{s_flops:.4g} FLOP, {s_bytes} B), "
              f"{s_rates['bound_fraction']:.3f} of it at the device time, "
              f"{s_rates['tflops']:.1f} TFLOP/s, {s_rates['gbps']:.0f} GB/s; "
              f"max err f32 {ssd_errs['float32']:.3e} (state "
              f"{ssd_errs['float32_state']:.3e}), bf16 "
              f"{ssd_errs['bfloat16']:.3e} (tol {SSD_TOL} x (1 + |plain|))")
        rows.append({"name": "ssd_scan", "route": "cuda",
                     "source": "src/repro_torch/csrc/ssd_scan.cu",
                     "replaces": "src/repro/kernels/ssm_scan/kernel.py:76",
                     **launches("ssd_scan", "serve_hybrid"),
                     "max_abs_err": ssd_errs["bfloat16"], "ms": s_ms,
                     "plain_ms": s_plain, "bound_ms": s_bound,
                     "bound_by": s_by,
                     "library_ms": None,
                     "shape": [list(xs_shape), list(bc_shape)],
                     "max_abs_err_f32": ssd_errs["float32"],
                     "max_abs_err_state_f32": ssd_errs["float32_state"],
                     "tolerance": SSD_TOL, "device_ms": s_dev,
                     "call_ms": s_call,
                     "flops": s_flops, "bytes": s_bytes,
                     "bound_fraction": s_rates["bound_fraction"],
                     "tflops": s_rates["tflops"], "gbps": s_rates["gbps"],
                     "max_abs_err_state_bf16": ssd_errs["bfloat16_state"]})
        del sx, sdt, sb, sc_
        # ssd_scan at train_hybrid's shape (measured in phase 6c): its forward,
        # and forward + backward through SsdScanFn
        rows[-1]["train"] = {**htrain_ssd_row,
                             **launches("ssd_scan", "train_hybrid")}
        extra_rows.append(rows[-1]["train"])
        print(f"[kernels] ssd_scan at train_hybrid's shape "
              f"{htrain_ssd_row['shape']}: forward {htrain_ssd_row['ms']:.4f} "
              f"ms (bound {htrain_ssd_row['bound_ms']:.5f}), forward + "
              f"backward {htrain_ssd_row['fwd_bwd_ms']:.4f} ms (bound "
              f"{htrain_ssd_row['fwd_bwd_bound_ms']:.5f}); launches "
              f"{rows[-1]['train']['launches']} on train_hybrid")

        # the backward kernels, at their main paths' shapes (timed in
        # phases 6b and 6c, the backward alone: from the forward's saved
        # LSE or chunk states); they replace no TPU kernel (the reference
        # differentiates XLA twins), so ``replaces`` names the TPU kernel
        # whose trainable form's backward they are
        def bwd_row(name, source, replaces, home, fwd_row, errs, tol):
            return {"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "replaces_note": "the backward of this TPU kernel's "
                                     "trainable form; the reference has no "
                                     "backward kernel",
                    **launches(name, home),
                    "max_abs_err": max(errs.values()),
                    "ms": fwd_row["bwd_ms"], "plain_ms": fwd_row["bwd_plain_ms"],
                    "bound_ms": fwd_row["bwd_bound_ms"],
                    "bound_by": fwd_row["bwd_bound_by"],
                    "library_ms": fwd_row["bwd_library_ms"],
                    "shape": fwd_row["shape"], "max_abs_errs": errs,
                    "tolerance": tol,
                    "fwd_bwd_ms": fwd_row["fwd_bwd_ms"],
                    "fwd_bwd_tensor_op_bwd_ms":
                        fwd_row["fwd_bwd_tensor_op_bwd_ms"],
                    "fwd_bwd_library_ms": fwd_row["fwd_bwd_library_ms"],
                    "fwd_bwd_bound_ms": fwd_row["fwd_bwd_bound_ms"]}

        rows.append(bwd_row(
            "flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention/kernel.py:83", "train",
            train_flash_row,
            {k: train_flash_row["max_abs_err"][k] for k in ("dq", "dk", "dv")},
            f"{ATT_TOL['bfloat16']} x (min(1, RMS) + |plain|) of the plain "
            f"version's autograd"))
        rows.append(bwd_row(
            "ssd_scan_bwd", "src/repro_torch/csrc/ssd_scan_bwd.cu",
            "src/repro/kernels/ssm_scan/kernel.py:76", "train_hybrid",
            htrain_ssd_row, htrain_ssd_row["grad_max_abs_err"],
            f"{SSD_TOL['bfloat16']} x (1 + |plain|) of ssd_scan_grad"))
        for r in rows[-2:]:
            print(f"[kernels] {r['name']} at {r['shape']}: {r['ms']:.4f} ms "
                  f"(plain backward {r['plain_ms']:.4f}, library "
                  f"{r['library_ms']}, bound {r['bound_ms']:.5f} "
                  f"({r['bound_by']})); forward + backward {r['fwd_bwd_ms']:.4f}"
                  f" ms, with the tensor-op backward "
                  f"{r['fwd_bwd_tensor_op_bwd_ms']:.4f}; max |err| "
                  f"{r['max_abs_err']:.4g}")
        return rows, extra_rows, ftrain_flash_rows

    rows, extra_rows, ftrain_flash_rows = kernels_phase()
    # the dispatches the earlier phases kept for phase 7 are done with
    for calls in (soj_calls, coded_calls, combine_calls,
                  fleet_coded_calls, serving_widest):
        calls.clear()

    # -- 4c's profiled re-plans and the trainers' profiled steps ----------
    _phase("tuner profiles")

    def run_deferred():
        """Phase 4c's profiled re-plans, then phases 6b's and 6c's profiled
        training steps; each is dropped once run, and its inputs and
        trainer with it."""
        while deferred_profiles:
            phase_, key_, tag_, fn_ = deferred_profiles.pop(0)
            report["phases"][phase_][key_] = busy_of(tag_, fn_)
        _phase("train profile")
        while trainer_profiles:
            trainer_profiles.pop(0)()

    run_deferred()

    # -- 6e. train_families: MoE, VLM, audio, xLSTM at full width -------
    import gc

    from repro_torch.models import train_loss
    from repro_torch.tree import tree_map

    SIM._GROUP_MIN_CACHE.clear()  # the sweeps' cached group minima
    t_ftrain = time.perf_counter()
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    ftrain_report = {}

    def attention_layers(cfg_):
        """Flash launches a distinct batch's backward pass makes."""
        return {"audio": 3 * cfg_.n_layers, "ssm": 0}.get(cfg_.family,
                                                          cfg_.n_layers)

    def nonzero_leaves(cfg_, g):
        """The leaves each family reaches only through its own path, whose
        step-0 gradient a detached or missing path would leave at 0."""
        if cfg_.family == "moe":
            names = [(f"blocks/{i}/moe/{n}", lp["moe"][n])
                     for i, lp in enumerate(g["blocks"])
                     for n in ("router", "wi_gate", "wi_up", "wo")]
            names += [(f"blocks/{i}/moe/shared/wi_gate",
                       lp["moe"]["shared"]["wi_gate"])
                      for i, lp in enumerate(g["blocks"])
                      if "shared" in lp["moe"]]
            names += [(f"blocks/{i}/attn/{n}", lp["attn"][n])
                      for i, lp in enumerate(g["blocks"])
                      for n in ("wq", "wk")]
        elif cfg_.family == "vlm":
            names = [("projector/w", g["projector"]["w"])]
            names += [(f"blocks/{i}/attn/{n}", lp["attn"][n])
                      for i, lp in enumerate(g["blocks"])
                      for n in ("wq", "wk")]
        elif cfg_.family == "audio":
            names = [(f"dec_blocks/{i}/cross/{n}", lp["cross"][n])
                     for i, lp in enumerate(g["dec_blocks"])
                     for n in ("wq", "wk", "wv")]
            names += [(f"enc_blocks/{i}/attn/{n}", lp["attn"][n])
                      for i, lp in enumerate(g["enc_blocks"])
                      for n in ("wq", "wk")]
            names += [("frontend", g["frontend"])]
        else:
            names = [(f"slstm_blocks/{i}/r", lp["r"])
                     for i, lp in enumerate(g["slstm_blocks"])]
            names += [(f"mlstm_segments/{i}/{j}/{n}", lp[n])
                      for i, seg in enumerate(g["mlstm_segments"])
                      for j, lp in enumerate(seg) for n in ("w_q", "w_k")]
        return names

    def bf16_spread(pin_config):
        """The CPU's own step-0 loss gap between the reduced trainer's bf16
        parameters and the same parameters in float32, on its first
        batch: the random-weight rounding spread a card-vs-CPU loss gap is
        read against."""
        host = Trainer(TrainerConfig(**pin_config), device="cpu")
        hb = host._device_batch(host.pipeline.batch_for(
            0, 0, host.tc.n_batches))
        with torch.no_grad():
            l16 = float(train_loss(host.cfg, host.params, hb)[0])
            l32 = float(train_loss(host.cfg, tree_map(
                lambda t: t.float(), host.params), hb)[0])
        return abs(l16 - l32)

    def train_family(arch, tag, depth, fconf, fsteps):
        """One family's path at full width through ``Trainer.run``: its
        memory reckoning, step-0 gradients, ``FlashAttentionFn`` at its
        shapes, the counted run with its launch pins, and its profiled
        steps.  Returns the path's report; its trainer dies on return."""
        held_f = torch.cuda.memory_allocated() / 1e9
        if tag == "train_internvl2" and not held_f < FTRAIN_START_LIMIT_GB:
            raise AssertionError(f"{tag} starts with {held_f:.2f} GB "
                                 f"allocated by earlier phases (limit "
                                 f"{FTRAIN_START_LIMIT_GB} GB)")
        ftc = TrainerConfig(arch=arch, steps=fsteps, **fconf)
        ftr = trainer_at_depth(ftc, depth)
        fc = ftr.cfg
        fn_ = count_params(ftr.params)
        max_b = (max(ftr.cluster_spec.feasible_batches()) if ftc.tuner
                 else ftc.n_batches)
        step_gb = (14 + 4 * max_b + 4) * fn_ / 1e9
        freckon = {"state_gb": 14 * fn_ / 1e9, "grad_tree_gb": 4 * fn_ / 1e9,
                   "largest_b": max_b, "step_gb": step_gb,
                   "held_before_gb": held_f, "card_gb": card_gb,
                   "spare_gb": card_gb - held_f - step_gb}
        print(f"[{tag}] {fc.name} at full width (d {fc.d_model}, "
              f"{fc.n_heads} heads / {fc.n_kv_heads} KV of {fc.head_dim}, "
              f"vocab {fc.vocab_size}), depth {fc.n_layers} of "
              f"{get_config(arch).n_layers}: {fn_:,} parameters; {fsteps} "
              f"steps of {fconf}; memory reckoned (14 B a parameter of "
              f"weights and AdamW state, 4 B a distinct batch's float32 "
              f"gradient tree at B <= {max_b}, 4 B their aggregate) "
              f"{ {k: round(v, 3) for k, v in freckon.items()} } (GB)")
        if freckon["spare_gb"] < FTRAIN_SPARE_GB:
            raise AssertionError(f"{tag}: the reckoning leaves "
                                 f"{freckon['spare_gb']:.1f} GB spare; lower "
                                 f"its global batch")

        # step-0 gradients: every leaf finite, the family's own leaves
        # nonzero; MoE: the assignments dropped past capacity, and a second
        # backward pass from the same state bit-equal (not counted)
        fb0 = ftr._device_batch(ftr.pipeline.batch_for(0, 0, ftc.n_batches))
        dropped = [0]
        o_dispatch = MOE_MODEL.dispatch

        def counting_dispatch(moe, gate_e, cap):
            out = o_dispatch(moe, gate_e, cap)
            dropped[0] += int((~out[4]).sum())
            return out

        MOE_MODEL.dispatch = counting_dispatch
        try:
            floss0, fg0 = ftr._grad_fn(ftr.params, fb0)
        finally:
            MOE_MODEL.dispatch = o_dispatch
        torch.cuda.synchronize()
        fleaves = tree_leaves(fg0)
        if len(fleaves) != len(tree_leaves(ftr.params)) or not all(
                bool(torch.isfinite(g).all()) for g in fleaves):
            raise AssertionError(f"{tag}: a parameter leaf got no finite "
                                 f"gradient")
        checked = nonzero_leaves(fc, fg0)
        zero = [n for n, g in checked if not g.abs().max().item() > 0]
        if zero:
            raise AssertionError(f"{tag}: zero step-0 gradients at "
                                 f"{zero[:8]}")
        fnorms = {n: g.norm().item() for n, g in checked[:4]}
        print(f"[{tag}] step-0 gradients: {len(fleaves)} leaves, all finite; "
              f"{len(checked)} of the family's own leaves nonzero; loss "
              f"{floss0:.4f}; norms {fnorms}")
        deterministic = None
        if fc.family == "moe":
            _, fg1 = ftr._grad_fn(ftr.params, fb0)
            diff = [i for i, (a, b) in enumerate(zip(fleaves,
                                                     tree_leaves(fg1)))
                    if not torch.equal(a, b)]
            deterministic = not diff
            del fg1
            if diff:
                raise AssertionError(f"{tag}: two backward passes from one "
                                     f"state differ at {len(diff)} leaves")
            n_assign = ((fc.n_layers - fc.moe.first_layer_dense)
                        * fb0["tokens"].numel() * fc.moe.top_k)
            print(f"[{tag}] two backward passes from one state: every "
                  f"gradient leaf bit-equal; assignments dropped past "
                  f"capacity at step 0: {dropped[0]} of {n_assign}")
        del fg0, fleaves, checked

        # FlashAttentionFn at the path's own shapes (not counted)
        flash_errs, flash_reading = {}, {}
        if fc.family == "audio":
            sd = max(ftc.seq_len // 8, 8)
            flash_errs["encoder"], flash_reading["encoder"] = hold_flash_fn(
                tag, fc, ftc, causal=False)[2:]
            flash_errs["cross"], flash_reading["cross"] = hold_flash_fn(
                tag, fc, ftc, sq=sd, causal=False)[2:]
        elif fc.family != "ssm":
            flash_errs["layer"], flash_reading["layer"] = hold_flash_fn(
                tag, fc, ftc)[2:]

        fres, fcounts, fwall, n_fgrads, fstep_walls, fattempts, fpeak = (
            counted_run(tag, ftr))
        n_attn = attention_layers(fc)
        fwant = n_attn * n_fgrads
        if fcounts["flash_attention"] != fwant:
            raise AssertionError(f"{tag} launched flash_attention "
                                 f"{fcounts['flash_attention']} times, "
                                 f"expected {n_attn} attention layers x "
                                 f"{n_fgrads} distinct batches = "
                                 f"{fwant}")
        pin_backwards(tag, fcounts)
        if ftc.tuner and not fattempts:
            raise AssertionError(f"{tag}: the tuner made no re-plan attempt")
        flosses = fres.losses
        n_avg = 5 if fsteps >= 20 else 3
        ffirst, flast = (float(np.mean(flosses[:n_avg])),
                         float(np.mean(flosses[-n_avg:])))
        if not all(np.isfinite(flosses)) or not flast < ffirst:
            raise AssertionError(f"{tag}: the loss did not fall: first "
                                 f"{n_avg} {ffirst}, last {n_avg} {flast}")
        fmed = statistics.median(fstep_walls)
        print(f"[{tag}] losses first {flosses[0]:.5f}, last "
              f"{flosses[-1]:.5f}; mean of the last {n_avg} {flast:.5f} < "
              f"mean of the first {n_avg} {ffirst:.5f}: the loss falls")
        print(f"[{tag}] simulated time {fres.total_sim_time:.4f} s; "
              f"plan_history {fres.plan_history}; events {fres.events}; "
              f"tuner attempts (tuner step, wall s, moved B) {fattempts}")
        print(f"[{tag}] wall {fwall:.3f} s; median step wall {fmed:.4f} s "
              f"(min {min(fstep_walls):.4f}, max {max(fstep_walls):.4f}); "
              f"peak memory allocated {fpeak:.2f} GB against the reckoned "
              f"{held_f + step_gb:.2f} GB ({held_f:.2f} GB of it held when "
              f"the path began)")
        others = {k: v for k, v in fcounts.items()
                  if k not in ("flash_attention", "flash_attention_bwd",
                               "sojourn_cells")}
        print(f"[{tag}] launches: flash_attention {fcounts['flash_attention']}"
              f" = {n_attn} attention layers x {n_fgrads} distinct "
              f"batches, flash_attention_bwd "
              f"{fcounts['flash_attention_bwd']}; sojourn_cells {fcounts['sojourn_cells']} (the "
              f"tuner's re-plans score a plain metric); others {others}")
        frep = {
            "config": {**fconf, "steps": fsteps, "layers": fc.n_layers,
                       "slow_workers": {str(k): v for k, v in
                                        (fconf.get("slow_workers")
                                         or {}).items()}},
            "parameters": fn_, "memory_reckoning_gb": freckon,
            "step0_loss": float(floss0), "step0_grad_norms": fnorms,
            "moe_backward_bit_equal": deterministic,
            "moe_dropped_step0": dropped[0] if fc.family == "moe" else None,
            "flash_fn_max_abs_err": flash_errs,
            "flash_fn_err_reading": flash_reading,
            "losses": flosses, "sim_times": fres.sim_times,
            "total_sim_time": fres.total_sim_time,
            "plan_history": fres.plan_history, "events": fres.events,
            "tuner_attempts": fattempts, "wall_s": fwall,
            "step_walls_s": fstep_walls, "median_step_s": fmed,
            "peak_memory_gb": fpeak, "held_before_gb": held_f,
            "launches": fcounts, "distinct_batch_grads": n_fgrads}
        # one profiled xLSTM step: two steps made 682,559 device events
        # (the sLSTM's per-position kernels), which took the profiler
        # longer to list than the steps took to run
        shares = dict(TRAIN_SHARES) if n_attn else {}
        if fc.family == "moe":  # the dispatch gathers' backward (D2)
            shares["dispatch_backward"] = "indexing_backward_kernel"
        train_profile(tag, ftr, frep, fmed, shares,
                      n_steps=1 if fc.family == "ssm" else 2)
        return frep

    for arch, tag, depth, fconf, fsteps in FAMILY_TRAIN:
        gc.collect()  # the cycles of the earlier phases' trainers
        torch.cuda.empty_cache()
        _phase(tag)
        t_path = time.perf_counter()
        frep = train_family(arch, tag, depth, fconf, fsteps)
        gc.collect()
        torch.cuda.empty_cache()

        # card against CPU, reduced, through a whole-group fault and a
        # checkpoint restore; the CPU's own bf16 spread beside the
        # tolerance
        fam = tag[len("train_"):]
        pin_cfg = {**TRAIN_PIN_CONFIG, "arch": arch}
        spread = bf16_spread(pin_cfg)
        frep["pins"] = train_pins(f"train_family_pins_{fam}", pin_cfg)
        frep["pins"]["cpu_bf16_vs_f32_step0_loss_gap"] = spread
        print(f"[train_family_pins_{fam}] card vs CPU max |loss diff| "
              f"{frep['pins']['loss_max_abs_diff']:.3e} against tolerance "
              f"{TRAIN_PIN_LOSS_TOL}; the CPU's own bf16-vs-float32 step-0 "
              f"loss gap {spread:.3e}")
        frep["wall_with_checks_s"] = time.perf_counter() - t_path
        ftrain_report[tag] = frep
        print(f"[{tag}] path with its checks and pins: "
              f"{frep['wall_with_checks_s']:.1f} s")
    for key, (tag, row) in ftrain_flash_rows.items():
        row.update(launches("flash_attention", tag))
    for row in rows:  # every path's launches, phase 6e's included
        row.update(launches(row["name"], row["launches_path"]))
    ftrain_wall = time.perf_counter() - t_ftrain
    report["phases"]["train_families"] = ftrain_report
    report["phases"]["train_families_wall_s"] = ftrain_wall
    print(f"[train_families] phase 6e: {ftrain_wall:.1f} s")

    # -- 8. dryrun: the port's dry-run, its reckoning, the paths' FLOPs --
    _phase("dryrun")
    import concurrent.futures
    import multiprocessing
    import pathlib

    from repro_torch.configs import ARCH_IDS, SHAPE_CELLS, ShapeCell
    from repro_torch.launch.dryrun import run_cell, train_memory
    from repro_torch.launch.specs import params_shapes
    from repro_torch.models import active_params
    from repro_torch.roofline import (HBM_BW, PEAK_FLOPS, count_step,
                                      hillclimb, model_flops)
    from repro_torch.roofline.op_cost import rank_ops

    def at_depth(arch, depth):
        cfg_ = get_config(arch)
        return cfg_ if depth is None else dataclasses.replace(
            cfg_, n_layers=depth)

    phases_ = report["phases"]
    train_paths = [("train", "qwen2-0.5b", None, TRAIN_CONFIG),
                   ("train_hybrid", "zamba2-7b", HTRAIN_LAYERS,
                    HTRAIN_CONFIG)]
    train_paths += [(tag, arch, depth, fconf)
                    for arch, tag, depth, fconf, _ in FAMILY_TRAIN]
    prefill_paths = [("serve", "qwen2-0.5b", None, SERVE_BATCH, SERVE_PROMPT),
                     ("serve_hybrid", "zamba2-7b", None, HYBRID_BATCH,
                      HYBRID_PROMPT)]
    prefill_paths += [
        (tag, arch, depth, SERVE_BATCH,
         SERVE_PROMPT + get_config(arch).n_patches)
        for arch, tag, depth in DENSE_SERVE + FAMILY_SERVE]

    t_dry = time.perf_counter()
    dry_dir = pathlib.Path(ROOT, "chiprun_out", "torch_dryrun")
    # the counts are CPU-bound Python on the meta device: every cell and
    # every path count runs whole in one of a pool of spawned processes,
    # one a core, in this order: the xLSTM's train counts first (six
    # counting points each, each looping its sLSTM over hundreds of
    # positions: the longest), then the cells and the other paths
    jobs = {}
    for tag, arch, depth, conf in sorted(
            train_paths, key=lambda p: p[1] != "xlstm-350m"):
        for r in sorted({r for st in step_rows[tag] for r in st},
                        reverse=True):
            jobs["train", tag, r] = (count_step, (
                at_depth(arch, depth), "train", r, conf["seq_len"]))
    for a in sorted(ARCH_IDS, key=lambda a: a != "xlstm-350m"):
        for c in SHAPE_CELLS:
            jobs["dry", a, c] = (run_cell, (a, c, False, dry_dir))
    for tag, arch, depth, pb, positions in prefill_paths:
        jobs["prefill", tag] = (count_step, (
            at_depth(arch, depth), "prefill", pb, positions))
    n_procs = min(8, os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(
            n_procs, mp_context=multiprocessing.get_context("spawn")
    ) as procs:
        futs = {key: procs.submit(fn, *args)
                for key, (fn, args) in jobs.items()}
        done = {key: f.result() for key, f in futs.items()}
    dry = [done["dry", a, c] for a in ARCH_IDS for c in SHAPE_CELLS]
    train_counts = {(k[1], k[2]): v for k, v in done.items()
                    if k[0] == "train"}
    prefill_counts = {k[1]: v for k, v in done.items() if k[0] == "prefill"}
    ok_cells = [r for r in dry if r["status"] == "ok"]
    fits = [r["cell"] for r in ok_cells if r["one_card"]["fits"]]
    dry_report = {"counts_wall_s": time.perf_counter() - t_dry,
                  "count_processes": n_procs,
                  "cells_ok": len(ok_cells), "cells": len(dry),
                  "fit_one_card": fits, "reckoning": {}, "flop_share": {},
                  "walk": {}}
    print(f"[dryrun] {len(dry)} (arch, shape) pairs on the 16 x 16 mesh "
          f"shape: {len(ok_cells)} counted, {len(dry) - len(ok_cells)} "
          f"skipped (cell_supported); {len(fits)} fit one 80 GB card "
          f"({fits}); reports in chiprun_out/torch_dryrun/; with the "
          f"paths' counts {dry_report['counts_wall_s']:.1f} s on the host "
          f"in {n_procs} processes")
    t_hc = time.perf_counter()
    hc = hillclimb.run(dry_dir, pathlib.Path(
        ROOT, "chiprun_out", "torch_perf_hillclimb.json"))
    dry_report["hillclimb"] = hc
    dry_report["hillclimb_wall_s"] = time.perf_counter() - t_hc
    print(f"[dryrun] hill-climb: {len(hc)} of its 7 cells in the dry-run's "
          f"reports (the 2 x 16 x 16 one is not written here), "
          f"{dry_report['hillclimb_wall_s']:.1f} s")

    def walk_line(tag, label, flops, walked, by_op, wall):
        """The walked roofline of one step: its terms, the whole-step
        share max(terms) / the measured wall, the five ops with the most
        walked bytes."""
        terms = {"compute_s": flops / PEAK_FLOPS,
                 "memory_s": walked / HBM_BW}
        top = rank_ops(by_op, "bytes", 5)
        share = max(terms.values()) / wall
        dry_report["walk"][tag] = {
            "flops": flops, "walked_bytes": walked, "terms": terms,
            "dominant": max(terms, key=terms.get), "wall_s": wall,
            "roofline_share": share,
            "top_ops_by_bytes": [[n, b, c] for b, n, c in top]}
        print(f"[dryrun] {tag} walked roofline ({label}): compute "
              f"{terms['compute_s']:.6f} s, memory {terms['memory_s']:.6f} s "
              f"({walked:.4g} bytes); measured {wall:.5f} s: whole-step "
              f"share {share:.4f}")
        print(f"[dryrun] {tag} top walked bytes: " + "; ".join(
            f"{n} {b:.4g} B ({c:g} calls)" for b, n, c in top))

    for tag, arch, depth, conf in train_paths:
        rep = (phases_[tag] if tag in phases_
               else phases_["train_families"][tag])
        cfg_, seq = at_depth(arch, depth), conf["seq_len"]
        steps_ = step_rows[tag]
        calls = [r for st in steps_ for r in st]
        counts = {r: train_counts[tag, r] for r in set(calls)}
        # the reckoning at the most distinct batches one step computed,
        # with the activations of its largest batch
        n_dist = max(len(st) for st in steps_)
        mem = train_memory(params_shapes(cfg_), n_dist,
                           counts[max(calls)]["activation_bytes"])
        peak, held = rep["peak_memory_gb"], rep["held_before_gb"]
        reckoned = held + mem["peak_bytes"] / 1e9
        flat = held + mem["reckoning_14_4_4"] / 1e9
        dry_report["reckoning"][tag] = {
            "peak_gb": peak, "reckoned_gb": reckoned,
            "error_gb": reckoned - peak, "peak_phase": mem["peak_phase"],
            "phases_gb": {k: held + v / 1e9
                          for k, v in mem["phases"].items()},
            "distinct_batches": n_dist, "held_before_gb": held,
            "reckoning_14_4_4_gb": flat}
        print(f"[dryrun] {tag} memory: peak {peak:.2f} GB measured; the "
              f"dry-run reckons {reckoned:.2f} GB ({mem['peak_phase']}; "
              f"{n_dist} distinct batches in a step, {held:.2f} GB held "
              f"before), error {reckoned - peak:+.2f} GB; 14 + 4 n + 4 B a "
              f"parameter there: {flat:.2f} GB ({flat - peak:+.2f})")
        n_act = active_params(cfg_)
        useful = sum(model_flops(cfg_, ShapeCell("t", seq, r, "train"),
                                 n_act) for r in calls) / len(steps_)
        counted = sum(counts[r]["flops"] for r in calls) / len(steps_)
        wall = rep["median_step_s"]
        dry_report["flop_share"][tag] = {
            "model_flops_per_step": useful, "counted_flops_per_step": counted,
            "median_step_s": wall,
            "model_flops_share": useful / wall / PEAK_FLOPS,
            "counted_flops_share": counted / wall / PEAK_FLOPS}
        print(f"[dryrun] {tag} FLOPs: model {useful:.4g} a step (6 x "
              f"{n_act:,} active parameters x the tokens of "
              f"{len(calls) / len(steps_):.2f} distinct batches), counted "
              f"{counted:.4g}; at the median step wall {wall:.4f} s "
              f"{useful / wall / PEAK_FLOPS:.4f} of the bf16 peak (counted "
              f"{counted / wall / PEAK_FLOPS:.4f})")
        # a step's walk: each backward pass's (the update's walk taken
        # out of each call's count), and the float32 cast and AdamW update
        # once: a step runs one update whatever its distinct batches
        upd = counts[max(calls)]
        by_op: dict = {}

        def add_ops(table, w):
            for name, row in table.items():
                agg = by_op.setdefault(name, {"calls": 0, "flops": 0.0,
                                              "bytes": 0.0})
                for k in agg:
                    agg[k] += w * row[k]

        for r in calls:
            add_ops(counts[r]["by_op"], 1 / len(steps_))
            add_ops(counts[r]["update_by_op"], -1 / len(steps_))
        add_ops(upd["update_by_op"], 1)
        walked = upd["update_bytes"] + sum(
            counts[r]["walked_bytes"] - counts[r]["update_bytes"]
            for r in calls) / len(steps_)
        walk_line(tag, f"a step at the median wall: "
                  f"{len(calls) / len(steps_):.2f} backward passes and one "
                  f"update of {upd['update_bytes']:.4g} B",
                  sum(counts[r]["walked_flops"] for r in calls) / len(steps_),
                  walked, by_op, wall)
        dry_report["walk"][tag]["update_bytes_per_step"] = upd[
            "update_bytes"]
        dry_report["walk"][tag]["backward_passes_per_step"] = (
            len(calls) / len(steps_))

    for tag, arch, depth, pb, positions in prefill_paths:
        cfg_ = at_depth(arch, depth)
        useful = model_flops(cfg_, ShapeCell("p", positions, pb, "prefill"),
                             active_params(cfg_))
        pc = prefill_counts[tag]
        counted = pc["flops"]
        wall = phases_[tag]["prefill_s"]
        dry_report["flop_share"][tag] = {
            "model_flops": useful, "counted_flops": counted,
            "prefill_s": wall,
            "model_flops_share": useful / wall / PEAK_FLOPS,
            "counted_flops_share": counted / wall / PEAK_FLOPS}
        print(f"[dryrun] {tag} prefill FLOPs ({cfg_.n_layers} layers, "
              f"{pb} x {positions} positions): model {useful:.4g}, counted "
              f"{counted:.4g}; at the measured {wall:.5f} s "
              f"{useful / wall / PEAK_FLOPS:.4f} of the bf16 peak (counted "
              f"{counted / wall / PEAK_FLOPS:.4f})")
        walk_line(tag, "the prefill", pc["walked_flops"], pc["walked_bytes"],
                  pc["by_op"], wall)

    # D1: the serve_hybrid prefill walk's ops outside the matmul family and
    # the hand kernels (the elementwise chains, copies, reductions and
    # indexing), beside the profiled prefill's kernels whose names hold
    # "elementwise_kernel"
    pc = prefill_counts["serve_hybrid"]
    rest = {n: row for n, row in pc["by_op"].items()
            if row["flops"] == 0 and n not in pc["kernels"]}
    rest_bytes = sum(row["bytes"] for row in rest.values())
    ew = phases_["serve_hybrid"]["busy_prefill"]["shares"]["elementwise"]
    dry_report["d1_prefill_non_matmul"] = {
        "walked_bytes": rest_bytes, "ops": len(rest),
        "prefill_walked_bytes": pc["walked_bytes"],
        "top_ops_by_bytes": [[n, b, c] for b, n, c in
                             rank_ops(rest, "bytes", 5)],
        "profiled_elementwise": ew}
    print(f"[dryrun] D1 serve_hybrid prefill ({HYBRID_BATCH} x "
          f"{HYBRID_PROMPT}), walked ops outside the matmul family and the "
          f"hand kernels: {rest_bytes:.4g} B of {pc['walked_bytes']:.4g} "
          f"walked, {rest_bytes / HBM_BW * 1e3:.3f} ms at 3.35 TB/s; top: "
          + "; ".join(f"{n} {b:.4g} B" for b, n, _ in
                      rank_ops(rest, "bytes", 5))
          + f"; the profiled prefill's elementwise_kernel kernels "
          f"{ew['device_s']:.6f} s ({ew['share']:.2%} of its device time, "
          f"{ew['events']} events)")
    # D2: olmoe's dispatch backward (the gathers' functional index_put),
    # walked a step, beside the profiled steps' indexing backward kernel
    olm = dry_report["walk"]["train_olmoe"]
    olm_steps = step_rows["train_olmoe"]
    ip = {name: sum(train_counts["train_olmoe", r]["by_op"].get(
        name, {"bytes": 0.0})["bytes"] for st in olm_steps for r in st)
        / len(olm_steps) for name in ("aten.index_put", "aten.index")}
    prof = phases_["train_families"]["train_olmoe"]["profile"]
    dsh = prof["shares"]["dispatch_backward"]
    dry_report["d2_dispatch_backward"] = {
        "walked_bytes_per_step": ip, "profiled": dsh,
        "profiled_steps": prof["steps"],
        "step_walked_bytes": olm["walked_bytes"]}
    print(f"[dryrun] D2 train_olmoe dispatch backward: walked "
          f"{ip['aten.index_put']:.4g} B a step in the gathers' backward "
          f"(index_put), {ip['aten.index']:.4g} B in their forward (index), "
          f"of {olm['walked_bytes']:.4g} B a step walked; "
          f"{ip['aten.index_put'] / HBM_BW * 1e3:.3f} ms a step at 3.35 "
          f"TB/s; profiled indexing backward {dsh['device_s']:.6f} s over "
          f"{prof['steps']} steps ({dsh['share']:.2%} of device time, "
          f"{dsh['events']} events)")
    dry_report["phase_wall_s"] = time.perf_counter() - t_dry
    report["phases"]["dryrun"] = dry_report
    print(f"[dryrun] phase 8: {dry_report['phase_wall_s']:.1f} s")

    report["kernels"] = rows
    report["kernel_shapes"] = extra_rows
    report["phase_starts_s"] = PHASE_STARTS
    report["wall_s"] = time.perf_counter() - _T0
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    print(f"[kernels] all shapes: {json.dumps(extra_rows)}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
