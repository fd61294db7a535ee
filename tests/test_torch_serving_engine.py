"""The port's serving engine against the reference's, on the CPU.

Without the model (``execute_model=False``), each case builds both engines
from the same configuration (the port's through ``convert.from_reference``
with ``device="cpu"``, the reference's simulated planners on their
``pallas`` lane, interpret mode: the lane the port's sweeps are bit-equal
to) and drives both the same way.  Held bit for bit: every field of every
``RequestStats`` but the tokens, and every other entry of ``run_load`` /
``run`` — final B, policy, max_wait, shed, class stats, coding, the
master's clone / relaunch / hedge counts; and, re-plan by re-plan, the
tuner's attempts, moves and decisions, each plan's spectrum within 1e-12
relative (the spectra are bit-equal; the bound only absorbs a float64
rounding, none is expected).

The simulated planners run at ``TRIALS`` draws in both packages (the
engine's own 4,000 take minutes on the port's CPU lane, whose scan is its
plain per-job loop), except the multi-tenant swept deployment of
``benchmarks/bench_multitenant.py``, which runs as the card runs it.
``coding_candidates`` runs with the measured encode/decode overheads
replaced by constants in both packages: wall time is no parity input.

``benchmarks/bench_multitenant.py``'s headline holds on the port: the
FIFO baseline misses the premium target, the swept plan (B 2, max_wait
inf, cap 48, policy none) holds both.  Then the device rule: no card, no
engine by default; a CPU engine's re-plans and model launch no kernel.
The model's tokens are held in ``tests/test_torch_serving_model.py``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

import repro.kernels.coded as ref_coded
import repro.serving.engine as ref_engine_mod
import repro_torch.kernels.coded as port_coded
import repro_torch.serving.engine as port_engine_mod
from repro.core import simulator as RS
from repro.core.coding import CodingCandidate as RCode
from repro.core.policies import PolicyCandidate as RPol
from repro.core.policies import ShedPolicy as RShed
from repro.core.policies import SloClass as RSlo
from repro.serving import MultiTenantArrivals as RMT
from repro.serving import PoissonArrivals as RPoisson
from repro.serving import ReplicatedServingEngine as REngine
from repro.serving import ServeEngineConfig as RConfig
from repro_torch.convert import from_reference
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.serving import MultiTenantArrivals as TMT
from repro_torch.serving import PoissonArrivals as TPoisson
from repro_torch.serving import ReplicatedServingEngine as TEngine
from repro_torch.serving import ServeEngineConfig as TConfig

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import replan_log  # noqa: E402  (main() is not run)

TRIALS = 500
REL = 1e-12
CLASSES = (
    RSlo("premium", share=0.25, weight=4.0, deadline=0.8, miss_target=0.05),
    RSlo("standard", share=0.75, weight=1.0, deadline=3.0, miss_target=0.5),
)
PORTFOLIO = (RPol(), RPol("clone", quantile=0.9),
             RPol("relaunch", quantile=0.9), RPol("hedged", hedge_fraction=0.1))
BASE = dict(n_server_groups=8, n_batches=4, batch_size=4, delta=0.02,
            mu=2.0, execute_model=False, seed=0)
SWEPT = dict(  # benchmarks/bench_multitenant.py's _engine(16, swept=True)
    n_server_groups=16, n_batches=4, delta=0.02, mu=2.0, batch_size=4,
    utilization=0.95, arrival_kind="multitenant", slo_classes=CLASSES,
    execute_model=False, straggler_policy="none", seed=0,
    queue_discipline="wfq", max_wait=0.5,
    max_wait_candidates=(0.2, 0.5, math.inf),
    shed_candidates=(RShed("cap", cap=48), RShed("expired")),
    policy_candidates=(RPol(), RPol("hedged", hedge_fraction=1.0)),
    plan_initial=True, planner_mode="simulate")
FIFO = {**{k: v for k, v in SWEPT.items()
           if k not in ("max_wait_candidates", "shed_candidates",
                        "policy_candidates", "plan_initial",
                        "planner_mode")},
        "queue_discipline": "fifo"}
TUNED = dict(n_server_groups=16, n_batches=16, batch_size=4, prompt_len=16,
             gen_tokens=8, max_len=64, delta=0.02, mu=2.0, utilization=0.7,
             tuner=True, planner_mode="simulate", metric="p99",
             policy_candidates=PORTFOLIO, execute_model=False, seed=0)
TRACE = tuple(float(t) for t in np.cumsum(
    np.random.default_rng(9).gamma(0.3, 0.25, 64)))

# name -> (config, how to drive it, planner trials: None = the engine's)
CASES = {
    "static": (dict(BASE, utilization=0.7), ("load", 600), None),
    "static_mmpp": (dict(BASE, utilization=0.8, arrival_kind="mmpp",
                         seed=1), ("load", 600), None),
    "static_trace": (dict(BASE, arrival_kind="trace",
                          arrival_offsets=TRACE), ("load", 300), None),
    "rounds_tuner_analytic": (dict(BASE, n_batches=8, batch_size=1,
                                   delta=0.0005, tuner=True, seed=7),
                              ("rounds", 12), None),
    "round_remainder": (dict(BASE, batch_size=2), ("round", (10, None, 3)),
                        None),
    "tuner_analytic": (dict(BASE, n_batches=8, tuner=True, seed=2),
                       ("poisson", 1_500, 9.0), None),
    "tuner_simulate": (TUNED, ("load", 500), TRIALS),
    "tuner_simulate_clone": (dict(BASE, utilization=0.7, tuner=True,
                                  planner_mode="simulate", metric="p99",
                                  straggler_policy="clone",
                                  speculation_quantile=0.9, n_batches=8),
                             ("load", 800), TRIALS),
    "clone": (dict(BASE, n_batches=2, utilization=0.6,
                   straggler_policy="clone", speculation_quantile=0.8,
                   clone_budget=2), ("load", 600), None),
    "relaunch": (dict(BASE, n_batches=2, utilization=0.6,
                      straggler_policy="relaunch", speculation_quantile=0.8),
                 ("load", 600), None),
    "hedged": (dict(BASE, n_batches=2, utilization=0.6,
                    straggler_policy="hedged", hedge_fraction=0.5),
               ("load", 600), None),
    "relaunch_tuner": (dict(BASE, utilization=0.7, tuner=True,
                            planner_mode="simulate", metric="p99",
                            straggler_policy="relaunch",
                            speculation_quantile=0.9, n_batches=8),
                       ("load", 800), TRIALS),
    "edf_deadlines": (dict(BASE, utilization=0.9, queue_discipline="edf",
                           drop_expired=True), ("deadlines", 600), None),
    "edf_tuner": (dict(BASE, utilization=0.85, queue_discipline="edf",
                       deadline=0.6, tuner=True, planner_mode="simulate",
                       metric="p99", miss_rate_target=0.05, n_batches=8),
                  ("load", 800), TRIALS),
    "priority": (dict(BASE, utilization=0.9, queue_discipline="priority"),
                 ("priorities", 400), None),
    "multitenant_fifo": (FIFO, ("load", 4_000), None),
    "multitenant_swept": (SWEPT, ("load", 4_000), None),
    "multitenant_swept_burst": (SWEPT, ("burst", 1_000), TRIALS),
    "multitenant_tuner": (dict(SWEPT, tuner=True), ("load", 600), 300),
    "coding": (dict(BASE, utilization=0.6, planner_mode="simulate",
                    plan_initial=True, tuner=True,
                    coding_candidates=(RCode("mds", 2), RCode("mds", 4))),
               ("load", 600), TRIALS),
    "empirical_tuner": (dict(BASE, utilization=0.7, tuner=True,
                             planner_mode="empirical", metric="p99",
                             n_batches=8), ("load", 600), TRIALS),
}


def _fewer_trials(make_planner, trials):
    return lambda *a, **kw: make_planner(*a, **{**kw, "n_trials": trials})


def _overheads(c, n_workers, **kw):
    return 0.002, 0.003


def _configs(cfg):
    ref = RConfig(**cfg, sim_backend="pallas")
    port = TConfig(**{k: from_reference(v) for k, v in cfg.items()},
                   device="cpu")
    return ref, port


def _policy(p):
    return None if p is None else (p.kind, p.quantile, p.hedge_fraction)


def _decision(plan):
    if plan is None:
        return None
    return (plan.planner, plan.n_batches, _policy(plan.policy),
            plan.speculation_quantile, plan.max_wait,
            None if plan.shed is None else (plan.shed.kind, plan.shed.cap),
            None if plan.coding is None else plan.coding.describe(),
            plan.class_report, plan.confidence, plan.vote_share)


def _points(plan):
    return [(p.n_batches, p.mean, p.var, p.p99, p.p999)
            for p in plan.spectrum.points] if plan is not None else []


def _attempts(log):
    """``replan_log``'s attempts as (step, move, decision, spectrum)."""
    return [(step, None if rp is None else (rp.old_batches, rp.new_batches),
             _decision(plan), _points(plan)) for step, _, plan, rp in log]


def _drive(eng, how, Poisson, MT):
    kind = how[0]
    if kind == "load":
        return eng.run_load(how[1])
    if kind == "rounds":
        return eng.run(n_rounds=how[1])
    if kind == "round":
        stats = [s for n in how[1] for s in eng.serve_round(n)]
        return {"stats": stats, "final_B": eng.plan.n_batches,
                "clock": eng.clock}
    if kind == "poisson":
        return eng.run_load(how[1], arrivals=Poisson(rate=how[2]))
    if kind == "deadlines":
        rel = np.random.default_rng(4).uniform(0.1, 1.5, how[1])
        return eng.run_load(how[1], deadlines=rel)
    if kind == "priorities":
        prio = np.random.default_rng(5).integers(0, 4, how[1]).astype(float)
        return {"stats": eng.serve(how[1], priorities=prio)}
    proc = MT(rate=eng._request_rate(),
              classes=tuple((c.name, c.share) for c in eng.sc.slo_classes),
              diurnal_amplitude=0.3, diurnal_period=20.0, burst_rate=0.5,
              burst_size=12, burst_span=0.5)
    return eng.run_load(how[1], arrivals=proc)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def _stat(s):
    return tuple("nan" if isinstance(v, float) and math.isnan(v) else v
                 for v in (s.request_id, s.arrival, s.completion,
                           s.dispatched, s.deadline, s.dropped, s.slo))


def _same_log(got, want):
    assert len(got) == len(want)
    for (gs, gm, gd, gp), (ws, wm, wd, wp) in zip(got, want):
        assert (gs, gm, gd) == (ws, wm, wd)
        assert len(gp) == len(wp)
        for x, y in zip(gp, wp):
            assert x[0] == y[0]
            for u, v in zip(x[1:], y[1:]):
                assert u == v or math.isclose(u, v, rel_tol=REL), (x, y)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_without_the_model_is_the_references(case, monkeypatch):
    cfg, how, trials = CASES[case]
    if trials is not None:
        for mod in (ref_engine_mod, port_engine_mod):
            monkeypatch.setattr(mod, "make_planner",
                                _fewer_trials(mod.make_planner, trials))
    monkeypatch.setattr(ref_coded, "measure_coding_overhead", _overheads)
    monkeypatch.setattr(port_coded, "measure_coding_overhead", _overheads)
    RS._GROUP_MIN_CACHE.clear()
    rcfg, tcfg = _configs(cfg)
    ref, port = REngine(rcfg), TEngine(tcfg)
    assert (port.plan.n_batches, _policy(port.policy), port.max_wait) == (
        ref.plan.n_batches, _policy(ref.policy), ref.max_wait)
    logs = replan_log(ref), replan_log(port)
    want = _drive(ref, how, RPoisson, RMT)
    got = _drive(port, how, TPoisson, TMT)
    assert [_stat(s) for s in got["stats"]] == [_stat(s)
                                                for s in want["stats"]]
    for k in want:
        if k != "stats":
            assert _same(got[k], want[k]), (k, got[k], want[k])
    _same_log(_attempts(logs[1]), _attempts(logs[0]))
    assert (port.plan.n_batches, port.clock, _policy(port.policy),
            port.max_wait) == (ref.plan.n_batches, ref.clock,
                               _policy(ref.policy), ref.max_wait)
    assert (port.shed is None) == (ref.shed is None)
    if port.shed is not None:
        assert (port.shed.kind, port.shed.cap) == (ref.shed.kind,
                                                    ref.shed.cap)
    assert all(len(s.tokens) == 0 for s in got["stats"])
    if cfg.get("tuner") and case != "rounds_tuner_analytic":
        assert logs[1], "the tuner never re-planned"
    if case == "multitenant_fifo":  # bench_multitenant's baseline breach
        assert got["class_stats"]["premium"]["miss_rate"] > 0.05
    if case == "multitenant_swept":  # ... and the swept plan's headline
        assert (got["final_B"], got["max_wait"], got["shed"],
                got["policy"]) == (2, math.inf, "cap", "none")
        for c in CLASSES:
            assert got["class_stats"][c.name]["miss_rate"] <= c.miss_target


# -- the device rule --------------------------------------------------------

def test_unported_arch_raises():
    """Every arch builds now, but the engine's prefill + decode cannot
    serve whisper's batches: ``prefill`` refuses the audio family, as the
    reference's does."""
    eng = TEngine(TConfig(arch="whisper-medium", device="cpu"))
    with pytest.raises(NotImplementedError, match="audio"):
        eng._generate(torch.zeros((1, 4), dtype=torch.long))


def test_default_device_is_cuda():
    """``device=None`` means CUDA: without a card the engine refuses to
    start, whatever it would run."""
    assert TConfig().device is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(TConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(TConfig(execute_model=False, planner_mode="simulate",
                        utilization=0.5, plan_initial=True))


def test_cpu_engine_leaves_launch_counters_at_zero(monkeypatch):
    """Re-plans on sojourn_cells and the model's attention and scan run
    their plain versions on the CPU: no kernel launches."""
    monkeypatch.setattr(port_engine_mod, "make_planner", _fewer_trials(
        port_engine_mod.make_planner, 200))
    reset_launch_counts()
    for arch in ("qwen2-0.5b", "zamba2-7b"):
        eng = TEngine(_configs(dict(
            TUNED, arch=arch, execute_model=True, n_server_groups=4,
            n_batches=4, gen_tokens=3, prompt_len=8, max_len=16))[1])
        eng.tuner.config = dataclasses.replace(eng.tuner.config,
                                               min_samples=8,
                                               cooldown_steps=2)
        log = replan_log(eng)
        out = eng.run_load(80)
        assert log and all(len(s.tokens) == 3 for s in out["stats"])
    assert set(launch_counts().values()) == {0}
