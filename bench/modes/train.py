"""Training traffic: the port's replication trainer (``Trainer.run``) at the
configuration's widths, in a closed loop, each step starting when the
last ends.

Set-up builds one ``Trainer`` (the model at the configuration's depth,
the AdamW state, the tuner), gives it the benchmark's weights and token
rows (from the seed) and straggler draws (from ``DRAW_SEED``, the same for
every run, so that every run trains the same B path), and runs it through
its first ``warm_steps`` steps: the first three are the start that the
reference follows from the benchmark's weights, and the tuner's first
re-plan falls among the rest.  The window is the same ``run()`` call going
on for ``--seconds``: every step from ``warm_steps`` on, ending in a
synchronize.  A traced run profiles its last ``profile_seconds``.

Once the window has closed and the memory peak is read, the program's
float32 master weights and AdamW moments are copied to the host, and the
same ``run()`` call goes on for three more steps at the B the window ran
at: the settled steps, which the reference follows from that copy.

The check, for the start and for the settled steps alike: the norm by
leaf of the stage's first gradient as AdamW got it (worked out from its
first moment, (m1 - b1 m0) / (1 - b1)), a sample of that gradient's
elements, and the norm of each leaf's change of the float32 master over
the three steps, against the float32 reference given the same weights
(and moments), rows, draws and B (``reference/replication.py`` over the
family's model).  A gap of norms is taken against the larger of the
leaf's own reference norm and the median leaf's.  Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of the
change and of the sampled error.
"""

from __future__ import annotations

import gc
import time

import harness as H
import numpy as np

CHECKED_STEPS = 3  # the steps of a stage the reference follows
STAGES = ("start", "settled")
NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's reference gradient
SAMPLE = 1 << 16  # elements of a leaf's first gradient compared one by one
SAMPLE_STREAM = 6
DRAW_SEED = 0  # the straggler draws: one B path for every run


class Feed:
    """The trainer's data feed: step i's global batch is rows of
    ``token_rows(seed, 0, i, ...)``, batch b of B its b-th slice; the
    labels are the next tokens."""

    def __init__(self, seed: int, global_batch: int, seq_len: int,
                 vocab: int):
        self.seed, self.gb, self.seq, self.vocab = (seed, global_batch,
                                                    seq_len, vocab)

    def batch_for(self, step: int, batch_id: int, n_batches: int) -> dict:
        rows = self.gb // n_batches
        full = H.token_rows(self.seed, 0, step, self.gb, self.seq + 1,
                            self.vocab)
        part = full[batch_id * rows:(batch_id + 1) * rows]
        return {"tokens": part[:, :-1], "labels": part[:, 1:]}


def draws(ctx) -> H.ServiceDraws:
    return H.ServiceDraws(DRAW_SEED, ctx.cell.traffic["service"],
                          ctx.cell.traffic["n_workers"])


def norm_gap(prog: dict, ref: dict, names) -> float:
    """The worst leaf's |prog norm - ref norm| over the larger of its
    reference norm and the median leaf's."""
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared of one stage, from the program's and the
    reference's readings (``grad``, ``change``: norms by leaf;
    ``grad_sample``: the first gradient's sampled elements by leaf)."""
    names = sorted(ref["grad"])
    med = float(np.median([ref["grad"][n] for n in names]))
    moved = [n for n in names if ref["grad"][n] >= NEGLIGIBLE_GRAD * med]
    errors = [float(np.linalg.norm(prog["grad_sample"][n]
                                   - ref["grad_sample"][n])
                    / max(np.linalg.norm(ref["grad_sample"][n]), 1e-30))
              for n in moved]
    return {
        "grad_norm_gap": norm_gap(prog["grad"], ref["grad"], names),
        "change_norm_gap": norm_gap(prog["change"], ref["change"], moved),
        "grad_error_median_leaf": float(np.median(errors)),
    }


def sample_index(ctx, leaves) -> dict:
    """Per leaf, SAMPLE element indices drawn from the seed (all of a
    smaller leaf), on the device."""
    torch = ctx.torch
    out = {}
    for i, (name, shape, _) in enumerate(sorted(leaves)):
        n = int(np.prod(shape))
        rng = np.random.default_rng(np.random.SeedSequence(
            [ctx.seed, SAMPLE_STREAM, i]))
        idx = np.arange(n) if n <= SAMPLE else rng.integers(0, n, SAMPLE)
        out[name] = torch.from_numpy(idx).to(ctx.device)
    return out


def picked(t, idx) -> np.ndarray:
    return t.detach().reshape(-1)[idx].float().cpu().numpy()


def build_trainer(ctx):
    """The port's Trainer at the configuration's depth and widths, its
    optimizer as the traffic states, with the benchmark's weights, feed and
    draws.  Returns (trainer, the weights it was given, leaves)."""
    torch = ctx.torch
    import repro_torch.launch.train as TR
    from repro_torch.optim import AdamWConfig

    conf, tr = ctx.cell.config, ctx.cell.traffic
    cfg = H.port_arch_config(conf)
    tc = TR.TrainerConfig(
        arch=cfg.name, reduced=False, steps=tr["schedule"]["total_steps"],
        seq_len=tr["seq_len"], global_batch=tr["global_batch"],
        n_workers=tr["n_workers"], n_batches=tr["n_batches"],
        lr=tr["schedule"]["lr"], warmup=tr["schedule"]["warmup"],
        seed=ctx.seed % 2**31, tuner=tr["tuner"],
        planner_mode=tr["planner_mode"], checkpoint_dir=None)
    # the trainer takes its model from the registry by name: point the
    # lookup at the configuration while it is built
    orig = TR.get_config
    TR.get_config = lambda arch: cfg
    try:
        trainer = TR.Trainer(tc, device=ctx.device)
    finally:
        TR.get_config = orig
    trainer.adamw = AdamWConfig(**tr["optimizer"], master_fp32=True)
    ref = H.reference_module(conf)
    leaves = [(n, tuple(p.shape), p.dtype)
              for n, p in H.tree_items(trainer.params)]
    missing = set(ref.leaf_names(conf)) ^ {n for n, _, _ in leaves}
    if missing:
        raise RuntimeError(f"the program's weights and the reference's "
                           f"differ: {sorted(missing)[:8]}")
    w0 = H.make_weights(ctx, leaves, ref.init_rule)
    with torch.no_grad():
        for n, p in H.tree_items(trainer.params):
            p.copy_(w0[n])
        for n, p in H.tree_items(trainer.opt_state["master"]):
            p.copy_(w0[n])
    trainer.pipeline = Feed(ctx.seed, tr["global_batch"], tr["seq_len"],
                            conf["vocab_size"])
    trainer.sim = draws(ctx)
    return trainer, w0, leaves


def host_copy(trainer) -> dict:
    """The float32 master weights and AdamW moments, copied to the host."""
    return {part: {n: t.detach().to("cpu", copy=True)
                   for n, t in H.tree_items(trainer.opt_state[part])}
            for part in ("master", "m", "v")}


def program_readings(trainer, before, idx, j, out, torch):
    """After a stage's first step (``j`` 0) its gradient as AdamW got it by
    leaf, (m1 - b1 m0) / (1 - b1), with m0 ``before["m"](name)`` (None:
    zero); after its last each leaf's change of the float32 master from
    ``before["master"](name)``."""
    b1 = trainer.adamw.b1
    with torch.no_grad():
        if j == 0:
            out["grad"], out["grad_sample"] = {}, {}
            for n, m1 in H.tree_items(trainer.opt_state["m"]):
                g = m1 if before["m"] is None else m1 - b1 * before["m"](n)
                g = g / (1 - b1)
                out["grad"][n] = float(torch.linalg.vector_norm(g))
                out["grad_sample"][n] = picked(g, idx[n])
        if j == CHECKED_STEPS - 1:
            out["change"] = {
                n: float(torch.linalg.vector_norm(p - before["master"](n)))
                for n, p in H.tree_items(trainer.opt_state["master"])}


def reference_readings(ctx, leaves, steps, batches_at, start,
                       precision="fp32") -> dict:
    """The reference's losses, first gradient and change by leaf over
    ``steps``, from ``start()`` = (float32 weights, AdamW moments or None,
    the leaf before the steps by name) and the same rows and draws."""
    torch = ctx.torch
    conf, tr = H.as_run(ctx.cell.config), ctx.cell.traffic
    ref = H.reference_module(conf)
    rep = H.load_module(H.BENCH / "reference" / "replication.py")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        weights, moments, before = start()
        feed = Feed(ctx.seed, tr["global_batch"], tr["seq_len"],
                    conf["vocab_size"])
        stream = draws(ctx)
        times = [stream.next_step() for _ in range(steps[-1] + 1)]

        def batch(i, b, n_batches):
            d = feed.batch_for(i, b, n_batches)
            return (torch.from_numpy(d["tokens"]).to(ctx.device),
                    torch.from_numpy(d["labels"]).to(ctx.device))

        idx = sample_index(ctx, leaves)
        grad_sample = {}
        losses, grad = rep.train_steps(
            lambda w, t, lab: ref.loss(conf, w, t, lab, precision),
            weights, batch, lambda i: times[i], batches_at, steps,
            tr["optimizer"], tr["schedule"], moments=moments,
            on_first_grad=lambda g: grad_sample.update(
                {n: picked(t, idx[n]) for n, t in g.items()}))
        with torch.no_grad():
            change = {n: float(torch.linalg.vector_norm(weights[n]
                                                        - before(n)))
                      for n in weights}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return {"losses": losses, "grad": grad, "change": change,
            "grad_sample": grad_sample}


def reference_starts(ctx, leaves, snap):
    """Each stage's start for the reference: the benchmark's weights from
    the seed, and the program's host copy after the window."""
    torch, dev = ctx.torch, ctx.device
    ref = H.reference_module(ctx.cell.config)

    def start():
        w0 = H.make_weights(ctx, leaves, ref.init_rule)
        weights = {n: t.to(torch.float32, copy=True) for n, t in w0.items()}
        return weights, None, lambda n: w0[n].float()

    def settled():
        weights = {n: t.to(dev, copy=True) for n, t in snap["master"].items()}
        moments = tuple({n: t.to(dev, copy=True) for n, t in snap[p].items()}
                        for p in ("m", "v"))
        return weights, moments, lambda n: snap["master"][n].to(dev)

    return {"start": start, "settled": settled}


def run(ctx) -> H.Outcome:
    torch = ctx.torch
    from repro_torch.kernels import _build

    conf, tr = ctx.cell.config, ctx.cell.traffic
    family = H.family_module(conf)
    trainer, w0, leaves = build_trainer(ctx)
    idx = sample_index(ctx, leaves)
    ctx.log(f"[{ctx.cell.name}] trainer and weights at "
            f"{time.perf_counter() - ctx.t_start:.2f} s")
    warm = tr["warm_steps"]
    if warm <= CHECKED_STEPS:
        raise ValueError("warm_steps must exceed the checked steps")
    prof = H.Profiled(torch, ctx.device) if ctx.trace else None
    if prof is not None:
        prof.warm()
    st = {"window_start": None, "deadline": None, "prof_step": None,
          "prof_t": None, "t_end": None, "settled_from": None, "peak": 0}
    entries, rows, attempts, b_at = [], [], [], {}
    prog = {s: {"losses": []} for s in STAGES}
    before = {"start": {"master": lambda n: w0[n].float(), "m": None}}
    snap = None
    o_step, o_grad, o_opt = trainer.step, trainer._grad_fn, trainer._opt_fn
    o_replan = trainer.tuner.maybe_replan

    def grad_fn(params, batch):
        rows[-1].append(int(batch["tokens"].shape[0]))
        return o_grad(params, batch)

    def opt_fn(*args):
        with torch.profiler.record_function("bench.optimizer"):
            return o_opt(*args)

    def replan():
        before_s = trainer.tuner.last_replan_seconds
        out = o_replan()
        after = trainer.tuner.last_replan_seconds
        attempts.append(0.0 if after is before_s else float(after))
        return out

    def close_window(i):
        """After step i, the window's last: its end, the trace, the memory
        peak, and the host copy the settled steps start from."""
        nonlocal snap
        H.synchronize(torch, ctx.device)
        st["t_end"] = time.perf_counter()
        if prof is not None:
            prof.stop()
        if ctx.device == "cuda":
            st["peak"] = torch.cuda.max_memory_allocated()
        t_copy = time.perf_counter()
        snap = host_copy(trainer)
        ctx.log(f"[{ctx.cell.name}] host copy of the state "
                f"{time.perf_counter() - t_copy:.2f} s")
        before["settled"] = {
            "master": lambda n: snap["master"][n].to(ctx.device),
            "m": lambda n: snap["m"][n].to(ctx.device)}
        st["settled_from"] = i + 1
        trainer.tc.steps = i + 1 + CHECKED_STEPS

    def step(i):
        nonlocal w0
        now = time.perf_counter()
        if i == warm:
            st["window_start"], st["deadline"] = now, now + ctx.seconds
        if (prof is not None and st["prof_step"] is None and i > warm
                and now >= st["deadline"] - tr["profile_seconds"]):
            H.synchronize(torch, ctx.device)
            st["prof_step"], st["prof_t"] = i, time.perf_counter()
            prof.start()
        settled = st["settled_from"]
        if settled is None:
            entries.append(now)
        b_at[i] = trainer.plan.n_batches
        rows.append([])
        out = o_step(i)
        stage, j = (("start", i) if i < CHECKED_STEPS else
                    ("settled", i - settled) if settled is not None else
                    (None, None))
        if stage is not None:
            prog[stage]["losses"].append(float(out[0]))
            program_readings(trainer, before[stage], idx, j, prog[stage],
                             torch)
            if (stage, j) == ("start", CHECKED_STEPS - 1):
                w0 = None  # the benchmark's copy of the weights goes
                before["start"] = None
        elif (i >= warm and time.perf_counter() >= st["deadline"]
              and (prof is None or (st["prof_step"] is not None
                                    and i + 1 - st["prof_step"]
                                    >= tr["profile_min_steps"]))):
            close_window(i)
        return out

    trainer.step, trainer._grad_fn, trainer._opt_fn = step, grad_fn, opt_fn
    trainer.tuner.maybe_replan = replan
    result = trainer.run()
    H.synchronize(torch, ctx.device)
    launches = _build.launch_counts()

    k, t0, t_end = st["settled_from"], st["window_start"], st["t_end"]
    walls = [b - a for a, b in zip(entries[warm:], entries[warm + 1:]
                                   + [t_end])]
    n_win = k - warm
    tokens = tr["global_batch"] * tr["seq_len"]
    settled_steps = list(range(k, k + CHECKED_STEPS))
    ctx.log(f"[{ctx.cell.name}] B path (step, B) {result.plan_history}; "
            f"{k} steps to the window's end, {n_win} in the window of "
            f"{t_end - t0:.3f} s; B of the settled steps "
            f"{[b_at[i] for i in settled_steps]}; backwards a step "
            f"{[len(r) for r in rows]}; launches {launches}; tuner "
            f"attempts (s) {[round(a, 4) for a in attempts if a]}")
    end_to_end = {
        "setup_s": t0 - ctx.t_start,
        "train_tokens_per_s": n_win * tokens / (t_end - t0),
        "train_step_ms_p90": H.quantile(walls, 0.9) * 1e3,
    }
    readings = {}
    if ctx.trace and st["prof_step"] is not None:
        p = st["prof_step"]
        calls: dict = {}
        for step_rows in rows[p:k]:
            for r in step_rows:
                for kern, c in family.kernel_calls(conf, r, tr["seq_len"],
                                                   grad=True).items():
                    calls.setdefault(kern, []).extend(c)
        readings = {
            "model_flops": (p - warm) * family.train_step_flops(
                conf, tr["global_batch"], tr["seq_len"]),
            "model_seconds": st["prof_t"] - t0,
            "tuner_seconds": sum(attempts[warm:p]),
            "tuner_steps": p - warm,
            "profiled_steps": k - p,
            "kernel_calls": calls,
        }
    trace = prof.trace if prof is not None else None
    del trainer, result, o_step, o_grad, o_opt, o_replan
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    stage_steps = {"start": list(range(CHECKED_STEPS)),
                   "settled": settled_steps}
    starts = reference_starts(ctx, leaves, snap)
    nums, control = {}, {}
    for s in STAGES:
        ref = reference_readings(ctx, leaves, stage_steps[s], b_at.get,
                                 starts[s])
        nums.update({f"{s}_{n}": v for n, v in compare(prog[s], ref).items()})
        ctx.log(f"[{ctx.cell.name}] {s} steps {stage_steps[s]} at B "
                f"{[b_at[i] for i in stage_steps[s]]}: losses "
                f"{prog[s]['losses']} against {ref['losses']}")
        if ctx.control:
            low = reference_readings(ctx, leaves, stage_steps[s], b_at.get,
                                     starts[s], "fp8")
            control.update({f"{s}_{n}": v
                            for n, v in compare(low, ref).items()})
        del ref
        gc.collect()
        if ctx.device == "cuda":
            torch.cuda.empty_cache()
    ctx.log(f"[{ctx.cell.name}] reference {time.perf_counter() - t_ref:.2f}"
            f" s; every number read (those without a limit are not "
            f"compared) {nums}")
    checks = [(name, nums[name], lim) for name, lim in ctx.cell.limits.items()]
    return H.Outcome(end_to_end, attempted=n_win, failed=0, checks=checks,
                     memory_peak_bytes=st["peak"], readings=readings,
                     trace=trace, control=control or None)
