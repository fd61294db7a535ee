"""Prefill traffic: batches of prompts through the port's serving driver,
``repro_torch.launch.serve.generate(..., gen_tokens=1)``, prompt to first
token, each batch into a fresh cache of ``max_len``, in a closed loop:
the next batch starts when the last one's token is back.  The load is
above what the server sustains (a batch is always waiting), so the
end-to-end metric is the prompt tokens prefilled a second.

Set-up lays out the port's parameter tree on the meta device (shapes
only), fills it with the benchmark's weights (from the seed), makes a pool
of prompt batches from the seed, and serves ``warm_batches`` other batches
at the same shape.  The window serves pool batches for ``--seconds``; a
traced run profiles its last ``profile_seconds``.

The check: ``check_batches`` whole batches (the experts' capacity couples
the prompts of a batch) drawn from the seed among the window's first
``check_span`` are kept as they are served: the last position's logits
that ``prefill`` returned, the served tokens, and what prefill wrote into
the cache at ``check_positions`` positions drawn from the seed (the
prompt's last among them; the family's ``cache_sample``).  Once the
window has closed and the program's state is freed, they run through the
float32 reference, which is compared by the mean gap by which a served
token's reference logit lies below the reference's best, the median
request's logit error, and the worst layer's cache error.
"""

from __future__ import annotations

import contextlib
import gc
import time

import harness as H
import numpy as np

PROMPT_STREAM, WARM_STREAM, SAMPLE_STREAM = 3, 4, 5


def prompts(seed, stream, n, tr, vocab, device, torch):
    """``n`` batches of prompts (n, batch, prompt_len) on the device."""
    rows = [H.token_rows(seed, stream, i, tr["batch"], tr["prompt_len"],
                         vocab) for i in range(n)]
    return torch.from_numpy(np.stack(rows)).to(device)


def build_params(ctx):
    """The port's parameter tree at the configuration's depth, each leaf a
    view of the benchmark's weights.  Returns (cfg, params, leaves)."""
    torch = ctx.torch
    from repro_torch.models import lm

    conf = ctx.cell.config
    cfg = H.port_arch_config(conf)
    ref = H.reference_module(conf)
    layout = lm._build(None, cfg, torch.device("meta"))  # shapes only
    leaves = [(n, tuple(p.shape), p.dtype) for n, p in H.tree_items(layout)]
    missing = set(ref.leaf_names(conf)) ^ {n for n, _, _ in leaves}
    if missing:
        raise RuntimeError(f"the program's weights and the reference's "
                           f"differ: {sorted(missing)[:8]}")
    w = H.make_weights(ctx, leaves, ref.init_rule)
    return cfg, H.tree_rebuild(layout, lambda n: w[n]), leaves


def check_sample(ctx):
    """The batches (indices of the window's served batches) and the cache
    positions the check compares, drawn from the seed."""
    tr = ctx.cell.traffic
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed,
                                                        SAMPLE_STREAM]))
    span = min(tr["check_span"], tr["pool_batches"])
    batches = sorted(rng.choice(span, size=tr["check_batches"],
                                replace=False).tolist())
    last = tr["prompt_len"] - 1
    positions = sorted(rng.choice(last, size=tr["check_positions"] - 1,
                                  replace=False).tolist()) + [last]
    return batches, positions


class Float32View(dict):
    """Named bf16 weights read as float32, one leaf at a time."""

    def __getitem__(self, name):
        return dict.__getitem__(self, name).float()


@contextlib.contextmanager
def captured(family, positions):
    """While ``keep["on"]`` names a served batch, keeps what the
    ``prefill`` that ``generate`` calls returns for it: its last position's
    logits (the program's own tensor) and its cache at ``positions``."""
    import repro_torch.launch.serve as SV

    orig, keep = SV.prefill, {"on": None, "got": {}}

    def prefill(*args, **kwargs):
        logits, state = orig(*args, **kwargs)
        if keep["on"] is not None:
            keep["got"][keep["on"]] = (logits,
                                       family.cache_sample(state, positions))
        return logits, state

    SV.prefill = prefill
    try:
        yield keep
    finally:
        SV.prefill = orig


def gaps(ref_logits, tokens):
    """Each row's (best reference logit - the served token's)."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, tokens.reshape(-1, 1))[:, 0]


def compare(ref, tokens, logits, ref_cache, cache) -> dict:
    """The numbers compared, over the sampled batches, from the
    reference's last-position logits and cache, the served tokens, and the
    logits and cache they were served from: the mean gap by which a served
    token's reference logit lies below the reference's best, the median
    request's logit error relative to the reference's logits, and the
    worst layer's cache error (over the sampled batches and positions,
    relative to the reference's)."""
    g = np.concatenate([gaps(r, t).cpu().numpy()
                        for r, t in zip(ref, tokens)])
    err = np.concatenate([
        ((lg.reshape(r.shape).float() - r).norm(dim=-1)
         / r.norm(dim=-1)).cpu().numpy() for r, lg in zip(ref, logits)])
    worst = 0.0
    for name in ref_cache[0]:
        diff = sum(((c[name].float() - r[name]) ** 2).flatten(1).sum(1)
                   for c, r in zip(cache, ref_cache))
        norm = sum((r[name] ** 2).flatten(1).sum(1) for r in ref_cache)
        worst = max(worst, float((diff / norm).sqrt().max()))
    return {"served_logit_gap_mean": float(g.mean()),
            "logit_error_median": float(np.median(err)),
            "cache_error_worst_layer": worst}


def reference_prefill(ctx, leaves, batches, positions, precision="fp32"):
    """The reference's last-position logits and cache sample of each batch
    of prompts."""
    torch = ctx.torch
    conf = H.as_run(ctx.cell.config)
    ref = H.reference_module(conf)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        w = Float32View(H.make_weights(ctx, leaves, ref.init_rule))
        with torch.no_grad():
            out = [ref.prefill(conf, w, b, positions, precision)
                   for b in batches]
        return [lo for lo, _ in out], [c for _, c in out]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def run(ctx) -> H.Outcome:
    torch = ctx.torch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate

    conf, tr = ctx.cell.config, ctx.cell.traffic
    family = H.family_module(conf)
    cfg, params, leaves = build_params(ctx)
    vocab = conf["vocab_size"]
    pool = prompts(ctx.seed, PROMPT_STREAM, tr["pool_batches"], tr, vocab,
                   ctx.device, torch)
    warm = prompts(ctx.seed, WARM_STREAM, tr["warm_batches"], tr, vocab,
                   ctx.device, torch)
    picks, positions = check_sample(ctx)
    pick_set = set(picks)
    at = torch.tensor(positions, device=ctx.device)
    ctx.log(f"[{ctx.cell.name}] weights and prompts at "
            f"{time.perf_counter() - ctx.t_start:.2f} s")

    def serve(batch):
        return generate(cfg, params, batch, 1, tr["max_len"]).tokens[:, 0]

    prof = H.Profiled(torch, ctx.device) if ctx.trace else None
    with captured(family, at) as keep:
        for b in warm:
            serve(b)
        if prof is not None:
            prof.warm()
        served, prof_at = [], None
        H.synchronize(torch, ctx.device)
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while True:
            now = time.perf_counter()
            if now >= deadline and (prof_at is None or len(served)
                                    - prof_at[0] >= tr["profile_min_batches"]):
                break
            if (prof is not None and prof_at is None and served
                    and now >= deadline - tr["profile_seconds"]):
                prof_at = (len(served), now)
                prof.start()
            j = len(served)
            keep["on"] = j if j in pick_set else None
            served.append(serve(pool[j % len(pool)]))
        keep["on"] = None
        H.synchronize(torch, ctx.device)
        t_end = time.perf_counter()
    if prof_at is not None:
        prof.stop()
    n = len(served)
    ctx.log(f"[{ctx.cell.name}] {n} batches of {tr['batch']} x "
            f"{tr['prompt_len']} in {t_end - t0:.3f} s; launches "
            f"{_build.launch_counts()}")
    end_to_end = {"setup_s": t0 - ctx.t_start,
                  "prefill_tokens_per_s": (n * tr["batch"] * tr["prompt_len"]
                                           / (t_end - t0))}
    readings = {}
    if prof_at is not None:
        k, t_k = prof_at
        readings = {
            "model_flops": k * family.prefill_flops(conf, tr["batch"],
                                                    tr["prompt_len"]),
            "model_seconds": t_k - t0,
            "kernel_calls": family.kernel_calls(
                conf, tr["batch"], tr["prompt_len"], grad=False,
                count=n - k),
        }
    peak = (torch.cuda.max_memory_allocated() if ctx.device == "cuda"
            else 0)

    done = [j for j in picks if j < n]
    batches = [pool[j] for j in done]
    tokens = [served[j] for j in done]
    logits = [keep["got"][j][0] for j in done]
    cache = [keep["got"][j][1] for j in done]
    del params, pool, warm, served, keep
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_logits, ref_cache = reference_prefill(ctx, leaves, batches, positions)
    nums = compare(ref_logits, tokens, logits, ref_cache, cache)
    ctx.log(f"[{ctx.cell.name}] reference over served batches {done}: "
            f"{time.perf_counter() - t_ref:.2f} s")
    control = None
    if ctx.control:
        low, low_cache = reference_prefill(ctx, leaves, batches, positions,
                                           "fp8")
        control = compare(ref_logits, [lo.argmax(dim=-1) for lo in low],
                          low, ref_cache, low_cache)
    checks = [(k, nums[k], lim) for k, lim in ctx.cell.limits.items()]
    return H.Outcome(end_to_end, attempted=n * tr["batch"], failed=0,
                     checks=checks, memory_peak_bytes=peak,
                     readings=readings,
                     trace=prof.trace if prof is not None else None,
                     control=control)
