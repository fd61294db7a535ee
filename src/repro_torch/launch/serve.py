"""Batched serving of the port, on the attention kernels.

As ``repro.launch.serve``: (a) run prefill + greedy decode on a model to
produce tokens (:func:`generate`, which goes through the
``flash_attention`` and ``decode_attention`` kernels on the card, and for
the hybrid family, ``--arch zamba2-7b``, through ``ssd_scan`` too; every
arch but whisper's, whose ``prefill`` the reference refuses too), and
(b) score a fleet of N server groups under the shifted-exponential
straggler model, as batch-completion latency across B
(``sweep_simulated``) and as per-request sojourn under Poisson arrivals
through the load-aware ``SimulatedPlanner`` with the straggler-policy
portfolio (the ``sojourn_cells`` kernel on the card).

Weights come from a seeded ``torch.Generator`` and prompts from a second
one, so the generated tokens differ from the reference's (JAX keys); the
fleet half draws from numpy at the reference's seeds.

Run on the card:  PYTHONPATH=src python -m repro_torch.launch.serve
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_config, reduced_config
from ..configs.base import ArchConfig
from ..core.order_stats import ShiftedExponential
from ..core.planner import ClusterSpec, Objective, SimulatedPlanner
from ..core.policies import PolicyCandidate
from ..core.spectrum import sweep_simulated
from ..device import resolve_device
from ..models import decode_step, init_params, prefill

__all__ = ["ServeConfig", "Generation", "generate", "run_serving", "main"]


@dataclasses.dataclass
class ServeConfig:
    arch: str = "qwen2-0.5b"
    batch: int = 4
    prompt_len: int = 32
    gen_tokens: int = 16
    max_len: int = 128
    seed: int = 0
    # latency sim
    n_servers: int = 16
    delta: float = 0.05
    mu: float = 20.0
    # offered load for the queueing-aware (sojourn) sweep
    utilization: float = 0.7
    # straggler-policy portfolio offered to the load-aware planner: clone /
    # relaunch triggers at these late-quantiles plus hedged dispatch at
    # these tail fractions (a plain-replication 'none' candidate is always
    # in the race)
    speculation_quantiles: tuple[float, ...] = (0.8, 0.9, 0.95)
    hedge_fractions: tuple[float, ...] = (0.1, 0.3)

    def policy_candidates(self) -> tuple[PolicyCandidate, ...]:
        return (
            *(PolicyCandidate("clone", quantile=q)
              for q in self.speculation_quantiles),
            *(PolicyCandidate("relaunch", quantile=q)
              for q in self.speculation_quantiles),
            *(PolicyCandidate("hedged", hedge_fraction=f)
              for f in self.hedge_fractions),
        )


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor  # (b, gen_tokens) int64, on the model's device
    prefill_s: float  # prompt -> first token, synchronised
    decode_s: float  # the gen_tokens - 1 decode steps, synchronised


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg: ArchConfig, params, prompts, gen_tokens: int,
             max_len: int, patch_embeds=None) -> Generation:
    """Greedy generation: prefill the prompts (b, s), then
    ``gen_tokens - 1`` decode steps, each token the first argmax of the
    bfloat16 logits.  Runs on the device the parameters live on.  The vlm
    family takes ``patch_embeds`` (b, n_patches, frontend_dim), which sit
    ahead of the prompt: decode continues at position n_patches + s."""
    if gen_tokens < 1:
        raise ValueError("gen_tokens must be >= 1")
    dev = params["embed"]["tokens"].device
    prompts = torch.as_tensor(prompts, device=dev).long()
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["patch_embeds"] = patch_embeds
    s = prompts.shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    if s + gen_tokens - 1 > max_len:
        raise ValueError(f"{s} + {gen_tokens} - 1 positions exceed max_len "
                         f"{max_len}")
    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill(cfg, params, batch, max_len)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen_tokens - 1):
        logits, state = decode_step(cfg, params, state, tok, s + i)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        out.append(tok)
    _sync(dev)
    return Generation(torch.cat(out, dim=1), prefill_s,
                      time.perf_counter() - t0)


def run_serving(sc: ServeConfig, device=None):
    """Serve ``sc.batch`` prompts on the reduced config of ``sc.arch`` and
    score the fleet; ``device=None`` means CUDA.  The vlm family's patch
    embeddings are drawn after the prompts from the prompts' generator (the
    reference draws them from the prompts' key); the audio family raises
    ``NotImplementedError``, as the reference's does (``prefill``)."""
    dev = resolve_device(device)
    cfg = reduced_config(get_config(sc.arch))
    params = init_params(torch.Generator(device=dev).manual_seed(sc.seed),
                         cfg, dev)
    gen_p = torch.Generator(device=dev).manual_seed(sc.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (sc.batch, sc.prompt_len),
                            device=dev, generator=gen_p)
    patch_embeds = None
    if cfg.family == "vlm":
        patch_embeds = torch.randn(
            (sc.batch, cfg.n_patches, cfg.frontend_dim), device=dev,
            generator=gen_p)
    gen = generate(cfg, params, prompts, sc.gen_tokens, sc.max_len,
                   patch_embeds)

    # latency across the diversity-parallelism spectrum: ONE batched CRN
    # sweep, then the queueing twin through the load-aware planner
    dist = ShiftedExponential(delta=sc.delta, mu=sc.mu)
    res = sweep_simulated(dist, sc.n_servers, n_trials=20_000, seed=7,
                          device=dev)
    lat = {p.n_batches: {"mean": p.mean, "p99": p.p99} for p in res.points}
    spec = ClusterSpec(n_workers=sc.n_servers, dist=dist)
    plan = SimulatedPlanner(n_trials=20_000, seed=7, device=dev).plan(
        spec,
        Objective(metric="p99", utilization=sc.utilization,
                  policies=sc.policy_candidates()),
    )
    sojourn = {
        p.n_batches: {"mean": p.mean, "p99": p.p99, "p999": p.p999}
        for p in plan.spectrum.points
    }
    return {
        "generated": gen.tokens.cpu().numpy(),
        "prefill_s": gen.prefill_s,
        "decode_s": gen.decode_s,
        "latency_by_B": lat,
        "sojourn_by_B": sojourn,
        "sojourn_best_B": plan.n_batches,
        "policy": plan.policy,
        "speculation_quantile": plan.speculation_quantile,
        "speculative_p99": plan.score,
        "backend": plan.backend,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run_serving(ServeConfig(arch=args.arch, gen_tokens=args.tokens,
                                  batch=args.batch), device=args.device)
    print(f"[{out['backend']}] prefill {out['prefill_s']*1e3:.1f}ms, "
          f"decode {out['decode_s']*1e3:.1f}ms for {args.tokens} tokens")
    print("generated tokens[0,:8]:", out["generated"][0, :8])
    print("batch-latency vs B (simulated fleet):")
    for b, d in out["latency_by_B"].items():
        print(f"  B={b:3d}  mean={d['mean']*1e3:7.2f}ms  "
              f"p99={d['p99']*1e3:7.2f}ms")
    print("request sojourn vs B (Poisson arrivals; best policy per B):")
    for b, d in out["sojourn_by_B"].items():
        print(f"  B={b:3d}  mean={d['mean']*1e3:7.2f}ms  "
              f"p99={d['p99']*1e3:7.2f}ms  p999={d['p999']*1e3:7.2f}ms")
    pol = out["policy"]
    if pol is not None and pol.enabled:
        what = {
            "clone": f"clone at the q={pol.quantile:g} late-quantile",
            "relaunch": f"relaunch at the q={pol.quantile:g} late-quantile",
            "hedged": f"hedged dispatch of {pol.hedge_fraction:.0%} of jobs",
        }[pol.kind]
    else:
        what = "plain replication (no mitigation candidate pays off)"
    print(f"load-aware p99-optimal B* = {out['sojourn_best_B']}: {what} "
          f"(predicted p99 {out['speculative_p99']*1e3:.2f}ms)")


if __name__ == "__main__":
    main()
