"""The port's serving engine with the model, on the CPU.

The port's engine runs on the reference's parameters
(``convert.params_from_reference``) and prompts (through its
``_prompts`` hook: event-mode prompts keyed by ``fold_in(PRNGKey(seed +
3), request_id)``, ``serve_round``'s block by ``PRNGKey(seed + first
id)``).  Its schedule must be the reference's bit for bit, and its tokens
the reference's at every position whose prefix matched, except where the
reference's own top-two logit margin is under
``tests/test_torch_models.py``'s logit tolerance (4e-2): there the two
bfloat16 models may pick different tokens, and the rest of that row is
skipped and counted (each case prints how many).  qwen2-0.5b reduced in
event mode and in ``serve_round``, and one small zamba2-7b case.

Then the port alone: the same request generates the same tokens at any
replication level, ``serve_round``'s remainder and event mode give every
request its tokens, and the prompt rule.
"""

import jax
import numpy as np
import pytest
import torch

import repro_torch.serving.engine as port_engine_mod
from repro.models import prefill as ref_prefill
from repro.serving import PoissonArrivals as RPoisson
from repro.serving import ReplicatedServingEngine as REngine
from repro.serving import ServeEngineConfig as RConfig
from repro_torch.convert import params_from_reference
from repro_torch.serving import PoissonArrivals as TPoisson
from repro_torch.serving import ReplicatedServingEngine as TEngine
from repro_torch.serving import ServeEngineConfig as TConfig

LOGIT_TOL = 4e-2  # tests/test_torch_models.py's ATOL


def _stat(s):
    return tuple("nan" if isinstance(v, float) and v != v else v
                 for v in (s.request_id, s.arrival, s.completion,
                           s.dispatched, s.deadline, s.dropped, s.slo))


def _with_reference_model(ref, port, rounds):
    """Hand the port the reference's weights and prompts: event-mode
    prompts keyed by ``fold_in(PRNGKey(seed + 3), id)``, ``serve_round``'s
    block by ``PRNGKey(seed + first id)``."""
    tree = jax.tree.map(np.asarray, ref.params)
    port.params = params_from_reference(port.cfg, tree, device="cpu")
    sc = ref.sc

    def prompts(ids):
        ids = list(ids)
        if rounds:
            rows = jax.random.randint(jax.random.PRNGKey(sc.seed + ids[0]),
                                      (len(ids), sc.prompt_len), 0,
                                      ref.cfg.vocab_size)
        else:
            rows = jax.numpy.stack([jax.random.randint(
                jax.random.fold_in(ref._prompt_key, i), (sc.prompt_len,), 0,
                ref.cfg.vocab_size) for i in ids])
        return torch.as_tensor(np.array(rows)).long()
    port._prompts = prompts
    return prompts


def _reference_margins(ref, prompts):
    """The reference's greedy tokens and top-two logit margins for one
    batch of prompts, step by step."""
    sc = ref.sc
    logits, state = ref_prefill(ref.cfg, ref.shard, ref.params,
                                {"tokens": jax.numpy.asarray(prompts.numpy(),
                                                             jax.numpy.int32)},
                                max_len=sc.max_len)
    toks, margins = [], []
    for i in range(sc.gen_tokens):
        last = np.asarray(logits[:, -1], dtype=np.float32)
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = np.asarray(jax.numpy.argmax(logits[:, -1], -1))[:, None]
        toks.append(tok[:, 0])
        if i < sc.gen_tokens - 1:
            logits, state = ref._decode(  # the engine's jitted step
                ref.params, state, jax.numpy.asarray(tok, jax.numpy.int32),
                jax.numpy.int32(sc.prompt_len + i))
    return np.stack(toks, 1), np.stack(margins, 1)


def _compare_tokens(got, want, margins):
    """(positions compared, positions skipped).  A position is compared
    when every earlier one of its row matched; a differing token is
    allowed only where the reference's margin is under LOGIT_TOL, and the
    rest of that row is skipped."""
    compared = skipped = 0
    for g, w, m in zip(got, want, margins):
        for j in range(len(w)):
            compared += 1
            if g[j] != w[j]:
                assert m[j] < LOGIT_TOL, (j, g, w, m)
                skipped += len(w) - j - 1
                break
    return compared, skipped


MODEL_CASES = {
    "qwen2_event": ("qwen2-0.5b", dict(n_server_groups=8, n_batches=4,
                                       batch_size=4, prompt_len=8,
                                       gen_tokens=5, max_len=16, seed=1),
                    ("serve", 8)),
    "qwen2_rounds": ("qwen2-0.5b", dict(n_server_groups=8, n_batches=4,
                                        batch_size=2, prompt_len=8,
                                        gen_tokens=4, max_len=16, seed=3),
                     ("round", 10)),
    "zamba2_event": ("zamba2-7b", dict(n_server_groups=4, n_batches=2,
                                       batch_size=4, prompt_len=8,
                                       gen_tokens=4, max_len=16, seed=1),
                     ("serve", 8)),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_engine_tokens_are_the_references(case, capsys):
    arch, cfg, (mode, n) = MODEL_CASES[case]
    cfg = dict(cfg, arch=arch)
    ref = REngine(RConfig(**cfg))
    port = TEngine(TConfig(**cfg, device="cpu"))
    prompts = _with_reference_model(ref, port, rounds=mode == "round")
    if mode == "round":
        want, got = ref.serve_round(n), port.serve_round(n)
        batches = [list(range(lo, hi)) for lo, hi in
                   port_engine_mod.partition_requests(n, cfg["n_batches"])]
        block = prompts(range(n))
        rows = [block[b[0]:b[-1] + 1] for b in batches]
    else:
        want = ref.serve(n, arrivals=RPoisson(rate=30.0))
        got = port.serve(n, arrivals=TPoisson(rate=30.0))
        batches = [[r.request_id for r in j.requests]
                   for j in ref.last_master.completed_jobs]
        rows = [prompts(b) for b in batches]
    assert [_stat(s) for s in got] == [_stat(s) for s in want]
    by_id = {s.request_id: s for s in got}
    ref_by_id = {s.request_id: s for s in want}
    compared = skipped = 0
    for ids, p in zip(batches, rows):
        toks, margins = _reference_margins(ref, p)
        np.testing.assert_array_equal(
            toks, np.stack([ref_by_id[i].tokens for i in ids]))
        port_toks = np.stack([by_id[i].tokens for i in ids])
        assert port_toks.dtype == np.int32
        c, s = _compare_tokens(port_toks, toks, margins)
        compared, skipped = compared + c, skipped + s
    assert compared + skipped == n * cfg["gen_tokens"]
    assert compared >= skipped
    with capsys.disabled():
        print(f"\n[{case}] {compared} token positions equal to the "
              f"reference's, {skipped} skipped after a position whose "
              f"reference top-two margin is under {LOGIT_TOL}")


def _port(**kw):
    return TEngine(TConfig(**{**dict(n_server_groups=8, n_batches=4,
                                     gen_tokens=4, prompt_len=8,
                                     batch_size=2, max_len=16),
                              **kw}, device="cpu"))


def test_generation_is_deterministic_across_replication_levels():
    """Replication changes WHO serves, never WHAT is served."""
    outs = [np.stack([s.tokens for s in _port(n_batches=b, seed=3)
                      .serve_round(n_requests=8)]) for b in (2, 4)]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_serve_round_remainder_generates_all_tokens():
    stats = _port().serve_round(n_requests=10)
    assert len(stats) == 10
    assert all(s.tokens.shape == (4,) and (s.tokens >= 0).all()
               for s in stats)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b"])
def test_event_mode_generates_real_tokens(arch):
    eng = _port(arch=arch, seed=1)
    stats = eng.serve(6, arrivals=TPoisson(rate=50.0))
    vocab = eng.cfg.vocab_size
    assert len(stats) == 6
    for s in stats:
        assert s.tokens.shape == (4,) and s.tokens.dtype == np.int32
        assert ((s.tokens >= 0) & (s.tokens < vocab)).all()
        assert np.isfinite(s.latency) and s.completion >= s.dispatched >= (
            s.arrival)


def test_prompts_are_keyed_by_request_id():
    eng = _port(seed=4)
    a, b = eng._prompts([5, 9]), eng._prompts([9])
    assert a.shape == (2, 8) and a.dtype == torch.int64
    assert torch.equal(a[1], b[0]) and not torch.equal(a[0], a[1])
    g = torch.Generator().manual_seed(((4 + 3) << 32) + 9)
    assert torch.equal(b[0], torch.randint(0, eng.cfg.vocab_size, (8,),
                                           generator=g))
