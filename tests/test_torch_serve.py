"""The port's serving entry point against the reference's, on the CPU.

``run_serving`` of both packages for the same ``ServeConfig`` (2 prompts,
4 new tokens on the reduced qwen2-0.5b).  The fleet half must agree:

* ``latency_by_B`` (``sweep_simulated``, 20,000 trials at seed 7) within
  1e-6 relative: the port's sweep takes the min and max in float32 on the
  reference's float64 draws, the reference's numpy lane in float64;
* ``sojourn_best_B`` and ``policy`` exactly, and ``sojourn_by_B`` within
  1e-5 relative (the port's sojourn scan runs in float32).

The load-aware planner runs at 1,000 trials in both packages here (its
``SimulatedPlanner`` is wrapped for the test's duration), because on the
CPU the port's scan is its plain per-job version, which takes minutes at
``run_serving``'s 20,000; the card runs the full count in ``chip_smoke.py``.
The model half cannot match token for token (the weights come from a
``torch.Generator`` and JAX keys respectively), so ``generate`` is held
to shape, range, determinism and the decode-equals-prefill rule.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve
import repro_torch.launch.serve as port_serve
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import init_params, prefill

PLAN_TRIALS = 1_000
SC = dict(batch=2, gen_tokens=4)


def _fewer_trials(cls):
    return lambda **kw: cls(**{**kw, "n_trials": PLAN_TRIALS})


@pytest.fixture(scope="module")
def served():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_serve, "SimulatedPlanner",
                   _fewer_trials(ref_serve.SimulatedPlanner))
        mp.setattr(port_serve, "SimulatedPlanner",
                   _fewer_trials(port_serve.SimulatedPlanner))
        ref = ref_serve.run_serving(ref_serve.ServeConfig(**SC))
        port = port_serve.run_serving(port_serve.ServeConfig(**SC),
                                      device="cpu")
    return ref, port


def test_latency_by_b_matches_reference(served):
    ref, port = served
    assert list(port["latency_by_B"]) == list(ref["latency_by_B"])
    for b, want in ref["latency_by_B"].items():
        for k in ("mean", "p99"):
            assert port["latency_by_B"][b][k] == pytest.approx(want[k], rel=1e-6)


def test_plan_matches_reference(served):
    ref, port = served
    assert port["sojourn_best_B"] == ref["sojourn_best_B"]
    pol, want = port["policy"], ref["policy"]
    assert (pol.kind, pol.quantile, pol.hedge_fraction) == (
        want.kind, want.quantile, want.hedge_fraction)
    assert port["speculation_quantile"] == ref["speculation_quantile"]
    assert list(port["sojourn_by_B"]) == list(ref["sojourn_by_B"])
    for b, w in ref["sojourn_by_B"].items():
        for k in ("mean", "p99", "p999"):
            assert port["sojourn_by_B"][b][k] == pytest.approx(w[k], rel=1e-5)
    assert port["backend"] == "cpu"


def test_served_tokens(served):
    ref, port = served
    assert port["generated"].shape == ref["generated"].shape == (2, 4)
    vocab = reduced_config(get_config("qwen2-0.5b")).vocab_size
    assert ((port["generated"] >= 0) & (port["generated"] < vocab)).all()
    assert port["prefill_s"] > 0 and port["decode_s"] > 0


def test_generate_end_to_end():
    cfg = reduced_config(get_config("qwen2-0.5b"))
    params = init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (3, 10),
                            generator=torch.Generator().manual_seed(4))
    gen = port_serve.generate(cfg, params, prompts, gen_tokens=6, max_len=16)
    assert gen.tokens.shape == (3, 6) and gen.tokens.dtype == torch.long
    again = port_serve.generate(cfg, params, prompts, gen_tokens=6, max_len=16)
    assert torch.equal(gen.tokens, again.tokens)
    # each greedy token is the argmax of a prefill over everything before it
    for i in range(6):
        seq = torch.cat([prompts, gen.tokens[:, :i]], dim=1)
        logits, _ = prefill(cfg, params, {"tokens": seq}, 16)
        assert torch.equal(logits[:, -1].argmax(-1), gen.tokens[:, i])
    with pytest.raises(ValueError, match="max_len"):
        port_serve.generate(cfg, params, prompts, gen_tokens=8, max_len=16)


def test_serving_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.run_serving(port_serve.ServeConfig(**SC))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(torch.Generator(), reduced_config(get_config("qwen2-0.5b")))


def test_main_prints_a_plan(served, capsys):
    calls = []

    def fake_run(sc, device=None):
        calls.append((sc, device))
        return served[1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_serve, "run_serving", fake_run)
        port_serve.main(["--tokens", "3", "--batch", "1", "--device", "cpu"])
    (sc, device), = calls
    assert (sc.gen_tokens, sc.batch, sc.arch, device) == (3, 1, "qwen2-0.5b",
                                                          "cpu")
    out = capsys.readouterr().out
    assert "[cpu] prefill" in out and "load-aware p99-optimal B*" in out
    assert np.isfinite(float(out.split("predicted p99 ")[1].split("ms")[0]))
