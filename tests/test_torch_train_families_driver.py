"""The port's ``Trainer`` on the MoE and audio families beside the
reference's, on the CPU, and the trainer's handling of float batch entries.

* Reduced olmoe-1b-7b (capacity factor 8 in both packages: the reference's
  overflow scatter is defective, ROADMAP C) and reduced whisper-medium (2
  + 2 layers; 64 frames and 8 decoder tokens a row) through
  ``tests/test_torch_train_driver.py``'s comparison: both trainers built
  from the same ``TrainerConfig`` fields, the port's from the reference's
  parameters and AdamW state (olmoe's untied final norm scale set near
  1/4, as the MoE tests set it); a plain run, and a whole-group fault
  whose elastic re-plan restores a checkpoint, 6 steps each.  The port's
  MoE layers are routed to the reference's experts call by call
  (``tests/test_torch_moe.py``'s recorder): each token whose own top-k
  set would differ is a near-tie, a margin below 1e-2 (measured at most
  6.7e-3).  ``sim_times``, ``plan_history``, ``events``, ``final_plan``
  and the topology generation equal exactly; losses within 2e-3
  (measured at most 6.1e-4, olmoe); the final master weights within 2 x
  the learning rates applied (that file's bound).
* A whisper batch's ``frames`` reach ``train_loss`` as the pipeline's
  float32 values (not cast to integers), its tokens and labels as
  ``long``; an internvl2 batch's ``patch_embeds`` likewise.
* ``make_train_step`` with 2 micro-batches splits every entry of an audio
  batch by rows: against the reference's step at 2 micro-batches, the loss
  within 2e-3, the grad norm within 2%, the new parameters within
  ``tests/test_torch_train_grad.py``'s 8e-3.
* ``optim.update_`` (the trainer's) gives the same bits as ``update``, in
  the tensors it was given.
* ``python -m repro_torch.launch.train --arch whisper-medium --device cpu``
  trains.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as ref_train_mod
import repro.models.moe as ref_moe
import repro_torch.models.moe as port_moe
import repro_torch.launch.steps as port_steps
import repro_torch.launch.train as port_train_mod
from repro.configs.base import ShardingPolicy
from repro.core import FaultEvent as RefFaultEvent
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim import init as ref_opt_init
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeCell
from repro_torch.convert import (from_reference, opt_state_from_reference,
                                 params_from_reference)
from repro_torch.data import TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import Trainer, TrainerConfig, main
from repro_torch.optim import init as opt_init
from repro_torch.optim import update as adamw_update
from repro_torch.optim import update_ as adamw_update_
from repro_torch.tree import tree_leaves, tree_map
from test_torch_moe import _forced_route, _ref_recorder, _untied_scale
from test_torch_train_driver import (BASE, _check_control_plane,
                                     _check_losses, _check_params, _lr_total)
from test_torch_train_grad import PARAM_TOL, _paths

LOSS_TOL = 2e-3
ARCHS = ["olmoe-1b-7b", "whisper-medium"]
CF = 8.0
FLIP_MARGIN = 1e-2


@pytest.fixture(autouse=True)
def _moe_without_overflow(monkeypatch):
    """Both trainers' reduced configs with MoE capacity factor 8."""
    for mod in (ref_train_mod, port_train_mod):
        orig = mod.reduced_config

        def reduced(cfg, orig=orig):
            cfg = orig(cfg)
            if cfg.moe is None:
                return cfg
            return dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=CF))

        monkeypatch.setattr(mod, "reduced_config", reduced)


# arch -> (the first reference trainer's jitted grad and optimizer
# functions, the recorder's list their MoE callback appends to)
_REF_FNS: dict = {}


def _routed_runs(arch, **kw):
    """Both trainers run (reference first): the port's from the
    reference's parameters and state, its final norm scale near 1/4 as the
    MoE tests set an untied unembedding's, and its MoE layers routed to
    the reference's experts call by call (``tests/test_torch_moe.py``'s
    recorder; the reference's backward recomputes each layer and records
    it again, so each gradient call records twice its MoE layers, the
    forward's first).  Every reference trainer of an arch runs the jitted
    functions of the module's first one (the same config and AdamW; the
    reference re-jits per instance), whose recorder callback appends to
    one list, emptied here before each run.  Returns (ref result, port
    result, ref trainer, port trainer, routing flips)."""
    fns = _REF_FNS.get(arch)
    calls = fns[2] if fns else []
    calls.clear()
    flips = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_moe, "apply_moe", _ref_recorder(calls,
                                                       ref_moe.apply_moe))
        rt = ref_train_mod.Trainer(ref_train_mod.TrainerConfig(
            **{**BASE, **kw, "arch": arch}))
        if fns:
            rt._grad_fn, rt._opt_fn = fns[:2]
        else:
            _REF_FNS[arch] = (rt._grad_fn, rt._opt_fn, calls)
        if "final_norm" in rt.params:  # an untied unembedding
            rt.params = jax.tree.map(jnp.asarray, _untied_scale(
                jax.tree.map(np.array, rt.params)))
        pkw = {**BASE, **kw, "arch": arch}
        pkw["faults"] = from_reference(tuple(pkw.get("faults", ())))
        if "checkpoint_dir" in kw:
            pkw["checkpoint_dir"] = kw["checkpoint_dir"] + "-port"
        pt = Trainer(TrainerConfig(**pkw), device="cpu")
        pt.params = params_from_reference(
            pt.cfg, jax.tree.map(np.asarray, rt.params), device="cpu")
        pt.opt_state = opt_state_from_reference(
            pt.cfg, jax.tree.map(np.asarray, rt.opt_state), device="cpu")
        rr = rt.run()
        jax.effects_barrier()
    cfg = pt.cfg
    n = cfg.n_layers - cfg.moe.first_layer_dense if cfg.moe else 0
    forward = [c for i in range(0, len(calls), 2 * max(n, 1))
               for c in calls[i:i + n]]
    forced = iter(forward)

    def route(moe, router, xt):
        flips.append([])
        return _forced_route(forced, flips[-1])(moe, router, xt)

    with pytest.MonkeyPatch.context() as mp:
        if n:
            mp.setattr(port_moe, "route", route)
        pr = pt.run()
    return rr, pr, rt, pt, flips


def _check_flips(flips, pt):
    """Each token whose own top-k set would differ from the reference's is
    a near-tie, a margin below 1e-2 (measured at most 4.3e-3 at step 0 and
    6.7e-3 after it, the parameters then apart by AdamW's drift)."""
    if pt.cfg.moe is None:
        assert not any(flips)
    assert all(m < FLIP_MARGIN for f in flips for m in f)


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_run_matches_reference(arch):
    rr, pr, rt, pt, flips = _routed_runs(arch, steps=6)
    assert pt.cfg.family == ("moe" if arch.startswith("olmoe") else "audio")
    assert pt.cfg.moe is None or pt.cfg.moe.capacity_factor == CF
    _check_flips(flips, pt)
    _check_control_plane(rr, pr, rt, pt)
    _check_losses(rr, pr, LOSS_TOL)
    _check_params(rt, pt, _lr_total(pt.tc, pt.tc.steps))
    assert pr.total_sim_time == rr.total_sim_time > 0
    assert pr.plan_history == [(0, 4)] and pr.events == []


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_group_loss_replans_and_restores(tmp_path, arch):
    faults = (RefFaultEvent(worker=1, start_step=3, end_step=10**9),
              RefFaultEvent(worker=5, start_step=3, end_step=10**9))
    restores = []
    orig = Checkpointer.restore

    def spy(self, example, step=None):
        out = orig(self, example, step)
        restores.append(out[1]["step"])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Checkpointer, "restore", spy)
        rr, pr, rt, pt, flips = _routed_runs(
            arch, steps=6, faults=faults, checkpoint_every=2,
            checkpoint_dir=str(tmp_path / "ckpt"))
    _check_flips(flips, pt)
    _check_control_plane(rr, pr, rt, pt)
    _check_losses(rr, pr, LOSS_TOL)
    assert any("replan" in e for e in pr.events)
    assert restores and restores[0] < 6
    _check_params(rt, pt, _lr_total(pt.tc, pt.tc.steps))


@pytest.mark.parametrize("arch,key", [("whisper-medium", "frames"),
                                      ("internvl2-76b", "patch_embeds")])
def test_float_entries_reach_train_loss_as_float32(monkeypatch, arch, key):
    seen = []
    orig = port_steps.train_loss

    def spy(cfg, params, batch):
        seen.append({k: v.detach().clone() for k, v in batch.items()})
        return orig(cfg, params, batch)

    monkeypatch.setattr(port_steps, "train_loss", spy)
    tc = TrainerConfig(arch=arch, steps=1, seq_len=32, global_batch=8)
    tr = Trainer(tc, device="cpu")
    loss, _, _ = tr.step(0)
    assert np.isfinite(loss) and len(seen) == tc.n_batches
    batches = [tr.pipeline.batch_for(0, b, tc.n_batches)
               for b in range(tc.n_batches)]
    got = seen[0]
    want = next(b for b in batches
                if np.array_equal(b["tokens"], got["tokens"].numpy()))
    assert got[key].dtype == torch.float32
    np.testing.assert_array_equal(got[key].numpy(), want[key])
    assert not np.array_equal(want[key], np.trunc(want[key]))
    for name in ("tokens", "labels"):
        assert got[name].dtype == torch.long
        np.testing.assert_array_equal(got[name].numpy(), want[name])


def test_micro_batches_split_an_audio_batch():
    tc = TrainerConfig(arch="whisper-medium", seq_len=64, global_batch=4)
    tr = Trainer(tc, device="cpu")
    rtr = ref_train_mod.Trainer(ref_train_mod.TrainerConfig(
        arch="whisper-medium", seq_len=64, global_batch=4))
    rcfg, cfg = rtr.cfg, tr.cfg
    tree = jax.tree.map(np.asarray, rtr.params)
    batch = TokenPipeline(cfg, ShapeCell("t", 64, 4, "train"),
                          seed=2).global_batch(0)
    lr = 1e-3
    rstep = jax.jit(ref_make_train_step(
        rcfg, ShardingPolicy(num_microbatches=2)))
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = ref_opt_init(rparams)
    rnew, _, rmet = rstep(rparams, rstate, jax.tree.map(jnp.asarray, batch),
                          jnp.float32(lr))
    params = params_from_reference(cfg, tree, device="cpu")
    state = opt_state_from_reference(
        cfg, jax.tree.map(np.asarray, rstate), device="cpu")
    new, _, met = make_train_step(cfg, num_microbatches=2)(
        params, state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.tensor(lr))
    loss_gap = abs(float(met["loss_total"]) - float(rmet["loss_total"]))
    assert loss_gap <= LOSS_TOL
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=2e-2)
    want = params_from_reference(cfg, jax.tree.map(np.asarray, rnew),
                                 device="cpu")
    for (path, w), (_, g) in zip(_paths(want), _paths(new)):
        assert g.dtype == w.dtype, path
        assert (g.float() - w.float()).abs().max().item() <= PARAM_TOL, path


def test_in_place_update_is_bit_equal():
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn((8, 16), generator=gen).to(torch.bfloat16),
              "b": [torch.randn((5,), generator=gen)]}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    state = opt_init(params)
    for _ in range(2):  # the second step from moments that are not zero
        kept = [t.clone() for t in tree_leaves((params, state))]
        want = adamw_update(grads, state, params, torch.tensor(3e-3))
        assert all(torch.equal(a, b) for a, b in
                   zip(kept, tree_leaves((params, state))))  # untouched
        p2, s2 = (tree_map(lambda t: t.clone(), t) for t in (params, state))
        before = tree_leaves((p2, s2["m"], s2["v"], s2["master"]))
        got = adamw_update_(grads, s2, p2, torch.tensor(3e-3))
        for a, b in zip(tree_leaves(want), tree_leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        after = tree_leaves((got[0], got[1]["m"], got[1]["v"],
                             got[1]["master"]))
        assert all(a is b for a, b in zip(before, after))
        params, state = want[0], want[1]


def test_cli_trains_whisper(capsys):
    main(["--arch", "whisper-medium", "--device", "cpu", "--steps", "2",
          "--seq-len", "32", "--global-batch", "8"])
    out = capsys.readouterr().out
    assert "final loss" in out and "plan history [(0, 4)]" in out
