"""The H100 roofline of a step, counted on the meta device.

The counterpart of ``repro.roofline.analysis``.  The reference reads the
FLOPs and bytes of a step from the compiled, SPMD-partitioned XLA module
of a TPU pod (``walk_hlo``, ``cost_analysis``); the port counts the
step functions it runs, on meta tensors, so nothing is allocated and no
card is needed:

* FLOPs: the matmul family (mm, bmm, addmm, baddbmm, convolution), forward
  and backward, of ``train_loss`` and its backward, ``prefill`` or
  ``decode_step``, counted op by op by the walk below with
  ``torch.utils.flop_counter``'s formulas (what ``FlopCounterMode``
  counts, in one pass with the bytes); elementwise work is no FLOP here
  (its cost is its bytes, below).  The attention and SSD scan kernels
  run no tensor op on a meta tensor: their wrappers note each call's
  operations and bytes (``flash_attention_work``, ``decode_attention_work``
  and ``ssd_scan_work``, the formulas of the kernel table's bound column,
  causal attention at its visible pairs, about half), and those are added.
  The kernels' training backwards (``FlashAttentionFn``'s
  ``flash_attention_grad`` and ``SsdScanFn``'s ``ssd_scan_grad``) are tensor
  ops, so the counter counts what they do: the backward's full (not
  causal-halved) score products, and the scan's plain recompute.
* Bytes, walked (``walked_bytes``, the report's ``bytes_per_device``):
  every op the step dispatches, costed by ``op_cost.walk_ops`` (operands
  read and result written, views free), elementwise chains, gathers and
  their backward included, and the kernels' noted bytes; a train step is
  walked through its float32 gradient cast and the in-place AdamW update
  (``optim.update_``), whose walk is also kept apart (``update_bytes``,
  ``update_by_op``): a trainer's step of several distinct batches runs
  one backward pass each but one update.  ``by_op`` splits the walk by
  op.  Walked again with the kernels' plain twins run in their place
  (``plain=True``), the same step gives the unfused attention's traffic
  (the dry-run's ``bytes_per_device_plain``).
* Bytes, modeled from shapes (``bytes``, the report's
  ``modeled_bytes_per_device``).  Train: the bf16 parameters read by the
  forward and the backward and written by the update, the float32 AdamW
  state (m, v, master) read and written, the float32 gradient tree
  written and read, the activations saved for the backward
  (``saved_tensors_hooks``, each storage once) written and read, and the
  kernels' noted bytes.  Prefill: the parameters read, the decode state
  written, the kernels' bytes.  Decode: the parameters read, the
  recurrent state (every state tensor but the KV caches) read and
  written, the kernels' bytes (the KV caches' valid positions).
* Time: compute = FLOPs / :data:`PEAK_FLOPS` (bf16 tensor cores; the few
  float32 matmuls, the MoE router and the xLSTM gates and recurrences, are
  counted at the same peak, so their term is a lower bound), memory =
  walked bytes / :data:`HBM_BW`; collective = 0 (one rank: the count has
  no communication).

Every count is affine in the depth, and the xLSTM's (its sLSTM a Python
loop over positions) in the sequence length too (but its train step's
walked bytes, quadratic there), so :func:`count_step` counts two small
depths (and two or three lengths) and carries the line (or parabola) to
the full model: a step of a 104 B-parameter model counts in about a
second.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["HBM_BW", "PEAK_FLOPS", "CARD_BYTES", "model_flops",
           "count_step", "analyze_cell"]

PEAK_FLOPS = 989e12  # H100 SXM bf16 dense, tensor cores
HBM_BW = 3.35e12  # H100 SXM HBM3, bytes/s
CARD_BYTES = 80e9  # the card's memory (80 GB) for the one-card verdict
META = torch.device("meta")
# the ssm family's counting lengths, in chunks of its mLSTM: two, and a
# third for a train step, whose walked bytes are quadratic in the length
# (each position's sLSTM gradient lands in a zeroed (B, S, ...) tensor);
# from two chunks, since one chunk's einsums copy other operands
SSM_COUNT_CHUNKS = (2, 3)
SSM_TRAIN_CHUNKS = (2, 3, 4)


def model_flops(cfg, cell, n_params_active: int) -> float:
    """Useful model FLOPs for the whole cell step (all chips)."""
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_params_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence
    return 2.0 * n_params_active * cell.global_batch


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    from ..tree import tree_leaves

    return sum(_nbytes(t) for t in tree_leaves(tree))


def _meta_state(cfg, rows: int, max_len: int):
    from ..models.lm import decode_state_shapes

    return {k: torch.zeros(shape, dtype=dt, device=META)
            for k, (shape, dt) in decode_state_shapes(cfg, rows,
                                                      max_len).items()}


def _batch(cfg, kind: str, rows: int, seq_len: int):
    from ..configs.base import ShapeCell
    from ..data.pipeline import make_batch_shapes

    shapes = make_batch_shapes(cfg, ShapeCell("count", seq_len, rows, kind))
    return {k: torch.zeros(s, dtype=torch.long if k in ("tokens", "labels",
                                                         "token")
                           else torch.float32, device=META)
            for k, s in shapes.items()}


def _run(cfg, kind: str, rows: int, seq_len: int,
         plain: bool = False) -> dict:
    """One step of ``kind`` on meta tensors at (rows, seq_len); with
    ``plain`` the kernel wrappers run their plain twins' ops."""
    from .. import optim
    from ..kernels import _build
    from ..models import lm
    from ..models import whisper as W
    from ..tree import tree_leaves
    from .op_cost import walking

    params = lm._build(None, cfg, META)
    pbytes = _tree_bytes(params)
    saved: dict = {}

    def pack(t):
        # each saved storage once, whole (views of one activation share
        # it), the parameters' apart; kept here until the count ends, so no
        # address is reused while the storages are told apart by it
        st = t.untyped_storage()
        if st._cdata not in held:
            saved[st._cdata] = st
        return t

    # the step's inputs, made before the walk: set-up, not the step
    extra, update = 0, None
    if kind == "decode":
        state = _meta_state(cfg, rows, seq_len)
        token = torch.zeros((rows, 1), dtype=torch.long, device=META)
    elif kind in ("train", "prefill"):
        batch = _batch(cfg, kind, rows, seq_len)
    if kind == "train":
        leaves = tree_leaves(params)
        opt_state = optim.init(params)
    route = _build.plain_on_meta() if plain else contextlib.nullcontext()
    with route, _build.record_meta_work() as work, walking() as walked:
        if kind == "train":
            held = {p.untyped_storage()._cdata for p in leaves}
            for p in leaves:
                p.requires_grad_(True)
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss, _ = lm.train_loss(cfg, params, batch)
            # allow_unused: a cut-down hybrid of no segment leaves its
            # shared block unused
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            # the trainer's float32 cast and in-place AdamW, walked only
            # (no FLOP of theirs is a matmul), and walked apart too: a
            # step of several backward passes runs one update
            with torch.no_grad(), walking() as update:
                optim.update_([torch.zeros(p.shape, device=META)
                               if g is None else g.to(torch.float32)
                               for g, p in zip(grads, leaves)],
                              opt_state, params, 1e-4)
            # AdamW: m, v, master (float32) read and written; the float32
            # gradient tree written and read
            n = sum(p.numel() for p in leaves)
            extra = 3 * pbytes + 2 * 12 * n + 2 * 4 * n
        elif kind == "prefill":
            with torch.no_grad():
                if cfg.family == "audio":
                    # whisper's prompt: the encoder over the frames and every
                    # decoder layer's cross K / V (lm.prefill raises for it)
                    enc = W.encode(cfg, params, batch["frames"])
                    out = [W._cross_kv(cfg, lp, enc)
                           for lp in params["dec_blocks"]]
                    extra = pbytes + sum(2 * _nbytes(kv[0]) for kv in out)
                else:
                    _, state = lm.prefill(cfg, params, batch, seq_len)
                    extra = pbytes + _tree_bytes(state)
        elif kind == "decode":
            kv = {"k", "v", "attn_k", "attn_v", "self_k", "self_v",
                  "cross_k", "cross_v"}
            recurrent = sum(_nbytes(t) for k, t in state.items()
                            if k not in kv)
            with torch.no_grad():
                lm.decode_step(cfg, params, state, token, seq_len - 1)
            extra = pbytes + 2 * recurrent
        else:
            raise ValueError(kind)
    by_kernel: dict = {}
    for name, f, b in work:
        k = by_kernel.setdefault(name, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += f
        k["bytes"] += b
    # the matmul family's FLOPs, summed exactly (integers) op by op
    counted = float(sum(row["flops"] for op, row in walked.by_op.items()
                        if op not in by_kernel))
    kflops = sum(k["flops"] for k in by_kernel.values())
    kbytes = sum(k["bytes"] for k in by_kernel.values())
    act = float(sum(st.nbytes() for st in saved.values()))
    return {"flops": counted + kflops, "counted_flops": counted,
            "kernel_flops": kflops, "kernels": by_kernel,
            "bytes": float(extra) + kbytes + 2 * act,
            "activation_bytes": act, "param_bytes": float(pbytes),
            "walked_flops": walked.flops, "walked_bytes": walked.bytes,
            "by_op": walked.by_op,
            "update_bytes": update.bytes if update else 0.0,
            "update_by_op": update.by_op if update else {}}


def _depth_points(cfg, kind: str = "train"):
    """Two cut-down configs of ``cfg``'s layout and their depth units, and
    the full model's units: the counts are affine in the units (layers;
    zamba2's and the xLSTM's segments), so two points give them all."""
    import dataclasses

    if cfg.family == "hybrid":
        n_seg, k, trailing = _zamba_layout(cfg)
        # one segment and two: the RoPE tables, computed once, are saved
        # only where a segment's shared block runs
        cut = [dataclasses.replace(cfg, n_layers=u * k + trailing)
               for u in (1, 2)]
        return list(zip(cut, (1, 2))), n_seg
    if cfg.family == "ssm":
        from ..models.lm import _xlstm_layout

        n_seg, m_per, trailing = _xlstm_layout(cfg)
        if n_seg:
            # no segment and one: each segment's sLSTM loops over the
            # positions, the costliest thing to count; a prefill builds
            # the decode state, whose segment slots a model of no segment
            # lacks (one allocation more at any depth), so one and two
            units = (1, 2) if kind == "prefill" else (0, 1)
            seg = m_per + 1
            cut = [dataclasses.replace(
                cfg, n_layers=u * seg + trailing,
                ssm=dataclasses.replace(cfg.ssm, slstm_layers=tuple(
                    seg * (i + 1) - 1 for i in range(u))))
                for u in units]
            return list(zip(cut, units)), n_seg
    lead = 1 if cfg.moe is not None and cfg.moe.first_layer_dense else 0
    units = [lead + 1, lead + 2]
    return ([(dataclasses.replace(cfg, n_layers=u), u) for u in units],
            cfg.n_layers)


def _zamba_layout(cfg):
    from ..models.zamba import segment_layout

    return segment_layout(cfg)


def _carry(points, x: float):
    """Each number of the counts at ``points`` [(x_i, counts_i)] carried
    to ``x``: on the line through two points, or on the parabola through
    three equally spaced ones (the line through the first two plus the
    second difference's term, exactly 0 for affine integer counts); a
    kernel or op one point did not call counts 0 there."""
    (xa, a), (xb, b) = points[:2]
    if isinstance(a, dict):
        zero = {"calls": 0, "flops": 0.0, "bytes": 0.0}
        return {k: _carry([(xi, ci.get(k, zero)) for xi, ci in points], x)
                for k in set().union(*(ci for _, ci in points))}
    line = a + (b - a) * (x - xa) / (xb - xa)
    if len(points) == 2:
        return line
    xc, c = points[2]
    d2 = ((c - b) / (xc - xb) - (b - a) / (xb - xa)) / (xc - xa)
    return line + d2 * (x - xa) * (x - xb)


def count_step(cfg, kind: str, rows: int, seq_len: int,
               plain: bool = False) -> dict:
    """FLOPs, bytes (modeled and walked, the walk by op), the kernels'
    share and the saved activations of one ``kind`` step ("train",
    "prefill", "decode") of ``cfg`` over ``rows`` sequences of ``seq_len``
    positions (decode: one token against a cache of ``seq_len``,
    ``seq_len - 1`` of them valid), counted on the meta device; with
    ``plain``, the kernels' plain twins run in their place.

    Every count is affine in the depth (layers, or segments), so the step
    is counted at two small depths of the same layout and carried to the
    full one; the ssm family's train and prefill, whose sLSTM loops over
    positions, are also counted at lengths of whole mLSTM chunks and
    carried to ``seq_len``: two for prefill (affine in the length), three
    for train (its walked bytes quadratic in it).  All are exact."""
    points, full = _depth_points(cfg, kind)
    if cfg.family == "ssm" and kind != "decode":
        chunks = SSM_TRAIN_CHUNKS if kind == "train" else SSM_COUNT_CHUNKS
        lengths = [k * cfg.ssm.chunk for k in chunks]
    else:
        lengths = [seq_len]
    runs = [_run(c, kind, rows, s, plain)
            for c, _ in points for s in lengths]
    n = len(lengths)
    at = [runs[i * n] if n == 1 else _carry(
        list(zip(lengths, runs[i * n:(i + 1) * n])), seq_len)
        for i in range(2)]
    (_, u1), (_, u2) = points
    out = _carry([(u1, at[0]), (u2, at[1])], full)
    for k in (*out["kernels"].values(), *out["by_op"].values(),
              *out["update_by_op"].values()):
        k["calls"] = round(k["calls"])
    out["counted_at"] = {"depth_units": [u1, u2], "full_units": full}
    if n > 1:
        out["counted_at"]["lengths"] = lengths
    return out


def analyze_cell(cfg, cell, chips: int = 1, counts: dict | None = None) -> dict:
    """The reference's report fields, where they mean something on one
    card, for ``cell`` split evenly over ``chips`` devices: ``terms``,
    ``dominant``, ``model_flops_per_device``, ``flops_per_device``,
    ``bytes_per_device`` (walked, as the reference's memory term is
    ``walk_hlo``'s), ``useful_flop_ratio`` and ``roofline_fraction``, with
    ``modeled_bytes_per_device`` and the counts they come from.  ``counts`` is :func:`count_step`'s
    at the cell's (global batch, seq_len), computed when not given."""
    from ..models.lm import active_params

    if counts is None:
        counts = count_step(cfg, cell.kind, cell.global_batch, cell.seq_len)
    flops_dev = counts["flops"] / chips
    bytes_dev = counts["walked_bytes"] / chips
    # collective 0: one rank, the count has no communication
    terms = {"compute_s": flops_dev / PEAK_FLOPS,
             "memory_s": bytes_dev / HBM_BW, "collective_s": 0.0}
    dominant = max(terms, key=terms.get)
    mf_dev = model_flops(cfg, cell, active_params(cfg)) / chips
    useful = mf_dev / flops_dev if flops_dev else 0.0
    top = max(max(terms.values()), 1e-30)
    fraction = (min(useful, 1.0) if dominant == "compute_s"
                else terms["compute_s"] / top * min(useful, 1.0))
    return {
        "arch": cfg.name, "shape": cell.name, "kind": cell.kind,
        "chips": chips,
        "flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
        "modeled_bytes_per_device": counts["bytes"] / chips,
        "terms": terms, "dominant": dominant,
        "model_flops_per_device": mf_dev, "useful_flop_ratio": useful,
        "roofline_fraction": fraction,
        "counts": counts,
        "peaks": {"bf16_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW},
    }
