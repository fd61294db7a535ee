#!/usr/bin/env python3
"""Times the two backward kernels against a parent tree's, on one card, at
the training shapes ``PERF.md`` tracks them at.

    python3 bwd_ab.py --parent DIR [--reps N]

``DIR`` is a checkout of the parent commit (for example ``git archive``
unpacked under ``build/``).  Its ``csrc/flash_attention_bwd.cu`` and
``csrc/ssd_scan_bwd.cu`` are compiled with this tree's flags beside this
tree's libraries and called through their own C interfaces, from the same
forward outputs (this tree's forward kernels: their numerics are the
parent's).  The parent's ``csrc/flash_attention.cu`` is built too, to time
the serving forward, whose Hopper helpers this tree moved into
``csrc/hopper.cuh``.  The shapes:

* ``flash_attention_bwd`` (bf16), the kernel table's row 4 training rows:
  ``train`` (q 8 x 512 x 14 x 64 over 2 KV heads, causal), whisper's
  encoder (4 x 1,500 x 16 x 64, non-causal), internvl2's layer (q 2 x 512
  x 64 x 128 over 8, causal) and whisper's cross attention (q 4 x 187, k/v
  4 x 1,500 x 16 x 64, non-causal); beside each, SDPA's backward (the
  library call, timed here and used nowhere in the port);
* ``ssd_scan_bwd`` (bf16), row 6's ``train_hybrid`` shape: x 3 x 512 x 112
  x 64 and b / c 3 x 512 x 1 x 64 as views of one activation;
* ``flash_attention`` (bf16, the serving forward, row 4): q 8 x 1,024 x 14
  x 64 over 2 KV heads and 8 x 1,024 x 32 x 112, causal.

Each is timed in turns parent, change, change, parent (CUDA events, the
median of ``reps`` calls each turn), and, after every timing, under the
profiler: each call's device time by kernel, free of the host's gaps
(SDPA's backward runs through autograd, whose host time can exceed its
kernels').  Every backward's output is held to
this tree's plain backward in float32 at ``chip_smoke.py``'s tolerances
(flash: 5e-2 x (min(1, RMS) + |plain|); the scan: 5e-2 x (1 + |plain|)),
and two passes of each must be bit-equal; the forwards must agree bit for
bit.  The ptxas registers, spills and shared memory of each backward
function come from the build logs.  Prints one JSON line and writes it to
``chiprun_out/bwd_ab.json``.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = 5e-2
# (b, sq, skv, H, KV, d, causal)
FLASH = {"train": (8, 512, 512, 14, 2, 64, True),
         "whisper_encoder": (4, 1500, 1500, 16, 16, 64, False),
         "internvl2": (2, 512, 512, 64, 8, 128, True),
         "whisper_cross": (4, 187, 1500, 16, 16, 64, False)}
# (B, S, H, G, P, N)
SSD = {"train_hybrid": (3, 512, 112, 1, 64, 64)}
FORWARD = {"serve": (8, 1024, 1024, 14, 2, 64, True),
           "serve_d112": (8, 1024, 1024, 32, 32, 112, True)}
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_figures(log: str, keep: str) -> dict:
    """{function: {registers, spill stores / loads, static smem}} of the
    entry functions whose mangled name holds ``keep``."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = m.group(1) if keep in m.group(1) else None
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            out.setdefault(cur, {})["spill"] = [int(m[1]), int(m[2])]
        m = _USED.search(line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m[1])
            s = _SMEM.search(line)
            if s:
                out[cur]["static_smem"] = int(s[1])
    return out


def _parent_lib(parent: Path, name: str, argtypes, fn: str):
    """The parent's csrc/<name>.cu, built with this tree's flags."""
    from repro_torch.kernels import _build

    src = parent / "src" / "repro_torch" / "csrc" / f"{name}.cu"
    out = _build.BUILD_DIR / "ab" / f"lib{name}_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = subprocess.run(
        [_build._nvcc(), *_build._flags(name), "-Xptxas", "-v", "-o",
         str(out), str(src)], check=True, capture_output=True, text=True,
        timeout=900)
    lib = ctypes.CDLL(str(out))
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    lib.ptxas_log = log.stdout + log.stderr
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssm_scan import ops as SS

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _build.build_all()
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    with ThreadPoolExecutor(3) as ex:
        jobs = [ex.submit(_parent_lib, args.parent, "flash_attention_bwd",
                          [P] * 11 + [I] * 9 + [P],
                          "flash_attention_bwd_launch"),
                ex.submit(_parent_lib, args.parent, "ssd_scan_bwd",
                          [P] * 16 + [I] * 7 + [L] * 4 + [P],
                          "ssd_scan_bwd_launch"),
                ex.submit(_parent_lib, args.parent, "flash_attention",
                          [P] * 6 + [I] * 9 + [P], "flash_attention_launch")]
        p_flash_bwd, p_ssd_bwd, p_flash = (j.result() for j in jobs)
    ptr = lambda t: P(None if t is None else t.data_ptr())  # noqa: E731

    def stream():
        return P(torch.cuda.current_stream().cuda_stream)

    def time_ms(fn, reps):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for s, e in pairs:
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def turns(fns, reps):
        """parent, change, change, parent (and any other kernel once a
        turn, in the same order each way)."""
        order = list(fns) + list(reversed(fns))
        times: dict = {t: [] for t in fns}
        for tag in order:
            times[tag].append(time_ms(fns[tag], reps))
        return times

    def kernel_split(fn, reps=5):
        """{kernel name: mean device ms a call} of ``reps`` calls under the
        profiler: where a call's device time goes."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if us > 0:
                out[ev.key[:60]] = us / reps / 1e3
        return out

    def rand(shape, seed, scale=1.0):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(shape, generator=g, device=dev) * scale)

    def reading(got, want):
        """largest |got - want| / (min(1, RMS) + |want|)."""
        want = want.float()
        floor = min(1.0, want.square().mean().sqrt().item())
        return ((got.float() - want).abs() / (floor + want.abs())).max().item()

    report = {"card": card, "flash_attention_bwd": {}, "ssd_scan_bwd": {},
              "flash_attention": {}}
    profiled: list = []  # (kernel, shape, {tag: call}), profiled at the end

    # -- flash attention's backward ---------------------------------------
    def flash_case(name, b, sq, skv, h, kv, d, causal):
        """One flash shape: holds, A/B times, the row."""
        q = rand((b, sq, h, d), 1).to(torch.bfloat16)
        k = rand((b, skv, kv, d), 2).to(torch.bfloat16)
        v = rand((b, skv, kv, d), 3).to(torch.bfloat16)
        do = rand((b, sq, h, d), 4).to(torch.bfloat16)
        with torch.no_grad():
            out, lse, out_lo = FA._attend(q, k, v, causal, 0, with_lse=True)
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        pq, pk, pv = (torch.empty_like(t) for t in (q, k, v))

        def parent_call():
            code = p_flash_bwd.flash_attention_bwd_launch(
                ptr(q), ptr(k), ptr(v), ptr(out), ptr(out_lo), ptr(do),
                ptr(lse), ptr(delta), ptr(pq), ptr(pk), ptr(pv), b, sq, skv,
                h, kv, d, int(causal), 0, 1, stream())
            assert code == 0, code
            return pq, pk, pv

        def change_call():
            return FA._attend_grad(q, k, v, out, out_lo, lse, do, causal, 0)

        st = [t.transpose(1, 2).contiguous().requires_grad_(True)
              for t in (q, k, v)]
        so = F.scaled_dot_product_attention(*st, is_causal=causal,
                                            enable_gqa=True)
        sdo = do.transpose(1, 2).contiguous()

        def sdpa_bwd():
            return torch.autograd.grad(so, st, sdo, retain_graph=True)

        want = FA.flash_attention_grad(q.float(), k.float(), v.float(),
                                       do.float(), causal=causal)
        holds = {}
        for tag, fn in (("parent", parent_call), ("change", change_call)):
            first = [t.clone() for t in fn()]
            again = fn()
            if not all(torch.equal(a, b_) for a, b_ in zip(first, again)):
                raise AssertionError(f"{name}: two {tag} passes differ")
            holds[tag] = {g: reading(a, w) for g, a, w in
                          zip(("dq", "dk", "dv"), first, want)}
            if max(holds[tag].values()) > TOL:
                raise AssertionError(f"{name}: {tag} {holds[tag]} past {TOL}")
        times = turns({"parent": parent_call, "change": change_call,
                       "sdpa_bwd": sdpa_bwd}, args.reps)
        profiled.append(("flash_attention_bwd", name,
                         {"parent": parent_call, "change": change_call,
                          "sdpa_bwd": sdpa_bwd}))
        flops, nbytes = FA.flash_attention_grad_work(b, sq, skv, h, kv, d,
                                                     causal, 0, 2)
        bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        row = {"shape": [b, sq, skv, h, kv, d, causal],
               "splits": FA.dkdv_splits(b, skv, kv, h // kv),
               "ms": times, "bound_ms": bound,
               "bound_by": ("operations" if flops / 989e12 > nbytes / 3.35e12
                            else "bytes"),
               "reading": holds}
        report["flash_attention_bwd"][name] = row
        print(f"[ab] flash_attention_bwd {name} {row['shape']} splits "
              f"{row['splits']}: " + ", ".join(
                  f"{t} {' / '.join(f'{x:.4f}' for x in v_)} ms"
                  for t, v_ in times.items()) + f"; bound {bound:.5f}; "
              f"readings {holds}", flush=True)

    for name, shape in FLASH.items():
        flash_case(name, *shape)
        torch.cuda.empty_cache()

    # -- the SSD scan's backward ------------------------------------------
    def ssd_case(name, bs, s, h, g, p, n):
        """One scan shape: holds, A/B times, the row."""
        width = h * p + 2 * g * n
        act = rand((bs, s, width), 5, 0.5).to(torch.bfloat16)
        x = act[..., :h * p].unflatten(-1, (h, p))
        bm = act[..., h * p:h * p + g * n].unflatten(-1, (g, n))
        cm = act[..., h * p + g * n:].unflatten(-1, (g, n))
        dt = 0.01 + 0.09 * torch.rand((bs, s, h), device=dev,
                                      generator=torch.Generator(
                                          device=dev).manual_seed(6))
        a_log = rand((h,), 7, 0.5)
        d_skip = 1 + rand((h,), 8, 0.2)
        dy = rand((bs, s, h, p), 9).to(torch.bfloat16)
        with torch.no_grad():
            _, _, states = SS._scan(x, dt, a_log, bm, cm, d_skip, None, 128,
                                    with_states=True)
        needs = (True,) * 6 + (False,)
        f32 = dict(dtype=torch.float32, device=dev)
        pbufs = [torch.empty(x.shape, dtype=x.dtype, device=dev),
                 torch.empty((bs, s, h), **f32),
                 torch.empty((bs, s, h, n), **f32),
                 torch.empty((bs, s, h, n), **f32),
                 torch.empty((bs, h), **f32), torch.empty((bs, h), **f32),
                 torch.empty((bs, h, n, p), **f32)]

        def parent_call():
            code = p_ssd_bwd.ssd_scan_bwd_launch(
                ptr(x), ptr(dt), ptr(a_log), ptr(bm), ptr(cm), ptr(d_skip),
                ptr(states), ptr(dy), None, *[ptr(t) for t in pbufs], bs, s,
                h, g, p, n, 1, x.stride(0), x.stride(1), bm.stride(0),
                bm.stride(1), stream())
            assert code == 0, code
            dx, ddt, dbh, dch, da_, dd_, _ = pbufs

            def gsum(t):
                return t.view(bs, s, g, h // g, n).sum(dim=3).to(bm.dtype)
            return (dx, ddt, da_.sum(dim=0), gsum(dbh), gsum(dch),
                    dd_.sum(dim=0))

        def change_call():
            return SS._scan_grad(x, dt, a_log, bm, cm, d_skip, None, states,
                                 dy, None, 128, needs)[:6]

        want = SS.ssd_scan_grad(x.float(), dt, a_log, bm.float(), cm.float(),
                                d_skip, None, dy.float(), None, 128, needs)
        holds = {}
        names = ("dx", "ddt", "da_log", "db", "dc", "dd_skip")
        for tag, fn in (("parent", parent_call), ("change", change_call)):
            first = [t.clone() for t in fn()]
            again = fn()
            if not all(torch.equal(a, b_) for a, b_ in zip(first, again)):
                raise AssertionError(f"{name}: two {tag} passes differ")
            holds[tag] = {
                nm: ((a.float() - w.float()).abs()
                     / (1 + w.float().abs())).max().item()
                for nm, a, w in zip(names, first, want)}
            if max(holds[tag].values()) > TOL:
                raise AssertionError(f"{name}: {tag} {holds[tag]} past {TOL}")
        times = turns({"parent": parent_call, "change": change_call},
                      args.reps)
        profiled.append(("ssd_scan_bwd", name,
                         {"parent": parent_call, "change": change_call}))
        flops, nbytes = SS.ssd_scan_grad_work(bs, s, h, g, p, n, 2)
        bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        row = {"shape": [bs, s, h, g, p, n], "ms": times, "bound_ms": bound,
               "bound_by": ("operations" if flops / 989e12 > nbytes / 3.35e12
                            else "bytes"),
               "reading": holds}
        report["ssd_scan_bwd"][name] = row
        print(f"[ab] ssd_scan_bwd {name} {row['shape']}: " + ", ".join(
            f"{t} {' / '.join(f'{x_:.4f}' for x_ in v_)} ms"
            for t, v_ in times.items()) + f"; bound {bound:.5f}; readings "
            f"{holds}", flush=True)

    for name, shape in SSD.items():
        ssd_case(name, *shape)
        torch.cuda.empty_cache()

    # -- the serving forward, whose helpers moved into a header; both
    # kernels called through their C interfaces the same way -------------
    lib_flash = _build.load("flash_attention")
    for name, (b, sq, skv, h, kv, d, causal) in FORWARD.items():
        q = rand((b, sq, h, d), 11).to(torch.bfloat16)
        k = rand((b, skv, kv, d), 12).to(torch.bfloat16)
        v = rand((b, skv, kv, d), 13).to(torch.bfloat16)
        pout = torch.empty_like(q)

        def parent_fwd():
            code = p_flash.flash_attention_launch(
                ptr(q), ptr(k), ptr(v), ptr(pout), None, None, b, sq, skv,
                h, kv, d, int(causal), 0, 1, stream())
            assert code == 0, code
            return pout

        cout = torch.empty_like(q)

        def change_fwd():
            code = lib_flash.flash_attention_launch(
                ptr(q), ptr(k), ptr(v), ptr(cout), None, None, b, sq, skv,
                h, kv, d, int(causal), 0, 1, stream())
            assert code == 0, code
            return cout

        if not torch.equal(parent_fwd().clone(), change_fwd()):
            raise AssertionError(f"{name}: the forwards differ")
        times = turns({"parent": parent_fwd, "change": change_fwd},
                      args.reps)
        report["flash_attention"][name] = {"shape": [b, sq, skv, h, kv, d,
                                                     causal], "ms": times}
        print(f"[ab] flash_attention {name}: " + ", ".join(
            f"{t} {' / '.join(f'{x_:.4f}' for x_ in v_)} ms"
            for t, v_ in times.items()), flush=True)
        del q, k, v, pout, cout

    # -- where each backward call's device time goes (after every timing:
    # a profiler session slows the host's launches for the rest of the
    # process) -----------------------------------------------------------
    for kernel, name, fns in profiled:
        split = {tag: kernel_split(fn) for tag, fn in fns.items()}
        total = {tag: sum(v.values()) for tag, v in split.items()}
        report[kernel][name]["device_ms_by_kernel"] = split
        report[kernel][name]["device_ms"] = total
        print(f"[ab] {kernel} {name} device ms a call {total}; by kernel "
              f"{split}", flush=True)

    logs = {name: _build._lib_path(name).with_suffix(".log").read_text()
            for name in ("flash_attention_bwd", "ssd_scan_bwd")}
    report["ptxas"] = {
        "flash_attention_bwd": ptxas_figures(logs["flash_attention_bwd"],
                                             "flash_bwd"),
        "ssd_scan_bwd": ptxas_figures(logs["ssd_scan_bwd"], "ssd_bwd"),
        "parent_flash_attention_bwd": ptxas_figures(
            p_flash_bwd.ptxas_log, "flash_bwd"),
        "parent_ssd_scan_bwd": ptxas_figures(p_ssd_bwd.ptxas_log, "ssd_bwd")}
    for lib, figs in report["ptxas"].items():
        for fn, f in figs.items():
            print(f"[ab] ptxas {lib} {fn}: {f}")
    print(f"[ab] on {card}")
    out_path = ROOT / "chiprun_out" / "bwd_ab.json"
    out_path.parent.mkdir(exist_ok=True)
    out_path.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
