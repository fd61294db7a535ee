"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
by ``nvcc`` into a shared library under ``build/repro_torch_kernels/`` at
the root of the checkout (listed in ``.gitignore``).  The library name
carries a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused.  All sources are compiled at once, one
``nvcc`` process each, the first time any kernel is needed.

Nothing here runs at import time: the CPU tests import every module, and
this host may have no ``nvcc``.  The launch counters live here too: each
wrapper adds one to its kernel's count where it launches the kernel, and
nowhere else; a backward kernel (``flash_attention_bwd``,
``ssd_scan_bwd``) counts one a backward call, however many launches it
makes.  :func:`refuse_grad` is the guard of every wrapper whose kernel
has no backward.

On a meta tensor (shapes only, ``launch.dryrun``) the attention and scan
wrappers, and the backwards of their trainable forms, launch nothing and
count nothing: they allocate their outputs on the meta device and,
inside :func:`record_meta_work`, note the operations
and bytes their kernel would do (:func:`note_meta_work`); inside
:func:`plain_on_meta` they run their plain twin's tensor ops instead (the
roofline's walk of the unfused step).  Neither acts on a CPU or CUDA
tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = [
    "SOURCES",
    "SIGNATURES",
    "build_all",
    "load",
    "launch_counts",
    "reset_launch_counts",
    "count_launch",
    "record_meta_work",
    "note_meta_work",
    "plain_on_meta",
    "meta_runs_plain",
    "check",
    "refuse_grad",
    "stack_frames",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch_kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo"]
# name -> (source file, extra flags).  The scan and the selection must stay
# bit-equal to their plain versions, so the compiler may not contract any
# float op into an FMA there.
SOURCES = {
    "sojourn_cells": ("sojourn_cells.cu", ["-fmad=false"]),
    "coded_cells": ("coded_cells.cu", ["-fmad=false"]),
    "combine": ("combine.cu", []),
    "flash_attention": ("flash_attention.cu", []),
    "flash_attention_bwd": ("flash_attention_bwd.cu", []),
    "decode_attention": ("decode_attention.cu", []),
    "ssd_scan": ("ssd_scan.cu", []),
    "ssd_scan_bwd": ("ssd_scan_bwd.cu", []),
}

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PINT = ctypes.POINTER(ctypes.c_int)
# name -> {C function: (argtypes, restype)}: the plain C interface of each
# library, declared once when it is loaded
SIGNATURES = {
    "sojourn_cells": {
        "sojourn_cells_launch": ([_PTR] * 9 + [_INT] * 5 + [_PTR], _INT),
        "sojourn_cells_max_groups": ([], _INT),
        "sojourn_cells_wide_launch": ([_PTR] * 10 + [_INT] * 7 + [_PTR], _INT),
        "sojourn_cells_max_wide_groups": ([], _INT),
        "sojourn_cells_wide_split": ([_INT, _PINT, _PINT], _INT),
        "sojourn_cells_state_words": ([_INT] * 3, _I64),
    },
    "coded_cells": {
        "coded_cells_launch": ([_PTR] * 5 + [_INT] * 4 + [_PTR], _INT),
        "coded_cells_floor_launch": ([_PTR] * 5 + [_INT] * 4 + [_PTR], _INT),
        "coded_cells_max_staged_n": ([], _INT),
        "coded_cells_host_quorums": ([], _INT),
        "coded_cells_max_passes": ([], _INT),
    },
    "combine": {
        "combine_launch": ([_PTR] * 3 + [_INT] * 3 + [_PTR], _INT),
        "combine_path": ([_INT] * 2, _INT),
    },
    "flash_attention": {
        "flash_attention_launch": ([_PTR] * 6 + [_INT] * 9 + [_PTR], _INT),
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": ([_PTR] * 11 + [_INT] * 9 + [_PTR],
                                       _INT),
    },
    "decode_attention": {
        "decode_attention_launch": ([_PTR] * 4 + [_INT] * 9 + [_PTR], _INT),
    },
    "ssd_scan": {
        "ssd_scan_launch": ([_PTR] * 10 + [_INT] * 7 + [_I64] * 4 + [_PTR],
                            _INT),
    },
    "ssd_scan_bwd": {
        "ssd_scan_bwd_launch": ([_PTR] * 16 + [_INT] * 7 + [_I64] * 4
                                + [_PTR], _INT),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LAUNCHES = {name: 0 for name in SOURCES}
BUILD_SECONDS: dict[str, float] = {}


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


_META_WORK: list = []


@contextlib.contextmanager
def record_meta_work():
    """Collects, in the list it yields, one (kernel, operations, bytes) a
    wrapper call on meta tensors while the block runs."""
    work: list = []
    _META_WORK.append(work)
    try:
        yield work
    finally:
        _META_WORK.remove(work)


def note_meta_work(name: str, flops: float, nbytes: float) -> None:
    """A wrapper's meta-tensor call: its kernel's work, to every open
    :func:`record_meta_work` (nothing when none is open)."""
    for work in _META_WORK:
        work.append((name, float(flops), float(nbytes)))


_PLAIN_ON_META: list = []


@contextlib.contextmanager
def plain_on_meta():
    """While the block runs, a wrapper called on meta tensors runs its
    plain twin's tensor ops in place of noting its kernel's work."""
    _PLAIN_ON_META.append(True)
    try:
        yield
    finally:
        _PLAIN_ON_META.pop()


def meta_runs_plain() -> bool:
    """Whether a :func:`plain_on_meta` block is open."""
    return bool(_PLAIN_ON_META)


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str) -> list[str]:
    return ARCH_FLAGS + BASE_FLAGS + SOURCES[name][1]


def _lib_path(name: str) -> Path:
    src = CSRC / SOURCES[name][0]
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> dict[str, float]:
    """Compile every kernel whose library is missing, all in parallel.

    Returns the wall seconds of the build (0.0 for a library that was
    already there).  Raises ``RuntimeError`` with nvcc's output when any
    source fails to compile.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, (src, _) in SOURCES.items():
        out = _lib_path(name)
        if out.exists():
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        (out.with_suffix(".log")).write_text(log)
        if verbose:
            print(f"[build] {name}: {BUILD_SECONDS[name]:.1f}s\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return dict(BUILD_SECONDS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building all kernels if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    lib.repro_error_string.restype = ctypes.c_char_p
    lib.repro_error_string.argtypes = [_INT]
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad: ``what`` has
    no backward, and a kernel's output carries no autograd graph, so
    training through it would silently drop the inputs' gradients.  The
    rule holds on every device, so the CPU tests see it too."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad() or on "
            f"inputs that do not require grad (the trainable forms are "
            f"kernels.flash_attention.FlashAttentionFn and "
            f"kernels.ssm_scan.SsdScanFn)")


_FRAME = re.compile(r"Function properties for (\S+)\s+(\d+) bytes stack frame, "
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def stack_frames(log: str) -> dict[str, tuple[int, int, int]]:
    """{mangled function: (stack frame, spill store, spill load bytes)} from
    the ``-Xptxas -v`` output that :func:`build_all` keeps beside each
    library (``lib<name>_<hash>.log``); non-zero means local memory."""
    return {m[1]: (int(m[2]), int(m[3]), int(m[4]))
            for m in _FRAME.finditer(log)}
