"""Builds and loads the port's hand-written CUDA kernels.

Every ``paddle_tpu_torch/csrc/*.cu`` file is compiled for Hopper with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into an object file (one
``nvcc`` per source, all started together), and the objects are linked
into ``build/paddle_tpu_torch/libkernels.so`` at the root of the
checkout (``build/`` is listed in ``.gitignore``). The library has a
plain C interface and is loaded with ``ctypes``: no PyTorch headers are
compiled, so a build takes seconds, not minutes.

The build happens at the first :func:`load`, never at import: the tests
import every module on machines without ``nvcc`` or a card. A library
that is newer than every source is reused. When ``nvcc`` or the card is
missing, :func:`load` raises a ``RuntimeError`` that names what is
missing; nothing falls back to another implementation.

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; the
wrappers call :func:`check` on it.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "paddle_tpu_torch"
LIB_PATH = BUILD_DIR / "libkernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)
# name -> argtypes of every C entry point in csrc/ (restype is int: the
# cudaError_t of the launch). Without argtypes ctypes would pass Python
# ints as 32-bit C ints and cut the pointers.
SIGNATURES = {
    # x, w, y, rstd (or null), rows, hidden, dtype, eps, stream
    "ptt_rms_norm_fwd": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    # x, w, g, rstd, dx, dw, partials, rows, hidden, ctas, dtype, stream
    "ptt_rms_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, q_out, heads_q, k, k_out, heads_k, cos, sin, pos_ids,
    # batch, seq, head_dim, tab_batch, tab_rows, dtype, stream
    "ptt_rope_fwd": [_P, _P, _I, _P, _P, _I, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _P],
    # the same with the gradients of q and k in and out
    "ptt_rope_bwd": [_P, _P, _I, _P, _P, _I, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _P],
    # q, k_pages, v_pages, table, pos, out, scores, stats, partials,
    # counters, batch, heads, kv_heads, head_dim (padded), kv_dim,
    # page_size, table_width, chunk, max_chunks, q_dtype, kv_dtype, scale,
    # stream
    "ptt_paged_attention_fwd": [_P] * 10 + [_I] * 11 + [_F, _P],
    # q, k_q, k_scale, v_q, v_scale, table, pos, out, scores, stats,
    # partials, counters, batch, heads, kv_heads, head_dim (padded),
    # kv_dim, page_size, table_width, chunk, max_chunks, q_dtype, scale,
    # stream
    "ptt_paged_attention_int8_fwd": [_P] * 12 + [_I] * 10 + [_F, _P],
    # x (fp32), w_q, scale, out, partial (or null), rows, K, N, kchunk,
    # stream
    "ptt_int8_matmul": [_P] * 5 + [_I] * 4 + [_P],
    # x, w_q, scale, out, partial (or null), rows, K, N, kchunk,
    # swap_rows (0: the tiled kernel), stream
    "ptt_int8_matmul_tc": [_P] * 5 + [_I] * 5 + [_P],
    # q, k, v, o, lse, batch, heads, sq, sk, head_dim, (batch, seq, head)
    # strides of q, k, v, causal, scale, dtype, work (or null),
    # cuda_cores, stream
    "ptt_flash_attention_fwd": [_P] * 5 + [_I] * 5 + [_L] * 9
    + [_I, _F, _I, _P, _I, _P],
    # q, k, v, o, cos, sin, table row stride, batch, heads, seq,
    # head_dim, (batch, seq, head) strides of q, k, v, causal, scale,
    # dtype, work (or null), cuda_cores, stream
    "ptt_rope_attention_fwd": [_P] * 6 + [_L] + [_I] * 4 + [_L] * 9
    + [_I, _F, _I, _P, _I, _P],
    # x, w, wm, out, partial (or null), rows, K, N, kchunk, eps, stream
    # (fp32)
    "ptt_rms_norm_matmul": [_P] * 5 + [_I] * 4 + [_F, _P],
    # x, w, wm, out, rstd, partial (or null), rows, K, N, kchunk,
    # swap_rows (0: the tiled kernel), w_dtype, eps, stream (bf16)
    "ptt_rms_norm_matmul_tc": [_P] * 6 + [_I] * 6 + [_F, _P],
    # x, w, wm, out, rstd, work, rows, K, N, eps, stream (fp32, the
    # split design)
    "ptt_rms_norm_matmul_split": [_P] * 6 + [_I] * 3 + [_F, _P],
    # a, bt, sa, sb, out, M, N, K, a format, bt format (0 e4m3, 1 e5m2),
    # out dtype, stream (csrc/fp8_matmul.cu)
    "ptt_fp8_gemm": [_P] * 5 + [_I] * 6 + [_P],
    # x, q (or null), qt (or null), amax (or null), scale (or null), rows,
    # cols, x dtype, e5m2, stream
    "ptt_fp8_quantize": [_P] * 5 + [_I] * 4 + [_P],
    # stream: an empty kernel (the launch floor)
    "ptt_empty": [_P],
    # q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads, sq, sk,
    # head_dim, strides of q, k, v, o, dout, causal, scale, dtype, work
    # (or null), cuda_cores, stream
    "ptt_flash_attention_bwd": [_P] * 10 + [_I] * 5 + [_L] * 15
    + [_I, _F, _I, _P, _I, _P],
    # the multi-tensor kernels (csrc/multi_tensor.cu): host arrays of
    # pointers and numels (and slots), the count, dtype codes, ...,
    # kernels launched (out), stream.
    # gradients, numels, dtype codes, count, inv, stats, partial,
    # workspace chunks, clip_norm, skip_nonfinite, launches, stream
    "ptt_mt_sumsq": [_P, _P, _P, _I, _P, _P, _P, _L, _F, _I, _PI, _P],
    # (p, g, m, v) pointers, numels, slots, count, p dtype, g dtype,
    # prologue pointers, floats, ints, hyper, decoupled, launches, stream
    "ptt_mt_adam": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _PI, _P],
    # (p, g, velocity) pointers, ..., prologue, lr, mu, nesterov,
    # launches, stream
    "ptt_mt_momentum": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _F, _F, _I,
                        _PI, _P],
    # (p, g, m, v) pointers, ..., prologue, hyper, sums, partial,
    # workspace chunks, launches, stream
    "ptt_mt_lamb": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _L,
                    _PI, _P],
}

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float16: 3}
# the floating types the training kernels take (rows 1, 2, 3a, 3b, 6a, 6b
# of PERF.md's table, and the multi-tensor updates)
FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)


def fp16_refused(kernel, item):
    """The TypeError of a kernel that has no fp16 version yet, naming
    the ``ROADMAP.md`` queue B fp16 line that holds it."""
    return TypeError(
        f"{kernel} has no float16 version on the card yet (ROADMAP.md "
        f"queue B, fp16 item {item}); run it in float32 or bfloat16")

_LIB = None
_LOCK = threading.Lock()
build_seconds = None  # wall time of the last build in this process


def find_nvcc():
    """Path of ``nvcc``: on PATH, under ``$CUDA_HOME/bin``, or under
    ``/usr/local/cuda/bin``; None when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    return None


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _stale():
    if not LIB_PATH.is_file():
        return True
    built = LIB_PATH.stat().st_mtime
    deps = sources() + sorted(CSRC_DIR.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


def build(nvcc):
    """Compile every source into an object in parallel, then link the
    shared library (written under a temporary name, then renamed, so a
    concurrent loader never sees a half-written file)."""
    global build_seconds
    import time

    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{src.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = BUILD_DIR / f"libkernels.{tag}.so"
    link = subprocess.run(
        [nvcc, "-shared", *ARCH_FLAGS, "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, LIB_PATH)
    build_seconds = time.perf_counter() - t0


def load():
    """The loaded kernel library, built first when missing or stale.
    Raises RuntimeError naming what is missing (the GPU or nvcc)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch kernels need a CUDA GPU and none is "
                "available (torch.cuda.is_available() is False)"
            )
        if _stale():
            nvcc = find_nvcc()
            if nvcc is None:
                raise RuntimeError(
                    "paddle_tpu_torch kernels are built with nvcc, which "
                    "was not found on PATH, under $CUDA_HOME/bin or under "
                    "/usr/local/cuda/bin"
                )
            build(nvcc)
        lib = ctypes.CDLL(str(LIB_PATH))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def check(err, name):
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err:
        msg = load().ptt_error_string(err)
        raise RuntimeError(
            f"{name}: CUDA error {err}: "
            f"{msg.decode() if msg else 'unknown'}"
        )


def launch_empty(device):
    """Launch the library's empty kernel on ``device``'s current stream,
    through the ctypes path every kernel takes: timed back to back, the
    floor under any kernel's time."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        err = load().ptt_empty(
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    check(err, "ptt_empty")


def stream_of(t):
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


_SMS = {}


def sm_count(dev):
    """Streaming multiprocessors of CUDA device ``dev`` (cached)."""
    idx = torch.device(dev).index or 0
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]
