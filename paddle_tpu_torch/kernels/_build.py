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
    # q, k_pages, v_pages, table, pos, out, batch, heads, kv_heads,
    # head_dim, page_size, table_width, q_dtype, kv_dtype, scale, stream
    "ptt_paged_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _F, _P],
    # q, k_q, k_scale, v_q, v_scale, table, pos, out, batch, heads,
    # kv_heads, head_dim, page_size, table_width, q_dtype, scale, stream
    "ptt_paged_attention_int8_fwd": [_P] * 8 + [_I] * 7 + [_F, _P],
    # x, w_q, scale, out, partial (or null), rows, K, N, kchunk, x_dtype,
    # stream
    "ptt_int8_matmul": [_P] * 5 + [_I] * 5 + [_P],
    # q, k, v, o, lse, batch, heads, sq, sk, head_dim, (batch, seq, head)
    # strides of q, k, v, causal, scale, dtype, stream
    "ptt_flash_attention_fwd": [_P] * 5 + [_I] * 5 + [_L] * 9
    + [_I, _F, _I, _P],
    # q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads, sq, sk,
    # head_dim, strides of q, k, v, o, dout, causal, scale, dtype, stream
    "ptt_flash_attention_bwd": [_P] * 10 + [_I] * 5 + [_L] * 15
    + [_I, _F, _I, _P],
}

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

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


def stream_of(t):
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
