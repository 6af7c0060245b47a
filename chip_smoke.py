#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports neither jax nor ``paddle_tpu``. Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build: every ``paddle_tpu_torch/csrc/*.cu`` compiled with nvcc for
   sm_90a, seconds and library path printed;
3. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the Llama-2-7B shapes of the serving, training and
   quantized-serving paths, in bf16 and fp32, with the tolerance stated
   per kernel, and timed (CUDA events, median) beside its bound, its
   plain version and, where one PyTorch call computes the same function,
   that call (the W8A16 matmul: beside the composed dequantize-then-
   ``torch.matmul`` and the float weight's ``torch.matmul``); the
   backward kernels and the W8A16 matmul must repeat bit for bit;
4. small parity: a tiny fp32 Llama on the card, whose paged-engine
   greedy streams must equal ``generate`` with an fp32 slab cache
   token for token; then the same model quantized
   (``quantize_for_serving``), whose paged and slab engines' streams
   with an int8 cache must equal ``generate(cache_dtype="int8")``;
5. tiny train parity: a 2-layer fp32 Llama takes one
   ``CompiledTrainStep`` on the card and the same step on the CPU (the
   plain versions) from the same weights; the loss and every parameter
   after the step must agree;
6. training: Llama-2-7B widths with 8 of its 32 layers (1.88B fp32
   parameters from a seeded generator), AdamW with weight decay 0.01, a
   linear warmup and global-norm clipping at 1.0, AMP O1 bf16, 10 steps
   on one fixed batch of 2 x 2048 tokens; every loss finite, the last
   below the first, and every training kernel launched the number of
   times per step the model's structure gives;
7. serving: Llama-2-7B at full width and depth (random bf16 weights
   from a seeded generator) served by ``PagedServingEngine`` (8 rows,
   2048 slots, page size 16, bf16 arena) for 12 staggered requests of
   64 new tokens; every serving kernel must have launched during this
   phase, no page may leak, and every generated token must pass a
   teacher-forced check against the cache-free forward (which attends
   through the flash attention kernel);
8. quantized serving: the same Llama-2-7B weights through
   ``quantize_for_serving`` (int8 weights, W8A16 kernel) and the same 12
   requests through ``PagedServingEngine`` with an int8 KV arena; the
   int8 paged attention and the W8A16 kernels must have launched the
   counts the structure gives (32 and 6 x 32 + 1 per decode step, 193
   per prefill), no page may leak, and every generated token must pass
   a teacher-forced check against one slab prefill of the whole
   sequence with an int8 cache (the same quantization, composed
   attention).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth, and the
# operation rate for each input type (bf16 on the tensor cores, fp32 on
# the CUDA cores), the two floors every kernel here is held against
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# teacher-forced check: a generated token that is not the argmax of the
# cache-free forward's logits must trail it by less than this many
# logits (8 bf16 ulps at |logit| in [2, 4), where ulp = 2^-6; the two
# paths round scores, probabilities and activations at different places)
NEAR_TIE = 0.125

# kernel tolerances (absolute, on max |kernel - plain| over the output):
# - rms_norm / rope, bf16: one bf16 ulp of the largest output, 2^-7 *
#   max|plain| (the sum of squares is reduced in another order, so rstd
#   may differ in the last fp32 bit and flip one rounding); fp32:
#   1e-5 * max|plain| (rsqrtf is within 2 ulp, the order differs);
# - paged attention, float and int8 arenas: bf16 1e-2 (scores are summed
#   in another order, so a probability may round to the neighbouring bf16
#   value before the value product); fp32 1e-5 (fp32 sums over up to 2048
#   slots in another order). Both sides dequantize an int8 row the same
#   way, float(q) * scale in fp32.
# - the W8A16 matmul: cast once (below), fp32 1e-5 * max|plain| (both
#   sides take the same dequantized weight and sum up to 11008 fp32
#   products in another order).
# - the backward kernels and flash attention (both sides compute in fp32
#   and cast once): fp32 1e-5 * max|plain| for O, RMSNorm dx and rope,
#   1e-4 * max|plain| for sums over thousands of rows that cancel
#   (RMSNorm dw, flash dQ/dK/dV); LSE 1e-5 * max|plain|. bf16 holds EACH
#   entry: |kernel_i - plain_i| <= 2^-7 * |plain_i| (at least one bf16
#   ulp of that entry, under two) + the fp32 tolerance (the fp32 values
#   before the cast differ by that much, so the cast may round them one
#   ulp apart; at the bottom of a binade that comes to just under the
#   entry's tolerance).
REL_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
PAGED_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
SUM_TOL32 = 1e-4

# the training phase: Llama-2-7B widths, 8 of 32 layers (fp32 parameters,
# gradients and two Adam moments of the full depth take 16 B x 6.74B =
# 108 GB, more than the card's 80 GB; 8 layers take 30 GB), B 2 x S 2048
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 2048, 10

# tiny train parity on the card against the CPU: the loss within 1e-5
# relative and every parameter within 1e-5 absolute after one AdamW step
# (fp32 math in other orders; epsilon 1e-3 keeps the update a smooth
# function of the gradient, so a gradient that differs by 1e-7 moves its
# parameter by about as much instead of flipping a sign near zero)
TINY_LOSS_RTOL, TINY_PARAM_ATOL = 1e-5, 1e-5


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def gpu_time_ms(torch, fn, n=20, repeats=7):
    """Median device time of one call of ``fn``: ``n`` calls queued
    behind a sleep kernel (so the host's launch overhead hides behind
    it and the calls run back to back), timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(bytes_moved, flops, dtype):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the card's peak rate for the inputs' ``dtype``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def cast_once(name, got, want, tol32, dname):
    """The check of an output that both sides compute in fp32 and cast
    once: fp32 within ``tol32 * max|want|``; bf16 entry by entry within
    2^-7 of the entry plus that fp32 tolerance."""
    if dname == "float32":
        return name, got, want, tol32, None
    return name, got, want, 2.0 ** -7, tol32


def checks(torch, pairs):
    """[{output, max_abs_err, tolerance, err_over_tol}] for (name, got,
    want, rel, floor): with ``floor`` None every entry is held to ``rel *
    max|want|``; else entry i to ``rel * |want_i| + floor * max|want|``,
    and ``tolerance`` is the largest of those. ``err_over_tol`` is the
    largest ratio of an entry's error to its tolerance (a check passes at
    <= 1). Returns the checks and the tightest one, whose numbers the case
    reports."""
    out = []
    for n, g, w, rel, floor in pairs:
        err = (g.float() - w.float()).abs()
        ref = w.float().abs()
        top = float(ref.max())
        if floor is None:
            tol = rel * top
            ratio = float(err.max()) / max(tol, 1e-30)
        else:
            tol_i = rel * ref + floor * top
            tol = float(tol_i.max())
            ratio = float((err / tol_i).max())
        out.append({"output": n, "max_abs_err": float(err.max()),
                    "tolerance": tol, "err_over_tol": ratio,
                    "per_entry": floor is not None})
    worst = max(out, key=lambda c: c["err_over_tol"])
    return out, worst


def grad_time_ms(torch, outputs, inputs, grads, n=5, repeats=5):
    """Device time of the autograd backward of a graph built once."""
    return gpu_time_ms(torch, lambda: torch.autograd.grad(
        outputs, inputs, grads, retain_graph=True), n=n, repeats=repeats)


# ------------------------------------------------------------ kernels
def rms_norm_cases(torch, mod, dev):
    out = []
    g = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (8, 1024):
            h = 4096
            x = torch.randn(rows, h, generator=g, device=dev).to(dtype)
            w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(dtype)
            y = mod.rms_norm_cuda(x, w, 1e-5)
            ref = mod.rms_norm_reference(x, w, 1e-5)
            dname = str(dtype).replace("torch.", "")
            tol = REL_TOL[dname] * float(ref.float().abs().max())
            es = x.element_size()
            b_ms, b_by = bound(2 * rows * h * es + h * w.element_size(),
                               4 * rows * h, dname)
            out.append({
                "shape": [rows, h], "dtype": dname,
                "max_abs_err": max_err(torch, y, ref), "tolerance": tol,
                "ms": gpu_time_ms(torch, lambda: mod.rms_norm_cuda(
                    x, w, 1e-5)),
                "plain_ms": gpu_time_ms(torch, lambda: mod.rms_norm_reference(
                    x, w, 1e-5)),
                "library_ms": gpu_time_ms(
                    torch, lambda: torch.nn.functional.rms_norm(
                        x, (h,), w, 1e-5)),
                "bound_ms": b_ms, "bound_by": b_by,
            })
    return out


def rope_cases(torch, mod, dev):
    out = []
    g = torch.Generator(device=dev).manual_seed(2)
    cos_full, sin_full = mod.build_rope_cache(2048, 128, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        # decode: [8, 1, 32, 128] per-row positions into the full table
        # (the continuous-batching step); prefill: [1, 1024, 32, 128]
        # with a shared table of 1024 rows
        pid = torch.tensor([[0], [15], [300], [777], [1024], [1500],
                            [2000], [2047]], dtype=torch.int32, device=dev)
        for b, s, tabs, ids in (
                (8, 1, (cos_full, sin_full), pid),
                (1, 1024, (cos_full[:, :1024], sin_full[:, :1024]), None)):
            q = torch.randn(b, s, 32, 128, generator=g, device=dev).to(dtype)
            k = torch.randn(b, s, 32, 128, generator=g, device=dev).to(dtype)
            cos, sin = tabs
            qo, ko = mod.rope_cuda(q, k, cos, sin, ids)
            rq = mod.rope_reference(q, cos, sin, ids)
            rk = mod.rope_reference(k, cos, sin, ids)
            err = max(max_err(torch, qo, rq), max_err(torch, ko, rk))
            tol = REL_TOL[dname] * max(float(rq.float().abs().max()),
                                       float(rk.float().abs().max()))
            es = q.element_size()
            tab_rows = b * s if ids is not None else s
            nbytes = (4 * q.numel() * es + 2 * tab_rows * 64 * 4
                      + (ids.numel() * 4 if ids is not None else 0))
            b_ms, b_by = bound(nbytes, 3 * 2 * q.numel(), dname)
            out.append({
                "shape": [b, s, 32, 128], "dtype": dname,
                "tables": "per-row ids" if ids is not None else "shared",
                "max_abs_err": err, "tolerance": tol,
                "ms": gpu_time_ms(torch, lambda: mod.rope_cuda(
                    q, k, cos, sin, ids)),
                "plain_ms": gpu_time_ms(torch, lambda: (
                    mod.rope_reference(q, cos, sin, ids),
                    mod.rope_reference(k, cos, sin, ids))),
                "library_ms": None,
                "bound_ms": b_ms, "bound_by": b_by,
            })
    return out


def paged_inputs(torch, dev, dtype, kvh, g):
    b, h, d, ps, width = 8, 32, 128, 16, 128
    pos = torch.tensor([0, 15, 300, 777, 1024, 1500, 2000, 2047],
                       dtype=torch.int32, device=dev)
    n_pages = b * width + 1
    k_pages = torch.randn(n_pages, ps, kvh, d, generator=g,
                          device=dev).to(dtype)
    v_pages = torch.randn(n_pages, ps, kvh, d, generator=g,
                          device=dev).to(dtype)
    # the garbage page holds large values: a kernel that read it inside
    # a row's live range would be far off the plain version
    k_pages[0] = 1e4
    v_pages[0] = 1e4
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    table = perm.reshape(b, width).to(torch.int32)
    live = (pos.long() // ps + 1)[:, None]
    cols = torch.arange(width, device=dev)[None, :]
    table = torch.where(cols < live, table, torch.zeros_like(table))
    q = torch.randn(b, 1, h, d, generator=g, device=dev).to(dtype)
    return q, k_pages, v_pages, table.contiguous(), pos


def paged_cases(torch, mod, dev):
    out = []
    g = torch.Generator(device=dev).manual_seed(3)
    for dtype, kvh in ((torch.bfloat16, 32), (torch.float32, 32),
                       (torch.bfloat16, 8), (torch.float32, 8)):
        dname = str(dtype).replace("torch.", "")
        q, kp, vp, tbl, pos = paged_inputs(torch, dev, dtype, kvh, g)
        o = mod.paged_attention_cuda(q, kp, vp, tbl, pos)
        ref = mod.paged_attention_reference(q, kp, vp, tbl, pos)
        if not torch.isfinite(o).all():
            fail("paged attention kernel produced non-finite values")
        es = q.element_size()
        slots = int((pos.long() + 1).sum())
        d = 128
        nbytes = (2 * slots * kvh * d * es + 2 * q.numel() * es
                  + int((pos.long() // 16 + 1).sum()) * 4 + 4 * 8)
        b_ms, b_by = bound(nbytes, 4 * slots * 32 * d, dname)
        out.append({
            "shape": {"q": list(q.shape), "pages": list(kp.shape),
                      "pos": [int(p) for p in pos]},
            "dtype": dname, "kv_heads": kvh,
            "max_abs_err": max_err(torch, o, ref),
            "tolerance": PAGED_TOL[dname],
            "ms": gpu_time_ms(torch, lambda: mod.paged_attention_cuda(
                q, kp, vp, tbl, pos)),
            "plain_ms": gpu_time_ms(
                torch, lambda: mod.paged_attention_reference(
                    q, kp, vp, tbl, pos), n=5, repeats=5),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
        })
    return out


def rms_norm_bwd_cases(torch, mod, dev):
    """[4096, 4096]: the 7B training batch's rows (2 x 2048) at hidden
    4096, fp32 (the O1 residual stream the norms see) and bf16."""
    out = []
    g = torch.Generator(device=dev).manual_seed(7)
    rows, h = TRAIN_BATCH * TRAIN_SEQ, 4096
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        x = torch.randn(rows, h, generator=g, device=dev).to(dtype)
        w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(dtype)
        gy = torch.randn(rows, h, generator=g, device=dev).to(dtype)
        _, rstd = mod.rms_norm_cuda(x, w, 1e-5, return_rstd=True)
        dx, dw = mod.rms_norm_backward_cuda(x, w, gy, rstd)
        rdx, rdw = mod.rms_norm_backward_reference(x, w, gy, rstd)
        dx2, dw2 = mod.rms_norm_backward_cuda(x, w, gy, rstd)
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            fail(f"rms_norm backward {dname} does not repeat bit for bit")
        cs, worst = checks(torch, [
            cast_once("dx", dx, rdx, REL_TOL["float32"], dname),
            cast_once("dw", dw, rdw, SUM_TOL32, dname)])
        es = x.element_size()
        b_ms, b_by = bound(3 * rows * h * es + 2 * h * es + 4 * rows,
                           10 * rows * h, dname)
        xl = x.clone().requires_grad_(True)
        wl = w.clone().requires_grad_(True)
        yl = torch.nn.functional.rms_norm(xl, (h,), wl, 1e-5)
        out.append({
            "shape": [rows, h], "dtype": dname, "checks": cs,
            "max_abs_err": worst["max_abs_err"],
            "tolerance": worst["tolerance"],
            "err_over_tol": worst["err_over_tol"], "repeats_bitwise": True,
            "ms": gpu_time_ms(torch, lambda: mod.rms_norm_backward_cuda(
                x, w, gy, rstd)),
            "plain_ms": gpu_time_ms(
                torch, lambda: mod.rms_norm_backward_reference(
                    x, w, gy, rstd)),
            "library_ms": grad_time_ms(torch, yl, (xl, wl), gy, n=20,
                                       repeats=7),
            "library_call": "autograd backward of F.rms_norm",
            "bound_ms": b_ms, "bound_by": b_by,
        })
        del xl, wl, yl
    return out


def rope_bwd_cases(torch, mod, dev):
    """The training shape: q and k gradients [2, 2048, 32, 128] bf16 with
    the shared [1, 2048, 1, 64] table."""
    g = torch.Generator(device=dev).manual_seed(8)
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, 32, 128
    cos, sin = mod.build_rope_cache(s, d, device=dev)
    out = []
    for dtype in (torch.bfloat16,):
        dname = str(dtype).replace("torch.", "")
        gq = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
        gk = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
        dq, dk = mod.rope_cuda(gq, gk, cos, sin, inverse=True)
        rq = mod.rope_backward_reference(gq, cos, sin)
        rk = mod.rope_backward_reference(gk, cos, sin)
        cs, worst = checks(torch, [
            cast_once("dq", dq, rq, REL_TOL["float32"], dname),
            cast_once("dk", dk, rk, REL_TOL["float32"], dname)])
        es = gq.element_size()
        b_ms, b_by = bound(4 * gq.numel() * es + 2 * s * (d // 2) * 4,
                           3 * 2 * gq.numel(), dname)
        out.append({
            "shape": [b, s, h, d], "dtype": dname, "tables": "shared",
            "checks": cs, "max_abs_err": worst["max_abs_err"],
            "tolerance": worst["tolerance"],
            "err_over_tol": worst["err_over_tol"],
            "ms": gpu_time_ms(torch, lambda: mod.rope_cuda(
                gq, gk, cos, sin, inverse=True)),
            "plain_ms": gpu_time_ms(torch, lambda: (
                mod.rope_backward_reference(gq, cos, sin),
                mod.rope_backward_reference(gk, cos, sin))),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
        })
    return out


def paged_int8_cases(torch, mod, dev):
    """Kernel A at the decode shapes of the float flavour: arenas made in
    fp32 (garbage page 0 at 1e4) and quantized with quantize_kv; q bf16
    and fp32."""
    from paddle_tpu_torch.quantization.kv import QuantizedKV, quantize_kv

    out = []
    g = torch.Generator(device=dev).manual_seed(4)
    for dtype, kvh in ((torch.bfloat16, 32), (torch.float32, 32),
                       (torch.bfloat16, 8), (torch.float32, 8)):
        dname = str(dtype).replace("torch.", "")
        q, kp, vp, tbl, pos = paged_inputs(torch, dev, torch.float32, kvh, g)
        q = q.to(dtype)
        kq, vq = QuantizedKV(*quantize_kv(kp)), QuantizedKV(*quantize_kv(vp))
        del kp, vp
        o = mod.paged_attention_int8_cuda(q, kq, vq, tbl, pos)
        ref = mod.paged_attention_reference(q, kq, vq, tbl, pos)
        if not torch.isfinite(o).all():
            fail("int8 paged attention kernel produced non-finite values")
        es = q.element_size()
        slots = int((pos.long() + 1).sum())
        d = 128
        nbytes = (2 * slots * kvh * (d + 4) + 2 * q.numel() * es
                  + int((pos.long() // 16 + 1).sum()) * 4 + 4 * 8)
        b_ms, b_by = bound(nbytes, 4 * slots * 32 * d, dname)
        out.append({
            "shape": {"q": list(q.shape), "pages": list(kq.q.shape),
                      "scales": list(kq.scale.shape),
                      "pos": [int(p) for p in pos]},
            "dtype": dname, "kv_heads": kvh, "arena": "int8",
            "max_abs_err": max_err(torch, o, ref),
            "tolerance": PAGED_TOL[dname],
            "ms": gpu_time_ms(torch, lambda: mod.paged_attention_int8_cuda(
                q, kq, vq, tbl, pos)),
            "plain_ms": gpu_time_ms(
                torch, lambda: mod.paged_attention_reference(
                    q, kq, vq, tbl, pos), n=5, repeats=5),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
        })
        del q, kq, vq, o, ref
    torch.cuda.empty_cache()
    return out


# W8A16 shapes: the 7B decode step's four weight shapes at 8 rows (q/k/v/o,
# gate+up, down, lm_head) and one prefill bucket through gate+up
INT8_MM_SHAPES = ((8, 4096, 4096), (8, 4096, 22016), (8, 11008, 4096),
                  (8, 4096, 32000), (1024, 4096, 22016))
# weight copies cycled through so that every timed call reads its weight
# from device memory, not from the 50 MB L2 (as each layer's projection
# does in a decode step)
L2_FLUSH_BYTES = 120 * 2 ** 20


def cycled(fns):
    """One call of the next function of ``fns`` per call, round robin."""
    state = [0]

    def call():
        fns[state[0] % len(fns)]()
        state[0] += 1
    return call


def int8_matmul_cases(torch, mod, dev):
    """Kernel B at the decode and prefill shapes, bf16 and fp32 x, against
    its plain version; timed beside the composed dequantize-then-matmul
    and the float weight's torch.matmul in x's dtype (the float path's
    cost), each over enough weight copies to miss in L2."""
    out = []
    g = torch.Generator(device=dev).manual_seed(10)
    for rows, h, n in INT8_MM_SHAPES:
        w = torch.randn(h, n, generator=g, device=dev) * 0.02
        wq, sc = mod.quantize_weight(w)
        del w
        copies = max(1, -(-L2_FLUSH_BYTES // wq.numel()))
        wqs = [wq] + [wq.clone() for _ in range(copies - 1)]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            x = torch.randn(rows, h, generator=g, device=dev).to(dtype)
            y = mod.int8_matmul_cuda(x, wq, sc)
            ref = mod.int8_matmul_reference(x, wq, sc)
            if not torch.isfinite(y).all():
                fail(f"int8 matmul {dname} {[rows, h, n]} produced "
                     f"non-finite values")
            if not torch.equal(y, mod.int8_matmul_cuda(x, wq, sc)):
                fail(f"int8 matmul {dname} {[rows, h, n]} does not repeat "
                     f"bit for bit")
            cs, worst = checks(torch, [
                cast_once("out", y, ref, REL_TOL["float32"], dname)])
            del y, ref
            es = x.element_size()
            # the int8 weight, its scales, x and the output, once each
            b_ms, b_by = bound(h * n + 4 * n + rows * (h + n) * es,
                               2 * rows * h * n, dname)
            fcopies = max(1, -(-L2_FLUSH_BYTES // (h * n * es)))
            wfs = [mod._dequant(wq, sc, dtype) for _ in range(fcopies)]
            n_t = 20 if rows <= 16 else 5
            ms = gpu_time_ms(torch, cycled([
                (lambda wi=wi: mod.int8_matmul_cuda(x, wi, sc))
                for wi in wqs]), n=n_t)
            plain = gpu_time_ms(torch, lambda: mod.int8_matmul_reference(
                x, wq, sc), n=3, repeats=5)
            composed = gpu_time_ms(torch, cycled([
                (lambda wi=wi: torch.matmul(x, mod._dequant(wi, sc, dtype)))
                for wi in wqs]), n=n_t)
            float_mm = gpu_time_ms(torch, cycled([
                (lambda wf=wf: torch.matmul(x, wf)) for wf in wfs]), n=n_t)
            del wfs
            out.append({
                "shape": {"rows": rows, "h": h, "n": n}, "dtype": dname,
                "checks": cs, "max_abs_err": worst["max_abs_err"],
                "tolerance": worst["tolerance"],
                "err_over_tol": worst["err_over_tol"],
                "repeats_bitwise": True, "weight_copies": copies,
                "ms": ms, "plain_ms": plain, "library_ms": None,
                "composed_ms": composed,
                "composed_call": "dequantize, then torch.matmul",
                "float_matmul_ms": float_mm,
                "float_matmul_call": f"torch.matmul of the {dname} weight",
                "bound_ms": b_ms, "bound_by": b_by,
            })
            del x
        del wq, sc, wqs
        torch.cuda.empty_cache()
    return out


def _visible_pairs(sq, sk, causal):
    """(row, key) pairs a head attends: all of them, or the causal
    bottom-right triangle."""
    if not causal:
        return sq * sk
    return sum(min(sk, r + (sk - sq) + 1) for r in range(sq))


def _library_attention(torch, q, k, v, causal):
    """F.scaled_dot_product_attention on [B, H, S, D] views, with the
    bottom-right causal mask for Sq != Sk."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sq, sk = int(q.shape[1]), int(k.shape[1])
    if causal and sq != sk:
        from torch.nn.attention.bias import causal_lower_right

        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=causal_lower_right(sq, sk))
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)


FLASH_SHAPES = (
    # dtype, causal, sq, sk: the training shape in bf16 and fp32, and a
    # chunk of 512 queries over 2048 keys (bottom-right causal)
    ("bfloat16", True, 2048, 2048),
    ("float32", True, 2048, 2048),
    ("bfloat16", True, 512, 2048),
)


def flash_cases(torch, mod, dev):
    """Both flash kernels at B 2, H 32, D 128: returns (forward cases,
    backward cases)."""
    fwd, bwd = [], []
    b, h, d = TRAIN_BATCH, 32, 128
    g = torch.Generator(device=dev).manual_seed(9)
    for dname, causal, sq, sk in FLASH_SHAPES:
        dtype = getattr(torch, dname)
        q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
        do = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
        o, lse = mod.flash_attention_cuda(q, k, v, causal)
        ro, rlse = mod.flash_attention_reference(q, k, v, causal)
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            fail(f"flash forward {dname} produced non-finite values")
        cs, worst = checks(torch, [
            cast_once("o", o, ro, REL_TOL["float32"], dname),
            ("lse", lse, rlse, 1e-5, None)])
        del ro, rlse
        pairs = _visible_pairs(sq, sk, causal) * b * h
        es = q.element_size()
        shape = {"b": b, "h": h, "d": d, "sq": sq, "sk": sk,
                 "causal": causal}
        b_ms, b_by = bound(es * b * h * d * (2 * sq + 2 * sk) + 4 * b * h * sq,
                           4 * d * pairs, dname)
        ms = gpu_time_ms(torch, lambda: mod.flash_attention_cuda(
            q, k, v, causal), n=5, repeats=5)
        plain = gpu_time_ms(torch, lambda: mod.flash_attention_reference(
            q, k, v, causal), n=3, repeats=3)
        lib = gpu_time_ms(torch, lambda: _library_attention(
            torch, q, k, v, causal), n=5, repeats=5)
        fwd.append({"shape": shape, "dtype": dname, "checks": cs,
                    "max_abs_err": worst["max_abs_err"],
                    "tolerance": worst["tolerance"],
                    "err_over_tol": worst["err_over_tol"], "ms": ms,
                    "plain_ms": plain, "library_ms": lib,
                    "library_call": "F.scaled_dot_product_attention",
                    "bound_ms": b_ms, "bound_by": b_by})

        grads = mod.flash_attention_backward_cuda(q, k, v, o, lse, do, causal)
        again = mod.flash_attention_backward_cuda(q, k, v, o, lse, do, causal)
        if not all(torch.equal(a, c) for a, c in zip(grads, again)):
            fail(f"flash backward {dname} does not repeat bit for bit")
        del again
        want = mod.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                      causal)
        cs, worst = checks(torch, [
            cast_once(n, gr, w, SUM_TOL32, dname)
            for n, gr, w in zip(("dq", "dk", "dv"), grads, want)])
        if not all(torch.isfinite(gr).all() for gr in grads):
            fail(f"flash backward {dname} produced non-finite values")
        del want, grads
        b_ms, b_by = bound(es * b * h * d * (4 * sq + 4 * sk) + 4 * b * h * sq,
                           10 * d * pairs, dname)
        ms = gpu_time_ms(torch, lambda: mod.flash_attention_backward_cuda(
            q, k, v, o, lse, do, causal), n=3, repeats=5)
        plain = gpu_time_ms(
            torch, lambda: mod.flash_attention_backward_reference(
                q, k, v, o, lse, do, causal), n=2, repeats=3)
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
        lo = _library_attention(torch, ql, kl, vl, causal)
        dot = do.transpose(1, 2)
        lib = grad_time_ms(torch, lo, (ql, kl, vl), dot)

        def ours_fwd_bwd():
            o2, lse2 = mod.flash_attention_cuda(q, k, v, causal)
            mod.flash_attention_backward_cuda(q, k, v, o2, lse2, do, causal)

        def lib_fwd_bwd():
            out = _library_attention(torch, ql, kl, vl, causal)
            torch.autograd.grad(out, (ql, kl, vl), dot)

        fb = gpu_time_ms(torch, ours_fwd_bwd, n=3, repeats=5)
        lib_fb = gpu_time_ms(torch, lib_fwd_bwd, n=3, repeats=5)
        del ql, kl, vl, lo, dot
        bwd.append({"shape": shape, "dtype": dname, "checks": cs,
                    "max_abs_err": worst["max_abs_err"],
                    "tolerance": worst["tolerance"],
                    "err_over_tol": worst["err_over_tol"],
                    "repeats_bitwise": True,
                    "ms": ms, "plain_ms": plain, "library_ms": lib,
                    "library_call": "autograd backward of "
                                    "F.scaled_dot_product_attention",
                    "fwd_bwd_ms": fb, "library_fwd_bwd_ms": lib_fb,
                    "bound_ms": b_ms, "bound_by": b_by})
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return fwd, bwd


KERNELS = [
    # name, source, replaces (file:line of the TPU kernel)
    ("rms_norm", "paddle_tpu_torch/csrc/rms_norm.cu",
     "paddle_tpu/kernels/rms_norm.py:45"),
    ("rope", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/kernels/rope.py:60"),
    ("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
     "paddle_tpu/kernels/paged_attention.py:341"),
    ("rms_norm_bwd", "paddle_tpu_torch/csrc/rms_norm.cu",
     "paddle_tpu/kernels/rms_norm.py:93"),
    ("rope_bwd", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/kernels/rope.py:88"),
    ("flash_attention_fwd", "paddle_tpu_torch/csrc/flash_attention.cu",
     "jax/experimental/pallas/ops/tpu/flash_attention.py:758 "
     "(via paddle_tpu/kernels/flash_attention.py:260)"),
    ("flash_attention_bwd", "paddle_tpu_torch/csrc/flash_attention.cu",
     "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 and :1456 "
     "(via paddle_tpu/kernels/flash_attention.py:260)"),
    ("paged_attention_int8", "paddle_tpu_torch/csrc/paged_attention.cu",
     "paddle_tpu/kernels/paged_attention.py:341 "
     "(int8 flavour _paged_kernel_quant :253)"),
    ("int8_matmul", "paddle_tpu_torch/csrc/int8_matmul.cu",
     "paddle_tpu/kernels/int8_matmul.py:84"),
]
# the kernels each main-path phase must launch
SERVING_KERNELS = ("rms_norm", "rope", "paged_attention")
# launches per training step, from the model's structure: two RMSNorms
# per layer and the final one; one rope launch (q and k) per layer; one
# flash attention per layer; forward and backward each
TRAIN_PER_STEP = {
    "rms_norm": 2 * TRAIN_LAYERS + 1, "rms_norm_bwd": 2 * TRAIN_LAYERS + 1,
    "rope": TRAIN_LAYERS, "rope_bwd": TRAIN_LAYERS,
    "flash_attention_fwd": TRAIN_LAYERS, "flash_attention_bwd": TRAIN_LAYERS,
    "paged_attention": 0, "paged_attention_int8": 0, "int8_matmul": 0,
}
# W8A16 launches per forward of the quantized 7B (decode step or prefill):
# q, k, v, o, gate+up and down in each of 32 layers, and the head
QUANT_MM_PER_FORWARD = 6 * 32 + 1


# ------------------------------------------------------- small parity
def small_parity(torch, np, dev):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_for_serving
    from paddle_tpu_torch.serving import PagedServingEngine, ServingEngine

    for kvh in (None, 2):
        cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                               intermediate_size=512, num_hidden_layers=2,
                               num_attention_heads=4,
                               num_key_value_heads=kvh)
        net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=4)
        rng = np.random.RandomState(5)
        prompts = [rng.randint(0, 256, (n,)) for n in (9, 17, 30, 5)]
        news = [12, 5, 9, 16]
        eng = PagedServingEngine(net, max_batch_size=2, max_seq_len=64,
                                 page_size=8, min_bucket=8,
                                 cache_dtype="float32")
        hs = [eng.submit(p, m) for p, m in zip(prompts, news)]
        eng.run_until_idle()
        for h, p, m in zip(hs, prompts, news):
            want = net.generate(p[None], max_new_tokens=m,
                                cache_dtype="float32")[0].cpu().numpy()
            if h.status != "DONE" or not np.array_equal(h.output_ids,
                                                        want):
                fail(f"small parity (kvH={kvh}): paged engine stream "
                     f"{h.output_ids.tolist()} != generate "
                     f"{want.tolist()}")
        if eng.page_pool.pages_in_use:
            fail("small parity: pages leaked")
        # the same model quantized: int8 weights and an int8 KV cache
        quantize_for_serving(net, inplace=True)
        for kind, eng in (
                ("paged", PagedServingEngine(
                    net, max_batch_size=2, max_seq_len=64, page_size=8,
                    min_bucket=8, cache_dtype="int8")),
                ("slab", ServingEngine(net, max_batch_size=2, max_seq_len=64,
                                       min_bucket=8, cache_dtype="int8"))):
            hs = [eng.submit(p, m) for p, m in zip(prompts, news)]
            eng.run_until_idle()
            for h, p, m in zip(hs, prompts, news):
                want = net.generate(p[None], max_new_tokens=m,
                                    cache_dtype="int8")[0].cpu().numpy()
                if h.status != "DONE" or not np.array_equal(h.output_ids,
                                                            want):
                    fail(f"small int8 parity (kvH={kvh}): {kind} engine "
                         f"stream {h.output_ids.tolist()} != generate "
                         f"{want.tolist()}")
            if eng.pool.occupancy:
                fail(f"small int8 parity: the {kind} engine leaked")
    log("small parity: tiny fp32 Llama (MHA and GQA kvH=2), paged engine "
        "== generate token for token; quantized (int8 weights, int8 KV), "
        "paged and slab engines == generate(cache_dtype='int8')")


# -------------------------------------------------- tiny train parity
def _tiny_step(torch, np, cfg, dev, weights, ids):
    from paddle_tpu_torch.convert import load_numpy_state, numpy_state
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, causal_lm_loss
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    load_numpy_state(net, weights)
    opt = AdamW(1e-3, epsilon=1e-3, parameters=net.named_parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt)
    t = torch.as_tensor(ids, dtype=torch.long, device=dev)
    loss, _ = step([t[:, :-1]], [t[:, 1:]])
    return float(loss), numpy_state(net)


def tiny_train_parity(torch, np, dev):
    """One fp32 CompiledTrainStep of a 2-layer GQA Llama (head_dim 64,
    100 tokens: a ragged second 64-row block) on the card and on the CPU
    from the same weights."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import numpy_state
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=128)
    weights = numpy_state(LlamaForCausalLM(cfg, device="cpu", seed=11))
    ids = np.random.RandomState(12).randint(0, 256, (2, 101))
    kernels.reset_launch_counts()
    loss_gpu, after_gpu = _tiny_step(torch, np, cfg, dev, weights, ids)
    counts = kernels.launch_counts()
    loss_cpu, after_cpu = _tiny_step(torch, np, cfg, "cpu", weights, ids)
    loss_again, after_again = _tiny_step(torch, np, cfg, dev, weights, ids)
    serving_only = ("paged_attention", "paged_attention_int8", "int8_matmul")
    missing = [k for k, n in counts.items()
               if n <= 0 and k not in serving_only]
    if missing:
        fail(f"tiny train parity: kernels not launched on the card: "
             f"{missing}")
    if not abs(loss_gpu - loss_cpu) <= TINY_LOSS_RTOL * abs(loss_cpu):
        fail(f"tiny train parity: loss {loss_gpu} on the card, {loss_cpu} "
             f"on the CPU")
    worst, worst_name = 0.0, ""
    for k, want in after_cpu.items():
        err = float(np.abs(after_gpu[k] - want).max())
        if err > worst:
            worst, worst_name = err, k
    if not worst <= TINY_PARAM_ATOL:
        fail(f"tiny train parity: {worst_name} differs by {worst} after "
             f"the step (> {TINY_PARAM_ATOL})")
    repeats = loss_again == loss_gpu and all(
        np.array_equal(after_again[k], v) for k, v in after_gpu.items())
    log("tiny train parity: " + json.dumps({
        "loss_card": loss_gpu, "loss_cpu": loss_cpu,
        "max_param_diff": worst, "param": worst_name,
        "tolerance": {"loss_rtol": TINY_LOSS_RTOL,
                      "param_atol": TINY_PARAM_ATOL},
        "card_step_repeats_bitwise": repeats, "launches": counts}))


# ----------------------------------------------------------- training
def training_phase(torch, np, dev, card, profile_train_steps=0):
    """10 AdamW steps, AMP O1 bf16, of Llama-2-7B widths at 8 layers on
    one fixed batch; returns the launch counts of the 10 steps. With
    ``profile_train_steps`` that many more steps run under the profiler
    after the counts are read."""
    import gc

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         causal_lm_loss)
    from paddle_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                            LinearWarmup)

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    torch.cuda.synchronize()
    n_params = net.num_params()
    log(f"training: Llama-2-7B widths, {TRAIN_LAYERS} of 32 layers, "
        f"{n_params / 1e9:.3f}B params fp32, built in "
        f"{time.perf_counter() - t0:.1f} s")
    sched = LinearWarmup(3e-4, 3, 3e-5, 3e-4)
    opt = AdamW(sched, parameters=net.named_parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt,
        amp_level="O1", amp_dtype="bfloat16")
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
    inputs, labels = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, _ = step([inputs], [labels])
        sched.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail(f"training: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training: the last loss {losses[-1]} is not below the first "
             f"{losses[0]} on a fixed batch")
    want = {k: n * TRAIN_STEPS for k, n in TRAIN_PER_STEP.items()}
    if counts != want:
        fail(f"training: launches {counts}, expected {want} "
             f"({TRAIN_STEPS} steps)")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = statistics.median(times)
    flops = net.flops_per_token(TRAIN_SEQ) * tokens
    res = {
        "card": card,
        "model": f"Llama-2-7B widths, {TRAIN_LAYERS} layers, fp32 params, "
                 f"AMP O1 bf16, random weights",
        "params": n_params, "batch": [TRAIN_BATCH, TRAIN_SEQ],
        "steps": TRAIN_STEPS, "losses": losses, "step_s": times,
        "step_p50_s": p50, "tokens_per_s": tokens / p50,
        "model_tflop_per_step": flops / 1e12,
        "model_tflop_per_s": flops / p50 / 1e12,
        "peak_mem_bytes": peak,
        "launches": counts,
        "launches_per_step": {k: n / TRAIN_STEPS for k, n in counts.items()},
    }
    log("training: " + json.dumps(res))
    if profile_train_steps:
        prof = profile_steps(torch, lambda: step([inputs], [labels]),
                             profile_train_steps)
        log("profile: " + json.dumps(dict(prof, kind="train")))
    del step, opt, net, sched, loss
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------ serving
SERVE_MAX_NEW = 64


def drive_requests(torch, np, eng, cfg):
    """The serving traffic: 12 requests, prompts of 32-1024 tokens from
    seed 1234, 64 new tokens each, six at once and six more after 24
    steps, so late requests take rows that early ones free. The launch
    counts are zeroed just before and read just after. Returns (handles,
    prompt lengths, steps, wall seconds, launch counts, peak bytes)."""
    from paddle_tpu_torch import kernels

    rng = np.random.RandomState(1234)
    lens = rng.randint(32, 1025, size=12)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),)) for n in lens]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [eng.submit(p, SERVE_MAX_NEW) for p in prompts[:6]]
    for _ in range(24):
        eng.step()
    handles += [eng.submit(p, SERVE_MAX_NEW) for p in prompts[6:]]
    steps = 24 + eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for h in handles:
        if h.status != "DONE" or len(h.tokens) != SERVE_MAX_NEW:
            fail(f"request {h.request.request_id}: status {h.status}, "
                 f"{len(h.tokens)} tokens")
    if eng.page_pool.pages_in_use:
        fail(f"{eng.page_pool.pages_in_use} pages leaked")
    if min(h.admitted_step for h in handles[6:]) < 24:
        fail("late requests were not admitted after the first wave")
    return handles, lens, steps, wall, counts, peak


def teacher_forced(torch, dev, handles, logits_of, label):
    """Every generated token must be the argmax of ``logits_of(ids)``
    ([S, V] logits of the whole sequence) at its position, or trail it
    by less than NEAR_TIE. Returns (near-ties, largest gap)."""
    ties, worst_gap = 0, 0.0
    with torch.inference_mode():
        for h in handles:
            ids = torch.as_tensor(h.output_ids, dtype=torch.long,
                                  device=dev)[None]
            logits = logits_of(ids).float()
            if not torch.isfinite(logits).all():
                fail(f"{label}: the reference produced non-finite logits")
            p = h.request.prompt_len
            rows = logits[p - 1:p - 1 + SERVE_MAX_NEW]
            gen = ids[0, p:p + SERVE_MAX_NEW]
            top = rows.argmax(dim=-1)
            gap = rows.max(dim=-1).values - rows.gather(
                1, gen[:, None])[:, 0]
            miss = top != gen
            if miss.any():
                g = float(gap[miss].max())
                worst_gap = max(worst_gap, g)
                ties += int(miss.sum())
                if g >= NEAR_TIE:
                    fail(f"{label}: request {h.request.request_id}: a "
                         f"generated token trails the reference argmax by "
                         f"{g:.4f} >= {NEAR_TIE}")
    log(f"{label}: teacher-forced check passed for "
        f"{len(handles) * SERVE_MAX_NEW} tokens; {ties} near-ties (largest "
        f"gap {worst_gap:.4f} < {NEAR_TIE})")
    return ties, worst_gap


def serving_result(eng, handles, lens, steps, wall, counts, peak, ties,
                   worst_gap, **extra):
    m = eng.metrics
    return dict(extra, **{
        "requests": len(handles), "prompt_lens": [int(n) for n in lens],
        "max_new_tokens": SERVE_MAX_NEW, "steps": steps, "wall_s": wall,
        "prefill_tokens": m.prefill_tokens.value,
        "prefill_s": m.prefill_time.sum,
        "prefill_tok_per_s": m.prefill_tokens.value / m.prefill_time.sum,
        "decode_tokens": m.decode_tokens.value,
        "decode_s": m.decode_step_time.sum,
        "decode_tok_per_s": m.decode_tokens.value / m.decode_step_time.sum,
        "ttft_p50_s": m.ttft.percentile(50),
        "prefill_p50_s": m.prefill_time.percentile(50),
        "itl_p50_s": m.itl.percentile(50),
        "decode_step_p50_s": m.decode_step_time.percentile(50),
        "peak_mem_bytes": peak,
        "arena_bytes": eng.page_pool.arena_bytes(),
        "launches": counts,
        "near_ties": ties, "near_tie_max_gap": worst_gap,
    })


def serving_phase(torch, np, dev, card, profile_steps=0):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import PagedServingEngine

    cfg = LlamaConfig.llama2_7b()
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    log(f"serving: Llama-2-7B, {layers} layers, "
        f"{net.num_params() / 1e9:.3f}B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = PagedServingEngine(net, max_batch_size=8, max_seq_len=2048,
                             page_size=16, cache_dtype="bfloat16")
    log(f"serving: page arena {eng.page_pool.num_pages + 1} pages x 16 "
        f"slots, {eng.page_pool.arena_bytes() / 1e9:.2f} GB")
    handles, lens, steps, wall, counts, peak = drive_requests(
        torch, np, eng, cfg)
    missing = [k for k in SERVING_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"kernels not launched in the serving phase: {missing}")
    # teacher-forced check against the cache-free forward
    ties, worst_gap = teacher_forced(torch, dev, handles,
                                     lambda ids: net(ids)[0], "serving")
    res = serving_result(
        eng, handles, lens, steps, wall, counts, peak, ties, worst_gap,
        card=card, model=f"Llama-2-7B, {layers} layers, bf16, random "
                         f"weights")
    log("serving: " + json.dumps(res))
    if profile_steps:
        profile_decode(torch, np, eng, cfg, profile_steps, "decode")
    return counts


def quant_serving_phase(torch, np, dev, card, profile_steps=0):
    """Llama-2-7B at full width and depth, quantized: the serving phase's
    random bf16 weights (seed 0) through quantize_for_serving in place,
    an int8 KV arena of 1025 pages x 16 slots, the same 12 requests."""
    import gc

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.generation import alloc_kv_caches
    from paddle_tpu_torch.quantization import quantize_for_serving
    from paddle_tpu_torch.serving import PagedServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = LlamaConfig.llama2_7b()
    layers = cfg.num_hidden_layers
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    quantize_for_serving(net, inplace=True)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    weight_bytes = sum(b.numel() * b.element_size() for b in net.buffers())
    log(f"quantized serving: Llama-2-7B, {layers} layers, int8 weights "
        f"({weight_bytes / 1e9:.2f} GB with scales) + bf16 embeddings and "
        f"norms, built and quantized in {time.perf_counter() - t_phase:.1f}"
        f" s")
    eng = PagedServingEngine(net, max_batch_size=8, max_seq_len=2048,
                             page_size=16, cache_dtype="int8")
    log(f"quantized serving: int8 page arena {eng.page_pool.num_pages + 1} "
        f"pages x 16 slots, {eng.page_pool.arena_bytes() / 1e9:.2f} GB")
    handles, lens, steps, wall, counts, peak = drive_requests(
        torch, np, eng, cfg)
    m = eng.metrics
    n_decode, n_prefill = m.decode_step_time.count, m.prefill_time.count
    want = {k: 0 for k in counts}
    want.update(rms_norm=(2 * layers + 1) * (n_decode + n_prefill),
                rope=layers * (n_decode + n_prefill),
                paged_attention_int8=layers * n_decode,
                int8_matmul=QUANT_MM_PER_FORWARD * (n_decode + n_prefill))
    if counts != want:
        fail(f"quantized serving: launches {counts}, expected {want} "
             f"({n_decode} decode steps, {n_prefill} prefills)")

    # teacher-forced check against one slab prefill of the whole sequence
    # with an int8 cache: the same quantization on write, dequantized on
    # read, composed attention
    def slab_prefill(ids):
        caches = alloc_kv_caches(cfg, 1, int(ids.shape[1]), "int8",
                                 device=dev)
        return net(ids, caches=caches, pos=0)[0][0]

    ties, worst_gap = teacher_forced(torch, dev, handles, slab_prefill,
                                     "quantized serving")
    res = serving_result(
        eng, handles, lens, steps, wall, counts, peak, ties, worst_gap,
        card=card, model=f"Llama-2-7B, {layers} layers, int8 weights "
                         f"(W8A16) and int8 KV cache, random weights",
        weight_bytes=weight_bytes, decode_steps=n_decode,
        prefills=n_prefill,
        launches_per_decode_step={
            "paged_attention_int8": layers,
            "int8_matmul": QUANT_MM_PER_FORWARD},
        phase_s=time.perf_counter() - t_phase)
    log("quantized serving: " + json.dumps(res))
    if profile_steps:
        profile_decode(torch, np, eng, cfg, profile_steps, "decode_int8")
    return counts


def profile_steps(torch, step_fn, steps):
    """Device time by kernel group over ``steps`` calls of ``step_fn``
    (torch.profiler), and the device's idle share of that window (1 -
    summed kernel time / wall time; the profiler's own overhead makes
    the wall time an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {}
    kernels = []
    for e in prof.key_averages():
        # kernels only: a CPU op's self device time repeats the time of
        # the kernels it launched
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us <= 0:
            continue
        name = e.key
        low = name.lower()
        group = ("paged_attention_int8" if "paged_attention_kernel" in low
                 and "signed char" in low
                 else "int8_matmul" if "int8_matmul" in low
                 else "paged_attention" if "paged_attention_kernel" in low
                 else "flash_attention_fwd" if "flash_fwd_kernel" in low
                 else "flash_attention_bwd" if "flash_bwd_" in low
                 else "rms_norm" if "rms_norm_fwd_kernel" in low
                 else "rms_norm_bwd" if ("rms_norm_bwd_kernel" in low
                                         or "rms_norm_dw_kernel" in low)
                 else "rope" if "rope_kernel" in low
                 else "gemm" if any(s in low for s in (
                     "gemm", "nvjet", "xmma", "cutlass", "gemv", "splitk"))
                 else "other")
        groups[group] = groups.get(group, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, e.count, name[:90]))
    busy = sum(groups.values())
    kernels.sort(reverse=True)
    return {
        "steps": steps, "wall_ms": wall_ms,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
        "ms_per_step_by_group": {k: v / steps for k, v in
                                 sorted(groups.items())},
        "top_kernels": [{"ms": ms, "count": c, "name": n}
                        for ms, c, n in kernels[:12]],
    }


def profile_decode(torch, np, eng, cfg, steps, kind):
    """The decode-step profile with all 8 rows busy."""
    rng = np.random.RandomState(99)
    hs = [eng.submit(rng.randint(0, cfg.vocab_size, (int(n),)), 64)
          for n in rng.randint(32, 1025, size=8)]
    while any(h.status == "QUEUED" for h in hs):
        eng.step()
    prof = profile_steps(torch, eng.step, steps)
    log("profile: " + json.dumps(dict(prof, rows=8, kind=kind)))
    eng.run_until_idle()
    if eng.page_pool.pages_in_use:
        fail("pages leaked after the profiled steps")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="after each serving phase (bf16, quantized), "
                         "profile this many decode steps with every row "
                         "busy")
    ap.add_argument("--profile-train-steps", type=int, default=0,
                    help="after the training phase, profile this many "
                         "more training steps")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = smi

    nvcc = _build.find_nvcc()
    if nvcc is None:
        fail("nvcc not found")
    _build.build(nvcc)
    _build.load()
    log(f"build: {_build.build_seconds:.1f} s, {_build.LIB_PATH}")

    results = {}
    for name, modname, cases_fn in (
            ("rms_norm", "rms_norm", rms_norm_cases),
            ("rope", "rope", rope_cases),
            ("paged_attention", "paged_attention", paged_cases),
            ("rms_norm_bwd", "rms_norm", rms_norm_bwd_cases),
            ("rope_bwd", "rope", rope_bwd_cases),
            ("flash_attention", "flash_attention", flash_cases),
            ("paged_attention_int8", "paged_attention", paged_int8_cases),
            ("int8_matmul", "int8_matmul", int8_matmul_cases)):
        cases = cases_fn(torch, getattr(kernels, modname), dev)
        torch.cuda.synchronize()
        named = (dict(zip(("flash_attention_fwd", "flash_attention_bwd"),
                          cases)) if name == "flash_attention"
                 else {name: cases})
        for kname, kcases in named.items():
            for c in kcases:
                log(f"kernel {kname}: " + json.dumps(c))
                for chk in c.get("checks", [c]):
                    if not (chk["max_abs_err"] <= chk["tolerance"]
                            and chk.get("err_over_tol", 0.0) <= 1.0):
                        fail(f"{kname} {c['dtype']} {c['shape']} "
                             f"{chk.get('output', '')}: max_abs_err "
                             f"{chk['max_abs_err']}, tolerance "
                             f"{chk['tolerance']}, largest error over "
                             f"its entry's tolerance "
                             f"{chk.get('err_over_tol')}")
            results[kname] = kcases

    small_parity(torch, np, dev)
    tiny_train_parity(torch, np, dev)
    train_counts = training_phase(torch, np, dev, card,
                                  args.profile_train_steps)
    serve_counts = serving_phase(torch, np, dev, card, args.profile_steps)
    quant_counts = quant_serving_phase(torch, np, dev, card,
                                       args.profile_steps)

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "paddle_tpu."))
              or m == "paddle_tpu"]
    if leaked:
        fail(f"the port imported {leaked[:5]}")

    line = []
    for name, src, replaces in KERNELS:
        # the first case is the main path's shape: bf16 at the decode
        # shape for the serving kernels (the W8A16 matmul: q/k/v/o's
        # [8, 4096] x [4096, 4096]), the training shape for the rest
        # (fp32 [4096, 4096] for the RMSNorm backward, the O1 residual)
        main_case = results[name][0]
        by_phase = {"serving": serve_counts[name],
                    "training": train_counts[name],
                    "quantized_serving": quant_counts[name]}
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": main_case["max_abs_err"],
            "tolerance": main_case["tolerance"],
            "err_over_tol": main_case.get("err_over_tol"),
            "ms": main_case["ms"], "kernel_ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "card": card, "cases": results[name],
        })
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
