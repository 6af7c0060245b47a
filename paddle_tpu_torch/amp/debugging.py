"""paddle.amp.debugging (counterpart of ``paddle_tpu/amp/debugging.py``):
numeric-health tooling for mixed-precision training.

Builds on the NaN/Inf sweep (``amp/naninf.py``): the tensor checker is
``FLAGS_check_nan_inf``, and the operator statistics are the sweep's
per-op seam with a collector installed (every ATen op and every hand
kernel, by the names the sweep gives them; the ops the autograd engine
runs are not counted, as JAX's dispatch hook never sees its backward).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..utils.flags import set_flags
from . import naninf


class DebugMode:
    """Reference enum surface (CHECK_NAN_INF_AND_ABORT is the acted-on
    mode; the others are accepted for API parity)."""

    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


def enable_tensor_checker(checker_config=None):
    """Turn on the per-op NaN/Inf sweep (FLAGS_check_nan_inf)."""
    set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    set_flags({"FLAGS_check_nan_inf": False})


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """Raise on NaN/Inf in ``tensor`` (reference check_numerics)."""
    v = (tensor.detach().float().cpu().numpy()
         if isinstance(tensor, torch.Tensor) else np.asarray(tensor))
    bad = ~np.isfinite(v)
    if bad.any():
        raise FloatingPointError(
            f"check_numerics: {int(bad.sum())}/{v.size} non-finite values "
            f"in {op_type or 'tensor'} {var_name or ''} "
            f"(nan={int(np.isnan(v).sum())}, inf={int(np.isinf(v).sum())})"
        )
    return True


class _OpStats:
    def __init__(self):
        self.calls = {}

    def hook(self, name, seconds):
        cnt, total = self.calls.get(name, (0, 0.0))
        self.calls[name] = (cnt + 1, total + seconds)


_COLLECTOR = [None]
_PREV_HOOK = [None]


def enable_operator_stats_collection():
    """Start counting per-op calls and host seconds. Chains with a
    collector already installed instead of clobbering it."""
    _COLLECTOR[0] = _OpStats()
    stats = _COLLECTOR[0]
    prev = naninf._COLLECTOR[0]

    def chained(name, seconds):
        stats.hook(name, seconds)
        if prev is not None:
            prev(name, seconds)

    _PREV_HOOK[0] = naninf.set_collector(chained)


def disable_operator_stats_collection():
    """Stop collecting and print the per-op call table; restores any
    previously installed collector. Returns ``{op: calls}``."""
    col = _COLLECTOR[0]
    naninf.set_collector(_PREV_HOOK[0])
    _PREV_HOOK[0] = None
    _COLLECTOR[0] = None
    if col is None:
        return {}
    print(f"{'op':<32}{'calls':>8}{'total_ms':>12}")
    for name, (cnt, total) in sorted(
        col.calls.items(), key=lambda kv: -kv[1][1]
    ):
        print(f"{name:<32}{cnt:>8}{total * 1e3:>12.2f}")
    return {k: c for k, (c, _) in col.calls.items()}


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    raise NotImplementedError(
        "compare_accuracy consumes the reference's GPU tensor-dump "
        "format; on this build use check_numerics / operator stats"
    )
