"""Global runtime flags (the port's copy of ``paddle_tpu/utils/flags.py``).

The ``FLAGS_*`` registry: each flag's default is overridden by the
environment variable of its name when this module is imported, read with
:func:`get_flags` and set with :func:`set_flags`. ``FLAGS_check_nan_inf``
turns on the NaN/Inf sweep (``amp/naninf.py``); the others are accepted
and stored, as in the JAX package. A module that acts on a flag registers
a listener (:func:`on_change`), called after every :func:`set_flags`.
"""
from __future__ import annotations

import os
import threading

_LOCK = threading.Lock()

# name -> default (env var FLAGS_<name> overrides at import)
_DEFAULTS = {
    "FLAGS_check_nan_inf": False,
    "FLAGS_check_nan_inf_level": 0,
    "FLAGS_cudnn_deterministic": False,
    "FLAGS_embedding_deterministic": 0,
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_allocator_strategy": "auto_growth",
    "FLAGS_use_stream_safe_cuda_allocator": True,
    "FLAGS_benchmark": False,
    "FLAGS_eager_delete_tensor_gb": 0.0,
    "FLAGS_max_inplace_grad_add": 0,
    "FLAGS_log_level": 0,
}

_FLAGS: dict = {}
_LISTENERS = []


def _coerce(default, raw):
    if isinstance(default, bool):
        return str(raw).lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def _init():
    for name, default in _DEFAULTS.items():
        raw = os.environ.get(name)
        _FLAGS[name] = _coerce(default, raw) if raw is not None else default


_init()


def set_flags(flags: dict):
    """paddle.set_flags parity."""
    with _LOCK:
        for k, v in flags.items():
            if k in _DEFAULTS:
                _FLAGS[k] = _coerce(_DEFAULTS[k], v) if not isinstance(
                    v, type(_DEFAULTS[k])
                ) else v
            else:
                _FLAGS[k] = v
    for fn in _LISTENERS:
        fn()


def get_flags(flags):
    """paddle.get_flags parity: str or list -> dict."""
    if isinstance(flags, str):
        flags = [flags]
    return {k: _FLAGS.get(k) for k in flags}


def flag(name, default=None):
    return _FLAGS.get(name, default)


def on_change(fn):
    """Call ``fn()`` after every :func:`set_flags` (and once now)."""
    _LISTENERS.append(fn)
    fn()
