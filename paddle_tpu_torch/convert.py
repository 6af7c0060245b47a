"""Carry weights between the JAX package and the port through numpy.

Parameter names and layouts are the same in both packages (Paddle's
names, ``[in, out]`` Linear weights, one fused ``[H, 2 * FFN]``
gate+up matrix), so conversion is a dtype and device move per array.
The JAX side gives ``{k: np.asarray(p.value) for k, p in
net.named_parameters()}``. A model that ``quantize_for_serving`` has
converted (in both packages) also carries its ``QuantizedLinear``
buffers, ``weight_q`` (int8) and ``weight_scale`` (fp32): add the JAX
side's ``named_buffers()`` to the dict, and they cross as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def state_dict_from_numpy(arrays, config=None, device=None,
                          dtype=torch.float32):
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``
    (None: the first CUDA card, or a raise without one); floating arrays
    become ``dtype``. ``config`` is accepted for the
    caller's symmetry with the model constructor and not needed: the
    names carry over unchanged."""
    device = resolve_device(device)
    out = {}
    for name, arr in arrays.items():
        a = np.asarray(arr)
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            t = torch.tensor(np.asarray(a, np.float32))
            out[name] = t.to(device=device, dtype=dtype)
        else:
            out[name] = torch.tensor(a).to(device)
    return out


def _named_state(net):
    """Every parameter and buffer of ``net`` by name."""
    own = dict(net.named_parameters())
    own.update(net.named_buffers())
    return own


def load_numpy_state(net, arrays):
    """Load ``{name: np.ndarray}`` into ``net``'s parameters and buffers
    in place (floating arrays in each tensor's device and dtype; integer
    arrays, the int8 weight codes, unchanged). Raises ``KeyError`` on a
    missing or an extra name, ``ValueError`` on a wrong shape and
    ``TypeError`` on a float array for an integer tensor; nothing is
    loaded then."""
    own = _named_state(net)
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, extra {extra}")
    bad = [
        f"{k}: {tuple(np.shape(arrays[k]))} != {tuple(p.shape)}"
        for k, p in own.items() if tuple(np.shape(arrays[k])) != tuple(p.shape)
    ]
    if bad:
        raise ValueError("state shape mismatch: " + "; ".join(bad))
    src = {}
    for k, p in own.items():
        a = np.asarray(arrays[k])
        is_float = a.dtype.kind == "f" or a.dtype.name == "bfloat16"
        if is_float != p.dtype.is_floating_point:
            raise TypeError(f"{k}: array of {a.dtype} for a {p.dtype} "
                            f"tensor")
        src[k] = torch.tensor(np.asarray(a, np.float32) if is_float else a)
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(src[k])
    return net


def numpy_state(net):
    """The inverse of :func:`load_numpy_state`: ``{name: np.ndarray}`` of
    every parameter and buffer, floating ones as fp32 host arrays (numpy
    has no bfloat16), integer ones unchanged."""
    return {k: (p.detach().float() if p.dtype.is_floating_point
                else p.detach()).cpu().numpy()
            for k, p in _named_state(net).items()}
