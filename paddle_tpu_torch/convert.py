"""Carry weights between the JAX package and the port through numpy.

Parameter names and layouts are the same in both packages (Paddle's
names, ``[in, out]`` Linear weights, one fused ``[H, 2 * FFN]``
gate+up matrix), so conversion is a dtype and device move per array.
The JAX side gives ``{k: np.asarray(p.value) for k, p in
net.named_parameters()}``.
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


def load_numpy_state(net, arrays):
    """Load ``{name: np.ndarray}`` into ``net`` in place (in the net's
    device and dtype). Raises ``KeyError`` on a missing or an extra name
    and ``ValueError`` on a wrong shape; nothing is loaded then."""
    own = dict(net.named_parameters())
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
    sd = state_dict_from_numpy(arrays, device=net.device, dtype=net.dtype)
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(sd[k])
    return net


def numpy_state(net):
    """The inverse of :func:`load_numpy_state`: ``{name: np.ndarray}`` of
    every parameter, as fp32 host arrays (numpy has no bfloat16)."""
    return {k: p.detach().float().cpu().numpy()
            for k, p in net.named_parameters()}
