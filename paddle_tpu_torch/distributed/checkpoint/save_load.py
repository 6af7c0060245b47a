"""Checkpoint save/load (counterpart of
``paddle_tpu/distributed/checkpoint/save_load.py``).

The JAX package writes every addressable shard of a sharded array, and
loads by assembling each device's box from the saved shards that overlap
it. The port runs one process on one device, so every tensor is one
shard, ``<name>.p0.s0.npy``, whose box is the whole shape, and a load
fills each target tensor in place (``copy_``, on the tensor's own device
and the caller's current stream) cast to its dtype as JAX's
``.astype(d)`` casts. ``process_group`` other than None raises: process
groups wait for ``ROADMAP.md`` queue A item 6.

A directory written here is byte-identical to the JAX package's for the
same state: every ``.npy`` and ``metadata.json``. Scalars (an optimizer's
``@step_count``, its LR scheduler's state) ride in the metadata JSON.
Nested dicts and lists flatten to ``/``-joined names and fill back in
place.

bfloat16: the JAX package writes a bf16 array as raw 2-byte words under
the header descr ``'<V2'`` with ``"bfloat16"`` in the metadata, and its
own reader then fails on that file (it assigns the ``V2`` shard into a
bfloat16 array, ``save_load.py:164``: ``No cast function available``).
The port writes the same bytes and reads them back: ``'<V2'`` under
``"bfloat16"`` is read as uint16 and viewed as ``torch.bfloat16``; a
cast from a bf16 shard to another target dtype goes through fp32. That
read is a departure, recorded in ``ROADMAP.md`` queue C.
"""
from __future__ import annotations

import os
import re
import time

import numpy as np
import torch

from .fsio import atomic_save_npy, atomic_write_text, fsync_dir
from .metadata import (
    METADATA_FILE,
    Metadata,
    ShardMeta,
    TensorMeta,
    metadata_path,
)

PROCESS_GROUPS_NOT_PORTED = (
    "process_group=...: process groups are not ported (ROADMAP.md queue A "
    "item 6); the port saves and loads one process's state")


def _walk(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _walk(v, f"{prefix}{k}/")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], obj


def _sanitize(name):
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)


def _is_array_leaf(v):
    return isinstance(v, torch.Tensor) or (
        isinstance(v, np.ndarray) and v.ndim > 0)


def dtype_name(t):
    """The numpy name of a tensor's or an array's dtype (``"bfloat16"``
    for bf16), as the metadata records it."""
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0):
    """Write a checkpoint of ``state_dict`` (possibly nested) to directory
    ``path``: one ``.npy`` a tensor, then ``metadata.json`` last (its
    existence marks the directory complete). Every file is written
    atomically (``fsio.py``). Returns ``{filename: {"crc32": int,
    "bytes": int}}`` of every file written, for the commit manifest."""
    if process_group is not None:
        raise NotImplementedError(PROCESS_GROUPS_NOT_PORTED)
    os.makedirs(path, exist_ok=True)
    files = {}
    tensors, scalars = {}, {}
    for name, leaf in _walk(state_dict):
        if not _is_array_leaf(leaf):
            if leaf is None or isinstance(leaf, (int, float, str, bool)):
                scalars[name] = leaf
            else:
                scalars[name] = float(np.asarray(leaf))
            continue
        shape = list(leaf.shape)
        fname = f"{_sanitize(name)}.p0.s0.npy"
        crc, nbytes = atomic_save_npy(os.path.join(path, fname), leaf)
        files[fname] = {"crc32": crc, "bytes": nbytes}
        tensors[name] = TensorMeta(
            shape=shape, dtype=dtype_name(leaf),
            shards=[ShardMeta(file=fname, box=[[0, d] for d in shape])])
    meta = Metadata(tensors=tensors, scalars=scalars)
    crc, nbytes = atomic_write_text(metadata_path(path), meta.to_json())
    files[METADATA_FILE] = {"crc32": crc, "bytes": nbytes}
    fsync_dir(path)
    return files


def _storage_dtype(name):
    """The numpy dtype a shard of metadata dtype ``name`` is read as."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


class _ShardReader:
    """Reads a tensor from its shards: in one read when one shard holds
    it all (what the port writes), else assembled from the boxes of
    several mmap'd shards (a JAX checkpoint of a sharded array)."""

    def __init__(self, path, tmeta):
        self.path = path
        self.meta = tmeta

    def read(self):
        """The whole tensor as a numpy array in its storage dtype."""
        shape = self.meta.shape
        dtype = _storage_dtype(self.meta.dtype)
        shards = self.meta.shards
        if len(shards) == 1 and shards[0].box == [[0, d] for d in shape]:
            # one shard holding the whole tensor (what the port writes):
            # one read into the array, no assembly
            arr = np.load(os.path.join(self.path, shards[0].file))
            if list(arr.shape) != list(shape):
                raise ValueError(
                    f"shard {shards[0].file} has shape {list(arr.shape)}, "
                    f"metadata says {shape}")
            return arr.view(dtype) if arr.dtype.kind == "V" else arr
        out = np.empty(shape, dtype=dtype)
        filled = 0
        for sh in self.meta.shards:
            src = np.load(os.path.join(self.path, sh.file), mmap_mode="r")
            if src.dtype.kind == "V":
                src = src.view(out.dtype)
            out[tuple(slice(a, b) for a, b in sh.box)] = src
            filled += int(np.prod([b - a for a, b in sh.box]))
        if filled != int(np.prod(shape)):
            raise ValueError(
                f"checkpoint shards do not cover the tensor of shape "
                f"{shape} (covered {filled} of {int(np.prod(shape))} "
                f"elements)")
        return out


def _to_torch(arr, dtype_name_):
    """A shard read in its storage dtype -> a CPU tensor of its dtype."""
    if dtype_name_ == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _cast(src, dtype):
    """``src`` (CPU tensor) in ``dtype``; from bf16 through fp32."""
    if src.dtype == dtype:
        return src
    if src.dtype == torch.bfloat16:
        src = src.float()
    return src.to(dtype)


def load_state_dict(state_dict, path, process_group=None, timings=None):
    """Fill ``state_dict`` (possibly nested) IN PLACE from the checkpoint
    at ``path``: each torch tensor by ``copy_`` on its own device (under
    the caller's current CUDA stream), cast to its dtype; each numpy
    array leaf is replaced by the read array cast to its dtype; scalars
    whose slot exists in the target are assigned. Raises ``KeyError`` for
    tensors the checkpoint lacks, ``ValueError`` on a shape mismatch.
    ``timings`` (a dict), when given, gains ``read_s`` (the disk read),
    ``copy_s`` (casts and the copies into the targets) and ``bytes``
    (read)."""
    if process_group is not None:
        raise NotImplementedError(PROCESS_GROUPS_NOT_PORTED)
    with open(metadata_path(path)) as f:
        meta = Metadata.from_json(f.read())
    read_s = copy_s = 0.0
    nbytes = 0
    missing = []
    for name, leaf in list(_walk(state_dict)):
        if not _is_array_leaf(leaf):
            continue
        tmeta = meta.tensors.get(name)
        if tmeta is None:
            missing.append(name)
            continue
        if list(leaf.shape) != list(tmeta.shape):
            raise ValueError(
                f"{name}: checkpoint shape {tmeta.shape} != "
                f"target shape {list(leaf.shape)}")
        t0 = time.perf_counter()
        arr = _ShardReader(path, tmeta).read()
        t1 = time.perf_counter()
        read_s += t1 - t0
        nbytes += arr.nbytes
        src = _to_torch(arr, tmeta.dtype)
        if isinstance(leaf, torch.Tensor):
            with torch.no_grad():
                leaf.copy_(_cast(src, leaf.dtype))
        else:
            _assign_nested(state_dict, name,
                           _cast(src, _torch_dtype(leaf.dtype)).numpy())
        copy_s += time.perf_counter() - t1
    if missing:
        raise KeyError(
            f"checkpoint at {path} is missing tensors: {missing[:5]}"
            + ("..." if len(missing) > 5 else ""))
    for name, value in meta.scalars.items():
        try:
            _assign_nested(state_dict, name, value)
        except (KeyError, IndexError, TypeError):
            pass  # scalar slot absent from the target dict: skip
    if timings is not None:
        for k, v in (("read_s", read_s), ("copy_s", copy_s),
                     ("bytes", nbytes)):
            timings[k] = timings.get(k, 0) + v


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _assign_nested(obj, slash_key, value):
    parts = slash_key.split("/")
    for p in parts[:-1]:
        obj = obj[int(p)] if isinstance(obj, (list, tuple)) else obj[p]
    last = parts[-1]
    if isinstance(obj, (list, tuple)):
        obj[int(last)] = value
    else:
        obj[last] = value
