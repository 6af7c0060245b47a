"""Durable file primitives for checkpointing: write-temp, fsync, rename
(counterpart of ``paddle_tpu/distributed/checkpoint/fsio.py``).

The commit protocol of ``paddle_tpu_torch.checkpoint`` holds only if
every single file write is atomic: a file either has its complete
contents or does not exist. Each writer here writes to a ``.inflight``
name in the same directory, flushes and fsyncs the file, ``os.replace``s
it onto the final name and, at commit points, fsyncs the parent
directory. Every writer also returns the CRC32 and byte count of what it
wrote, computed while the bytes stream through, so the commit manifest
needs no second read.

``atomic_save_npy`` writes the ``.npy`` bytes ``np.save`` writes for
the same array: a version 1.0 header and the C-order data. A bfloat16
tensor (numpy on the card has no such dtype) is written as its raw
2-byte words under the header descr ``'<V2'``, which is what ``np.save``
writes for the JAX package's ``ml_dtypes`` bfloat16 arrays.
"""
from __future__ import annotations

import os
import zlib

import numpy as np
import torch

INFLIGHT_SUFFIX = ".inflight"
# the data is written in chunks of this many bytes (np.save's buffer)
CHUNK_BYTES = 16 << 20


def fsync_dir(dirname):
    """fsync a directory so a just-performed rename/create in it is
    durable (no-op on platforms that cannot open directories)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class _CRC32Writer:
    """File-object wrapper accumulating CRC32/size of everything written."""

    def __init__(self, f):
        self._f = f
        self.crc32 = 0
        self.nbytes = 0

    def write(self, data):
        if isinstance(data, str):
            data = data.encode("utf-8")
        self._f.write(data)
        self.crc32 = zlib.crc32(data, self.crc32)
        n = data.nbytes if isinstance(data, memoryview) else len(data)
        self.nbytes += n
        return n


def _atomic_write(path, emit):
    """Run ``emit(crc_writer)`` against ``path + INFLIGHT_SUFFIX``, fsync,
    rename into place. Returns (crc32, nbytes)."""
    tmp = path + INFLIGHT_SUFFIX
    with open(tmp, "wb") as f:
        w = _CRC32Writer(f)
        emit(w)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return w.crc32, w.nbytes


def host_array(value):
    """``value`` (a torch tensor on any device, or array-like) as a
    C-contiguous numpy array and its header descr: bfloat16 as uint16
    words under ``'<V2'``."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "<V2"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(value))
    return arr, np.lib.format.dtype_to_descr(arr.dtype)


def _emit_npy(w, arr, descr):
    np.lib.format.write_array_header_1_0(
        w, {"descr": descr, "fortran_order": False, "shape": arr.shape})
    if arr.size == 0:
        return
    data = memoryview(arr.reshape(-1).view(np.uint8))
    for i in range(0, data.nbytes, CHUNK_BYTES):
        w.write(data[i:i + CHUNK_BYTES])


def atomic_save_npy(path, array):
    """Write ``array`` (a torch tensor or an array) to ``path`` as
    ``.npy`` atomically; returns (crc32, nbytes) of the stream."""
    arr, descr = host_array(array)
    return _atomic_write(path, lambda w: _emit_npy(w, arr, descr))


def atomic_write_text(path, text):
    """Write ``text`` to ``path`` atomically; returns (crc32, nbytes)."""
    return _atomic_write(path, lambda w: w.write(text))


def crc32_file(path, chunk_size=1 << 20):
    """CRC32 + size of an existing file (the verify side of the
    manifest's checksums)."""
    crc, n = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)
    return crc, n
