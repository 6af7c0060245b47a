"""The KV frame codec (counterpart of the frame part of
``paddle_tpu/serving/fleet/kv_transfer.py``: ``MAGIC`` ``:66``,
``_HEAD`` ``:69``, ``_HLEN`` ``:70``, ``MAX_FRAME_BYTES`` ``:73``,
``TransferError`` ``:76``, ``_encode_array`` ``:131``,
``_decode_array`` ``:136``)::

    frame := MAGIC(4) | payload_len(u64 BE) | crc32(u32 BE) | payload
    payload := header_len(u32 BE) | header_json | raw_bytes

An array crosses as its host bytes in C order under a header of its
dtype name and shape. A torch tensor is copied to the host first; bf16
has no numpy dtype here, so it crosses as its raw 2-byte words under
the dtype name ``"bfloat16"``, the name JAX writes. A frame of the port
is byte-for-byte the JAX frame of the same arrays, so either package
reads the other's. Decoding gives CPU torch tensors. The socket side
(``send_frame``, ``recv_frame``, the prefill worker) is queue A item
1.7.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

# the current wire magic and the one a receiver still accepts
MAGIC = b"PKV2"
MAGIC_V1 = b"PKV1"
_HEAD = struct.Struct(">QI")   # payload_len, crc32
_HLEN = struct.Struct(">I")    # header_json length
# one frame is at most a few pages of KV; anything past this is a
# corrupted length field, not a real payload
MAX_FRAME_BYTES = 1 << 31

# dtype name -> torch dtype, for the dtypes a KV page holds
_TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
}


class TransferError(RuntimeError):
    """Any failure of a KV frame: magic, length, CRC, header or leaf
    sizes. The spill tier counts it as a refusal and the request falls
    back to a cold prefill."""


def _encode_array(arr):
    """``(header, bytes)`` of one array (a torch tensor or anything numpy
    takes), its bytes in C order."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            data = t.view(torch.int16).numpy().tobytes()
        else:
            data = t.numpy().tobytes()
        return {"dtype": name, "shape": list(t.shape)}, data
    a = np.asarray(arr)
    return {"dtype": str(a.dtype), "shape": list(a.shape)}, a.tobytes()


def _itemsize(name):
    dt = _TORCH_DTYPES.get(name)
    if dt is None:
        raise TransferError(f"unsupported array dtype {name!r}")
    return torch.empty((), dtype=dt).element_size()


def _decode_array(header, blob):
    """One array of a frame as a CPU torch tensor (its own storage)."""
    name = header["dtype"]
    n = int(np.prod(header["shape"])) * _itemsize(name)
    if len(blob) != n:
        raise TransferError(
            f"array payload {len(blob)}B != expected {n}B for "
            f"{name}{header['shape']}"
        )
    dt = _TORCH_DTYPES[name]
    if n == 0:
        return torch.empty(header["shape"], dtype=dt)
    return torch.frombuffer(bytearray(blob), dtype=dt).reshape(
        header["shape"])
