"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (counterpart of ``paddle_tpu/kernels``).

- :mod:`.rms_norm` (``csrc/rms_norm.cu``) <- ``kernels/rms_norm.py``,
  forward and backward
- :mod:`.rope` (``csrc/rope.cu``) <- ``kernels/rope.py``, forward and
  backward
- :mod:`.paged_attention` (``csrc/paged_attention.cu``) <-
  ``kernels/paged_attention.py``, float and int8 arenas
- :mod:`.flash_attention` (``csrc/flash_attention.cu``) <-
  ``kernels/flash_attention.py``, forward and backward
- :mod:`.int8_matmul` (``csrc/int8_matmul.cu``) <-
  ``kernels/int8_matmul.py``, the W8A16 matmul

Each module counts the kernel launches it made (``launches`` for the
forward, ``bwd_launches`` for the backward, ``int8_launches`` for the
int8 paged attention); :mod:`._build` compiles
``csrc/`` with nvcc at first use.
"""
from . import (  # noqa: F401
    flash_attention,
    int8_matmul,
    paged_attention,
    rms_norm,
    rope,
)

# kernel name -> (module, counter attribute)
KERNELS = {
    "rms_norm": (rms_norm, "launches"),
    "rms_norm_bwd": (rms_norm, "bwd_launches"),
    "rope": (rope, "launches"),
    "rope_bwd": (rope, "bwd_launches"),
    "paged_attention": (paged_attention, "launches"),
    "flash_attention_fwd": (flash_attention, "launches"),
    "flash_attention_bwd": (flash_attention, "bwd_launches"),
    "paged_attention_int8": (paged_attention, "int8_launches"),
    "int8_matmul": (int8_matmul, "launches"),
}


def reset_launch_counts():
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


def launch_counts():
    return {name: getattr(mod, attr) for name, (mod, attr) in
            KERNELS.items()}
