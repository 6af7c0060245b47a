"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (counterpart of ``paddle_tpu/kernels``).

- :mod:`.rms_norm` (``csrc/rms_norm.cu``) <- ``kernels/rms_norm.py``,
  forward and backward
- :mod:`.rope` (``csrc/rope.cu``) <- ``kernels/rope.py``, forward and
  backward
- :mod:`.paged_attention` (``csrc/paged_attention.cu``) <-
  ``kernels/paged_attention.py``
- :mod:`.flash_attention` (``csrc/flash_attention.cu``) <-
  ``kernels/flash_attention.py``, forward and backward

Each module counts the kernel launches it made (``launches`` for the
forward, ``bwd_launches`` for the backward); :mod:`._build` compiles
``csrc/`` with nvcc at first use.
"""
from . import flash_attention, paged_attention, rms_norm, rope  # noqa: F401

# kernel name -> (module, counter attribute)
KERNELS = {
    "rms_norm": (rms_norm, "launches"),
    "rms_norm_bwd": (rms_norm, "bwd_launches"),
    "rope": (rope, "launches"),
    "rope_bwd": (rope, "bwd_launches"),
    "paged_attention": (paged_attention, "launches"),
    "flash_attention_fwd": (flash_attention, "launches"),
    "flash_attention_bwd": (flash_attention, "bwd_launches"),
}


def reset_launch_counts():
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


def launch_counts():
    return {name: getattr(mod, attr) for name, (mod, attr) in
            KERNELS.items()}
