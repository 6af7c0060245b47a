"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (counterpart of ``paddle_tpu/kernels``).

- :mod:`.rms_norm` (``csrc/rms_norm.cu``) <- ``kernels/rms_norm.py``,
  forward and backward
- :mod:`.rope` (``csrc/rope.cu``) <- ``kernels/rope.py``, forward and
  backward
- :mod:`.paged_attention` (``csrc/paged_attention.cu``) <-
  ``kernels/paged_attention.py``, float and int8 arenas
- :mod:`.flash_attention` (``csrc/flash_attention.cu``) <-
  ``kernels/flash_attention.py``, forward and backward; on the tensor
  cores (wgmma, TMA) at every head dim: bf16 as it is, fp32 through
  split products that keep the fp32 contract (above 128 on pairs of
  CTAs, each on half of the head dim)
- :mod:`.int8_matmul` (``csrc/int8_matmul.cu``) <-
  ``kernels/int8_matmul.py``, the W8A16 matmul; bf16 on the tensor
  cores (wgmma on the weight dequantized in shared memory), fp32 on the
  CUDA cores
- :mod:`.fused_norm_matmul` (``csrc/fused_norm_matmul.cu``) <-
  ``kernels/fused_norm_matmul.py``, RMSNorm + matmul (the Llama head);
  bf16 on the tensor cores, fp32 too from ``SPLIT_MIN_ROWS`` rows
  (three-part split products), fewer fp32 rows on the CUDA cores; its
  backward is the
  plain version's VJP, as in JAX
- :mod:`.fused_rope_attention` (``csrc/flash_attention.cu``, the
  rope-on-load forward) <- ``kernels/fused_rope_attention.py``; bf16 at
  head dims 64 to 128 on the tensor cores (hi/lo products that keep the
  fp32 contract), the rest through split products (q and k rotated and
  split into three parts, then flash attention's split forward); its
  backward is the VJP of the plain version, as in JAX, composed of the
  rope and flash attention kernels in fp32
- :mod:`.fused_adam` (``csrc/multi_tensor.cu``) <-
  ``kernels/fused_adam.py`` ``fused_adam_update`` and the optimizer layer
  XLA fuses into the JAX train step (no Pallas kernel): the multi-tensor
  sum of squares and the Adam/AdamW, SGD/Momentum and Lamb updates, each a
  few launches for a whole parameter list

- :mod:`.fp8_matmul` (``csrc/fp8_matmul.cu``) <- no Pallas kernel: the
  fp8 ``dot_general`` and ``_quantize`` that ``amp/fp8.py`` (AMP O3)
  leaves to XLA; the fp8 GEMM on the tensor cores (wgmma k32 on e4m3 and
  e5m2 operands, fp32 promotion every 128 of K) in its three operand
  forms, and the fp8 quantize (codes, transposed codes, amax)

With these every ``pl.pallas_call`` of the JAX package has a hand-written
counterpart. Each module counts the kernel launches it made
(``launches`` for the forward, ``bwd_launches`` for the backward (the
fused rope + attention's: one per composition of its kernels),
``int8_launches`` for the int8 paged attention; ``fp16_launches`` and
``fp16_bwd_launches`` (``fp16_sumsq_launches``, ``fp16_adam_launches``)
for the kernels that take fp16, :func:`fp16_launch_counts`; flash attention, the
W8A16 matmul and the two fusions also per design,
:func:`flash_design_counts`, :func:`int8_matmul_design_counts` and
:func:`fusion_design_counts`); a serving program captured as a CUDA
graph takes what its capture added to the counters off again and adds it
at every replay (:func:`measure_launches`, :func:`add_launches`), so the
counts are the launches the card ran. :mod:`._build` compiles ``csrc/``
with nvcc at first use.
"""
from . import (  # noqa: F401
    flash_attention,
    fp8_matmul,
    fused_adam,
    fused_norm_matmul,
    fused_rope_attention,
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
    "rms_norm_matmul": (fused_norm_matmul, "launches"),
    "rope_attention": (fused_rope_attention, "launches"),
    "rope_attention_bwd": (fused_rope_attention, "bwd_launches"),
    "mt_sumsq": (fused_adam, "sumsq_launches"),
    "mt_adam": (fused_adam, "adam_launches"),
    "mt_momentum": (fused_adam, "momentum_launches"),
    "mt_lamb": (fused_adam, "lamb_launches"),
    "fp8_gemm": (fp8_matmul, "launches"),
    "fp8_quantize": (fp8_matmul, "quantize_launches"),
}

# the launches over fp16 tensors, of the totals above
FP16_KERNELS = {
    "rms_norm_fp16": (rms_norm, "fp16_launches"),
    "rms_norm_bwd_fp16": (rms_norm, "fp16_bwd_launches"),
    "rope_fp16": (rope, "fp16_launches"),
    "rope_bwd_fp16": (rope, "fp16_bwd_launches"),
    "flash_attention_fwd_fp16": (flash_attention, "fp16_launches"),
    "flash_attention_bwd_fp16": (flash_attention, "fp16_bwd_launches"),
    "mt_sumsq_fp16": (fused_adam, "fp16_sumsq_launches"),
    "mt_adam_fp16": (fused_adam, "fp16_adam_launches"),
}


# modules that also count their launches by design (tensor cores "tc",
# the fusions' fp32 split products "split", CUDA cores "cc")
DESIGN_MODULES = (flash_attention, int8_matmul, fused_norm_matmul,
                  fused_rope_attention)


# every launch counter, once: (module, attribute)
COUNTERS = tuple(dict.fromkeys(
    [*KERNELS.values(), *FP16_KERNELS.values()]
    + [(mod, attr) for mod in DESIGN_MODULES for attr in mod.DESIGN_COUNTERS]))


def reset_launch_counts():
    for mod, attr in COUNTERS:
        setattr(mod, attr, 0)


def measure_launches(fn):
    """Run ``fn()`` and undo what it added to the launch counters: returns
    ``(fn(), launches)``, the counters it moved as ``(module, attribute,
    count)`` triples. A CUDA-graph capture records launches without
    making them; :func:`add_launches` counts them at each replay."""
    before = [getattr(mod, attr) for mod, attr in COUNTERS]
    try:
        out = fn()
    finally:
        after = [getattr(mod, attr) for mod, attr in COUNTERS]
        for (mod, attr), n in zip(COUNTERS, before):
            setattr(mod, attr, n)
    return out, tuple((mod, attr, b - a) for (mod, attr), a, b in
                      zip(COUNTERS, before, after) if b != a)


def add_launches(launches):
    """Add :func:`measure_launches`' counts to the counters."""
    for mod, attr, n in launches:
        setattr(mod, attr, getattr(mod, attr) + n)


def launch_counts():
    return {name: getattr(mod, attr) for name, (mod, attr) in
            KERNELS.items()}


def fp16_launch_counts():
    """The launches over fp16 tensors of the kernels that take fp16
    (:data:`FP16_KERNELS`: RMSNorm, rope and flash attention forward and
    backward, the sum of squares and the Adam update)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in
            FP16_KERNELS.items()}


def flash_design_counts():
    """Flash attention launches by design: ``tc_*`` the tensor-core
    kernels, ``cc_*`` the CUDA-core kernels (``flash_attention.design``
    says which runs)."""
    return {attr: getattr(flash_attention, attr)
            for attr in flash_attention.DESIGN_COUNTERS}


def int8_matmul_design_counts():
    """W8A16 launches by design: ``tc_launches`` the tensor-core kernels
    (bf16 x), ``cc_launches`` the CUDA-core kernels (fp32 x)."""
    return {attr: getattr(int8_matmul, attr)
            for attr in int8_matmul.DESIGN_COUNTERS}


def fusion_design_counts():
    """The two fusions' launches by design: ``{"rms_norm_matmul": {...},
    "rope_attention": {...}}``, each ``tc_launches`` (tensor cores: bf16),
    ``split_launches`` (tensor cores through three-part split products:
    fp32, and the rope-on-load forward's other bf16 head dims) and
    ``cc_launches`` (CUDA cores); the rope attention's also
    ``bwd_launches`` (its backward's compositions of the rope and flash
    kernels)."""
    return {name: {attr: getattr(mod, attr) for attr in mod.DESIGN_COUNTERS}
            for name, mod in (("rms_norm_matmul", fused_norm_matmul),
                              ("rope_attention", fused_rope_attention))}
