"""The fused rope + attention backward, composed of the port's kernels.

``fused_rope_attention.rope_attention_backward`` is the JAX package's
``_bwd`` (``paddle_tpu/kernels/fused_rope_attention.py:153``, the VJP of
``_composed_2d_tables``) built from the rope and flash attention kernels
in fp32: rotate q and k, the flash forward for O and LSE, the flash
backward, the rope backward (-sin), one cast. On the CPU the same
composition runs through the kernels' plain versions, which is what
these tests hold against ``jax.grad`` through ``rope_attention_fused`` (its
Pallas forward in interpret mode). Tolerances: fp32 gradients within
1e-5 of each gradient's largest entry (the same fp32 function summed in
other orders); bf16 entry by entry within 2^-7 of the entry plus that
(both sides work in fp32 and cast once, so the casts may round one ulp
apart). Three seeded faults, each a rounding the JAX ``_bwd`` does not
make, must fall outside the fp32 tolerance: Delta from O rounded to
bf16, the rope backward rotating by +theta, and the LSE of scores formed
from the rotated q and k rounded to bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import fused_rope_attention as jfra  # noqa: E402
from paddle_tpu.kernels.rope import build_rope_cache  # noqa: E402
from paddle_tpu_torch.kernels import fused_rope_attention as tfra  # noqa
from paddle_tpu_torch.kernels import rope as trope  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

TOL32 = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (batch, seq, heads, head_dim): a padded head dim on the card (72 -> 80)
SHAPES = {"d16": (2, 32, 2, 16), "d72": (1, 64, 2, 72)}


def _inputs(shape, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _jax_grads(q, k, v, g, dtype):
    jd = DTYPES[dtype][0]
    s, d = q.shape[1], q.shape[3]
    cos, sin = build_rope_cache(s, d)
    gj = jnp.asarray(g).astype(jd)
    grads = jax.jit(jax.grad(lambda a, b, c: (jfra.rope_attention_fused(
        a, b, c, cos, sin, block_q=16).astype(jnp.float32)
        * gj.astype(jnp.float32)).sum(), argnums=(0, 1, 2)))(
        *(jnp.asarray(t).astype(jd) for t in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


def _port_grads(q, k, v, g, dtype):
    td = DTYPES[dtype][1]
    s, d = q.shape[1], q.shape[3]
    cos, sin = trope.build_rope_cache(s, d)
    ins = [torch.from_numpy(t).to(td).requires_grad_(True) for t in (q, k, v)]
    out = tfra.rope_attention_fused(*ins, cos, sin)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g).to(td))
    return [x.float().numpy() for x in grads]


def _worst(got, want, dtype):
    """The largest error over its tolerance across dq, dk, dv."""
    worst = 0.0
    for a, w in zip(got, want):
        tol = TOL32 * np.abs(w).max()
        if dtype == "bfloat16":
            tol = tol + 2.0 ** -7 * np.abs(w)
        worst = max(worst, float((np.abs(a - w) / tol).max()))
    return worst


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fused_backward_matches_jax_bwd(dtype, shape):
    q, k, v, g = _inputs(SHAPES[shape])
    got = _port_grads(q, k, v, g, dtype)
    want = _jax_grads(q, k, v, g, dtype)
    assert _worst(got, want, dtype) <= 1.0


def _plus_sin(g, cos, sin, position_ids=None):
    return trope.rope_reference(g, cos, sin, position_ids)


def _delta_from_bf16_o(monkeypatch):
    bwd = tfra.flash_attention_backward_reference
    monkeypatch.setattr(
        tfra, "flash_attention_backward_reference",
        lambda q, k, v, o, lse, do, c, s: bwd(
            q, k, v, o.bfloat16().float(), lse, do, c, s))


def _lse_from_bf16_scores(monkeypatch):
    fwd = tfra.flash_attention_reference

    def faulty(q, k, v, causal, scale):
        o, _ = fwd(q, k, v, causal, scale)
        _, lse = fwd(q.bfloat16().float(), k.bfloat16().float(), v, causal,
                     scale)
        return o, lse

    monkeypatch.setattr(tfra, "flash_attention_reference", faulty)


FAULTS = {
    "delta_from_bf16_o": _delta_from_bf16_o,
    "rope_backward_plus_sin": lambda mp: mp.setattr(
        tfra, "rope_backward_reference", _plus_sin),
    "lse_from_bf16_scores": _lse_from_bf16_scores,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fused_backward_seeded_faults_fail(monkeypatch, fault):
    """Each fault replaces one step of the CPU composition; the fp32
    gradients then fall outside the 1e-5 tolerance (the composition, not
    autograd through the plain forward, is what runs)."""
    q, k, v, g = _inputs(SHAPES["d16"])
    want = _jax_grads(q, k, v, g, "float32")
    FAULTS[fault](monkeypatch)
    assert _worst(_port_grads(q, k, v, g, "float32"), want, "float32") > 1.0


def test_rope_kernel_op_order_is_the_rotation_of_the_fused_path():
    """The rope kernel's plain version rotates in ``_rotate``'s op order
    (the pre-pass pairing of column c with c + D/2) bit for bit in fp32,
    and its backward (-sin) is autograd through ``_rotate`` bit for bit:
    the fused backward's rotations are the fused forward's."""
    b, s, h, d = 2, 24, 3, 40
    x, g = (torch.from_numpy(t) for t in _inputs((b, s, h, d))[:2])
    cos, sin = trope.build_rope_cache(s, d)
    assert torch.equal(trope.rope_reference(x, cos, sin),
                       tfra._rotate(x, cos, sin))
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(tfra._rotate(xr, cos, sin), xr, g)
    assert torch.equal(trope.rope_backward_reference(g, cos, sin), want)
