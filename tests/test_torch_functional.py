"""The port's functionals take the reference's parameter lists.

``scaled_dot_product_attention``, ``rms_norm``, ``cross_entropy`` and
``linear`` in ``paddle_tpu_torch/nn/functional.py`` against the JAX
package's (``paddle_tpu/nn/functional/{attention,norm,loss,common}.py``):
every reference call below, positional and by keyword, either gives the
JAX result on the CPU (fp32, 1e-5 relative and 1e-6 absolute: the same
math summed in other orders) or raises a ``NotImplementedError`` that
names ROADMAP.md queue A item 5 (dropout while training, a bias, a norm
over more than the last axis). Inputs are
made with numpy from a seed and handed to both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

QUEUE = "ROADMAP.md queue A item 5"
RNG = np.random.RandomState(21)
Q, K, V = (RNG.randn(2, 5, 3, 8).astype(np.float32) for _ in range(3))
X = RNG.randn(4, 6, 16).astype(np.float32)
W16 = (1.0 + 0.1 * RNG.randn(16)).astype(np.float32)
B16 = RNG.randn(16).astype(np.float32)
WLIN = RNG.randn(16, 10).astype(np.float32)
LOGITS = RNG.randn(7, 11).astype(np.float32)
PROBS = np.exp(LOGITS) / np.exp(LOGITS).sum(-1, keepdims=True)
LABEL = RNG.randint(0, 11, (7,)).astype(np.int64)
LABEL[3] = -100
LABEL3 = np.where(LABEL < 0, 3, LABEL)  # ignore_index 3 instead
SOFT = PROBS[::-1].copy()
CLASS_W = RNG.rand(11).astype(np.float32)
MASK = np.where(RNG.rand(2, 1, 5, 5) < 0.3, -np.inf, 0.0).astype(np.float32)
MASK[..., 0] = 0.0

# name -> (function name, positional args, keyword args, refused): args are
# numpy arrays (None stays None), the same for both packages
CALLS = {
    "sdpa_causal_kw": ("scaled_dot_product_attention", (Q, K, V),
                       {"is_causal": True}, False),
    "sdpa_causal_pos": ("scaled_dot_product_attention",
                        (Q, K, V, None, 0.0, True), {}, False),
    "sdpa_mask_pos": ("scaled_dot_product_attention", (Q, K, V, MASK), {},
                      False),
    "sdpa_dropout_pos_training": ("scaled_dot_product_attention",
                                  (Q, K, V, None, 0.1), {}, True),
    "sdpa_dropout_kw_training": ("scaled_dot_product_attention", (Q, K, V),
                                 {"dropout_p": 0.1, "training": True}, True),
    "sdpa_dropout_pos_eval": ("scaled_dot_product_attention",
                              (Q, K, V, None, 0.1, False, False), {}, False),
    "sdpa_dropout_kw_eval": ("scaled_dot_product_attention", (Q, K, V),
                             {"dropout_p": 0.1, "training": False}, False),
    "rms_norm_pos": ("rms_norm", (X, W16), {}, False),
    "rms_norm_eps_pos": ("rms_norm", (X, W16, None, 1e-3), {}, False),
    "rms_norm_eps_kw": ("rms_norm", (X,),
                        {"weight": W16, "epsilon": 1e-3}, False),
    "rms_norm_no_weight": ("rms_norm", (X,), {}, False),
    "rms_norm_last_axis_kw": ("rms_norm", (X, W16),
                              {"begin_norm_axis": 2}, False),
    "rms_norm_bias_pos": ("rms_norm", (X, W16, B16), {}, True),
    "rms_norm_bias_kw": ("rms_norm", (X, W16), {"bias": B16}, True),
    "rms_norm_two_axes": ("rms_norm", (X, None, None, 1e-6, 1), {}, True),
    "cross_entropy_pos": ("cross_entropy", (LOGITS, LABEL), {}, False),
    "cross_entropy_ignore_pos": ("cross_entropy",
                                 (LOGITS, LABEL3, None, 3, "sum"), {}, False),
    "cross_entropy_kw": ("cross_entropy", (LOGITS, LABEL3),
                         {"reduction": "none", "ignore_index": 3}, False),
    "cross_entropy_no_softmax": ("cross_entropy", (PROBS, LABEL),
                                 {"use_softmax": False}, False),
    "cross_entropy_smoothing": ("cross_entropy", (LOGITS, LABEL),
                                {"label_smoothing": 0.1}, False),
    "cross_entropy_weight_pos": ("cross_entropy", (LOGITS, LABEL, CLASS_W),
                                 {}, False),
    "cross_entropy_weight_kw": ("cross_entropy", (LOGITS, LABEL),
                                {"weight": CLASS_W}, False),
    "cross_entropy_soft": ("cross_entropy", (LOGITS, SOFT),
                           {"soft_label": True}, False),
    "linear_pos": ("linear", (X, WLIN), {}, False),
    "linear_none_bias_kw": ("linear", (X, WLIN), {"bias": None}, False),
    "linear_bias_pos": ("linear", (X, WLIN, B16[:10]), {}, True),
    "linear_bias_kw": ("linear", (X, WLIN), {"bias": B16[:10]}, True),
}


def _jax(a):
    return Tensor(jnp.asarray(a)) if isinstance(a, np.ndarray) else a


def _torch(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("case", sorted(CALLS))
def test_reference_call_matches_jax_or_names_the_queue(case):
    fn, args, kwargs, refused = CALLS[case]
    port = getattr(TF, fn)
    if refused:
        with pytest.raises(NotImplementedError, match=QUEUE):
            port(*(_torch(a) for a in args),
                 **{k: _torch(a) for k, a in kwargs.items()})
        return
    want = getattr(JF, fn)(*(_jax(a) for a in args),
                           **{k: _jax(a) for k, a in kwargs.items()})
    got = port(*(_torch(a) for a in args),
               **{k: _torch(a) for k, a in kwargs.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want.value),
                               rtol=1e-5, atol=1e-6)


def test_dropout_position_is_not_causal():
    """The reference's fifth positional parameter is ``dropout_p``: with
    ``training=False`` a call that passes 0.1 there runs non-causal
    attention (it ran causal attention before the parameter lists
    matched)."""
    q, k, v = (torch.from_numpy(a) for a in (Q, K, V))
    got = TF.scaled_dot_product_attention(q, k, v, None, 0.1, training=False)
    full = TF.scaled_dot_product_attention(q, k, v)
    causal = TF.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert torch.equal(got, full) and not torch.equal(got, causal)
