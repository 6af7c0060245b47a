"""PTQ and QAT of the port (``paddle_tpu_torch.quantization``: the
config, observers, quanters, ``QAT``, ``PTQ`` and ``quantize_for_serving``
of their ``ObservedLayer``s) against the JAX package's, on the CPU.

Bit-equal: the observers' and quanters' scales (the per-tensor ones in
Python floats, the per-channel ones in numpy float32, as JAX computes
them), ``fake_quant``'s values and its straight-through gradients (against
JAX's op-by-op math; its compiled public op within one ulp), the
scales PTQ and QAT freeze on a model whose quantized layers see the data
itself, and the int8 codes and scales ``quantize_for_serving`` makes of
them. On the tiny Llama the weight scales and the int8 codes are
bit-equal and the activation scales within 1e-6 relative (each is the
largest |value| of an activation that two layers of fp32 math in other
orders move by about that much). Three eager AdamW steps of a QAT model
match JAX's losses within 1e-6 relative, the tolerance of
``tests/test_torch_optim_extra.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import quantization as jq  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.quantization import quanters as jquanters  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch import quantization as tq  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.quantization import quanters as tquanters  # noqa
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)


def _jnp(x):
    return np.asarray(x.value if isinstance(x, Tensor) else x)


# ---------------------------------------------------------- the pieces
def test_observer_and_quanter_scales_bit_equal_jax():
    rng = np.random.RandomState(0)
    batches = [(rng.randn(6, 5) * (i + 1)).astype(np.float32)
               for i in range(3)]
    for bits in (8, 4):
        for factory, kw in (("AbsmaxObserver", {}),
                            ("PerChannelAbsmaxObserver", {}),
                            ("PerChannelAbsmaxObserver",
                             {"channel_axis": 0})):
            jo = getattr(jq, factory)(quant_bits=bits, **kw)._instance()
            to = getattr(tq, factory)(quant_bits=bits, **kw)._instance()
            for b in batches:
                jo.observe(Tensor(jnp.asarray(b)))
                to.observe(torch.from_numpy(b))
            want, got = jo.scales(), to.scales()
            assert type(got) is type(want)
            np.testing.assert_array_equal(got, want)
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype == np.float32
        jf = jq.FakeQuanterWithAbsMaxObserver(bits, 0.7)._instance()
        tf = tq.FakeQuanterWithAbsMaxObserver(bits, 0.7)._instance()
        for b in batches:
            jout = jf(Tensor(jnp.asarray(b)))
            tout = tf(torch.from_numpy(b))
            assert tf.scale() == jf.scale()  # Python floats, bit-equal
            np.testing.assert_array_equal(tout.numpy(), _jnp(jout))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_channel", [False, True])
def test_fake_quant_values_and_ste_grads_bit_equal_jax(per_channel, bits):
    import jax

    rng = np.random.RandomState(1)
    x = (rng.randn(7, 6) * 3).astype(np.float32)
    x[0, :3] = [0.5, -1.5, 2.5]  # ties at scale 1: round half to even
    scale = (np.abs(rng.randn(6)).astype(np.float32) / 10 if per_channel
             else 1.0)
    weights = rng.randn(7, 6).astype(np.float32)
    qmax = float(2 ** (bits - 1) - 1)
    jval, jvjp = jax.vjp(
        lambda v: jquanters._fake_quant(v, jnp.asarray(scale, jnp.float32),
                                        qmax=qmax), jnp.asarray(x))
    jgrad = jvjp(jnp.asarray(weights))[0]
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tquanters.fake_quant(tx, scale, bits)
    out.backward(torch.from_numpy(weights))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jval))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrad))
    # JAX's public helper runs the same math as one compiled op, whose
    # fused code may round x + (dq - x) one ulp apart from the op-by-op
    # math above (measured: 1 of 42 entries, per-channel, 8 bits; JAX's
    # own jitted and eager results differ there too)
    want = jq.quanters.fake_quant(Tensor(jnp.asarray(x)), scale, bits)
    np.testing.assert_allclose(out.detach().numpy(), _jnp(want),
                               rtol=2.0 ** -23, atol=0)


# -------------------------------------------- models the data reaches
class _JTwo(paddle.nn.Layer):
    """Two Linears on the same input: every quantized layer sees the
    data itself."""

    def __init__(self):
        super().__init__()
        self.a = paddle.nn.Linear(8, 4, bias_attr=False)
        self.b = paddle.nn.Linear(8, 4, bias_attr=False)

    def forward(self, x):
        return self.a(x) + self.b(x)


class _TTwo(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = tnn.Linear(8, 4, device="cpu")
        self.b = tnn.Linear(8, 4, device="cpu")

    def forward(self, x):
        return self.a(x) + self.b(x)


def _two(seed=2):
    rng = np.random.RandomState(seed)
    jm, tm = _JTwo(), _TTwo()
    for name in ("a", "b"):
        w = (rng.randn(8, 4) * 0.5).astype(np.float32)
        getattr(jm, name).weight.value = jnp.asarray(w)
        with torch.no_grad():
            getattr(tm, name).weight.copy_(torch.from_numpy(w))
    data = [rng.randn(5, 8).astype(np.float32) for _ in range(3)]
    return jm, tm, data


def _observed(model):
    """``{path: (act_scale, weight_scale, act_bits, weight_bits)}`` of a
    converted model's ObservedLayers."""
    subs = (model.named_sublayers() if hasattr(model, "named_sublayers")
            else model.named_modules())
    return {k: (m.act_scale, m.weight_scale, m.act_bits, m.weight_bits)
            for k, m in subs if type(m).__name__ == "ObservedLayer"}


def _scales_equal(got, want, act_rtol=0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        (ga, gw, *gb), (wa, ww, *wb) = got[k], want[k]
        assert gb == wb, k
        for g, w, rtol in ((ga, wa, act_rtol), (gw, ww, 0.0)):
            assert (g is None) == (w is None), k
            if w is not None:
                assert type(g) is type(w) and np.shape(g) == np.shape(w), k
                np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                           err_msg=k)


def _int8_equal(tmodel, jmodel):
    """Every QuantizedLinear's int8 codes and scales, bit for bit."""
    want = {k: (np.asarray(m.weight_q.value), np.asarray(
        m.weight_scale.value)) for k, m in jmodel.named_sublayers()
        if type(m).__name__ == "QuantizedLinear"}
    got = {k: (m.weight_q.numpy(), m.weight_scale.numpy())
           for k, m in tmodel.named_modules()
           if type(m).__name__ == "QuantizedLinear"}
    assert sorted(got) == sorted(want) and want
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)
        np.testing.assert_array_equal(got[k][1], want[k][1], err_msg=k)


def _config(m, act, weight, override=None):
    cfg = m.QuantConfig()
    cfg.add_type_config(m is tq and tnn.Linear or paddle.nn.Linear,
                        activation=act, weight=weight)
    if override is not None:
        cfg.add_layer_config([override], activation=None, weight=None)
    return cfg


def test_ptq_and_quantize_for_serving_bit_equal_jax():
    jm, tm, data = _two()
    jp = jq.PTQ(_config(jq, jq.AbsmaxObserver(),
                        jq.PerChannelAbsmaxObserver()))
    tp = tq.PTQ(_config(tq, tq.AbsmaxObserver(),
                        tq.PerChannelAbsmaxObserver()))
    jo, to = jp.quantize(jm), tp.quantize(tm)
    assert to is not tm and type(to.a).__name__ == "_ObservingWrapper"
    for x in data[:2]:
        jo(Tensor(jnp.asarray(x)))
        to(torch.from_numpy(x))
    jc, tc = jp.convert(jo), tp.convert(to)
    _scales_equal(_observed(tc), _observed(jc))
    _int8_equal(tq.quantize_for_serving(tc), jq.quantize_for_serving(jc))


def test_qat_convert_override_and_serving_bit_equal_jax():
    """QAT with the moving-average quanters, ``b`` overridden by an
    ``add_layer_config`` to no quantization (wrapped, nothing frozen):
    one forward, convert, serve."""
    jm, tm, data = _two(seed=3)
    fq = "FakeQuanterWithAbsMaxObserver"
    jqat = jq.QAT(_config(jq, getattr(jq, fq)(moving_rate=0.8),
                          getattr(jq, fq)(quant_bits=8), override=jm.b))
    tqat = tq.QAT(_config(tq, getattr(tq, fq)(moving_rate=0.8),
                          getattr(tq, fq)(quant_bits=8), override=tm.b))
    jw, tw = jqat.quantize(jm), tqat.quantize(tm)
    assert tw.b._weight_quanter is None and tw.a._weight_quanter is not None
    for x in data[:2]:
        # the products sum 8 terms in another order: fp32 rounding apart
        np.testing.assert_allclose(
            tw(torch.from_numpy(x)).detach().numpy(),
            _jnp(jw(Tensor(jnp.asarray(x)))), rtol=1e-6, atol=1e-6)
    jc, tc = jqat.convert(jw), tqat.convert(tw)
    _scales_equal(_observed(tc), _observed(jc))
    assert _observed(tc)["b"][:2] == (None, None)
    _int8_equal(tq.quantize_for_serving(tc), jq.quantize_for_serving(jc))


def test_qat_eager_adamw_steps_match_jax():
    jm, tm, data = _two(seed=4)
    fq = "FakeQuanterWithAbsMaxObserver"
    jw = jq.QAT(_config(jq, getattr(jq, fq)(),
                        jq.PerChannelAbsmaxObserver())).quantize(jm)
    tw = tq.QAT(_config(tq, getattr(tq, fq)(),
                        tq.PerChannelAbsmaxObserver())).quantize(tm)
    jopt = paddle.optimizer.AdamW(learning_rate=0.01,
                                  parameters=jw.parameters())
    topt_ = topt.AdamW(0.01, parameters=tw.named_parameters())
    y = np.random.RandomState(5).randn(5, 4).astype(np.float32)
    jl, tl = [], []
    for x in data:
        loss = ((jw(Tensor(jnp.asarray(x))) - Tensor(jnp.asarray(y)))
                ** 2).mean()
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(_jnp(loss)))
        loss = ((tw(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
        loss.backward()
        topt_.step()
        topt_.clear_grad()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    for name in ("a", "b"):
        np.testing.assert_allclose(
            getattr(tw, name)._inner.weight.detach().numpy(),
            _jnp(getattr(jw, name)._inner.weight), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the Llama
def _llamas():
    paddle.seed(11)
    jnet = JLlama(JConfig(**CFG))
    arrays = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=1)
    load_numpy_state(tnet, arrays)
    ids = [np.random.RandomState(6 + i).randint(0, 64, (1, 8))
           for i in range(2)]
    return jnet, tnet, ids


def test_llama_ptq_to_serving_match_jax():
    """PTQ on the tiny Llama (the lm_head overridden to no observers),
    two calibration prompts: the same ObservedLayers, weight scales
    bit-equal, activation scales within 1e-6, and the int8 codes and
    scales of ``quantize_for_serving`` bit-equal (the head, frozen with
    nothing, gets fresh per-channel scales on both sides)."""
    jnet, tnet, ids = _llamas()
    jflow = jq.PTQ(_config(jq, jq.AbsmaxObserver(),
                           jq.PerChannelAbsmaxObserver(),
                           override=jnet.lm_head))
    tflow = tq.PTQ(_config(tq, tq.AbsmaxObserver(),
                           tq.PerChannelAbsmaxObserver(),
                           override=tnet.lm_head))
    jw, tw = jflow.quantize(jnet), tflow.quantize(tnet)
    with torch.no_grad():
        for p in ids:
            jw(Tensor(jnp.asarray(p)))
            tw(torch.from_numpy(p).long())
    jc, tc = jflow.convert(jw), tflow.convert(tw)
    got, want = _observed(tc), _observed(jc)
    # 6 projections a layer and the head (wrapped, nothing frozen)
    assert len(want) == 13 and got["lm_head"][:2] == (None, None)
    _scales_equal(got, want, act_rtol=1e-6)
    _int8_equal(tq.quantize_for_serving(tc), jq.quantize_for_serving(jc))
