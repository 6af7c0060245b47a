"""AMP O3 of the port (``paddle_tpu_torch.amp.fp8``, the fp8 kernels'
plain versions ``kernels/fp8_matmul.py``, ``CompiledTrainStep(amp_level=
"O3")``) against the JAX package's ``paddle_tpu.amp.fp8`` and trainer,
on the CPU, at the tiny size of ``tests/test_fp8_amp.py`` (vocab 64,
hidden 32, 2 layers).

Tolerances:

- the quantize codes, ``_delayed_scale`` and ``_roll_in``: bit-equal
  (the same fp32 division, clip and round-to-nearest-even cast);
- ``_fp8_dot`` forward and backward: the fp32 summation bound of the
  same fp8 products, ``K * 2^-24 * sum_k |a_k b_k| * sa * sb`` per entry
  (every fp8 x fp8 product is exact in fp32; only the order of the sums
  differs), plus half an ulp of the output's dtype for bf16;
- the tiny Llama's loss, every gradient and every amax under
  ``fp8_autocast`` at fp32 (no O1 casts) against ``jax.grad`` through
  JAX's: loss 1e-5 relative, gradients 1e-4 of their largest entry
  (fp32 sums in other orders move an activation by ~1e-7, which flips an
  e4m3 code only at a rounding boundary), amaxes 1e-6 relative;
- three O3 AdamW steps against JAX's trainer: losses within 2e-3
  relative (measured 1.0e-3 at step 1). At O1 the two frameworks round
  bf16 activations at other places (40-60% of the tiny model's logits
  differ by a bf16 ulp, the loss by 2.3e-5 without fp8), and e4m3's
  coarser grid turns a bf16 ulp into a code flip 1 time in 32 and a flip
  into 2^-3 of that value. The first step's amax histories within one
  bf16 ulp, 2^-7 relative (each amax is the largest |value| of a bf16
  tensor, and one value rounded the other way moves it by an ulp); later
  steps' within one e4m3 step, 2^-3 (after an update the weights differ
  wherever an e5m2 gradient code flipped; measured 5.5e-2 at step 3).
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.amp import fp8 as jfp8  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.jit.trainer import CompiledTrainStep as JStep  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import causal_lm_loss as jloss  # noqa: E402
from paddle_tpu.observability import StepMeter as JMeter  # noqa: E402
from paddle_tpu.observability import set_step_meter as jset_meter  # noqa
from paddle_tpu_torch import observability as tobs  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.amp import amp_cast, auto_cast  # noqa: E402
from paddle_tpu_torch.amp import fp8 as tfp8  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state, numpy_state  # noqa
from paddle_tpu_torch.jit import CompiledTrainStep  # noqa: E402
from paddle_tpu_torch.kernels import fp8_matmul as tk  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.models import causal_lm_loss  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

jac = sys.modules["paddle_tpu.amp.auto_cast"]

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)
STEPS = 3
JFMT = {"e4m3": (jnp.float8_e4m3fn, jfp8.E4M3_MAX),
        "e5m2": (jnp.float8_e5m2, jfp8.E5M2_MAX)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _spread(seed, shape):
    """Values of both signs spread over 1e-4 to 1e3 (log-uniform), and
    a few past the formats' largest values."""
    rng = np.random.RandomState(seed)
    mag = 10.0 ** rng.uniform(-4, 3, shape)
    x = (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    x.flat[:3] = [1e5, -7e4, 0.0]
    return x


def _codes(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


# ------------------------------------------------------------- unit level
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fmt", sorted(JFMT))
def test_quantize_codes_and_amax_bit_equal_jax(fmt, dtype):
    x = _spread(1, (64, 96))
    jx, tx = _both(x, dtype)
    jdt, fmax = JFMT[fmt]
    for s in (1.0, 0.37, 3.1e-3):
        want = jfp8._quantize(jx, jnp.float32(s), jdt, fmax)
        q, qt, am = tk.quantize(tx, torch.tensor(s, dtype=torch.float32),
                                fmt, rows=True, transposed=True, amax=True)
        np.testing.assert_array_equal(_codes(q), _codes(want))
        np.testing.assert_array_equal(_codes(qt), _codes(want).T)
        np.testing.assert_array_equal(_codes(tfp8._quantize(
            tx, torch.tensor(s, dtype=torch.float32), fmt)), _codes(want))
        assert float(am) == float(jnp.max(jnp.abs(jx.astype(jnp.float32))))
    # the transposed copy alone, and the amax alone (the backward's two
    # launches over the gradient)
    q, qt, am = tk.quantize(tx, torch.tensor(0.5), fmt, rows=False,
                            transposed=True)
    assert q is None and am is None
    assert tk.quantize(tx, None, fmt, rows=False, amax=True)[:2] == (None,
                                                                      None)


def test_delayed_scale_and_roll_in_bit_equal_jax():
    rng = np.random.RandomState(2)
    hist = [np.zeros(jfp8.HISTORY_LEN, np.float32),
            np.abs(rng.randn(jfp8.HISTORY_LEN)).astype(np.float32) * 37.0,
            np.full(jfp8.HISTORY_LEN, 1e-14, np.float32)]
    for h in hist:
        for fmax in (jfp8.E4M3_MAX, jfp8.E5M2_MAX):
            want = np.asarray(jfp8._delayed_scale(jnp.asarray(h), fmax))
            got = tfp8._delayed_scale(torch.from_numpy(h), fmax).numpy()
            np.testing.assert_array_equal(got, want)
        amax = np.float32(rng.rand() * 900)
        want = np.asarray(jfp8._roll_in(jnp.asarray(h), jnp.float32(amax)))
        got = tfp8._roll_in(torch.from_numpy(h), torch.tensor(amax)).numpy()
        np.testing.assert_array_equal(got, want)
    assert (tfp8.E4M3_MAX, tfp8.E5M2_MAX, tfp8.HISTORY_LEN, tfp8._EPS) == (
        jfp8.E4M3_MAX, jfp8.E5M2_MAX, jfp8.HISTORY_LEN, jfp8._EPS)


def _sum_bound(a, b, sa, sb):
    """The fp32 summation bound of ``a @ b`` over fp8 codes (numpy)."""
    k = a.shape[1]
    return np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64)) \
        * k * 2.0 ** -24 * abs(sa * sb)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fp8_dot_forward_backward_match_jax(dtype):
    rng = np.random.RandomState(3)
    x = rng.randn(24, 40).astype(np.float32)
    w = (rng.randn(40, 16) * 0.2).astype(np.float32)
    g = rng.randn(24, 16).astype(np.float32)
    sx, sw = np.float32(0.011), np.float32(0.0007)
    jd, td = DTYPES[dtype]
    jx, tx = _both(x, dtype)
    jw, tw = _both(w, dtype)
    name = jnp.dtype(jd).name

    def f(xv, wv, gv):
        out, vjp = jax.vjp(lambda a, b: jfp8._fp8_dot(
            name, name, a, b, jnp.float32(sx), jnp.float32(sw)), xv, wv)
        return (out,) + vjp(gv)

    # one compiled program (op by op compiles every primitive)
    jout, jgx, jgw = jax.jit(f)(jx, jw, jnp.asarray(g).astype(jd)
                                .astype(jnp.float32))
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    out, ax, aw = tfp8._Fp8Dot.apply(tx, tw, torch.tensor(sx),
                                     torch.tensor(sw))
    assert out.dtype == td and not ax.requires_grad
    out.backward(torch.from_numpy(g).to(td))
    assert tx.grad.dtype == td and tw.grad.dtype == td
    assert jgx.dtype == jd and jgw.dtype == jd
    assert float(ax) == float(jnp.max(jnp.abs(jx.astype(jnp.float32))))
    assert float(aw) == float(jnp.max(jnp.abs(jw.astype(jnp.float32))))
    half_ulp = (lambda v: np.abs(v) * 2.0 ** -8) if dtype == "bfloat16" \
        else (lambda v: 0.0)
    qx = np.asarray(jfp8._quantize(jx, sx, jnp.float8_e4m3fn, 448.0),
                    np.float32)
    qw = np.asarray(jfp8._quantize(jw, sw, jnp.float8_e4m3fn, 448.0),
                    np.float32)
    want = np.asarray(jout, np.float32)
    np.testing.assert_array_less(
        np.abs(out.detach().float().numpy() - want),
        _sum_bound(qx, qw, sx, sw) + half_ulp(want) + 1e-30)
    # the backward: the same e5m2 gradient on both sides
    gd = np.asarray(jnp.asarray(g).astype(jd).astype(jnp.float32))
    ga = np.abs(gd).max()
    sg = np.float32(max(ga, 1e-12) / np.float32(jfp8.E5M2_MAX))
    qg = np.asarray(jfp8._quantize(jnp.asarray(gd), jnp.float32(sg),
                                   jnp.float8_e5m2, jfp8.E5M2_MAX),
                    np.float32)
    # (both sides round to the primals' dtype: up to one ulp apart)
    for got, jwant, bound in (
            (tx.grad, jgx, _sum_bound(qg, qw.T, sg, sw)),
            (tw.grad, jgw, _sum_bound(qx.T, qg, sx, sg))):
        jwant = np.asarray(jwant, np.float32)
        np.testing.assert_array_less(
            np.abs(got.float().numpy() - jwant),
            bound + 2 * half_ulp(jwant) + 1e-30)


def test_fp8_autocast_collects_sites_in_call_order():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(4, 8).astype(np.float32))
    w1 = torch.from_numpy(rng.randn(8, 8).astype(np.float32))
    w2 = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    with tfp8.fp8_autocast(None) as ctx:
        assert tfp8.active() and tfp8.current() is ctx
        y = tfp8.fp8_linear_value(x, w1, None)
        tfp8.fp8_linear_value(y, w2, None)
    assert sorted(ctx.new_state) == [
        "linear0/w", "linear0/x", "linear1/w", "linear1/x"]
    assert ctx.weight_bytes_saved == (8 * 8 + 8 * 4) * 3  # fp32 weights
    assert not tfp8.active()
    assert float(ctx.new_state["linear0/x"][0]) == float(x.abs().max())


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_amp_cast_levels_match_jax_hook(level):
    """``auto_cast`` at every level casts as JAX's ``_amp_hook`` (which
    records the level and never reads it); ``use_promote`` is taken."""
    ops = ("linear", "matmul", "flash_attention", "cross_entropy",
           "softmax", "fused_rms_norm", "swiglu")
    ins = {"float32": (jnp.ones((2,), jnp.float32), torch.ones(2)),
           "bfloat16": (jnp.ones((2,), jnp.bfloat16),
                        torch.ones(2, dtype=torch.bfloat16))}
    for enable in (True, False):
        with jac.auto_cast(enable, level=level, use_promote=False), \
                auto_cast(enable, level=level, use_promote=False):
            for op in ops:
                for dn, (jv, tv) in ins.items():
                    want = jnp.dtype(jac._amp_hook(op, [jv])[0].dtype).name
                    got = str(amp_cast(op, tv).dtype).replace("torch.", "")
                    assert got == want, (level, enable, op, dn)


# ------------------------------------------------------- train-step level
def _nets(seed=11):
    paddle.seed(seed)
    jnet = JLlama(JConfig(**CFG))
    arrays = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=1)
    load_numpy_state(tnet, arrays)
    return jnet, tnet, arrays


def _batches():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 64, (2, 17)).astype(np.int32)
            for _ in range(STEPS + 1)]


def _tstep(tnet):
    opt = topt.AdamW(1e-3, parameters=tnet.named_parameters())
    return CompiledTrainStep(
        tnet, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt,
        amp_level="O3")


def _tcall(step, ids):
    ids = torch.from_numpy(ids).long()
    loss, _ = step([ids[:, :-1]], [ids[:, 1:]])
    return float(loss)


@pytest.fixture(scope="module")
def jax_o3():
    """The JAX trainer's O3 run (3 steps), shared by the tests that need
    it: the losses, the histories after each step, the bytes saved and
    the StepMeter gauge."""
    jnet, _, arrays = _nets()
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=jnet.parameters())
    step = JStep(jnet, lambda lo, lb: jloss(lo, lb).mean(), opt,
                 amp_level="O3")
    meter = JMeter()
    jset_meter(meter)
    losses, hists = [], []
    for ids in _batches()[:STEPS]:
        loss, _ = step([Tensor(jnp.asarray(ids[:, :-1]))],
                       [Tensor(jnp.asarray(ids[:, 1:]))])
        losses.append(float(np.asarray(loss.value)))
        hists.append(step.fp8_state_dict())
    return dict(arrays=arrays, losses=losses, hists=hists,
                saved=step._fp8_bytes_saved,
                gauge=meter.fp8_bytes_saved.value())


def test_fp8_model_loss_grads_and_amaxes_match_jax_at_fp32():
    from paddle_tpu.core import tape

    jnet, tnet, _ = _nets()
    ids = _batches()[0]
    params = {k: p.value for k, p in jnet.named_parameters()}

    def f(params):
        jnet.load_functional_state(params)
        with tape.trace_scope(), tape.no_grad(), \
                jfp8.fp8_autocast(None) as ctx:
            logits = jnet(Tensor(jnp.asarray(ids[:, :-1])))
            loss = jloss(logits, Tensor(jnp.asarray(ids[:, 1:]))).mean()
        return loss.value, ctx.new_state

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    jnet.load_functional_state(params)
    with tfp8.fp8_autocast(None) as ctx:
        loss = causal_lm_loss(tnet(torch.from_numpy(ids[:, :-1]).long()),
                              torch.from_numpy(ids[:, 1:]).long()).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert sorted(ctx.new_state) == sorted(jstate)
    for k, v in ctx.new_state.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k]),
                                   rtol=1e-6, err_msg=k)
    for k, p in tnet.named_parameters():
        want = np.asarray(jgrads[k])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


def test_o3_trainer_matches_jax(jax_o3):
    _, tnet, _ = _nets()
    step = _tstep(tnet)
    meter = tobs.StepMeter()
    tobs.set_step_meter(meter)
    losses = []
    for i, ids in enumerate(_batches()[:STEPS]):
        losses.append(_tcall(step, ids))
        got, want = step.fp8_state_dict(), jax_o3["hists"][i]
        assert sorted(got) == sorted(want) and len(got) == 26
        for k in want:
            np.testing.assert_allclose(got[k], want[k],
                                       rtol=2.0 ** (-7 if i == 0 else -3),
                                       atol=0, err_msg=k)
            assert (got[k] > 0).sum() == i + 1, k
    step.flush_telemetry()
    np.testing.assert_allclose(losses, jax_o3["losses"], rtol=2e-3)
    assert step._fp8_bytes_saved == jax_o3["saved"] > 0
    assert meter.fp8_bytes_saved.value() == jax_o3["gauge"] \
        == jax_o3["saved"]
    # nothing but the histories: device tensors of [16] fp32
    assert all(v.dtype == torch.float32 and tuple(v.shape) == (16,)
               for v in step._fp8_state.values())


def test_o3_state_survives_checkpoint_resume(tmp_path):
    """``fp8_state_dict`` -> the checkpoint's ``"fp8"`` extra state ->
    ``load_fp8_state``: a trainer resumed after step 2 repeats the
    uninterrupted step 3 bit for bit."""
    from paddle_tpu_torch.checkpoint import (CheckpointManager,
                                             CheckpointPolicy)

    batches = _batches()
    _, tnet, arrays = _nets()
    step = _tstep(tnet)
    mgr = step.attach_checkpoint(CheckpointManager(
        str(tmp_path), policy=CheckpointPolicy(save_every_steps=2,
                                               keep_last_k=2)))
    ref = [_tcall(step, ids) for ids in batches[:STEPS]]
    mgr.close()
    ref_state = step.fp8_state_dict()
    ref_params = numpy_state(tnet)

    tnet2 = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=5)
    load_numpy_state(tnet2, arrays)
    step2 = _tstep(tnet2)
    mgr2 = step2.attach_checkpoint(CheckpointManager(
        str(tmp_path), policy=CheckpointPolicy(save_every_steps=100)))
    assert mgr2.restore_or_init().step == 2
    assert sorted(step2.fp8_state_dict()) == sorted(ref_state)
    assert _tcall(step2, batches[2]) == ref[2]
    mgr2.close()
    for k, v in step2.fp8_state_dict().items():
        np.testing.assert_array_equal(v, ref_state[k], err_msg=k)
    got = numpy_state(tnet2)
    for k, v in ref_params.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_sentinel_skip_restores_histories():
    """A skipped step (the loss made NaN through the chaos seam) leaves
    the histories as they were before it, as it leaves the weights."""
    from paddle_tpu_torch import chaos, training
    from paddle_tpu_torch.observability import MetricsRegistry

    batches = _batches()
    _, tnet, _ = _nets()
    step = _tstep(tnet)
    step.attach_sentinel(training.AnomalySentinel(
        training.SentinelPolicy(nan_action="skip"), sync=True,
        registry=MetricsRegistry()))
    _tcall(step, batches[0])
    before = step.fp8_state_dict()
    with chaos.chaos() as m:
        m.on("train.loss", lambda value=None, **_: float("nan"), times=1)
        _tcall(step, batches[1])
    after = step.fp8_state_dict()
    assert sorted(after) == sorted(before)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_sentinel_skip_of_first_step_restores_empty_histories():
    """A skipped first O3 step leaves no histories behind: the snapshot
    was taken before any existed, so the next step starts from empty
    ones (scale 1) and repeats a fresh trainer's first step bit for bit,
    as JAX's snapshot of the discovered empty histories does."""
    from paddle_tpu_torch import chaos, training
    from paddle_tpu_torch.observability import MetricsRegistry

    batches = _batches()
    _, tnet, arrays = _nets()
    step = _tstep(tnet)
    step.attach_sentinel(training.AnomalySentinel(
        training.SentinelPolicy(nan_action="skip"), sync=True,
        registry=MetricsRegistry()))
    with chaos.chaos() as m:
        m.on("train.loss", lambda value=None, **_: float("nan"), times=1)
        _tcall(step, batches[0])
    assert step.fp8_state_dict() == {}
    got = _tcall(step, batches[1])

    tnet2 = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=5)
    load_numpy_state(tnet2, arrays)
    fresh = _tstep(tnet2)
    assert got == _tcall(fresh, batches[1])
    want = fresh.fp8_state_dict()
    assert sorted(step.fp8_state_dict()) == sorted(want)
    for k, v in step.fp8_state_dict().items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
        assert (v > 0).sum() == 1, k
