"""fp16 training in the port (paddle_tpu_torch) against the JAX package.

On the CPU every kernel wrapper runs its plain version, so these hold the
fp16 plain versions (what the card's fp16 kernels are compared with by
``chip_smoke.py``) against the JAX kernels run in fp16 as the JAX
package's own tests run them (Pallas in interpret mode, jax's stock flash
kernel in TPU interpret mode, ``jax.vjp`` for the backward), and the fp16
training paths against JAX's. Inputs are made from a numpy seed.
Tolerances:

- RMSNorm and rope, forward and backward: one fp16 ulp (2^-10 relative:
  both sides compute in fp32 and round once; the fp32 rstd may differ in
  its last bit and flip one rounding); RMSNorm ``dw`` 2^-9 of its largest
  entry (fp32 sums over the rows in another order before the cast), as
  the bf16 test's 2^-6 is two bf16 ulps.
- Flash attention's plain forward and backward against the stock Pallas
  flash kernel in fp16: 2^-8 of the largest entry (the stock kernel
  rounds the unnormalised P of each block, the plain version the
  normalised P: each rounding moves an entry by 2^-11 of it, summed over
  the keys; the bf16 test's 1e-2 is the same bound at 8 bits).
- The O1 fp16 ``CompiledTrainStep`` with a ``GradScaler`` against JAX's
  for five steps: every loss within the O1 test's 1e-3 relative; the
  scale, the good and bad counts, ``_found_inf`` and the step count
  exactly equal after every step (the first step overflows in fp16 on
  both sides).
- Three eager ``amp.decorate(level="O2", dtype="float16")`` steps with
  the eager scaler against JAX's step over the same decorated net:
  losses within 1e-3 relative, scaler state exactly equal, the
  parameters fp16 and the Adam moments fp32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.jit.trainer import CompiledTrainStep as JStep  # noqa: E402
from paddle_tpu.kernels import rope as jrope  # noqa: E402
from paddle_tpu.kernels.rms_norm import rms_norm_fused  # noqa: E402
from paddle_tpu.models import causal_lm_loss as jloss  # noqa: E402
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state, numpy_state  # noqa
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.jit import CompiledTrainStep  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.kernels import rms_norm as trms  # noqa: E402
from paddle_tpu_torch.kernels import rope as trope  # noqa: E402
from paddle_tpu_torch.models import causal_lm_loss  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)
from test_torch_train import _batch, _pair  # noqa: E402

F16_ULP = 2.0 ** -10


def _both(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jnp.float16), \
        torch.from_numpy(a).to(torch.float16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol, atol=1e-6):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _jit_vjp(fn, args, g):
    """``fn(*args)`` and its VJP at ``g``, as one compiled program (the
    op-by-op dispatch compiles every primitive at each new shape, several
    times slower on the CPU)."""
    def both(args, g):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(g)

    return jax.jit(both)(args, g)


def _stock_flash(arrays, causal):
    """jax's stock Pallas flash attention in fp16, forward and
    ``jax.vjp``, in TPU interpret mode with every block 128 (as
    ``test_torch_kernels._stock_flash`` runs it in bf16); [B, S, H, D]
    numpy in and out."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu import flash_attention as stock

    blocks = stock.BlockSizes(
        block_q=128, block_k_major=128, block_k=128, block_b=1,
        block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128,
        block_q_dkv=128, block_k_major_dq=128, block_k_dq=128,
        block_q_dq=128)
    q, k, v, g = (_both(a)[0].transpose(0, 2, 1, 3) for a in arrays)
    scale = 1.0 / np.sqrt(arrays[0].shape[-1])
    @jax.jit  # one compiled program (op-by-op is several times slower)
    def forward_and_vjp(q, k, v, g):
        o, vjp = jax.vjp(lambda q, k, v: stock.flash_attention(
            q, k, v, causal=causal, sm_scale=scale, block_sizes=blocks),
            q, k, v)
        return o, vjp(g)

    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        o, grads = forward_and_vjp(q, k, v, g)
    return [_np(x).transpose(0, 2, 1, 3) for x in (o, *grads)]


# --------------------------------------------------------------- kernels
def test_rms_norm_fp16_forward_and_backward_match_pallas():
    rng = np.random.RandomState(30)
    xj, xt = _both(rng.randn(2, 5, 128))
    wj, wt = _both(1 + 0.1 * rng.randn(128))
    gj, gt = _both(rng.randn(2, 5, 128))
    want, (want_dx, want_dw) = _jit_vjp(
        lambda x, w: rms_norm_fused(x, w, 1e-5), (xj, wj), gj)
    xg = xt.clone().requires_grad_(True)
    wg = wt.clone().requires_grad_(True)
    y = trms.rms_norm(xg, wg, 1e-5)
    y.backward(gt)
    assert y.dtype == torch.float16 and xg.grad.dtype == torch.float16
    _close(y, want, F16_ULP)
    _close(xg.grad, want_dx, F16_ULP)
    np.testing.assert_allclose(
        _np(wg.grad), _np(want_dw), rtol=0,
        atol=2.0 ** -9 * float(np.abs(_np(want_dw)).max()))


def test_rope_fp16_forward_and_backward_match_pallas():
    rng = np.random.RandomState(31)
    b, s, h, kh, d = 2, 6, 4, 2, 16
    qj, qt = _both(rng.randn(b, s, h, d))
    kj, kt = _both(rng.randn(b, s, kh, d))
    gqj, gqt = _both(rng.randn(b, s, h, d))
    gkj, gkt = _both(rng.randn(b, s, kh, d))
    cj, sj = jrope.build_rope_cache(s, d)
    ct, st = trope.build_rope_cache(s, d)
    wq, (gq,) = _jit_vjp(lambda x: jrope.rope_fused(x, cj, sj), (qj,), gqj)
    wk, (gk,) = _jit_vjp(lambda x: jrope.rope_fused(x, cj, sj), (kj,), gkj)
    qg = qt.clone().requires_grad_(True)
    kg = kt.clone().requires_grad_(True)
    qo, ko = trope.rope_fused(qg, kg, ct, st)
    assert qo.dtype == torch.float16
    torch.autograd.backward([qo, ko], [gqt, gkt])
    _close(qo, wq, F16_ULP)
    _close(ko, wk, F16_ULP)
    _close(qg.grad, gq, F16_ULP)
    _close(kg.grad, gk, F16_ULP)


def test_flash_fp16_plain_matches_stock_pallas_kernel():
    """The fp16 plain forward and backward (what the fp16 tensor-core
    kernels are held to on the card) against jax's stock Pallas flash
    kernel in fp16, causal: within 2^-8 of each output's largest entry."""
    rng = np.random.RandomState(32)
    b, s, h, d = 1, 128, 2, 64
    qn, kn, vn, gn = (rng.randn(b, s, h, d).astype(np.float32)
                      for _ in range(4))
    want = _stock_flash((qn, kn, vn, gn), True)
    q, k, v, g = (_both(a)[1] for a in (qn, kn, vn, gn))
    o, lse = tfa.flash_attention_reference(q, k, v, True)
    grads = tfa.flash_attention_backward_reference(q, k, v, o, lse, g, True)
    assert o.dtype == torch.float16 and all(
        x.dtype == torch.float16 for x in grads)
    for name, x, w in zip(("o", "dq", "dk", "dv"), [o, *grads], want):
        top = np.abs(w).max()
        err = np.abs(_np(x) - w).max()
        assert err <= 2.0 ** -8 * top, (name, err / top)


def test_fp16_rounding_slack_and_refusals():
    """fp16's slack is fp16's ulp plus its subnormal flush (zero for
    fp32); the kernels fp16 does not reach yet raise a TypeError naming
    ROADMAP.md queue B."""
    rng = np.random.RandomState(33)
    q, k, v = (torch.from_numpy(rng.randn(1, 8, 2, 16).astype(np.float32))
               for _ in range(3))
    _, lse = tfa.flash_attention_reference(q, k, v, True)
    s32 = tfa.probability_rounding_slack(q, k, v, lse, causal=True)
    q16, k16, v16 = (t.half() for t in (q, k, v))
    s16 = tfa.probability_rounding_slack(q16, k16, v16, lse, causal=True)
    assert float(s32.abs().max()) == 0.0
    assert 0.0 < float(s16.max()) < 2.0 ** -9 * float(v.abs().sum(1).max())
    for backward, dim, cc in ((True, 256, False), (True, 160, False),
                              (False, 128, True)):
        with pytest.raises(TypeError, match="queue B, fp16 item 3"):
            tfa._check_fp16(torch.float16, dim, backward, cc)
    tfa._check_fp16(torch.float16, 256, False, False)
    tfa._check_fp16(torch.float16, 128, True, False)
    assert _build.DTYPE_CODES[torch.float16] == 3
    assert torch.float16 in _build.FLOAT_TYPES


# ------------------------------------------------------ training paths
# the first step overflows in fp16 (the logits' gradient is 2^24 / 32 =
# 2^19 times a probability, past fp16's 65504) and the scale falls to
# 2^12; no step grows it again
SCALER16 = dict(init_loss_scaling=2.0 ** 24, decr_ratio=2.0 ** -12,
                decr_every_n_nan_or_inf=1)


def _state(scaler, opt):
    return (scaler._scale, scaler._good_steps, scaler._bad_steps,
            scaler._found_inf, opt._step_count)


def test_fp16_o1_trajectory_and_scaler_state_match_jax_trainer():
    jnet, tnet = _pair("mha", seed=6)
    ids, labels = _batch(seed=3)
    jopt = paddle.optimizer.AdamW(
        2e-3, parameters=jnet.parameters(), weight_decay=0.01,
        grad_clip=paddle.optimizer.ClipGradByGlobalNorm(1.0))
    topt_ = topt.AdamW(2e-3, parameters=tnet.named_parameters(),
                       weight_decay=0.01,
                       grad_clip=topt.ClipGradByGlobalNorm(1.0))
    js = paddle.amp.GradScaler(**SCALER16)
    ts = tamp.GradScaler(**SCALER16)
    jstep = JStep(jnet, lambda lo, lb: jloss(lo, lb).mean(), jopt,
                  amp_level="O1", amp_dtype="float16", scaler=js)
    tstep = CompiledTrainStep(
        tnet, lambda lo, lb: causal_lm_loss(lo, lb).mean(), topt_,
        amp_level="O1", amp_dtype="float16", scaler=ts)
    jl, tl = [], []
    for step in range(5):
        loss, _ = jstep([Tensor(jnp.asarray(ids))],
                        [Tensor(jnp.asarray(labels))])
        jl.append(float(np.asarray(loss.value)))
        loss, _ = tstep([torch.from_numpy(ids).long()],
                        [torch.from_numpy(labels).long()])
        tl.append(float(loss))
        assert _state(ts, topt_) == _state(js, jopt), step
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert _state(ts, topt_) == (2.0 ** 12, 4, 0, False, 4)
    assert tl[-1] < tl[1]


def test_fp16_decorate_o2_eager_steps_match_jax():
    """The README's eager O2 path (``decorate``, then ``scaler.scale(loss)
    .backward()``, ``scaler.step(opt)``, ``scaler.update()``) for three
    steps against JAX's step over the same decorated net (its compiled
    O2 step: JAX's eager tape cannot differentiate through the O2 cast of
    a black-listed op's fp16 input, and the step's cast is the port's
    ``logits.float()``: every other op of the net runs in fp16 on both
    sides)."""
    jnet, tnet = _pair("mha", seed=8)
    ids, labels = _batch(seed=4)
    jopt = paddle.optimizer.AdamW(
        2e-3, parameters=jnet.parameters(), weight_decay=0.01,
        grad_clip=paddle.optimizer.ClipGradByGlobalNorm(1.0))
    topt_ = topt.AdamW(2e-3, parameters=tnet.named_parameters(),
                       weight_decay=0.01,
                       grad_clip=topt.ClipGradByGlobalNorm(1.0))
    jnet, jopt = paddle.amp.decorate(jnet, jopt, level="O2",
                                     dtype="float16")
    tnet, topt_ = tamp.decorate(tnet, topt_, level="O2", dtype="float16")
    assert {p.dtype for p in tnet.parameters()} == {torch.float16}
    # the decorated JAX net's fp16 arrays cross through convert unchanged
    arrays = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    assert {str(a.dtype) for a in arrays.values()} == {"float16"}
    load_numpy_state(tnet, arrays)
    got = numpy_state(tnet)
    assert all(np.array_equal(got[k], a.astype(np.float32))
               for k, a in arrays.items())
    js = paddle.amp.GradScaler(init_loss_scaling=1024.0)
    ts = tamp.GradScaler(init_loss_scaling=1024.0)
    jstep = JStep(jnet, lambda lo, lb: jloss(lo, lb).mean(), jopt,
                  amp_level="O2", amp_dtype="float16", scaler=js)
    tl = []
    for step in range(3):
        loss, _ = jstep([Tensor(jnp.asarray(ids))],
                        [Tensor(jnp.asarray(labels))])
        want = float(np.asarray(loss.value))
        logits = tnet(torch.from_numpy(ids).long()).float()
        loss = causal_lm_loss(logits, torch.from_numpy(labels).long()).mean()
        ts.scale(loss).backward()
        ts.step(topt_)
        ts.update()
        topt_.clear_grad()
        tl.append(float(loss.detach()))
        np.testing.assert_allclose(tl[-1], want, rtol=1e-3)
        assert _state(ts, topt_) == _state(js, jopt), step
    assert tl[-1] < tl[0]
    assert {p.dtype for p in tnet.parameters()} == {torch.float16}
    assert {a.dtype for a in topt_._accumulators.values()} == {
        torch.float32}
    want = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    for k, p in tnet.named_parameters():
        assert str(want[k].dtype) == "float16", k
