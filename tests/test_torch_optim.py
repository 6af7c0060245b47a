"""The port's optimizer layer (paddle_tpu_torch) against the JAX package's.

Inputs are made from a numpy seed and handed to both sides; on the CPU the
port's multi-tensor functions (``kernels/fused_adam.py``) run their plain
versions, which the card's kernels equal bit for bit (``mt_adam``,
``mt_momentum``) or within a stated bound (``mt_sumsq``, ``mt_lamb``: sums
in another order; ``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Tolerances (every case runs 3 steps):

- fp32 parameters and moments: within 1e-6 of the entry plus 1e-6 of the
  largest entry. XLA's CPU code contracts a multiply and an add into one
  FMA (``0.9 * v + g`` in ``_momentum_update`` equals the single rounding
  of the fused product-sum, not the two roundings of the port, checked on
  100,000 values), so each step may round one ulp apart, and where ``mu *
  v + g`` cancels, the ulps of the large terms show on a small entry; the
  port takes numpy's fp32 ``1 - beta ** t``, XLA's ``pow`` may round it
  one ulp apart; Lamb's norms are sums in another order;
- bf16 parameters: within one bf16 ulp of the value, at most 2^-7 of it
  (two fp32 values a few ulps apart may round to neighbouring bf16
  values);
- the clips' outputs and the norms: 1e-6 relative (fp32 sums of squares
  in another order); the clip by value exactly;
- the eager optimizers against the JAX eager optimizers: as above;
- the loss scaler's state (scale, good and bad counts, ``_found_inf``,
  ``_step_count``): exactly, in the eager scaler and in the train step
  (``tests/test_torch_train.py``);
- the schedulers: exactly, at every epoch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Parameter, Tensor  # noqa: E402
from paddle_tpu.kernels.fused_adam import fused_adam_update as j_fused  # noqa
from paddle_tpu.optimizer import optimizer as jopt_mod  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.amp import GradScaler  # noqa: E402
from paddle_tpu_torch.incubate.optimizer import fused_adam_update  # noqa
from paddle_tpu_torch.kernels import fused_adam as fa  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

SHAPES = ((1,), (7,), (1023,), (64, 33))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
RTOL32 = ATOL32 = 1e-6
BF16_REL = 2.0 ** -7


def _arrays(seed, shapes=SHAPES, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if isinstance(x, Tensor):
        x = x.value
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype="float32", err=""):
    got, want = _np(got), _np(want)
    if dtype == "bfloat16":
        bad = np.abs(got - want) > BF16_REL * np.abs(want)
        assert not bad.any(), (err, got[bad][:5], want[bad][:5])
    else:
        atol = ATOL32 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=RTOL32, atol=atol,
                                   err_msg=err)


def _pair(arrays, dtype):
    """Each array on both sides, in copies (a donated JAX buffer may alias
    the numpy array it came from)."""
    jd, td = DTYPES[dtype]
    return ([jnp.array(a, copy=True).astype(jd) for a in arrays],
            [torch.tensor(a).to(td) for a in arrays])


# ------------------------------------------- the multi-tensor functions
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_adam_update_matches_jax(dtype, decoupled, wd):
    """``fused_adam_update`` on odd shapes, 3 steps, against JAX's."""
    jp, tp = _pair(_arrays(0), dtype)
    jm = [jnp.zeros(a.shape, jnp.float32) for a in jp]
    jv = [jnp.zeros(a.shape, jnp.float32) for a in jp]
    tm = [torch.zeros(a.shape) for a in tp]
    tv = [torch.zeros(a.shape) for a in tp]
    for t in range(1, 4):
        jg, tg = _pair(_arrays(10 + t), dtype)
        jp, jm, jv = j_fused(jp, jm, jv, jg, jnp.float32(1e-2),
                             jnp.float32(0.9), jnp.float32(0.999),
                             jnp.float32(1e-8), jnp.float32(t), decoupled,
                             jnp.float32(wd))
        fused_adam_update(tp, tm, tv, tg, 1e-2, 0.9, 0.999, 1e-8, t,
                          decoupled, wd)
    for i in range(len(SHAPES)):
        _close(tp[i], jp[i], dtype, f"p{i}")
        _close(tm[i], jm[i], err=f"m{i}")
        _close(tv[i], jv[i], err=f"v{i}")


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_momentum_update_matches_jax(dtype, kind):
    jp, tp = _pair(_arrays(1), dtype)
    jvel = [jnp.zeros(a.shape, jnp.float32) for a in jp]
    tvel = None if kind == "sgd" else [torch.zeros(a.shape) for a in tp]
    for t in range(3):
        jg, tg = _pair(_arrays(20 + t), dtype)
        for i in range(len(jp)):
            if kind == "sgd":
                jp[i] = jopt_mod._sgd_update(jp[i], jg[i], jnp.float32(0.1))
            else:
                jp[i], jvel[i] = jopt_mod._momentum_update(
                    jp[i], jvel[i], jg[i], jnp.float32(0.1),
                    jnp.float32(0.9), kind == "nesterov")
        fa.momentum_update(tp, tvel, tg, 0.1, 0.9, kind == "nesterov")
    for i in range(len(SHAPES)):
        _close(tp[i], jp[i], dtype, f"p{i}")
        if tvel is not None:
            _close(tvel[i], jvel[i], err=f"velocity{i}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lamb_update_matches_jax(dtype):
    jp, tp = _pair(_arrays(2), dtype)
    jm = [jnp.zeros(a.shape, jnp.float32) for a in jp]
    jv = [jnp.zeros(a.shape, jnp.float32) for a in jp]
    tm = [torch.zeros(a.shape) for a in tp]
    tv = [torch.zeros(a.shape) for a in tp]
    for t in range(1, 4):
        jg, tg = _pair(_arrays(30 + t), dtype)
        for i in range(len(jp)):
            jp[i], jm[i], jv[i] = jopt_mod._lamb_update(
                jp[i], jm[i], jv[i], jg[i], jnp.float32(1e-2),
                jnp.float32(0.9), jnp.float32(0.999), jnp.float32(1e-6),
                jnp.float32(t), jnp.float32(0.01))
        fa.lamb_update(tp, tm, tv, tg, 1e-2, 0.9, 0.999, 1e-6, t, 0.01)
    for i in range(len(SHAPES)):
        _close(tp[i], jp[i], dtype, f"p{i}")
        _close(tm[i], jm[i], err=f"m{i}")
        _close(tv[i], jv[i], err=f"v{i}")


def _clip_pairs(seed, need_clip=(True, False, True, True)):
    arrays = _arrays(seed, scale=0.3)
    jpg, tpg = [], []
    for i, (a, nc) in enumerate(zip(arrays, need_clip)):
        jp = Parameter(jnp.zeros(a.shape), name=f"w{i}")
        jp.need_clip = nc
        tp = torch.zeros(a.shape)
        tp.need_clip = nc
        jpg.append((jp, Tensor(jnp.asarray(a))))
        tpg.append((tp, torch.from_numpy(a)))
    return jpg, tpg


@pytest.mark.parametrize("clip", ["global", "norm", "value"])
def test_clips_match_jax(clip):
    """Each clip called on ``(param, grad)`` pairs (one with ``need_clip``
    False), and ``clip_grad_norm_``, against JAX's; the sums of squares
    and the per-tensor norms of ``grad_sumsq`` against numpy in fp64."""
    make = {"global": lambda m: m.ClipGradByGlobalNorm(1.5),
            "norm": lambda m: m.ClipGradByNorm(1.0),
            "value": lambda m: m.ClipGradByValue(0.2, -0.1)}[clip]
    jpg, tpg = _clip_pairs(3)
    want = make(paddle.optimizer)(jpg)
    got = make(topt)(tpg)
    for (_, g), (_, w) in zip(got, want):
        if clip == "value":
            np.testing.assert_array_equal(_np(g), _np(w))
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=0)
    grads = [g for _, g in tpg]
    stats = fa.grad_sumsq(grads, clip_norm=1.5)
    sq = [float(np.sum(np.square(_np(g).astype(np.float64)))) for g in grads]
    np.testing.assert_allclose(_np(stats.sq), sq, rtol=1e-6)
    np.testing.assert_allclose(float(stats.total), sum(sq), rtol=1e-6)
    assert stats.finite()
    if clip == "global":
        from paddle_tpu.optimizer.clip import clip_grad_norm_ as jclip_

        jps = [p for p, _ in jpg]
        for p, (_, g) in zip(jps, jpg):
            p.grad = g
        tps = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        for p, g in zip(tps, grads):
            p.grad = g.clone()
        jn, tn = jclip_(jps, 1.5), topt.clip_grad_norm_(tps, 1.5)
        np.testing.assert_allclose(float(tn), _np(jn), rtol=1e-6)
        for p, jp in zip(tps, jps):
            np.testing.assert_allclose(_np(p.grad), _np(jp.grad), rtol=1e-6)


def test_grad_sumsq_unscales_and_flags_nonfinite():
    g = [torch.tensor([1.0, 2.0, 3.0]), torch.tensor([4.0, float("inf")])]
    inv = torch.tensor([0.5])
    st = fa.grad_sumsq(g, inv=inv, clip_norm=1.0, skip_nonfinite=True)
    assert float(st.sq[0]) == 0.25 + 1.0 + 2.25
    assert float(st.nonfinite) == 1.0 and float(st.skip) == 1.0
    assert not st.finite()
    # a skipped update writes nothing
    p = [torch.ones(3), torch.ones(2)]
    m = [torch.zeros(3), torch.zeros(2)]
    v = [torch.zeros(3), torch.zeros(2)]
    pro = fa.Prologue(inv, fa.CLIP_GLOBAL, st, skip=True)
    fa.fused_adam_update(p, m, v, g, 0.1, 0.9, 0.999, 1e-8, 1, True, 0.1,
                         prologue=pro)
    assert all(torch.equal(x, torch.ones_like(x)) for x in p)
    assert all(not x.any() for x in m + v)


# ---------------------------------------------- the eager optimizers
def _eager_case(name):
    """(builder(module, params, clip_module) -> optimizer, clip factory,
    parameter regularizer / groups)."""
    cases = {
        "sgd_l2_global": (lambda m, ps: m.SGD(
            0.1, parameters=ps, weight_decay=m_l2(m)(0.01),
            grad_clip=m.ClipGradByGlobalNorm(1.0))),
        "sgd_l1_value": (lambda m, ps: m.SGD(
            0.1, parameters=ps, weight_decay=m_l1(m)(0.01),
            grad_clip=m.ClipGradByValue(0.5))),
        "momentum_l2_norm": (lambda m, ps: m.Momentum(
            0.1, 0.9, parameters=ps, weight_decay=0.02,
            grad_clip=m.ClipGradByNorm(0.5))),
        "nesterov_l1_global": (lambda m, ps: m.Momentum(
            0.1, 0.9, parameters=ps, use_nesterov=True,
            weight_decay=m_l1(m)(0.01),
            grad_clip=m.ClipGradByGlobalNorm(1.0))),
        "adam_l2_global": (lambda m, ps: m.Adam(
            1e-2, parameters=ps, weight_decay=m_l2(m)(0.01),
            grad_clip=m.ClipGradByGlobalNorm(1.0))),
        "adam_l1_value": (lambda m, ps: m.Adam(
            1e-2, parameters=ps, weight_decay=m_l1(m)(0.01),
            grad_clip=m.ClipGradByValue(0.5))),
        "adamw_groups_norm": (lambda m, ps: m.AdamW(
            1e-2, parameters=_groups(m, ps), weight_decay=0.05,
            apply_decay_param_fun=lambda n: n != "w2",
            grad_clip=m.ClipGradByNorm(0.5))),
        "adamw_multi_groups_norm": (lambda m, ps: m.AdamW(
            1e-2, parameters=_groups(m, ps), weight_decay=0.05,
            apply_decay_param_fun=lambda n: n != "w2",
            grad_clip=m.ClipGradByNorm(0.5), use_multi_tensor=True)),
        "adam_multi_l1_global": (lambda m, ps: m.Adam(
            1e-2, parameters=[{"params": ps[:2], "learning_rate": 0.5},
                              {"params": ps[2:],
                               "weight_decay": m_l1(m)(0.01)}],
            grad_clip=m.ClipGradByGlobalNorm(1.0), use_multi_tensor=True)),
        "lamb_global": (lambda m, ps: m.Lamb(
            1e-2, parameters=ps, grad_clip=m.ClipGradByGlobalNorm(1.0))),
        "lamb_exclude": (lambda m, ps: m.Lamb(
            1e-2, 0.05, parameters=ps,
            exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1)),
    }
    return cases[name]


def m_l1(m):
    return m.L1Decay if m is topt else paddle.regularizer.L1Decay


def m_l2(m):
    return m.L2Decay if m is topt else paddle.regularizer.L2Decay


def _groups(m, ps):
    return [{"params": ps[:2]},
            {"params": ps[2:], "weight_decay": m_l2(m)(0.2),
             "learning_rate": 0.5}]


@pytest.mark.parametrize("case", [
    "sgd_l2_global", "sgd_l1_value", "momentum_l2_norm",
    "nesterov_l1_global", "adam_l2_global", "adam_l1_value",
    "adamw_groups_norm", "adamw_multi_groups_norm", "adam_multi_l1_global",
    "lamb_global", "lamb_exclude"])
def test_eager_optimizer_matches_jax(case):
    """``opt.step()`` three times on gradients set by hand (one
    parameter with ``need_clip`` False, one with ``requires_grad`` False /
    ``stop_gradient``, which is skipped) against the JAX eager
    optimizer."""
    build = _eager_case(case)
    arrays = _arrays(4, shapes=((5, 3), (7,), (4, 4), (6,), (3,)))
    jps = [Parameter(jnp.asarray(a), name=f"w{i}")
           for i, a in enumerate(arrays)]
    tps = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    jps[1].need_clip = False
    tps[1].need_clip = False
    jps[4].stop_gradient = True
    tps[4].requires_grad_(False)
    jo = build(paddle.optimizer, jps)
    to = build(topt, [(f"w{i}", p) for i, p in enumerate(tps)])
    for step in range(3):
        grads = _arrays(40 + step, shapes=[a.shape for a in arrays],
                        scale=0.5)
        for jp, tp, g in zip(jps, tps, grads):
            jp.grad = Tensor(jnp.asarray(g))
            tp.grad = torch.from_numpy(g)
        jo.step()
        to.step()
    assert to._step_count == jo._step_count == 3
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        _close(tp, jp, err=f"w{i}")


def test_eager_grad_scaler_matches_jax():
    """The eager scaler's unscale, skip and scale update on gradients set
    by hand, one step with an inf, against JAX's."""
    from paddle_tpu.amp import GradScaler as JScaler

    arrays = _arrays(5, shapes=((4,), (3, 2)))
    jps = [Parameter(jnp.asarray(a), name=f"w{i}")
           for i, a in enumerate(arrays)]
    tps = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    jo = paddle.optimizer.SGD(0.1, parameters=jps)
    to = topt.SGD(0.1, parameters=tps)
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    js, ts = JScaler(**kw), GradScaler(**kw)
    assert float(ts.scale(torch.tensor(2.0))) == 2048.0
    for step in range(5):
        grads = _arrays(50 + step, shapes=[a.shape for a in arrays])
        if step == 1:
            grads[1][0, 1] = np.inf
        for jp, tp, g in zip(jps, tps, grads):
            jp.grad = Tensor(jnp.asarray(g * js._scale))
            tp.grad = torch.from_numpy(g * ts._scale)
        js.minimize(jo, None)
        ts.minimize(to, None)
        assert ts._found_inf == js._found_inf == (step == 1)
        assert ts.state_dict() == js.state_dict()
        for jp, tp in zip(jps, tps):
            _close(tp, jp)
    assert to._step_count == jo._step_count == 4
