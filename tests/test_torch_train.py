"""The port's training path (paddle_tpu_torch) against the JAX package's.

Inputs are made from a numpy seed and handed to both sides; the JAX
Pallas kernels run as the JAX package's own CPU tests run them
(``rms_norm_fused`` and ``rope_fused`` in interpret mode,
``flash_attention_fwd`` through its CPU path ``_composed``). On the CPU
the port's wrappers run their plain versions; the kernels' backward
passes are held against ``jax.vjp`` in ``tests/test_torch_kernels.py``.
Tolerances:

- Tiny Llama at fp32 (2 layers, hidden 64, MHA and GQA): the mean
  ``causal_lm_loss`` within 1e-5 relative and every parameter gradient
  within 2e-5 absolute + 1e-4 relative (two layers of fp32 math in
  other orders, as ``tests/test_torch_llama.py`` holds the logits).
- Five AdamW steps (weight decay 0.01, global-norm clip 1.0, linear
  warmup) against the JAX ``CompiledTrainStep``: at fp32 every loss
  within 1e-5 relative and every parameter within 1e-5 absolute after
  step 5 (measured: 2.6e-6 and 1.6e-6; Adam divides each gradient by
  its own root mean square, so an fp32 difference in a small gradient
  moves its parameter by more than the gradient moved); at O1 bf16
  every loss within 1e-3 relative (measured 1.6e-4: the two frameworks
  round the bf16 products at other places, and the JAX composed bf16
  attention rounds scores and P).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core import tape  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.jit.trainer import CompiledTrainStep as JStep  # noqa: E402
from paddle_tpu.kernels import flash_attention as jfa  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import causal_lm_loss as jloss  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state, numpy_state  # noqa
from paddle_tpu_torch.jit import CompiledTrainStep  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.models import causal_lm_loss  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CFG = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)
VARIANTS = {"mha": None, "gqa": 2}


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def test_sdpa_unmasked_routes_by_device():
    """On the CPU, unmasked attention stays composed (as the JAX package
    does on the CPU); the flash kernel is the CUDA route."""
    rng = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rng.randn(1, 5, 2, 16).astype(np.float32))
               for _ in range(3))
    got = TF.scaled_dot_product_attention(q, k, v, is_causal=True)
    want = tfa.flash_attention(q, k, v, causal=True)
    _close(got, want, 1e-5, 1e-6)


# ------------------------------------------------------ loss and AMP
def test_cross_entropy_matches_jax():
    from paddle_tpu.nn import functional as JF

    rng = np.random.RandomState(14)
    logits = rng.randn(7, 11).astype(np.float32)
    lbl = rng.randint(0, 11, (7,)).astype(np.int64)
    lbl[2] = -100
    for red in ("none", "mean", "sum"):
        want = JF.cross_entropy(Tensor(jnp.asarray(logits)),
                                Tensor(jnp.asarray(lbl)), reduction=red)
        got = TF.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(lbl), reduction=red)
        _close(got, want.value, 1e-6, 1e-6)
    lbl[2] = 3  # [N, 1] labels with another ignore_index
    got = TF.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(lbl[:, None]), ignore_index=3)
    want = JF.cross_entropy(Tensor(jnp.asarray(logits)),
                            Tensor(jnp.asarray(lbl[:, None])),
                            ignore_index=3)
    _close(got, want.value, 1e-6, 1e-6)


def test_auto_cast_places_casts_like_jax():
    from paddle_tpu_torch.amp import amp_cast, auto_cast

    x32 = torch.ones(2, 2)
    x16 = torch.ones(2, 2, dtype=torch.bfloat16)
    with auto_cast(True, level="O1"):
        assert amp_cast("linear", x32).dtype == torch.bfloat16
        assert amp_cast("cross_entropy", x16).dtype == torch.float32
        assert amp_cast("fused_rms_norm", x32).dtype == torch.float32
        assert amp_cast("swiglu", x16).dtype == torch.bfloat16
        with auto_cast(False):
            assert amp_cast("linear", x32).dtype == torch.float32
    assert amp_cast("linear", x32).dtype == torch.float32
    # every level casts as O1, as JAX's hook (it records the level and
    # never reads it): O3 included, O0 with enable too
    for level in ("O0", "O3"):
        with auto_cast(True, level=level, use_promote=True):
            assert amp_cast("linear", x32).dtype == torch.bfloat16
            assert amp_cast("cross_entropy", x16).dtype == torch.float32


# ------------------------------------------------------- the tiny Llama
def _pair(variant, seed=11):
    kw = dict(CFG, num_key_value_heads=VARIANTS[variant])
    paddle.seed(seed)
    jnet = JLlama(JConfig(**kw))
    arrays = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    tnet = LlamaForCausalLM(LlamaConfig(**kw), device="cpu", seed=1)
    load_numpy_state(tnet, arrays)
    return jnet, tnet


def _batch(b=2, s=16, seed=0):
    ids = np.random.RandomState(seed).randint(0, CFG["vocab_size"],
                                              (b, s + 1)).astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


def _jax_loss_and_grads(jnet, ids, labels):
    params = {k: p.value for k, p in jnet.named_parameters()}

    def f(params):
        jnet.load_functional_state(params)
        with tape.trace_scope(), tape.no_grad():
            logits = jnet(Tensor(jnp.asarray(ids)))
            return jloss(logits, Tensor(jnp.asarray(labels))).mean().value

    # one compiled program (op-by-op dispatch compiles every primitive
    # of the model and its backward at first use, several times slower)
    loss, grads = jax.jit(jax.value_and_grad(f))(params)
    jnet.load_functional_state(params)
    return loss, grads


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tiny_llama_loss_and_every_grad_match_jax(variant):
    jnet, tnet = _pair(variant)
    ids, labels = _batch()
    want_loss, want_grads = _jax_loss_and_grads(jnet, ids, labels)
    logits = tnet(torch.from_numpy(ids).long())
    loss = causal_lm_loss(logits, torch.from_numpy(labels).long()).mean()
    loss.backward()
    _close(loss, want_loss, 1e-5, 0)
    got = dict(tnet.named_parameters())
    assert set(got) == set(want_grads)
    for k, p in got.items():
        assert p.grad is not None, k
        _close(p.grad, want_grads[k], 1e-4, 2e-5)


def test_flops_per_token_matches_jax():
    jnet, tnet = _pair("gqa")
    assert tnet.flops_per_token(16) == jnet.flops_per_token(16)


# --------------------------------------------------------- schedulers
SCHEDULERS = {
    "cosine": lambda m: m.CosineAnnealingDecay(3e-3, T_max=6, eta_min=1e-4),
    "warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(3e-3, T_max=6, eta_min=1e-4), 4, 1e-5, 3e-3),
    "warmup_float": lambda m: m.LinearWarmup(0.1, 4, 0.0, 0.1),
    "noam": lambda m: m.NoamDecay(64, 4, learning_rate=0.5),
    "piecewise": lambda m: m.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, 0.3),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, 0.5),
    "polynomial": lambda m: m.PolynomialDecay(0.1, 5, 1e-3, 2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.1, 4, cycle=True),
    "exponential": lambda m: m.ExponentialDecay(0.1, 0.8),
    "multistep": lambda m: m.MultiStepDecay(0.1, [2, 5], 0.5),
    "step": lambda m: m.StepDecay(0.1, 3, 0.5),
    "lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.9 ** e),
    "multiplicative": lambda m: m.MultiplicativeDecay(0.1, lambda e: 0.95),
    "warm_restarts": lambda m: m.CosineAnnealingWarmRestarts(0.1, 3, 2),
    "one_cycle": lambda m: m.OneCycleLR(0.1, 10),
    "one_cycle_linear": lambda m: m.OneCycleLR(
        0.1, 10, anneal_strategy="linear", phase_pct=0.4),
    "cyclic_triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, 2, 3, mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, 3, mode="exp_range", exp_gamma=0.9),
    "reduce_on_plateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=1, cooldown=1, min_lr=1e-3),
}
PLATEAU_LOSSES = (3.0, 2.0, 2.5, 2.4, 2.6, 1.0, 1.5, 1.6, 1.7, 1.8, 1.9,
                  None)


@pytest.mark.parametrize("kind", sorted(SCHEDULERS))
def test_schedulers_match_jax(kind):
    """Every JAX scheduler (``lr.py:47-342``; ``LinearWarmup`` around a
    float and around ``CosineAnnealingDecay``, whose inner scheduler steps
    only once warm-up is over) gives the JAX package's rate at every epoch
    (``ReduceOnPlateau`` fed a metric, then none), and the same state."""
    jsched, tsched = (SCHEDULERS[kind](m)
                      for m in (paddle.optimizer.lr, topt.lr))
    for epoch in range(12):
        assert tsched.last_lr == jsched.last_lr, epoch
        assert tsched() == jsched()
        if kind == "reduce_on_plateau":
            loss = PLATEAU_LOSSES[epoch]
            jsched.step(loss)
            tsched.step(None if loss is None else torch.tensor(loss))
        else:
            jsched.step()
            tsched.step()
    assert tsched.last_epoch == jsched.last_epoch
    assert tsched.state_dict() == jsched.state_dict()


# --------------------------------------------------------- trajectory
def _params(m, named):
    """What each package's optimizer takes: the port ``(name, tensor)``
    pairs, JAX the parameters (whose names its optimizer reads)."""
    return named if m is topt else [p for _, p in named]


def _l2(m):
    return topt.L2Decay if m is topt else paddle.regularizer.L2Decay


def _mlp_group(m, named):
    """The MLP weights in a group with an ``L2Decay`` and half the rate;
    the rest at the optimizer's decay."""
    mlp = [x for x in named if ".mlp." in x[0]]
    rest = [x for x in named if ".mlp." not in x[0]]
    return [{"params": _params(m, rest)},
            {"params": _params(m, mlp), "weight_decay": _l2(m)(0.05),
             "learning_rate": 0.5}]


# the train step's optimizer, clip and decay cases: (rate scale,
# builder(module, named parameters, scheduler))
TRAJECTORY_CASES = {
    "adamw_global": (1.0, lambda m, named, sched: m.AdamW(
        sched, parameters=_params(m, named), weight_decay=0.01,
        grad_clip=m.ClipGradByGlobalNorm(1.0))),
    "sgd": (100.0, lambda m, named, sched: m.SGD(
        sched, parameters=_params(m, named))),
    "nesterov_l2": (50.0, lambda m, named, sched: m.Momentum(
        sched, 0.9, parameters=_params(m, named), use_nesterov=True,
        weight_decay=1e-3)),
    "lamb_global": (1.0, lambda m, named, sched: m.Lamb(
        sched, 0.01, parameters=_params(m, named),
        grad_clip=m.ClipGradByGlobalNorm(1.0))),
    # no coupled decay here: g + wd * p cancels in a few entries, where
    # XLA's CPU FMA and the port's two roundings differ by an ulp of the
    # larger term, which Adam's normalisation then amplifies (measured
    # 1.47e-5 on 3 of 86,336 parameters after five steps, the rest within
    # 5.7e-7); tests/test_torch_optim.py holds the coupled decay
    "adam_norm": (1.0, lambda m, named, sched: m.Adam(
        sched, parameters=_params(m, named),
        grad_clip=m.ClipGradByNorm(0.5))),
    "adamw_value_l2_group": (1.0, lambda m, named, sched: m.AdamW(
        sched, parameters=_mlp_group(m, named), weight_decay=0.01,
        grad_clip=m.ClipGradByValue(0.05))),
}


def _trajectory(jnet, tnet, amp_level, steps=5, case="adamw_global"):
    rate, build = TRAJECTORY_CASES[case]
    ids, labels = _batch(seed=3)
    jsched, tsched = (m.LinearWarmup(2e-3 * rate, 3, 1e-4 * rate,
                                     2e-3 * rate)
                      for m in (paddle.optimizer.lr, topt.lr))
    jopt = build(paddle.optimizer, list(jnet.named_parameters()), jsched)
    topt_ = build(topt, list(tnet.named_parameters()), tsched)
    jstep = JStep(jnet, lambda lo, lb: jloss(lo, lb).mean(), jopt,
                  amp_level=amp_level)
    tstep = CompiledTrainStep(
        tnet, lambda lo, lb: causal_lm_loss(lo, lb).mean(), topt_,
        amp_level=amp_level)
    jl, tl = [], []
    for _ in range(steps):
        loss, _ = jstep([Tensor(jnp.asarray(ids))],
                        [Tensor(jnp.asarray(labels))])
        jl.append(float(np.asarray(loss.value)))
        loss, _ = tstep([torch.from_numpy(ids).long()],
                        [torch.from_numpy(labels).long()])
        tl.append(float(loss))
        jsched.step()
        tsched.step()
    return np.array(jl), np.array(tl)


def _params_close(jnet, tnet, atol):
    want = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    got = numpy_state(tnet)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def test_trajectory_fp32_matches_jax_trainer():
    jnet, tnet = _pair("gqa", seed=5)
    jl, tl = _trajectory(jnet, tnet, None)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    _params_close(jnet, tnet, 1e-5)


@pytest.mark.parametrize("case", sorted(set(TRAJECTORY_CASES)
                                        - {"adamw_global"}))
def test_trajectory_optimizers_match_jax_trainer(case):
    """Five fp32 steps of each other optimizer, clip and decay case of the
    train step against the JAX ``CompiledTrainStep``, at the fp32 test's
    tolerances."""
    jnet, tnet = _pair("gqa", seed=5)
    jl, tl = _trajectory(jnet, tnet, None, case=case)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    _params_close(jnet, tnet, 1e-5)


def test_trajectory_o1_matches_jax_trainer():
    jnet, tnet = _pair("mha", seed=6)
    jl, tl = _trajectory(jnet, tnet, "O1")
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


# the scaler case: its first step overflows (a summed loss, so that the
# logits' gradient is about the scale itself; 2^127 times an lm_head
# gradient entry above 2 is past fp32's largest value), then the scale
# falls by 2^-20 and grows by 2 after every 2 good steps; chip_smoke.py's
# 7B scaler case takes the same values
SCALER_KW = dict(init_loss_scaling=2.0 ** 127, decr_ratio=2.0 ** -20,
                 incr_every_n_steps=2, decr_every_n_nan_or_inf=1)


def _scaler_state(scaler, opt):
    return (scaler._scale, scaler._good_steps, scaler._bad_steps,
            scaler._found_inf, opt._step_count)


def test_scaler_state_matches_jax_trainer():
    """AdamW under bf16 O1 with a ``GradScaler`` in the step: after every
    step the loss scale, the good and bad counts, ``_found_inf`` and the
    optimizer's step count equal the JAX trainer's exactly; the first
    step overflows and leaves every parameter and moment as it was; the
    losses hold within the O1 test's 1e-3."""
    from paddle_tpu_torch.amp import GradScaler

    jnet, tnet = _pair("mha", seed=6)
    ids, labels = _batch(seed=3)
    jopt = paddle.optimizer.AdamW(
        2e-3, parameters=jnet.parameters(), weight_decay=0.01,
        grad_clip=paddle.optimizer.ClipGradByGlobalNorm(1.0))
    topt_ = topt.AdamW(2e-3, parameters=tnet.named_parameters(),
                       weight_decay=0.01,
                       grad_clip=topt.ClipGradByGlobalNorm(1.0))
    js, ts = paddle.amp.GradScaler(**SCALER_KW), GradScaler(**SCALER_KW)
    jstep = JStep(jnet, lambda lo, lb: jloss(lo, lb).sum(), jopt,
                  amp_level="O1", scaler=js)
    tstep = CompiledTrainStep(
        tnet, lambda lo, lb: causal_lm_loss(lo, lb).sum(), topt_,
        amp_level="O1", scaler=ts)
    before = numpy_state(tnet)
    for step in range(5):
        jl, _ = jstep([Tensor(jnp.asarray(ids))],
                      [Tensor(jnp.asarray(labels))])
        tl, _ = tstep([torch.from_numpy(ids).long()],
                      [torch.from_numpy(labels).long()])
        assert _scaler_state(ts, topt_) == _scaler_state(js, jopt), step
        np.testing.assert_allclose(float(tl), float(np.asarray(jl.value)),
                                   rtol=1e-3)
        if step == 0:
            assert ts._found_inf and topt_._step_count == 0
            after = numpy_state(tnet)
            assert all(np.array_equal(after[k], v)
                       for k, v in before.items())
            assert not any(a.any() for a in topt_._accumulators.values())
    assert ts._scale == 2.0 ** 109 and topt_._step_count == 4


def test_trainer_refuses_l1_decay_layout_policy_and_takes_no_scaler():
    """L1 decay is refused at the first step with the JAX trainer's
    message; a layout policy is refused naming its queue item; a disabled
    scaler is no scaler."""
    from paddle_tpu_torch.amp import GradScaler

    jnet, tnet = _pair("mha", seed=7)
    ids, labels = _batch(s=8)
    jopt = paddle.optimizer.SGD(
        0.1, parameters=jnet.parameters(),
        weight_decay=paddle.regularizer.L1Decay(0.01))
    tsgd = topt.SGD(0.1, parameters=tnet.named_parameters(),
                    weight_decay=topt.L1Decay(0.01))
    jstep = JStep(jnet, lambda lo, lb: jloss(lo, lb).mean(), jopt)
    tstep = CompiledTrainStep(
        tnet, lambda lo, lb: causal_lm_loss(lo, lb).mean(), tsgd)
    msg = "does not support L1Decay"
    with pytest.raises(NotImplementedError, match=msg):
        jstep([Tensor(jnp.asarray(ids))], [Tensor(jnp.asarray(labels))])
    with pytest.raises(NotImplementedError, match=msg):
        tstep([torch.from_numpy(ids).long()],
              [torch.from_numpy(labels).long()])
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        CompiledTrainStep(tnet, None, tsgd, layout_policy="tp-pp-dp")
    step = CompiledTrainStep(tnet, None, tsgd,
                             scaler=GradScaler(enable=False))
    assert step.scaler is None


def test_eager_step_equals_train_step():
    """``loss.backward(); opt.step()`` updates as the train step does
    (the same clip and update functions)."""
    ids, labels = (torch.from_numpy(a).long() for a in _batch(s=8, seed=4))
    nets, opts = [], []
    for _ in range(2):
        net = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=3)
        nets.append(net)
        opts.append(topt.AdamW(1e-3, parameters=net.named_parameters(),
                               grad_clip=topt.ClipGradByGlobalNorm(0.5)))
    loss = causal_lm_loss(nets[0](ids), labels).mean()
    loss.backward()
    opts[0].step()
    opts[0].clear_grad()
    step = CompiledTrainStep(
        nets[1], lambda lo, lb: causal_lm_loss(lo, lb).mean(), opts[1])
    loss1, _ = step([ids], [labels])
    assert float(loss1) == float(loss.detach())
    assert all(p.grad is None for p in nets[0].parameters())
    for (k, a), (_, b) in zip(nets[0].named_parameters(),
                              nets[1].named_parameters()):
        assert torch.equal(a, b), k


def test_trainer_refuses_unported_optimizer_and_state_round_trips():
    tnet = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=2)

    class Lamb(topt.Optimizer):
        pass

    with pytest.raises(NotImplementedError, match="Lamb"):
        CompiledTrainStep(tnet, None, Lamb(parameters=tnet.parameters()))
    opt = topt.AdamW(1e-3, parameters=tnet.named_parameters(),
                     apply_decay_param_fun=lambda n: "norm" not in n)
    assert opt.decay_of(opt._param_groups[0],
                        tnet.model.norm.weight) == 0.0
    step = CompiledTrainStep(
        tnet, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt)
    ids, labels = _batch(s=8)
    step([torch.from_numpy(ids).long()], [torch.from_numpy(labels).long()])
    sd = opt.state_dict()
    assert sd["@step_count"] == 1
    # the reference's keys: ``param_<i>``, i the parameter's index
    names = [n for n, _ in tnet.named_parameters()]
    assert f"param_{names.index('model.norm.weight')}__moment1" in sd
    opt2 = topt.AdamW(1e-3, parameters=tnet.named_parameters())
    opt2.set_state_dict(sd)
    assert opt2._step_count == 1
    assert torch.equal(opt2._acc(tnet.lm_head.weight, "moment2"),
                       opt._acc(tnet.lm_head.weight, "moment2"))


# ------------------------------------------- entry points need a device
def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from paddle_tpu_torch.convert import state_dict_from_numpy
    from paddle_tpu_torch.models.generation import alloc_kv_caches
    from paddle_tpu_torch.serving.kv_pool import KVCachePool
    from paddle_tpu_torch.serving.paged_pool import PagedKVPool

    cfg = LlamaConfig(**CFG)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        alloc_kv_caches(cfg, 1, 8, "float32")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        KVCachePool(cfg)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        PagedKVPool(cfg, num_pages=4)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        state_dict_from_numpy({"w": np.zeros(2, np.float32)})
