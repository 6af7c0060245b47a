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
    with pytest.raises(ValueError):
        with auto_cast(True, level="O3"):
            pass


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

    loss, grads = jax.value_and_grad(f)(params)
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
@pytest.mark.parametrize("kind", ["cosine", "warmup_cosine"])
def test_schedulers_match_jax(kind):
    """``CosineAnnealingDecay`` alone and wrapped in ``LinearWarmup`` (the
    inner scheduler steps only once warm-up is over) give the JAX
    package's rate at every epoch."""
    def build(lr_mod):
        cos = lr_mod.CosineAnnealingDecay(3e-3, T_max=6, eta_min=1e-4)
        if kind == "cosine":
            return cos
        return lr_mod.LinearWarmup(cos, 4, 1e-5, 3e-3)

    jsched, tsched = build(paddle.optimizer.lr), build(topt.lr)
    for epoch in range(12):
        assert tsched.last_lr == jsched.last_lr, epoch
        jsched.step()
        tsched.step()


# --------------------------------------------------------- trajectory
def _trajectory(jnet, tnet, amp_level, steps=5):
    ids, labels = _batch(seed=3)
    jsched = paddle.optimizer.lr.LinearWarmup(2e-3, 3, 1e-4, 2e-3)
    tsched = topt.LinearWarmup(2e-3, 3, 1e-4, 2e-3)
    jopt = paddle.optimizer.AdamW(
        jsched, parameters=jnet.parameters(), weight_decay=0.01,
        grad_clip=paddle.optimizer.ClipGradByGlobalNorm(1.0))
    tclip = topt.ClipGradByGlobalNorm(1.0)
    topt_ = topt.AdamW(tsched, parameters=tnet.named_parameters(),
                       weight_decay=0.01, grad_clip=tclip)
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


def test_trajectory_fp32_matches_jax_trainer():
    jnet, tnet = _pair("gqa", seed=5)
    jl, tl = _trajectory(jnet, tnet, None)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    want = {k: np.asarray(p.value) for k, p in jnet.named_parameters()}
    got = numpy_state(tnet)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_trajectory_o1_matches_jax_trainer():
    jnet, tnet = _pair("mha", seed=6)
    jl, tl = _trajectory(jnet, tnet, "O1")
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


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
    assert "model.norm.weight__moment1" in sd
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
