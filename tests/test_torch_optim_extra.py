"""The eager-only optimizers and the incubate wrappers of the port
(``paddle_tpu_torch.optimizer``: Adagrad, RMSProp, Adadelta, Adamax, NAdam,
RAdam, ASGD, Rprop, LBFGS; ``incubate.optimizer``: LookAhead,
ModelAverage) against the JAX package's, on the CPU.

Gradients are set by hand from a numpy seed on both sides and each
optimizer steps five times. Tolerances as ``tests/test_torch_optim.py``
states them for fp32 (within 1e-6 of the entry plus 1e-6 of the largest
entry: XLA's CPU code contracts a multiply and an add into one FMA where
the port rounds twice, and its ``pow`` may round one ulp from numpy's);
LBFGS within 1e-5 of the largest entry (its directions are dot products
over the flat vector, summed in another order, then fed back through five
iterations). ``state_dict()`` keys are JAX's exactly, and a JAX state
loaded into a fresh port optimizer continues the same trajectory.

Also the chip script's CPU rehearsal of its eager-optimizer phase
(``chip_smoke.eager_optimizer_phase`` on a tiny Llama): every optimizer
steps, every single-parameter card-vs-CPU check holds (here CPU against
CPU), LBFGS lowers the loss.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Parameter, Tensor  # noqa: E402
from paddle_tpu.incubate import optimizer as jinc  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.incubate import optimizer as tinc  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((5, 3), (7,))
STEPS = 5


def _arrays(seed, shapes=SHAPES, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if isinstance(x, Tensor):
        x = x.value
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, err="", rel=1e-6):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=err)


def _params(arrays):
    """The same parameters on both sides, unnamed: the state keys are
    ``param_<i>__<accumulator>`` on both."""
    return ([Parameter(jnp.array(a, copy=True)) for a in arrays],
            [torch.from_numpy(a.copy()).requires_grad_() for a in arrays])


def _l1(m):
    return m.L1Decay if m is topt else paddle.regularizer.L1Decay


def _l2(m):
    return m.L2Decay if m is topt else paddle.regularizer.L2Decay


# name -> builder(module, params): each optimizer with a decay or clip
# where it takes one, so the eager step's clip and decay paths run too
CASES = {
    "adagrad": lambda m, ps: m.Adagrad(
        0.1, parameters=ps, weight_decay=0.01,
        initial_accumulator_value=0.1,
        grad_clip=m.ClipGradByGlobalNorm(1.0)),
    "rmsprop_centered": lambda m, ps: m.RMSProp(
        0.01, parameters=ps, momentum=0.9, centered=True,
        weight_decay=_l1(m)(0.01)),
    "rmsprop": lambda m, ps: m.RMSProp(0.01, rho=0.9, parameters=ps),
    "adadelta": lambda m, ps: m.Adadelta(
        1.0, parameters=ps, grad_clip=m.ClipGradByValue(0.5)),
    "adamax": lambda m, ps: m.Adamax(
        0.02, parameters=ps, weight_decay=_l2(m)(0.02)),
    "nadam": lambda m, ps: m.NAdam(
        0.02, parameters=ps, grad_clip=m.ClipGradByNorm(1.0)),
    "radam": lambda m, ps: m.RAdam(0.02, parameters=ps, weight_decay=0.01),
    "asgd": lambda m, ps: m.ASGD(0.05, t0=2, parameters=ps),
    "rprop": lambda m, ps: m.Rprop(0.01, parameters=ps),
}


def _grads(step, arrays):
    return _arrays(50 + step, shapes=[a.shape for a in arrays], scale=0.5)


def _run(jo, to, jps, tps, arrays, steps=STEPS, first=0):
    for step in range(first, first + steps):
        for jp, tp, g in zip(jps, tps, _grads(step, arrays)):
            jp.grad = Tensor(jnp.asarray(g))
            tp.grad = torch.from_numpy(g)
        jo.step()
        to.step()


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_optimizer_matches_jax(case):
    """Five steps against the JAX optimizer; ``state_dict`` keys equal to
    JAX's, every accumulator close; JAX's state loaded into a fresh port
    optimizer after three steps continues to JAX's parameters."""
    arrays = _arrays(7)
    jps, tps = _params(arrays)
    jo, to = CASES[case](paddle.optimizer, jps), CASES[case](topt, tps)
    _run(jo, to, jps, tps, arrays, steps=3)
    # a fresh port optimizer from JAX's state (through numpy) and the
    # parameters as JAX has them continues JAX's trajectory
    jsd = jo.state_dict()
    _, tps2 = _params([_np(p) for p in jps])
    to2 = CASES[case](topt, tps2)
    to2.set_state_dict({k: (v if k in ("@step_count",) else _np(v))
                        for k, v in jsd.items()})
    if hasattr(jo, "_t"):
        to2._t = jo._t
    _run(jo, to, jps, tps, arrays, steps=STEPS - 3, first=3)
    for step in range(3, STEPS):
        for tp, g in zip(tps2, _grads(step, arrays)):
            tp.grad = torch.from_numpy(g)
        to2.step()
    assert to._step_count == jo._step_count == STEPS
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert set(tsd) == set(jsd)
    for k in jsd:
        if k != "@step_count":
            _close(tsd[k], jsd[k], err=k)
    for i, (jp, tp, tp2) in enumerate(zip(jps, tps, tps2)):
        _close(tp, jp, err=f"w{i}")
        _close(tp2, jp, err=f"w{i} from JAX's state")


def test_asgd_averaged_params_match_jax():
    arrays = _arrays(8)
    jps, tps = _params(arrays)
    jo, to = CASES["asgd"](paddle.optimizer, jps), CASES["asgd"](topt, tps)
    _run(jo, to, jps, tps, arrays)
    javg, tavg = jo.averaged_params(), to.averaged_params()
    for jp, tp in zip(jps, tps):
        _close(tavg[id(tp)], javg[id(jp)])


def _lstsq(module):
    """A least-squares problem on both sides: ``|A x - b|^2``."""
    rng = np.random.RandomState(9)
    a = rng.randn(12, 4).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    return a, b


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(line_search):
    a, b = _lstsq(None)
    x0 = np.zeros(4, np.float32)
    jx = Parameter(jnp.asarray(x0), name="x")
    tx = torch.from_numpy(x0.copy()).requires_grad_()
    kw = dict(max_iter=4, history_size=3, line_search_fn=line_search)
    lr = 1.0 if line_search else 0.02
    jo = paddle.optimizer.LBFGS(lr, parameters=[jx], **kw)
    to = topt.LBFGS(lr, parameters=[tx], **kw)
    ja, jb = Tensor(jnp.asarray(a)), Tensor(jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def jclosure():
        loss = ((paddle.matmul(ja, jx) - jb) ** 2).sum()
        loss.backward()
        return loss

    def tclosure():
        loss = ((ta @ tx - tb) ** 2).sum()
        loss.backward()
        return loss

    for _ in range(2):
        jl = jo.step(jclosure)
        tl = to.step(tclosure)
        _close(tx, jx, rel=1e-5)
        np.testing.assert_allclose(float(tl.detach()),
                                   float(np.asarray(jl.value)), rtol=1e-5)
    assert to._evals == jo._evals and len(to._s) == len(jo._s)
    with pytest.raises(ValueError, match="closure"):
        to.step()


def test_lookahead_matches_jax():
    arrays = _arrays(10)
    jps, tps = _params(arrays)
    jo = jinc.LookAhead(paddle.optimizer.Adam(0.05, parameters=jps),
                        alpha=0.5, k=2)
    to = tinc.LookAhead(topt.Adam(0.05, parameters=tps), alpha=0.5, k=2)
    _run(jo, to, jps, tps, arrays)
    for jp, tp in zip(jps, tps):
        _close(tp, jp)
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert set(tsd) == set(jsd) and tsd["lookahead_step"] == STEPS
    for js, ts in zip(jsd["lookahead_slow"], tsd["lookahead_slow"]):
        _close(ts, js)


def test_model_average_apply_and_restore_match_jax():
    arrays = _arrays(11)
    jps, tps = _params(arrays)
    jo = paddle.optimizer.SGD(0.1, parameters=jps)
    to = topt.SGD(0.1, parameters=tps)
    javg = jinc.ModelAverage(parameters=jps)
    tavg = tinc.ModelAverage(parameters=[(f"w{i}", p)
                                         for i, p in enumerate(tps)])
    for step in range(3):
        _run(jo, to, jps, tps, arrays, steps=1, first=step)
        javg.step()
        tavg.step()
    trained = [tp.detach().clone() for tp in tps]
    with tavg.apply(), javg.apply():
        for jp, tp in zip(jps, tps):
            _close(tp, jp)
        with pytest.raises(RuntimeError, match="twice"):
            tavg.apply()
    for tp, t0 in zip(tps, trained):
        assert torch.equal(tp.detach(), t0)
    tavg.apply(need_restore=False)
    tavg.restore()
    for tp, t0 in zip(tps, trained):
        assert torch.equal(tp.detach(), t0)


def test_compiled_step_refuses_eager_optimizers_with_jax_message():
    from paddle_tpu.jit.trainer import CompiledTrainStep as JStep
    from paddle_tpu_torch.jit import CompiledTrainStep

    jnet, tnet = paddle.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    for name in ("Adagrad", "RMSProp", "NAdam", "LBFGS"):
        with pytest.raises(NotImplementedError) as want:
            JStep(jnet, None, getattr(paddle.optimizer, name)(
                0.1, parameters=jnet.parameters()))
        with pytest.raises(NotImplementedError) as got:
            CompiledTrainStep(tnet, None, getattr(topt, name)(
                0.1, parameters=list(tnet.parameters())))
        assert str(got.value) == str(want.value)
        assert "use the eager path" in str(got.value)


def test_chip_eager_optimizer_phase_rehearsal():
    """``chip_smoke.eager_optimizer_phase`` on a tiny Llama on the CPU:
    every optimizer steps with finite losses, the nine single-parameter
    checks hold, the model average restores bit for bit, LBFGS lowers the
    loss (its gates would fail the script)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(num_hidden_layers=1, hidden_size=32,
                           intermediate_size=64, vocab_size=64)
    net = LlamaForCausalLM(cfg, device="cpu", seed=0)
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 64, (2, 9)))
    counts = chip_smoke.eager_optimizer_phase(
        torch, np, net, ids[:, :-1].contiguous(), ids[:, 1:].contiguous(),
        "cpu", lbfgs_cfg=cfg)
    assert not any(counts.values())  # the plain versions launch nothing
