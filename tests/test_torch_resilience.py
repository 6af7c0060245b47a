"""The port's resilient training runtime (``paddle_tpu_torch/training/
resilience.py`` and the seams of ``jit/trainer.py``) against the JAX
package's, under one loss script and one injected clock.

- the policy ladder (skip, its budget escalating to rollback, rollback,
  abort without a manager, a loss spike): the same script through the
  JAX and the port trainers (a bias-free ``Linear``, AdamW, fp32) gives
  the same summaries, anomaly series and actions, and losses within 1e-5
  relative (``test_torch_train.py``'s fp32 tolerance: AdamW at 0.05
  moves the two frameworks' fp32 roundings apart by up to 3e-6); the
  sentinel's classify and spike rules on one value script;
- a tiny fp32 Llama (2 layers, hidden 64) with a NaN injected through
  ``train.loss`` at step 3 skips exactly that batch: the port's healthy
  losses and parameters equal a port run that never took batch 3 bit
  for bit, and JAX's sentinel run within ``test_torch_train.py``'s
  tolerances (losses 1e-5 relative, parameters 1e-5 absolute);
- rollback-and-replay through ``run_resilient`` with a
  ``CheckpointManager`` repeats the uninterrupted port run bit for bit,
  and a late detection quarantines the poisoned generations;
- the watchdog: one fire a wedge, ``note_blocked`` time excluded, peer
  heartbeat staleness once an episode, each against JAX's watchdog under
  the same ``ChaosClock``; the trainer feeds it and the StepMeter's
  blocked listener reaches it.
"""
import glob
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import chaos as jchaos  # noqa: E402
from paddle_tpu import training as jtraining  # noqa: E402
from paddle_tpu.checkpoint import CheckpointManager as JManager  # noqa
from paddle_tpu.checkpoint import CheckpointPolicy as JPolicy  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.jit.trainer import CompiledTrainStep as JStep  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import causal_lm_loss as jloss  # noqa: E402
from paddle_tpu.observability import FlightRecorder as JRecorder  # noqa
from paddle_tpu.observability import MetricsRegistry as JRegistry  # noqa
from paddle_tpu_torch import chaos as tchaos  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch import training as ttraining  # noqa: E402
from paddle_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from paddle_tpu_torch.checkpoint import CheckpointPolicy  # noqa: E402
from paddle_tpu_torch.checkpoint import commit as tcommit  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state, numpy_state  # noqa
from paddle_tpu_torch.jit import CompiledTrainStep  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.models import causal_lm_loss  # noqa: E402
from paddle_tpu_torch.nn import Linear  # noqa: E402
from paddle_tpu_torch.observability import (  # noqa: E402
    FlightRecorder,
    MetricsRegistry,
    StepMeter,
    set_step_meter,
)
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

RNG = np.random.RandomState(0)
LIN = {s: (RNG.randn(8, 4).astype(np.float32),
           RNG.randn(8, 4).astype(np.float32)) for s in range(1, 10)}
W0 = RNG.randn(4, 4).astype(np.float32) * 0.5
CFG = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
IDS = {s: np.random.RandomState(100 + s).randint(
    0, CFG["vocab_size"], (2, 17)).astype(np.int32) for s in range(1, 10)}
PKGS = {"jax": (jtraining, jchaos), "port": (ttraining, tchaos)}


# ------------------------------------------------------------- trainers
def _linear(pkg):
    """A bias-free 4 x 4 Linear from W0, AdamW at 0.05, the mean squared
    error: ``(net, opt, trainer, batch_fn)``."""
    if pkg == "jax":
        import paddle_tpu.nn as jnn

        net = jnn.Linear(4, 4, bias_attr=False)
        net.weight.value = jnp.asarray(W0)
        opt = paddle.optimizer.AdamW(learning_rate=0.05,
                                     parameters=net.parameters())
        trainer = JStep(net, lambda o, y: ((o - y) ** 2).mean(), opt)

        def batch_fn(step):
            x, y = LIN[step]
            return [Tensor(jnp.asarray(x))], [Tensor(jnp.asarray(y))]
    else:
        net = Linear(4, 4, device="cpu")
        with torch.no_grad():
            net.weight.copy_(torch.from_numpy(W0))
        opt = topt.AdamW(0.05, parameters=net.named_parameters())
        trainer = CompiledTrainStep(net, lambda o, y: ((o - y) ** 2).mean(),
                                    opt)

        def batch_fn(step):
            x, y = LIN[step]
            return [torch.from_numpy(x)], [torch.from_numpy(y)]
    return net, opt, trainer, batch_fn


_INIT = {}


def _llama(pkg):
    """The tiny fp32 GQA Llama (the JAX model's weights carried into the
    port's by ``convert.py``), AdamW 1e-3 with weight decay 0.01:
    ``(net, opt, trainer, batch_fn)``."""
    if pkg == "jax" or "arrays" not in _INIT:
        paddle.seed(7)
        jnet = JLlama(JConfig(**CFG))
        _INIT.setdefault("arrays", {k: np.asarray(p.value)
                                    for k, p in jnet.named_parameters()})
    if pkg == "jax":
        opt = paddle.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                     parameters=jnet.parameters())
        trainer = JStep(jnet, lambda lo, lb: jloss(lo, lb).mean(), opt)

        def batch_fn(step):
            ids = IDS[step]
            return ([Tensor(jnp.asarray(ids[:, :-1]))],
                    [Tensor(jnp.asarray(ids[:, 1:]))])
        return jnet, opt, trainer, batch_fn
    net = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    load_numpy_state(net, _INIT["arrays"])
    opt = topt.AdamW(1e-3, parameters=net.named_parameters(),
                     weight_decay=0.01)
    trainer = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt)

    def batch_fn(step):
        ids = torch.from_numpy(IDS[step]).long()
        return [ids[:, :-1]], [ids[:, 1:]]
    return net, opt, trainer, batch_fn


def _loss(v):
    return float(np.asarray(v.value if hasattr(v, "value") else v))


def _params(pkg, net):
    if pkg == "jax":
        return {k: np.asarray(p.value) for k, p in net.named_parameters()}
    return numpy_state(net)


def _series(counter):
    return {tuple(sorted(dict(k).items())): v
            for k, v in counter.series().items()}


# the ladder cases: (policy keyword arguments, a checkpoint every N steps
# or None, the loss script's site arguments, what the script returns)
NAN = (lambda value=None, **_: float("nan"))
SPIKE = (lambda value=None, **_: value * 1000.0)
LADDER = {
    "skip": (dict(nan_action="skip"), None, dict(after=2, times=1), NAN),
    "skip_budget": (dict(nan_action="skip", max_skips=1), 1,
                    dict(after=2, times=2), NAN),
    "rollback": (dict(nan_action="rollback"), 2, dict(after=4, times=1),
                 NAN),
    "abort": (dict(nan_action="rollback"), None, dict(after=1, times=1),
              NAN),
    "spike_skip": (dict(spike_action="skip", min_history=4), None,
                   dict(after=5, times=1), SPIKE),
}


def _ladder_run(pkg, case, tmp_path):
    policy_kw, every, site, fn = LADDER[case]
    training, chaos = PKGS[pkg]
    net, opt, trainer, batch_fn = _linear(pkg)
    mgr = None
    if every is not None:
        mk, pol = ((JManager, JPolicy) if pkg == "jax"
                   else (CheckpointManager, CheckpointPolicy))
        mgr = trainer.attach_checkpoint(mk(
            str(tmp_path / pkg), network=net, optimizer=opt,
            policy=pol(save_every_steps=every, keep_last_k=100)))
    rec = (JRecorder if pkg == "jax" else FlightRecorder)(
        dump_dir=str(tmp_path / f"flight_{pkg}"))
    sentinel = training.AnomalySentinel(
        training.SentinelPolicy(**policy_kw), manager=mgr, sync=True,
        registry=(JRegistry if pkg == "jax" else MetricsRegistry)(),
        recorder=rec)
    trainer.attach_sentinel(sentinel)
    losses, acts = [], []
    out = {}
    with chaos.chaos() as m:
        m.on("train.loss", fn, **site)
        try:
            out["summary"] = training.run_resilient(
                trainer, batch_fn, steps=8,
                on_step=lambda s, lo, a: (losses.append(_loss(lo)),
                                          acts.append(a and (a.kind,
                                                             a.action,
                                                             a.step))))
        except training.TrainingAborted as e:
            bundle = json.load(open(e.bundle_path))
            out["aborted"] = (e.action.kind, e.action.step,
                              bundle["reason"])
    if mgr is not None:
        mgr.close()
    la = sentinel.last_action
    out.update(
        losses=losses, actions=acts, series=_series(sentinel.anomalies),
        last=la and (la.kind, la.action, la.step, la.resume_step,
                     la.dropped_steps),
        skips=sentinel.skips_taken, rollbacks=sentinel.rollbacks_taken)
    return out


@pytest.mark.parametrize("case", sorted(LADDER))
def test_policy_ladder_matches_jax(case, tmp_path):
    """One loss script through the JAX and the port sentinels: the same
    rungs, escalations, replays, skips and abort, and the same losses."""
    want = _ladder_run("jax", case, tmp_path)
    got = _ladder_run("port", case, tmp_path)
    wl, gl = want.pop("losses"), got.pop("losses")
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    assert got == want
    if case == "abort":
        assert got["aborted"][2] == "train_anomaly:naninf"
    elif case == "skip_budget":
        assert got["summary"]["skipped_steps"] == 1 \
            and got["summary"]["replays"] == 1


def test_classify_and_spike_rules_match_jax():
    values = [1.0, 1.1, 0.9, 1.05, 5.0, 50.0, float("nan"), float("inf"),
              2.0, 1e3, 0.95]
    for kw in (dict(spike_factor=10.0, min_history=4),
               dict(loss_ceiling=100.0), dict(min_history=2,
                                              spike_factor=3.0,
                                              spike_window=3)):
        got, want = [], []
        for pkg, out in (("jax", want), ("port", got)):
            training = PKGS[pkg][0]
            s = training.AnomalySentinel(
                training.SentinelPolicy(spike_action="abort", **kw),
                sync=True,
                registry=(JRegistry if pkg == "jax"
                          else MetricsRegistry)())
            for v in values:
                kind = s._classify(v)
                out.append(kind)
                if kind is None:
                    s._history.append(v)
                    del s._history[:-s.policy.spike_window]
        assert got == want, kw
    assert "loss_spike" in got and "naninf" in got


# ------------------------------------------------- the tiny Llama's runs
def _llama_run(pkg, skip=None, sentinel=False, steps=8):
    net, opt, trainer, batch_fn = _llama(pkg)
    training, chaos = PKGS[pkg]
    order = [s for s in range(1, steps + 1) if s != skip]
    losses, acts = [], []
    if sentinel:
        s = training.AnomalySentinel(
            training.SentinelPolicy(nan_action="skip"), sync=True,
            registry=(JRegistry if pkg == "jax" else MetricsRegistry)())
        s.attach(trainer)
    with chaos.chaos() as m:
        if sentinel:
            m.on("train.loss", NAN, after=2, times=1)
        summary = training.run_resilient(
            trainer, lambda st: batch_fn(order[st - 1]), steps=len(order),
            on_step=lambda st, lo, a: (losses.append(_loss(lo)),
                                       acts.append(a)))
    healthy = [lo for lo, a in zip(losses, acts) if a is None]
    return summary, healthy, _params(pkg, net), opt


def test_nan_skip_drops_exactly_the_bad_batch():
    """NaN at step 3 through ``train.loss``: the skip undoes the update in
    place, drops batch 3, and the run equals one that never took it (bit
    for bit on the port; JAX's sentinel run within the fp32 train-step
    tolerances)."""
    summary, healthy, params, opt = _llama_run("port", sentinel=True)
    assert summary["skipped_steps"] == 1 and summary["replays"] == 0
    assert opt._step_count == 7
    _, ref, ref_params, _ = _llama_run("port", skip=3, steps=8)
    assert healthy == ref
    for k in ref_params:
        np.testing.assert_array_equal(params[k], ref_params[k], err_msg=k)
    jsummary, jhealthy, jparams, _ = _llama_run("jax", sentinel=True)
    assert jsummary == summary
    np.testing.assert_allclose(healthy, jhealthy, rtol=1e-5)
    for k in jparams:
        np.testing.assert_allclose(params[k], jparams[k], rtol=0,
                                   atol=1e-5, err_msg=k)


def test_rollback_replay_is_bit_equal(tmp_path):
    """NaN at step 5 after the commit of step 4: the rollback restores
    the commit, ``run_resilient`` replays steps 5-8, and the losses and
    every parameter equal the uninterrupted port run bit for bit."""
    _, ref, ref_params, _ = _llama_run("port")
    net, opt, trainer, batch_fn = _llama("port")
    mgr = trainer.attach_checkpoint(CheckpointManager(
        str(tmp_path / "ck"), policy=CheckpointPolicy(save_every_steps=2,
                                                      keep_last_k=100)))
    sentinel = ttraining.AnomalySentinel(
        ttraining.SentinelPolicy(nan_action="rollback"), manager=mgr,
        sync=True, registry=MetricsRegistry())
    trainer.attach_sentinel(sentinel)
    got = {}
    with tchaos.chaos() as m:
        m.on("train.loss", NAN, after=4, times=1)
        summary = ttraining.run_resilient(
            trainer, batch_fn, steps=8,
            on_step=lambda s, lo, a: got.__setitem__(s, float(lo)))
    mgr.close()
    assert summary == {"completed_steps": 8, "replays": 1,
                       "skipped_steps": 0, "final_step": 8}
    assert [got[s] for s in sorted(got)] == ref
    params = numpy_state(net)
    for k in ref_params:
        np.testing.assert_array_equal(params[k], ref_params[k], err_msg=k)
    assert _series(sentinel.anomalies) == {
        (("action", "rollback"), ("kind", "naninf")): 1}


def test_rollback_quarantines_poisoned_generations(tmp_path):
    """A detection that arrives late (the anomaly at step 4 with steps 4
    and 5 committed) retires both generations to ``.anomaly.tmp`` names
    and restores step 3, as JAX's does."""
    root = str(tmp_path / "ck")
    net, opt, trainer, batch_fn = _linear("port")
    mgr = trainer.attach_checkpoint(CheckpointManager(
        root, policy=CheckpointPolicy(save_every_steps=1, keep_last_k=100)))
    ttraining.run_resilient(trainer, batch_fn, steps=5)
    mgr.wait()
    assert [s for s, _ in tcommit.list_committed(root)] == [5, 4, 3, 2, 1]
    sentinel = ttraining.AnomalySentinel(
        ttraining.SentinelPolicy(nan_action="rollback"), manager=mgr,
        sync=True, registry=MetricsRegistry())
    trainer.attach_sentinel(sentinel)
    with pytest.raises(ttraining.RollbackAndReplay) as ei:
        sentinel._respond("naninf", 4, float("nan"))
    assert ei.value.action.resume_step == 4
    assert opt._step_count == 3
    assert [s for s, _ in tcommit.list_committed(root)] == [3, 2, 1]
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(root, "*.anomaly.tmp"))) == [
        "step_00000004.anomaly.tmp", "step_00000005.anomaly.tmp"]
    mgr.close()


# ------------------------------------------------------------- watchdog
def _watchdog_script(pkg, tmp_path):
    training, chaos = PKGS[pkg]
    clk = chaos.ChaosClock()
    fired = []
    wd = training.TrainWatchdog(
        stall_seconds=5.0, clock=clk,
        registry=(JRegistry if pkg == "jax" else MetricsRegistry)(),
        recorder=(JRecorder if pkg == "jax" else FlightRecorder)(
            dump_dir=str(tmp_path / f"wd_{pkg}")),
        on_fire=lambda kind, **info: fired.append((kind, info)))
    checks = [wd.check()]                 # nothing dispatched yet
    wd.note_dispatch(1)
    for dt in (3.0, 3.0, 0.0):            # inside, past, the same gap
        clk.advance(dt)
        checks.append(wd.check())
    bundle = json.load(open(wd.last_dump_path))["reason"]
    wd.note_dispatch(2)                   # a new dispatch re-arms
    clk.advance(8.0)
    wd.note_blocked(6.0)                  # a checkpoint stall: no hang
    checks.append(wd.check())
    clk.advance(4.0)                      # 12 s gap - 6 s blocked > 5 s
    checks.append(wd.check())
    return checks, fired, _series(wd.fires), bundle


def test_watchdog_wedge_and_blocked_match_jax(tmp_path):
    got = _watchdog_script("port", tmp_path)
    assert got == _watchdog_script("jax", tmp_path)
    checks, fired, series, bundle = got
    assert [[k for k, _ in c] for c in checks] == [
        [], [], ["wedged_step"], [], [], ["wedged_step"]]
    assert series == {(("kind", "wedged_step"),): 2}
    assert bundle == "watchdog:wedged_step"


def test_watchdog_peer_heartbeat_staleness_matches_jax(tmp_path):
    out = {}
    for pkg in ("jax", "port"):
        training = PKGS[pkg][0]
        hb = tmp_path / f"hb_{pkg}"
        hb.mkdir()
        wd = training.TrainWatchdog(
            stall_seconds=60.0, heartbeat_dir=str(hb), rank=0,
            heartbeat_timeout_s=5.0,
            registry=(JRegistry if pkg == "jax" else MetricsRegistry)(),
            recorder=(JRecorder if pkg == "jax" else FlightRecorder)(
                dump_dir=str(tmp_path / f"hbf_{pkg}")))
        wd.note_dispatch(1)
        own = (hb / "0").read_text()
        old = time.time() - 30.0
        (hb / "1").write_text("7\n")
        os.utime(hb / "1", (old, old))
        runs = [wd.check(), wd.check()]   # stale: one fire an episode
        (hb / "1").write_text("9\n")
        os.utime(hb / "1", (old + 1, old + 1))
        runs.append(wd.check())           # stale again: a new episode
        out[pkg] = (own, [[(k, i["rank"]) for k, i in r] for r in runs])
    assert out["port"] == out["jax"]
    assert out["port"][1] == [[("missed_heartbeat", 1)], [],
                              [("missed_heartbeat", 1)]]


def test_trainer_feeds_watchdog_and_seams():
    """The trainer timestamps each dispatch, fires ``train.step_begin``
    with the step it starts, and the StepMeter's blocked listener reaches
    an attached watchdog (and stops at ``stop()``)."""
    prev = set_step_meter(StepMeter())
    try:
        clk = tchaos.ChaosClock()
        net, opt, trainer, batch_fn = _linear("port")
        wd = ttraining.TrainWatchdog(stall_seconds=300.0, clock=clk,
                                     registry=MetricsRegistry())
        wd.attach(trainer)
        begun = []
        with tchaos.chaos() as m:
            m.on("train.step_begin",
                 lambda step=None, **_: begun.append(step))
            ttraining.run_resilient(trainer, batch_fn, steps=2)
        assert begun == [1, 2] and wd._last_step == 2
        from paddle_tpu_torch.observability import get_step_meter

        get_step_meter().note_blocked(6.0)
        assert wd._blocked == 6.0
        wd.stop()
        get_step_meter().note_blocked(1.0)
        assert wd._blocked == 6.0
    finally:
        set_step_meter(prev)


def test_serving_chaos_is_the_shared_module():
    from paddle_tpu_torch.serving import chaos as schaos

    assert schaos.poke is tchaos.poke and schaos.install is tchaos.install
    assert schaos.ChaosMonkey is tchaos.ChaosMonkey
    with tchaos.chaos() as m:
        assert schaos.active() is m
