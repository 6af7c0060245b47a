"""The port's checkpoint format and runtime (``paddle_tpu_torch/
distributed/checkpoint``, ``paddle_tpu_torch/checkpoint``, ``chaos.py``)
against the JAX package's, on the CPU.

- JAX's ``save_state_dict`` and the port's, on the same numpy-made state
  (fp32, int8, int64 and bf16 tensors, nested dicts and lists, scalars),
  write byte-identical directories; each package loads the other's
  bit-exactly, except that JAX's reader fails on a bf16 shard (pinned:
  the recorded departure, ``ROADMAP.md`` queue C).
- Each ``tear_checkpoint`` mode of either package is caught by the other
  package's ``verify_checkpoint``.
- The manager: retention, orphan GC, restore past a torn newest
  checkpoint, an async save taken before in-place updates equal to a copy
  taken then, the ``rng`` entry JAX's manager loads.
- A tiny Llama with AdamW, 2 eager JAX steps checkpointed by JAX's
  ``CheckpointManager``, restores into the port's trainer with parameters
  and moments bit-equal and ``@step_count`` and the scheduler's state
  equal, key by key; the reverse too; and the port's trainer resumed from
  its own checkpoint repeats the uninterrupted losses exactly.
"""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import chaos as jchaos  # noqa: E402
from paddle_tpu.checkpoint import CheckpointManager as JManager  # noqa: E402
from paddle_tpu.checkpoint import commit as jcommit  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.distributed.checkpoint import (  # noqa: E402
    load_state_dict as jload,
    save_state_dict as jsave,
)
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.models import causal_lm_loss as jloss  # noqa: E402
from paddle_tpu_torch import chaos as tchaos  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.observability import (  # noqa: E402
    MetricsRegistry as TMetricsRegistry,
)
from paddle_tpu_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    CheckpointPolicy,
    commit as tcommit,
)
from paddle_tpu_torch.convert import load_numpy_state, numpy_state  # noqa
from paddle_tpu_torch.distributed.checkpoint import (  # noqa: E402
    load_state_dict as tload,
    save_state_dict as tsave,
)
from paddle_tpu_torch.jit import CompiledTrainStep  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.models import causal_lm_loss  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=32)
TEAR_MODES = ("truncate_shard", "bitflip_shard", "delete_shard",
              "delete_manifest")


# ------------------------------------------------------------- the format
def _arrays():
    rng = np.random.RandomState(0)
    bf = rng.randn(3, 4).astype(np.float32).astype(ml_dtypes.bfloat16)
    return {"f32": rng.randn(5, 6).astype(np.float32),
            "i8": rng.randint(-128, 128, (7,)).astype(np.int8),
            "i64": rng.randint(0, 1 << 40, (2, 3)).astype(np.int64),
            "bf16": bf,
            "f32_0d": np.float32(2.5) * np.ones((), np.float32)}


def _bf16_torch(a):
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _states(arrays):
    """The same nested state, as each package holds it."""
    def build(conv):
        return {"model": {"w": conv(arrays["f32"]), "q": conv(arrays["i8"]),
                          "bf": conv(arrays["bf16"])},
                "opt": {"moments": [conv(arrays["i64"]),
                                    {"s": conv(arrays["f32_0d"])}],
                        "@step_count": 5,
                        "LR_Scheduler": {"last_lr": 0.125, "verbose": False,
                                         "name": "warmup", "ids": [1, 2]}},
                "step": 9, "rng": np.array([0, 7], np.uint32)}

    def to_torch(a):
        if a.dtype == ml_dtypes.bfloat16:
            return _bf16_torch(a)
        return torch.from_numpy(np.array(a))

    return build(jnp.asarray), build(to_torch)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x.value if isinstance(x, Tensor) else x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_directories_are_byte_identical(tmp_path):
    jstate, tstate = _states(_arrays())
    jfiles = jsave(jstate, str(tmp_path / "jax"))
    tfiles = tsave(tstate, str(tmp_path / "port"))
    assert jfiles == tfiles
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 7  # five tensors, rng, metadata
    for name in names:
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert a == b, name


def _zeros_like_state(state, torch_side):
    """A target of the same structure: zero tensors, zeroed scalars."""
    def z(v):
        if isinstance(v, dict):
            return {k: z(x) for k, x in v.items()}
        if isinstance(v, list):
            return [z(x) for x in v]
        if isinstance(v, torch.Tensor):
            return torch.zeros_like(v)
        if isinstance(v, np.ndarray):
            return np.zeros_like(v)
        if hasattr(v, "dtype") and not torch_side:
            return jnp.zeros_like(v)
        return type(v)() if v is not None else None

    return z(state)


def test_port_loads_jax_checkpoint_bit_exactly_bf16_included(tmp_path):
    jstate, tstate = _states(_arrays())
    jsave(jstate, str(tmp_path))
    target = _zeros_like_state(tstate, True)
    tload(target, str(tmp_path))
    for (k, want), (_, got) in zip(_leaves(tstate), _leaves(target)):
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)
        assert type(got) is type(want), k
    assert target["opt"]["@step_count"] == 5
    assert target["opt"]["LR_Scheduler"] == tstate["opt"]["LR_Scheduler"]
    assert target["step"] == 9


def _leaves(state, prefix=""):
    if isinstance(state, dict):
        for k, v in state.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(state, list):
        for i, v in enumerate(state):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix, state


def test_jax_loads_port_checkpoint_bit_exactly_except_bf16(tmp_path):
    jstate, tstate = _states(_arrays())
    tsave(tstate, str(tmp_path))
    target = _zeros_like_state(jstate, False)
    del target["model"]["bf"]  # JAX cannot read a bf16 shard
    jload(target, str(tmp_path))
    for k, got in _leaves(target):
        want = dict(_leaves(jstate))[k]
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)
    assert target["opt"]["LR_Scheduler"]["ids"] == [1, 2]


def test_jax_bf16_read_fault_is_pinned(tmp_path):
    """The recorded departure: JAX writes bf16 under ``'<V2'`` and its own
    reader then raises (``save_load.py:148``, ``:164``); the port reads
    the same file, and casts a bf16 shard to fp32 exactly."""
    bf = _arrays()["bf16"]
    jsave({"model": {"w": jnp.asarray(bf)}}, str(tmp_path))
    with pytest.raises(ValueError, match="No cast function"):
        jload({"model": {"w": jnp.zeros(bf.shape, jnp.bfloat16)}},
              str(tmp_path))
    got = {"model": {"w": torch.zeros(bf.shape)}}
    tload(got, str(tmp_path))
    np.testing.assert_array_equal(got["model"]["w"].numpy(),
                                  bf.astype(np.float32))


def test_port_loads_jax_sharded_checkpoint(tmp_path):
    """A JAX array sharded over 4 of the 8 CPU devices is written as 4
    shard files with their boxes; the port assembles the whole tensor."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    a = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    sharded = jax.device_put(jnp.asarray(a),
                             NamedSharding(mesh, PartitionSpec("x")))
    jsave({"w": sharded}, str(tmp_path))
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npy")]) == 4
    got = {"w": torch.zeros(8, 6)}
    tload(got, str(tmp_path))
    np.testing.assert_array_equal(got["w"].numpy(), a)


def test_casts_on_load_and_process_group_refused(tmp_path):
    arrays = _arrays()
    tsave({"w": torch.from_numpy(arrays["f32"])}, str(tmp_path))
    got = {"w": torch.zeros(arrays["f32"].shape, dtype=torch.bfloat16)}
    tload(got, str(tmp_path))
    want = arrays["f32"].astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(_bits(got["w"]), want)
    with pytest.raises(ValueError, match="shape"):
        tload({"w": torch.zeros(2)}, str(tmp_path))
    with pytest.raises(KeyError, match="missing"):
        tload({"v": torch.zeros(2)}, str(tmp_path))
    for fn in (tsave, tload):
        with pytest.raises(NotImplementedError, match="queue A item 6"):
            fn({"w": torch.zeros(2)}, str(tmp_path), process_group=object())


# -------------------------------------------------------- commit and tears
def _net(seed=5):
    return LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu", seed=seed)


def _commit_one(side, root, seed=5, step=1):
    """One committed checkpoint of a tiny net written by ``side``."""
    if side == "port":
        mgr = CheckpointManager(str(root), network=_net(seed),
                                async_saves=False)
    else:
        paddle.seed(seed)
        mgr = JManager(str(root), network=JLlama(JConfig.tiny(**CFG)),
                       async_saves=False)
    mgr.save(step, blocking=True)
    mgr.close()
    return (tcommit if side == "port" else jcommit).latest_committed(
        str(root))


@pytest.mark.parametrize("mode", TEAR_MODES)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_every_tear_is_caught_by_the_other_package(tmp_path, writer, mode):
    """A checkpoint one package wrote and tore, verified by the other:
    intact first (the manifests agree), every tear caught."""
    other = jcommit if writer == "port" else tcommit
    tear = (tchaos if writer == "port" else jchaos).tear_checkpoint
    step_dir = _commit_one(writer, tmp_path)
    assert other.verify_checkpoint(step_dir) == []
    tear(step_dir, mode)
    if mode == "delete_manifest":
        assert other.read_manifest(step_dir) is None
    else:
        assert other.verify_checkpoint(step_dir), mode


# ------------------------------------------------------------- the manager
def test_retention_orphan_gc_and_fallback_past_torn_newest(tmp_path):
    net = _net(5)
    mgr = CheckpointManager(
        str(tmp_path), network=net, async_saves=False,
        policy=CheckpointPolicy(save_every_steps=1, keep_last_k=2,
                                keep_every_m=3))
    for step in range(1, 7):
        with torch.no_grad():
            net.model.norm.weight.fill_(float(step))
        mgr.on_step(step)
    mgr.close()
    assert [s for s, _ in tcommit.list_committed(str(tmp_path))] == [6, 5, 3]
    assert mgr.saves_total.by_label() == {"sync": 6}
    # an orphaned save older than the window is reaped at startup
    orphan = tcommit.tmp_dir(str(tmp_path), 7)
    os.makedirs(orphan)
    os.utime(orphan, (time.time() - 1000, time.time() - 1000))
    fresh = tcommit.tmp_dir(str(tmp_path), 8)
    os.makedirs(fresh)
    tchaos.tear_checkpoint(tcommit.step_dir(str(tmp_path), 6),
                           "truncate_shard")
    net2 = _net(9)
    mgr2 = CheckpointManager(str(tmp_path), network=net2, async_saves=False)
    assert not os.path.isdir(orphan) and os.path.isdir(fresh)
    assert mgr2.fallbacks_total.by_label() == {"orphan_tmp": 1}
    res = mgr2.restore_or_init()
    assert res.restored and res.step == 5
    assert mgr2.fallbacks_total.by_label() == {
        "orphan_tmp": 1, "checksum_mismatch": 1}
    assert torch.equal(net2.model.norm.weight,
                       torch.full_like(net2.model.norm.weight, 5.0))
    assert mgr2.restores_total.by_label() == {"restored": 1}
    mgr2.close()
    # ``registry=`` is taken, as in JAX: the series land there by name
    reg = TMetricsRegistry()
    mgr3 = CheckpointManager(str(tmp_path), registry=reg, async_saves=False)
    assert reg.get("paddle_ckpt_restore_fallbacks_total") is \
        mgr3.fallbacks_total
    mgr3.close()


def test_preemption_signal_takes_an_emergency_save(tmp_path):
    """A preemption signal (SIGUSR1 here, SIGTERM by default) saves the
    current step on a dedicated thread; a second emergency save of the
    same step is skipped; the manager closes as a context manager."""
    import signal

    policy = CheckpointPolicy(save_every_steps=1000)  # never by policy
    with CheckpointManager(str(tmp_path), network=_net(5),
                           policy=policy) as mgr:
        mgr.install_preemption_handler(signals=(signal.SIGUSR1,),
                                       grace_seconds=10.0)
        try:
            mgr.on_step(41)
            assert tcommit.list_committed(str(tmp_path)) == []
            os.kill(os.getpid(), signal.SIGUSR1)
            assert mgr.preempted
            assert mgr.join_preemption(timeout=30)
        finally:
            signal.signal(signal.SIGUSR1,
                          mgr._prev_handlers[signal.SIGUSR1])
        assert mgr.emergency_save() == 41
    assert [s for s, _ in tcommit.list_committed(str(tmp_path))] == [41]
    assert mgr.saves_total.by_label() == {"emergency": 1}
    assert tcommit.verify_checkpoint(
        tcommit.latest_committed(str(tmp_path))) == []
    assert not mgr._saver._thread.is_alive()


def test_async_save_under_in_place_updates_equals_copy(tmp_path):
    """An async save whose write runs after later in-place updates (a
    slowed serializer) commits the state of the step it was taken at."""
    net = _net(5)
    mgr = CheckpointManager(str(tmp_path), network=net)
    release = threading.Event()
    undo = tchaos.wedged_serializer(mgr, release)
    try:
        copy = {k: v.clone() for k, v in net.state_dict().items()}
        mgr.save(1)
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(-3.0).add_(1.0)  # the next steps, in place
        assert not mgr.wait(timeout=0.05)
        release.set()
        assert mgr.wait(timeout=30)
    finally:
        undo()
        mgr.close()
    assert mgr.saves_total.by_label() == {"async": 1}
    got = {k: torch.zeros_like(v) for k, v in copy.items()}
    tload({"model": got}, tcommit.step_dir(str(tmp_path), 1))
    for k, v in copy.items():
        assert torch.equal(got[k], v), k


def test_rng_entry_loads_into_jax_manager(tmp_path):
    """The ``rng`` entry has JAX's name, shape and dtype: JAX's
    ``restore_or_init`` loads a port checkpoint; the port ignores it on
    restore with JAX's warning."""
    step_dir = _commit_one("port", tmp_path)
    meta = (tmp_path / os.path.basename(step_dir) / "metadata.json")
    assert '"rng"' in meta.read_text()
    paddle.seed(3)
    jnet = JLlama(JConfig.tiny(**CFG))
    jmgr = JManager(str(tmp_path), network=jnet, async_saves=False)
    assert jmgr.restore_or_init().restored
    jmgr.close()
    want = numpy_state(_net(5))
    for k, p in jnet.named_parameters():
        np.testing.assert_array_equal(np.asarray(p.value), want[k], err_msg=k)


# ------------------------------------------- trainer state across packages
def _carried_pair(seed=11):
    paddle.seed(seed)
    jnet = JLlama(JConfig(**CFG))
    tnet = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=1)
    load_numpy_state(tnet, {k: np.asarray(p.value)
                            for k, p in jnet.named_parameters()})
    return jnet, tnet


def _batch(seed=0):
    ids = np.random.RandomState(seed).randint(0, CFG["vocab_size"], (2, 9))
    return ids[:, :-1], ids[:, 1:]


def _port_trainer(tnet):
    sched = topt.lr.LinearWarmup(2e-3, 3, 1e-4, 2e-3)
    opt = topt.AdamW(sched, parameters=tnet.named_parameters(),
                     weight_decay=0.01)
    step = CompiledTrainStep(
        tnet, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt)
    return step, opt, sched


def _jax_eager_steps(jnet, n, seed=0):
    sched = paddle.optimizer.lr.LinearWarmup(2e-3, 3, 1e-4, 2e-3)
    opt = paddle.optimizer.AdamW(sched, parameters=jnet.parameters(),
                                 weight_decay=0.01)
    ids, labels = _batch(seed)
    for _ in range(n):
        loss = jloss(jnet(Tensor(jnp.asarray(ids))),
                     Tensor(jnp.asarray(labels))).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
    return opt, sched


def test_jax_optimizer_state_restores_into_port_trainer(tmp_path):
    """2 eager JAX AdamW steps, saved by JAX's manager; the port's fresh
    trainer restores: the optimizer keys equal JAX's, key by key, and
    every parameter and moment, the step count and the scheduler's state
    are equal."""
    jnet, tnet = _carried_pair()
    jopt, jsched = _jax_eager_steps(jnet, 2)
    jmgr = JManager(str(tmp_path), network=jnet, optimizer=jopt,
                    async_saves=False)
    jmgr.save(2, blocking=True)
    jmgr.close()
    _, opt, sched = _port_trainer(tnet)
    mgr = CheckpointManager(str(tmp_path), network=tnet, optimizer=opt)
    res = mgr.restore_or_init()
    mgr.close()
    assert res.restored and res.step == 2
    jsd, tsd = jopt.state_dict(), opt.state_dict()
    assert sorted(jsd) == sorted(tsd)
    for k, v in jsd.items():
        if k == "LR_Scheduler":
            assert tsd[k] == v
        elif k == "@step_count":
            assert tsd[k] == v == 2
        else:
            np.testing.assert_array_equal(
                tsd[k].numpy(), np.asarray(v.value), err_msg=k)
    assert sched.state_dict() == jsched.state_dict()
    for k, p in jnet.named_parameters():
        np.testing.assert_array_equal(numpy_state(tnet)[k],
                                      np.asarray(p.value), err_msg=k)


def test_port_trainer_state_restores_into_jax(tmp_path):
    """The reverse: 2 port steps saved by the port's manager load into
    JAX's (its optimizer primed with one step, so its moments exist)."""
    jnet, tnet = _carried_pair()
    step, opt, sched = _port_trainer(tnet)
    ids, labels = _batch()
    for _ in range(2):
        step([torch.from_numpy(ids)], [torch.from_numpy(labels)])
        sched.step()
    mgr = CheckpointManager(str(tmp_path), network=tnet, optimizer=opt,
                            async_saves=False)
    mgr.save(2)
    mgr.close()
    assert [s for s, _ in tcommit.list_committed(str(tmp_path))] == [2]
    jopt, jsched = _jax_eager_steps(jnet, 1, seed=5)
    jmgr = JManager(str(tmp_path), network=jnet, optimizer=jopt,
                    async_saves=False)
    assert jmgr.restore_or_init().restored
    jmgr.close()
    tsd = opt.state_dict()
    for k, v in jopt.state_dict().items():
        if k == "LR_Scheduler":
            assert v == tsd[k]
        elif k == "@step_count":
            assert v == 2
        else:
            np.testing.assert_array_equal(
                np.asarray(v.value), tsd[k].numpy(), err_msg=k)
    for k, p in jnet.named_parameters():
        np.testing.assert_array_equal(np.asarray(p.value),
                                      numpy_state(tnet)[k], err_msg=k)


def test_trainer_resume_repeats_uninterrupted_losses(tmp_path):
    """Four port steps with an async manager saving every 2 steps; the
    step-4 checkpoint torn; a fresh trainer restores from step 2 (past
    the torn one), repeats steps 3-4's losses exactly, and its own save
    of step 4 replaces the torn one."""
    ids, labels = _batch(3)
    batch = ([torch.from_numpy(ids)], [torch.from_numpy(labels)])
    policy = CheckpointPolicy(save_every_steps=2, keep_last_k=2)
    step, opt, sched = _port_trainer(_carried_pair()[1])
    mgr = step.attach_checkpoint(CheckpointManager(str(tmp_path),
                                                   policy=policy))
    losses = []
    for _ in range(4):
        losses.append(float(step(*batch)[0]))
        sched.step()
    mgr.close()
    assert mgr.saves_total.by_label() == {"async": 2}
    tchaos.tear_checkpoint(tcommit.step_dir(str(tmp_path), 4),
                           "bitflip_shard")
    tnet = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=4)
    step2, opt2, sched2 = _port_trainer(tnet)
    mgr2 = step2.attach_checkpoint(CheckpointManager(str(tmp_path),
                                                     policy=policy))
    assert mgr2.restore_or_init().step == 2
    # the save ran inside step 2, before that iteration's sched.step()
    assert opt2._step_count == 2 and sched2.last_epoch == 1
    sched2.step()
    resumed = []
    for _ in range(2):
        resumed.append(float(step2(*batch)[0]))
        sched2.step()
    mgr2.close()
    assert resumed == losses[2:]
    assert [s for s, _ in tcommit.list_committed(str(tmp_path))] == [4, 2]
    assert tcommit.verify_checkpoint(tcommit.step_dir(str(tmp_path), 4)) \
        == []
