"""Live weight reload in the port (``paddle_tpu_torch/serving/reload.py``
and the engines' seams), the cases of ``tests/test_zero_downtime.py``
(the remote-prefill one aside: queue A item 1.7) on the port's slab and
paged engines, fp32 greedy, on the CPU:

exactness before and after a swap; in-flight requests drain on the old
weights while queued ones wait for the new; torn, incompatible and
missing checkpoints refused with JAX's outcome names; a kill mid-swap
through the port's ``chaos``; the int8 publish path with a template
instance (and refused without one); a swap staged through a float
template instance unchanged by a later, refused prepare on it; the prefix-cache flush at the swap
(``tests/test_prefix_cache.py:609-645``) with the spill tier flushed
too; a self-speculative draft that follows the new weights; a newer
staged swap superseding an older one and ``close()`` abandoning one; the
parameters' ``data_ptr()`` and the capture counts unchanged across a
swap; the three methods' signatures against JAX's; and one post-swap
stream, from a checkpoint JAX's ``CheckpointManager`` wrote, against
JAX ``generate`` on the new weights.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.checkpoint import CheckpointManager as JManager  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLlama  # noqa: E402
from paddle_tpu.serving import PagedServingEngine as JPaged  # noqa: E402
from paddle_tpu_torch import chaos  # noqa: E402
from paddle_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from paddle_tpu_torch.checkpoint import commit as commit_mod  # noqa: E402
from paddle_tpu_torch.convert import load_numpy_state  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa
from paddle_tpu_torch.quantization import quantize_for_serving  # noqa
from paddle_tpu_torch.serving import (  # noqa: E402
    PagedServingEngine,
    ServingEngine,
    SpeculativeDecoder,
)
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4)
GEOM = dict(max_batch_size=2, max_seq_len=64, min_bucket=8)
IDS = [3, 7, 11, 2]


def build_net(seed=5, hidden=32, layers=2):
    cfg = LlamaConfig.tiny(**dict(CFG, hidden_size=hidden,
                                  intermediate_size=2 * hidden,
                                  num_hidden_layers=layers))
    return LlamaForCausalLM(cfg, device="cpu", seed=seed).eval()


def ref_tokens(net, ids, max_new):
    out = net.generate(np.asarray(ids)[None], max_new_tokens=max_new,
                       cache_dtype="float32", graphs=False)
    return [int(t) for t in out[0, len(ids):]]


def save_checkpoint(root, net, step=1):
    """One committed checkpoint of ``net`` under ``root``."""
    mgr = CheckpointManager(str(root), network=net, async_saves=False)
    mgr.save(step, blocking=True)
    mgr.close()
    return str(root)


def make_engine(kind, net, **kw):
    kw.setdefault("cache_dtype", "float32")
    if kind == "slab":
        return ServingEngine(net, **GEOM, **kw)
    return PagedServingEngine(net, page_size=8, **GEOM, **kw)


@pytest.fixture(scope="module")
def ckpt_b(tmp_path_factory):
    """netB's streams and its checkpoint (step 3)."""
    root = tmp_path_factory.mktemp("ckpt_b")
    netB = build_net(9)
    return save_checkpoint(root, netB, step=3), netB


KINDS = ["slab", "paged"]


@pytest.mark.parametrize("kind", KINDS)
def test_reload_exactness_before_and_after(kind, ckpt_b):
    root, netB = ckpt_b
    refB = ref_tokens(netB, IDS, 6)
    netA = build_net(5)
    refA = ref_tokens(netA, IDS, 6)
    eng = make_engine(kind, netA)
    h1 = eng.generate([IDS], 6)[0]
    assert h1.tokens == refA and h1.weights_version == "v0"
    ptrs = [p.data_ptr() for p in netA.state_dict(keep_vars=True).values()]
    captures = eng.compile_counts()
    res = eng.reload_weights(root)
    assert res.applied, res.to_json()
    assert eng.weights_version == "ckpt-3"
    assert eng.generation == 1 and eng.last_reload_step == 3
    assert not eng.reload_in_progress
    h2 = eng.generate([IDS], 6)[0]
    assert h2.tokens == refB and h2.weights_version == "ckpt-3"
    assert eng.metrics.reloads.by_label() == {"ok": 1}
    assert eng.metrics.reload_ttft_spike.snapshot()["count"] == 1
    # the swap wrote into the same storage; no program captured again
    assert ptrs == [p.data_ptr()
                    for p in netA.state_dict(keep_vars=True).values()]
    assert eng.compile_counts() == captures
    eng.close()


@pytest.mark.parametrize("kind", KINDS)
def test_reload_drains_inflight_on_old_weights(kind, tmp_path):
    netA, netB = build_net(5), build_net(9)
    refA = ref_tokens(netA, IDS, 10)
    refB = ref_tokens(netB, [4, 9, 1], 6)
    root = save_checkpoint(tmp_path, netB, step=1)
    eng = make_engine(kind, netA)
    h_old = eng.submit(IDS, 10)
    eng.step()
    assert h_old.status == "RUNNING"
    staged = eng.prepare_reload(root)
    assert staged.ok
    eng.commit_reload(staged)
    assert eng.reload_in_progress and eng.weights_version == "v0"
    h_new = eng.submit([4, 9, 1], 6)
    eng.step()
    assert h_new.status == "QUEUED"        # admission paused
    eng.run_until_idle()
    assert h_old.tokens == refA and h_old.weights_version == "v0"
    assert h_new.tokens == refB and h_new.weights_version == "ckpt-1"
    assert not eng.reload_in_progress
    assert eng.metrics.reloads.by_label() == {"ok": 1}
    eng.close()


@pytest.mark.parametrize("mode", ["bitflip_shard", "delete_manifest"])
def test_reload_refuses_torn_checkpoint(tmp_path, mode):
    netA = build_net(5)
    refA = ref_tokens(netA, IDS, 6)
    root = save_checkpoint(tmp_path, build_net(9), step=1)
    chaos.tear_checkpoint(commit_mod.latest_committed(root), mode)
    eng = make_engine("paged", netA)
    res = eng.reload_weights(root)
    want = "verify_failed" if mode != "delete_manifest" else "no_checkpoint"
    assert not res.ok and res.outcome == want, res.to_json()
    assert eng.weights_version == "v0" and eng.generation == 0
    assert eng.generate([IDS], 6)[0].tokens == refA
    assert eng.metrics.reloads.by_label() == {want: 1}


def test_reload_refuses_incompatible_and_missing(tmp_path):
    root = save_checkpoint(tmp_path / "wide", build_net(9, hidden=16))
    eng = make_engine("slab", build_net(5))
    res = eng.reload_weights(root)
    # a shape mismatch fails the load, as in JAX (its test accepts both)
    assert not res.ok and res.outcome == "load_error", res.to_json()
    assert "shape" in res.error
    root = save_checkpoint(tmp_path / "deep", build_net(9, layers=1))
    res = eng.reload_weights(root)
    assert not res.ok and res.outcome == "incompatible", res.to_json()
    res = eng.reload_weights(str(tmp_path / "empty"))
    assert not res.ok and res.outcome == "no_checkpoint"
    assert eng.weights_version == "v0"
    assert eng.metrics.reloads.by_label() == {
        "load_error": 1, "incompatible": 1, "no_checkpoint": 1}


def test_chaos_kill_mid_swap_keeps_last_committed_weights(ckpt_b):
    root, netB = ckpt_b
    netA = build_net(5)
    refA, refB = ref_tokens(netA, IDS, 6), ref_tokens(netB, IDS, 6)
    eng = make_engine("paged", netA)
    with chaos.chaos() as m:
        m.fail("reload.apply")
        res = eng.reload_weights(root)
        assert m.fired("reload.apply") == 1
    assert not res.ok and res.outcome == "error"
    assert eng.weights_version == "v0" and not eng.reload_in_progress
    assert eng.generate([IDS], 6)[0].tokens == refA
    assert eng.metrics.reloads.by_label() == {"error": 1}
    with chaos.chaos() as m:
        m.fail("reload.prepare")
        assert eng.reload_weights(root).outcome == "error"
    assert eng.reload_weights(root).applied
    assert eng.generate([IDS], 6)[0].tokens == refB


def test_reload_int8_publish_path_and_refusal(ckpt_b):
    """A float checkpoint publishes as int8 serving weights through a
    template net instance; without a template it is refused."""
    root, netB = ckpt_b
    ref = make_engine("paged", quantize_for_serving(netB),
                      cache_dtype="int8")
    ref_toks = ref.generate([IDS], 6)[0].tokens
    ref.close()
    eng = make_engine("paged", quantize_for_serving(build_net(5)),
                      cache_dtype="int8")
    res = eng.reload_weights(root)
    assert not res.ok and res.outcome == "incompatible"
    assert "template_net" in (res.error or "")
    pre = eng.generate([IDS], 6)[0]
    res = eng.reload_weights(root, template_net=build_net(5))
    assert res.applied, res.to_json()
    post = eng.generate([IDS], 6)[0]
    assert post.tokens == ref_toks and post.tokens != pre.tokens
    # reload_template= is the default template (a factory works too)
    eng2 = make_engine("slab", quantize_for_serving(build_net(5)),
                       cache_dtype="int8",
                       reload_template=lambda: build_net(7))
    assert eng2.reload_weights(root).applied
    assert eng2.generate([IDS], 6)[0].tokens == ref_toks


def test_staged_swap_survives_a_later_prepare_on_its_template(ckpt_b,
                                                              tmp_path):
    """A swap staged through a float template instance owns its tensors:
    a second prepare on the same template, refused partway through its
    load (a checkpoint missing a layer), changes neither the staged swap
    nor the template, and the first swap applies exactly its weights."""
    root, netB = ckpt_b
    deep = save_checkpoint(tmp_path / "deep", build_net(11, layers=1))
    template = build_net(7)
    before = {k: v.clone() for k, v in template.state_dict().items()}
    eng = make_engine("paged", build_net(5), reload_template=template)
    h = eng.submit(IDS, 8)
    eng.step()
    first = eng.commit_reload(eng.prepare_reload(root))
    assert first.ok and eng.reload_in_progress
    second = eng.prepare_reload(deep)
    assert not second.ok and second.outcome == "incompatible"
    for k, v in template.state_dict().items():
        assert torch.equal(v, before[k]), k
    eng.run_until_idle()
    eng.step()
    assert first.applied and h.weights_version == "v0"
    for (k, a), (_, b) in zip(netB.named_parameters(),
                              eng.net.named_parameters()):
        assert torch.equal(a, b), k
    assert eng.generate([IDS], 6)[0].tokens == ref_tokens(netB, IDS, 6)
    eng.close()


def test_reload_flushes_prefix_cache_and_spill_tier(ckpt_b):
    """The swap flushes the store and its tier (reason
    ``weights_reload``); a post-swap same-prefix request misses and is
    exact on the new weights."""
    root, netB = ckpt_b
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, 64, (16,))
    p1 = np.concatenate([prefix, rng.randint(0, 64, (3,))])
    p2 = np.concatenate([prefix, rng.randint(0, 64, (3,))])
    netA = build_net(5)
    eng = make_engine("paged", netA, prefix_cache=True, kv_tiering={
        "host_budget_bytes": 1 << 20})
    h1 = eng.generate([p1], 5)[0]
    assert h1.tokens == ref_tokens(netA, p1, 5)
    assert eng.prefix_cache.cached_pages > 0
    # spill one cached page into the tier
    assert eng.prefix_cache.evict(1) == 1
    spilled = sum(eng.kv_tier.stats()["pages"].values())
    assert spilled >= 1
    misses0 = int(eng.prefix_cache.misses.value)
    assert eng.reload_weights(root).applied
    assert eng.prefix_cache.cached_pages == 0
    assert sum(eng.kv_tier.stats()["pages"].values()) == 0
    assert eng.kv_tier.dropped.by_label() == {"weights_reload": spilled}
    h2 = eng.generate([p2], 5)[0]
    assert int(eng.prefix_cache.misses.value) - misses0 >= 1
    assert h2.tokens == ref_tokens(netB, p2, 5)
    eng.close()
    assert eng.page_pool.pages_in_use == 0


def test_self_speculative_draft_follows_new_weights(ckpt_b):
    root, netB = ckpt_b
    eng = make_engine("paged", build_net(5),
                      speculative=SpeculativeDecoder(exit_layer=1, k=2),
                      demand_paging=True)
    eng.generate([IDS], 6)
    assert eng.reload_weights(root).applied
    assert all(st.fed == -1 for st in eng.speculative._slots.values())
    h = eng.generate([IDS], 6)[0]
    assert h.tokens == ref_tokens(netB, IDS, 6)
    eng.close()


def test_newer_swap_supersedes_and_close_abandons(tmp_path):
    netB, netC = build_net(9), build_net(11)
    rootB = save_checkpoint(tmp_path / "b", netB, step=1)
    rootC = save_checkpoint(tmp_path / "c", netC, step=2)
    eng = make_engine("slab", build_net(5))
    h = eng.submit(IDS, 8)
    eng.step()
    first = eng.commit_reload(eng.prepare_reload(rootB))
    second = eng.commit_reload(eng.prepare_reload(rootC))
    assert first.outcome == "superseded" and eng.reload_in_progress
    eng.run_until_idle()
    assert h.weights_version == "v0" and eng.reload_in_progress
    eng.step()  # the first boundary with nothing in flight applies it
    assert second.applied
    assert eng.weights_version == "ckpt-2"
    assert eng.generate([IDS], 6)[0].tokens == ref_tokens(netC, IDS, 6)
    assert eng.metrics.reloads.by_label() == {"superseded": 1, "ok": 1}
    eng.submit(IDS, 8)
    eng.step()
    eng.commit_reload(eng.prepare_reload(rootB))
    eng.close()
    assert not eng.reload_in_progress
    assert eng.metrics.reloads.by_label()["abandoned"] == 1
    closed = eng.commit_reload(eng.prepare_reload(rootB))
    assert closed.outcome == "engine_closed"


@pytest.mark.parametrize("name", ["prepare_reload", "commit_reload",
                                  "reload_weights"])
def test_signatures_equal_jax(name):
    for cls in (ServingEngine, PagedServingEngine):
        got = inspect.signature(getattr(cls, name))
        want = inspect.signature(getattr(JPaged, name))
        assert list(got.parameters) == list(want.parameters)
        for k, p in want.parameters.items():
            assert got.parameters[k].kind == p.kind, k
            assert got.parameters[k].default == p.default, k


def test_post_swap_stream_equals_jax_generate(tmp_path):
    """A checkpoint JAX's manager wrote, reloaded by the port's paged
    engine: the post-swap stream equals JAX ``generate`` (fp32 cache) on
    those weights."""
    paddle.seed(9)
    jnet = JLlama(JConfig.tiny(**CFG))
    jnet.eval()
    mgr = JManager(str(tmp_path), network=jnet, async_saves=False)
    mgr.save(4, blocking=True)
    mgr.close()
    want = np.asarray(jnet.generate(Tensor(jnp.asarray([IDS])),
                                    max_new_tokens=6,
                                    cache_dtype="float32").numpy())
    eng = make_engine("paged", build_net(5))
    res = eng.reload_weights(str(tmp_path))
    assert res.applied and eng.weights_version == "ckpt-4"
    got = eng.generate([IDS], 6)[0]
    assert got.tokens == [int(t) for t in want[0, len(IDS):]]
    tnet = build_net(1)
    load_numpy_state(tnet, {k: np.asarray(p.value)
                            for k, p in jnet.named_parameters()})
    for (k, a), (_, b) in zip(tnet.named_parameters(),
                              eng.net.named_parameters()):
        assert torch.equal(a, b), k


def test_prepare_on_a_thread_while_serving(ckpt_b):
    """``prepare_reload`` is pure: run on another thread while the engine
    serves, it changes no stream; the staged swap then applies."""
    import threading

    root, netB = ckpt_b
    netA = build_net(5)
    eng = make_engine("paged", netA)
    box = {}
    worker = threading.Thread(
        target=lambda: box.update(staged=eng.prepare_reload(root)))
    worker.start()
    during = eng.generate([IDS, [4, 9, 1]], 8)
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert [h.tokens for h in during] == [ref_tokens(netA, IDS, 8),
                                         ref_tokens(netA, [4, 9, 1], 8)]
    assert eng.commit_reload(box["staged"]).applied
    assert eng.generate([IDS], 6)[0].tokens == ref_tokens(netB, IDS, 6)
    eng.close()
