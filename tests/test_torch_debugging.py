"""The port's NaN/Inf sweep (``FLAGS_check_nan_inf``, ``amp/naninf.py``)
and ``amp.debugging`` against the JAX package's (``core/dispatch.py``
``check_nan_inf``, ``amp/debugging.py``), on the CPU.

Every case of JAX's ``TestCheckNanInf``
(``tests/test_recompute_naninf.py``; the recompute cases excluded) and
the two flight-recorder cases of ``tests/test_observability.py`` run on
the port; the op names in the error (``log``, ``sqrt``, ``sqrt_grad``),
``check_numerics``' message and the operator-stats counts equal JAX's for
the same computation (exactly: they are names and counts). The flag is
turned off after every test. Also the chip script's CPU rehearsal of its
``naninf`` phase (``chip_smoke.naninf_phase`` on a tiny Llama).
"""
import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import observability as jobs  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.amp import debugging, naninf  # noqa: E402
from paddle_tpu_torch.jit import CompiledTrainStep  # noqa: E402
from paddle_tpu_torch.optimizer import SGD  # noqa: E402
from paddle_tpu_torch.utils import get_flags, set_flags  # noqa: E402
from test_torch_kernels import _one_thread  # noqa: E402,F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _flag_off_after():
    yield
    set_flags({"FLAGS_check_nan_inf": False})
    paddle.set_flags({"FLAGS_check_nan_inf": False})


def _op(err):
    return re.search(r"operator \[([^\]]*)\]", str(err)).group(1)


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(8, 32), torch.nn.GELU(),
                               torch.nn.Linear(32, 8))


def _mse(out, lb):
    return ((out - lb) ** 2).mean()


# ------------------------------------------------ JAX's TestCheckNanInf
def test_eager_forward_trips():
    set_flags({"FLAGS_check_nan_inf": True})
    with pytest.raises(RuntimeError, match="NaN or Inf"):
        torch.tensor([1.0, -1.0]).log()


def test_eager_backward_trips():
    set_flags({"FLAGS_check_nan_inf": True})
    x = torch.tensor([0.0, 4.0], requires_grad=True)
    y = x.sqrt().sum()
    with pytest.raises(RuntimeError, match="_grad"):
        y.backward()


def test_disabled_no_trip():
    set_flags({"FLAGS_check_nan_inf": True})
    set_flags({"FLAGS_check_nan_inf": False})
    out = torch.tensor([-1.0]).log()
    assert not np.isfinite(out.numpy()[0])


def test_compiled_step_trips():
    net = _mlp()
    step = CompiledTrainStep(net, _mse, SGD(1e-2, parameters=list(
        net.named_parameters())))
    set_flags({"FLAGS_check_nan_inf": True})
    before = [p.detach().clone() for p in net.parameters()]
    with pytest.raises(Exception, match="NaN or Inf"):
        step([torch.full((2, 8), float("nan"))], [torch.zeros(2, 8)])
    # the check reads the step's flags before the update: nothing moved
    assert all(torch.equal(a, p) for a, p in zip(before, net.parameters()))


def test_flag_roundtrip():
    set_flags({"FLAGS_check_nan_inf": True})
    assert get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"] is True


# ------------------------------------------- names and messages as JAX's
def _jax_op(fn):
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        fn()
    except RuntimeError as e:
        return _op(e)
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf": False})
    return None


def _port_op(fn):
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        fn()
    except RuntimeError as e:
        return _op(e)
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
    return None


def test_op_names_equal_jax():
    """``log``, ``sqrt`` and ``sqrt_grad`` as JAX names them; the message
    is JAX's."""
    def jsqrt_grad():
        x = Tensor(jnp.asarray([0.0, 4.0]), stop_gradient=False)
        x.sqrt().sum().backward()

    def tsqrt_grad():
        x = torch.tensor([0.0, 4.0], requires_grad=True)
        x.sqrt().sum().backward()

    cases = [
        (lambda: Tensor(jnp.asarray([1.0, -1.0])).log(),
         lambda: torch.tensor([1.0, -1.0]).log()),
        (lambda: paddle.sqrt(Tensor(np.asarray([-1.0], np.float32))),
         lambda: torch.sqrt(torch.tensor([-1.0]))),
        (jsqrt_grad, tsqrt_grad),
    ]
    names = [(_jax_op(j), _port_op(t)) for j, t in cases]
    assert names == [("log", "log"), ("sqrt", "sqrt"),
                     ("sqrt_grad", "sqrt_grad")]
    set_flags({"FLAGS_check_nan_inf": True})
    with pytest.raises(RuntimeError) as e:
        torch.tensor([-1.0]).log()
    assert str(e.value) == ("FLAGS_check_nan_inf: operator [log] output "
                            "contains NaN or Inf")


def test_check_numerics_matches_jax():
    from paddle_tpu.amp import debugging as jdbg

    x = np.array([1.0, np.inf, np.nan, 2.0], np.float32)
    assert debugging.check_numerics(torch.tensor([1.0, 2.0]))
    with pytest.raises(FloatingPointError) as want:
        jdbg.check_numerics(Tensor(jnp.asarray(x)), "matmul", "w")
    with pytest.raises(FloatingPointError) as got:
        debugging.check_numerics(torch.from_numpy(x), "matmul", "w")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError):
        debugging.compare_accuracy("a", "b", "c")
    assert debugging.DebugMode.CHECK_NAN_INF_AND_ABORT == 0


def test_operator_stats_match_jax():
    """The counts of each op's calls, and the printed table's ops, equal
    JAX's on one small computation; the tensor checker sets the flag."""
    from paddle_tpu.amp import debugging as jdbg

    xn = np.array([1.0, 2.0, 3.0], np.float32)

    def jrun():
        x = Tensor(jnp.asarray(xn))
        y = ((x + x) * x).exp().sqrt() - x
        return (y / x).log()

    def trun():
        x = torch.from_numpy(xn)
        y = ((x + x) * x).exp().sqrt() - x
        return (y / x).log()

    outs = []
    for mod, run in ((jdbg, jrun), (debugging, trun)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.enable_operator_stats_collection()
            run()
            counts = mod.disable_operator_stats_collection()
        outs.append((counts, sorted(line.split()[0] for line in
                                    buf.getvalue().splitlines()[1:])))
    assert outs[1] == outs[0]
    assert outs[1][0] == {"add": 1, "multiply": 1, "exp": 1, "sqrt": 1,
                          "subtract": 1, "divide": 1, "log": 1}
    assert naninf._COLLECTOR[0] is None and naninf._T.mode is None
    debugging.enable_tensor_checker()
    assert get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"] is True
    debugging.disable_tensor_checker()
    assert get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"] is False


# ------------------------------------------------ the flight recorder
def test_nan_hook_dumps_before_raise(tmp_path):
    rec = obs.FlightRecorder(capacity=4, dump_dir=str(tmp_path),
                             registry=obs.MetricsRegistry())
    prev = obs.set_flight_recorder(rec)
    rec.install(excepthook=False)  # nan seam only
    rec.record_step({"step": 7, "loss": 0.1})
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(RuntimeError, match="NaN or Inf"):
            torch.sqrt(torch.tensor([-1.0]))
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
        rec.uninstall()
        obs.set_flight_recorder(prev)
    b = json.load(open(rec.last_dump_path))
    assert b["reason"].startswith("naninf")
    assert [e["kind"] for e in b["events"]] == ["naninf"]
    assert b["steps"][-1]["step"] == 7


def test_nan_hook_in_compiled_step_dumps_without_blocking(tmp_path):
    """The deferred check of a compiled step fires the hook at the step's
    end, and the bundle lands before the error."""
    rec = obs.FlightRecorder(capacity=4, dump_dir=str(tmp_path),
                             registry=obs.MetricsRegistry())
    prev = obs.set_flight_recorder(rec)
    rec.install(excepthook=False)
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 8))
    step = CompiledTrainStep(net, _mse, SGD(1e-2, parameters=list(
        net.named_parameters())))
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(Exception, match="NaN or Inf") as e:
            step([torch.full((2, 8), float("nan"))], [torch.zeros(2, 8)])
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
        rec.uninstall()
        obs.set_flight_recorder(prev)
    assert rec.last_dump_path is not None
    b = json.load(open(rec.last_dump_path))
    assert b["reason"] == f"naninf:{_op(e.value)}"
    assert jobs.FlightRecorder is not None  # the JAX recorder's case


def test_kernel_wrappers_are_one_op_each():
    """A hand kernel's wrapper is one op of the sweep under JAX's dispatch
    name, forward and ``_grad``; its plain version's inner ATen ops are
    not ops of their own (the causal mask's -inf inside the composed
    attention trips nothing)."""
    from paddle_tpu_torch.kernels import rms_norm as trms
    from paddle_tpu_torch.nn import functional as F

    q, k, v = (torch.randn(1, 4, 2, 8) for _ in range(3))
    set_flags({"FLAGS_check_nan_inf": True})
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert torch.isfinite(out).all()
    x = torch.randn(3, 16)
    w = torch.full((16,), float("inf"))
    with pytest.raises(RuntimeError) as e:
        trms.rms_norm(x, w)
    assert _op(e.value) == "fused_rms_norm"
    xg = torch.randn(3, 16, requires_grad=True)
    y = trms.rms_norm(xg, torch.ones(16))
    with pytest.raises(RuntimeError) as e:
        y.backward(torch.full((3, 16), float("nan")))
    assert _op(e.value) == "fused_rms_norm_grad"


def test_chip_naninf_phase_rehearsal(tmp_path):
    """``chip_smoke.naninf_phase`` on a tiny Llama on the CPU: nothing
    trips on finite weights, the eager forward and the compiled step name
    the same op for a NaN weight, the bundle is written (its gates would
    fail the script)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.tiny(num_hidden_layers=1, hidden_size=32,
                           intermediate_size=64, vocab_size=64)
    chip_smoke.naninf_phase(torch, np, torch.device("cpu"), "cpu", cfg=cfg,
                            batch=1, seq=8, dump_dir=str(tmp_path))
    assert naninf._T.mode is None
