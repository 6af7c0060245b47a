"""The two fusions' fp32 split designs, emulated on the CPU, against the
JAX package's fp32 kernels; and the design each fusion's wrapper picks.

On the card the fp32 fused RMSNorm + matmul and the fp32 rope-on-load
forward run "the split design": every fp32 operand as three bf16 parts
(hi, mid, lo), every product as the six bf16 products of parts, smallest
first, with fp32 accumulators. The CUDA kernels cannot run here, so
these tests emulate their order of work in plain PyTorch and hold it
against the JAX kernels in Pallas interpret mode (fed the same numpy
inputs) within the fp32 tolerance the card's checks use at small shapes:
1e-5 of the largest output entry, no slack. Seeded faults must each fall
outside it, so the tolerance does not hide a wrong order of work.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import fused_norm_matmul as jfnm  # noqa: E402
from paddle_tpu.kernels import fused_rope_attention as jfra  # noqa: E402
from paddle_tpu.kernels.rope import build_rope_cache  # noqa: E402
from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import fused_norm_matmul as tfnm  # noqa: E402
from paddle_tpu_torch.kernels import fused_rope_attention as tfra  # noqa
from test_torch_kernels import (SPLIT_TERMS, _emulate_split_flash,  # noqa
                                _one_thread, _parts)

TOL32 = 1e-5
# K rows of the split head kernel's k-tile (csrc/fused_norm_matmul.cu,
# namespace sp): each k-tile's six terms, over its two k-steps of 16,
# go into the accumulator before the next tile's
HEAD_KTILE = 32


def _ratio(got, want):
    """Largest error over the fp32 tolerance, 1e-5 of max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (TOL32 * np.abs(want).max()))


# ------------------------------------------- (a) the split fused head
def _emulate_split_head(x, w, wm, eps, fault=None):
    """The fp32 split head's order of work: rstd over the whole row in
    fp32, y = (x * rstd) * w in fp32 (nothing rounded), y and wm each as
    three bf16 parts, then per k-tile of HEAD_KTILE rows the six terms
    smallest first, each over the tile's k-steps of 16, summed into one
    fp32 accumulator. ``fault``: "no_hm" (the hi.mid term dropped),
    "y_one_part" (y as its bf16 hi part alone)."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    y = (xf * rstd) * w.float()
    py = _parts(y)
    if fault == "y_one_part":
        py = [py[0], torch.zeros_like(y), torch.zeros_like(y)]
    pw = _parts(wm.float())
    terms = tuple(t for t in SPLIT_TERMS if not (fault == "no_hm"
                                                  and t == (0, 1)))
    acc = torch.zeros(x.shape[0], wm.shape[1])
    for k0 in range(0, x.shape[1], HEAD_KTILE):
        for i, j in terms:
            for kk in range(k0, min(k0 + HEAD_KTILE, x.shape[1]), 16):
                acc = acc + py[i][:, kk:kk + 16] @ pw[j][kk:kk + 16]
    return acc


@functools.lru_cache(maxsize=None)
def _split_head_case():
    """The inputs (seed 20) and the JAX package's fp32 ``rms_norm_matmul``
    on them (interpret mode), computed once for the three cases."""
    rng = np.random.RandomState(20)
    rows, h, n = 64, 256, 512
    x = rng.randn(rows, h).astype(np.float32)
    w = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    wm = (0.05 * rng.randn(h, n)).astype(np.float32)
    want = np.asarray(jfnm.rms_norm_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(wm), eps=1e-5,
        block_rows=16, block_cols=128))
    return x, w, wm, want


def _split_head_ratio(fault):
    x, w, wm, want = _split_head_case()
    got = _emulate_split_head(*(torch.from_numpy(a) for a in (x, w, wm)),
                              1e-5, fault)
    return _ratio(got.numpy(), want)


@pytest.mark.parametrize("fault", [None, "no_hm", "y_one_part"])
def test_split_head_order_of_work_within_fp32_tolerance(fault):
    """The fp32 split head's order of work (emulated) lies within the
    fp32 tolerance of the JAX package's fp32 ``rms_norm_matmul`` (the
    Pallas kernel in interpret mode); dropping the hi.mid term, or taking
    the normed rows as one bf16 part, each falls outside it."""
    ratio = _split_head_ratio(fault)
    assert (ratio <= 1.0) == (fault is None), ratio


# --------------------------------- (b) the rotate-and-split forward
def _rotated(x, cos2, sin2, fault=None):
    """q or k ``[B, S, H, D]`` rotated in fp32 by ``_rotate`` (the
    pre-pass's op order). ``fault`` "hi_only": only the bf16 hi part is
    rotated, its mid and lo parts added back unrotated."""
    xt = x.transpose(1, 2).float()
    c, s = cos2[None, None], sin2[None, None]
    if fault == "hi_only":
        hi = xt.to(torch.bfloat16).float()
        out = tfra._rotate(hi, c, s) + (xt - hi)
    else:
        out = tfra._rotate(xt, c, s)
    return out.transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _rope_split_case():
    """The inputs (seed 21) and the JAX package's fp32
    ``rope_attention_fused`` on them (interpret mode), computed once for
    the three cases of ``_rope_split_ratio``."""
    rng = np.random.RandomState(21)
    b, s, h, d = 1, 160, 2, 64
    qn, kn = (4.0 * rng.randn(b, s, h, d).astype(np.float32)
              for _ in range(2))
    vn = rng.randn(b, s, h, d).astype(np.float32)
    cos, sin = build_rope_cache(s, d)
    want = np.asarray(jfra.rope_attention_fused(
        *(jnp.asarray(a) for a in (qn, kn, vn)), cos, sin, causal=True,
        block_q=32))
    return qn, kn, vn, cos, sin, want


def _rope_split_ratio(fault):
    """The emulated fp32 rope-on-load split design (q and k rotated and
    split, then flash attention's split forward: ``_emulate_split_flash``)
    against the JAX package's fp32 ``rope_attention_fused``. q and k have
    a standard deviation of 4, which sharpens the softmax and lets an
    error in the scores show in O."""
    qn, kn, vn, cos, sin, want = _rope_split_case()
    tcos, tsin = (torch.tensor(np.asarray(t))[0, :, 0] for t in (cos, sin))
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    rope_fault = fault if fault == "hi_only" else None
    o = _emulate_split_flash(_rotated(q, tcos, tsin, rope_fault),
                             _rotated(k, tcos, tsin, rope_fault), v,
                             torch.zeros_like(v), True,
                             "two_part" if fault == "two_part" else None)[0]
    return _ratio(o.numpy(), want)


@pytest.mark.parametrize("fault", [None, "hi_only", "two_part"])
def test_rope_split_order_of_work_within_fp32_tolerance(fault):
    """The fp32 rope-on-load split design's order of work (emulated: the
    rotation in fp32, three parts of the rotated q and k and of v, the
    split forward's tiles, online softmax and six products) lies within
    the fp32 tolerance of the JAX package's fp32 kernel (interpret mode);
    rotating only the bf16 hi part, or a two-part split, each falls
    outside it."""
    ratio = _rope_split_ratio(fault)
    assert (ratio <= 1.0) == (fault is None), ratio


# --------------------------------------- (c) the designs each picks
@pytest.mark.parametrize("rows", [1, 8, tfnm.SPLIT_MIN_ROWS - 1,
                                  tfnm.SPLIT_MIN_ROWS, 32, 64, 1024, 4096])
def test_head_design_by_dtype_and_rows(rows):
    """bf16 runs the tensor cores at every row count; fp32 the split
    design from SPLIT_MIN_ROWS rows, the CUDA cores below."""
    assert tfnm.design(torch.bfloat16, rows) == "tc"
    assert tfnm.design(torch.float32, rows) == (
        "split" if rows >= tfnm.SPLIT_MIN_ROWS else "cc")


@pytest.fixture
def fake_head(monkeypatch):
    """``rms_norm_matmul_cuda`` with the launches replaced by fakes that
    record which kernel ran and count as the real ones do (the counters
    start at zero and are restored after the test)."""
    for name in ("launches", *tfnm.DESIGN_COUNTERS):
        monkeypatch.setattr(tfnm, name, 0)
    ran = []

    def fake(kind):
        def run(x2, w, wm, eps, *which):
            ran.append((kind, *which))
            setattr(tfnm, "launches", tfnm.launches + 1)
            counter = f"{kind}_launches"
            setattr(tfnm, counter, getattr(tfnm, counter) + 1)
            return torch.zeros(x2.shape[0], wm.shape[1], dtype=x2.dtype)
        return run

    def checked(x, w, wm):
        h = int(x.shape[-1])
        return x.reshape(-1, h), h, int(wm.shape[1])

    monkeypatch.setattr(tfnm, "_checked", checked)
    for kind in ("tc", "split", "cc"):
        monkeypatch.setattr(tfnm, f"_{kind}_kernel", fake(kind))
    return ran


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [8, tfnm.SPLIT_MIN_ROWS, 4096])
def test_head_wrapper_counts_the_design_it_runs(fake_head, dtype, rows):
    """The wrapper runs the kernel its design names and counts it under
    that design (bf16 also by swap-AB or tiled kernel); with
    ``cuda_cores`` fp32 runs the CUDA-core kernels at any row count, and
    bf16 is refused; ``fusion_design_counts`` reports every counter."""
    dt = getattr(torch, dtype)
    x = torch.zeros(rows, 64, dtype=dt)
    w, wm = torch.ones(64, dtype=dt), torch.zeros(64, 24, dtype=dt)
    out = tfnm.rms_norm_matmul_cuda(x, w, wm)
    kind = tfnm.design(dt, x.shape[0])
    assert out.shape == (x.shape[0], 24)
    want = (kind,) if kind != "tc" else (
        kind, "swap" if x.shape[0] <= tfnm.SWAP_MAX_ROWS else "tiled")
    assert fake_head == [want]
    counts = kernels.fusion_design_counts()["rms_norm_matmul"]
    assert counts == {c: int(c == f"{kind}_launches")
                      for c in tfnm.DESIGN_COUNTERS}
    if dt == torch.float32:
        tfnm.rms_norm_matmul_cuda(x, w, wm, cuda_cores=True)
        assert fake_head[-1] == ("cc",)
        assert tfnm.launches == 2
    else:
        with pytest.raises(ValueError, match="CUDA-core kernels take"):
            tfnm.rms_norm_matmul_cuda(x, w, wm, cuda_cores=True)


@pytest.mark.parametrize("width", range(16, 257, 16))
def test_rope_attention_design_table(width):
    """Every padded head dim (and the head dim 8 below it): bf16 on the
    tensor cores at a padded 64 to 128, everything else (fp32 at every
    head dim, bf16 below 64 and above 128) on the split design; never the
    CUDA cores."""
    for d in (width - 8, width):
        assert tfra.design(torch.bfloat16, d) == (
            "tc" if 64 <= width <= 128 else "split")
        assert tfra.design(torch.float32, d) == "split"


@pytest.fixture
def fake_rope(monkeypatch):
    for name in ("launches", *tfra.DESIGN_COUNTERS):
        monkeypatch.setattr(tfra, name, 0)
    ran = []

    def launch(q, k, v, cos2, sin2, causal, scale, cuda_cores=False):
        ran.append((int(q.shape[-1]), cuda_cores))
        return torch.zeros_like(q)

    monkeypatch.setattr(tfra, "_launch", launch)
    monkeypatch.setattr(tfra, "_check_cuda", lambda *tensors: None)
    return ran


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64, 72, 96, 128, 256])
def test_rope_attention_wrapper_counts_the_design_it_runs(fake_rope, dtype,
                                                          d):
    """The wrapper counts each call under the design ``design`` names
    (``cuda_cores``: the CUDA cores), launching at the padded head dim."""
    dt = getattr(torch, dtype)
    q = torch.zeros(1, 8, 2, d, dtype=dt)
    cos, sin = (torch.zeros(8, d // 2) for _ in range(2))
    o = tfra.rope_attention_cuda(q, q, q, cos, sin)
    assert o.shape == q.shape and o.dtype == dt
    tfra.rope_attention_cuda(q, q, q, cos, sin, cuda_cores=True)
    padded = -(-d // 16) * 16
    assert fake_rope == [(padded, False), (padded, True)]
    kind = tfra.design(dt, d)
    counts = kernels.fusion_design_counts()["rope_attention"]
    assert tfra.launches == 2
    assert counts == {c: (c == f"{kind}_launches") + (c == "cc_launches")
                      for c in tfra.DESIGN_COUNTERS}


def test_reset_launch_counts_clears_the_split_counters(monkeypatch):
    for mod in (tfnm, tfra):
        monkeypatch.setattr(mod, "split_launches", 3)
    kernels.reset_launch_counts()
    counts = kernels.fusion_design_counts()
    assert counts["rms_norm_matmul"]["split_launches"] == 0
    assert counts["rope_attention"]["split_launches"] == 0


def test_split_head_workspace_holds_both_operands():
    """The split head's bf16 workspace: three parts of the normed rows
    (rows padded to a multiple of 8) and of the weight."""
    assert tfnm.split_workspace_elems(4096, 4096, 32000) == \
        3 * 4096 * (4096 + 32000)
    assert tfnm.split_workspace_elems(130, 520, 136) == 3 * 520 * (136 + 136)
