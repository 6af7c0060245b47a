"""Per-request sampling keys, addressed by what is sampled (counterpart
of ``paddle_tpu/serving/sampling_keys.py``).

The JAX scheme folds the admission index and then the cache position
into a threefry key. The port keeps the property, not the bits:

- ``request key`` = ``(seed, admission_index)``; the index is the
  engine-local admission counter, so two engines fed the same workload in
  the same order derive the same keys;
- ``position key`` = a 64-bit seed mixed (splitmix64) from the request
  key and the cache position ``j`` the sampled token will occupy
  (prefill samples ``j = prompt_len``, decode at ``pos`` samples
  ``j = pos + 1``);
- the token is drawn by Gumbel-max over the filtered logits, with the
  noise vector drawn from a ``torch.Generator`` seeded with the position
  key (Philox on a CUDA device).

So a sampled token is a function of (seed, admission index, position)
and of nothing else: not of the batch size, the row a request sits in,
or the interleaving of prefills and decode steps.

Speculative decoding draws from sub-streams of a position key: a
``purpose key`` mixes one of ``DRAFT``, ``ACCEPT`` or ``RESIDUAL`` below
the position key, so the undecorated position key stays the vanilla
stream, and :func:`uniform` draws the one uniform an acceptance test or
an inverse-CDF draw needs from such a key (a CPU ``torch.Generator``,
so the draw does not depend on the engine's device).
"""
from __future__ import annotations

import torch

_MASK = (1 << 64) - 1

# speculative purpose folds (any distinct constants, the JAX package's;
# mixed below the position key, so the undecorated position key IS the
# vanilla stream)
DRAFT = 0x5D
ACCEPT = 0x5E
RESIDUAL = 0x5F


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


class SamplingKeySource:
    """One request key per admitted request, off a master seed, in
    admission order."""

    def __init__(self, seed):
        self.seed = int(seed)
        self.next_index = 0

    def next_request_key(self):
        key = (self.seed, self.next_index)
        self.next_index += 1
        return key


def position_key(request_key, position):
    """The 63-bit generator seed that samples the token landing at cache
    ``position`` of the request with ``request_key``."""
    seed, index = request_key
    x = _splitmix64(int(seed) & _MASK)
    x = _splitmix64(x ^ (int(index) & _MASK))
    x = _splitmix64(x ^ (int(position) & _MASK))
    return x >> 1


def purpose_key(request_key, position, purpose):
    """A speculative sub-stream (``DRAFT``, ``ACCEPT`` or ``RESIDUAL``)
    at one position: disjoint from the vanilla stream by construction."""
    return _splitmix64(
        (position_key(request_key, position) ^ int(purpose)) & _MASK) >> 1


def uniform(key):
    """One uniform in [0, 1) from a 63-bit key (a position or purpose
    key), drawn on the host."""
    gen = torch.Generator()
    gen.manual_seed(int(key))
    return float(torch.rand((), generator=gen, dtype=torch.float64))


def gumbel_noise(keys, vocab, device):
    """``[len(keys), vocab]`` fp32 Gumbel noise: row ``b`` is
    ``-log(-log(u))`` of the uniforms a generator seeded with the
    position key of ``keys[b]``, a (request_key, position) pair, draws
    on ``device``. Each row is drawn and transformed alone, so it does
    not depend on the other rows."""
    rows = []
    for key in keys:
        gen = torch.Generator(device=device)
        gen.manual_seed(position_key(*key))
        u = torch.rand((vocab,), generator=gen, device=device)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows)


def sample_rows(scaled, keys):
    """One token per row of the filtered fp32 logits ``scaled`` [B, V]:
    Gumbel-max with row ``b``'s noise from its (request_key, position)
    pair ``keys[b]`` (:func:`gumbel_noise`). A row whose key is None (a
    free engine row) gets 0."""
    b, v = (int(n) for n in scaled.shape)
    out = torch.zeros((b,), dtype=torch.long, device=scaled.device)
    live = [i for i, key in enumerate(keys) if key is not None]
    if live:
        rows = torch.tensor(live, device=scaled.device)
        noise = gumbel_noise([keys[i] for i in live], v, scaled.device)
        out[rows] = torch.argmax(scaled[rows] + noise, dim=-1)
    return out
