"""Fused and multi-tensor optimizers, and the wrappers (counterpart of
``paddle_tpu/incubate/optimizer``): ``fused_adam_update``, the multi-tensor
Adam/AdamW update (``kernels/fused_adam.py``; on the card the ``mt_adam``
kernel of ``csrc/multi_tensor.cu``), which ``optimizer.Adam(
use_multi_tensor=True)`` and the train step call; ``LookAhead`` and
``ModelAverage`` (``:11-121``), eager, in the parameters' own dtype."""
import contextlib

import torch

from ...kernels.fused_adam import fused_adam_update  # noqa: F401


def _tensor(entry):
    """A parameter from a tensor or a ``(name, tensor)`` pair."""
    return entry[1] if isinstance(entry, tuple) else entry


class LookAhead:
    """paddle.incubate.LookAhead: ``k`` fast steps with the inner
    optimizer, then the slow weights move toward the fast ones by
    ``alpha`` and the fast weights are reset to them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step_count = 0
        self._slow = None

    def _params(self):
        return [p for _, p in self.inner_optimizer._all_params()]

    @torch.no_grad()
    def step(self):
        if self._slow is None:
            self._slow = [p.detach().clone() for p in self._params()]
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for i, p in enumerate(self._params()):
                slow = self._slow[i] + self.alpha * (p - self._slow[i])
                self._slow[i] = slow
                p.copy_(slow)

    def clear_grad(self, set_to_zero=False):
        self.inner_optimizer.clear_grad(set_to_zero)

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        sd = self.inner_optimizer.state_dict()
        sd["lookahead_slow"] = list(self._slow or [])
        sd["lookahead_step"] = self._step_count
        return sd


class ModelAverage:
    """paddle.incubate.ModelAverage: a running sum of the parameters
    (``step()``), whose mean :meth:`apply` swaps in (a context that
    restores on exit with ``need_restore``) and :meth:`restore` swaps
    out; a second apply without a restore raises."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        if parameters is None:
            raise ValueError("ModelAverage requires parameters")
        self._params = [_tensor(p) for p in parameters]
        self._sums = None
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        if self._sums is None:
            self._sums = [torch.zeros_like(p) for p in self._params]
        for i, p in enumerate(self._params):
            self._sums[i] = self._sums[i] + p
        self._count += 1

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        """Swap in the averaged weights; usable as ``with avg.apply():
        evaluate()``, which restores on exit when ``need_restore``."""

        @contextlib.contextmanager
        def _ctx():
            try:
                yield
            finally:
                if need_restore:
                    self.restore()

        if self._count:
            if self._backup is not None:
                raise RuntimeError(
                    "ModelAverage.apply called twice without restore()")
            self._backup = [p.detach().clone() for p in self._params]
            for p, s in zip(self._params, self._sums):
                p.copy_(s / float(self._count))
        return _ctx()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p, b in zip(self._params, self._backup):
            p.copy_(b)
        self._backup = None
