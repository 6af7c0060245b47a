#!/usr/bin/env python3
"""Train-step times of checkouts of the PyTorch/CUDA port, alternated.

Run on a machine with one NVIDIA H100 from the root of a checkout, with
other checkouts unpacked beside it (``git archive <commit> | tar -x -C
build/parent``):

    python3 tools/torch_step_ab.py build/parent . . build/parent

Each root in the order given runs in a process of its own (its kernels
built from its own sources): Llama-2-7B widths at 8 layers, fp32 weights
from seed 0, AdamW with the global-norm clip, B 2 x S 2048; five
``CompiledTrainStep`` steps fp32 (``amp_level=None``) and five AMP O1
bf16 steps, each from the seed's weights. It prints the card's name and
power limit, then one JSON line a root: the median of steps 2-5 in
seconds for each dtype (host clock around each step, synchronized).
"""
import json
import os
import statistics
import subprocess
import sys
import time


def _one(root):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         causal_lm_loss)
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=8)
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 2049))
    ids = torch.as_tensor(ids, device=dev)
    inputs, labels = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    out = {"root": root}
    for amp in (None, "O1"):
        net.reset_parameters(0)
        opt = AdamW(3e-4, parameters=net.named_parameters(),
                    weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
        step = CompiledTrainStep(
            net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt,
            amp_level=amp)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step([inputs], [labels])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[f"step_p50_s_{amp or 'fp32'}"] = statistics.median(times[1:])
        del step, opt
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        _one(sys.argv[2])
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
