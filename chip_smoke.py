#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports neither jax nor ``paddle_tpu``. Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build: every ``paddle_tpu_torch/csrc/*.cu`` compiled with nvcc for
   sm_90a, seconds and library path printed;
3. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the Llama-2-7B shapes of the serving, training and
   quantized-serving paths, in bf16 and fp32 (flash attention: both on
   the tensor-core kernels at every head dim, fp32 through split
   products, above head dim 128 on pairs of CTAs), with the tolerance
   stated per
   kernel, and timed (CUDA events, median) beside its bound, its plain
   version and, where one PyTorch call computes the same function, that
   call (flash attention also beside the CUDA-core design wherever the
   tensor-core kernels replaced it, and fails unless faster; the W8A16
   matmul: beside the composed
   dequantize-then-``torch.matmul``, the float weight's
   ``torch.matmul``, the CUDA-core kernels on the same bf16 inputs, and
   ``torch._weight_int8pack_mm`` where this PyTorch runs it; with a
   sweep of its two tensor-core kernels over 16-512 rows, and paged
   attention over chunks of 16-256 slots); the backward kernels, the
   W8A16 matmul and paged attention must repeat bit for bit; flash
   attention and paged attention also at head dims 16, 80, 96, 256 and
   72 (not a multiple of 16: the wrappers pad it; flash also 32, 64, 160
   and 192, and fp32 at 16, 64, 80, 96, 160, 192 and 256), paged
   attention also with 32 query heads on one kv head and one 8192-slot
   row at groups of 4 and 8; the library's empty kernel, timed the same
   way (the launch floor); the four multi-tensor optimizer kernels
   (``csrc/multi_tensor.cu``: ``mt_sumsq``, ``mt_adam``, ``mt_momentum``,
   ``mt_lamb``) at the training model's parameter list (75 fp32 tensors,
   1.881B elements) and on odd sizes, an empty tensor and an unaligned
   slice in fp32 and bf16, through every prologue (unscale, the three
   clips, L2, L1, the skip flag): ``mt_adam`` and ``mt_momentum`` bit for
   bit, ``mt_sumsq`` within 1e-6 relative and bit-equal on a repeat (also
   over a list mixing fp32 and bf16), ``mt_lamb`` within 1e-6 of the
   tensor's largest |p| (bf16 one ulp) and bit-equal on a repeat (also
   with no norm, every tensor in stats slot 0); timed beside their bound,
   the plain versions, ``torch._foreach_norm``, ``torch._fused_adamw_``
   and ``torch._fused_sgd_``;
4. small parity: tiny fp32 Llamas on the card (MHA, GQA, and head dims
   96 with MQA, 80 with GQA, 72 with GQA, 16 with 16 query heads on one
   kv head),
   whose paged-engine and slab-engine greedy streams (through their
   programs, CUDA graphs) must equal ``generate`` with an
   fp32 slab cache token for token; then the MHA and GQA models quantized
   (``quantize_for_serving``), whose paged and slab engines' streams
   with an int8 cache must equal ``generate(cache_dtype="int8")``;
5. tiny train parity: a 2-layer fp32 Llama takes one
   ``CompiledTrainStep`` on the card and the same step on the CPU (the
   plain versions) from the same weights; the loss and every parameter
   after the step must agree; then the same for each optimizer case of
   the optimizer sub-phase (below; the scaler case two steps, the
   overflowing one and an update, its scaler state equal), each case's
   multi-tensor launches counted;
6. training: Llama-2-7B widths with 8 of its 32 layers (1.88B fp32
   parameters from a seeded generator), AdamW with weight decay 0.01, a
   linear warmup and global-norm clipping at 1.0, AMP O1 bf16, 10 steps
   on one fixed batch of 2 x 2048 tokens; every loss finite, the last
   below the first, and every training kernel launched the number of
   times per step the model's structure gives (flash attention all on
   its tensor-core kernels); then (after the fused steps below) the same
   model reset to its seed takes 3 steps with ``amp_level=None``, the
   trainer's default, fp32 end to end, under the same checks (flash
   attention all on its tensor-core design: split products), with step
   time and peak memory; then, reset again, 3 fp32 steps with both
   fusions (below); per step the optimizer layer is three ``mt_sumsq``
   launches (chunks, per-tensor sums, finalize) and one ``mt_adam`` launch
   (75 tensors, one table each); then the optimizer sub-phase: the model
   reset to its seed for each of SGD, Momentum with Nesterov and L2 decay,
   Lamb with the global-norm clip, Lamb with no clip, Lamb with
   ``ClipGradByValue``, Adam with ``ClipGradByNorm``, AdamW with
   ``ClipGradByValue`` and an ``L2Decay`` group (two update calls a step),
   and AdamW with the global-norm clip under a ``GradScaler`` (a summed
   loss, initial scale 2^127: the first step overflows and must leave every
   parameter and moment bit-equal and the step count at 0; the scale and
   counts are checked after every step), 3 O1 steps each: every loss
   finite, every launch count exact, step time and peak memory printed
   (``optimizer <case>: {...}``);
7. serving: Llama-2-7B at full width and depth (random bf16 weights
   from a seeded generator) served by two ``PagedServingEngine``s (8
   rows, 2048 slots, page size 16, bf16 arena each): one through its
   fixed-shape programs (CUDA graphs, the default; ``warmup()`` first
   must capture 17 programs, a second call none) and one with
   ``graphs=False`` (eager), 12 staggered requests of 64 new tokens
   through each in the order eager, graphs, eager, graphs; every run's
   streams must equal the first's token for token, every run must
   launch the counts the structure gives (RMSNorm 65 and rope 32 a
   forward, paged attention 32 a decode step; a replay counts the
   launches its capture recorded), the graph engine must capture
   nothing during traffic, no page may leak, and every generated token
   must pass a teacher-forced check against the cache-free forward
   (which attends through the flash attention kernel); ITL, decode step
   time, ``decode_s``, TTFT, prefill tokens/s, peak memory and
   ``warmup()``'s seconds and memory are printed for both modes;
8. quantized serving: the same Llama-2-7B weights through
   ``quantize_for_serving`` (int8 weights, W8A16 kernel) and the same 12
   requests through two ``PagedServingEngine``s with an int8 KV arena
   (the graph engine warmed first), in the order eager, graphs; the
   int8 paged attention and the W8A16 kernels must have launched the
   counts the structure gives (32 and 6 x 32 + 1 per decode step, 193
   per prefill) in both, every W8A16 launch on its tensor-core design
   (bf16), the streams must be equal, no page may leak, and every
   generated token must pass
   a teacher-forced check against one slab prefill of the whole
   sequence with an int8 cache (the same quantization, composed
   attention).

The float fusions (``LlamaForCausalLM.fusions``) add: their two kernels
to phase 3 (timed also beside the unfused pair of kernels they replace;
bf16 on their tensor-core designs, fp32 (the 4096-row training head, the
rope-on-load forward at head dims 64, 80, 96, 128, 256 and a ragged S
1000) and the bf16 rope-on-load forward at head dims 32 and 256 on their
split designs, timed also beside the CUDA-core kernels they replaced,
which they must beat; each case holding the design counter; the fused
attention's backward (the rope and flash kernels composed in fp32) at
bf16 and fp32 head dim 128 and fp32 256, against the plain VJP on the
card, bit for bit on a repeat, and timed beside it;
the fused head also swept over 16-512 rows: its swap-AB and tiled
kernels and the unfused pair in bf16, and over 16-512 and 4096 rows in
fp32: the split design, the CUDA-core kernels and the unfused pair);
a fused tiny fp32 Llama's logits on the card against the CPU after phase
4; after phase 6, the same model reset to its seed, 3 O1 steps with both
fusions (step-1 loss within 1e-3 of the unfused one, the last loss below
the first, per step the fused attention 8 on its tensor-core design and
its backward 8, each one rope, one rope backward, one flash forward and
one flash backward launch (all flash on the tensor-core design), the
fused head 1 on its split design (fp32 under O1), RMSNorm 16 + 16),
and, after the fp32 steps, 3 fp32 steps with both fusions (step-1 loss
within 1e-5 of the unfused fp32 one, the same launches, both fusions on
their split designs; ``fused fp32 training: {...}``); after phase 7,
the same model and engines
with both fusions serving the same 12 requests, graphs then eager (the
graph engine's decode and prefill programs are captured again at their
first use: one decode step and one prefill per bucket used; per decode
step the fused head 1, on its tensor-core design at every decode step
and prefill, RMSNorm 64, rope 32, paged attention 32; equal streams; no
page leak)
and its teacher-forced check through the fused cache-free forward (the
fused attention 32 times a sequence, no flash), with the count of tokens
that differ from the unfused streams printed.

The paged engine's prefix cache (``prefix_cache=True``) adds: after
phase 4, the prefix parity: a tiny fp32 GQA Llama on a prefix engine
(graphs, warmed: 23 programs) of 2 rows x 64 slots and 12 pages of 8,
with an fp32 arena, a bf16 arena and, after ``quantize_for_serving``,
an int8 one, through traffic that forces 3 full-page hits, a
copy-on-write clone, a second turn over decode-published pages,
evictions and one ``pages_exhausted`` shed; the fp32 and int8 streams
must equal ``generate`` token for token (the shed one its prefix), the
pages the warm admissions share must keep their bytes, nothing may be
captured during traffic, and the arena must drain after ``close()``;
decode-published KV against one prefill of the same tokens is printed
(bit-equal or the largest difference); after the fused serving, the
prefix phase: the serving phase's graph engine (warmed again) as the
cold twin, a prefix engine with graphs (``warmup()`` must capture 61
programs: 17, a gather per bucket and a chunk prefill per (bucket, tail
bucket)) and one with ``graphs=False``, 22 requests over a 1024-token
prefix (16 first turns with tails of 16-256 tokens, 4 second turns over
a first turn's answer, and the first 1000 and 1001 prefix tokens, which
force a clone), in the order cold, prefix graphs, prefix eager, prefix
graphs, the cache flushed before each prefix run: the prefix streams
must be equal, every token must pass the teacher-forced check, every
run must launch RMSNorm 65 and rope 32 a forward (a decode step, a
prefill or a chunk prefill) and paged attention 32 a decode step,
nothing may be captured during traffic, each prefix run must hit on 21
requests and save at least 21 x 992 tokens, and the arenas must drain
after a flush; warm and cold prefill p50, TTFT, ITL, ``decode_s``, peak
and shared pages, ``warmup()``'s cost, the tokens that differ from the
cold twin and decode-published KV against one prefill are printed (the
latter also for the quantized model in phase 8, measured, not gated).

Speculative decoding (``SpeculativeDecoder``) and beam search add:
after the prefix parity, the spec parity: the same tiny fp32 GQA Llama
with an fp32, a bf16 and an int8 cache, on the slab engine and on the
paged engine with demand paging (pages of 4; graphs, warmed), with the
early exit at layer 1 of 2 and with a separate 1-layer draft (k 3, 4),
beside the vanilla engine of the same kind and cache: fp32 speculative
streams must equal vanilla token for token, and the paged ones in every
cache, whose verify rows must equal the vanilla rows at the same
positions bit for bit (the slab's rows are printed); bf16 and int8
tokens must pass the teacher-forced check, the slab's int8 verify must
be the sequential one, nothing may be captured during traffic and the
paged pools must drain after rollbacks (at least one); the last-layer
exit must accept every proposal; sampled fp32 streams must be equal on
slab and paged; a tiny fp32 beam search (B 2, 3 beams) on the card must
equal the CPU's, with and without an EOS, whose freeze must hold. After
the prefix phase, the beam phase: ``generate`` on the 7B model with B 2,
4 beams, prompt 128 and 64 new tokens beside greedy, ms a step printed,
and the freeze with the winning beam's first token as EOS; then the spec
phase: a paged engine with demand paging and ``SpeculativeDecoder(
exit_layer=e, k=4)`` (``warmup()`` must capture 33 programs: 17, a
draft prefill per bucket and a draft decode per row; the verify is one
replay of the decode program) beside the serving phase's graph
engine, for two legs: random weights with the exit at 8, then the same
model with ``o_proj`` and ``down_proj`` zeroed from layer 4 on (layers
4-31 add exact zeros, so the exit at 4 is a perfect draft); each leg
runs 4 requests of 512 prompt and 128 new tokens one after another,
then 8 at once, through both engines; gates: every run finishes with
nothing captured and the arena drained, the speculative runs launch
RMSNorm, rope and paged attention the counts the structure gives (a
verify is one decode step, a draft step one forward of the exit
layers), every speculative stream equals the vanilla one token for
token, every verify row equals the vanilla row bit for bit, and every
speculative token passes the teacher-forced check; printed: acceptance,
ITL p50, the round's time, tokens/s per request, ``decode_s``, pages
claimed and rolled back, the warmup, and one replay of the decode
program (the verify) and of the draft decode (CUDA events). The
``kernels`` line's ``launches_by_phase`` gains ``spec_parity``,
``spec_serving`` and ``beam``.

Sessions and the KV spill tier add, after the prefix phase, the session
phase: two paged prefix engines with ``sessions=True`` on arenas of 400
pages (3.36 GB at 7B), one with a 4 GiB host spill tier and one that
evicts outright, beside the serving phase's graph engine as the cold
reference, 16 conversations of 3 turns over a 512-token system prompt
(32-192 user tokens and 64 new a turn, seed 2468) in two waves of 8
that alternate turn by turn, every engine on the tier engine's prompts;
gates: every turn finishes, the launches follow the structure, nothing
is captured during traffic, the tier spilled and restored pages with no
refused payload and its first restores read back bit-equal, every token
passes the teacher-forced check, the stores count 16 sessions and 48
turns, and the arenas drain; printed: TTFT p50 and p90 of turns 2-3,
ITL, hits, tokens saved, spills, restores, a spill's and a restore's
milliseconds, peak pages, the stores' stats, the tokens that differ
from the cold streams by turn, and the cached KV of wave A's first
turns against one prefill (the chunk-written and the decode-written
spans apart). ``launches_by_phase`` gains ``session_serving``. After
every ``warmup()`` a ``... memory_report:`` line gives the engine's
program count, the largest capture peak, the graph pool growth summed
and the five largest programs.

Checkpoints, live reload and ``generate``'s programs add: after the
training phase, the checkpoint phase (Llama-2-7B widths at 2 layers,
fp32, AdamW, B 2 x S 2048: the depth is cut so that a checkpoint holds
about 8 GB): 6 steps with a ``CheckpointManager`` (async saves, a save
every 2 steps, the last 2 kept) attached to the trainer, and a
synchronous host copy right after step 2; gates: step 2's committed
checkpoint equals that copy bit for bit although steps 3-4 updated the
tensors in place meanwhile, the launches follow the structure; printed:
save, blocked and snapshot seconds, bytes, the write rate and the
seconds of ``verify_checkpoint(level="full")``; then the trained net
publishes into running engines: a warmed bf16 paged engine of the same
architecture serves 8 requests, serves them again while
``prepare_reload`` of the newest (fp32) checkpoint runs on another thread
(the streams must not change), and has one more in flight when
``commit_reload`` runs; gates: the in-flight request's tokens
equal its pre-swap stream, the post-swap streams equal a fresh engine's
on the trained net cast to bf16 token for token, and no program is
captured again and the parameters keep their addresses; then the same
for a quantized engine (int8 weights and arena) through a bf16
``template_net``, against a fresh quantized engine; printed: prepare
seconds (verify, read, copy), the pause and the swap's copy, and
``torch.cuda.mem_get_info()``; then step 6's checkpoint is torn and a
fresh trainer's ``restore_or_init()`` falls back to step 4 and takes
steps 5-6 (gate: its losses within 1e-6 relative of the uninterrupted
run's; printed: the largest parameter difference and whether the steps
were bit-equal); the checkpoint root is deleted and the free disk space
printed before and after. The beam phase runs
``generate``'s greedy, sampled (temperature 0.8, top_p 0.9, seed 7) and
beam modes each with ``graphs=False`` and as its program (one CUDA graph
of the whole prefill and decode a signature); gates: the programs'
tokens equal the eager loop's, a repeated signature captures nothing;
printed: ms a step of both, the capturing call's seconds and the growth
of reserved memory over it, and the greedy and beam graphs' node counts; the tiny beam of the spec
parity also runs its program. After the spec phase, the full-depth
reload: the serving phase's graph engine reloads a 13.5 GB bf16
checkpoint of a second net (seed 1) that a fresh engine served first and
a ``CheckpointManager`` saved; gates: the 12 serving requests' streams
equal the fresh engine's and nothing is captured again; printed: the
save, the prepare split into verify, read and host-to-device copy, the
swap's copy and the peak memory during staging. ``launches_by_phase``
gains ``checkpoint`` and ``full_reload``.

Observability: the trainer publishes into the process
``StepMeter``; the O1 and fp32 training legs each read a fresh meter
(``training step meter: {...}``, ``fp32 training step meter: {...}``:
``paddle_training_mfu`` against the card's bf16 dense peak, tokens/s,
the device memory gauges; gates: every step observed, the first as
warmup, 0 < MFU <= 1, and for O1 the meter's step_time p50 within 5% of
the phase's synced p50). The checkpoint phase's manager publishes into
the process registry (gate: its ``paddle_ckpt_*`` series in the
exposition). After the bf16 serving modes, the front-end phase
(``frontend (...)`` lines) puts the warmed 7B graph engine behind
``ServingFrontend(eng, port=0)`` on 127.0.0.1: the 12 serving prompts as
12 concurrent SSE streams, each with a client ``traceparent`` (gates:
every stream ends ``done``; tokens equal the in-process run's, or each
differing one passes the teacher-forced check; the kernels' launches by
formula; ``/metrics`` parses, wire TTFT counts 12, wire ITL the tokens
less 12, the ``slo_class="interactive"`` TTFT child 12; ``/trace`` holds
``engine.queue_wait``, ``engine.prefill`` and ``engine.decode`` under
the client's span, the decode ring one event a step; ``/healthz``
``memory`` equals ``memory_report()``, ``compile_entries`` unchanged,
no guard fire), then backpressure (a burst past ``max_queue_size`` while
8 long streams hold every row: 429 ``queue_full``; a prompt past
``max_seq_len``: 413) and the drain (503 ``draining`` while an in-flight
stream finishes), ``driver_errors`` empty; printed: wire TTFT and ITL
p50/p90 beside the engine's, the scrape's bytes and ms, each leg's
seconds; then the 12 requests in process with tracing sampled at 1 and
at 0, alternated three times each (ITL p50 of each run).
``launches_by_phase`` gains ``frontend``.

The fleet and the resilient training runtime add, after the checkpoint
phase, the resilience phase (``resilience: {...}``, the checkpoint
phase's 2-layer fp32 AdamW model, a batch of its own each step): a skip
with ``sync=True`` and a NaN through ``train.loss`` at step 3 (gate: the
parameters and moments equal a run that never took batch 3, bit for
bit), a skip with ``sync=False`` (the detection lag in steps, printed), a
rollback of a NaN at step 5 to the commit of step 4 through
``run_resilient`` (gate: the losses and every parameter and moment equal
the uninterrupted run's, bit for bit), and a started ``TrainWatchdog``
(``stall_seconds`` 2: a 3 s block at ``train.step_begin`` fires
``wedged_step`` once, with a flight bundle; a 3 s stall reported through
``note_blocked`` fires none); every trainer call launches the training
kernels by formula. After the fused serving, the fleet phase (``fleet
(...)`` lines): (a) a ``PrefillWorker`` over the 7B net, its programs
captured before traffic by ``launch._warmup``, and a graph engine with
``prefill_transport=RemotePrefillClient``: the 12 serving requests all
remote, their streams equal the serving phase's graph run, launches by
formula, nothing captured in traffic, the adopted pages of the shortest
and the longest prompt bit-equal to a local prefill's; bytes and seconds
per transfer and TTFT against the graph run printed; the worker stopped,
one fallback and the stream unchanged; (c) two prefix-cache engines
behind ``ServingFrontend``s and a ``FleetRouter``: 12 SSE streams through
the router equal the graph run, both replicas serve, 6 same-prefix
requests converge on one replica (5 prefix hits there), ``/metrics``
carries the per-replica series; wire TTFT and ITL printed beside the
front end's; (d) the fleet as the README starts it: ``launch.spawn``
children on the card (a prefill worker, two replicas attached to it, a
router, at 7B widths with 4 layers and 128 positions): streams through
the router equal an in-process engine over the same seeded weights, a
replica SIGKILLed mid-stream ends that stream ``replica_failed`` while
unstarted requests complete on the survivor, which leaks no page, and
every other child exits 0 on SIGTERM. After the quantized phase, the
fleet's int8 leg: 4 requests through a worker and a disaggregated int8
engine, streams equal the quantized graph engine's, adopted codes and
scales bit-equal. ``launches_by_phase`` gains ``fleet``, ``fleet_int8``
and ``resilience``; the script's total seconds are printed.

fp16, the eager optimizers and the NaN/Inf sweep add: to phase 3, the
fp16 kernel cases (``fp16_kernel_cases``: RMSNorm and rope forward and
backward, flash attention forward and backward at the training shapes,
and ``mt_sumsq`` / ``mt_adam`` over the 75 tensors with fp16 parameters
and gradients, each against its plain version in fp16 on the card; the
fp16 flash forward at head dim 256 checked, its backward refused naming
ROADMAP.md queue B; an inf gradient must set the skip flag and leave
every parameter and moment bit-equal); after the optimizer sub-phase of
phase 6: ``fp16 training`` (the training model, O1 fp16 with JAX's
``GradScaler`` defaults, 10 steps: every loss finite after the scaler's
first skips, step 1's loss within FP16_LOSS_RTOL of the bf16 O1 step 1,
the structure's launch counts with rope and flash attention all on fp16
tensors), ``eager optimizer <case>`` (each eager-only optimizer,
``LookAhead`` and a ``ModelAverage`` for 3 eager O1 bf16 steps beside
the multi-tensor AdamW: finite losses, one parameter's update on the
card equal to a CPU copy's, the average applied and restored bit for
bit; LBFGS on the 2-layer model: finite, lower), ``fp16 O2 (decorate)``
(the README's eager O2 path, 3 steps: every RMSNorm, rope and flash
launch fp16 and the fp16 multi-tensor launches the scaler's skips give),
then ``naninf`` (``FLAGS_check_nan_inf`` on the 2-layer model: step p50
with the flag off and on, nothing trips on finite weights; a NaN weight
makes the eager forward and the compiled step name the same op, the
flight recorder writes a ``naninf`` bundle, and with the flag off the
step runs through). The kernels line gains the fp16 kernels
(``<kernel>_fp16``, their launches the fp16 counters'), and
``launches_by_phase`` gains ``fp16_training``, ``fp16_o2``,
``eager_optimizers`` and ``naninf``.

AMP O3 and PTQ/QAT add: to phase 3, the fp8 kernels
(``csrc/fp8_matmul.cu``, ``fp8_kernel_cases``): ``fp8_gemm`` in its
three forms (forward e4m3 . e4m3, dX e5m2 . e4m3, dW e4m3 . e5m2) at
each O3 shape of the 7B step (M 4096 tokens: q/k/v/o, gate_up, down,
lm_head) and a ragged one, each entry within the fp32 summation bound
``K 2^-24 sum |a b| sa sb`` plus half a bf16 ulp of its plain version
(TF32 off), bit-equal on a repeat, timed beside its bound (the fp8 dense
peak), the plain version, ``torch._scaled_mm`` and a bf16
``torch.matmul`` of the same shape; ``fp8_quantize``'s codes (both
layouts) bit-equal to the plain version's and its amax exact, for fp32,
bf16 and fp16 into e4m3 and e5m2, and each of the step's launches timed
beside its bound; to phase 5, ``tiny o3 parity`` (one O3 step of the
tiny model on the card and on the CPU: the loss, the gradients before
the update and the parameters after it within TINY_O3_* tolerances, the
fp8 launch counts); to phase 6, right after the O1 steps, ``o3
training`` (the model reset to its seed, 5 AdamW steps under
``amp_level="O3"`` with the O1 batch, schedule and clip: every loss
finite and within its step's limit of O1's, 3% while O1's loss falls and
O3_LOSS_RTOL_LATE after, which a warmed-history run must also pass and
a control without the gradient's scale must fail; 98 histories with one
non-zero amax a step each, the
``fp8_bytes_saved`` gauge equal to the linear weights' element count,
the launch counts of O3_PER_STEP (``fp8_gemm`` 3 and ``fp8_quantize`` 4
a linear a step), flash on its tensor-core kernels; step time beside
O1's, peak memory and the step meter printed); to phase 8, the quantized
model is built through PTQ (``ptq_build``: a type config of
``AbsmaxObserver`` and ``PerChannelAbsmaxObserver`` on each Linear, two
calibration prompts, ``convert``; each layer's int8 weight and scales
from its frozen scales bit-equal to a direct quantization, checked one
layer at a time) before ``quantize_for_serving``. The kernels line gains
``fp8_gemm`` and ``fp8_quantize``, and ``launches_by_phase`` gains
``o3_training`` and ``o3_tiny_parity``.

``--profile-steps N`` profiles N replays of the spec phase's decode
program (its verify) and draft decode, and N decode steps after each serving phase
(the graph engine's, and the bf16 and quantized eager engines'), with
the graph's replay also timed by CUDA events, and one 1024-bucket
prefill (three times) of the bf16, the fused and the quantized model;
and it breaks the front end's decode step down (``frontend profile``
line, ``frontend_profile``): the time inside ``step()``, the gap between
steps and the device's idle share, in process and behind the front end,
with and without per-token writer threads and with the clients in this
process or a child one.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth, and the
# operation rate for each input type (bf16 on the tensor cores, fp32 on
# the CUDA cores), the two floors every kernel here is held against; a
# kernel of flash attention's fp32 split design is held against its
# products on the tensor cores: every fp32 product is six bf16 products,
# so its operations count at a sixth of the bf16 rate
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float32_split": 989e12 / 6, "float8": 1979e12}

# teacher-forced check: a generated token that is not the argmax of the
# cache-free forward's logits must trail it by less than this many
# logits (8 bf16 ulps at |logit| in [2, 4), where ulp = 2^-6; the two
# paths round scores, probabilities and activations at different places)
NEAR_TIE = 0.125

# kernel tolerances (absolute, on max |kernel - plain| over the output):
# - rms_norm / rope, bf16: one bf16 ulp of the largest output, 2^-7 *
#   max|plain| (the sum of squares is reduced in another order, so rstd
#   may differ in the last fp32 bit and flip one rounding); fp32:
#   1e-5 * max|plain| (rsqrtf is within 2 ulp, the order differs);
# - paged attention, float and int8 arenas: bf16 1e-2 (scores are summed
#   in another order, so a probability may round to the neighbouring bf16
#   value before the value product); fp32 1e-5 (fp32 sums over up to 2048
#   slots in another order). Both sides dequantize an int8 row the same
#   way, float(q) * scale in fp32.
# - the W8A16 matmul: cast once (below), fp32 1e-5 * max|plain| (both
#   sides take the same dequantized weight and sum up to 11008 fp32
#   products in another order).
# - the backward kernels and flash attention (both sides compute in fp32
#   and cast once): fp32 1e-5 * max|plain| for O, RMSNorm dx and rope,
#   1e-4 * max|plain| for sums over thousands of rows that cancel
#   (RMSNorm dw, flash dQ/dK/dV); LSE 1e-5 * max|plain|. bf16 holds EACH
#   entry: |kernel_i - plain_i| <= 2^-7 * |plain_i| (at least one bf16
#   ulp of that entry, under two) + the fp32 tolerance (the fp32 values
#   before the cast differ by that much, so the cast may round them one
#   ulp apart; at the bottom of a binade that comes to just under the
#   entry's tolerance). bf16 flash attention (the tensor-core kernels)
#   rounds P before the value product and dV, and dS before dK and dQ,
#   as the plain version and the stock Pallas kernel do, but the kernel
#   rounds the unnormalised P of each tile: each bf16 entry also gets
#   the slack of rounding at other points, 2^-7 times the product of
#   absolute values (``flash_attention.probability_rounding_slack``).
# - the fused RMSNorm + matmul and rope + attention: cast once with the
#   1e-4 fp32 tolerance (products over K = 4096, attention over up to
#   2048 keys). The fused head rounds its normed row to x's dtype BEFORE
#   the product, and the kernel's rstd (its own sum of squares) can send
#   an entry near a rounding midpoint the other way: each bf16 entry also
#   gets that entry's slack, the sum over such k of ulp(y_k) * |wm_kn|
#   (``fused_norm_matmul.normed_rounding_slack``, for rstd within 2^-20
#   relative; zero in fp32). The bf16 rope-on-load kernel (tensor cores)
#   splits the rotated q and k and P into bf16 hi and lo parts: each bf16
#   entry also gets what those split products may move it by
#   (``fused_rope_attention.split_product_slack``).
# - fp16 as bf16 with its own ulp: 2^-10 of the entry (11 significant
#   bits); flash attention's slack also covers P or dS entries that fp16
#   flushes below 2^-24 on one side and not the other.
REL_TOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10, "float32": 1e-5}
PAGED_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
SUM_TOL32 = 1e-4

# the training phase: Llama-2-7B widths, 8 of 32 layers (fp32 parameters,
# gradients and two Adam moments of the full depth take 16 B x 6.74B =
# 108 GB, more than the card's 80 GB; 8 layers take 30 GB), B 2 x S 2048
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 2048, 10

# tiny train parity on the card against the CPU: the loss within 1e-5
# relative and every parameter within 1e-5 absolute after one AdamW step
# (fp32 math in other orders; epsilon 1e-3 keeps the update a smooth
# function of the gradient, so a gradient that differs by 1e-7 moves its
# parameter by about as much instead of flipping a sign near zero)
TINY_LOSS_RTOL, TINY_PARAM_ATOL = 1e-5, 1e-5


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def gpu_time_ms(torch, fn, n=20, repeats=7):
    """Median device time of one call of ``fn``: ``n`` calls queued
    behind a sleep kernel (so the host's launch overhead hides behind
    it and the calls run back to back), timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(bytes_moved, flops, dtype):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the card's peak rate for ``dtype`` (a FLOP_PER_S key:
    the inputs' dtype, or the design's rate)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def cast_once(name, got, want, tol32, dname, slack=None):
    """The check of an output that both sides compute in fp32 and cast
    once: fp32 within ``tol32 * max|want|``; bf16 entry by entry within
    2^-7 of the entry plus that fp32 tolerance. ``slack`` (per entry)
    adds what the inputs' own rounding before the product may move an
    entry by (the fused head's normed row)."""
    if dname == "float32":
        return name, got, want, tol32, None, slack
    return name, got, want, REL_TOL[dname], tol32, slack


def checks(torch, pairs):
    """[{output, max_abs_err, tolerance, err_over_tol}] for (name, got,
    want, rel, floor[, slack]): with ``floor`` None every entry is held
    to ``rel * max|want|``; else entry i to ``rel * |want_i| + floor *
    max|want|``; a per-entry ``slack`` is added to either. ``tolerance``
    is the largest entry's tolerance. ``err_over_tol`` is the largest
    ratio of an entry's error to its tolerance (a check passes at <= 1).
    Returns the checks and the tightest one, whose numbers the case
    reports."""
    out = []
    for n, g, w, rel, floor, *extra in pairs:
        slack = extra[0] if extra else None
        err = (g.float() - w.float()).abs()
        ref = w.float().abs()
        top = float(ref.max())
        if floor is None and slack is None:
            tol = rel * top
            ratio = float(err.max()) / max(tol, 1e-30)
        else:
            tol_i = rel * top if floor is None else rel * ref + floor * top
            if slack is not None:
                tol_i = tol_i + slack
            tol = float(tol_i.max())
            ratio = float((err / tol_i).max())
        out.append({"output": n, "max_abs_err": float(err.max()),
                    "tolerance": tol, "err_over_tol": ratio,
                    "per_entry": floor is not None})
    worst = max(out, key=lambda c: c["err_over_tol"])
    return out, worst


def grad_time_ms(torch, outputs, inputs, grads, n=5, repeats=5):
    """Device time of the autograd backward of a graph built once."""
    return gpu_time_ms(torch, lambda: torch.autograd.grad(
        outputs, inputs, grads, retain_graph=True), n=n, repeats=repeats)


# ------------------------------------------------------------ kernels
def rms_norm_cases(torch, mod, dev):
    out = []
    g = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (8, 1024):
            h = 4096
            x = torch.randn(rows, h, generator=g, device=dev).to(dtype)
            w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(dtype)
            y = mod.rms_norm_cuda(x, w, 1e-5)
            ref = mod.rms_norm_reference(x, w, 1e-5)
            dname = str(dtype).replace("torch.", "")
            tol = REL_TOL[dname] * float(ref.float().abs().max())
            es = x.element_size()
            b_ms, b_by = bound(2 * rows * h * es + h * w.element_size(),
                               4 * rows * h, dname)
            out.append({
                "shape": [rows, h], "dtype": dname,
                "max_abs_err": max_err(torch, y, ref), "tolerance": tol,
                "ms": gpu_time_ms(torch, lambda: mod.rms_norm_cuda(
                    x, w, 1e-5)),
                "plain_ms": gpu_time_ms(torch, lambda: mod.rms_norm_reference(
                    x, w, 1e-5)),
                "library_ms": gpu_time_ms(
                    torch, lambda: torch.nn.functional.rms_norm(
                        x, (h,), w, 1e-5)),
                "bound_ms": b_ms, "bound_by": b_by,
            })
    return out


def rope_cases(torch, mod, dev):
    out = []
    g = torch.Generator(device=dev).manual_seed(2)
    cos_full, sin_full = mod.build_rope_cache(2048, 128, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        # decode: [8, 1, 32, 128] per-row positions into the full table
        # (the continuous-batching step); prefill: [1, 1024, 32, 128]
        # with a shared table of 1024 rows
        pid = torch.tensor([[0], [15], [300], [777], [1024], [1500],
                            [2000], [2047]], dtype=torch.int32, device=dev)
        for b, s, tabs, ids in (
                (8, 1, (cos_full, sin_full), pid),
                (1, 1024, (cos_full[:, :1024], sin_full[:, :1024]), None)):
            q = torch.randn(b, s, 32, 128, generator=g, device=dev).to(dtype)
            k = torch.randn(b, s, 32, 128, generator=g, device=dev).to(dtype)
            cos, sin = tabs
            qo, ko = mod.rope_cuda(q, k, cos, sin, ids)
            rq = mod.rope_reference(q, cos, sin, ids)
            rk = mod.rope_reference(k, cos, sin, ids)
            err = max(max_err(torch, qo, rq), max_err(torch, ko, rk))
            tol = REL_TOL[dname] * max(float(rq.float().abs().max()),
                                       float(rk.float().abs().max()))
            es = q.element_size()
            tab_rows = b * s if ids is not None else s
            nbytes = (4 * q.numel() * es + 2 * tab_rows * 64 * 4
                      + (ids.numel() * 4 if ids is not None else 0))
            b_ms, b_by = bound(nbytes, 3 * 2 * q.numel(), dname)
            out.append({
                "shape": [b, s, 32, 128], "dtype": dname,
                "tables": "per-row ids" if ids is not None else "shared",
                "max_abs_err": err, "tolerance": tol,
                "ms": gpu_time_ms(torch, lambda: mod.rope_cuda(
                    q, k, cos, sin, ids)),
                "plain_ms": gpu_time_ms(torch, lambda: (
                    mod.rope_reference(q, cos, sin, ids),
                    mod.rope_reference(k, cos, sin, ids))),
                "library_ms": None,
                "bound_ms": b_ms, "bound_by": b_by,
            })
    return out


# the 7B decode step's rows: 8 rows at these positions of 2048 slots
DECODE_POS = (0, 15, 300, 777, 1024, 1500, 2000, 2047)
# paged attention cases: (q dtype, query heads, kv heads, head_dim, live
# slots of each row) over a page-16 arena. The 7B decode shape first (the
# main path's), in bf16 and fp32, with GQA kvH 8; head dims 16, 256, 80
# and 96; one 8192-slot row at kvH 8 with Llama-3-8B's group of 4 and
# Llama-2-70B's of 8 (past the earlier design's shared-memory cap); MQA
# with 32 query heads on one kv head; and head dim 72 at group 4 (not a
# multiple of 16: the arena's rows are staged in smaller pieces).
PAGED_SHAPES = (
    ("bfloat16", 32, 32, 128, DECODE_POS),
    ("float32", 32, 32, 128, DECODE_POS),
    ("bfloat16", 32, 8, 128, DECODE_POS),
    ("float32", 32, 8, 128, DECODE_POS),
    ("bfloat16", 32, 32, 16, DECODE_POS),
    ("bfloat16", 32, 32, 256, DECODE_POS),
    ("bfloat16", 32, 32, 80, DECODE_POS),
    ("bfloat16", 32, 32, 96, DECODE_POS),
    ("bfloat16", 32, 8, 128, (8191,)),
    ("bfloat16", 64, 8, 128, (8191,)),
    ("bfloat16", 32, 1, 128, DECODE_POS),
    ("bfloat16", 32, 8, 72, DECODE_POS),
)


def paged_inputs(torch, dev, dtype, kvh, g, d=128, h=32, positions=None):
    positions = DECODE_POS if positions is None else positions
    b, ps = len(positions), 16
    width = (max(positions) + ps) // ps
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    n_pages = b * width + 1
    k_pages = torch.randn(n_pages, ps, kvh, d, generator=g,
                          device=dev).to(dtype)
    v_pages = torch.randn(n_pages, ps, kvh, d, generator=g,
                          device=dev).to(dtype)
    # the garbage page holds large values: a kernel that read it inside
    # a row's live range would be far off the plain version
    k_pages[0] = 1e4
    v_pages[0] = 1e4
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    table = perm.reshape(b, width).to(torch.int32)
    live = (pos.long() // ps + 1)[:, None]
    cols = torch.arange(width, device=dev)[None, :]
    table = torch.where(cols < live, table, torch.zeros_like(table))
    q = torch.randn(b, 1, h, d, generator=g, device=dev).to(dtype)
    return q, k_pages, v_pages, table.contiguous(), pos


def paged_bound(pos, q, kvh, d, kv_bytes, dname):
    """(bound_ms, bound_by) of one paged attention call: each live slot's
    K and V rows of every kv head read once (``kv_bytes`` per row: D
    values, and an int8 row's 4-byte scale), q read and the output
    written once, the live table entries and pos read; 4 flops per live
    slot, query head and head dim column (q . k and p v)."""
    slots = int((pos.long() + 1).sum())
    h = int(q.shape[2])
    nbytes = (2 * slots * kvh * kv_bytes + 2 * q.numel() * q.element_size()
              + int((pos.long() // 16 + 1).sum()) * 4 + 4 * int(pos.numel()))
    return bound(nbytes, 4 * slots * h * d, dname)


def paged_cases(torch, mod, dev):
    out = []
    g = torch.Generator(device=dev).manual_seed(3)
    for dname, h, kvh, d, positions in PAGED_SHAPES:
        dtype = getattr(torch, dname)
        q, kp, vp, tbl, pos = paged_inputs(torch, dev, dtype, kvh, g, d, h,
                                           positions)
        o = mod.paged_attention_cuda(q, kp, vp, tbl, pos)
        ref = mod.paged_attention_reference(q, kp, vp, tbl, pos)
        if not torch.isfinite(o).all():
            fail("paged attention kernel produced non-finite values")
        if not torch.equal(o, mod.paged_attention_cuda(q, kp, vp, tbl, pos)):
            fail(f"paged attention {dname} H {h} kvH {kvh} D {d} does not "
                 f"repeat bit for bit")
        b_ms, b_by = paged_bound(pos, q, kvh, d, d * q.element_size(), dname)
        out.append({
            "shape": {"q": list(q.shape), "pages": list(kp.shape),
                      "pos": [int(p) for p in pos]},
            "dtype": dname, "heads": h, "kv_heads": kvh, "head_dim": d,
            "repeats_bitwise": True,
            "max_abs_err": max_err(torch, o, ref),
            "tolerance": PAGED_TOL[dname],
            "ms": gpu_time_ms(torch, lambda: mod.paged_attention_cuda(
                q, kp, vp, tbl, pos)),
            "plain_ms": gpu_time_ms(
                torch, lambda: mod.paged_attention_reference(
                    q, kp, vp, tbl, pos), n=5, repeats=5),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
        })
        del q, kp, vp, o, ref
    torch.cuda.empty_cache()
    return out


def rms_norm_bwd_cases(torch, mod, dev, dtypes=None):
    """[4096, 4096]: the 7B training batch's rows (2 x 2048) at hidden
    4096, fp32 (the O1 residual stream the norms see) and bf16 (or
    ``dtypes``)."""
    out = []
    g = torch.Generator(device=dev).manual_seed(7)
    rows, h = TRAIN_BATCH * TRAIN_SEQ, 4096
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        x = torch.randn(rows, h, generator=g, device=dev).to(dtype)
        w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(dtype)
        gy = torch.randn(rows, h, generator=g, device=dev).to(dtype)
        _, rstd = mod.rms_norm_cuda(x, w, 1e-5, return_rstd=True)
        dx, dw = mod.rms_norm_backward_cuda(x, w, gy, rstd)
        rdx, rdw = mod.rms_norm_backward_reference(x, w, gy, rstd)
        dx2, dw2 = mod.rms_norm_backward_cuda(x, w, gy, rstd)
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            fail(f"rms_norm backward {dname} does not repeat bit for bit")
        cs, worst = checks(torch, [
            cast_once("dx", dx, rdx, REL_TOL["float32"], dname),
            cast_once("dw", dw, rdw, SUM_TOL32, dname)])
        es = x.element_size()
        b_ms, b_by = bound(3 * rows * h * es + 2 * h * es + 4 * rows,
                           10 * rows * h, dname)
        xl = x.clone().requires_grad_(True)
        wl = w.clone().requires_grad_(True)
        yl = torch.nn.functional.rms_norm(xl, (h,), wl, 1e-5)
        out.append({
            "shape": [rows, h], "dtype": dname, "checks": cs,
            "max_abs_err": worst["max_abs_err"],
            "tolerance": worst["tolerance"],
            "err_over_tol": worst["err_over_tol"], "repeats_bitwise": True,
            "ms": gpu_time_ms(torch, lambda: mod.rms_norm_backward_cuda(
                x, w, gy, rstd)),
            "plain_ms": gpu_time_ms(
                torch, lambda: mod.rms_norm_backward_reference(
                    x, w, gy, rstd)),
            "library_ms": grad_time_ms(torch, yl, (xl, wl), gy, n=20,
                                       repeats=7),
            "library_call": "autograd backward of F.rms_norm",
            "bound_ms": b_ms, "bound_by": b_by,
        })
        del xl, wl, yl
    return out


def rope_bwd_cases(torch, mod, dev, dtypes=None, inverse=True):
    """The training shape: q and k gradients [2, 2048, 32, 128] bf16 (or
    ``dtypes``) with the shared [1, 2048, 1, 64] table; with ``inverse``
    False the forward rotation of q and k at that shape."""
    g = torch.Generator(device=dev).manual_seed(8)
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, 32, 128
    cos, sin = mod.build_rope_cache(s, d, device=dev)
    plain = mod.rope_backward_reference if inverse else mod.rope_reference
    out = []
    for dtype in dtypes or (torch.bfloat16,):
        dname = str(dtype).replace("torch.", "")
        gq = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
        gk = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
        dq, dk = mod.rope_cuda(gq, gk, cos, sin, inverse=inverse)
        rq = plain(gq, cos, sin)
        rk = plain(gk, cos, sin)
        names = ("dq", "dk") if inverse else ("q", "k")
        cs, worst = checks(torch, [
            cast_once(names[0], dq, rq, REL_TOL["float32"], dname),
            cast_once(names[1], dk, rk, REL_TOL["float32"], dname)])
        es = gq.element_size()
        b_ms, b_by = bound(4 * gq.numel() * es + 2 * s * (d // 2) * 4,
                           3 * 2 * gq.numel(), dname)
        out.append({
            "shape": [b, s, h, d], "dtype": dname, "tables": "shared",
            "checks": cs, "max_abs_err": worst["max_abs_err"],
            "tolerance": worst["tolerance"],
            "err_over_tol": worst["err_over_tol"],
            "ms": gpu_time_ms(torch, lambda: mod.rope_cuda(
                gq, gk, cos, sin, inverse=inverse)),
            "plain_ms": gpu_time_ms(torch, lambda: (
                plain(gq, cos, sin), plain(gk, cos, sin))),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
        })
    return out


# the int8 arena at the float flavour's shapes (q bf16 and fp32)
PAGED_INT8_SHAPES = (
    ("bfloat16", 32, 32, 128, DECODE_POS),
    ("float32", 32, 32, 128, DECODE_POS),
    ("bfloat16", 32, 8, 128, DECODE_POS),
    ("float32", 32, 8, 128, DECODE_POS),
    ("bfloat16", 32, 32, 80, DECODE_POS),
    ("bfloat16", 32, 32, 96, DECODE_POS),
    ("bfloat16", 32, 8, 128, (8191,)),
    ("bfloat16", 64, 8, 128, (8191,)),
    ("bfloat16", 32, 1, 128, DECODE_POS),
    ("bfloat16", 32, 8, 72, DECODE_POS),
)


def paged_int8_cases(torch, mod, dev):
    """Kernel A at the decode shapes of the float flavour: arenas made in
    fp32 (garbage page 0 at 1e4) and quantized with quantize_kv; q bf16
    and fp32."""
    from paddle_tpu_torch.quantization.kv import QuantizedKV, quantize_kv

    out = []
    g = torch.Generator(device=dev).manual_seed(4)
    for dname, h, kvh, d, positions in PAGED_INT8_SHAPES:
        dtype = getattr(torch, dname)
        q, kp, vp, tbl, pos = paged_inputs(torch, dev, torch.float32, kvh, g,
                                           d, h, positions)
        q = q.to(dtype)
        kq, vq = QuantizedKV(*quantize_kv(kp)), QuantizedKV(*quantize_kv(vp))
        del kp, vp
        o = mod.paged_attention_int8_cuda(q, kq, vq, tbl, pos)
        ref = mod.paged_attention_reference(q, kq, vq, tbl, pos)
        if not torch.isfinite(o).all():
            fail("int8 paged attention kernel produced non-finite values")
        if not torch.equal(o, mod.paged_attention_int8_cuda(q, kq, vq, tbl,
                                                            pos)):
            fail(f"int8 paged attention {dname} H {h} kvH {kvh} D {d} does "
                 f"not repeat bit for bit")
        b_ms, b_by = paged_bound(pos, q, kvh, d, d + 4, dname)
        out.append({
            "shape": {"q": list(q.shape), "pages": list(kq.q.shape),
                      "scales": list(kq.scale.shape),
                      "pos": [int(p) for p in pos]},
            "dtype": dname, "heads": h, "kv_heads": kvh, "head_dim": d,
            "arena": "int8", "repeats_bitwise": True,
            "max_abs_err": max_err(torch, o, ref),
            "tolerance": PAGED_TOL[dname],
            "ms": gpu_time_ms(torch, lambda: mod.paged_attention_int8_cuda(
                q, kq, vq, tbl, pos)),
            "plain_ms": gpu_time_ms(
                torch, lambda: mod.paged_attention_reference(
                    q, kq, vq, tbl, pos), n=5, repeats=5),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
        })
        del q, kq, vq, o, ref
    torch.cuda.empty_cache()
    return out


PAGED_SWEEP_CHUNKS = (16, 32, 64, 128, 256)


def paged_chunk_sweep(torch, mod, dev):
    """Paged attention's time at chunks of 16..256 slots and at the
    wrapper's own choice (``chunk_slots``), both flavours with a bf16 q
    over the shapes above, each output within the paged tolerance of the
    plain version: the evidence for ``chunk_slots``. One row per
    shape."""
    from paddle_tpu_torch.quantization.kv import QuantizedKV, quantize_kv

    own = mod.chunk_slots
    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    shapes = [("bf16", *c[1:]) for c in PAGED_SHAPES if c[0] == "bfloat16"]
    shapes += [("int8", *c[1:]) for c in PAGED_INT8_SHAPES
               if c[0] == "bfloat16"]
    try:
        for arena, h, kvh, d, positions in shapes:
            dt = torch.float32 if arena == "int8" else torch.bfloat16
            q, kp, vp, tbl, pos = paged_inputs(torch, dev, dt, kvh, g, d, h,
                                               positions)
            if arena == "int8":
                kp = QuantizedKV(*quantize_kv(kp))
                vp = QuantizedKV(*quantize_kv(vp))
                q = q.bfloat16()
            ref = mod.paged_attention_reference(q, kp, vp, tbl, pos)
            row = {"arena": arena, "heads": h, "kv_heads": kvh,
                   "head_dim": d, "rows": len(positions),
                   "own_chunk": own(16, d, 1 if arena == "int8" else 2,
                                    h // kvh), "ms": {}}
            for chunk in (None, *PAGED_SWEEP_CHUNKS):
                mod.chunk_slots = own if chunk is None else (
                    lambda *a, c=chunk: c)
                o = mod.paged_attention(q, kp, vp, tbl, pos)
                if max_err(torch, o, ref) > PAGED_TOL["bfloat16"]:
                    fail(f"paged chunk sweep {row} chunk {chunk}: "
                         f"{max_err(torch, o, ref)}")
                row["ms"][str(chunk or "own")] = gpu_time_ms(
                    torch, lambda: mod.paged_attention(q, kp, vp, tbl, pos))
            rows.append(row)
            del q, kp, vp, ref
    finally:
        mod.chunk_slots = own
    torch.cuda.empty_cache()
    return rows


# W8A16 shapes: the 7B decode step's four weight shapes at 8 rows (q/k/v/o,
# gate+up, down, lm_head) and three prefill buckets (64, 256, 1024 rows)
INT8_MM_SHAPES = ((8, 4096, 4096), (8, 4096, 22016), (8, 11008, 4096),
                  (8, 4096, 32000), (64, 4096, 4096), (256, 4096, 22016),
                  (1024, 4096, 22016))
# weight copies cycled through so that every timed call reads its weight
# from device memory, not from the 50 MB L2 (as each layer's projection
# does in a decode step)
L2_FLUSH_BYTES = 120 * 2 ** 20


def launch_floor(torch, dev, results):
    """The library's empty kernel, launched through the same ctypes path
    and timed the same way as every kernel (back to back, CUDA events):
    the floor under any launch's time, beside the two smallest kernels'
    main-path times (RMSNorm and rope at the decode shape)."""
    from paddle_tpu_torch.kernels import _build

    ms = gpu_time_ms(torch, lambda: _build.launch_empty(dev))
    rows = {name: results[name][0]["ms"] for name in ("rms_norm", "rope")}
    return {"empty_kernel_ms": ms,
            "main_case_ms": rows,
            "main_case_over_floor": {k: v / ms for k, v in rows.items()}}


def cycled(fns):
    """One call of the next function of ``fns`` per call, round robin."""
    state = [0]

    def call():
        fns[state[0] % len(fns)]()
        state[0] += 1
    return call


def int8pack_ms(torch, x, wqs, sc, n_t):
    """``torch._weight_int8pack_mm`` (one PyTorch call: x times an int8
    ``[N, K]`` weight, scaled per column AFTER the product) on transposed
    copies of the weights, timed as a yardstick of time only (it rounds
    otherwise, so it is no parity oracle): ``(ms, None)``, or ``(None,
    why)`` where this PyTorch does not run it on the card."""
    try:
        wts = [w.t().contiguous() for w in wqs]
        s = sc.to(x.dtype)
        torch._weight_int8pack_mm(x, wts[0], s)
        torch.cuda.synchronize()
    except Exception as e:  # a yardstick this PyTorch lacks
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    ms = gpu_time_ms(torch, cycled([
        (lambda wt=wt: torch._weight_int8pack_mm(x, wt, s)) for wt in wts]),
        n=n_t)
    del wts
    return ms, None


def int8_matmul_cases(torch, mod, dev):
    """Kernel B at the decode and prefill shapes against its plain version:
    bf16 x on the tensor-core design (the kernel its row count selects:
    swap-AB up to SWAP_MAX_ROWS, tiled above), fp32 x on the CUDA-core
    one. Timed beside the composed dequantize-then-matmul, the float
    weight's torch.matmul in x's dtype (the float path's cost), and for
    bf16 torch._weight_int8pack_mm where it runs, each over enough
    weight copies to miss in L2."""
    out = []
    g = torch.Generator(device=dev).manual_seed(10)
    for rows, h, n in INT8_MM_SHAPES:
        w = torch.randn(h, n, generator=g, device=dev) * 0.02
        wq, sc = mod.quantize_weight(w)
        del w
        copies = max(1, -(-L2_FLUSH_BYTES // wq.numel()))
        wqs = [wq] + [wq.clone() for _ in range(copies - 1)]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            kernel = ("cc" if mod.design(dtype) == "cc" else
                      "swap" if rows <= mod.SWAP_MAX_ROWS else "tiled")
            x = torch.randn(rows, h, generator=g, device=dev).to(dtype)
            y = mod.int8_matmul_cuda(x, wq, sc)
            ref = mod.int8_matmul_reference(x, wq, sc)
            if not torch.isfinite(y).all():
                fail(f"int8 matmul {dname} {[rows, h, n]} produced "
                     f"non-finite values")
            if not torch.equal(y, mod.int8_matmul_cuda(x, wq, sc)):
                fail(f"int8 matmul {dname} {[rows, h, n]} does not repeat "
                     f"bit for bit")
            cs, worst = checks(torch, [
                cast_once("out", y, ref, REL_TOL["float32"], dname)])
            del y, ref
            es = x.element_size()
            # the int8 weight, its scales, x and the output, once each
            b_ms, b_by = bound(h * n + 4 * n + rows * (h + n) * es,
                               2 * rows * h * n, dname)
            fcopies = max(1, -(-L2_FLUSH_BYTES // (h * n * es)))
            wfs = [mod._dequant(wq, sc, dtype) for _ in range(fcopies)]
            n_t = 20 if rows <= 16 else 5
            ms = gpu_time_ms(torch, cycled([
                (lambda wi=wi: mod.int8_matmul_cuda(x, wi, sc))
                for wi in wqs]), n=n_t)
            plain = gpu_time_ms(torch, lambda: mod.int8_matmul_reference(
                x, wq, sc), n=3, repeats=5)
            composed = gpu_time_ms(torch, cycled([
                (lambda wi=wi: torch.matmul(x, mod._dequant(wi, sc, dtype)))
                for wi in wqs]), n=n_t)
            float_mm = gpu_time_ms(torch, cycled([
                (lambda wf=wf: torch.matmul(x, wf)) for wf in wfs]), n=n_t)
            del wfs
            extra = {}
            if kernel != "cc":
                # the library's one call
                lib, why = int8pack_ms(torch, x, wqs, sc, n_t)
                extra.update(library_ms=lib,
                             library_call="torch._weight_int8pack_mm "
                                          "(scales after the product)",
                             library_unavailable=why)
            out.append(dict({
                "shape": {"rows": rows, "h": h, "n": n}, "dtype": dname,
                "design": mod.design(dtype), "kernel": kernel,
                "checks": cs, "max_abs_err": worst["max_abs_err"],
                "tolerance": worst["tolerance"],
                "err_over_tol": worst["err_over_tol"],
                "repeats_bitwise": True, "weight_copies": copies,
                "ms": ms, "plain_ms": plain, "library_ms": None,
                "composed_ms": composed,
                "composed_call": "dequantize, then torch.matmul",
                "float_matmul_ms": float_mm,
                "float_matmul_call": f"torch.matmul of the {dname} weight",
                "bound_ms": b_ms, "bound_by": b_by,
            }, **extra))
            del x
        del wq, sc, wqs
        torch.cuda.empty_cache()
    return out


# the crossover of the two tensor-core W8A16 kernels: bf16 x of each
# prefill bucket's row count through each kernel at each of the 7B
# model's projection shapes (q/k/v/o, gate+up, down, lm_head), weights
# cycled past the L2
CROSSOVER_ROWS = (16, 32, 64, 128, 256, 512)
CROSSOVER_SHAPES = ((4096, 4096), (4096, 22016), (11008, 4096),
                    (4096, 32000))


def int8_crossover(torch, mod, dev):
    """ms of the swap-AB and tiled kernels (and the float weight's
    torch.matmul) at each row count and shape; the swap-AB kernel takes
    up to SWAP_MAX_ROWS rows. Each kernel's output is held within
    cast-once of the plain version and must repeat bit for bit."""
    g = torch.Generator(device=dev).manual_seed(15)
    out = []
    for h, n in CROSSOVER_SHAPES:
        wq, sc = mod.quantize_weight(
            0.02 * torch.randn(h, n, generator=g, device=dev))
        wqs = [wq] + [wq.clone()
                      for _ in range(L2_FLUSH_BYTES // wq.numel())]
        wfs = [mod._dequant(wq, sc, torch.bfloat16)
               for _ in range(-(-L2_FLUSH_BYTES // (2 * h * n)))]
        rows_out = []
        for rows in CROSSOVER_ROWS:
            x = torch.randn(rows, h, generator=g, device=dev).bfloat16()
            ref = mod.int8_matmul_reference(x, wq, sc)
            rec = {"rows": rows}
            for kernel in ("swap", "tiled"):
                if kernel == "swap" and rows > mod.SWAP_MAX_ROWS:
                    continue
                y = mod._tc_kernel(x, wq, sc, kernel)
                what = f"int8 matmul {kernel} {[rows, h, n]}"
                if not torch.equal(y, mod._tc_kernel(x, wq, sc, kernel)):
                    fail(f"{what} does not repeat bit for bit")
                _, worst = checks(torch, [cast_once(
                    "out", y, ref, REL_TOL["float32"], "bfloat16")])
                if worst["err_over_tol"] > 1.0:
                    fail(f"{what}: largest error over its entry's "
                         f"tolerance {worst['err_over_tol']}")
                rec[f"{kernel}_err_over_tol"] = worst["err_over_tol"]
                rec[f"{kernel}_ms"] = gpu_time_ms(torch, cycled([
                    (lambda wi=wi: mod._tc_kernel(x, wi, sc, kernel))
                    for wi in wqs]))
            rec["float_matmul_ms"] = gpu_time_ms(torch, cycled([
                (lambda wf=wf: torch.matmul(x, wf)) for wf in wfs]))
            rows_out.append(rec)
            del x, ref
        out.append({"shape": {"h": h, "n": n}, "rows": rows_out})
        del wq, sc, wqs, wfs
        torch.cuda.empty_cache()
    return {"swap_max_rows": mod.SWAP_MAX_ROWS, "shapes": out}


def _visible_pairs(sq, sk, causal):
    """(row, key) pairs a head attends: all of them, or the causal
    bottom-right triangle."""
    if not causal:
        return sq * sk
    return sum(min(sk, r + (sk - sq) + 1) for r in range(sq))


def _library_attention(torch, q, k, v, causal):
    """F.scaled_dot_product_attention on [B, H, S, D] views, with the
    bottom-right causal mask for Sq != Sk."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sq, sk = int(q.shape[1]), int(k.shape[1])
    if causal and sq != sk:
        from torch.nn.attention.bias import causal_lower_right

        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=causal_lower_right(sq, sk))
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)


FLASH_SHAPES = (
    # dtype, causal, batch, sq, sk, head_dim (heads 32): the training
    # shape in bf16 (O1) and fp32 (the trainer's default; split products
    # on the tensor cores), a chunk of 512 queries over 2048 keys
    # (bottom-right causal), a ragged causal S 1000, a non-causal Sq 1024
    # over Sk 1000, head dims 64, 16 and 32 (the 64-wide kernels) and
    # 256 (bf16 on the tensor cores both ways; fp32 through split
    # products on pairs of CTAs)
    ("bfloat16", True, TRAIN_BATCH, 2048, 2048, 128),
    ("float32", True, TRAIN_BATCH, 2048, 2048, 128),
    ("bfloat16", True, TRAIN_BATCH, 512, 2048, 128),
    ("bfloat16", True, 1, 1000, 1000, 128),
    ("bfloat16", False, 1, 1024, 1000, 128),
    ("bfloat16", True, TRAIN_BATCH, 2048, 2048, 64),
    ("bfloat16", True, TRAIN_BATCH, 2048, 2048, 16),
    ("bfloat16", True, TRAIN_BATCH, 2048, 2048, 32),
    ("bfloat16", True, TRAIN_BATCH, 2048, 2048, 256),
    ("float32", True, TRAIN_BATCH, 2048, 2048, 64),
    ("float32", True, TRAIN_BATCH, 2048, 2048, 16),
    ("float32", True, TRAIN_BATCH, 2048, 2048, 256),
    # head dims on the padded kernels: 80 and 96 (128 wide), 160 and 192
    # (256 wide)
    ("bfloat16", True, TRAIN_BATCH, 2048, 2048, 80),
    ("bfloat16", True, TRAIN_BATCH, 2048, 2048, 96),
    ("float32", True, TRAIN_BATCH, 2048, 2048, 80),
    ("float32", True, TRAIN_BATCH, 2048, 2048, 96),
    ("bfloat16", True, TRAIN_BATCH, 2048, 2048, 160),
    ("bfloat16", True, TRAIN_BATCH, 2048, 2048, 192),
    ("float32", True, TRAIN_BATCH, 2048, 2048, 160),
    ("float32", True, TRAIN_BATCH, 2048, 2048, 192),
    # head dim 72: not a multiple of 16, zero-padded to 80 by the wrapper
    ("bfloat16", True, TRAIN_BATCH, 2048, 2048, 72),
)


def _replaced_cc(mod, dtype, d, backward):
    """Whether the tensor-core design now runs a case that ran on the CUDA
    cores until the split design (fp32 at every D, bf16 below D 64, the
    bf16 backward above D 128): such a case is also timed on the CUDA
    cores (``cuda_core_ms``), in the same run."""
    pd = mod.padded_head_dim(d)
    return mod.design(dtype, d, backward) == "tc" and (
        dtype.itemsize == 4 or pd < 64 or (backward and pd > 128))


def _flash_bound(mod, dtype, dname, d, backward, bytes_moved, flops):
    """The case's bound: bf16 on the tensor cores, fp32 on the design it
    runs (split products: six bf16 products each; CUDA cores); fp32 rows
    also carry the CUDA-core bound."""
    split = dname == "float32" and mod.design(dtype, d, backward) == "tc"
    rate = "float32_split" if split else dname
    b_ms, b_by = bound(bytes_moved, flops, rate)
    out = {"bound_ms": b_ms, "bound_by": b_by, "bound_rate": rate}
    if dname == "float32":
        out["bound_cuda_core_ms"] = bound(bytes_moved, flops, "float32")[0]
    return out


def flash_cases(torch, mod, dev, shapes=FLASH_SHAPES):
    """Both flash kernels at H 32 and the shapes above (or ``shapes``):
    returns (forward cases, backward cases). bf16 and fp16 entries also
    get the slack of rounding P and dS at other points than the plain
    version (the tensor-core kernels round the unnormalised P tile by
    tile)."""
    fwd, bwd = [], []
    h = 32
    g = torch.Generator(device=dev).manual_seed(9)
    for dname, causal, b, sq, sk, d in shapes:
        dtype = getattr(torch, dname)
        design = mod.DESIGNS[mod.design(dtype, d)]
        bwd_design = mod.DESIGNS[mod.design(dtype, d, backward=True)]
        q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
        do = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
        o, lse = mod.flash_attention_cuda(q, k, v, causal)
        ro, rlse = mod.flash_attention_reference(q, k, v, causal)
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            fail(f"flash forward {dname} produced non-finite values")
        o_slack, slacks = mod.probability_rounding_slack(q, k, v, lse, o, do,
                                                         causal)
        cs, worst = checks(torch, [
            cast_once("o", o, ro, REL_TOL["float32"], dname, o_slack),
            ("lse", lse, rlse, 1e-5, None)])
        cs[0]["slack_max"] = float(o_slack.max())
        del ro, rlse, o_slack
        pairs = _visible_pairs(sq, sk, causal) * b * h
        es = q.element_size()
        shape = {"b": b, "h": h, "d": d, "sq": sq, "sk": sk,
                 "causal": causal}
        fb_bound = _flash_bound(
            mod, dtype, dname, d, False,
            es * b * h * d * (2 * sq + 2 * sk) + 4 * b * h * sq,
            4 * d * pairs)
        ms = gpu_time_ms(torch, lambda: mod.flash_attention_cuda(
            q, k, v, causal), n=5, repeats=5)
        cc_ms = None
        if _replaced_cc(mod, dtype, d, False):
            cc_ms = gpu_time_ms(torch, lambda: mod.flash_attention_cuda(
                q, k, v, causal, cuda_cores=True), n=2, repeats=3)
        plain = gpu_time_ms(torch, lambda: mod.flash_attention_reference(
            q, k, v, causal), n=3, repeats=3)
        lib = gpu_time_ms(torch, lambda: _library_attention(
            torch, q, k, v, causal), n=5, repeats=5)
        fwd.append({"shape": shape, "dtype": dname, "design": design,
                    "checks": cs,
                    "max_abs_err": worst["max_abs_err"],
                    "tolerance": worst["tolerance"],
                    "err_over_tol": worst["err_over_tol"], "ms": ms,
                    "cuda_core_ms": cc_ms,
                    "plain_ms": plain, "library_ms": lib,
                    "library_call": "F.scaled_dot_product_attention",
                    **fb_bound})

        grads = mod.flash_attention_backward_cuda(q, k, v, o, lse, do, causal)
        again = mod.flash_attention_backward_cuda(q, k, v, o, lse, do, causal)
        if not all(torch.equal(a, c) for a, c in zip(grads, again)):
            fail(f"flash backward {dname} does not repeat bit for bit")
        del again
        want = mod.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                      causal)
        cs, worst = checks(torch, [
            cast_once(n, gr, w, SUM_TOL32, dname, sl)
            for n, gr, w, sl in zip(("dq", "dk", "dv"), grads, want, slacks)])
        for c, sl in zip(cs, slacks):
            c["slack_max"] = float(sl.max())
        if not all(torch.isfinite(gr).all() for gr in grads):
            fail(f"flash backward {dname} produced non-finite values")
        del want, grads, slacks
        bb_bound = _flash_bound(
            mod, dtype, dname, d, True,
            es * b * h * d * (4 * sq + 4 * sk) + 4 * b * h * sq,
            10 * d * pairs)
        ms = gpu_time_ms(torch, lambda: mod.flash_attention_backward_cuda(
            q, k, v, o, lse, do, causal), n=3, repeats=5)
        cc_ms = None
        if _replaced_cc(mod, dtype, d, True):
            cc_ms = gpu_time_ms(
                torch, lambda: mod.flash_attention_backward_cuda(
                    q, k, v, o, lse, do, causal, cuda_cores=True),
                n=1, repeats=3)
        plain = gpu_time_ms(
            torch, lambda: mod.flash_attention_backward_reference(
                q, k, v, o, lse, do, causal), n=2, repeats=3)
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
        lo = _library_attention(torch, ql, kl, vl, causal)
        dot = do.transpose(1, 2)
        lib = grad_time_ms(torch, lo, (ql, kl, vl), dot)

        def ours_fwd_bwd():
            o2, lse2 = mod.flash_attention_cuda(q, k, v, causal)
            mod.flash_attention_backward_cuda(q, k, v, o2, lse2, do, causal)

        def lib_fwd_bwd():
            out = _library_attention(torch, ql, kl, vl, causal)
            torch.autograd.grad(out, (ql, kl, vl), dot)

        fb = gpu_time_ms(torch, ours_fwd_bwd, n=3, repeats=5)
        lib_fb = gpu_time_ms(torch, lib_fwd_bwd, n=3, repeats=5)
        del ql, kl, vl, lo, dot
        bwd.append({"shape": shape, "dtype": dname, "design": bwd_design,
                    "checks": cs,
                    "max_abs_err": worst["max_abs_err"],
                    "tolerance": worst["tolerance"],
                    "err_over_tol": worst["err_over_tol"],
                    "repeats_bitwise": True,
                    "ms": ms, "cuda_core_ms": cc_ms,
                    "plain_ms": plain, "library_ms": lib,
                    "library_call": "autograd backward of "
                                    "F.scaled_dot_product_attention",
                    "fwd_bwd_ms": fb, "library_fwd_bwd_ms": lib_fb,
                    **bb_bound})
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return fwd, bwd


# the fused RMSNorm + matmul at the Llama head's shapes: the bf16 decode
# head (its weight alone is past the L2, and is cycled like the W8A16
# case's), a bf16 prefill bucket, and the training head (fp32: under O1
# the op is on neither AMP list, so it gets the fp32 residual and
# weights; without AMP everything is fp32), on the split design
NORM_MATMUL_SHAPES = (("bfloat16", 8), ("bfloat16", 1024),
                      ("float32", TRAIN_BATCH * TRAIN_SEQ))


def _norm_matmul_bound(rows, h, n, es, rate):
    """The fused head's bound: its bytes, and 2 rows h n (the product) +
    4 rows h (the norm) operations at ``rate``."""
    return bound(rows * h * es + h * es + h * n * es + rows * n * es,
                 2 * rows * h * n + 4 * rows * h, rate)


def norm_matmul_cases(torch, mod, dev):
    """The fused norm + head against its plain version; timed beside
    the unfused path (the port's RMSNorm kernel, then torch.matmul) and,
    for the fp32 split design, beside the CUDA-core kernels it replaced
    (``cuda_core_ms``, which it must beat)."""
    from paddle_tpu_torch.kernels import rms_norm as rms

    out = []
    g = torch.Generator(device=dev).manual_seed(11)
    h, n = 4096, 32000
    for dname, rows in NORM_MATMUL_SHAPES:
        dtype = getattr(torch, dname)
        x = torch.randn(rows, h, generator=g, device=dev).to(dtype)
        w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(dtype)
        wm = (0.02 * torch.randn(h, n, generator=g, device=dev)).to(dtype)
        design = mod.design(dtype, rows)
        before = getattr(mod, f"{design}_launches")
        y = mod.rms_norm_matmul_cuda(x, w, wm, 1e-5)
        if getattr(mod, f"{design}_launches") != before + 1 or design != (
                "tc" if dname == "bfloat16" else "split"):
            fail(f"rms_norm_matmul {dname} {[rows, h, n]} did not run its "
                 f"{design} design")
        ref = mod.rms_norm_matmul_reference(x, w, wm, 1e-5)
        if not torch.isfinite(y).all():
            fail(f"rms_norm_matmul {dname} {[rows, h, n]} produced "
                 f"non-finite values")
        if not torch.equal(y, mod.rms_norm_matmul_cuda(x, w, wm, 1e-5)):
            fail(f"rms_norm_matmul {dname} {[rows, h, n]} does not repeat "
                 f"bit for bit")
        # the normed row is rounded to x's dtype before the product, and
        # the kernel's rstd (its own sum of squares) may round an entry
        # near a midpoint the other way: that entry's ulp times |wm| is
        # the slack (zero in fp32)
        slack = mod.normed_rounding_slack(x, w, wm, 1e-5)
        cs, worst = checks(torch, [
            cast_once("out", y, ref, SUM_TOL32, dname, slack)])
        cs[0]["slack_max"] = float(slack.max())
        del y, ref, slack
        es = x.element_size()
        split = design == "split"
        rate = "float32_split" if split else dname
        b_ms, b_by = _norm_matmul_bound(rows, h, n, es, rate)
        copies = max(1, -(-L2_FLUSH_BYTES // (h * n * es)))
        wms = [wm] + [wm.clone() for _ in range(copies - 1)]
        n_t, reps = (20, 7) if rows <= 16 else (3, 3)
        ms = gpu_time_ms(torch, cycled([
            (lambda wi=wi: mod.rms_norm_matmul_cuda(x, w, wi, 1e-5))
            for wi in wms]), n=n_t, repeats=reps)
        cc_ms = None
        if split:
            cc_ms = gpu_time_ms(torch, lambda: mod.rms_norm_matmul_cuda(
                x, w, wm, 1e-5, cuda_cores=True), n=2, repeats=3)
        unfused = gpu_time_ms(torch, cycled([
            (lambda wi=wi: torch.matmul(rms.rms_norm_cuda(x, w, 1e-5), wi))
            for wi in wms]), n=n_t, repeats=reps)
        plain = gpu_time_ms(torch, lambda: mod.rms_norm_matmul_reference(
            x, w, wm, 1e-5), n=3, repeats=3)
        case = {
            "shape": {"rows": rows, "h": h, "n": n}, "dtype": dname,
            "design": design,
            "kernel": (("swap" if rows <= mod.SWAP_MAX_ROWS else "tiled")
                       if design == "tc" else design),
            "checks": cs, "max_abs_err": worst["max_abs_err"],
            "tolerance": worst["tolerance"],
            "err_over_tol": worst["err_over_tol"], "repeats_bitwise": True,
            "weight_copies": copies, "ms": ms, "cuda_core_ms": cc_ms,
            "plain_ms": plain,
            "library_ms": None, "unfused_ms": unfused,
            "unfused_call": "the port's rms_norm kernel, then torch.matmul",
            "bound_ms": b_ms, "bound_by": b_by, "bound_rate": rate,
        }
        if dname == "float32":
            case["bound_cuda_core_ms"] = _norm_matmul_bound(
                rows, h, n, es, "float32")[0]
        out.append(case)
        del x, w, wm, wms
        torch.cuda.empty_cache()
    return out


HEAD_CROSSOVER_ROWS = (8, 16, 32, 64, 128, 256, 512)


def norm_matmul_crossover(torch, mod, dev):
    """ms of the fused head's swap-AB and tiled tensor-core kernels, and
    of the unfused pair (the port's RMSNorm kernel, then torch.matmul),
    at the Llama head's [rows, 4096] x [4096, 32000] in bf16 (8 rows: the
    decode step), weights
    cycled past the L2; the swap-AB kernel at every row count it takes
    (up to 256). Each kernel's output is held within cast-once plus
    normed_rounding_slack of the plain version and must repeat bit for
    bit. Sets where the wrapper switches kernels (SWAP_MAX_ROWS)."""
    from paddle_tpu_torch.kernels import rms_norm as rms

    g = torch.Generator(device=dev).manual_seed(16)
    h, n = 4096, 32000
    w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).bfloat16()
    wm = (0.02 * torch.randn(h, n, generator=g, device=dev)).bfloat16()
    wms = [wm] + [wm.clone() for _ in range(-(-L2_FLUSH_BYTES //
                                              (2 * h * n)) - 1)]
    rows_out = []
    for rows in HEAD_CROSSOVER_ROWS:
        x = torch.randn(rows, h, generator=g, device=dev).bfloat16()
        ref = mod.rms_norm_matmul_reference(x, w, wm, 1e-5)
        slack = mod.normed_rounding_slack(x, w, wm, 1e-5)
        rec = {"rows": rows}
        for kernel in ("swap", "tiled"):
            if kernel == "swap" and rows > mod.SWAP_TILES[-1]:
                continue
            y = mod._tc_kernel(x, w, wm, 1e-5, kernel)
            what = f"rms_norm_matmul {kernel} {[rows, h, n]}"
            if not torch.equal(y, mod._tc_kernel(x, w, wm, 1e-5, kernel)):
                fail(f"{what} does not repeat bit for bit")
            _, worst = checks(torch, [cast_once(
                "out", y, ref, SUM_TOL32, "bfloat16", slack)])
            if worst["err_over_tol"] > 1.0:
                fail(f"{what}: largest error over its entry's tolerance "
                     f"{worst['err_over_tol']}")
            rec[f"{kernel}_err_over_tol"] = worst["err_over_tol"]
            rec[f"{kernel}_ms"] = gpu_time_ms(torch, cycled([
                (lambda wi=wi: mod._tc_kernel(x, w, wi, 1e-5, kernel))
                for wi in wms]), n=10, repeats=5)
        rec["unfused_ms"] = gpu_time_ms(torch, cycled([
            (lambda wi=wi: torch.matmul(rms.rms_norm_cuda(x, w, 1e-5), wi))
            for wi in wms]), n=10, repeats=5)
        rows_out.append(rec)
        del x, ref, slack
    del wm, wms
    torch.cuda.empty_cache()
    return {"swap_max_rows": mod.SWAP_MAX_ROWS, "shape": {"h": h, "n": n},
            "rows": rows_out}


HEAD_FP32_CROSSOVER_ROWS = (16, 24, 32, 64, 128, 256, 512, 4096)


def norm_matmul_fp32_crossover(torch, mod, dev):
    """ms of the fp32 fused head's split design and CUDA-core kernels,
    and of the unfused pair (the port's RMSNorm kernel, then fp32
    torch.matmul), at the Llama head's [rows, 4096] x [4096, 32000]
    (the fp32 weight, 524 MB, is past the L2). Each kernel's output is
    held within SUM_TOL32 of the plain version, and the split design's
    must repeat bit for bit. Reports the fewest rows from which the split
    design is faster at every larger count swept, beside the wrapper's
    SPLIT_MIN_ROWS."""
    from paddle_tpu_torch.kernels import rms_norm as rms

    g = torch.Generator(device=dev).manual_seed(17)
    h, n = 4096, 32000
    w = 1 + 0.1 * torch.randn(h, generator=g, device=dev)
    wm = 0.02 * torch.randn(h, n, generator=g, device=dev)
    rows_out = []
    for rows in HEAD_FP32_CROSSOVER_ROWS:
        x = torch.randn(rows, h, generator=g, device=dev)
        ref = mod.rms_norm_matmul_reference(x, w, wm, 1e-5)
        rec = {"rows": rows}
        n_t, reps = (10, 5) if rows <= 512 else (2, 3)
        for kernel, fn in (
                ("split", lambda: mod._split_kernel(x, w, wm, 1e-5)),
                ("cc", lambda: mod.rms_norm_matmul_cuda(
                    x, w, wm, 1e-5, cuda_cores=True))):
            y = fn()
            what = f"rms_norm_matmul fp32 {kernel} {[rows, h, n]}"
            if kernel == "split" and not torch.equal(y, fn()):
                fail(f"{what} does not repeat bit for bit")
            _, worst = checks(torch, [cast_once(
                "out", y, ref, SUM_TOL32, "float32")])
            if worst["err_over_tol"] > 1.0:
                fail(f"{what}: error over tolerance {worst['err_over_tol']}")
            rec[f"{kernel}_err_over_tol"] = worst["err_over_tol"]
            rec[f"{kernel}_ms"] = gpu_time_ms(torch, fn, n=n_t, repeats=reps)
            del y
        rec["unfused_ms"] = gpu_time_ms(
            torch, lambda: torch.matmul(rms.rms_norm_cuda(x, w, 1e-5), wm),
            n=n_t, repeats=reps)
        rec["bound_split_ms"] = _norm_matmul_bound(rows, h, n, 4,
                                                   "float32_split")[0]
        rows_out.append(rec)
        del x, ref
    del wm
    torch.cuda.empty_cache()
    faster = None
    for rec in reversed(rows_out):
        if rec["split_ms"] >= rec["cc_ms"]:
            break
        faster = rec["rows"]
    return {"split_min_rows": mod.SPLIT_MIN_ROWS,
            "measured_split_faster_from_rows": faster,
            "shape": {"h": h, "n": n}, "rows": rows_out}


ROPE_ATTENTION_SHAPES = (
    # dtype, causal, batch, S, head_dim (heads 32): the training shape in
    # bf16 (the O1 projections' dtype) and fp32 (the split design: the
    # fused fp32 step's), a ragged tail, a non-causal case, and head dims
    # 64 (the 64-wide split kernel), 80 and 96 (the 128-wide kernels, each
    # column paired with the one d/2 on), 256 in fp32 and bf16 (the split
    # design on pairs of CTAs) and 32 in bf16 (the split design: bf16
    # outside 64 to 128)
    ("bfloat16", True, TRAIN_BATCH, TRAIN_SEQ, 128),
    ("float32", True, TRAIN_BATCH, TRAIN_SEQ, 128),
    ("bfloat16", True, 1, 1000, 128),
    ("bfloat16", False, 1, 1024, 128),
    ("bfloat16", True, TRAIN_BATCH, TRAIN_SEQ, 80),
    ("float32", True, TRAIN_BATCH, TRAIN_SEQ, 96),
    # head dim 72: each half zero-padded to 40 by the wrapper
    ("bfloat16", True, TRAIN_BATCH, TRAIN_SEQ, 72),
    ("float32", True, TRAIN_BATCH, TRAIN_SEQ, 64),
    ("float32", True, TRAIN_BATCH, TRAIN_SEQ, 80),
    ("float32", True, 1, 1000, 128),
    ("float32", True, TRAIN_BATCH, TRAIN_SEQ, 256),
    ("bfloat16", True, TRAIN_BATCH, TRAIN_SEQ, 32),
    ("bfloat16", True, TRAIN_BATCH, TRAIN_SEQ, 256),
)


def rope_attention_cases(torch, mod, dev):
    """The rope-on-load attention against its plain version; timed
    beside the unfused path (the port's rope kernel, then its flash
    forward kernel) and, for the split design, beside the CUDA-core
    kernel it replaced (``cuda_core_ms``, which it must beat)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import rope

    out = []
    h = 32
    g = torch.Generator(device=dev).manual_seed(12)
    for dname, causal, b, s, d in ROPE_ATTENTION_SHAPES:
        cos_full, sin_full = rope.build_rope_cache(4096, d, device=dev)
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        # leading rows of a longer table, as the model passes them
        cos, sin = cos_full[:, :s], sin_full[:, :s]
        design = mod.design(dtype, d)
        # bf16 at a padded 64 to 128 on the tensor-core kernel, every
        # other case on the split design
        padded = -(-d // 16) * 16
        want = ("tc" if dname == "bfloat16" and 64 <= padded <= 128
                else "split")
        before = getattr(mod, f"{design}_launches")
        o = mod.rope_attention_cuda(q, k, v, cos, sin, causal)
        if getattr(mod, f"{design}_launches") != before + 1 \
                or design != want:
            fail(f"rope_attention {dname} D {d} ran its {design} design, "
                 f"expected {want}")
        ref = mod.rope_attention_reference(q, k, v, cos, sin, causal)
        if not torch.isfinite(o).all():
            fail(f"rope_attention {dname} produced non-finite values")
        # the tensor-core kernel's split products: their own slack
        slack = (mod.split_product_slack(q, k, v, cos, sin, causal)
                 if design == "tc" else None)
        cs, worst = checks(torch, [
            cast_once("o", o, ref, SUM_TOL32, dname, slack)])
        if slack is not None:
            cs[0]["slack_max"] = float(slack.max())
        del o, ref, slack
        pairs = _visible_pairs(s, s, causal) * b * h
        es = q.element_size()
        rate = "float32_split" if design == "split" else dname
        moved = 4 * b * s * h * d * es + 2 * s * (d // 2) * 4
        flops = 4 * d * pairs + 2 * 6 * b * s * h * (d // 2)
        b_ms, b_by = bound(moved, flops, rate)

        def unfused():
            rq, rk = rope.rope_cuda(q, k, cos, sin)
            fa.flash_attention_cuda(rq, rk, v, causal)

        case = {
            "shape": {"b": b, "h": h, "d": d, "s": s, "causal": causal},
            "dtype": dname, "design": design, "checks": cs,
            "max_abs_err": worst["max_abs_err"],
            "tolerance": worst["tolerance"],
            "err_over_tol": worst["err_over_tol"],
            "ms": gpu_time_ms(torch, lambda: mod.rope_attention_cuda(
                q, k, v, cos, sin, causal), n=5, repeats=5),
            "cuda_core_ms": None,
            "plain_ms": gpu_time_ms(
                torch, lambda: mod.rope_attention_reference(
                    q, k, v, cos, sin, causal), n=3, repeats=3),
            "library_ms": None,
            "unfused_ms": gpu_time_ms(torch, unfused, n=5, repeats=5),
            "unfused_call": "the port's rope kernel, then its flash "
                            "forward kernel",
            "bound_ms": b_ms, "bound_by": b_by, "bound_rate": rate,
        }
        if design == "split":
            case["cuda_core_ms"] = gpu_time_ms(
                torch, lambda: mod.rope_attention_cuda(
                    q, k, v, cos, sin, causal, cuda_cores=True),
                n=2, repeats=3)
            case["bound_cuda_core_ms"] = bound(moved, flops, "float32")[0]
        out.append(case)
        del q, k, v
        torch.cuda.empty_cache()
    return out


# the fused attention's backward at the training shape (causal B 2, S
# 2048, H 32): the O1 step's bf16 and the fused fp32 step's head dim 128,
# and fp32 at 256 (the split design on pairs of CTAs)
ROPE_ATTENTION_BWD_SHAPES = (("bfloat16", 128), ("float32", 128),
                             ("float32", 256))


def rope_attention_bwd_cases(torch, mod, dev):
    """The fused attention's backward (``rope_attention_backward``: the
    rope and flash kernels composed in fp32, the JAX ``_bwd``) against the
    plain VJP on the card (autograd through the plain forward), within
    the flash backward's fp32 tolerance (sums over rows); bit for bit on
    a repeat; timed beside the plain VJP. Its bound: the VJP's 12 D flops
    a visible pair (S and P V recomputed, dP, dV, dK, dQ) as six bf16
    products each (it runs in fp32), and its inputs and outputs once."""
    from paddle_tpu_torch.kernels import rope

    out = []
    h = 32
    b, s = TRAIN_BATCH, TRAIN_SEQ
    g = torch.Generator(device=dev).manual_seed(13)
    for dname, d in ROPE_ATTENTION_BWD_SHAPES:
        dtype = getattr(torch, dname)
        q, k, v, gr = (torch.randn(b, s, h, d, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        cos, sin = (t.reshape(s, d // 2)
                    for t in rope.build_rope_cache(s, d, device=dev))
        scale = 1.0 / (d ** 0.5)

        def ours():
            return mod.rope_attention_backward(q, k, v, gr, cos, sin, True,
                                               scale)

        before = mod.bwd_launches
        got = ours()
        again = ours()
        if mod.bwd_launches != before + 2:
            fail(f"rope_attention backward {dname} D {d} did not count "
                 f"its launches")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"rope_attention backward {dname} D {d} does not repeat "
                 f"bit for bit")
        del again
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plain_out = mod.rope_attention_reference(*ins, cos, sin, True)
        want = torch.autograd.grad(plain_out, ins, gr, retain_graph=True)
        if not all(torch.isfinite(x).all() for x in got):
            fail(f"rope_attention backward {dname} produced non-finite "
                 f"values")
        cs, worst = checks(torch, [
            cast_once(n, x, w, SUM_TOL32, dname)
            for n, x, w in zip(("dq", "dk", "dv"), got, want)])
        del got, want
        pairs = _visible_pairs(s, s, True) * b * h
        es = q.element_size()
        moved = 7 * b * s * h * d * es + 2 * s * (d // 2) * 4
        flops = 12 * d * pairs + 4 * 6 * b * s * h * (d // 2)
        b_ms, b_by = bound(moved, flops, "float32_split")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ours()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        out.append({
            "shape": {"b": b, "h": h, "d": d, "s": s, "causal": True},
            "dtype": dname, "design": "rope + split flash, fp32",
            "checks": cs, "max_abs_err": worst["max_abs_err"],
            "tolerance": worst["tolerance"],
            "err_over_tol": worst["err_over_tol"], "repeats_bitwise": True,
            "ms": gpu_time_ms(torch, ours, n=3, repeats=5),
            "plain_ms": grad_time_ms(torch, plain_out, ins, gr, n=1,
                                     repeats=3),
            "plain_call": "autograd through the plain fused forward",
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_rate": "float32_split",
            "bound_cuda_core_ms": bound(moved, flops, "float32")[0],
            "workspace_peak_bytes": extra,
        })
        del q, k, v, gr, ins, plain_out
        torch.cuda.empty_cache()
    return out


# ------------------------------------------- multi-tensor optimizer kernels
# tensors a table holds (csrc/multi_tensor.cu Table<D>::kMax): the 4 KB of
# kernel parameters; and the kernels a table launches (the sum of squares:
# chunks and per-tensor sums, its call one finalize more; Lamb: moments,
# per-tensor sums and apply)
MT_TABLE = {"mt_sumsq": 159, "mt_adam": 79, "mt_momentum": 95,
            "mt_lamb": 79}
MT_PER_TABLE = {"mt_sumsq": 2, "mt_adam": 1, "mt_momentum": 1, "mt_lamb": 3}
MT_KERNELS = tuple(MT_TABLE)
# the CUDA kernels of csrc/multi_tensor.cu, by name (profile groups)
MT_KERNEL_NAMES = ("mt_sumsq_kernel", "mt_reduce_kernel",
                   "mt_finalize_kernel", "mt_adam_kernel",
                   "mt_momentum_kernel", "mt_lamb_moments_kernel",
                   "mt_lamb_apply_kernel")


def train_param_shapes():
    """The training model's parameter list (Llama-2-7B widths,
    TRAIN_LAYERS layers): the embedding, per layer q, k, v, o, gate, up,
    down and the two norms, the final norm and the head (75 tensors,
    1.881B elements at 8 layers)."""
    h, f, vocab = 4096, 11008, 32000
    layer = [(h, h)] * 4 + [(h, f), (h, f), (f, h), (h,), (h,)]
    return [(vocab, h)] + layer * TRAIN_LAYERS + [(h,), (h, vocab)]


TRAIN_TENSORS = len(train_param_shapes())


def mt_launches(kernel, tensors=TRAIN_TENSORS):
    """Kernel launches of one call over ``tensors`` non-empty tensors of
    one dtype."""
    tables = -(-tensors // MT_TABLE[kernel])
    return tables * MT_PER_TABLE[kernel] + (kernel == "mt_sumsq")


# the checks' tensors: odd sizes, an empty one, and (added by the case) an
# unaligned slice
MT_SHAPES = ((1,), (7,), (1023,), (64, 33), (0,), (3, 4096), (4097,))
# Lamb's norms are sums in another order: the ratio |p| / |r| moves by a
# few fp32 ulps, so each updated entry by that much of its step: every
# entry within 1e-6 of its tensor's largest |p| (fp32), and one bf16 ulp
# of the entry, at most 2^-7 of it (bf16 parameters, where the sum's ulps
# may flip a rounding)
LAMB_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
# the sum of squares: each tensor's sum and the total within 1e-6
# relative of the plain version's (fp32 sums in another order)
SUMSQ_RTOL = 1e-6


def _bitwise(torch, name, got, want):
    """A check that ``got`` equals ``want`` bit for bit, tensor by
    tensor."""
    same = all(_bits_equal(torch, a, b) for a, b in zip(got, want))
    err = max((float((a.float() - b.float()).abs().max()) if a.numel()
               else 0.0) for a, b in zip(got, want))
    return {"output": name, "max_abs_err": err, "tolerance": 0.0,
            "err_over_tol": 0.0 if same else float("inf"), "bitwise": same}


def _bits_equal(torch, a, b):
    """Bit equality (NaNs included)."""
    if a.element_size() == 2:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _mt_list(torch, dev, gen, dtype, shapes, scale=1.0, positive=False,
             unaligned=True):
    """Seeded tensors of ``shapes`` in ``dtype`` (and, with ``unaligned``,
    one more: a 1000-element slice one element into its storage, whose
    pointer is not 16-byte aligned)."""
    out = []
    for s in list(shapes) + ([(1001,)] if unaligned else []):
        x = torch.randn(s, generator=gen, device=dev) * scale
        if positive:
            x = x.abs()
        x = x.to(dtype)
        out.append(x[1:] if unaligned and s == (1001,) else x)
    return out


def _clones(xs):
    return [x.clone() for x in xs]


def mt_check_cases(torch, mod, dev):
    """Each family's kernel against its plain version on the card, on odd
    sizes, an empty tensor and an unaligned slice, fp32 and bf16
    parameters, through every prologue (unscale, the three clips, L2 and
    L1, the skip flag set by a non-finite gradient): ``mt_adam`` and
    ``mt_momentum`` bit for bit given the same stats, ``mt_sumsq`` within
    SUMSQ_RTOL and bit-equal on a repeat (also over a list of both
    dtypes), ``mt_lamb`` within LAMB_TOL (its moments bit for bit) and
    bit-equal on a repeat (also with no norm and every tensor in stats
    slot 0, as the optimizer calls it then)."""
    gen = torch.Generator(device=dev).manual_seed(21)
    out = {k: [] for k in MT_KERNELS}
    inv = torch.full((), 0.25, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        ps = _mt_list(torch, dev, gen, dtype, MT_SHAPES)
        gs = _mt_list(torch, dev, gen, dtype, MT_SHAPES, scale=2.0)
        ms = _mt_list(torch, dev, gen, torch.float32, MT_SHAPES, scale=0.1)
        vs = _mt_list(torch, dev, gen, torch.float32, MT_SHAPES, scale=0.1,
                      positive=True)
        shape = {"tensors": len(ps), "shapes": [list(p.shape) for p in ps],
                 "unaligned": "the last, 1000 elements at offset 1"}
        # sum of squares, unscaled by inv, with the clip coefficient
        stats = mod.grad_sumsq_cuda(gs, inv=inv, clip_norm=1.0)
        again = mod.grad_sumsq_cuda(gs, inv=inv, clip_norm=1.0)
        ref = mod.grad_sumsq_reference(gs, inv=inv, clip_norm=1.0)
        n = len(gs)
        rel = float(((stats.buf[:4 + n] - ref.buf[:4 + n]).abs()
                     / ref.buf[:4 + n].abs().clamp(min=1e-30)).max())
        checks = [
            {"output": "sums of squares, total, coefficient (relative)",
             "max_abs_err": rel, "tolerance": SUMSQ_RTOL,
             "err_over_tol": rel / SUMSQ_RTOL},
            _bitwise(torch, "non-finite counts", [stats.buf[4 + n:]],
                     [ref.buf[4 + n:]]),
            _bitwise(torch, "repeat", [stats.buf], [again.buf])]
        bad = _clones(gs)
        bad[2][5] = float("inf")
        flagged = mod.grad_sumsq_cuda(bad, inv=inv, clip_norm=1.0,
                                      skip_nonfinite=True)
        checks.append(_bitwise(torch, "inf flagged: count, skip", [
            flagged.buf[1:2], flagged.buf[3:4]],
            [torch.ones(1, device=dev), torch.ones(1, device=dev)]))
        # every other gradient in the other dtype: one pass a dtype, each
        # writing its tensors' slots, one finalize
        other = (torch.bfloat16 if dtype == torch.float32
                 else torch.float32)
        mixed = [g if i % 2 == 0 else g.to(other) for i, g in enumerate(gs)]
        got = mod.grad_sumsq_cuda(mixed, inv=inv, clip_norm=1.0)
        ref = mod.grad_sumsq_reference(mixed, inv=inv, clip_norm=1.0)
        rel = float(((got.buf[:4 + n] - ref.buf[:4 + n]).abs()
                     / ref.buf[:4 + n].abs().clamp(min=1e-30)).max())
        checks += [
            {"output": "mixed dtypes: sums, total, coefficient (relative)",
             "max_abs_err": rel, "tolerance": SUMSQ_RTOL,
             "err_over_tol": rel / SUMSQ_RTOL},
            _bitwise(torch, "mixed dtypes: repeat", [got.buf], [
                mod.grad_sumsq_cuda(mixed, inv=inv, clip_norm=1.0).buf])]
        out["mt_sumsq"].append(_mt_case(dname, shape, checks))

        def run_both(fn, cols, kwargs):
            """fn's kernel and plain version on clones of ``cols``."""
            a, b = [_clones(c) for c in cols], [_clones(c) for c in cols]
            getattr(mod, fn + "_cuda")(*a, **kwargs)
            getattr(mod, fn + "_reference")(*b, **kwargs)
            return a, b

        norm_stats = mod.grad_sumsq_cuda(gs)
        global_stats = mod.grad_sumsq_cuda(gs, inv=inv, clip_norm=1.0,
                                           skip_nonfinite=True)
        pro = {
            "none": None,
            "inv+global+skip flag clear": mod.Prologue(
                inv, mod.CLIP_GLOBAL, global_stats, skip=True),
            "norm": mod.Prologue(None, mod.CLIP_NORM, norm_stats,
                                 clip_norm=0.5),
            "value": mod.Prologue(None, mod.CLIP_VALUE, lo=-0.1, hi=0.2),
            "skip flag set": mod.Prologue(inv, mod.CLIP_GLOBAL, flagged,
                                          skip=True),
        }
        checks = []
        for label, decoupled, wd, l1, p in (
                ("AdamW wd 0.01", True, 0.01, 0.0, "none"),
                ("Adam coupled wd 0.01", False, 0.01, 0.0,
                 "inv+global+skip flag clear"),
                ("AdamW L1 0.01", True, 0.0, 0.01, "norm"),
                ("AdamW wd 0.1", True, 0.1, 0.0, "value"),
                ("Adam", False, 0.0, 0.0, "skip flag set")):
            grads = bad if p == "skip flag set" else gs
            a, b = run_both("fused_adam_update", [ps, ms, vs], dict(
                grads=grads, lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
                t=3, decoupled=decoupled, weight_decay=wd, l1=l1,
                prologue=pro[p]))
            for j, col in enumerate(("p", "m", "v")):
                checks.append(_bitwise(torch, f"{label}, {p}: {col}",
                                       a[j], b[j]))
            if p == "skip flag set":
                checks.append(_bitwise(torch, "skipped: p, m, v untouched",
                                       a[0] + a[1] + a[2], ps + ms + vs))
        out["mt_adam"].append(_mt_case(dname, shape, checks))
        checks = []
        for label, vel, nest, wd, l1, p in (
                ("SGD L2 0.01", None, False, 0.01, 0.0, "none"),
                ("Momentum Nesterov L1 0.01", ms, True, 0.0, 0.01, "norm"),
                ("Momentum", ms, False, 0.0, 0.0,
                 "inv+global+skip flag clear"),
                ("Momentum, value clip", ms, False, 0.0, 0.0, "value"),
                ("Momentum", ms, True, 0.0, 0.0, "skip flag set")):
            grads = bad if p == "skip flag set" else gs
            kw = dict(grads=grads, lr=0.1, momentum=0.9,
                      use_nesterov=nest, weight_decay=wd, l1=l1,
                      prologue=pro[p])
            if vel is None:
                a, b = run_both("momentum_update", [ps],
                                dict(kw, velocity=None))
            else:
                a, b = run_both("momentum_update", [ps, vel], kw)
            checks.append(_bitwise(torch, f"{label}, {p}: p", a[0], b[0]))
            if vel is not None:
                checks.append(_bitwise(torch, f"{label}, {p}: velocity", a[1],
                                       b[1]))
        out["mt_momentum"].append(_mt_case(dname, shape, checks))
        checks = []
        for p in ("inv+global+skip flag clear", "norm", "skip flag set",
                  "none", "value"):
            grads = bad if p == "skip flag set" else gs
            # without a norm the optimizer gives every tensor slot 0: the
            # Lamb norms must not depend on it
            kw = dict(grads=grads, lr=1e-2, beta1=0.9, beta2=0.999,
                      eps=1e-6, t=3, lamb_weight_decay=0.01,
                      prologue=pro[p], slots=[0] * len(ps) if p in (
                          "none", "value") else None)
            a, b = run_both("lamb_update", [ps, ms, vs], kw)
            a2 = [_clones(c) for c in (ps, ms, vs)]
            mod.lamb_update_cuda(*a2, **kw)
            checks.append(_bitwise(torch, f"{p}: m, v", a[1] + a[2],
                                   b[1] + b[2]))
            checks.append(_bitwise(torch, f"{p}: repeat", a[0], a2[0]))
            tol = LAMB_TOL[dname]
            worst = 0.0
            for x, y, p0 in zip(a[0], b[0], ps):
                if not x.numel():
                    continue
                d = (x.float() - y.float()).abs()
                lim = (tol * y.float().abs() if dtype == torch.bfloat16
                       else tol * float(p0.float().abs().max())
                       * torch.ones_like(d))
                worst = max(worst, float((d / lim.clamp(min=1e-30)).max()))
            checks.append({"output": f"{p}: p (ratio from sums in another "
                                     f"order)", "max_abs_err": worst * tol,
                           "tolerance": tol, "err_over_tol": worst})
        out["mt_lamb"].append(_mt_case(dname, shape, checks))
    return out


def _mt_case(dname, shape, checks):
    worst = max(checks, key=lambda c: c["err_over_tol"])
    return {"shape": shape, "dtype": dname, "checks": checks,
            "max_abs_err": worst["max_abs_err"],
            "tolerance": worst["tolerance"],
            "err_over_tol": worst["err_over_tol"]}


def mt_main_cases(torch, mod, dev):
    """Each family at the training model's parameter list (75 fp32 tensors,
    1.881B elements; the O1 step's configuration: AdamW with the
    global-norm clip): held against the plain version on the same inputs
    (``mt_adam``, ``mt_momentum`` bit for bit, Lamb within LAMB_TOL, the
    sums within SUMSQ_RTOL), then timed beside its bound (bytes at 3.35
    TB/s: every input read once, every output written once), the plain
    version and a PyTorch call for the same function that the port never
    makes (``torch._foreach_norm``; ``torch._fused_adamw_``, torch's op
    order on the same bytes; ``torch._fused_sgd_``)."""
    gen = torch.Generator(device=dev).manual_seed(22)
    shapes = train_param_shapes()
    ps = [torch.empty(s, device=dev) for s in shapes]
    gs = [torch.randn(s, generator=gen, device=dev) * 1e-3 for s in shapes]
    ms = [torch.empty(s, device=dev) for s in shapes]
    vs = [torch.empty(s, device=dev) for s in shapes]

    def fresh():
        """Seeded parameters and zero moments (each family's check starts
        from them: the timed calls before it update in place)."""
        gen.manual_seed(23)
        for p in ps:
            p.normal_(0.0, 0.02, generator=gen)
        for x in ms + vs:
            x.zero_()

    n = sum(p.numel() for p in ps)
    shape = {"tensors": len(ps), "elements": n, "dtype": "float32",
             "model": f"Llama-2-7B widths, {TRAIN_LAYERS} layers"}
    out = {}
    slow = dict(n=2, repeats=3)

    # sum of squares
    stats = mod.grad_sumsq_cuda(gs, clip_norm=1.0)
    again = mod.grad_sumsq_cuda(gs, clip_norm=1.0)
    ref = mod.grad_sumsq_reference(gs, clip_norm=1.0)
    k = 4 + len(gs)
    rel = float(((stats.buf[:k] - ref.buf[:k]).abs()
                 / ref.buf[:k].abs().clamp(min=1e-30)).max())
    checks = [{"output": "sums of squares, total, coefficient (relative)",
               "max_abs_err": rel, "tolerance": SUMSQ_RTOL,
               "err_over_tol": rel / SUMSQ_RTOL},
              _bitwise(torch, "repeat", [stats.buf], [again.buf])]
    b_ms, b_by = bound(4 * n, 2 * n, "float32")
    case = _mt_case("float32", shape, checks)
    case.update(
        ms=gpu_time_ms(torch, lambda: mod.grad_sumsq_cuda(gs, clip_norm=1.0)),
        plain_ms=gpu_time_ms(torch, lambda: mod.grad_sumsq_reference(
            gs, clip_norm=1.0), **slow),
        library_ms=gpu_time_ms(torch, lambda: torch._foreach_norm(gs)),
        library="torch._foreach_norm", bound_ms=b_ms, bound_by=b_by)
    out["mt_sumsq"] = case

    # AdamW with the global-norm clip (the O1 step's update)
    fresh()
    pro = mod.Prologue(None, mod.CLIP_GLOBAL, stats)
    kw = dict(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8, t=1,
              decoupled=True, weight_decay=0.01, prologue=pro)
    a = [_clones(c) for c in (ps, ms, vs)]
    mod.fused_adam_update_cuda(a[0], a[1], a[2], gs, **kw)
    checks = _per_tensor(torch, mod.fused_adam_update_reference, a,
                         (ps, ms, vs), gs, kw, "pmv")
    del a
    b_ms, b_by = bound(7 * 4 * n, 15 * n, "float32")
    case = _mt_case("float32", shape, checks)
    steps = [torch.zeros((), device=dev) for _ in ps]

    def fused_adamw():
        torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=3e-4, beta1=0.9,
                            beta2=0.999, weight_decay=0.01, eps=1e-8,
                            amsgrad=False, maximize=False)

    case.update(
        ms=gpu_time_ms(torch, lambda: mod.fused_adam_update_cuda(
            ps, ms, vs, gs, **kw)),
        plain_ms=gpu_time_ms(torch, lambda: mod.fused_adam_update_reference(
            ps, ms, vs, gs, **kw), **slow),
        library_ms=_library_ms(torch, fused_adamw),
        library="torch._fused_adamw_", bound_ms=b_ms, bound_by=b_by)
    out["mt_adam"] = case

    # Momentum with Nesterov (velocity in ms)
    fresh()
    kw = dict(lr=1e-2, momentum=0.9, use_nesterov=True)
    a = [_clones(c) for c in (ps, ms)]
    mod.momentum_update_cuda(a[0], a[1], gs, **kw)
    checks = _per_tensor(torch, mod.momentum_update_reference, a, (ps, ms),
                         gs, kw, ("p", "velocity"))
    del a
    b_ms, b_by = bound(5 * 4 * n, 5 * n, "float32")
    case = _mt_case("float32", shape, checks)

    def fused_sgd():
        torch._fused_sgd_(ps, gs, ms, weight_decay=0.0, momentum=0.9,
                          lr=1e-2, dampening=0.0, nesterov=True,
                          maximize=False, is_first_step=False)

    case.update(
        ms=gpu_time_ms(torch, lambda: mod.momentum_update_cuda(
            ps, ms, gs, **kw)),
        plain_ms=gpu_time_ms(torch, lambda: mod.momentum_update_reference(
            ps, ms, gs, **kw), **slow),
        library_ms=_library_ms(torch, fused_sgd),
        library="torch._fused_sgd_", bound_ms=b_ms, bound_by=b_by)
    out["mt_momentum"] = case

    # Lamb with the global-norm clip
    fresh()
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, t=1,
              lamb_weight_decay=0.01, prologue=pro)
    a = [_clones(c) for c in (ps, ms, vs)]
    mod.lamb_update_cuda(a[0], a[1], a[2], gs, **kw)
    checks = _per_tensor(torch, mod.lamb_update_reference, a, (ps, ms, vs),
                         gs, kw, "pmv", p_tol=LAMB_TOL["float32"])
    del a
    b_ms, b_by = bound(7 * 4 * n, 22 * n, "float32")
    case = _mt_case("float32", shape, checks)
    case.update(
        ms=gpu_time_ms(torch, lambda: mod.lamb_update_cuda(
            ps, ms, vs, gs, **kw)),
        plain_ms=gpu_time_ms(torch, lambda: mod.lamb_update_reference(
            ps, ms, vs, gs, **kw), **slow),
        library_ms=None, library=None, bound_ms=b_ms, bound_by=b_by)
    out["mt_lamb"] = case
    del ps, gs, ms, vs
    torch.cuda.empty_cache()
    return out


def _per_tensor(torch, reference, got, cols, gs, kw, names, p_tol=None):
    """Checks of the kernel's outputs ``got`` (a list per column of
    ``cols``) against the plain version run tensor by tensor on copies of
    ``cols`` (each tensor's slot is its index): bit for bit, or for the
    parameters with ``p_tol`` within that much of the tensor's largest
    |p| (Lamb)."""
    worst = {c: 0.0 for c in names}
    for i in range(len(gs)):
        mine = [[c[i].clone()] for c in cols]
        reference(*mine, [gs[i]], slots=[i], **kw)
        for j, c in enumerate(names):
            d = float((got[j][i] - mine[j][0]).abs().max())
            if j == 0 and p_tol is not None:
                d /= p_tol * float(cols[0][i].abs().max())
            elif d != 0.0 or not _bits_equal(torch, got[j][i], mine[j][0]):
                d = float("inf")
            worst[c] = max(worst[c], d)
    return [{"output": c, "max_abs_err": worst[c] * (
                p_tol if j == 0 and p_tol is not None else 1.0),
             "tolerance": p_tol if j == 0 and p_tol is not None else 0.0,
             "err_over_tol": worst[c]}
            for j, c in enumerate(names)]


def _library_ms(torch, fn):
    """The yardstick's time, or None where this PyTorch does not run it
    (the reason is printed)."""
    try:
        return gpu_time_ms(torch, fn)
    except (RuntimeError, TypeError, AttributeError) as e:
        log(f"library yardstick not timed: {type(e).__name__}: {e}")
        return None


def multi_tensor_cases(torch, mod, dev):
    """{kernel: [main case, check cases...]}: the main case first (the
    training model's parameter list), then :func:`mt_check_cases`."""
    main = mt_main_cases(torch, mod, dev)
    checks = mt_check_cases(torch, mod, dev)
    return {k: [main[k]] + checks[k] for k in MT_KERNELS}


# ------------------------------------------------------------ fp16
# the fp16 flash cases (the O1 and O2 fp16 steps attend in fp16): the
# training shape, head dim 64, a ragged causal S 1000 and head dim 80
# (padded to the 128-wide kernels); the backward takes head dims up to
# 128 in fp16 (above: ROADMAP.md queue B, fp16 item 3)
FP16_FLASH_SHAPES = (
    ("float16", True, TRAIN_BATCH, 2048, 2048, 128),
    ("float16", True, TRAIN_BATCH, 2048, 2048, 64),
    ("float16", True, 1, 1000, 1000, 128),
    ("float16", True, TRAIN_BATCH, 2048, 2048, 80),
)


def mt_fp16_cases(torch, mod, dev):
    """``mt_sumsq`` and ``mt_adam`` over the training model's parameter
    list with fp16 parameters and gradients and fp32 moments (the
    ``decorate`` O2 step): the scaler's unscale and finite check with the
    global-norm clip (``inv`` 2^-10), then AdamW with that prologue, held
    against the plain versions (the sums within SUMSQ_RTOL and bit-equal
    on a repeat, the update bit for bit) and timed beside their bounds
    (fp16 p and g, fp32 m and v), the plain versions and
    ``torch._foreach_norm`` / ``torch._fused_adamw_``; then one gradient
    made inf (an overflow, the common case under fp16) must set the skip
    flag and leave every parameter and moment bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(24)
    shapes = train_param_shapes()
    f16 = torch.float16
    ps = [(torch.randn(s, generator=gen, device=dev) * 0.02).to(f16)
          for s in shapes]
    gs = [(torch.randn(s, generator=gen, device=dev) * 1e-3).to(f16)
          for s in shapes]
    ms = [torch.zeros(s, device=dev) for s in shapes]
    vs = [torch.zeros(s, device=dev) for s in shapes]
    n = sum(p.numel() for p in ps)
    shape = {"tensors": len(ps), "elements": n,
             "dtype": "float16 parameters and gradients, float32 moments",
             "model": f"Llama-2-7B widths, {TRAIN_LAYERS} layers"}
    inv = torch.full((), 2.0 ** -10, dtype=torch.float32, device=dev)
    sk = dict(inv=inv, clip_norm=1.0, skip_nonfinite=True)
    slow = dict(n=2, repeats=3)
    out = {}

    stats = mod.grad_sumsq_cuda(gs, **sk)
    again = mod.grad_sumsq_cuda(gs, **sk)
    ref = mod.grad_sumsq_reference(gs, **sk)
    k = 4 + len(gs)
    rel = float(((stats.buf[:k] - ref.buf[:k]).abs()
                 / ref.buf[:k].abs().clamp(min=1e-30)).max())
    checks = [{"output": "sums of squares, total, coefficient (relative)",
               "max_abs_err": rel, "tolerance": SUMSQ_RTOL,
               "err_over_tol": rel / SUMSQ_RTOL},
              _bitwise(torch, "repeat", [stats.buf], [again.buf])]
    if float(stats.skip) != 0.0:
        fail("mt_sumsq fp16: the skip flag is set on finite gradients")
    b_ms, b_by = bound(2 * n, 3 * n, "float32")
    case = _mt_case("float16", shape, checks)
    case.update(
        ms=gpu_time_ms(torch, lambda: mod.grad_sumsq_cuda(gs, **sk)),
        plain_ms=gpu_time_ms(torch, lambda: mod.grad_sumsq_reference(
            gs, **sk), **slow),
        library_ms=_library_ms(torch, lambda: torch._foreach_norm(gs)),
        library="torch._foreach_norm", bound_ms=b_ms, bound_by=b_by)
    out["mt_sumsq_fp16"] = [case]

    pro = mod.Prologue(inv, mod.CLIP_GLOBAL, stats, skip=True)
    kw = dict(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8, t=1,
              decoupled=True, weight_decay=0.01, prologue=pro)
    a = [_clones(c) for c in (ps, ms, vs)]
    mod.fused_adam_update_cuda(a[0], a[1], a[2], gs, **kw)
    checks = _per_tensor(torch, mod.fused_adam_update_reference, a,
                         (ps, ms, vs), gs, kw, "pmv")
    del a
    # p, g read (2 bytes), m, v read (4), p written (2), m, v written (4)
    b_ms, b_by = bound(22 * n, 17 * n, "float32")
    case = _mt_case("float16", shape, checks)
    steps = [torch.zeros((), device=dev) for _ in ps]

    def fused_adamw():
        torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=3e-4, beta1=0.9,
                            beta2=0.999, weight_decay=0.01, eps=1e-8,
                            amsgrad=False, maximize=False)

    case.update(
        ms=gpu_time_ms(torch, lambda: mod.fused_adam_update_cuda(
            ps, ms, vs, gs, **kw)),
        plain_ms=gpu_time_ms(torch, lambda: mod.fused_adam_update_reference(
            ps, ms, vs, gs, **kw), **slow),
        library_ms=_library_ms(torch, fused_adamw),
        library="torch._fused_adamw_ (fp16 parameters, fp32 moments)",
        bound_ms=b_ms, bound_by=b_by)

    # an overflowed fp16 gradient: found, and the update skipped
    bad = _clones(gs)
    bad[3].view(-1)[5] = float("inf")
    bad_stats = mod.grad_sumsq_cuda(bad, **sk)
    before = [_clones(c) for c in (ps, ms, vs)]
    mod.fused_adam_update_cuda(
        ps, ms, vs, bad, **dict(kw, prologue=mod.Prologue(
            inv, mod.CLIP_GLOBAL, bad_stats, skip=True)))
    kept = all(_bits_equal(torch, x, y) for c, b in zip((ps, ms, vs), before)
               for x, y in zip(c, b))
    if float(bad_stats.skip) != 1.0 or float(bad_stats.nonfinite) < 1 \
            or not kept:
        fail(f"mt_adam fp16: an inf gradient gave skip "
             f"{float(bad_stats.skip)}, non-finite "
             f"{float(bad_stats.nonfinite)}, state kept {kept}")
    case["overflow_skipped"] = True
    out["mt_adam_fp16"] = [case]
    del ps, gs, ms, vs, bad, before
    torch.cuda.empty_cache()
    return out


# the fp8 GEMM's shapes on the O3 training step (Llama-2-7B widths, B 2 x
# S 2048 = 4096 tokens): name, M (tokens), N (the weight's out), K (its
# in), sites a step (8 layers), and one ragged shape (no multiple of 128
# anywhere, every contraction padded to a multiple of 16 by the wrapper)
FP8_SHAPES = (("q/k/v/o", 4096, 4096, 4096, 4 * 8),
              ("gate_up", 4096, 22016, 4096, 8),
              ("down", 4096, 4096, 11008, 8),
              ("lm_head", 4096, 32000, 4096, 1),
              ("ragged", 4104, 4120, 4136, 0))
# per site and step: the forward's quantize of x and of w (codes, the
# transposed codes, the amax), the gradient's amax and its quantize
# (codes and transposed codes); three products (forward, dX, dW)
FP8_QUANTIZE_PER_SITE, FP8_GEMM_PER_SITE = 4, 3


def _fp8_case(torch, mod, dev, label, form, a, bt, sa, sb, m, n, k, sites):
    """One GEMM form: the kernel against its plain version with a bf16
    and an fp32 output (the fp32 summation bound plus half an ulp of the
    output, ``fp8_matmul.gemm_error``; with an fp32 output the bound
    itself is what holds the sums, which the promotion of each 128 of K
    into fp32 registers keeps within it), a bit-equal repeat, and its
    time beside its bound, the plain version, ``torch._scaled_mm``
    (cuBLASLt, the library yardstick) and a bf16 ``torch.matmul`` of the
    same shape (what the O1 step runs)."""
    out = mod.gemm_cuda(a, bt, sa, sb, torch.bfloat16)
    if not torch.isfinite(out).all():
        fail(f"fp8 gemm {label} {form}: non-finite values")
    if not torch.equal(out, mod.gemm_cuda(a, bt, sa, sb, torch.bfloat16)):
        fail(f"fp8 gemm {label} {form} does not repeat bit for bit")
    err, tol, over = mod.gemm_error(out, a, bt, sa, sb)
    del out
    out = mod.gemm_cuda(a, bt, sa, sb, torch.float32)
    err32, tol32, over32 = mod.gemm_error(out, a, bt, sa, sb)
    del out
    ms = gpu_time_ms(torch, lambda: mod.gemm_cuda(a, bt, sa, sb,
                                                  torch.bfloat16),
                     n=5, repeats=3)
    plain = gpu_time_ms(torch, lambda: mod.gemm_reference(
        a, bt, sa, sb, torch.bfloat16), n=2, repeats=3)
    lib, why = None, None
    try:
        b = bt.t()  # column-major [K, N], as _scaled_mm takes it
        lib = gpu_time_ms(torch, lambda: torch._scaled_mm(
            a, b, sa, sb, out_dtype=torch.bfloat16), n=5, repeats=3)
    except Exception as exc:  # the yardstick only; never on the path
        why = repr(exc)[:200]
    a16 = torch.randn(a.shape, device=dev, dtype=torch.bfloat16)
    b16 = torch.randn(bt.shape[1], bt.shape[0], device=dev,
                      dtype=torch.bfloat16)
    bf16_ms = gpu_time_ms(torch, lambda: torch.matmul(a16, b16), n=5,
                          repeats=3)
    del a16, b16
    b_ms, b_by = bound(a.numel() + bt.numel() + 2 * m * n, 2 * m * n * k,
                       "float8")
    return {"shape": {"name": label, "form": form, "m": m, "n": n, "k": k},
            "dtype": f"{mod._format_of(a)}.{mod._format_of(bt)}->bf16",
            "max_abs_err": err, "tolerance": tol, "err_over_tol": over,
            "tolerance_rule": "K 2^-24 sum|a b| sa sb + half an ulp of "
                              "the output",
            "checks": [{"output": "bfloat16", "max_abs_err": err,
                        "tolerance": tol, "err_over_tol": over},
                       {"output": "float32", "max_abs_err": err32,
                        "tolerance": tol32, "err_over_tol": over32}],
            "repeats_bitwise": True, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "library_call": "torch._scaled_mm",
            "library_unavailable": why, "bf16_matmul_ms": bf16_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "tflop_per_s": 2 * m * n * k / ms / 1e9,
            "launches_per_o3_step": sites}


def fp8_gemm_cases(torch, mod, dev):
    """The fp8 GEMM in its three forms at each O3 shape (and the ragged
    one): the forward qx [M, K] . qw^T [N, K] (e4m3), dX qg [M, N] (e5m2)
    . qw [K, N], dW qx^T [K, M] . qg^T [N, M], from operands the plain
    quantize made of x ~ N(0, 1), w ~ N(0, 0.02^2) and g ~ N(0, 1e-8)
    with the scales their amaxes give."""
    out = []
    gen = torch.Generator(device=dev).manual_seed(21)
    for label, m, n, k, sites in FP8_SHAPES:
        x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
        w = (torch.randn(k, n, device=dev, generator=gen) * 0.02).bfloat16()
        g = (torch.randn(m, n, device=dev, generator=gen) * 1e-4).bfloat16()
        sx, sw = (t.float().abs().amax() / 448.0 for t in (x, w))
        sg = g.float().abs().amax() / 57344.0
        qx, qxt, _ = mod.quantize_reference(x, sx, "e4m3", True, True)
        qw, qwt, _ = mod.quantize_reference(w, sw, "e4m3", True, True)
        qg, qgt, _ = mod.quantize_reference(g, sg, "e5m2", True, True)
        del x, w, g
        for form, a, bt, sa, sb, dims in (
                ("forward", qx, qwt, sx, sw, (m, n, k)),
                ("dX", qg, qw, sg, sw, (m, k, n)),
                ("dW", qxt, qgt, sx, sg, (k, n, m))):
            out.append(_fp8_case(torch, mod, dev, label, form, a, bt, sa, sb,
                                 *dims, sites))
        del qx, qxt, qw, qwt, qg, qgt
        torch.cuda.empty_cache()
    return out


# the fp8 quantize's timed launches on the O3 step (bf16 inputs): role,
# shape, format, (codes, transposed codes, amax), launches a step
FP8_QUANTIZE_LAUNCHES = (
    ("x", (4096, 4096), "e4m3", (True, True, True), 5 * 8 + 1),
    ("x", (4096, 11008), "e4m3", (True, True, True), 8),
    ("w", (4096, 4096), "e4m3", (True, True, True), 4 * 8),
    ("w", (4096, 22016), "e4m3", (True, True, True), 8),
    ("w", (11008, 4096), "e4m3", (True, True, True), 8),
    ("w", (4096, 32000), "e4m3", (True, True, True), 1),
    ("g amax", (4096, 4096), "e5m2", (False, False, True), 5 * 8),
    ("g amax", (4096, 22016), "e5m2", (False, False, True), 8),
    ("g amax", (4096, 32000), "e5m2", (False, False, True), 1),
    ("g", (4096, 4096), "e5m2", (True, True, False), 5 * 8),
    ("g", (4096, 22016), "e5m2", (True, True, False), 8),
    ("g", (4096, 32000), "e5m2", (True, True, False), 1),
)


def fp8_quantize_cases(torch, mod, dev):
    """The quantize's codes (both layouts) bit-equal to the plain
    version's and its amax exact, for fp32, bf16 and fp16 inputs into
    e4m3 and e5m2, over values from 1e-4 to past the formats' range at
    [4096, 4096] and a ragged [1000, 520]; then each launch of the O3 step
    timed beside its bound (bytes: x read once, each layout of codes
    written once) and the plain version. The first case is the forward's
    x launch at the q/k/v/o shape."""
    gen = torch.Generator(device=dev).manual_seed(22)
    checked = []
    for shape in ((4096, 4096), (1000, 520)):
        mag = 10.0 ** (torch.rand(shape, device=dev, generator=gen) * 8 - 4)
        sign = torch.randint(0, 2, shape, device=dev, generator=gen) * 2 - 1
        base = mag * sign
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            x = base.to(dtype)
            for fmt in ("e4m3", "e5m2"):
                s = x.float().abs().amax() / 2 ** 12
                got = mod.quantize_cuda(x, s, fmt, True, True, True)
                want = mod.quantize_reference(x, s, fmt, True, True, True)
                for name, gt, wt in zip(("codes", "transposed", "amax"),
                                        got, want):
                    same = (torch.equal(gt.view(torch.uint8),
                                        wt.view(torch.uint8))
                            if name != "amax" else float(gt) == float(wt))
                    if not same:
                        fail(f"fp8 quantize {str(dtype)[6:]} -> {fmt} "
                             f"{list(shape)}: {name} differ from the plain "
                             f"version's")
                checked.append(f"{str(dtype)[6:]}->{fmt} {list(shape)}")
        del mag, sign, base, x
    out = []
    for role, shape, fmt, (rows, trans, amax), per_step in \
            FP8_QUANTIZE_LAUNCHES:
        x = torch.randn(shape, device=dev, generator=gen).bfloat16()
        s = x.float().abs().amax() / 448.0
        ms = gpu_time_ms(torch, lambda: mod.quantize_cuda(
            x, s, fmt, rows, trans, amax), n=10, repeats=5)
        plain = gpu_time_ms(torch, lambda: mod.quantize_reference(
            x, s, fmt, rows, trans, amax), n=3, repeats=3)
        numel = x.numel()
        b_ms, b_by = bound(2 * numel + numel * (rows + trans) + 4 * amax,
                           numel, "float8")
        lib = call = None
        if not (rows or trans):
            # the amax alone is one library call: max |x| in fp32
            lib = gpu_time_ms(torch, lambda: torch.linalg.vector_norm(
                x, float("inf"), dtype=torch.float32), n=10, repeats=5)
            call = "torch.linalg.vector_norm(x, inf, dtype=float32)"
        out.append({"shape": {"role": role, "rows": shape[0],
                              "cols": shape[1]},
                    "dtype": f"bfloat16->{fmt}",
                    "outputs": {"codes": rows, "transposed": trans,
                                "amax": amax},
                    "max_abs_err": 0.0, "tolerance": 0.0,
                    "err_over_tol": 0.0, "bit_equal": checked,
                    "ms": ms, "plain_ms": plain, "library_ms": lib,
                    "library_call": call,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "launches_per_o3_step": per_step})
        del x
    return out


def fp8_kernel_cases(torch, mod, dev):
    """Phase 3's fp8 rows: ``{"fp8_gemm": [...], "fp8_quantize":
    [...]}``."""
    return {"fp8_gemm": fp8_gemm_cases(torch, mod, dev),
            "fp8_quantize": fp8_quantize_cases(torch, mod, dev)}


def fp16_kernel_cases(torch, kernels, dev):
    """The fp16 kernels at the training shapes, each against its plain
    version run in fp16 on the card (tolerances as bf16's with fp16's
    ulp, ``REL_TOL``): RMSNorm forward and backward at [4096, 4096] (the
    O2 residual stream), rope forward and backward at [2, 2048, 32, 128],
    flash attention forward and backward (``FP16_FLASH_SHAPES``), and
    ``mt_sumsq`` / ``mt_adam`` (:func:`mt_fp16_cases`). Also: the fp16
    forward at head dim 256 runs and matches, and the fp16 backward there
    raises a TypeError naming ROADMAP.md queue B."""
    f16 = torch.float16
    rms, rope, flash = (kernels.rms_norm, kernels.rope,
                        kernels.flash_attention)
    out = {}
    g = torch.Generator(device=dev).manual_seed(25)
    rows, h = TRAIN_BATCH * TRAIN_SEQ, 4096
    x = torch.randn(rows, h, generator=g, device=dev).to(f16)
    w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(f16)
    y = rms.rms_norm_cuda(x, w, 1e-5)
    cs, worst = checks(torch, [cast_once(
        "y", y, rms.rms_norm_reference(x, w, 1e-5), REL_TOL["float32"],
        "float16")])
    b_ms, b_by = bound(2 * rows * h * 2 + h * 2, 4 * rows * h, "float16")
    out["rms_norm_fp16"] = [{
        "shape": [rows, h], "dtype": "float16", "checks": cs,
        "max_abs_err": worst["max_abs_err"], "tolerance": worst["tolerance"],
        "err_over_tol": worst["err_over_tol"],
        "ms": gpu_time_ms(torch, lambda: rms.rms_norm_cuda(x, w, 1e-5)),
        "plain_ms": gpu_time_ms(torch, lambda: rms.rms_norm_reference(
            x, w, 1e-5)),
        "library_ms": gpu_time_ms(torch, lambda: torch.nn.functional.rms_norm(
            x, (h,), w, 1e-5)),
        "library_call": "F.rms_norm", "bound_ms": b_ms, "bound_by": b_by}]
    del x, w, y
    out["rms_norm_bwd_fp16"] = rms_norm_bwd_cases(torch, rms, dev, (f16,))
    out["rope_fp16"] = rope_bwd_cases(torch, rope, dev, (f16,),
                                      inverse=False)
    out["rope_bwd_fp16"] = rope_bwd_cases(torch, rope, dev, (f16,))
    fwd, bwd = flash_cases(torch, flash, dev, FP16_FLASH_SHAPES)
    out["flash_attention_fwd_fp16"], out["flash_attention_bwd_fp16"] = \
        fwd, bwd
    # head dim 256: the forward on the 256-wide fp16 kernel, the backward
    # refused
    q, k, v = (torch.randn(1, 512, 8, 256, generator=g, device=dev).to(f16)
               for _ in range(3))
    o, lse = flash.flash_attention_cuda(q, k, v, True)
    ro, _ = flash.flash_attention_reference(q, k, v, True)
    cs, worst = checks(torch, [cast_once(
        "o", o, ro, REL_TOL["float32"], "float16",
        flash.probability_rounding_slack(q, k, v, lse, causal=True))])
    if worst["err_over_tol"] > 1.0:
        fail(f"flash forward fp16 D 256: {worst}")
    try:
        flash.flash_attention_backward_cuda(q, k, v, o, lse, o, True)
    except TypeError as e:
        if "queue B" not in str(e):
            fail(f"flash backward fp16 D 256 raised without its ROADMAP "
                 f"line: {e}")
    else:
        fail("flash backward fp16 D 256 ran: it has no fp16 kernel")
    log("kernel flash_attention fp16 D 256: " + json.dumps(
        {"forward": worst, "backward": "TypeError naming queue B"}))
    del q, k, v, o, lse, ro
    out.update(mt_fp16_cases(torch, kernels.fused_adam, dev))
    torch.cuda.empty_cache()
    return out


KERNELS = [
    # name, source, replaces (file:line of the TPU kernel)
    ("rms_norm", "paddle_tpu_torch/csrc/rms_norm.cu",
     "paddle_tpu/kernels/rms_norm.py:45"),
    ("rope", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/kernels/rope.py:60"),
    ("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
     "paddle_tpu/kernels/paged_attention.py:341"),
    ("rms_norm_bwd", "paddle_tpu_torch/csrc/rms_norm.cu",
     "paddle_tpu/kernels/rms_norm.py:93"),
    ("rope_bwd", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/kernels/rope.py:88"),
    ("flash_attention_fwd", "paddle_tpu_torch/csrc/flash_attention.cu",
     "jax/experimental/pallas/ops/tpu/flash_attention.py:758 "
     "(via paddle_tpu/kernels/flash_attention.py:260)"),
    ("flash_attention_bwd", "paddle_tpu_torch/csrc/flash_attention.cu",
     "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 and :1456 "
     "(via paddle_tpu/kernels/flash_attention.py:260)"),
    ("paged_attention_int8", "paddle_tpu_torch/csrc/paged_attention.cu",
     "paddle_tpu/kernels/paged_attention.py:341 "
     "(int8 flavour _paged_kernel_quant :253)"),
    ("int8_matmul", "paddle_tpu_torch/csrc/int8_matmul.cu",
     "paddle_tpu/kernels/int8_matmul.py:84"),
    ("rms_norm_matmul", "paddle_tpu_torch/csrc/fused_norm_matmul.cu",
     "paddle_tpu/kernels/fused_norm_matmul.py:55"),
    ("rope_attention", "paddle_tpu_torch/csrc/flash_attention.cu",
     "paddle_tpu/kernels/fused_rope_attention.py:111"),
    # no TPU kernel: the JAX custom_vjp's backward is plain jax (the VJP
    # of _composed_2d_tables), here the rope and flash kernels composed
    ("rope_attention_bwd", "paddle_tpu_torch/csrc/flash_attention.cu and "
     "paddle_tpu_torch/csrc/rope.cu, composed by "
     "paddle_tpu_torch/kernels/fused_rope_attention.py",
     "paddle_tpu/kernels/fused_rope_attention.py:153 (_bwd, plain jax; "
     "no pl.pallas_call)"),
    # no TPU kernel: the optimizer layer is plain jax that XLA fuses into
    # the jitted step; these are the port's counterpart of that fusion
    ("mt_sumsq", "paddle_tpu_torch/csrc/multi_tensor.cu",
     "paddle_tpu/jit/trainer.py:398-452 (the unscale, finite check and "
     "clip norms XLA fuses into the step; plain jax, no pl.pallas_call)"),
    ("mt_adam", "paddle_tpu_torch/csrc/multi_tensor.cu",
     "paddle_tpu/kernels/fused_adam.py:21 (fused_adam_update; "
     "_adam_update, paddle_tpu/optimizer/optimizer.py:44; plain jax, no "
     "pl.pallas_call)"),
    ("mt_momentum", "paddle_tpu_torch/csrc/multi_tensor.cu",
     "paddle_tpu/optimizer/optimizer.py:28 and :33 (_sgd_update, "
     "_momentum_update; plain jax, no pl.pallas_call)"),
    ("mt_lamb", "paddle_tpu_torch/csrc/multi_tensor.cu",
     "paddle_tpu/optimizer/optimizer.py:60 (_lamb_update; plain jax, no "
     "pl.pallas_call)"),
    # no TPU kernel: AMP O3's fp8 products and casts are XLA's
    ("fp8_gemm", "paddle_tpu_torch/csrc/fp8_matmul.cu",
     "paddle_tpu/amp/fp8.py:135 (_fp8_dot: XLA dot_general on fp8 "
     "operands, :135-139, :145-149, :160-168; no pl.pallas_call)"),
    ("fp8_quantize", "paddle_tpu_torch/csrc/fp8_matmul.cu",
     "paddle_tpu/amp/fp8.py:117 (_quantize and the amaxes of :157, "
     ":195-202; plain jax, no pl.pallas_call)"),
]
# the fp16 kernels in the kernels line: the same kernels at fp16 (cases:
# fp16_kernel_cases; launches: the fp16 phases' fp16 counters)
FP16_LINE = [(f"{name}_fp16", src, replaces) for name, src, replaces in
             KERNELS if name in ("rms_norm", "rms_norm_bwd", "rope",
                                 "rope_bwd", "flash_attention_fwd",
                                 "flash_attention_bwd", "mt_sumsq",
                                 "mt_adam")]
# launches per training step, from the model's structure: two RMSNorms
# per layer and the final one; one rope launch (q and k) per layer; one
# flash attention per layer; forward and backward each; and from the
# parameter list and the tables: AdamW with the global-norm clip is one
# sum of squares over the 75 gradients and one update call (one bucket:
# every parameter has the rate and weight decay 0.01), each one table:
# three sum-of-squares launches (chunks, per-tensor sums, finalize) and one
# Adam launch
TRAIN_PER_STEP = {
    "rms_norm": 2 * TRAIN_LAYERS + 1, "rms_norm_bwd": 2 * TRAIN_LAYERS + 1,
    "rope": TRAIN_LAYERS, "rope_bwd": TRAIN_LAYERS,
    "flash_attention_fwd": TRAIN_LAYERS, "flash_attention_bwd": TRAIN_LAYERS,
    "paged_attention": 0, "paged_attention_int8": 0, "int8_matmul": 0,
    "rms_norm_matmul": 0, "rope_attention": 0, "rope_attention_bwd": 0,
    "mt_sumsq": mt_launches("mt_sumsq"), "mt_adam": mt_launches("mt_adam"),
    "mt_momentum": 0, "mt_lamb": 0, "fp8_gemm": 0, "fp8_quantize": 0,
}
# the same with both fusions: the final norm goes into the fused head
# (whose backward is the plain version's VJP), and rope + flash into the
# fused attention, whose backward composes one rope, one flash forward,
# one flash backward (fp32, the split design) and one rope backward
# launch a layer
FUSED_TRAIN_PER_STEP = dict(
    TRAIN_PER_STEP, rms_norm=2 * TRAIN_LAYERS,
    rms_norm_bwd=2 * TRAIN_LAYERS, rms_norm_matmul=1,
    rope_attention=TRAIN_LAYERS, rope_attention_bwd=TRAIN_LAYERS)
FUSED_TRAIN_STEPS = 3
# the fp32 steps (``amp_level=None``, the trainer's default) on the reset
# model after the fused ones: the unfused step's launches, flash on its
# tensor-core (split) design; then the same with both fusions: the fused
# step's launches, both fusions on their split designs
FP32_TRAIN_STEPS = 3
FUSED_FP32_TRAIN_STEPS = 3
BOTH_FUSIONS = ("rms_norm_matmul", "rope_attention")
# the fused O1 training step-1 loss against the unfused one, relative: the
# unfused head multiplies in bf16 (``linear`` is white-listed) and rounds
# the logits to bf16, and the unfused rope rounds the rotated q and k to
# bf16; the fused path keeps all three in fp32, as the JAX package does.
# Round-to-nearest errors of 2^-9 per logit average out over 4096 tokens;
# the bound is the one the CPU O1 trajectory test holds against JAX
# (tests/test_torch_train.py, 1e-3) for rounding at other places
FUSED_LOSS_RTOL = 1e-3
# the fused fp32 step-1 loss against the unfused fp32 one, relative: both
# sides are fp32 and nothing is rounded to a narrower type on either
# (the rope-on-load pre-pass rotates in the rope kernel's op order and
# keeps the rotated q and k whole in three parts, as the unfused path's
# flash split does); only the head's fp32 sums run in another order
# (split products against cuBLAS), which moves a logit by a few fp32
# ulps: the tiny train parity's bound for fp32 math in other orders
FUSED_FP32_LOSS_RTOL = TINY_LOSS_RTOL
# W8A16 launches per forward of the quantized 7B (decode step or prefill):
# q, k, v, o, gate+up and down in each of 32 layers, and the head
QUANT_MM_PER_FORWARD = 6 * 32 + 1


# ------------------------------------------------------- small parity
# tiny fp32 models beyond the two below: (hidden, heads, kv heads), head
# dim 96 with MQA, head dim 80 with GQA, 16 query heads on one kv head,
# and head dim 72 (not a multiple of 16: padded on the card) with GQA
SMALL_PARITY_SHAPES = ((384, 4, 1), (320, 4, 2), (256, 16, 1), (288, 4, 2))


def _paged_equals_generate(torch, np, dev, cfg, label):
    """A tiny fp32 model's paged-engine and slab-engine greedy streams,
    both through their programs (CUDA graphs), against ``generate`` with
    an fp32 slab cache, token for token; returns the model."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import PagedServingEngine, ServingEngine

    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=4)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 256, (n,)) for n in (9, 17, 30, 5)]
    news = [12, 5, 9, 16]
    kw = dict(max_batch_size=2, max_seq_len=64, min_bucket=8,
              cache_dtype="float32")
    for kind, eng in (("paged", PagedServingEngine(net, page_size=8, **kw)),
                      ("slab", ServingEngine(net, **kw))):
        hs = [eng.submit(p, m) for p, m in zip(prompts, news)]
        eng.run_until_idle()
        for h, p, m in zip(hs, prompts, news):
            want = net.generate(p[None], max_new_tokens=m,
                                cache_dtype="float32")[0].cpu().numpy()
            if h.status != "DONE" or not np.array_equal(h.output_ids, want):
                fail(f"small parity ({label}): {kind} engine stream "
                     f"{h.output_ids.tolist()} != generate {want.tolist()}")
        if eng.pool.occupancy:
            fail(f"small parity ({label}): the {kind} engine leaked")
        if not eng.compile_counts()["serving::decode_step"]:
            fail(f"small parity ({label}): the {kind} engine captured no "
                 f"decode program")
    return net, prompts, news


def small_parity(torch, np, dev):
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.quantization import quantize_for_serving
    from paddle_tpu_torch.serving import PagedServingEngine, ServingEngine

    for hidden, heads, kvh in SMALL_PARITY_SHAPES:
        cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=hidden,
                               intermediate_size=512, num_hidden_layers=2,
                               num_attention_heads=heads,
                               num_key_value_heads=kvh)
        _paged_equals_generate(torch, np, dev, cfg,
                               f"D={hidden // heads}, H={heads}, kvH={kvh}")
    for kvh in (None, 2):
        cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                               intermediate_size=512, num_hidden_layers=2,
                               num_attention_heads=4,
                               num_key_value_heads=kvh)
        net, prompts, news = _paged_equals_generate(torch, np, dev, cfg,
                                                    f"kvH={kvh}")
        # the same model quantized: int8 weights and an int8 KV cache
        quantize_for_serving(net, inplace=True)
        for kind, eng in (
                ("paged", PagedServingEngine(
                    net, max_batch_size=2, max_seq_len=64, page_size=8,
                    min_bucket=8, cache_dtype="int8")),
                ("slab", ServingEngine(net, max_batch_size=2, max_seq_len=64,
                                       min_bucket=8, cache_dtype="int8"))):
            hs = [eng.submit(p, m) for p, m in zip(prompts, news)]
            eng.run_until_idle()
            for h, p, m in zip(hs, prompts, news):
                want = net.generate(p[None], max_new_tokens=m,
                                    cache_dtype="int8")[0].cpu().numpy()
                if h.status != "DONE" or not np.array_equal(h.output_ids,
                                                            want):
                    fail(f"small int8 parity (kvH={kvh}): {kind} engine "
                         f"stream {h.output_ids.tolist()} != generate "
                         f"{want.tolist()}")
            if eng.pool.occupancy:
                fail(f"small int8 parity: the {kind} engine leaked")
    log("small parity: tiny fp32 Llama (MHA and GQA kvH=2; D 96 MQA, D 80 "
        "GQA kvH=2, 16 heads on 1 kv head, D 72 GQA kvH=2), paged and slab "
        "engines (CUDA graphs) == generate token for token; quantized "
        "(int8 weights, int8 KV; MHA and GQA), paged and slab engines "
        "== generate(cache_dtype='int8')")


# ------------------------------------------------------- prefix parity
# the tiny prefix-cache engines: 2 rows of 64 slots, pages of 8 and an
# arena of 12 pages (two rows at full depth need 16: a growth that
# eviction cannot cover sheds a request)
PREFIX_PARITY_KW = dict(max_batch_size=2, max_seq_len=64, min_bucket=8,
                        page_size=8, num_pages=12)


def _kv_leaves(caches):
    """Every tensor of a cache list: K and V, an int8 cache's values and
    scales."""
    from paddle_tpu_torch.quantization.kv import is_quantized

    out = []
    for pair in caches:
        for t in pair:
            out += [t.q, t.scale] if is_quantized(t) else [t]
    return out


def published_vs_prefill(torch, eng, tokens, valid):
    """The pages the prefix cache holds for ``tokens[:valid]`` (published
    by a finished request: its prompt by the prefill, its answer by the
    decode steps) against one prefill of the same tokens into a fresh
    cache of the engine's dtype: whether they are bit-equal, the largest
    |difference|, the elements that differ and the elements compared."""
    from paddle_tpu_torch.models.generation import alloc_kv_caches

    ps = eng.page_size
    m = eng.prefix_cache.match(tokens, valid, eng.weights_version)
    if m.covered != valid:
        return {"not_measured": f"the cache covers {m.covered} of {valid} "
                                f"published positions (evicted)"}
    bucket = eng.pool.bucket_for(valid)
    ids = torch.zeros((1, bucket), dtype=torch.long, device=eng.device)
    ids[0, :valid] = torch.as_tensor(list(tokens[:valid]),
                                     device=eng.device)
    ref = alloc_kv_caches(eng.config, 1, bucket, eng.cache_dtype,
                          device=eng.device)
    with torch.inference_mode():
        eng.net(ids, caches=ref, pos=0)
    worst, differ, total = 0.0, 0, 0
    for i, page in enumerate(m.pages):
        rows = min(ps, valid - i * ps)
        for a, r in zip(_kv_leaves(eng._caches), _kv_leaves(ref)):
            got = a[page][:rows].float()
            want = r[0][i * ps:i * ps + rows].float()
            worst = max(worst, float((got - want).abs().max()))
            differ += int((got != want).sum())
            total += got.numel()
    return {"bit_equal": differ == 0, "max_abs_diff": worst,
            "elements_differing": differ, "elements": total}


def _prefix_parity_run(torch, np, net, cache, label, gate):
    """One tiny prefix engine (graphs, warmed) through traffic that forces
    full-page hits, a copy-on-write clone, a second turn over
    decode-published pages, evictions and one ``pages_exhausted`` shed.
    Fails (when ``gate``) unless every finished stream equals
    ``generate`` token for token (the shed one its prefix); always
    unless the pages the warm admissions shared kept their bytes, the
    counters moved and the arena drained. Returns the numbers it
    prints."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import (REASON_PAGES_EXHAUSTED,
                                          PagedServingEngine)

    eng = PagedServingEngine(net, cache_dtype=cache, prefix_cache=True,
                             **PREFIX_PARITY_KW)
    warmed = eng.warmup()["programs"]
    report_memory(eng, f"prefix parity ({label})")
    captures = eng.compile_counts()
    pc, pool = eng.prefix_cache, eng.page_pool
    rng = np.random.RandomState(21)
    vocab = net.config.vocab_size
    prefix = rng.randint(0, vocab, (24,))
    handles = []

    def run(prompts, news):
        hs = [eng.submit(p, m) for p, m in zip(prompts, news)]
        eng.run_until_idle()
        handles.extend(hs)
        return hs

    def tail(n):
        return rng.randint(0, vocab, (n,))

    kernels.reset_launch_counts()
    (first,) = run([np.concatenate([prefix, tail(5)])], [10])
    toks = [int(t) for t in first.output_ids]
    valid = first.request.prompt_len + len(first.tokens) - 1
    shared = pc.match(toks, valid, eng.weights_version).pages
    before = [t[shared].clone() for t in _kv_leaves(eng._caches)]
    published = published_vs_prefill(torch, eng, toks, valid)
    if "not_measured" in published:
        fail(f"prefix parity ({label}): {published['not_measured']}")
    # warm: another tail (full pages), the first 21 prefix tokens (the
    # boundary inside a cached page: a clone), a second turn over the
    # first request's answer
    run([np.concatenate([prefix, tail(6)]), prefix[:21],
         np.concatenate([first.output_ids, tail(4)])], [8, 8, 6])
    if not all(torch.equal(t[shared], b)
               for t, b in zip(_kv_leaves(eng._caches), before)):
        fail(f"prefix parity ({label}): a warm admission wrote a shared "
             f"page")
    # cold prompts fill the arena (evictions), then two rows that need
    # 16 pages of 12: one sheds
    run([tail(20) for _ in range(3)], [12] * 3)
    run([tail(10), tail(10)], [54, 54])
    counts = kernels.launch_counts()
    st, ps = pc.stats(), pool.stats()
    want = {"hits": 3, "misses": 6}
    if {k: st[k] for k in want} != want or st["cow_clones"] < 1 \
            or st["evictions"] < 1:
        fail(f"prefix parity ({label}): prefix stats {st}, expected {want}"
             f", a clone and evictions")
    sheds = [h for h in handles if h.status != "DONE"]
    if [(h.status, h.reason) for h in sheds] != [
            ("CANCELLED", REASON_PAGES_EXHAUSTED)]:
        fail(f"prefix parity ({label}): expected one pages_exhausted shed, "
             f"got {[(h.status, h.reason) for h in sheds]}")
    if eng.compile_counts() != captures:
        fail(f"prefix parity ({label}): captures during traffic: "
             f"{eng.compile_counts()} after warmup's {captures}")
    mismatched = 0
    for h in handles:
        want_ids = net.generate(
            h.request.input_ids[None], max_new_tokens=h.request.max_new_tokens,
            cache_dtype=cache)[0].cpu().numpy()[:len(h.output_ids)]
        if not np.array_equal(h.output_ids, want_ids):
            mismatched += 1
            if gate:
                fail(f"prefix parity ({label}): request "
                     f"{h.request.request_id} stream "
                     f"{h.output_ids.tolist()} != generate "
                     f"{want_ids.tolist()}")
    eng.close()
    end = pool.stats()
    if end["pages_in_use"] or end["claims"] != end["releases"] \
            or pool._refs:
        fail(f"prefix parity ({label}): not drained after close: {end}")
    res = {"cache": cache, "programs": warmed, "prefix": st,
           "peak_pages_in_use": ps["peak_pages_in_use"],
           "shed": len(sheds), "streams_unequal_generate": mismatched,
           "decode_published": published,
           "launches": {k: v for k, v in counts.items() if v}}
    log(f"prefix parity ({label}): " + json.dumps(res))
    return res


def prefix_parity(torch, np, dev):
    """The prefix cache's tiny card parity: a tiny fp32 GQA Llama on a
    prefix engine with an fp32 arena (streams gated against
    ``generate``) and a bf16 one (measured: streams and decode-published
    KV), then the same model quantized (int8 weights and arena, gated
    against ``generate(cache_dtype="int8")``)."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_for_serving

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2)
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=4)
    out = {"float32": _prefix_parity_run(torch, np, net, "float32", "fp32",
                                         True),
           "bfloat16": _prefix_parity_run(torch, np, net, "bfloat16",
                                          "fp32 model, bf16 arena", False)}
    quantize_for_serving(net, inplace=True)
    out["int8"] = _prefix_parity_run(torch, np, net, "int8", "int8", True)
    return out


# ------------------------------------------------------- spec parity
# the tiny speculative engines: 2 rows of 64 slots from bucket 8; the
# paged ones with demand paging and pages of 4 (a rejected tail often
# crosses a page, so rollbacks happen)
SPEC_PARITY_KW = dict(max_batch_size=2, max_seq_len=64, min_bucket=8)


class RowRecorder:
    """Records the logits rows an engine computes for its requests, keyed
    by (request index, position of the fed token): the decode step's rows
    of every active row (``eng._programs.run`` of ``("decode",)``), and the
    verify's rows (``eng._spec_verify``) with the ids they were scored
    with (a row is a stream's row only where the stream holds those ids).
    A decode replay that serves a verify (the paged engine's) is recorded
    as the verify's. Installed until ``remove()``."""

    def __init__(self, eng, handles):
        self.eng = eng
        self.index = {id(h): j for j, h in enumerate(handles)}
        self.rows = {}
        self.in_verify = False
        run = eng._programs.run

        def recording_run(key, build, *arrays):
            out = run(key, build, *arrays)
            if key == ("decode",) and not self.in_verify:
                self._record_decode(arrays, out)
            return out

        eng._programs.run = recording_run
        if eng.speculative is not None:
            verify = eng._spec_verify

            def recording_verify(slot, ids, pos):
                self.in_verify = True
                try:
                    out = verify(slot, ids, pos)
                finally:
                    self.in_verify = False
                self._record_verify(slot, ids, pos, out)
                return out

            eng._spec_verify = recording_verify

    def add(self, handles):
        self.index.update({id(h): len(self.index) + j
                           for j, h in enumerate(handles)})

    def _record_decode(self, arrays, out):
        logits, pos = out[0], arrays[1]
        for i, seq in enumerate(self.eng._seqs):
            j = None if seq is None else self.index.get(id(seq.handle))
            if j is not None:
                self.rows[(j, int(pos[i]))] = (None, logits[i].float().cpu())

    def _record_verify(self, slot, ids, p, out):
        j = self.index.get(id(self.eng._seqs[slot].handle))
        if j is None:
            return
        rows = out.float().cpu()
        for i in range(ids.shape[1]):
            self.rows[(j, p + i)] = ((p, tuple(int(t) for t in
                                               ids[0, :i + 1])), rows[i])

    def remove(self):
        del self.eng._programs.run
        if self.eng.speculative is not None:
            del self.eng._spec_verify


def compare_rows(np, verify, vanilla, spec_handles, vanilla_handles):
    """Verify rows against vanilla rows at the same position of the same
    request, where both streams hold the same tokens up to it and the
    verify row was scored with them: rows compared, rows bit-equal, the
    largest |difference| and the rows whose argmax differs."""
    n = same = flips = 0
    worst = 0.0
    for (j, q), (ctx, row) in verify.rows.items():
        v = vanilla.rows.get((j, q))
        if v is None or ctx is None:
            continue
        a = np.asarray(spec_handles[j].output_ids)
        b = np.asarray(vanilla_handles[j].output_ids)
        p, ids = ctx
        if len(a) <= q or len(b) <= q or not np.array_equal(a[:q + 1],
                                                              b[:q + 1]) \
                or tuple(a[p:q + 1]) != ids:
            continue
        d = float((row - v[1]).abs().max())
        n += 1
        same += d == 0.0
        worst = max(worst, d)
        flips += int(row.argmax()) != int(v[1].argmax())
    return {"rows": n, "rows_bit_equal": same, "max_abs_diff": worst,
            "argmax_differs": flips}


def traffic_captures(eng):
    """``compile_counts()`` without the key that moves during traffic: a
    paged speculative engine's ``serving::spec_verify`` counts its verify
    replays of the decode program, not captures."""
    counts = eng.compile_counts()
    if eng._spec_verify_in_arena:
        counts.pop("serving::spec_verify", None)
    return counts


def _tokens_differing(np, a, b):
    return sum(int((np.asarray(x.output_ids) != np.asarray(y.output_ids))
                   .sum()) for x, y in zip(a, b))


def spec_parity(torch, np, dev):
    """Speculative decoding on tiny models: a GQA fp32 Llama with an fp32,
    a bf16 and an int8 cache, on the slab engine and the paged engine with
    demand paging (graphs, warmed), with the early exit at layer 1 of 2
    and a separate 1-layer draft, against the vanilla engine of the same
    kind and cache. Fails unless fp32 speculative streams equal vanilla
    token for token, bf16 and int8 tokens pass the teacher-forced check
    (differences counted), the slab's int8 verify is sequential, nothing
    is captured during traffic, the paged pools drain (claims ==
    releases) after rollbacks; unless the paged engine's verify rows (its
    decode program replayed over the arena) equal its vanilla rows bit
    for bit and its streams equal vanilla's in every cache (C item 3;
    the slab's rows are printed); unless the last-layer exit accepts
    every proposal,
    sampled fp32 speculative streams are equal on slab and paged; and
    unless a tiny fp32 beam search on the card equals the CPU's with its
    EOS freeze. Returns the phase's launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (PagedServingEngine, ServingEngine,
                                          SpeculativeDecoder)

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2)
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=4)
    draft = LlamaForCausalLM(LlamaConfig.tiny(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=1, num_attention_heads=2), device=dev,
        dtype=torch.float32, seed=9)
    rng = np.random.RandomState(31)
    prompts = [rng.randint(0, 256, (n,)) for n in (9, 17, 30, 5)]
    news = [12, 20, 9, 16]

    def make(kind, cache, spec=None, **kw):
        if kind == "slab":
            return ServingEngine(net, cache_dtype=cache, speculative=spec,
                                 **SPEC_PARITY_KW, **kw)
        return PagedServingEngine(net, cache_dtype=cache, page_size=4,
                                  demand_paging=True, speculative=spec,
                                  **SPEC_PARITY_KW, **kw)

    def run(eng, label, record=False):
        eng.warmup()
        report_memory(eng, f"spec parity ({label})")
        captures = traffic_captures(eng)
        hs = [eng.submit(p, m) for p, m in zip(prompts, news)]
        rec = RowRecorder(eng, hs) if record else None
        eng.run_until_idle()
        if rec is not None:
            rec.remove()
        for h, m in zip(hs, news):
            if h.status != "DONE" or len(h.tokens) != m:
                fail(f"spec parity ({label}): status {h.status}, "
                     f"{len(h.tokens)} of {m} tokens")
        if traffic_captures(eng) != captures:
            fail(f"spec parity ({label}): captures during traffic: "
                 f"{captures} -> {traffic_captures(eng)}")
        eng.close()
        if hasattr(eng, "page_pool"):
            st = eng.page_pool.stats()
            if st["pages_in_use"] or st["claims"] != st["releases"]:
                fail(f"spec parity ({label}): not drained: {st}")
        return hs, rec

    kernels.reset_launch_counts()
    res, rolled_back = {}, 0
    for cache in ("float32", "bfloat16", "int8"):
        for kind in ("slab", "paged"):
            van, van_rec = run(make(kind, cache), f"{kind} {cache} vanilla",
                               record=True)
            for mode in ("exit", "draft"):
                label = f"{kind} {cache} {mode}"
                spec = (SpeculativeDecoder(exit_layer=1, k=3)
                        if mode == "exit" else SpeculativeDecoder(draft, k=4))
                eng = make(kind, cache, spec)
                hs, rec = run(eng, label, record=True)
                st = spec.stats()
                if st["sequential_verify"] != (cache == "int8"
                                               and kind == "slab"):
                    fail(f"spec parity ({label}): sequential verify "
                         f"{st['sequential_verify']}")
                differ = _tokens_differing(np, hs, van)
                if (cache == "float32" or kind == "paged") and differ:
                    fail(f"spec parity ({label}): {differ} tokens differ from "
                         f"the vanilla engine: "
                         f"{[h.tokens for h in hs]} != "
                         f"{[h.tokens for h in van]}")
                if cache != "float32":
                    teacher_forced(torch, dev, hs, lambda ids: net(ids)[0],
                                   f"spec parity ({label})")
                if kind == "paged":
                    rolled_back += eng.spec_pages_rolled_back
                res[label] = {
                    "tokens_differing_from_vanilla": differ,
                    "rounds": st["rounds"], "proposed": st["proposed"],
                    "accepted": st["accepted"],
                    "mean_accept_length": st["mean_accept_length"]}
                rows = compare_rows(np, rec, van_rec, hs, van)
                res[label]["verify_rows_vs_vanilla"] = rows
                if kind == "paged" and not (
                        rows["rows"] and rows["rows_bit_equal"] == rows["rows"]):
                    fail(f"spec parity ({label}): paged verify rows against "
                         f"vanilla rows: {rows}")
    if not rolled_back:
        fail("spec parity: no paged round rolled a page back")
    # the last layer as the draft: it is the target, every proposal holds
    spec = SpeculativeDecoder(exit_layer=2, k=3, draft_cache_dtype="float32")
    hs, _ = run(make("slab", "float32", spec), "final layer")
    st = spec.stats()
    if not (st["proposed"] and st["accepted"] == st["proposed"]
            and st["mean_accept_length"] > 1):
        fail(f"spec parity (final layer): {st}")
    res["final layer"] = st
    # sampled: position-addressed keys make slab and paged streams equal
    samp = dict(do_sample=True, temperature=0.9, top_k=20, top_p=0.95,
                seed=7)
    sampled = [run(make(kind, "float32", SpeculativeDecoder(draft, k=3),
                        **samp), f"{kind} sampled")[0]
               for kind in ("slab", "paged")]
    if [h.tokens for h in sampled[0]] != [h.tokens for h in sampled[1]]:
        fail("spec parity: sampled speculative streams differ between the "
             "slab and the paged engine")
    res["paged_pages_rolled_back"] = rolled_back
    res["beam"] = _tiny_beam(torch, np, dev, net, cfg)
    counts = kernels.launch_counts()
    res["launches"] = {k: v for k, v in counts.items() if v}
    log("spec parity: " + json.dumps(res))
    return counts


def _tiny_beam(torch, np, dev, net, cfg):
    """The tiny net's beam search (B 2, 3 beams, fp32 cache) on the card,
    as its program (a CUDA graph) and with ``graphs=False``, against the
    same weights on the CPU, token for token, without and with an EOS
    (the winner's second token): after its first EOS a row emits only
    EOS."""
    from paddle_tpu_torch.convert import load_numpy_state, numpy_state
    from paddle_tpu_torch.models import LlamaForCausalLM

    cpu = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_state(cpu, numpy_state(net))
    ids = np.random.RandomState(32).randint(0, 256, (2, 11))
    kw = dict(max_new_tokens=10, num_beams=3, cache_dtype="float32")

    def both(**extra):
        card = net.generate(torch.as_tensor(ids, device=dev), **kw,
                            **extra).cpu().numpy()
        eager = net.generate(torch.as_tensor(ids, device=dev), **kw,
                             graphs=False, **extra).cpu().numpy()
        want = cpu.generate(ids, **kw, **extra).numpy()
        if not (np.array_equal(card, want) and np.array_equal(eager, want)):
            fail(f"spec parity: tiny beam search ({extra}) on the card "
                 f"{card.tolist()} (program), {eager.tolist()} (eager) != "
                 f"the CPU's {want.tolist()}")
        return card

    free = both()
    eos = int(free[0, 12])
    frozen = both(eos_token_id=eos)
    for row in frozen[:, 11:]:
        hit = np.flatnonzero(row == eos)
        if len(hit) and (row[hit[0]:] != eos).any():
            fail(f"spec parity: a beam emitted past its EOS: {row.tolist()}")
    return {"tokens": free[:, 11:].tolist(),
            "tokens_eos": frozen[:, 11:].tolist(), "eos": eos,
            "equal_to_cpu": True}


def fused_parity(torch, np, dev):
    """A tiny fp32 MHA Llama (head_dim 64) with both fusions: its
    cache-free logits on the card against the
    same model's on the CPU, 2e-5 absolute + 1e-4 relative (the CPU
    tests' model bound)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import load_numpy_state, numpy_state
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=13,
                           fusions=BOTH_FUSIONS)
    net = LlamaForCausalLM(cfg, device=dev, fusions=BOTH_FUSIONS)
    load_numpy_state(net, numpy_state(cpu))
    ids = np.random.RandomState(14).randint(0, 256, (2, 100))
    with torch.inference_mode():
        want = cpu(torch.as_tensor(ids)).numpy()
        kernels.reset_launch_counts()
        got = net(torch.as_tensor(ids, device=dev)).float().cpu().numpy()
        counts = kernels.launch_counts()
    if counts["rope_attention"] != cfg.num_hidden_layers \
            or counts["rms_norm_matmul"] != 1 or counts["flash_attention_fwd"]:
        fail(f"fused parity: launches {counts}")
    err = np.abs(got - want)
    tol = 2e-5 + 1e-4 * np.abs(want)
    if not (err <= tol).all():
        fail(f"fused parity: logits differ by {float(err.max())} (largest "
             f"error over tolerance {float((err / tol).max())})")
    log("fused parity: " + json.dumps({
        "max_abs_err": float(err.max()),
        "err_over_tol": float((err / tol).max()),
        "tolerance": "2e-5 absolute + 1e-4 relative", "launches": counts}))


# -------------------------------------------------- tiny train parity
# the optimizer, clip, decay and scaler cases of the tiny train parity and
# of the optimizer sub-phase (tests/test_torch_train.py holds the same
# kinds against the JAX trainer on the CPU): name -> (rate, builder(
# optimizer module, named parameters, rate, epsilon))
def _mlp_groups(o, named):
    """The MLP weights in a group with an ``L2Decay`` and half the rate."""
    mlp = [x for x in named if ".mlp." in x[0]]
    rest = [x for x in named if ".mlp." not in x[0]]
    return [{"params": rest},
            {"params": mlp, "weight_decay": o.L2Decay(0.05),
             "learning_rate": 0.5}]


OPT_CASES = {
    "sgd": (0.1, lambda o, named, lr, eps: o.SGD(lr, parameters=named)),
    "nesterov_l2": (0.05, lambda o, named, lr, eps: o.Momentum(
        lr, 0.9, parameters=named, use_nesterov=True, weight_decay=1e-3)),
    "lamb_global": (1e-3, lambda o, named, lr, eps: o.Lamb(
        lr, 0.01, epsilon=eps, parameters=named,
        grad_clip=o.ClipGradByGlobalNorm(1.0))),
    # no sum of squares: every tensor's Lamb norms from the update alone
    "lamb_none": (1e-3, lambda o, named, lr, eps: o.Lamb(
        lr, 0.01, epsilon=eps, parameters=named)),
    "lamb_value": (1e-3, lambda o, named, lr, eps: o.Lamb(
        lr, 0.01, epsilon=eps, parameters=named,
        grad_clip=o.ClipGradByValue(0.05))),
    "adam_norm": (3e-4, lambda o, named, lr, eps: o.Adam(
        lr, epsilon=eps, parameters=named,
        grad_clip=o.ClipGradByNorm(1.0))),
    "adamw_value_l2_group": (3e-4, lambda o, named, lr, eps: o.AdamW(
        lr, epsilon=eps, parameters=_mlp_groups(o, named),
        weight_decay=0.01, grad_clip=o.ClipGradByValue(0.05))),
    "adamw_scaler": (3e-4, lambda o, named, lr, eps: o.AdamW(
        lr, epsilon=eps, parameters=named, weight_decay=0.01,
        grad_clip=o.ClipGradByGlobalNorm(1.0))),
}
# the scaler case's GradScaler, as in tests/test_torch_train.py: its first
# step overflows (a summed loss: the logits' gradient is about the scale,
# and 2^127 times an lm_head gradient entry above 2 is past fp32's largest
# value), then the scale falls by 2^-20 and doubles after 2 good steps
SCALER_KW = dict(init_loss_scaling=2.0 ** 127, decr_ratio=2.0 ** -20,
                 incr_every_n_steps=2, decr_every_n_nan_or_inf=1)


def opt_case_launches(case, layers):
    """Multi-tensor launches per step of an optimizer case on a model of
    ``layers`` layers (3 + 9 per layer parameters, 3 per layer in the MLP
    group): those of its sum of squares and of each update call."""
    n, mlp = 3 + 9 * layers, 3 * layers
    want = dict.fromkeys(MT_KERNELS, 0)
    sumsq = mt_launches("mt_sumsq", n)
    if case in ("sgd", "nesterov_l2"):
        want["mt_momentum"] = mt_launches("mt_momentum", n)
    elif case == "lamb_global":
        want.update(mt_sumsq=sumsq, mt_lamb=mt_launches("mt_lamb", n))
    elif case in ("lamb_none", "lamb_value"):  # no norm
        want["mt_lamb"] = mt_launches("mt_lamb", n)
    elif case == "adamw_value_l2_group":  # two buckets, no norm
        want["mt_adam"] = (mt_launches("mt_adam", n - mlp)
                           + mt_launches("mt_adam", mlp))
    else:  # adam_norm, adamw_scaler, and the AdamW + global clip steps
        want.update(mt_sumsq=sumsq, mt_adam=mt_launches("mt_adam", n))
    return want


def _scaler_state(scaler, opt):
    return [scaler._scale, scaler._good_steps, scaler._bad_steps,
            scaler._found_inf, opt._step_count]


def _tiny_step(torch, np, cfg, dev, weights, ids, case=None, steps=1):
    """``steps`` fp32 CompiledTrainSteps of the tiny model from
    ``weights``: AdamW with the global-norm clip (``case`` None) or an
    OPT_CASES case. Returns the losses, the parameters after and the
    scaler's state (or None)."""
    from paddle_tpu_torch import optimizer as o
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.convert import load_numpy_state, numpy_state
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, causal_lm_loss

    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    load_numpy_state(net, weights)
    named = list(net.named_parameters())
    if case is None:
        opt = o.AdamW(1e-3, epsilon=1e-3, parameters=named,
                      weight_decay=0.01,
                      grad_clip=o.ClipGradByGlobalNorm(1.0))
    else:
        rate, build = OPT_CASES[case]
        opt = build(o, named, rate, 1e-3)
    scaler = GradScaler(**SCALER_KW) if case == "adamw_scaler" else None
    if scaler is None:
        def loss_fn(lo, lb):
            return causal_lm_loss(lo, lb).mean()
    else:
        def loss_fn(lo, lb):
            return causal_lm_loss(lo, lb).sum()
    step = CompiledTrainStep(net, loss_fn, opt, scaler=scaler)
    t = torch.as_tensor(ids, dtype=torch.long, device=dev)
    losses = [float(step([t[:, :-1]], [t[:, 1:]])[0]) for _ in range(steps)]
    state = None if scaler is None else _scaler_state(scaler, opt)
    return losses, numpy_state(net), state


def _tiny_compare(np, label, card, cpu):
    """(worst parameter difference, its name); fails past the
    tolerances."""
    (l_gpu, p_gpu, s_gpu), (l_cpu, p_cpu, s_cpu) = card, cpu
    for a, b in zip(l_gpu, l_cpu):
        if not abs(a - b) <= TINY_LOSS_RTOL * abs(b):
            fail(f"tiny train parity {label}: loss {a} on the card, {b} "
                 f"on the CPU")
    if s_gpu != s_cpu:
        fail(f"tiny train parity {label}: scaler state {s_gpu} on the "
             f"card, {s_cpu} on the CPU")
    worst, worst_name = 0.0, ""
    for k, want in p_cpu.items():
        err = float(np.abs(p_gpu[k] - want).max())
        if err > worst:
            worst, worst_name = err, k
    if not worst <= TINY_PARAM_ATOL:
        fail(f"tiny train parity {label}: {worst_name} differs by {worst} "
             f"after the step (> {TINY_PARAM_ATOL})")
    return worst, worst_name


def tiny_train_parity(torch, np, dev):
    """One fp32 CompiledTrainStep of a 2-layer GQA Llama (head_dim 64,
    100 tokens: a ragged second 64-row block) on the card and on the CPU
    from the same weights, with AdamW and the global-norm clip; then the
    same for each optimizer case (the scaler case two steps: the
    overflowing one and one update), each case's multi-tensor launches
    counted on the card."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import numpy_state
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=128)
    weights = numpy_state(LlamaForCausalLM(cfg, device="cpu", seed=11))
    ids = np.random.RandomState(12).randint(0, 256, (2, 101))
    kernels.reset_launch_counts()
    gpu = _tiny_step(torch, np, cfg, dev, weights, ids)
    counts = kernels.launch_counts()
    cpu = _tiny_step(torch, np, cfg, "cpu", weights, ids)
    again = _tiny_step(torch, np, cfg, dev, weights, ids)
    not_here = ("paged_attention", "paged_attention_int8", "int8_matmul",
                *BOTH_FUSIONS, "rope_attention_bwd",  # serving only, and
                # the unfused model
                "mt_momentum", "mt_lamb",  # AdamW's step
                "fp8_gemm", "fp8_quantize")  # AMP O3 only
    missing = [k for k, n in counts.items()
               if n <= 0 and k not in not_here]
    if missing:
        fail(f"tiny train parity: kernels not launched on the card: "
             f"{missing}")
    worst, worst_name = _tiny_compare(np, "AdamW", gpu, cpu)
    repeats = again[0] == gpu[0] and all(
        np.array_equal(again[1][k], v) for k, v in gpu[1].items())
    cases = {}
    for case in OPT_CASES:
        steps = 2 if case == "adamw_scaler" else 1
        kernels.reset_launch_counts()
        card = _tiny_step(torch, np, cfg, dev, weights, ids, case, steps)
        mt = {k: v for k, v in kernels.launch_counts().items()
              if k in MT_KERNELS}
        want = {k: v * steps for k, v in opt_case_launches(
            case, cfg.num_hidden_layers).items()}
        if mt != want:
            fail(f"tiny train parity {case}: multi-tensor launches {mt}, "
                 f"expected {want}")
        cpu_ = _tiny_step(torch, np, cfg, "cpu", weights, ids, case, steps)
        err, name = _tiny_compare(np, case, card, cpu_)
        cases[case] = {"losses_card": card[0], "losses_cpu": cpu_[0],
                       "max_param_diff": err, "param": name,
                       "scaler_state": card[2], "launches": mt}
    log("tiny train parity: " + json.dumps({
        "loss_card": gpu[0][0], "loss_cpu": cpu[0][0],
        "max_param_diff": worst, "param": worst_name,
        "tolerance": {"loss_rtol": TINY_LOSS_RTOL,
                      "param_atol": TINY_PARAM_ATOL},
        "card_step_repeats_bitwise": repeats, "launches": counts,
        "optimizer_cases": cases}))


# tiny O3 parity on the card against the CPU: one O3 step of the tiny
# fp32 Llama from the same weights. Both sides cast to bf16 where O1 does
# and quantize to fp8 with the same scales (an empty history: 1), but a
# bf16 value that the card's kernels (RMSNorm, rope, flash attention) and
# the CPU's plain versions round apart flips an fp8 code now and then
# (e4m3's grid is 2^4 times coarser than bf16's, e5m2's 2^5), and the
# kernels' fp32 sums run in another order. A flipped e5m2 gradient code
# moves its term by a quarter, so the two sides' gradients part by about
# as much as O3's part from O1's (measured 6.5-12.7% of each parameter's
# largest entry, card against CPU; 3.5-15.4%, the CPU's O3 against its
# O1). Held: the loss within 2e-3 relative (as the port holds JAX's O3
# trainer on the CPU, tests/test_torch_fp8.py); the gradients the update
# read (AdamW's first moment after one step: (1 - beta1) times the
# clipped gradient) entry by entry within TINY_O3_GRAD_RTOL of each
# parameter's largest entry, twice the worst sound reading, so the O3
# backward is held end to end against a wrong scale, layout or format;
# the parameters after the update within TINY_O3_PARAM_ATOL, the
# learning rate (measured 4.95e-4; a step moves an entry by less than
# the rate); the histories' keys equal, the weights' amaxes bit-equal
# (the same weights cast to bf16), the activations' within one e4m3
# step, 2^-3 relative. A control on the CPU, the dX product doubled (a
# scale applied twice), must fail both the gradient and the parameter
# limits
TINY_O3_LOSS_RTOL, TINY_O3_HIST_RTOL = 2e-3, 2.0 ** -3
TINY_O3_GRAD_RTOL, TINY_O3_PARAM_ATOL = 0.25, 1e-3
TINY_O3_LR = 1e-3


def _tiny_o3_step(torch, np, cfg, dev, weights, ids, level="O3"):
    """One CompiledTrainStep (AdamW, the global-norm clip) of the tiny
    model from ``weights`` at ``level``: (loss, parameters after,
    histories, AdamW's first moments)."""
    from paddle_tpu_torch import optimizer as o
    from paddle_tpu_torch.convert import load_numpy_state, numpy_state
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, causal_lm_loss

    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    load_numpy_state(net, weights)
    opt = o.AdamW(TINY_O3_LR, epsilon=1e-3, parameters=list(
        net.named_parameters()), weight_decay=0.01,
        grad_clip=o.ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt,
        amp_level=level)
    t = torch.as_tensor(ids, dtype=torch.long, device=dev)
    loss = float(step([t[:, :-1]], [t[:, 1:]])[0])
    moments = {k: opt._accumulators[(k, "moment1")].cpu().numpy()
               for k, _ in net.named_parameters()}
    return loss, numpy_state(net), step.fp8_state_dict(), moments


def _grad_rel(np, got, want):
    """``{name: max |got - want| / max |want|}`` over parameters."""
    return {k: float(np.abs(got[k] - v).max() / max(np.abs(v).max(),
                                                    1e-30))
            for k, v in want.items()}


def tiny_o3_parity(torch, np, dev):
    """One AMP O3 step of the tiny model of ``tiny_train_parity`` on the
    card and on the CPU from the same weights (TINY_O3_* tolerances),
    and one O1 step on the CPU for the distance fp8 makes; the card's
    step launched the fp8 kernels 3 and 4 times a site."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import numpy_state
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=128)
    weights = numpy_state(LlamaForCausalLM(cfg, device="cpu", seed=11))
    ids = np.random.RandomState(12).randint(0, 256, (2, 101))
    kernels.reset_launch_counts()
    l_gpu, p_gpu, h_gpu, m_gpu = _tiny_o3_step(torch, np, cfg, dev, weights,
                                               ids)
    counts = kernels.launch_counts()
    l_cpu, p_cpu, h_cpu, m_cpu = _tiny_o3_step(torch, np, cfg, "cpu",
                                               weights, ids)
    m_o1 = _tiny_o3_step(torch, np, cfg, "cpu", weights, ids, "O1")[3]
    gemm = kernels.fp8_matmul.gemm

    def dx_doubled(a, bt, sa, sb, out_dtype):
        out = gemm(a, bt, sa, sb, out_dtype)
        # the dX form: the e5m2 gradient times the e4m3 weight
        return out * 2 if a.dtype == torch.float8_e5m2 \
            and bt.dtype == torch.float8_e4m3fn else out

    kernels.fp8_matmul.gemm = dx_doubled
    try:
        _, p_ctl, _, m_ctl = _tiny_o3_step(torch, np, cfg, "cpu", weights,
                                           ids)
    finally:
        kernels.fp8_matmul.gemm = gemm
    ctl_grad = max(_grad_rel(np, m_ctl, m_cpu).values())
    ctl_param = max(float(np.abs(p_ctl[k] - v).max())
                    for k, v in p_cpu.items())
    sites = 6 * cfg.num_hidden_layers + 1
    want = {"fp8_gemm": FP8_GEMM_PER_SITE * sites,
            "fp8_quantize": FP8_QUANTIZE_PER_SITE * sites}
    got = {k: counts[k] for k in want}
    diffs = {k: float(np.abs(p_gpu[k] - v).max()) for k, v in p_cpu.items()}
    worst = max(diffs, key=diffs.get)
    grad = _grad_rel(np, m_gpu, m_cpu)
    fp8_grad = _grad_rel(np, m_cpu, m_o1)
    g_worst = max(grad, key=grad.get)
    hist_rel = {}
    for k, v in h_cpu.items():
        live = v > 0
        hist_rel[k] = float((np.abs(h_gpu[k][live] - v[live])
                             / v[live]).max()) if live.any() else 0.0
    res = {"loss_card": l_gpu, "loss_cpu": l_cpu,
           "loss_rel": abs(l_gpu - l_cpu) / abs(l_cpu),
           "max_grad_rel": grad[g_worst], "grad_param": g_worst,
           "median_grad_rel": float(np.median(list(grad.values()))),
           "grad_rel": grad,
           "cpu_o3_vs_o1_grad_rel": {
               "min": min(fp8_grad.values()),
               "median": float(np.median(list(fp8_grad.values()))),
               "max": max(fp8_grad.values())},
           "cpu_control_dx_doubled": {"max_grad_rel": ctl_grad,
                                      "max_param_diff": ctl_param},
           "max_param_diff": diffs[worst], "param": worst,
           "median_param_diff": float(np.median(list(diffs.values()))),
           "histories": len(h_gpu),
           "max_history_rel": max(hist_rel.values()),
           "tolerance": {"loss_rtol": TINY_O3_LOSS_RTOL,
                         "grad_rtol_of_largest_entry": TINY_O3_GRAD_RTOL,
                         "param_atol": TINY_O3_PARAM_ATOL,
                         "lr": TINY_O3_LR,
                         "activation_history_rtol": TINY_O3_HIST_RTOL,
                         "weight_history": "bit-equal"},
           "fp8_launches": got}
    log("tiny o3 parity: " + json.dumps(res))
    if got != want:
        fail(f"tiny o3 parity: fp8 launches {got}, expected {want}")
    if not res["loss_rel"] <= TINY_O3_LOSS_RTOL:
        fail(f"tiny o3 parity: loss {l_gpu} on the card, {l_cpu} on the "
             f"CPU")
    if not grad[g_worst] <= TINY_O3_GRAD_RTOL:
        fail(f"tiny o3 parity: the gradient of {g_worst} differs by "
             f"{grad[g_worst]} of its largest entry")
    if not diffs[worst] <= TINY_O3_PARAM_ATOL:
        fail(f"tiny o3 parity: {worst} differs by {diffs[worst]}")
    if not (ctl_grad > TINY_O3_GRAD_RTOL and ctl_param > TINY_O3_PARAM_ATOL):
        fail(f"tiny o3 parity: the control with dX doubled reads "
             f"{ctl_grad} and {ctl_param}: the limits do not tell it from "
             f"a sound step")
    if sorted(h_gpu) != sorted(h_cpu) or len(h_gpu) != 2 * sites:
        fail(f"tiny o3 parity: history keys {sorted(h_gpu)} on the card, "
             f"{sorted(h_cpu)} on the CPU")
    for k, v in h_cpu.items():
        if k.endswith("/w") and not np.array_equal(h_gpu[k], v):
            fail(f"tiny o3 parity: weight history {k} {h_gpu[k][:2]} on "
                 f"the card, {v[:2]} on the CPU")
        if not hist_rel[k] <= TINY_O3_HIST_RTOL:
            fail(f"tiny o3 parity: history {k} {hist_rel[k]} apart")
    return counts


# ----------------------------------------------------------- training
def _flash_on_tensor_cores(kernels, want, label):
    """Fails unless every flash launch of a run (``want`` its counts) was
    on the tensor-core design; returns the counts by design."""
    designs = kernels.flash_design_counts()
    want_designs = {
        "tc_launches": want["flash_attention_fwd"],
        "tc_bwd_launches": want["flash_attention_bwd"],
        "cc_launches": 0, "cc_bwd_launches": 0}
    if designs != want_designs:
        fail(f"{label}: flash launches by design {designs}, expected "
             f"{want_designs}")
    return designs


def step_meter_gates(step, meter, steps, times, card, label,
                     gate_p50=True):
    """The trainer's steps as the process ``StepMeter`` saw them: fails
    unless it observed every step, the first as ``warmup``, its
    ``step_time`` p50 lies within 5% of the phase's own synced p50 (with
    ``gate_p50``), and 0 < MFU <= 1. Returns the numbers it prints (the MFU is against the
    bf16 dense peak of the card, whatever the step's dtype)."""
    from paddle_tpu_torch import observability as obs

    pending = step.flush_telemetry()
    st = meter.step_time.snapshot()
    mfu = meter.mfu.value()
    p50 = statistics.median(times)
    res = {
        "card": card, "steps_observed": meter.steps.value,
        "warmup_steps": meter.compile_time.count, "pending": pending,
        "step_time_p50_s": st.get("p50"), "phase_step_p50_s": p50,
        "paddle_training_mfu": mfu,
        "peak_flops": obs.peak_flops_per_device(),
        "peak": "bf16 dense tensor-core peak of the card, for every dtype",
        "tokens_per_second": meter.tokens_per_second.value(),
        "paddle_device_bytes_in_use": {
            s["labels"].get("device", ""): s["value"]
            for s in meter.device_bytes_in_use.data()["series"]},
        "paddle_device_peak_bytes_in_use": {
            s["labels"].get("device", ""): s["value"]
            for s in meter.device_peak_bytes.data()["series"]},
        "paddle_device_live_arrays": meter.device_live_arrays.value(),
    }
    log(f"{label} step meter: " + json.dumps(res))
    if meter.steps.value != steps or meter.compile_time.count != 1 \
            or meter.step_time.count != steps - 1 or pending:
        fail(f"{label}: the step meter observed {meter.steps.value} of "
             f"{steps} steps ({meter.compile_time.count} as warmup, "
             f"{pending} pending)")
    if gate_p50 and not abs(st["p50"] - p50) <= 0.05 * p50:
        fail(f"{label}: the step meter's step_time p50 {st['p50']} is not "
             f"within 5% of the phase's synced p50 {p50}")
    if mfu is None or not 0.0 < mfu <= 1.0:
        fail(f"{label}: paddle_training_mfu {mfu} is not in (0, 1]")
    return res


def training_phase(torch, np, dev, card, profile_train_steps=0):
    """10 AdamW steps, AMP O1 bf16, of Llama-2-7B widths at 8 layers on
    one fixed batch; returns the launch counts of the 10 steps. With
    ``profile_train_steps`` that many more steps run under the profiler
    after the counts are read."""
    import gc

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         causal_lm_loss)
    from paddle_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                            LinearWarmup)

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    torch.cuda.synchronize()
    n_params = net.num_params()
    log(f"training: Llama-2-7B widths, {TRAIN_LAYERS} of 32 layers, "
        f"{n_params / 1e9:.3f}B params fp32, built in "
        f"{time.perf_counter() - t0:.1f} s")
    sched = LinearWarmup(3e-4, 3, 3e-5, 3e-4)
    opt = AdamW(sched, parameters=net.named_parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt,
        amp_level="O1", amp_dtype="bfloat16")
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
    inputs, labels = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    meter = obs.StepMeter()
    obs.set_step_meter(meter)  # the steps publish into a fresh meter
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, _ = step([inputs], [labels])
        sched.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_meter = step_meter_gates(step, meter, TRAIN_STEPS, times, card,
                                  "training")
    if not all(np.isfinite(losses)):
        fail(f"training: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training: the last loss {losses[-1]} is not below the first "
             f"{losses[0]} on a fixed batch")
    want = {k: n * TRAIN_STEPS for k, n in TRAIN_PER_STEP.items()}
    if counts != want:
        fail(f"training: launches {counts}, expected {want} "
             f"({TRAIN_STEPS} steps)")
    # O1 attends in bf16: every flash launch went to the tensor cores
    designs = _flash_on_tensor_cores(kernels, want, "training")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = statistics.median(times)
    flops = net.flops_per_token(TRAIN_SEQ) * tokens
    res = {
        "card": card,
        "model": f"Llama-2-7B widths, {TRAIN_LAYERS} layers, fp32 params, "
                 f"AMP O1 bf16, random weights",
        "params": n_params, "batch": [TRAIN_BATCH, TRAIN_SEQ],
        "steps": TRAIN_STEPS, "losses": losses, "step_s": times,
        "step_p50_s": p50, "tokens_per_s": tokens / p50,
        "model_tflop_per_step": flops / 1e12,
        "model_tflop_per_s": flops / p50 / 1e12,
        "peak_mem_bytes": peak,
        "launches": counts,
        "launches_per_step": {k: n / TRAIN_STEPS for k, n in counts.items()},
        "flash_launches_by_design": designs,
        "step_meter": step_meter,
    }
    log("training: " + json.dumps(res))
    if profile_train_steps:
        prof = profile_steps(torch, lambda: step([inputs], [labels]),
                             profile_train_steps)
        log("profile: " + json.dumps(dict(prof, kind="train")))
    del step, opt, sched, loss
    gc.collect()
    torch.cuda.empty_cache()
    o3_counts = o3_training(torch, np, net, inputs, labels, losses, p50,
                            card, profile_train_steps)
    gc.collect()
    torch.cuda.empty_cache()
    fused_counts = fused_training(torch, np, net, inputs, labels, losses[0],
                                  card, profile_train_steps)
    gc.collect()
    torch.cuda.empty_cache()
    fp32_counts, fp32_loss0 = fp32_training(torch, np, net, inputs, labels,
                                            card, profile_train_steps)
    gc.collect()
    torch.cuda.empty_cache()
    fused_fp32_counts = fused_fp32_training(torch, np, net, inputs, labels,
                                            fp32_loss0, card,
                                            profile_train_steps)
    gc.collect()
    torch.cuda.empty_cache()
    opt_counts = optimizer_phase(torch, np, net, inputs, labels, card)
    gc.collect()
    torch.cuda.empty_cache()
    fp16_counts = fp16_training(torch, np, net, inputs, labels, losses[0],
                                card)
    gc.collect()
    torch.cuda.empty_cache()
    eager_counts = eager_optimizer_phase(torch, np, net, inputs, labels,
                                         card)
    gc.collect()
    torch.cuda.empty_cache()
    # last: decorate leaves the net in fp16
    o2_counts = fp16_o2(torch, np, net, inputs, labels, card)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    naninf_counts = naninf_phase(torch, np, dev, card)
    return (counts, fused_counts, fp32_counts, fused_fp32_counts, opt_counts,
            {"fp16_training": fp16_counts, "fp16_o2": o2_counts,
             "eager_optimizers": eager_counts, "naninf": naninf_counts,
             "o3_training": o3_counts})


def fp32_training(torch, np, net, inputs, labels, card,
                  profile_train_steps=0):
    """The training phase's model reset to its seed-0 weights, a fresh
    AdamW and schedule, FP32_TRAIN_STEPS steps with ``amp_level=None``
    (the trainer's default: fp32 end to end, flash attention through the
    split design) on the same batch. Returns the launch counts of those
    steps."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import causal_lm_loss
    from paddle_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                            LinearWarmup)

    net.reset_parameters(0)
    sched = LinearWarmup(3e-4, 3, 3e-5, 3e-4)
    opt = AdamW(sched, parameters=net.named_parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt)
    if step.amp_level is not None:
        fail(f"fp32 training: the trainer's default amp_level is "
             f"{step.amp_level!r}, not None")
    meter = obs.StepMeter()
    obs.set_step_meter(meter)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(FP32_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, _ = step([inputs], [labels])
        sched.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # three steps: the p50 of two meter samples against three synced ones
    # is printed, not gated
    step_meter = step_meter_gates(step, meter, FP32_TRAIN_STEPS, times,
                                  card, "fp32 training", gate_p50=False)
    if not all(np.isfinite(losses)):
        fail(f"fp32 training: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        fail(f"fp32 training: the last loss {losses[-1]} is not below the "
             f"first {losses[0]} on a fixed batch")
    want = {k: n * FP32_TRAIN_STEPS for k, n in TRAIN_PER_STEP.items()}
    if counts != want:
        fail(f"fp32 training: launches {counts}, expected {want} "
             f"({FP32_TRAIN_STEPS} steps)")
    # fp32 at head dim 128: every flash launch on the tensor cores
    designs = _flash_on_tensor_cores(kernels, want, "fp32 training")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = statistics.median(times)
    res = {
        "card": card, "amp_level": None, "steps": FP32_TRAIN_STEPS,
        "losses": losses, "step_s": times, "step_p50_s": p50,
        "tokens_per_s": tokens / p50, "peak_mem_bytes": peak,
        "launches": counts,
        "launches_per_step": {k: n / FP32_TRAIN_STEPS
                              for k, n in counts.items()},
        "flash_launches_by_design": designs,
        "step_meter": step_meter,
    }
    log("fp32 training: " + json.dumps(res))
    if profile_train_steps:
        prof = profile_steps(torch, lambda: step([inputs], [labels]),
                             profile_train_steps)
        groups = prof["ms_per_step_by_group"]
        prof["flash_ms_per_step"] = sum(
            groups.get(k, 0.0) for k in ("flash_attention_fwd",
                                         "flash_attention_bwd",
                                         "split_parts"))
        log("profile: " + json.dumps(dict(prof, kind="train_fp32")))
    del step, opt, sched, loss
    return counts, losses[0]


def fused_fp32_training(torch, np, net, inputs, labels, unfused_loss0, card,
                        profile_train_steps=0):
    """The training phase's model reset to its seed-0 weights again, with
    both fusions and ``amp_level=None`` (fp32 end to end: the fused head
    and the rope-on-load forward on their split designs), a fresh AdamW
    and schedule: FUSED_FP32_TRAIN_STEPS steps on the same batch. Returns
    the launch counts of those steps."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import causal_lm_loss
    from paddle_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                            LinearWarmup)

    net.reset_parameters(0)
    net.fusions = BOTH_FUSIONS
    sched = LinearWarmup(3e-4, 3, 3e-5, 3e-4)
    opt = AdamW(sched, parameters=net.named_parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt)
    if step.amp_level is not None:
        fail(f"fused fp32 training: the trainer's default amp_level is "
             f"{step.amp_level!r}, not None")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(FUSED_FP32_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, _ = step([inputs], [labels])
        sched.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail(f"fused fp32 training: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        fail(f"fused fp32 training: the last loss {losses[-1]} is not below "
             f"the first {losses[0]} on a fixed batch")
    rel = abs(losses[0] - unfused_loss0) / abs(unfused_loss0)
    if not rel <= FUSED_FP32_LOSS_RTOL:
        fail(f"fused fp32 training: step-1 loss {losses[0]}, unfused fp32 "
             f"{unfused_loss0} (relative {rel} > {FUSED_FP32_LOSS_RTOL})")
    want = {k: n * FUSED_FP32_TRAIN_STEPS
            for k, n in FUSED_TRAIN_PER_STEP.items()}
    if counts != want:
        fail(f"fused fp32 training: launches {counts}, expected {want} "
             f"({FUSED_FP32_TRAIN_STEPS} steps)")
    # fp32 at head dim 128 and 4096 rows: both fusions on their split
    # designs, the attention backward's flash on the tensor cores
    designs = kernels.fusion_design_counts()
    want_designs = {
        name: {"tc_launches": 0, "split_launches": want[name],
               "cc_launches": 0} for name in BOTH_FUSIONS}
    want_designs["rope_attention"]["bwd_launches"] = want[
        "rope_attention_bwd"]
    if designs != want_designs:
        fail(f"fused fp32 training: fusion launches by design {designs}, "
             f"expected {want_designs}")
    flash = _flash_on_tensor_cores(kernels, want, "fused fp32 training")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = statistics.median(times)
    res = {
        "card": card, "amp_level": None, "fusions": sorted(net.fusions),
        "steps": FUSED_FP32_TRAIN_STEPS, "losses": losses, "step_s": times,
        "step_p50_s": p50, "tokens_per_s": tokens / p50,
        "step1_loss_unfused_fp32": unfused_loss0,
        "step1_loss_rel_diff": rel, "step1_loss_rtol": FUSED_FP32_LOSS_RTOL,
        "peak_mem_bytes": peak, "launches": counts,
        "launches_per_step": {k: n / FUSED_FP32_TRAIN_STEPS
                              for k, n in counts.items()},
        "fusion_launches_by_design": designs,
        "flash_launches_by_design": flash,
    }
    log("fused fp32 training: " + json.dumps(res))
    if profile_train_steps:
        prof = profile_steps(torch, lambda: step([inputs], [labels]),
                             profile_train_steps)
        log("profile: " + json.dumps(dict(prof, kind="train_fused_fp32")))
    del step, opt, sched, loss
    net.fusions = ()
    return counts


def fused_training(torch, np, net, inputs, labels, unfused_loss0, card,
                   profile_train_steps=0):
    """The training phase's model reset to its seed-0 weights, with both
    fusions, a fresh AdamW and schedule: FUSED_TRAIN_STEPS O1 steps on the
    same batch. Returns the launch counts of those steps."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import causal_lm_loss
    from paddle_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                            LinearWarmup)

    net.reset_parameters(0)
    net.fusions = BOTH_FUSIONS
    sched = LinearWarmup(3e-4, 3, 3e-5, 3e-4)
    opt = AdamW(sched, parameters=net.named_parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt,
        amp_level="O1", amp_dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(FUSED_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, _ = step([inputs], [labels])
        sched.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail(f"fused training: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        fail(f"fused training: the last loss {losses[-1]} is not below the "
             f"first {losses[0]} on a fixed batch")
    rel = abs(losses[0] - unfused_loss0) / abs(unfused_loss0)
    if not rel <= FUSED_LOSS_RTOL:
        fail(f"fused training: step-1 loss {losses[0]}, unfused "
             f"{unfused_loss0} (relative {rel} > {FUSED_LOSS_RTOL})")
    want = {k: n * FUSED_TRAIN_STEPS for k, n in FUSED_TRAIN_PER_STEP.items()}
    if counts != want:
        fail(f"fused training: launches {counts}, expected {want} "
             f"({FUSED_TRAIN_STEPS} steps)")
    # O1: the attention's q, k, v are bf16 (tensor cores), the head's
    # input is the fp32 residual (split products on the tensor cores); the
    # attention backward's flash runs in fp32 on the tensor cores
    designs = kernels.fusion_design_counts()
    want_designs = {
        "rms_norm_matmul": {"tc_launches": 0,
                            "split_launches": want["rms_norm_matmul"],
                            "cc_launches": 0},
        "rope_attention": {"tc_launches": want["rope_attention"],
                           "split_launches": 0, "cc_launches": 0,
                           "bwd_launches": want["rope_attention_bwd"]}}
    if designs != want_designs:
        fail(f"fused training: fusion launches by design {designs}, "
             f"expected {want_designs}")
    flash = _flash_on_tensor_cores(kernels, want, "fused training")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = statistics.median(times)
    res = {
        "card": card, "fusions": sorted(net.fusions),
        "steps": FUSED_TRAIN_STEPS, "losses": losses, "step_s": times,
        "step_p50_s": p50, "tokens_per_s": tokens / p50,
        "step1_loss_unfused": unfused_loss0, "step1_loss_rel_diff": rel,
        "step1_loss_rtol": FUSED_LOSS_RTOL, "peak_mem_bytes": peak,
        "launches": counts,
        "launches_per_step": {k: n / FUSED_TRAIN_STEPS
                              for k, n in counts.items()},
        "fusion_launches_by_design": designs,
        "flash_launches_by_design": flash,
    }
    log("fused training: " + json.dumps(res))
    if profile_train_steps:
        prof = profile_steps(torch, lambda: step([inputs], [labels]),
                             profile_train_steps)
        log("profile: " + json.dumps(dict(prof, kind="train_fused")))
    net.fusions = ()
    return counts


OPT_STEPS = 3


def optimizer_phase(torch, np, net, inputs, labels, card):
    """The optimizer sub-phase: the training model reset to its seed-0
    weights for each OPT_CASES case, AMP O1 bf16, OPT_STEPS steps on the
    training batch. Every loss finite, and every kernel launched exactly
    the count the structure gives (the forward and backward kernels as
    the unfused O1 step, the multi-tensor kernels by the case's tables and
    buckets). The scaler case (a summed loss, SCALER_KW) must overflow on
    its first step and leave every parameter and moment bit-equal and the
    step count at 0, then update: its scale, counts and step count after
    each step are checked exactly. Returns the launch counts of all
    cases."""
    import gc

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import optimizer as o
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import causal_lm_loss

    total = dict.fromkeys(kernels.KERNELS, 0)
    # the scaler case's state after each step: the overflow (the scale
    # falls by 2^-20, the step does not count), then two good steps (the
    # second doubles the scale)
    scaler_want = [[2.0 ** 107, 0, 0, True, 0], [2.0 ** 107, 1, 0, False, 1],
                   [2.0 ** 108, 0, 0, False, 2]]
    for case, (rate, build) in OPT_CASES.items():
        net.reset_parameters(0)
        named = list(net.named_parameters())
        opt = build(o, named, rate, 1e-8)
        scaler = GradScaler(**SCALER_KW) if case == "adamw_scaler" else None
        reduce = "sum" if scaler is not None else "mean"

        def loss_fn(lo, lb, reduce=reduce):
            return getattr(causal_lm_loss(lo, lb), reduce)()

        step = CompiledTrainStep(net, loss_fn, opt, amp_level="O1",
                                 amp_dtype="bfloat16", scaler=scaler)
        before = ([p.detach().clone() for _, p in named]
                  if scaler is not None else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, times, states = [], [], []
        for i in range(OPT_STEPS):
            t0 = time.perf_counter()
            loss, _ = step([inputs], [labels])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if scaler is None:
                continue
            states.append(_scaler_state(scaler, opt))
            if states[-1] != scaler_want[i]:
                fail(f"optimizer {case}: scaler state after step {i + 1} "
                     f"{states[-1]}, expected {scaler_want[i]}")
            if i == 0:
                same = all(_bits_equal(torch, a, p)
                           for a, (_, p) in zip(before, named))
                zero = all(not a.any() for a in opt._accumulators.values())
                if not (same and zero and len(opt._accumulators)
                        == 2 * len(named)):
                    fail(f"optimizer {case}: the overflowing step changed "
                         f"the parameters ({not same}) or the moments "
                         f"({not zero})")
                del before
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)):
            fail(f"optimizer {case}: non-finite loss in {losses}")
        want = {k: 0 if k in MT_KERNELS else n * OPT_STEPS
                for k, n in TRAIN_PER_STEP.items()}
        want.update({k: n * OPT_STEPS for k, n in opt_case_launches(
            case, TRAIN_LAYERS).items()})
        if counts != want:
            fail(f"optimizer {case}: launches {counts}, expected {want} "
                 f"({OPT_STEPS} steps)")
        for k, n in counts.items():
            total[k] += n
        log(f"optimizer {case}: " + json.dumps({
            "card": card, "amp_level": "O1", "optimizer": type(opt).__name__,
            "clip": type(opt._grad_clip).__name__, "rate": rate,
            "steps": OPT_STEPS, "losses": losses, "step_s": times,
            "step_p50_s": statistics.median(times), "peak_mem_bytes": peak,
            "scaler_states": states or None,
            "launches_per_step": {k: counts[k] / OPT_STEPS
                                  for k in MT_KERNELS}}))
        del step, opt, scaler, named, loss
        gc.collect()
        torch.cuda.empty_cache()
    return total


# ------------------------------------------- fp16, eager optimizers, naninf
FP16_TRAIN_STEPS = 10
# the fp16 O1 step-1 loss against the bf16 O1 one (same seed, batch and
# schedule), relative: both round the projections' inputs and outputs,
# rope's and attention's to their low type (fp16 keeps 3 more bits) and
# keep the residual stream, norms and loss in fp32; the differences are
# round-to-nearest errors of at most 2^-9 per logit that average out over
# 4096 tokens (the bound FUSED_LOSS_RTOL takes for rounding at other
# places)
FP16_LOSS_RTOL = 1e-3
# the launches over fp16 tensors a fp16 O1 step makes: rope and flash
# attention (q and k come out of the fp16 projections); the residual
# stream, the norms and the optimizer stay fp32
FP16_O1_PER_STEP = {
    "rms_norm_fp16": 0, "rms_norm_bwd_fp16": 0,
    "rope_fp16": TRAIN_LAYERS, "rope_bwd_fp16": TRAIN_LAYERS,
    "flash_attention_fwd_fp16": TRAIN_LAYERS,
    "flash_attention_bwd_fp16": TRAIN_LAYERS,
    "mt_sumsq_fp16": 0, "mt_adam_fp16": 0}
O2_STEPS = 3
EAGER_OPT_STEPS = 3
# the eager optimizers' single-parameter check: the card's update of one
# parameter (layer 0's input norm weight, fp32) against the same update
# of a CPU copy (its gradient and state copied before the step): within
# 1e-6 of the parameter's largest |p| (fp32 elementwise math in the same
# order; the CPU's sqrt and division round as the card's, and a libm
# difference moves an entry by an ulp)
EAGER_OPT_ATOL = 1e-6
EAGER_OPT_PARAM = "model.layers.0.input_layernorm.weight"
# name -> (learning rate, builder(o, named, lr)): the nine eager-only
# optimizers at their reference defaults but the rate, no clip (the
# single-parameter check needs an update that depends on that parameter
# alone)
EAGER_OPT_CASES = {
    "adagrad": (1e-2, lambda o, named, lr: o.Adagrad(lr, parameters=named)),
    "rmsprop": (1e-3, lambda o, named, lr: o.RMSProp(
        lr, parameters=named, momentum=0.9, centered=True)),
    "adadelta": (1.0, lambda o, named, lr: o.Adadelta(lr, parameters=named)),
    "adamax": (2e-3, lambda o, named, lr: o.Adamax(lr, parameters=named)),
    "nadam": (2e-3, lambda o, named, lr: o.NAdam(lr, parameters=named)),
    "radam": (1e-3, lambda o, named, lr: o.RAdam(lr, parameters=named)),
    "asgd": (1e-2, lambda o, named, lr: o.ASGD(lr, t0=1, parameters=named)),
    "rprop": (1e-3, lambda o, named, lr: o.Rprop(lr, parameters=named)),
    "adamw_multi_tensor": (3e-4, lambda o, named, lr: o.AdamW(
        lr, parameters=named, use_multi_tensor=True)),
}
# LBFGS on Llama-2-7B widths at 2 layers (666.9M fp32 parameters): a
# history of LBFGS_HISTORY (s, y) pairs of flat fp32 vectors
LBFGS_LAYERS, LBFGS_HISTORY, LBFGS_STEPS = 2, 4, 2
NANINF_LAYERS = 2
NANINF_STEPS = 4
NANINF_DIR = os.path.join(HERE, "build", "chip_smoke_naninf")


def _all_counts(kernels):
    """Every launch counter: the totals and the fp16 ones."""
    return {**kernels.launch_counts(), **kernels.fp16_launch_counts()}


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed_ms(torch, dev, fn):
    """``fn()`` and its time in ms: CUDA events on a card (synchronized
    before and after), the host clock on the CPU (a CPU rehearsal's)."""
    _sync(torch, dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def _free(torch, dev):
    """Return a phase's dead tensors to the card between its cases (a
    full collection: reference cycles hold the optimizers' state); on a
    CPU rehearsal there is nothing to return."""
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()


def _peak_reset(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(torch, dev):
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


# AMP O3 on the training model (reset to its seed): 5 AdamW steps with
# the O1 steps' batch, schedule and clip, each loss held to O1's at the
# same step. While O1's loss falls (steps 1-4 on this batch) the limit is
# 3% (the JAX package's gate of a falling tiny run,
# tests/test_fp8_amp.py:126). Step 5 is the first at the peak rate, O1's
# loss rises there (an overshoot) and the runs part: there the limit is
# O3_LOSS_RTOL_LATE, set between what sound O3 runs read at step 5 (the
# trainer's 3.09%, and 2.46% with its histories warmed by one forward
# before step 1) and two controls that break the scaling: the forward's
# delayed scales held at 1 (5.25%; within 0.73% over steps 1-4) and the
# e5m2 gradient's scale dropped (16.7%; the smallest gradient codes flush
# to zero). All four run here: both sound runs must pass every step's
# limit and each control must fail a late one. Per step every linear (6
# a layer and the head) runs 3 fp8 products and 4 quantize launches, the
# rest as O1
O3_TRAIN_STEPS = 5
O3_LOSS_RTOL, O3_LOSS_RTOL_LATE = 0.03, 0.04
O3_CONTROLS = ("no_forward_scale", "no_grad_scale")
O3_SITES = 6 * TRAIN_LAYERS + 1
O3_PER_STEP = dict(TRAIN_PER_STEP, fp8_gemm=FP8_GEMM_PER_SITE * O3_SITES,
                   fp8_quantize=FP8_QUANTIZE_PER_SITE * O3_SITES)


def _o3_trainer(torch, net):
    """The training model reset to its seed, and an O3 CompiledTrainStep
    with the O1 phase's AdamW, clip and schedule: (sched, opt, step)."""
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import causal_lm_loss
    from paddle_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                            LinearWarmup)

    net.reset_parameters(0)
    sched = LinearWarmup(3e-4, 3, 3e-5, 3e-4)
    opt = AdamW(sched, parameters=net.named_parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt,
        amp_level="O3", amp_dtype="bfloat16")
    return sched, opt, step


def _o3_limits(o1_losses):
    """Each O3 step's limit on its distance from O1's loss: O3_LOSS_RTOL
    before O1's loss first rises, O3_LOSS_RTOL_LATE from then on."""
    falling = next((i for i in range(1, O3_TRAIN_STEPS)
                    if o1_losses[i] > o1_losses[i - 1]), O3_TRAIN_STEPS)
    return [O3_LOSS_RTOL if i < falling else O3_LOSS_RTOL_LATE
            for i in range(O3_TRAIN_STEPS)]


def _o3_arm(torch, net, inputs, labels, arm):
    """The losses of O3_TRAIN_STEPS steps of a variant run: ``"warmed"``
    (the histories set by one forward under O3 before step 1, where the
    trainer starts them empty), or a control: ``"no_forward_scale"``
    (every delayed scale 1, the histories kept but never read) or
    ``"no_grad_scale"`` (the gradient's amax-only pass reads as zero, so
    its scale is 1)."""
    from paddle_tpu_torch.amp import auto_cast, fp8
    from paddle_tpu_torch.kernels import fp8_matmul

    sched, opt, step = _o3_trainer(torch, net)
    if arm == "warmed":
        with torch.no_grad(), auto_cast(True, level="O3"), \
                fp8.fp8_autocast(None) as ctx:
            net(inputs)
        step.load_fp8_state({k: v.cpu().numpy()
                             for k, v in ctx.new_state.items()})
    quantize = fp8_matmul.quantize

    def no_grad_scale(x, scale, fmt, rows=True, transposed=False,
                      amax=False):
        q, qt, am = quantize(x, scale, fmt, rows, transposed, amax)
        if scale is None:  # the gradient's amax-only pass
            am = torch.zeros_like(am)
        return q, qt, am

    delayed_scale = fp8._delayed_scale
    if arm == "no_grad_scale":
        fp8_matmul.quantize = no_grad_scale
    if arm == "no_forward_scale":
        fp8._delayed_scale = lambda history, fmax: torch.ones_like(
            history[0])
    try:
        losses = []
        for _ in range(O3_TRAIN_STEPS):
            losses.append(float(step([inputs], [labels])[0]))
            sched.step()
    finally:
        fp8_matmul.quantize = quantize
        fp8._delayed_scale = delayed_scale
    return losses


def o3_training(torch, np, net, inputs, labels, o1_losses, o1_p50, card,
                profile_train_steps=0):
    """``CompiledTrainStep(..., amp_level="O3", amp_dtype="bfloat16")`` on
    the training model reset to its seed: O3_TRAIN_STEPS steps; fails
    unless every loss is finite and within its step's limit of O1's
    (:func:`_o3_limits`), 2 x 49 histories hold one non-zero amax a step
    each, the ``fp8_bytes_saved`` gauge is the linear weights' element
    count (bf16 weights read as fp8: one byte saved each), every launch
    count is O3_PER_STEP's, and flash attention ran on its tensor-core
    kernels. Then the warmed run must pass the same limits and each
    control (:func:`_o3_arm`) must fail a late one. Returns the launch
    counts of the trainer's run."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.nn import Linear

    sched, opt, step = _o3_trainer(torch, net)
    meter = obs.StepMeter()
    obs.set_step_meter(meter)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(O3_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, _ = step([inputs], [labels])
        sched.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # five steps: the p50 of four meter samples against five synced ones
    # (the first a warmup) is printed, not gated, as in the fp32 phase
    step_meter = step_meter_gates(step, meter, O3_TRAIN_STEPS, times, card,
                                  "o3 training", gate_p50=False)
    hists = step.fp8_state_dict()
    weight_elems = sum(m.weight.numel() for m in net.modules()
                       if isinstance(m, Linear))
    saved = meter.fp8_bytes_saved.value()
    want = {k: n * O3_TRAIN_STEPS for k, n in O3_PER_STEP.items()}
    if counts != want:
        fail(f"o3 training: launches {counts}, expected {want}")
    _flash_on_tensor_cores(kernels, want, "o3 training")
    if profile_train_steps:
        prof = profile_steps(torch, lambda: step([inputs], [labels]),
                             profile_train_steps)
        log("profile: " + json.dumps(dict(prof, kind="train_o3")))
    del step, opt, sched, loss
    torch.cuda.empty_cache()
    limits = _o3_limits(o1_losses)
    runs = {"o3": losses}
    for arm in ("warmed",) + O3_CONTROLS:
        runs[arm] = _o3_arm(torch, net, inputs, labels, arm)
    rel = {arm: [abs(a - b) / abs(b) for a, b in zip(ls, o1_losses)]
           for arm, ls in runs.items()}
    p50 = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = {
        "card": card, "amp_level": "O3", "amp_dtype": "bfloat16",
        "model": f"Llama-2-7B widths, {TRAIN_LAYERS} layers, fp32 params, "
                 f"random weights (seed 0)",
        "steps": O3_TRAIN_STEPS, "losses": losses,
        "o1_losses": o1_losses[:O3_TRAIN_STEPS], "loss_rel_to_o1": rel["o3"],
        "loss_rtol_by_step": limits,
        **{arm: {"losses": runs[arm], "loss_rel_to_o1": rel[arm]}
           for arm in ("warmed",) + O3_CONTROLS},
        "step_s": times, "step_p50_s": p50,
        "o1_step_p50_s": o1_p50, "tokens_per_s": tokens / p50,
        "peak_mem_bytes": peak, "histories": len(hists),
        "nonzero_amaxes_per_history": sorted(
            {int((h > 0).sum()) for h in hists.values()}),
        "fp8_bytes_saved": saved, "linear_weight_elements": weight_elems,
        "launches_per_step": {k: n / O3_TRAIN_STEPS
                              for k, n in counts.items()},
        "step_meter": step_meter,
    }
    log("o3 training: " + json.dumps(res))
    for arm in ("o3", "warmed"):
        if not all(np.isfinite(runs[arm])):
            fail(f"o3 training ({arm}): non-finite loss in {runs[arm]}")
        over = [i + 1 for i, (r, lim) in enumerate(zip(rel[arm], limits))
                if not r <= lim]
        if over:
            fail(f"o3 training ({arm}): losses {runs[arm]} against O1's "
                 f"{o1_losses} (relative {rel[arm]}, limits {limits}): "
                 f"over at steps {over}")
    late = [i for i, lim in enumerate(limits) if lim == O3_LOSS_RTOL_LATE]
    for arm in O3_CONTROLS:
        if not any(rel[arm][i] > O3_LOSS_RTOL_LATE for i in late):
            fail(f"o3 training: the control {arm} sits {rel[arm]} from "
                 f"O1: the late limit {O3_LOSS_RTOL_LATE} does not tell "
                 f"it from a sound run")
    if len(hists) != 2 * O3_SITES or any(
            int((h > 0).sum()) != O3_TRAIN_STEPS for h in hists.values()):
        fail(f"o3 training: {len(hists)} histories, non-zero amaxes "
             f"{res['nonzero_amaxes_per_history']} (expected "
             f"{2 * O3_SITES} with {O3_TRAIN_STEPS} each)")
    if saved != weight_elems:
        fail(f"o3 training: fp8_bytes_saved {saved}, expected the linear "
             f"weights' {weight_elems} elements")
    return counts


def fp16_training(torch, np, net, inputs, labels, bf16_loss0, card):
    """The fp16 path, entry (a): the training model reset to its seed,
    ``CompiledTrainStep(..., AdamW, amp_level="O1", amp_dtype="float16",
    scaler=GradScaler())`` (JAX's scaler defaults: scale 2^15, x2 after
    1000 good steps, x0.5 after 2 bad ones), FP16_TRAIN_STEPS steps with
    the clip and schedule of the bf16 step. Every loss finite after the
    scaler's first skips; step 1's loss within FP16_LOSS_RTOL of the bf16
    O1 step 1's; every kernel launched as the bf16 O1 step launches, and
    rope and flash attention (both ways) all on fp16 tensors
    (FP16_O1_PER_STEP). Returns the launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import causal_lm_loss
    from paddle_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                            LinearWarmup)

    net.reset_parameters(0)
    sched = LinearWarmup(3e-4, 3, 3e-5, 3e-4)
    opt = AdamW(sched, parameters=net.named_parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    scaler = GradScaler()
    step = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt,
        amp_level="O1", amp_dtype="float16", scaler=scaler)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times, states = [], [], []
    for _ in range(FP16_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, _ = step([inputs], [labels])
        sched.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        states.append(_scaler_state(scaler, opt))
    counts = _all_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    skipped = [s[3] for s in states]
    first_good = skipped.index(False) if False in skipped else len(skipped)
    rel = abs(losses[0] - bf16_loss0) / abs(bf16_loss0)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = statistics.median(times)
    res = {
        "card": card, "amp_level": "O1", "amp_dtype": "float16",
        "scaler": "GradScaler() (JAX defaults)", "steps": FP16_TRAIN_STEPS,
        "losses": losses, "step_s": times, "step_p50_s": p50,
        "tokens_per_s": tokens / p50, "peak_mem_bytes": peak,
        "scaler_states": [{"scale": s[0], "good": s[1], "bad": s[2],
                           "found_inf": s[3], "step_count": s[4]}
                          for s in states],
        "loss0_vs_bf16_o1": {"fp16": losses[0], "bf16": bf16_loss0,
                             "rel": rel, "rtol": FP16_LOSS_RTOL},
        "launches_per_step": {k: n / FP16_TRAIN_STEPS
                              for k, n in counts.items()},
    }
    log("fp16 training: " + json.dumps(res))
    if first_good == len(skipped) or not all(
            np.isfinite(losses[first_good:])):
        fail(f"fp16 training: non-finite loss after the scaler's first "
             f"skips ({first_good}): {losses}")
    if not rel <= FP16_LOSS_RTOL:
        fail(f"fp16 training: step 1's loss {losses[0]} is {rel} from the "
             f"bf16 O1 step's {bf16_loss0} (relative; {FP16_LOSS_RTOL})")
    want = {k: n * FP16_TRAIN_STEPS for k, n in TRAIN_PER_STEP.items()}
    want.update({k: n * FP16_TRAIN_STEPS
                 for k, n in FP16_O1_PER_STEP.items()})
    if counts != want:
        fail(f"fp16 training: launches {counts}, expected {want}")
    _flash_on_tensor_cores(kernels, want, "fp16 training")
    del step, opt, sched, scaler, loss
    return counts


def fp16_o2(torch, np, net, inputs, labels, card):
    """The fp16 path, entry (b), the eager O2 step as the README starts
    it: the training model reset to its seed, ``net, opt =
    amp.decorate(net, AdamW(... ClipGradByGlobalNorm(1.0)), level="O2",
    dtype="float16")`` (fp16 parameters; AdamW's moments fp32), then
    O2_STEPS eager steps: the loss of the fp16 net's logits cast to fp32
    (as the CPU test runs JAX's: its eager tape cannot differentiate
    through the O2 ``auto_cast``), ``scaler.scale(loss).backward()``,
    ``scaler.step(opt)``, ``scaler.update()``. The residual stream is
    fp16, so every RMSNorm, rope and flash launch is fp16, and so are the
    scaler's unscale check (``mt_sumsq``), the clip's and the eager
    update's (``mt_adam``, a call a parameter) when the scaler does not
    skip. Leaves the net in fp16. Returns the launch counts."""
    from paddle_tpu_torch import amp, kernels
    from paddle_tpu_torch.models import causal_lm_loss
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    net.reset_parameters(0)
    opt = AdamW(3e-4, parameters=net.named_parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    net, opt = amp.decorate(net, opt, level="O2", dtype="float16")
    if {p.dtype for p in net.parameters()} != {torch.float16}:
        fail("fp16 O2: decorate left a parameter in another dtype")
    scaler = amp.GradScaler()
    n = net.num_params()
    reckoned = {"params_fp16": 2 * n, "grads_fp16": 2 * n,
                "adam_moments_fp32": 8 * n, "total": 12 * n}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times, states = [], [], []
    for _ in range(O2_STEPS):
        t0 = time.perf_counter()
        loss = causal_lm_loss(net(inputs).float(), labels).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        states.append(_scaler_state(scaler, opt))
    counts = _all_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    skips = sum(st[3] for st in states)
    res = {
        "card": card, "amp_level": "O2 (decorate)", "amp_dtype": "float16",
        "steps": O2_STEPS, "losses": losses, "step_s": times,
        "step_p50_s": statistics.median(times), "peak_mem_bytes": peak,
        "reckoned_state_bytes": reckoned,
        "scaler_states": [{"scale": s[0], "good": s[1], "bad": s[2],
                           "found_inf": s[3], "step_count": s[4]}
                          for s in states],
        "launches": counts,
    }
    log("fp16 O2 (decorate): " + json.dumps(res))
    if not all(np.isfinite(losses)):
        fail(f"fp16 O2: non-finite loss in {losses}")
    if skips == O2_STEPS:
        fail("fp16 O2: the scaler skipped every step")
    layers = net.config.num_hidden_layers
    tensors = len(list(net.parameters()))
    good = O2_STEPS - skips
    per = {"rms_norm_fp16": 2 * layers + 1,
           "rms_norm_bwd_fp16": 2 * layers + 1,
           "rope_fp16": layers, "rope_bwd_fp16": layers,
           "flash_attention_fwd_fp16": layers,
           "flash_attention_bwd_fp16": layers}
    want = {k: v * O2_STEPS for k, v in per.items()}
    # the unscale check every step; the clip's sum and one eager update
    # call a parameter on the steps the scaler does not skip
    want["mt_sumsq_fp16"] = (O2_STEPS + good) * mt_launches("mt_sumsq",
                                                            tensors)
    want["mt_adam_fp16"] = good * tensors * mt_launches("mt_adam", 1)
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"fp16 O2: fp16 launches {got}, expected {want}")
    del opt, scaler, loss
    return counts


def _replica_update(torch, opt, p, name, rate, build):
    """The update ``opt.step()`` is about to make to ``p``, made by a new
    optimizer of the same kind on a CPU copy of ``p`` with its gradient,
    its state and the step count copied: the CPU parameter after it."""
    from paddle_tpu_torch import optimizer as o

    cpu = p.detach().cpu().clone().requires_grad_(True)
    twin = build(o, [(name, cpu)], rate)
    for (pname, acc), v in opt._accumulators.items():
        if pname == name:
            twin._accumulators[(pname, acc)] = v.detach().cpu().clone()
    twin._step_count = opt._step_count
    if hasattr(opt, "_t"):
        twin._t = opt._t
    cpu.grad = p.grad.detach().cpu().clone()
    twin.step()
    return cpu.detach()


def eager_optimizer_phase(torch, np, net, inputs, labels, card,
                          lbfgs_cfg=None):
    """The eager optimizers on the training model reset to its seed, AMP O1
    bf16 eager steps (the loss under ``auto_cast``, ``backward()``,
    ``opt.step()``): each of EAGER_OPT_CASES, ``LookAhead(AdamW, k=2)`` and
    AdamW with a ``ModelAverage`` for EAGER_OPT_STEPS steps; the update's
    time (CUDA events around ``step()``) beside AdamW with
    ``use_multi_tensor=True`` (one ``mt_adam`` call a step). Every loss
    finite; for the nine, the last update of EAGER_OPT_PARAM equal to the
    same update of a CPU copy within EAGER_OPT_ATOL of its largest |p|;
    the model average applied and restored bit for bit. Then LBFGS on a
    2-layer model (:func:`lbfgs_leg`; ``lbfgs_cfg``: another config). On
    the CPU (a rehearsal at a tiny size) the same with host times and no
    launch gate. Returns the launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import optimizer as o
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.incubate.optimizer import LookAhead, ModelAverage
    from paddle_tpu_torch.models import causal_lm_loss

    total = dict.fromkeys(_all_counts(kernels), 0)
    dev = inputs.device

    def run(label, opt, after_step=None, params=None, rate=None, build=None):
        named = dict(net.named_parameters())
        losses, upd = [], []
        err = None
        for i in range(EAGER_OPT_STEPS):
            with auto_cast(level="O1", dtype="bfloat16"):
                loss = causal_lm_loss(net(inputs), labels).mean()
            loss.backward()
            losses.append(float(loss.detach()))
            want = None
            if build is not None and i == EAGER_OPT_STEPS - 1:
                want = _replica_update(torch, opt, named[EAGER_OPT_PARAM],
                                       EAGER_OPT_PARAM, rate, build)
            upd.append(_timed_ms(torch, dev, opt.step))
            if after_step is not None:
                after_step()
            opt.clear_grad()
            if want is not None:
                got = named[EAGER_OPT_PARAM].detach().cpu()
                err = float((got - want).abs().max()) / max(
                    float(want.abs().max()), 1e-30)
        if not all(np.isfinite(losses)):
            fail(f"eager optimizer {label}: non-finite loss in {losses}")
        if err is not None and not err <= EAGER_OPT_ATOL:
            fail(f"eager optimizer {label}: the card's update of "
                 f"{EAGER_OPT_PARAM} is {err} (of its largest |p|) from "
                 f"the CPU copy's; tolerance {EAGER_OPT_ATOL}")
        return {"losses": losses, "update_ms": upd,
                "update_ms_p50": statistics.median(upd),
                "card_vs_cpu_update": None if err is None else {
                    "param": EAGER_OPT_PARAM, "max_abs_err_over_max_p": err,
                    "tolerance": EAGER_OPT_ATOL}}

    results = {}
    kernels.reset_launch_counts()
    for case, (rate, build) in EAGER_OPT_CASES.items():
        net.reset_parameters(0)
        opt = build(o, list(net.named_parameters()), rate)
        results[case] = run(case, opt, rate=rate,
                            build=None if case == "adamw_multi_tensor"
                            else build)
        results[case]["optimizer"] = type(opt).__name__
        del opt
        _free(torch, dev)
    # LookAhead over AdamW (k 2: the slow weights move at step 2)
    net.reset_parameters(0)
    la = LookAhead(o.AdamW(3e-4, parameters=list(net.named_parameters())),
                   alpha=0.5, k=2)
    results["lookahead_adamw"] = run("lookahead_adamw", la)
    if la._step_count != EAGER_OPT_STEPS or len(la._slow) != len(
            list(net.parameters())):
        fail("eager optimizer lookahead_adamw: its slow weights or step "
             "count are wrong")
    del la
    _free(torch, dev)
    # a ModelAverage of AdamW's steps, applied and restored
    net.reset_parameters(0)
    opt = o.AdamW(3e-4, parameters=list(net.named_parameters()))
    avg = ModelAverage(parameters=list(net.named_parameters()))
    results["model_average"] = run("model_average", opt,
                                   after_step=avg.step)
    before = [p.detach().clone() for p in net.parameters()]
    with avg.apply():
        mean0 = float(avg._sums[0].float().mean()) / avg._count
        got0 = float(next(net.parameters()).detach().float().mean())
    same = all(_bits_equal(torch, a, p)
               for a, p in zip(before, net.parameters()))
    if not same or abs(got0 - mean0) > 1e-6 * max(abs(mean0), 1e-3):
        fail(f"eager optimizer model_average: apply gave a mean {got0} "
             f"against {mean0}, restore bit-equal {same}")
    results["model_average"]["apply_restore_bitwise"] = same
    del opt, avg, before
    _free(torch, dev)
    counts = _all_counts(kernels)
    results["lbfgs"], lb_counts = lbfgs_leg(torch, np, inputs, labels,
                                            lbfgs_cfg)
    for k in total:
        total[k] = counts[k] + lb_counts[k]
    mt_ms = results["adamw_multi_tensor"]["update_ms_p50"]
    for case, r in results.items():
        r["update_ms_over_mt_adam_step"] = r["update_ms_p50"] / mt_ms
        log(f"eager optimizer {case}: " + json.dumps(dict(r, card=card)))
    if dev.type == "cuda" and not total["mt_adam"]:
        fail("eager optimizers: the multi-tensor AdamW never launched "
             "mt_adam")
    return total


def lbfgs_leg(torch, np, inputs, labels, cfg=None):
    """LBFGS on Llama-2-7B widths at LBFGS_LAYERS layers (fp32 weights
    from seed 0), O1 bf16 closures, ``line_search_fn="strong_wolfe"``
    (Armijo backtracking), history LBFGS_HISTORY: LBFGS_STEPS steps of at
    most 3 iterations and 8 evaluations each; every loss finite and the
    first one below the first. Returns its numbers and the launch
    counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         causal_lm_loss)
    from paddle_tpu_torch.optimizer import LBFGS

    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=LBFGS_LAYERS)
    dev = inputs.device
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    n = net.num_params()
    opt = LBFGS(1.0, max_iter=3, max_eval=8, history_size=LBFGS_HISTORY,
                line_search_fn="strong_wolfe",
                parameters=list(net.named_parameters()))
    evals = []

    def closure():
        with auto_cast(level="O1", dtype="bfloat16"):
            loss = causal_lm_loss(net(inputs), labels).mean()
        loss.backward()
        evals.append(float(loss.detach()))
        return loss

    _peak_reset(torch, dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [float(opt.step(closure).detach())
              for _ in range(LBFGS_STEPS)]
    _sync(torch, dev)
    dt = time.perf_counter() - t0
    counts = _all_counts(kernels)
    res = {"model": f"hidden {cfg.hidden_size}, "
                    f"{cfg.num_hidden_layers} layers, fp32",
           "params": n, "history_size": LBFGS_HISTORY,
           "reckoned_history_bytes": 2 * LBFGS_HISTORY * 4 * n,
           "losses": losses, "evaluations": evals, "seconds": dt,
           "update_ms": [dt * 1e3 / LBFGS_STEPS],
           "update_ms_p50": dt * 1e3 / LBFGS_STEPS,
           "peak_mem_bytes": _peak(torch, dev), "optimizer": "LBFGS"}
    if not all(np.isfinite(evals)) or not min(evals[1:]) < evals[0]:
        fail(f"eager optimizer lbfgs: losses {evals} (finite, one below "
             f"the first)")
    del net, opt
    _free(torch, dev)
    return res, counts


def naninf_phase(torch, np, dev, card, cfg=None, batch=TRAIN_BATCH,
                 seq=TRAIN_SEQ, dump_dir=NANINF_DIR):
    """``FLAGS_check_nan_inf`` on Llama-2-7B widths at NANINF_LAYERS
    layers (fp32 weights, O1 bf16 ``CompiledTrainStep`` with AdamW), a
    flight recorder installed: NANINF_STEPS steps with the flag off and
    then on (step p50 of each; nothing trips on finite weights); a NaN
    planted in layer 0's ``q_proj`` weight: the eager forward with the
    flag on raises naming the first op that reads it, the compiled step
    raises at its end naming the same op, the recorder's bundle is
    written with a ``naninf`` reason; with the flag off the step runs
    through the NaN. ``cfg``, ``batch``, ``seq``: a tiny CPU rehearsal's.
    Returns the launch counts."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         causal_lm_loss)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils import set_flags

    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=NANINF_LAYERS)
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                           (batch, seq + 1))
    ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
    inputs, labels = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    opt = AdamW(3e-4, parameters=list(net.named_parameters()))
    step = CompiledTrainStep(net, lambda lo, lb: causal_lm_loss(
        lo, lb).mean(), opt, amp_level="O1", amp_dtype="bfloat16")
    shutil.rmtree(dump_dir, ignore_errors=True)
    rec = obs.FlightRecorder(capacity=4, dump_dir=dump_dir,
                             registry=obs.MetricsRegistry())
    prev = obs.set_flight_recorder(rec)
    rec.install(excepthook=False)
    kernels.reset_launch_counts()
    res = {"card": card, "model": f"hidden {cfg.hidden_size}, "
           f"{cfg.num_hidden_layers} layers, fp32, O1 bf16",
           "steps": NANINF_STEPS}
    try:
        for flag in (False, True):
            set_flags({"FLAGS_check_nan_inf": flag})
            times = []
            for _ in range(NANINF_STEPS):
                t0 = time.perf_counter()
                loss, _ = step([inputs], [labels])
                _sync(torch, dev)
                times.append(time.perf_counter() - t0)
            res[f"step_p50_s_flag_{'on' if flag else 'off'}"] = \
                statistics.median(times[1:])
            if not np.isfinite(float(loss)):
                fail(f"naninf: a non-finite loss on finite weights (flag "
                     f"{flag})")
        with torch.no_grad():
            net.model.layers[0].self_attn.q_proj.weight[0, 0] = float("nan")
        names = []
        try:
            with auto_cast(level="O1", dtype="bfloat16"):
                net(inputs)
        except RuntimeError as e:
            names.append(str(e))
        try:
            step([inputs], [labels])
        except RuntimeError as e:
            names.append(str(e))
        set_flags({"FLAGS_check_nan_inf": False})
        loss, _ = step([inputs], [labels])
        off_loss = float(loss)
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
        rec.uninstall()
        obs.set_flight_recorder(prev)
    ops = [re.search(r"operator \[([^\]]*)\]", m) for m in names]
    ops = [m.group(1) if m else None for m in ops]
    bundle = None
    if rec.last_dump_path:
        with open(rec.last_dump_path) as f:
            bundle = json.load(f)
    res.update({"eager_error": names[0] if names else None,
                "compiled_error": names[1] if len(names) > 1 else None,
                "ops": ops, "flag_off_loss_with_nan": off_loss,
                "bundle": rec.last_dump_path,
                "bundle_reason": bundle and bundle.get("reason")})
    log("naninf: " + json.dumps(res))
    if len(ops) != 2 or ops[0] is None or ops[0] != ops[1]:
        fail(f"naninf: the eager forward and the compiled step named "
             f"{ops}, not one op each, the same")
    if bundle is None or not str(bundle.get("reason")).startswith("naninf"):
        fail(f"naninf: no flight-recorder bundle with a naninf reason "
             f"({rec.last_dump_path})")
    if np.isfinite(off_loss):
        fail("naninf: the flag-off step with a NaN weight gave a finite "
             "loss")
    counts = _all_counts(kernels)
    del step, opt, net
    _free(torch, dev)
    return counts


# --------------------------------------------------- checkpoints, publish
# the checkpoint phase: Llama-2-7B widths at 2 of its 32 layers, fp32,
# AdamW, B 2 x S 2048 (the depth is cut so that a checkpoint, fp32
# parameters and both moments, is about 8 GB on disk: 666.9M parameters x
# 12 B); a save every 2 steps, the last 2 kept
CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY, CKPT_KEEP = 2, 6, 2, 2
# the publish legs: 8 requests (seed 2024) of 32-512 prompt tokens, 32 new
CKPT_REQUESTS, CKPT_NEW = 8, 32
# the resumed steps' losses against the uninterrupted run's, relative
RESUME_RTOL = 1e-6
# checkpoints are written inside the checkout (build/ is git-ignored)
CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_checkpoints")


def _train_per_step(layers):
    """An unfused fp32 or O1 step's launches at ``layers`` layers (the
    optimizer over 9 tensors a layer and 3 more, one table)."""
    tensors = 9 * layers + 3
    return dict(TRAIN_PER_STEP, rms_norm=2 * layers + 1,
                rms_norm_bwd=2 * layers + 1, rope=layers, rope_bwd=layers,
                flash_attention_fwd=layers, flash_attention_bwd=layers,
                mt_sumsq=mt_launches("mt_sumsq", tensors),
                mt_adam=mt_launches("mt_adam", tensors))


def _disk_free(path):
    import shutil

    return shutil.disk_usage(path).free


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _trainer(torch, net):
    from paddle_tpu_torch.jit import CompiledTrainStep
    from paddle_tpu_torch.models import causal_lm_loss
    from paddle_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                            LinearWarmup)

    sched = LinearWarmup(3e-4, 3, 3e-5, 3e-4)
    opt = AdamW(sched, parameters=net.named_parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = CompiledTrainStep(
        net, lambda lo, lb: causal_lm_loss(lo, lb).mean(), opt)
    return step, opt, sched


def _state_on_host(net, opt):
    """The checkpointed tensors (parameters and moments) as host copies,
    by their metadata names."""
    out = {f"model/{k}": v.detach().to("cpu", copy=True)
           for k, v in net.state_dict().items()}
    out.update({f"opt/{k}": v.detach().to("cpu", copy=True)
                for k, v in opt.state_dict().items()
                if hasattr(v, "detach")})
    return out


def _equals_checkpoint(np, path, host):
    """Whether every tensor of the committed checkpoint at ``path`` equals
    ``host`` (name -> CPU tensor) bit for bit; (equal, tensors, bytes)."""
    from paddle_tpu_torch.distributed.checkpoint.metadata import Metadata

    with open(os.path.join(path, "metadata.json")) as f:
        meta = Metadata.from_json(f.read())
    n = nbytes = 0
    for name, t in host.items():
        tm = meta.tensors.get(name)
        if tm is None:
            return False, name, 0
        got = np.load(os.path.join(path, tm.shards[0].file), mmap_mode="r")
        if not np.array_equal(got, t.numpy()):
            return False, name, nbytes
        n += 1
        nbytes += got.nbytes
    return True, n, nbytes


def checkpoint_phase(torch, np, dev, card):
    """Train, save, resume, publish at Llama-2-7B widths, CKPT_LAYERS
    layers, fp32 (the depth cut keeps a checkpoint near 8 GB):

    - CKPT_STEPS AdamW steps (B 2 x S 2048) with a ``CheckpointManager``
      (async saves, ``CheckpointPolicy(save_every_steps=2,
      keep_last_k=2)``) attached; a synchronous host copy of the state
      right after step 2; gates: step 2's committed checkpoint equals
      that copy bit for bit (steps 3-4 ran in place meanwhile), launches
      by formula; prints save, blocked and snapshot seconds, bytes, the
      write rate and ``verify_checkpoint(level="full")``'s seconds;
    - a bf16 paged engine of the same architecture (random weights,
      warmed) serves CKPT_REQUESTS requests, and again while the newest
      checkpoint's ``prepare_reload`` runs on another thread (fp32, cast
      on load); one more is in flight when ``commit_reload`` runs; gates: the in-flight request's tokens equal the pre-swap
      stream of its prompt, the post-swap streams equal a fresh engine's
      on the trained net cast to bf16, no capture and the same parameter
      addresses across the swap; prints prepare seconds, the pause and
      the swap's copy;
    - a quantized engine (int8 weights and arena) reloads the same
      checkpoint through a bf16 ``template_net``; gate: its streams equal
      a fresh quantized engine's built from the trained net;
    - then the newest checkpoint torn (``chaos.tear_checkpoint``): a fresh
      trainer's ``restore_or_init()`` falls back to step 4 and takes steps
      5-6; gate: its losses within RESUME_RTOL of the uninterrupted run's;
      prints the largest parameter difference and whether the steps are
      bit-equal.

    The checkpoint root is deleted at the end. Returns the phase's launch
    counts."""
    import gc
    import shutil

    from paddle_tpu_torch import chaos, kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.checkpoint import (CheckpointManager,
                                             CheckpointPolicy, commit)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t_phase = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    free0 = _disk_free(CKPT_DIR)
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=CKPT_LAYERS)
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    n_params = net.num_params()
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
    inputs, labels = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    policy = CheckpointPolicy(save_every_steps=CKPT_EVERY,
                              keep_last_k=CKPT_KEEP)
    step, opt, sched = _trainer(torch, net)
    mgr = step.attach_checkpoint(CheckpointManager(
        CKPT_DIR, async_saves=True, policy=policy,
        registry=obs.get_registry()))
    total = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses, times, busy = [], [], {}
    host2 = copy_s = None
    step2_check = None
    for i in range(1, CKPT_STEPS + 1):
        t0 = time.perf_counter()
        loss, _ = step([inputs], [labels])
        sched.step()
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        busy[i] = mgr._saver.busy()
        if i == 2:
            t0 = time.perf_counter()
            host2 = _state_on_host(net, opt)
            copy_s = time.perf_counter() - t0
        if i == 4:
            # step 4's save waited for step 2's write (one in flight), so
            # step 2 is committed now; steps 3 and 4 updated in place
            path2 = commit.step_dir(CKPT_DIR, 2)
            if commit.read_manifest(path2) is None:
                fail(f"checkpoint: step 2 not committed after step 4")
            step2_check = _equals_checkpoint(np, path2, host2)
            del host2
    counts = kernels.launch_counts()
    _add_counts(total, counts)
    mgr.close()
    want = {k: n * CKPT_STEPS for k, n in _train_per_step(
        CKPT_LAYERS).items()}
    if counts != want:
        fail(f"checkpoint: launches {counts}, expected {want}")
    if not (step2_check and step2_check[0]):
        fail(f"checkpoint: step 2's checkpoint differs from the host copy "
             f"taken after step 2: {step2_check}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"checkpoint: losses {losses}")
    committed = [s for s, _ in commit.list_committed(CKPT_DIR)]
    if committed != [6, 4]:
        fail(f"checkpoint: committed {committed}, expected [6, 4]")
    path6 = commit.step_dir(CKPT_DIR, 6)
    t0 = time.perf_counter()
    problems = commit.verify_checkpoint(path6, level="full")
    verify_s = time.perf_counter() - t0
    if problems:
        fail(f"checkpoint: step 6 does not verify: {problems}")
    ckpt_bytes = sum(r["bytes"] for r in commit.read_manifest(
        path6)["files"].values())
    saves = mgr.save_seconds.snapshot()
    train = {
        "card": card, "model": f"Llama-2-7B widths, {CKPT_LAYERS} layers, "
                               f"fp32, AdamW, random weights",
        "params": n_params, "batch": [TRAIN_BATCH, TRAIN_SEQ],
        "losses": losses, "step_s": times,
        "writer_busy_after_step": busy, "committed": committed,
        "step2_equal_to_host_copy": {"tensors": step2_check[1],
                                     "bytes": step2_check[2]},
        "host_copy_s": copy_s,
        "checkpoint_bytes": ckpt_bytes,
        "save_s": saves, "blocked_s": mgr.blocked_seconds.snapshot(),
        "snapshot_s": mgr.snapshot_seconds.snapshot(),
        "saves": mgr.saves_total.by_label(),
        "bytes_written": mgr.bytes_total.value,
        "write_gb_per_s": mgr.bytes_total.value / mgr.save_seconds.sum / 1e9,
        "verify_full_s": verify_s,
        "verify_gb_per_s": ckpt_bytes / verify_s / 1e9,
        "disk_free_bytes_before": free0,
    }
    # the manager published into the process registry under JAX's names
    scrape = obs.parse_prometheus_text(obs.prometheus_text())
    want_series = ("paddle_ckpt_save_seconds_count",
                   "paddle_ckpt_blocked_seconds_count",
                   "paddle_ckpt_snapshot_seconds_count",
                   "paddle_ckpt_bytes_total", "paddle_ckpt_saves_total",
                   "paddle_ckpt_last_step",
                   "paddle_ckpt_restore_fallbacks_total",
                   "paddle_ckpt_restores_total")
    missing = [n for n in want_series if n not in scrape]
    if missing or scrape["paddle_ckpt_last_step"][0][1] != 6 \
            or scrape["paddle_ckpt_save_seconds_count"][0][1] != 3:
        fail(f"checkpoint: the exposition lacks {missing}, or its last "
             f"step is not 6, or it counts other than 3 saves")
    train["exposition_series"] = sorted(
        n for n in scrape if n.startswith("paddle_ckpt_"))
    log("checkpoint (train and save): " + json.dumps(train))
    uninterrupted = losses
    del step, opt, sched, mgr, loss
    gc.collect()
    torch.cuda.empty_cache()

    # ---- publish: the trained net (step 6) into running engines
    publish = publish_legs(torch, np, dev, card, cfg, net, total)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- resume past a torn newest checkpoint (its commit marker gone:
    # rejected without reading it; the CPU tests tear every way)
    chaos.tear_checkpoint(path6, "delete_manifest")
    net2 = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=1)
    step2, opt2, sched2 = _trainer(torch, net2)
    mgr2 = CheckpointManager(CKPT_DIR, network=net2, optimizer=opt2,
                             async_saves=False)
    t0 = time.perf_counter()
    res = mgr2.restore_or_init()
    restore_s = time.perf_counter() - t0
    mgr2.close()
    if not (res.restored and res.step == 4 and opt2._step_count == 4
            and mgr2.fallbacks_total.by_label() == {"manifest_missing": 1}):
        fail(f"checkpoint: restore gave {res}, step count "
             f"{opt2._step_count}, fallbacks "
             f"{mgr2.fallbacks_total.by_label()}")
    # the save ran inside step 4, before that iteration's sched.step()
    sched2.step()
    kernels.reset_launch_counts()
    resumed = []
    for _ in range(CKPT_STEPS - 4):
        loss, _ = step2([inputs], [labels])
        sched2.step()
        resumed.append(float(loss))
    _add_counts(total, kernels.launch_counts())
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed, uninterrupted[4:])]
    if max(rel) > RESUME_RTOL:
        fail(f"checkpoint: resumed losses {resumed} against the "
             f"uninterrupted {uninterrupted[4:]} (relative {rel})")
    with torch.no_grad():
        diffs = {k: float((a - b).abs().max()) for (k, a), (_, b) in zip(
            net2.named_parameters(), net.named_parameters())}
    resume = {
        "card": card, "restored_step": res.step, "restore_s": restore_s,
        "fallbacks": mgr2.fallbacks_total.by_label(),
        "losses": resumed, "uninterrupted_losses": uninterrupted[4:],
        "relative": rel, "losses_bit_equal": resumed == uninterrupted[4:],
        "max_param_diff": max(diffs.values()),
        "params_bit_equal": all(d == 0.0 for d in diffs.values()),
    }
    log("checkpoint (resume): " + json.dumps(resume))
    del net, net2, step2, opt2, sched2, mgr2, loss
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    out = {"card": card, "phase_s": time.perf_counter() - t_phase,
           "disk_free_bytes_before": free0,
           "disk_free_bytes_after": _disk_free(os.path.dirname(CKPT_DIR)),
           "publish": publish}
    log("checkpoint phase: " + json.dumps(out))
    return total


def _timed_apply(eng):
    """Time the engine's swap itself (host clock to a sync) on its next
    apply; returns the dict the seconds land in."""
    import torch

    seen = {}
    inner = eng._apply_reload

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner()
        torch.cuda.synchronize()
        seen["apply_s"] = time.perf_counter() - t0

    eng._apply_reload = timed
    return seen


def _weight_ptrs(net):
    return [t.data_ptr() for t in net.state_dict(keep_vars=True).values()]


def publish_legs(torch, np, dev, card, cfg, trained, total):
    """The bf16 and int8 publish legs of ``checkpoint_phase``: each
    engine's ``prepare_reload`` runs on a thread while the engine serves
    its requests again (the streams must not change), then one request
    is in flight at ``commit_reload``. Adds their launches to ``total``;
    returns their numbers."""
    import gc
    import threading

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_for_serving
    from paddle_tpu_torch.serving import PagedServingEngine

    rng = np.random.RandomState(2024)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),))
               for n in rng.randint(32, 513, size=CKPT_REQUESTS)]
    out = {}
    # the reference: the trained net cast to bf16 (as the load casts)
    fresh_net = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=0)
    with torch.no_grad():
        for (k, p), (k2, q) in zip(fresh_net.state_dict().items(),
                                   trained.state_dict().items()):
            p.copy_(q)

    def streams(eng):
        hs = eng.generate(prompts, CKPT_NEW)
        bad = [h for h in hs if h.status != "DONE"]
        if bad:
            fail(f"publish: request {bad[0].request.request_id} "
                 f"{bad[0].status}")
        return [h.tokens for h in hs]

    for leg in ("bf16", "int8"):
        kernels.reset_launch_counts()
        cache = "bfloat16" if leg == "bf16" else "int8"
        init = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                seed=5)
        if leg == "int8":
            quantize_for_serving(init, inplace=True)
            ref_net = quantize_for_serving(fresh_net)
            template = LlamaForCausalLM(cfg, device=dev,
                                        dtype=torch.bfloat16, seed=7)
        else:
            ref_net, template = fresh_net, None
        eng = PagedServingEngine(init, cache_dtype=cache, **ENGINE_KW)
        warm = warm_engine(torch, eng, f"publish ({leg})")
        pre = streams(eng)
        captures = eng.compile_counts()
        ptrs = _weight_ptrs(init)
        free, total_mem = torch.cuda.mem_get_info()
        box = {}

        def prepare():
            t0 = time.perf_counter()
            # the int8 leg reads the directory the bf16 leg verified in
            # full
            box["staged"] = eng.prepare_reload(
                CKPT_DIR, template_net=template,
                verify_level="full" if leg == "bf16" else "size")
            box["prepare_s"] = time.perf_counter() - t0

        # the prepare runs off the engine's thread while the engine serves
        # the same requests again: its replays must not be disturbed
        worker = threading.Thread(target=prepare)
        t0 = time.perf_counter()
        worker.start()
        during = streams(eng)
        traffic_s = time.perf_counter() - t0
        overlapped = worker.is_alive()
        worker.join()
        if during != pre:
            fail(f"publish ({leg}): streams served during the prepare "
                 f"differ from the ones before it")
        staged, prepare_s = box.get("staged"), box.get("prepare_s")
        if staged is None or not staged.ok:
            fail(f"publish ({leg}): prepare_reload: "
                 f"{staged and staged.to_json()}")
        h_in = eng.submit(prompts[0], CKPT_NEW)
        eng.step()
        if h_in.status != "RUNNING":
            fail(f"publish ({leg}): the request is not in flight")
        seen = _timed_apply(eng)
        eng.commit_reload(staged)
        if not eng.reload_in_progress:
            fail(f"publish ({leg}): the swap applied with a request in "
                 f"flight")
        eng.run_until_idle()
        post = streams(eng)
        if h_in.tokens != pre[0] or h_in.weights_version != "v0":
            fail(f"publish ({leg}): the in-flight request ran "
                 f"{h_in.tokens} ({h_in.weights_version}), the pre-swap "
                 f"stream is {pre[0]}")
        ref = PagedServingEngine(ref_net, cache_dtype=cache, **ENGINE_KW)
        want = streams(ref)
        ref.close()
        differ = sum(a != b for x, y in zip(post, want)
                     for a, b in zip(x, y))
        if post != want:
            fail(f"publish ({leg}): {differ} post-swap tokens differ from a "
                 f"fresh engine's on the trained weights")
        if eng.compile_counts() != captures or _weight_ptrs(init) != ptrs:
            fail(f"publish ({leg}): captures {eng.compile_counts()} (before "
                 f"{captures}) or parameter addresses moved across the swap")
        m = eng.metrics
        res = {"card": card, "cache": cache, "weights_version":
               eng.weights_version, "reloads": m.reloads.by_label(),
               "prepare_s": prepare_s, "timings": staged.timings,
               "traffic_during_prepare_s": traffic_s,
               "prepare_outlasted_traffic": overlapped,
               "pause_s": m.reload_ttft_spike.sum,
               "apply_s": seen.get("apply_s"),
               "mem_get_info_before_prepare": [free, total_mem],
               "tokens_differing_from_pre_swap": sum(
                   a != b for x, y in zip(post, pre) for a, b in zip(x, y)),
               "warmup_s": warm["warmup_s"], "captures": captures}
        log(f"publish ({leg}): " + json.dumps(res))
        out[leg] = res
        _add_counts(total, kernels.launch_counts())
        eng.close()
        del eng, init, ref_net, template, ref, staged
        gc.collect()
        torch.cuda.empty_cache()
    del fresh_net
    return out


# ------------------------------------------------------------ serving
SERVE_MAX_NEW = 64
# every serving phase's engines: 8 rows of 2048 slots, pages of 16
ENGINE_KW = dict(max_batch_size=8, max_seq_len=2048, page_size=16)
# the numbers each mode prints, run by run
MODE_KEYS = ("itl_p50_s", "decode_step_p50_s", "decode_s", "ttft_p50_s",
             "ttft_p50_ceil_rank_s", "prefill_tok_per_s", "wall_s",
             "peak_mem_bytes", "reserved_bytes")


def ceil_rank(xs, q):
    """The ``q``-th percentile of ``xs`` at the rank ceil(q n / 100) - 1
    of the sorted samples, which the port's serving histograms read
    before they took the registry's round(q (n - 1) / 100): for 12
    samples the p50 is the 6th, where the registry reads the 7th.
    Printed beside the registry's p50 so that readings taken under
    either rank compare."""
    import math

    s = sorted(xs)
    return s[max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))]


def serving_prompts(np, cfg):
    """The serving traffic's 12 prompts, 32-1024 tokens, from seed 1234:
    ``(lens, prompts)``."""
    rng = np.random.RandomState(1234)
    lens = rng.randint(32, 1025, size=12)
    return lens, [rng.randint(0, cfg.vocab_size, (int(n),)) for n in lens]


def drive_requests(torch, np, eng, cfg, mode, label):
    """The serving traffic: 12 requests, prompts of 32-1024 tokens from
    seed 1234, 64 new tokens each, six at once and six more after 24
    steps, so late requests take rows that early ones free. The launch
    counts are zeroed just before and read just after. Returns the run:
    its handles, prompt lengths, decode steps and prefills, launch
    counts (and by design), the engine's capture counts before and
    after, and ``result``, the numbers it prints."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    eng.metrics = ServingMetrics()  # this run's numbers only
    lens, prompts = serving_prompts(np, cfg)
    captures = eng.compile_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [eng.submit(p, SERVE_MAX_NEW) for p in prompts[:6]]
    for _ in range(24):
        eng.step()
    handles += [eng.submit(p, SERVE_MAX_NEW) for p in prompts[6:]]
    steps = 24 + eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    designs = {"fusions": kernels.fusion_design_counts(),
               "int8_matmul": kernels.int8_matmul_design_counts()}
    peak = torch.cuda.max_memory_allocated()
    for h in handles:
        if h.status != "DONE" or len(h.tokens) != SERVE_MAX_NEW:
            fail(f"{label} ({mode}): request {h.request.request_id}: "
                 f"status {h.status}, {len(h.tokens)} tokens")
    if eng.page_pool.pages_in_use:
        fail(f"{label} ({mode}): {eng.page_pool.pages_in_use} pages leaked")
    if min(h.admitted_step for h in handles[6:]) < 24:
        fail(f"{label} ({mode}): late requests were not admitted after "
             f"the first wave")
    m = eng.metrics
    result = {
        "mode": mode, "steps": steps, "wall_s": wall,
        "prefill_tokens": m.prefill_tokens.value,
        "prefill_s": m.prefill_time.sum,
        "prefill_tok_per_s": m.prefill_tokens.value / m.prefill_time.sum,
        "decode_tokens": m.decode_tokens.value,
        "decode_s": m.decode_step_time.sum,
        "decode_tok_per_s": m.decode_tokens.value / m.decode_step_time.sum,
        "ttft_p50_s": m.ttft.percentile(50),
        "ttft_p50_ceil_rank_s": ceil_rank([h.ttft for h in handles], 50),
        "prefill_p50_s": m.prefill_time.percentile(50),
        "itl_p50_s": m.itl.percentile(50),
        "decode_step_p50_s": m.decode_step_time.percentile(50),
        "peak_mem_bytes": peak,
        "reserved_bytes": torch.cuda.memory_reserved(),
        "launches": counts, "captures": eng.compile_counts(),
    }
    log(f"{label} ({mode}): " + json.dumps(result))
    return {"mode": mode, "handles": handles, "lens": lens,
            "decode_steps": m.decode_step_time.count,
            "prefills": m.prefill_time.count, "counts": counts,
            "designs": designs, "captures_before": captures,
            "captures": result["captures"], "result": result}


def teacher_forced(torch, dev, handles, logits_of, label):
    """Every generated token must be the argmax of ``logits_of(ids)``
    ([S, V] logits of the whole sequence) at its position, or trail it
    by less than NEAR_TIE. Returns (near-ties, largest gap)."""
    ties, worst_gap = 0, 0.0
    with torch.inference_mode():
        for h in handles:
            ids = torch.as_tensor(h.output_ids, dtype=torch.long,
                                  device=dev)[None]
            logits = logits_of(ids).float()
            if not torch.isfinite(logits).all():
                fail(f"{label}: the reference produced non-finite logits")
            p, n = h.request.prompt_len, len(h.tokens)
            rows = logits[p - 1:p - 1 + n]
            gen = ids[0, p:p + n]
            top = rows.argmax(dim=-1)
            gap = rows.max(dim=-1).values - rows.gather(
                1, gen[:, None])[:, 0]
            miss = top != gen
            if miss.any():
                g = float(gap[miss].max())
                worst_gap = max(worst_gap, g)
                ties += int(miss.sum())
                if g >= NEAR_TIE:
                    fail(f"{label}: request {h.request.request_id}: a "
                         f"generated token trails the reference argmax by "
                         f"{g:.4f} >= {NEAR_TIE}")
    log(f"{label}: teacher-forced check passed for "
        f"{sum(len(h.tokens) for h in handles)} tokens; {ties} near-ties "
        f"(largest gap {worst_gap:.4f} < {NEAR_TIE})")
    return ties, worst_gap


def report_memory(eng, label):
    """``memory_report()`` after a ``warmup()``, on a line of its own: the
    programs it lists, the largest peak allocated during a capture, the
    graph pool growth summed, and the five programs whose first call grew
    the reserved memory most. Fails when it is None. Returns the line's
    numbers."""
    rep = eng.memory_report()
    if rep is None:
        fail(f"{label}: memory_report() is None after warmup()")
    progs = rep["programs"]
    top = sorted(progs.items(), key=lambda kv: -kv[1]["graph_pool_bytes"])
    out = {"programs": len(progs), "max_peak_bytes": rep["max_peak_bytes"],
           "graph_pool_bytes": sum(e["graph_pool_bytes"]
                                   for e in progs.values()),
           "largest": dict(top[:5])}
    log(f"{label} memory_report: " + json.dumps(out))
    return out


def warm_engine(torch, eng, label):
    """``warmup()`` of a graph engine before its traffic: fails unless it
    captures 1 + 2 x buckets programs (17 at 2048 slots from bucket 16)
    and a second call none. Returns its seconds and the device memory
    it took: ``memory_allocated`` (the pooled prefill blocks, one a
    bucket, which an eager engine also allocates as it meets each
    bucket, ``block_bytes``; and the programs' static outputs) and
    ``memory_reserved`` (with the graph pool)."""
    from paddle_tpu_torch.quantization.kv import kv_token_bytes

    cfg = eng.config
    buckets = eng._warmup_buckets()
    block_bytes = sum(buckets) * 2 * cfg.num_hidden_layers * kv_token_bytes(
        cfg.kv_heads, cfg.head_dim, eng.cache_dtype)
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    stats = eng.warmup()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = 1 + 2 * len(buckets)
    if stats != {"programs": want, "aot_hits": 0, "aot_saves": 0}:
        fail(f"{label}: warmup() gave {stats}, expected {want} programs")
    if eng.warmup()["programs"]:
        fail(f"{label}: a second warmup() captured programs")
    memory = report_memory(eng, label)
    res = {"warmup_s": seconds, "programs": stats["programs"],
           "buckets": buckets, "captures": eng.compile_counts(),
           "block_bytes": block_bytes,
           "programs_alloc_bytes": torch.cuda.memory_allocated() - alloc0,
           "programs_reserved_bytes": (torch.cuda.memory_reserved()
                                       - reserved0),
           "memory_report": memory}
    log(f"{label} warmup: " + json.dumps(res))
    return res


def serve_modes(torch, np, cfg, engines, order, label, want_counts,
                recaptures=None):
    """The 12 requests through ``engines[mode]`` ("graphs": the programs,
    the default; "eager": ``graphs=False``) for each mode of ``order``,
    in one call. Fails unless every run's streams equal the first run's
    token for token, every run launched ``want_counts(run)`` (the graph
    runs count each replay's captured launches), and the graph engine's
    captures moved by ``recaptures(run)`` in its first run (by default
    none: warmed before) and by none after it. Returns the runs and a
    summary of each mode's numbers."""
    runs, seen = [], set()
    for mode in order:
        run = drive_requests(torch, np, engines[mode], cfg, mode, label)
        runs.append(run)
        first = runs[0]
        for h, ref in zip(run["handles"], first["handles"]):
            if h.tokens != ref.tokens:
                fail(f"{label}: the {mode} stream of request "
                     f"{h.request.request_id} differs from the "
                     f"{first['mode']} one: {h.tokens} != {ref.tokens}")
        want = want_counts(run)
        if run["counts"] != want:
            fail(f"{label} ({mode}): launches {run['counts']}, expected "
                 f"{want} ({run['decode_steps']} decode steps, "
                 f"{run['prefills']} prefills)")
        moved = {k: run["captures"][k] - run["captures_before"][k]
                 for k in run["captures"]}
        want_moved = dict.fromkeys(moved, 0)
        if mode == "graphs" and mode not in seen and recaptures:
            want_moved.update(recaptures(run))
        if moved != want_moved:
            fail(f"{label} ({mode}): captures moved {moved} during "
                 f"traffic, expected {want_moved}")
        seen.add(mode)
    summary = {mode: {k: [r["result"][k] for r in runs
                          if r["mode"] == mode] for k in MODE_KEYS}
               for mode in dict.fromkeys(order)}
    log(f"{label} modes: " + json.dumps(summary))
    return runs, summary


def serving_phase(torch, np, dev, card, profile_steps=0):
    import gc

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import PagedServingEngine

    cfg = LlamaConfig.llama2_7b()
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    log(f"serving: Llama-2-7B, {layers} layers, "
        f"{net.num_params() / 1e9:.3f}B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = PagedServingEngine(net, cache_dtype="bfloat16", **ENGINE_KW)
    eager = PagedServingEngine(net, cache_dtype="bfloat16", graphs=False,
                               **ENGINE_KW)
    log(f"serving: two engines (graphs, eager), each a page arena of "
        f"{eng.page_pool.num_pages + 1} pages x 16 slots, "
        f"{eng.page_pool.arena_bytes() / 1e9:.2f} GB")
    warm = warm_engine(torch, eng, "serving")

    def want_counts(run):
        fwd = run["decode_steps"] + run["prefills"]
        want = {k: 0 for k in run["counts"]}
        want.update(rms_norm=(2 * layers + 1) * fwd, rope=layers * fwd,
                    paged_attention=layers * run["decode_steps"])
        return want

    runs, summary = serve_modes(
        torch, np, cfg, {"graphs": eng, "eager": eager},
        ("eager", "graphs", "eager", "graphs"), "serving", want_counts)
    graph_run = runs[1]
    # teacher-forced check against the cache-free forward
    ties, worst_gap = teacher_forced(torch, dev, graph_run["handles"],
                                     lambda ids: net(ids)[0], "serving")
    frontend_counts, fe_res = frontend_phase(
        torch, np, dev, card, net, eng, cfg, graph_run["handles"],
        want_counts)
    if profile_steps:
        frontend_profile(torch, np, eng, cfg, card)
    res = {"card": card, "model": f"Llama-2-7B, {layers} layers, bf16, "
                                  f"random weights",
           "requests": len(graph_run["handles"]),
           "prompt_lens": [int(n) for n in graph_run["lens"]],
           "max_new_tokens": SERVE_MAX_NEW,
           "decode_steps": graph_run["decode_steps"],
           "prefills": graph_run["prefills"],
           "arena_bytes": eng.page_pool.arena_bytes(),
           "warmup": warm, "modes": summary,
           "near_ties": ties, "near_tie_max_gap": worst_gap}
    log("serving: " + json.dumps(res))
    if profile_steps:
        profile_decode(torch, np, eng, cfg, profile_steps, "decode")
        profile_decode(torch, np, eager, cfg, profile_steps, "decode_eager")
        profile_prefill(torch, np, eng, cfg, "prefill_1024")
    fused = fused_serving(torch, np, dev, card, net, eng, eager, cfg,
                          graph_run["handles"], profile_steps)
    # the eager engine's arena and blocks make room for the fleet's and the
    # prefix engines
    eager.close()
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    fleet_counts = fleet_phase(torch, np, dev, card, net, eng, cfg,
                               graph_run, want_counts, fe_res)
    prefix = prefix_phase(torch, np, dev, card, net, eng)
    session = session_phase(torch, np, dev, card, net, eng)
    beam = beam_phase(torch, np, dev, card, net)
    # the perfect-draft leg zeroes layers of this net: no later phase uses
    # its weights (the full-depth reload replaces them; the quantized phase
    # builds its own)
    spec = spec_phase(torch, np, dev, card, net, eng, profile_steps)
    reload = full_reload_phase(torch, np, dev, card, eng)
    return (graph_run["counts"], runs[0]["counts"], fused, prefix, session,
            spec, beam, reload, frontend_counts, fleet_counts)


# the front-end phase: long streams that hold every row while a burst
# past max_queue_size arrives, and the burst's requests
FE_LONG_NEW, FE_BURST_EXTRA, FE_SHORT_LEN, FE_SHORT_NEW = 256, 8, 16, 2


def _sse(host, port, payload, traceparent=None, first_token=None,
         timeout=600):
    """POST ``payload`` to ``/v1/generate`` (with a ``traceparent``
    header) and read the SSE stream: ``(status, events, body)``, with
    ``events`` the ``(event, data, client_seconds)`` triples of a 200
    and ``body`` the JSON body of any other status; ``first_token`` (an
    Event) is set at the first token."""
    import http.client

    from paddle_tpu_torch.serving import read_sse_events

    headers = {"Content-Type": "application/json"}
    if traceparent is not None:
        headers["traceparent"] = traceparent
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(payload),
                     headers=headers)
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, [], json.loads(resp.read() or b"null")
        events = []
        for event, data in read_sse_events(resp):
            events.append((event, data, time.perf_counter() - t0))
            if event == "token" and first_token is not None:
                first_token.set()
            if event in ("done", "error"):
                break
        return 200, events, None
    finally:
        conn.close()


def _http(host, port, method, path, body=None):
    """One plain request: ``(status, bytes, seconds)``."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=120)
    t0 = time.perf_counter()
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data, time.perf_counter() - t0
    finally:
        conn.close()


def _in_threads(fns):
    """Run the callables on threads of their own; their results in
    order (an exception is re-raised)."""
    import threading

    out = [None] * len(fns)

    def run(i, fn):
        try:
            out[i] = (True, fn())
        except BaseException as e:  # re-raised on the main thread
            out[i] = (False, e)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for ok, v in out:
        if not ok:
            raise v
    return [v for _, v in out]


def _traced_itl(torch, np, eng, cfg, sample):
    """The 12 serving prompts in process, all submitted at once, each
    with a front-end-style root trace (``sample`` 1: traced, 0: sampled
    out): the run's ITL and decode-step p50."""
    from paddle_tpu_torch.observability.tracing import get_tracer
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    os.environ["PADDLE_TPU_TRACE_SAMPLE"] = str(sample)
    eng.metrics = ServingMetrics()
    _, prompts = serving_prompts(np, cfg)
    tr = get_tracer()
    handles = []
    for p in prompts:
        h = eng.submit(p, SERVE_MAX_NEW)
        h.trace = tr.start_trace("frontend.request",
                                 request_id=h.request.request_id)
        handles.append(h)
    eng.run_until_idle()
    torch.cuda.synchronize()
    traced = sum(h.trace is not None for h in handles)
    for h in handles:
        if h.trace is not None:
            h.trace.finish(status=h.status, tokens=len(h.tokens))
    if traced != (12 if sample else 0):
        fail(f"frontend: {traced} of 12 requests traced at sample {sample}")
    m = eng.metrics
    return {"sample": sample, "itl_p50_s": m.itl.percentile(50),
            "decode_step_p50_s": m.decode_step_time.percentile(50)}


def frontend_phase(torch, np, dev, card, net, eng, cfg, inproc, want_counts):
    """The warmed 7B graph engine behind ``ServingFrontend`` on 127.0.0.1
    (see the module docstring). ``inproc`` is the serving phase's graph
    run (its handles, in prompt order); ``want_counts(run)`` the launch
    formula. Returns the launch counts of the 12 streams and the phase's
    printed numbers."""
    import secrets
    import threading
    import types

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import ServingFrontend
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    t_phase = time.perf_counter()
    legs = {}
    sample_env = os.environ.get("PADDLE_TPU_TRACE_SAMPLE")
    os.environ["PADDLE_TPU_TRACE_SAMPLE"] = "1"
    eng.metrics = ServingMetrics()  # this phase's numbers only
    fe = ServingFrontend(eng, host="127.0.0.1", port=0).start()
    host, port = "127.0.0.1", fe.port

    def health():
        st, data, _ = _http(host, port, "GET", "/healthz")
        if st != 200:
            fail(f"frontend: /healthz answered {st}")
        return json.loads(data)

    h0 = health()
    entries0 = h0["compile_entries"]
    # ---- 12 concurrent SSE streams, each under a client span
    t0 = time.perf_counter()
    lens, prompts = serving_prompts(np, cfg)
    clients = [obs.SpanContext(secrets.token_hex(16), secrets.token_hex(8))
               for _ in prompts]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    streams = _in_threads([
        (lambda p=p, c=c: _sse(host, port, {
            "input_ids": [int(t) for t in p],
            "max_new_tokens": SERVE_MAX_NEW}, c.traceparent()))
        for p, c in zip(prompts, clients)])
    counts = kernels.launch_counts()
    legs["streams_s"] = time.perf_counter() - t0
    m = eng.metrics
    run = {"counts": counts, "decode_steps": m.decode_step_time.count,
           "prefills": m.prefill_time.count}
    if counts != want_counts(run):
        fail(f"frontend: launches {counts}, expected {want_counts(run)} "
             f"({run['decode_steps']} decode steps, {run['prefills']} "
             f"prefills)")
    tokens, wire_ttft, wire_itl = [], [], []
    for i, (st, events, body) in enumerate(streams):
        if st != 200 or not events or events[-1][0] != "done":
            fail(f"frontend: stream {i} ended {st} {body} "
                 f"{events[-1][:2] if events else None}")
        toks = [d["token"] for e, d, _ in events if e == "token"]
        if toks != events[-1][1]["tokens"] or len(toks) != SERVE_MAX_NEW:
            fail(f"frontend: stream {i}'s token events disagree with its "
                 f"done event or count {len(toks)}")
        tokens.append(toks)
        times = [t for e, _, t in events if e == "token"]
        wire_ttft.append(times[0])
        wire_itl.extend(b - a for a, b in zip(times, times[1:]))
    differ, check = 0, []
    for i, (toks, h) in enumerate(zip(tokens, inproc)):
        if toks != h.tokens:
            differ += sum(a != b for a, b in zip(toks, h.tokens))
            p = [int(t) for t in prompts[i]]
            check.append(types.SimpleNamespace(
                output_ids=p + toks, tokens=toks,
                request=types.SimpleNamespace(prompt_len=len(p),
                                              request_id=i)))
    if check:
        teacher_forced(torch, dev, check, lambda ids: net(ids)[0],
                       "frontend")
    # ---- /metrics
    st, data, scrape_s = _http(host, port, "GET", "/metrics")
    scrape_bytes = len(data)
    scrape = obs.parse_prometheus_text(data.decode("utf-8"))
    n_tok = sum(len(t) for t in tokens)

    def sample(name, **labels):
        for lab, v in scrape.get(name, ()):
            if lab == labels:
                return v
        return None

    got = {"wire_ttft": sample("paddle_serving_wire_ttft_seconds_count"),
           "wire_itl": sample("paddle_serving_wire_itl_seconds_count"),
           "ttft_interactive": sample("paddle_serving_ttft_seconds_count",
                                      slo_class="interactive")}
    if st != 200 or got != {"wire_ttft": 12, "wire_itl": n_tok - 12,
                            "ttft_interactive": 12}:
        fail(f"frontend: /metrics {st}: {got}, expected wire TTFT 12, wire "
             f"ITL {n_tok - 12}, interactive TTFT 12")
    # ---- /trace: the handler finishes its request span after the done
    # event is written, so poll until all 12 are in
    deadline = time.perf_counter() + 30
    while True:
        st, data, _ = _http(host, port, "GET", "/trace")
        by_id = {t["trace_id"]: t["spans"]
                 for t in json.loads(data)["traces"]}
        if all(any(sp["name"] == "frontend.request"
                   for sp in by_id.get(c.trace_id, ())) for c in clients):
            break
        if time.perf_counter() > deadline:
            fail("frontend: /trace lacks a request span after 30 s")
        time.sleep(0.05)
    ring = obs.tracing.DEFAULT_EVENT_RING
    for c, toks in zip(clients, tokens):
        spans = {sp["name"]: sp for sp in by_id[c.trace_id]}
        req = spans["frontend.request"]
        if req["parent_id"] != c.span_id:
            fail(f"frontend: trace {c.trace_id}: the request span's parent "
                 f"{req['parent_id']} is not the client's {c.span_id}")
        for name in ("engine.queue_wait", "engine.prefill",
                     "engine.decode"):
            sp = spans.get(name)
            if sp is None or sp["parent_id"] != req["span_id"]:
                fail(f"frontend: trace {c.trace_id}: {name} missing or not "
                     f"under the request span: {sorted(spans)}")
        steps = [e for e in spans["engine.decode"]["events"]
                 if e["name"] == "decode_step"]
        if len(steps) != min(len(toks) - 1, ring):
            fail(f"frontend: trace {c.trace_id}: {len(steps)} decode_step "
                 f"events for {len(toks) - 1} decode steps")
    # ---- /healthz
    h1 = health()
    mem = json.loads(json.dumps(eng.memory_report()))
    if h1.get("memory") != mem:
        fail("frontend: /healthz memory differs from memory_report()")
    if h1["compile_entries"] != entries0 or eng.trace_guard.findings \
            or eng.metrics.guard_fires.value:
        fail(f"frontend: compile_entries {entries0} -> "
             f"{h1['compile_entries']}, guard findings "
             f"{eng.trace_guard.findings}")
    in_process = {"ttft_p50_s": m.ttft.percentile(50),
                  # the window's samples: the streams' handles live in
                  # the server
                  "ttft_p50_ceil_rank_s": ceil_rank(list(m.ttft._samples),
                                                    50),
                  "itl_p50_s": m.itl.percentile(50)}
    # ---- backpressure: long streams hold every row, then a burst
    t0 = time.perf_counter()
    rng = np.random.RandomState(99)
    long_started = [threading.Event() for _ in range(eng.max_batch_size)]
    long_threads, long_out = [], [None] * eng.max_batch_size

    def long_stream(i):
        long_out[i] = _sse(host, port, {
            "input_ids": [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                       (32,))],
            "max_new_tokens": FE_LONG_NEW}, first_token=long_started[i])

    for i in range(eng.max_batch_size):
        long_threads.append(threading.Thread(target=long_stream, args=(i,)))
        long_threads[-1].start()
    for ev in long_started:
        if not ev.wait(120):
            fail("frontend: a long stream did not start")
    qmax = eng.scheduler.max_queue_size
    burst = _in_threads([
        (lambda: _sse(host, port, {
            "input_ids": [1 + j for j in range(FE_SHORT_LEN)],
            "max_new_tokens": FE_SHORT_NEW}))
        for _ in range(qmax + FE_BURST_EXTRA)])
    too_long = _sse(host, port, {
        "input_ids": [1] * (eng.max_seq_len + 1), "max_new_tokens": 8})
    for t in long_threads:
        t.join()
    codes = {}
    for st, events, body in burst:
        codes[st] = codes.get(st, 0) + 1
        if st == 200 and events[-1][0] != "done":
            fail(f"frontend: an accepted burst stream ended {events[-1]}")
        if st != 200 and (st, body.get("reason")) != (429, "queue_full"):
            fail(f"frontend: a burst request got {st} {body}")
    if not codes.get(429):
        fail(f"frontend: a burst of {qmax + FE_BURST_EXTRA} past "
             f"max_queue_size {qmax} got no 429: {codes}")
    if any(o[0] != 200 or o[1][-1][0] != "done" for o in long_out):
        fail("frontend: a long stream did not finish")
    if (too_long[0], (too_long[2] or {}).get("reason")) != (413, "too_long"):
        fail(f"frontend: a prompt past max_seq_len got {too_long[0]} "
             f"{too_long[2]}")
    legs["backpressure_s"] = time.perf_counter() - t0
    # ---- drain: the in-flight stream finishes, a new request gets 503
    t0 = time.perf_counter()
    started = threading.Event()
    inflight = []
    th = threading.Thread(target=lambda: inflight.append(_sse(
        host, port, {"input_ids": [int(t) for t in prompts[0][:64]],
                     "max_new_tokens": SERVE_MAX_NEW},
        first_token=started)))
    th.start()
    if not started.wait(120):
        fail("frontend: the in-flight stream did not start")
    st_drain = _http(host, port, "POST", "/drain")[0]
    rejected = _sse(host, port, {"input_ids": [1, 2, 3],
                                 "max_new_tokens": 4})
    th.join()
    st_undrain = _http(host, port, "POST", "/undrain")[0]
    if (st_drain, st_undrain) != (200, 200) \
            or (rejected[0], (rejected[2] or {}).get("reason")) \
            != (503, "draining") \
            or inflight[0][0] != 200 or inflight[0][1][-1][0] != "done":
        fail(f"frontend: drain {st_drain}, the new request {rejected[0]} "
             f"{rejected[2]}, the in-flight one {inflight[0][0]} "
             f"{inflight[0][1][-1][:2] if inflight[0][1] else None}")
    legs["drain_s"] = time.perf_counter() - t0
    fe.stop(close_engine=False)
    if fe.driver_errors:
        fail(f"frontend: driver errors {list(fe.driver_errors)}")
    # ---- traced against untraced, in process, alternated
    t0 = time.perf_counter()
    traced = [_traced_itl(torch, np, eng, cfg, s) for s in (1, 0) * 3]
    legs["traced_untraced_s"] = time.perf_counter() - t0
    if sample_env is None:
        os.environ.pop("PADDLE_TPU_TRACE_SAMPLE", None)
    else:
        os.environ["PADDLE_TPU_TRACE_SAMPLE"] = sample_env

    def p(xs, q):
        return float(np.percentile(np.asarray(xs), q))

    res = {
        "card": card, "streams": len(streams), "tokens": n_tok,
        "tokens_differing_from_in_process": differ,
        "requests_differing": len(check),
        "wire_ttft_p50_s": p(wire_ttft, 50), "wire_ttft_p90_s":
            p(wire_ttft, 90),
        "wire_itl_p50_s": p(wire_itl, 50), "wire_itl_p90_s": p(wire_itl, 90),
        "engine": in_process,
        "scrape_bytes": scrape_bytes,
        "scrape_s": scrape_s, "burst_codes": codes,
        "traced_itl_p50_s": [r["itl_p50_s"] for r in traced if r["sample"]],
        "untraced_itl_p50_s": [r["itl_p50_s"] for r in traced
                               if not r["sample"]],
        "traced_runs": traced, "legs_s": legs,
        "phase_s": time.perf_counter() - t_phase,
    }
    log("frontend: " + json.dumps(res))
    return counts, res


# the front end's step breakdown (``--profile-steps``): a stdlib-only SSE
# client for a child process, whose threads then do not take this
# interpreter's lock beside the engine's driver thread; it prints, per
# stream, its status, its last event and the client clock at each token
_SSE_CLIENT = r"""
import http.client, json, sys, threading, time
host, port = sys.argv[1], int(sys.argv[2])
payloads = json.load(sys.stdin)
out = [None] * len(payloads)


def run(i):
    conn = http.client.HTTPConnection(host, port, timeout=600)
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(payloads[i]),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        times, event, last = [], None, None
        for raw in resp:
            line = raw.decode("utf-8").rstrip("\r\n")
            if line.startswith("event:"):
                event = line[6:].strip()
            elif line.startswith("data:"):
                last = event
                if event == "token":
                    times.append(time.perf_counter())
                elif event in ("done", "error"):
                    break
        out[i] = {"status": resp.status, "last": last, "times": times}
    finally:
        conn.close()


threads = [threading.Thread(target=run, args=(i,))
           for i in range(len(payloads))]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps(out))
"""
FE_PROFILE_ROUNDS = 2


def frontend_profile(torch, np, eng, cfg, card):
    """Where the front end's extra ITL goes: one request a row (every row
    busy) of SERVE_MAX_NEW tokens, tracing off, in four settings
    alternated FE_PROFILE_ROUNDS times in one call: ``in_process`` (this
    thread steps the engine); ``in_process_writers`` (the same, with one
    thread a request doing an SSE handler's work for each token: format
    the event and write it to a socket, no HTTP); ``frontend`` (behind
    ``ServingFrontend``, the clients' threads in this process, as the
    gate leg runs them); ``frontend_child_clients`` (the clients in a
    child process). Over the decode-only steps (every row busy, no
    prefill in the step or the next) it reads the host clock's time
    inside ``step()``, the gap to the next ``step()`` and the interval
    between step starts (a token's ITL), each p50 and mean, beside the
    decode program's replay alone (CUDA events, ``replay_ms``) and the
    device's idle share of the interval that leaves, as
    ``profile_decode`` reads it."""
    import queue
    import socket
    import threading

    from paddle_tpu_torch.serving import ServingFrontend
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    sample_env = os.environ.get("PADDLE_TPU_TRACE_SAMPLE")
    os.environ["PADDLE_TPU_TRACE_SAMPLE"] = "0"
    rows = eng.max_batch_size
    rng = np.random.RandomState(99)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),))
               for n in rng.randint(32, 1025, size=rows)]
    payloads = [{"input_ids": [int(t) for t in p],
                 "max_new_tokens": SERVE_MAX_NEW} for p in prompts]
    real_step = eng.step
    marks = []  # (start, end, rows busy before, prefills in the step)
    replay = []

    def timed_step():
        busy, pf = eng.active_slots, eng.metrics.prefill_time.count
        t0 = time.perf_counter()
        out = real_step()
        marks.append((t0, time.perf_counter(), busy,
                      eng.metrics.prefill_time.count - pf))
        return out

    def sse_writer(q, sock):
        idx = 0
        while True:
            tok = q.get()
            if tok is None:
                return
            sock.sendall(f"event: token\ndata: "
                         f"{json.dumps({'index': idx, 'token': tok})}\n\n"
                         .encode("utf-8"))
            idx += 1

    def in_process(writers):
        sinks, threads = [], []
        if writers:
            for _ in range(rows):
                sinks.append((queue.Queue(), *socket.socketpair()))
                threads.append(threading.Thread(
                    target=sse_writer, args=sinks[-1][:2]))
                threads[-1].start()
        hs = [eng.submit(p, SERVE_MAX_NEW, on_token=None if not writers
                         else (lambda tok, h, q=sinks[i][0]: q.put(tok)))
              for i, p in enumerate(prompts)]
        while eng.active_slots or eng.scheduler.depth:
            timed_step()
            if not replay and len(marks) == 3 * rows:
                # the decode program alone, mid-run (its replays rewrite
                # the same slots with the same values); the sentinel
                # keeps the steps around it out of the pairs
                replay.append(replay_ms(
                    torch, eng._programs.get(("decode",)).graph))
                marks.append((0.0, 0.0, -1, 0))
        for q, a, b in sinks:
            q.put(None)
        for t in threads:
            t.join()
        for q, a, b in sinks:
            a.close()
            b.close()
        if any(h.status != "DONE" or len(h.tokens) != SERVE_MAX_NEW
               for h in hs):
            fail("frontend profile: an in-process request did not finish")
        return []

    def behind_frontend(child):
        eng.step = timed_step  # the driver thread takes it at start()
        fe = ServingFrontend(eng, host="127.0.0.1", port=0).start()
        try:
            if child:
                proc = subprocess.Popen(
                    [sys.executable, "-c", _SSE_CLIENT, "127.0.0.1",
                     str(fe.port)], stdin=subprocess.PIPE,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
                try:
                    out, err = proc.communicate(json.dumps(payloads),
                                                timeout=600)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.communicate()
                    fail("frontend profile: the child client timed out")
                if proc.returncode:
                    fail(f"frontend profile: the child client exited "
                         f"{proc.returncode}: {err[-2000:]}")
                streams = [(s or {}).get("times") for s in json.loads(out)
                           if (s or {}).get("status") == 200
                           and s.get("last") == "done"]
            else:
                streams = [[t for e, _, t in ev if e == "token"]
                           for st, ev, _ in _in_threads([
                               (lambda p=p: _sse("127.0.0.1", fe.port, p))
                               for p in payloads])
                           if st == 200 and ev and ev[-1][0] == "done"]
        finally:
            fe.stop(close_engine=False)
            del eng.step
        if fe.driver_errors:
            fail(f"frontend profile: driver errors {fe.driver_errors}")
        if len(streams) != rows or any(len(t) != SERVE_MAX_NEW
                                       for t in streams):
            fail(f"frontend profile: {len(streams)} of {rows} streams "
                 f"ended done with {SERVE_MAX_NEW} tokens")
        return [b - a for t in streams for a, b in zip(t, t[1:])]

    def ms(xs, how):
        return float(how(np.asarray(xs))) * 1e3

    t_phase = time.perf_counter()
    legs = {"in_process": lambda: in_process(False),
            "in_process_writers": lambda: in_process(True),
            "frontend": lambda: behind_frontend(False),
            "frontend_child_clients": lambda: behind_frontend(True)}
    runs = []
    for _ in range(FE_PROFILE_ROUNDS):
        for name, leg in legs.items():
            eng.metrics = ServingMetrics()
            marks.clear()
            wire = leg()
            pairs = [(a, b) for a, b in zip(marks, marks[1:])
                     if a[2] == b[2] == rows and not a[3] and not b[3]]
            if len(pairs) < SERVE_MAX_NEW // 2:
                fail(f"frontend profile ({name}): {len(pairs)} decode-only "
                     f"step pairs")
            if eng.page_pool.pages_in_use:
                fail(f"frontend profile ({name}): pages leaked")
            m = eng.metrics
            r = {"setting": name, "pairs": len(pairs)}
            for key, xs in (("step", [a[1] - a[0] for a, b in pairs]),
                            ("gap", [b[0] - a[1] for a, b in pairs]),
                            ("interval", [b[0] - a[0] for a, b in pairs]),
                            ("wire_itl", wire)):
                if xs:
                    r[f"{key}_p50_ms"] = ms(xs, np.median)
                    r[f"{key}_mean_ms"] = ms(xs, np.mean)
            r["engine_itl_p50_ms"] = m.itl.percentile(50) * 1e3
            r["engine_itl_mean_ms"] = m.itl.sum / m.itl.count * 1e3
            r["idle_share"] = 1.0 - replay[0] / r["interval_p50_ms"]
            runs.append(r)
    if sample_env is None:
        os.environ.pop("PADDLE_TPU_TRACE_SAMPLE", None)
    else:
        os.environ["PADDLE_TPU_TRACE_SAMPLE"] = sample_env
    log("frontend profile: " + json.dumps({
        "card": card, "rows": rows, "max_new_tokens": SERVE_MAX_NEW,
        "replay_ms": replay[0], "runs": runs,
        "phase_s": time.perf_counter() - t_phase}))


def fused_serving(torch, np, dev, card, net, eng, eager, cfg,
                  unfused_handles, profile_steps=0):
    """The serving phase's model and engines with both fusions: the same
    12 requests through the graph engine, whose decode and prefill
    programs are captured again at their first use (counted), and the
    eager one; per forward (decode step or prefill) the fused head once
    and two RMSNorms a layer (no final norm). The teacher-forced check
    runs the fused cache-free forward (rope_attention once a layer, no
    flash). Returns the launch counts of the graph and eager runs."""
    from paddle_tpu_torch import kernels

    layers = cfg.num_hidden_layers
    net.fusions = BOTH_FUSIONS
    t_phase = time.perf_counter()

    def want_counts(run):
        fwd = run["decode_steps"] + run["prefills"]
        want = {k: 0 for k in run["counts"]}
        want.update(rms_norm=2 * layers * fwd, rope=layers * fwd,
                    paged_attention=layers * run["decode_steps"],
                    rms_norm_matmul=fwd)
        # bf16 serving: the fused head on the tensor cores at every step
        heads = run["designs"]["fusions"]["rms_norm_matmul"]
        if heads != {"tc_launches": fwd, "split_launches": 0,
                     "cc_launches": 0}:
            fail(f"fused serving ({run['mode']}): fused head launches by "
                 f"design {heads}, expected all {fwd} on the tensor cores")
        return want

    def recaptures(run):
        buckets = {eng.pool.bucket_for(int(n)) for n in run["lens"]}
        return {"serving::decode_step": 1, "serving::prefill": len(buckets)}

    runs, summary = serve_modes(
        torch, np, cfg, {"graphs": eng, "eager": eager}, ("graphs", "eager"),
        "fused serving", want_counts, recaptures)
    graph_run = runs[0]
    kernels.reset_launch_counts()
    ties, worst_gap = teacher_forced(torch, dev, graph_run["handles"],
                                     lambda ids: net(ids)[0],
                                     "fused serving")
    check_counts = kernels.launch_counts()
    n_seq = len(graph_run["handles"])
    want_check = {k: 0 for k in check_counts}
    want_check.update(rms_norm=2 * layers * n_seq,
                      rope_attention=layers * n_seq, rms_norm_matmul=n_seq)
    if check_counts != want_check:
        fail(f"fused serving: teacher-forced check launched "
             f"{check_counts}, expected {want_check}")
    differ = sum(int((np.asarray(a.output_ids) != np.asarray(
        b.output_ids)).sum()) for a, b in zip(graph_run["handles"],
                                              unfused_handles))
    res = {"card": card, "fusions": sorted(net.fusions),
           "decode_steps": graph_run["decode_steps"],
           "prefills": graph_run["prefills"],
           "launches_per_decode_step": {
               "rms_norm_matmul": 1, "rms_norm": 2 * layers,
               "rope": layers, "paged_attention": layers},
           "check_launches": check_counts,
           "fusion_launches_by_design": graph_run["designs"]["fusions"],
           "captures": graph_run["captures"], "modes": summary,
           "near_ties": ties, "near_tie_max_gap": worst_gap,
           "tokens_differing_from_unfused": differ,
           "phase_s": time.perf_counter() - t_phase}
    log("fused serving: " + json.dumps(res))
    if profile_steps:
        profile_decode(torch, np, eng, cfg, profile_steps, "decode_fused")
        profile_prefill(torch, np, eng, cfg, "prefill_1024_fused")
    net.fusions = ()
    return graph_run["counts"], runs[1]["counts"]


# ------------------------------------------------------- prefix serving
# the prefix phase's traffic (seed 4321): a 1024-token shared prefix; 16
# first turns, the prefix and a distinct tail of 16-256 tokens, 8 at
# once and 8 more after 24 steps; then 4 second turns (a first turn's
# prompt and answer plus 32 new tokens) and 2 prompts that are the first
# 1000 and 1001 prefix tokens (they end inside a cached page, so the
# recompute boundary falls inside it: a copy-on-write clone); 64 new
# tokens each
PREFIX_LEN, PREFIX_FIRST, PREFIX_SECOND = 1024, 16, 4
PREFIX_PARTIAL = (1000, 1001)
PREFIX_REQUESTS = PREFIX_FIRST + PREFIX_SECOND + len(PREFIX_PARTIAL)
# every warm admission reuses at least 62 full pages of the prefix
PREFIX_MIN_SAVED = (PREFIX_REQUESTS - 1) * 992
PREFIX_COUNTERS = ("hits", "misses", "evictions", "cow_clones",
                   "tokens_saved", "flushes")


def prefix_traffic(np, cfg):
    rng = np.random.RandomState(4321)
    prefix = rng.randint(0, cfg.vocab_size, (PREFIX_LEN,))
    tails = rng.randint(16, 257, size=PREFIX_FIRST)
    first = [np.concatenate([prefix, rng.randint(0, cfg.vocab_size,
                                                 (int(n),))])
             for n in tails]
    second = [rng.randint(0, cfg.vocab_size, (32,))
              for _ in range(PREFIX_SECOND)]
    return first, second, [prefix[:n] for n in PREFIX_PARTIAL]


def drive_prefix(torch, np, eng, traffic, mode, label):
    """The prefix traffic through ``eng`` (a prefix engine, flushed first
    so that it starts with an empty cache, or the cold twin). The launch
    counts are zeroed just before and read just after. Returns the run as
    ``drive_requests`` does, with the prefix cache's and the pool's
    numbers."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    first, second, partial = traffic
    pc, pool = getattr(eng, "prefix_cache", None), eng.page_pool
    if pc is not None:
        pc.flush()
        before = pc.stats()
    eng.metrics = ServingMetrics()
    pool.peak_in_use = pool.pages_in_use
    peak_shared = 0
    captures = eng.compile_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()

    def steps_until_idle():
        nonlocal peak_shared
        n = 0
        while eng.scheduler.depth or eng.active_slots:
            eng.step()
            peak_shared = max(peak_shared, pool.shared_pages)
            n += 1
        return n

    handles = [eng.submit(p, SERVE_MAX_NEW) for p in first[:8]]
    for _ in range(24):
        eng.step()
        peak_shared = max(peak_shared, pool.shared_pages)
    handles += [eng.submit(p, SERVE_MAX_NEW) for p in first[8:]]
    steps = 24 + steps_until_idle()
    handles += [eng.submit(np.concatenate([h.output_ids, new]),
                           SERVE_MAX_NEW)
                for h, new in zip(handles, second)]
    handles += [eng.submit(p, SERVE_MAX_NEW) for p in partial]
    steps += steps_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for h in handles:
        if h.status != "DONE" or len(h.tokens) != SERVE_MAX_NEW:
            fail(f"{label} ({mode}): request {h.request.request_id}: "
                 f"status {h.status} ({h.reason}), {len(h.tokens)} tokens")
    if pc is None and pool.pages_in_use:
        fail(f"{label} ({mode}): {pool.pages_in_use} pages leaked")
    m = eng.metrics
    result = {
        "mode": mode, "steps": steps, "wall_s": wall,
        "requests": len(handles),
        "prefill_tokens": m.prefill_tokens.value,
        "prefill_s": m.prefill_time.sum,
        "prefill_p50_s": m.prefill_time.percentile(50),
        "warm_prefill_p50_s": m.warm_prefill_time.percentile(50),
        "warm_prefills": m.warm_prefill_time.count,
        "decode_tokens": m.decode_tokens.value,
        "decode_s": m.decode_step_time.sum,
        "ttft_p50_s": m.ttft.percentile(50),
        "itl_p50_s": m.itl.percentile(50),
        "decode_step_p50_s": m.decode_step_time.percentile(50),
        "peak_pages_in_use": pool.peak_in_use,
        "peak_shared_pages": peak_shared,
        "peak_mem_bytes": peak,
        "launches": counts, "captures": eng.compile_counts(),
    }
    if pc is not None:
        # this run's counts (a flush has emptied the cache before it)
        result["prefix"] = {k: v - before[k] if k in PREFIX_COUNTERS else v
                            for k, v in pc.stats().items()}
    log(f"{label} ({mode}): " + json.dumps(result))
    return {"mode": mode, "handles": handles,
            "decode_steps": m.decode_step_time.count,
            "prefills": m.prefill_time.count, "counts": counts,
            "captures_before": captures, "captures": result["captures"],
            "result": result}


def prefix_phase(torch, np, dev, card, net, cold):
    """The paged engine's prefix cache at Llama-2-7B: two prefix engines
    (graphs after ``warmup()``, and ``graphs=False``) beside the serving
    phase's graph engine as the cold twin, the prefix traffic in the
    order cold, prefix graphs, prefix eager, prefix graphs. Fails unless
    the prefix runs' streams are equal, every token passes the
    teacher-forced check, every run launched the counts the structure
    gives (a chunk prefill is one forward), nothing is captured during
    traffic, every prefix run hits on all but its first request and saves
    at least 62 pages a hit, and the arena drains. Returns the launch
    counts of the first prefix graph run and of the eager run."""
    from paddle_tpu_torch.serving import PagedServingEngine

    cfg = net.config
    layers = cfg.num_hidden_layers
    t_phase = time.perf_counter()
    traffic = prefix_traffic(np, cfg)
    cold.warmup()  # the fused serving's captures were dropped
    report_memory(cold, "prefix serving (cold)")
    eng = PagedServingEngine(net, cache_dtype="bfloat16", prefix_cache=True,
                             **ENGINE_KW)
    eager = PagedServingEngine(net, cache_dtype="bfloat16",
                               prefix_cache=True, graphs=False, **ENGINE_KW)
    buckets = eng._warmup_buckets()
    nb = len(buckets)
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    stats = eng.warmup()
    torch.cuda.synchronize()
    warm = {"warmup_s": time.perf_counter() - t0,
            "programs": stats["programs"],
            "captures": eng.compile_counts(),
            "programs_alloc_bytes": torch.cuda.memory_allocated() - alloc0,
            "programs_reserved_bytes": (torch.cuda.memory_reserved()
                                        - reserved0)}
    want_programs = 1 + 2 * nb + nb + nb * (nb + 1) // 2
    if stats["programs"] != want_programs or eng.warmup()["programs"]:
        fail(f"prefix serving: warmup() captured {stats['programs']} "
             f"programs, expected {want_programs} once")
    warm["memory_report"] = report_memory(eng, "prefix serving")
    log("prefix serving warmup: " + json.dumps(warm))

    def want_counts(run):
        fwd = run["decode_steps"] + run["prefills"]
        want = {k: 0 for k in run["counts"]}
        want.update(rms_norm=(2 * layers + 1) * fwd, rope=layers * fwd,
                    paged_attention=layers * run["decode_steps"])
        return want

    runs = []
    for mode, e in (("cold", cold), ("prefix graphs", eng),
                    ("prefix eager", eager), ("prefix graphs", eng)):
        run = drive_prefix(torch, np, e, traffic, mode, "prefix serving")
        runs.append(run)
        if run["counts"] != want_counts(run):
            fail(f"prefix serving ({mode}): launches {run['counts']}, "
                 f"expected {want_counts(run)}")
        if run["captures"] != run["captures_before"]:
            fail(f"prefix serving ({mode}): captures moved during traffic: "
                 f"{run['captures_before']} -> {run['captures']}")
        if mode == "cold":
            continue
        st = run["result"]["prefix"]
        if st["hits"] != PREFIX_REQUESTS - 1 or st["misses"] != 1 \
                or st["tokens_saved"] < PREFIX_MIN_SAVED:
            fail(f"prefix serving ({mode}): {st}, expected "
                 f"{PREFIX_REQUESTS - 1} hits, 1 miss and at least "
                 f"{PREFIX_MIN_SAVED} tokens saved")
        for h, ref in zip(run["handles"], runs[1]["handles"]):
            if h.tokens != ref.tokens:
                fail(f"prefix serving: the {mode} stream of request "
                     f"{h.request.request_id} differs from the prefix "
                     f"graphs one: {h.tokens} != {ref.tokens}")
    graph_run, cold_run = runs[1], runs[0]
    ties, worst_gap = teacher_forced(torch, dev, graph_run["handles"],
                                     lambda ids: net(ids)[0],
                                     "prefix serving")
    # decode-published KV against one prefill of the same tokens, for the
    # first request of the last run (its prompt and 63 answer tokens)
    h = runs[-1]["handles"][0]
    published = published_vs_prefill(
        torch, eng, [int(t) for t in h.output_ids],
        h.request.prompt_len + SERVE_MAX_NEW - 1)
    differ_cold = sum(
        int((np.asarray(a.output_ids) != np.asarray(b.output_ids)).sum())
        for a, b in zip(graph_run["handles"], cold_run["handles"]))
    for e in (eng, eager):
        e.prefix_cache.flush()
        st = e.page_pool.stats()
        if st["pages_in_use"] or st["claims"] != st["releases"] \
                or e.page_pool._refs:
            fail(f"prefix serving: not drained after a flush: {st}")
    # device time of one replay of each program of a warm admission at
    # the 2048 bucket (the shortest and the longest tail of the traffic)
    # and of the cold twin's prefill, CUDA events; the arenas hold no
    # live page now, so the adopt's replays overwrite nothing in use
    replays = {f"{k[0]}_{'_'.join(map(str, k[1:]))}": replay_ms(
        torch, e._programs.get(k).graph) for e, k in (
            (eng, ("gather", 2048)), (eng, ("chunk", 2048, 16)),
            (eng, ("chunk", 2048, 256)), (eng, ("adopt", 2048)),
            (cold, ("prefill", 2048)))}

    def by_mode(key):
        return {r["mode"] + f" {i}": r["result"][key]
                for i, r in enumerate(runs)}

    res = {"card": card,
           "model": f"Llama-2-7B, {layers} layers, bf16, random weights",
           "requests": PREFIX_REQUESTS, "prefix_tokens": PREFIX_LEN,
           "prompt_lens": [h.request.prompt_len
                           for h in graph_run["handles"]],
           "warmup": warm, "replay_ms": replays,
           "warm_prefill_p50_s": by_mode("warm_prefill_p50_s"),
           "prefill_p50_s": by_mode("prefill_p50_s"),
           "ttft_p50_s": by_mode("ttft_p50_s"),
           "itl_p50_s": by_mode("itl_p50_s"),
           "decode_s": by_mode("decode_s"),
           "peak_pages_in_use": by_mode("peak_pages_in_use"),
           "peak_shared_pages": by_mode("peak_shared_pages"),
           "prefix": graph_run["result"]["prefix"],
           "tokens_differing_from_cold": differ_cold,
           "decode_published": published,
           "near_ties": ties, "near_tie_max_gap": worst_gap,
           "phase_s": time.perf_counter() - t_phase}
    log("prefix serving: " + json.dumps(res))
    for e in (eng, eager):
        e.close()
    return graph_run["counts"], runs[2]["counts"]


# ------------------------------------------------------- session serving
# the multi-turn phase (seed 2468): 16 conversations of 3 turns over one
# 512-token system prompt; each turn adds 32-192 user tokens and asks 64
# new ones. Conversations 0-7 (wave A) and 8-15 (wave B) alternate turn
# by turn, each wave's 8 turns at once: A1, B1, A2, B2, A3, B3. The prefix
# engines' arena holds 400 pages, so a running wave evicts the idle
# wave's pages by its third turn.
SESSION_SYSTEM, SESSION_CONVS, SESSION_TURNS, SESSION_NEW = 512, 16, 3, 64
SESSION_USER = (32, 192)
SESSION_PAGES = 400
SESSION_TIER = {"host_budget_bytes": 4 << 30}
# spill and restore calls timed and restores read back: the first ones
SESSION_SAMPLE = 16


def session_traffic(np, cfg):
    """The system prompt and every conversation's user messages, turn by
    turn, from seed 2468."""
    rng = np.random.RandomState(2468)
    system = rng.randint(0, cfg.vocab_size, (SESSION_SYSTEM,))
    users = [[rng.randint(0, cfg.vocab_size,
                          (int(rng.randint(SESSION_USER[0],
                                           SESSION_USER[1] + 1)),))
              for _ in range(SESSION_TURNS)] for _ in range(SESSION_CONVS)]
    return system, users


def _spans_vs_prefill(torch, eng, tokens, lo, mid, valid):
    """The cached pages of ``tokens[:valid]`` against one prefill of the
    same tokens into a fresh cache at the bucket of ``valid``: the
    elements that differ in ``[lo, mid)`` (written by the warm admission's
    chunk prefill) and in ``[mid, valid)`` (written by the decode
    steps), with the elements compared."""
    from paddle_tpu_torch.models.generation import alloc_kv_caches

    ps = eng.page_size
    m = eng.prefix_cache.match(tokens, valid, eng.weights_version)
    if m.covered != valid:
        return {"not_measured": f"covered {m.covered} of {valid}"}
    bucket = eng.pool.bucket_for(valid)
    ids = torch.zeros((1, bucket), dtype=torch.long, device=eng.device)
    ids[0, :valid] = torch.as_tensor(list(tokens[:valid]), device=eng.device)
    ref = alloc_kv_caches(eng.config, 1, bucket, eng.cache_dtype,
                          device=eng.device)
    with torch.inference_mode():
        eng.net(ids, caches=ref, pos=0)
    out = {"chunk_written": [0, 0], "decode_written": [0, 0]}
    for i, page in enumerate(m.pages):
        for a, r in zip(_kv_leaves(eng._caches), _kv_leaves(ref)):
            for name, s0, s1 in (("chunk_written", lo, mid),
                                 ("decode_written", mid, valid)):
                s0, s1 = max(s0, i * ps), min(s1, (i + 1) * ps)
                if s0 >= s1:
                    continue
                got = a[page][s0 - i * ps:s1 - i * ps]
                want = r[0][s0:s1]
                out[name][0] += int((got != want).sum())
                out[name][1] += got.numel()
    return {k: {"differ": d, "elements": n} for k, (d, n) in out.items()}


class TierProbe:
    """Times the first ``SESSION_SAMPLE`` spills (the arena read and the
    store's ``put``) and restores (host clock to a sync), and reads back
    those restored pages: each must equal the arrays the checked frame
    gave (the frame's CRC holds them equal to the page that spilled).
    Installed over the prefix cache's hooks until ``remove()``."""

    def __init__(self, torch, eng):
        self.torch, self.eng = torch, eng
        pc, tier = eng.prefix_cache, eng.kv_tier
        self.spill_ms, self.restore_ms = [], []
        self.checked = self.mismatched = 0
        read, put, restore = pc._read_page, tier.put, pc._restore_page
        pending = []

        def timed_read(page):
            t0 = time.perf_counter()
            out = read(page)
            pending.append(time.perf_counter() - t0)
            return out

        def timed_put(*args, **kwargs):
            t0 = time.perf_counter()
            out = put(*args, **kwargs)
            dt = time.perf_counter() - t0 + (pending.pop() if pending else 0)
            if len(self.spill_ms) < SESSION_SAMPLE:
                self.spill_ms.append(dt * 1e3)
            return out

        def timed_restore(arrays):
            if len(self.restore_ms) >= SESSION_SAMPLE:
                return restore(arrays)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            page = restore(arrays)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if page is not None:
                self.restore_ms.append(dt * 1e3)
                back = eng._tier_read_page(page)
                self.checked += 1
                self.mismatched += not all(
                    torch.equal(a, b) for a, b in zip(back, arrays))
            return page

        pc._read_page, tier.put, pc._restore_page = (
            timed_read, timed_put, timed_restore)
        self._restore = (pc, tier, read, put, restore)

    def remove(self):
        pc, tier, read, put, restore = self._restore
        pc._read_page, pc._restore_page = read, restore
        del tier.put

    def numbers(self):
        med = statistics.median
        return {"spill_ms_p50": med(self.spill_ms) if self.spill_ms else None,
                "restore_ms_p50": (med(self.restore_ms) if self.restore_ms
                                   else None),
                "spills_timed": len(self.spill_ms),
                "restores_timed": len(self.restore_ms),
                "restores_read_back": self.checked,
                "restores_not_bit_equal": self.mismatched}


def _pctl(np, xs, q):
    return float(np.percentile(xs, q)) if xs else None


def session_phase(torch, np, dev, card, net, cold):
    """Multi-turn serving at Llama-2-7B bf16 (32 layers, nothing cut): two
    paged engines of 8 rows x 2048 slots, pages of 16, an arena of
    ``SESSION_PAGES`` pages, ``prefix_cache=True, sessions=True``, one
    with a host spill tier (``kv_tiering=SESSION_TIER``) and one that
    evicts outright, beside ``cold`` (the serving phase's graph engine,
    no prefix cache: the stream reference), through the session traffic
    wave by wave, every engine on the tier engine's prompts. Fails unless
    every turn finishes, the launches follow the structure (a chunk
    prefill is one forward; spills and restores launch no kernel),
    nothing is captured during traffic, the tier spilled and restored
    pages with no CRC refusal and every sampled restore read back
    bit-equal, every stream passes the teacher-forced check, the session
    stores counted 16 sessions and 48 turns, and the arenas drain.
    Prints TTFT p50 and p90 of turns 2-3, ITL p50, hits, tokens saved,
    pages spilled, restored and dropped, the spill's and the restore's
    milliseconds, peak pages, the stores' stats, and for C item 4 the
    tokens that differ from the cold engine's streams by turn (turn 1's
    warm hits cover prompt pages only, written by a prefill or a chunk
    prefill; turns 2-3 also cover decode-written pages), with the cached
    KV of wave A's first turns against one prefill (chunk-written and
    decode-written spans apart). Returns the tier engine's launch
    counts."""
    import gc

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import PagedServingEngine
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    cfg = net.config
    layers = cfg.num_hidden_layers
    t_phase = time.perf_counter()
    system, users = session_traffic(np, cfg)
    kw = dict(ENGINE_KW, cache_dtype="bfloat16", num_pages=SESSION_PAGES,
              prefix_cache=True, sessions=True)
    engines = {"tier": PagedServingEngine(net, kv_tiering=SESSION_TIER,
                                          **kw),
               "no tier": PagedServingEngine(net, **kw)}
    log(f"session serving: arenas of {SESSION_PAGES} pages x 16 slots, "
        f"{engines['tier'].page_pool.arena_bytes() / 1e9:.2f} GB each; "
        f"host tier budget {SESSION_TIER['host_budget_bytes'] / 2**30} GiB")
    warm = {}
    for name, eng in engines.items():
        t0 = time.perf_counter()
        warm[name] = {"programs": eng.warmup()["programs"],
                      "warmup_s": time.perf_counter() - t0,
                      "memory_report": report_memory(
                          eng, f"session serving ({name})")}
    all_engines = dict(engines, cold=cold)
    for eng in all_engines.values():
        eng.metrics = ServingMetrics()
        eng.page_pool.peak_in_use = eng.page_pool.pages_in_use
    captures = {n: e.compile_counts() for n, e in all_engines.items()}
    handles = {n: [] for n in all_engines}  # (conv, turn, handle)
    counts = {n: {} for n in all_engines}
    probe = TierProbe(torch, engines["tier"])
    convs = [np.asarray(system) for _ in range(SESSION_CONVS)]
    kv_checks = []
    waves = [(t, w) for t in range(SESSION_TURNS) for w in (0, 1)]
    for turn, wave in waves:
        ids = list(range(wave * 8, wave * 8 + 8))
        prompts = {c: np.concatenate([convs[c], users[c][turn]])
                   for c in ids}
        for name, eng in all_engines.items():
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            sid = None if name == "cold" else "conv-{}"
            hs = [eng.submit(prompts[c], SESSION_NEW, session_id=(
                None if sid is None else sid.format(c))) for c in ids]
            eng.run_until_idle()
            torch.cuda.synchronize()
            for k, v in kernels.launch_counts().items():
                counts[name][k] = counts[name].get(k, 0) + v
            for c, h in zip(ids, hs):
                if h.status != "DONE" or len(h.tokens) != SESSION_NEW:
                    fail(f"session serving ({name}): conversation {c} turn "
                         f"{turn + 1}: {h.status} ({h.reason}), "
                         f"{len(h.tokens)} tokens")
                handles[name].append((c, turn, h))
        for c, h in zip(ids, [h for c_, t_, h in handles["tier"][-8:]]):
            convs[c] = np.asarray(h.output_ids)
        if turn == 0 and wave == 0:
            eng = engines["tier"]
            for c, h in zip(ids, [h for _, _, h in handles["tier"][-8:]]):
                p = h.request.prompt_len
                kv_checks.append(dict(
                    conversation=c, prompt_len=p,
                    admission="cold" if c == ids[0] else "warm",
                    tail_bucket=min(b for b in eng._tail_buckets(
                        eng.pool.bucket_for(p)) if b >= p - SESSION_SYSTEM),
                    **_spans_vs_prefill(torch, eng, h.output_ids,
                                        SESSION_SYSTEM, p,
                                        p + SESSION_NEW - 1)))
    probe.remove()
    res = {"card": card,
           "model": f"Llama-2-7B, {layers} layers, bf16, random weights",
           "conversations": SESSION_CONVS, "turns": SESSION_TURNS,
           "system_prompt": SESSION_SYSTEM, "new_tokens": SESSION_NEW,
           "arena_pages": SESSION_PAGES, "warmup": warm,
           "tier_probe": probe.numbers(), "engines": {},
           "decode_vs_chunk_kv_wave_a_turn_1": kv_checks}
    for name, eng in all_engines.items():
        m = eng.metrics
        by_turn = {}
        for c, t, h in handles[name]:
            by_turn.setdefault(t, []).append(h.first_token_time
                                             - h.submit_time)
        late = by_turn.get(1, []) + by_turn.get(2, [])
        fwd = m.decode_step_time.count + m.prefill_time.count
        want = {k: 0 for k in counts[name]}
        want.update(rms_norm=(2 * layers + 1) * fwd, rope=layers * fwd,
                    paged_attention=layers * m.decode_step_time.count)
        if counts[name] != want:
            fail(f"session serving ({name}): launches {counts[name]}, "
                 f"expected {want}")
        if eng.compile_counts() != captures[name]:
            fail(f"session serving ({name}): captures during traffic: "
                 f"{captures[name]} -> {eng.compile_counts()}")
        differ = {}
        if name != "cold":
            for (c, t, h), (c2, t2, h2) in zip(handles[name],
                                                handles["cold"]):
                n = int((np.asarray(h.output_ids)
                         != np.asarray(h2.output_ids)).sum())
                d = differ.setdefault(f"turn {t + 1}", {
                    "tokens": 0, "streams": 0})
                d["tokens"] += n
                d["streams"] += n > 0
        r = {"ttft_turns_2_3_p50_s": _pctl(np, late, 50),
             "ttft_turns_2_3_p90_s": _pctl(np, late, 90),
             "ttft_turn_1_p50_s": _pctl(np, by_turn[0], 50),
             "itl_p50_s": m.itl.percentile(50),
             "prefill_p50_s": m.prefill_time.percentile(50),
             "warm_prefill_p50_s": m.warm_prefill_time.percentile(50),
             "decode_s": m.decode_step_time.sum,
             "peak_pages_in_use": eng.page_pool.peak_in_use,
             "tokens_differing_from_cold": differ}
        if name != "cold":
            ties, gap = teacher_forced(torch, dev,
                                       [h for _, _, h in handles[name]],
                                       lambda ids: net(ids)[0],
                                       f"session serving ({name})")
            st = eng.sessions.stats()
            if st["created"] != SESSION_CONVS or st["turns"] != len(
                    handles[name]):
                fail(f"session serving ({name}): session store {st}")
            r.update(prefix=eng.prefix_cache.stats(), sessions=st,
                     near_ties=ties, near_tie_max_gap=gap)
        res["engines"][name] = r
    tier = res["engines"]["tier"]["prefix"]["tier"]
    if not (sum(tier["spills"].values()) and sum(tier["restores"].values())) \
            or tier["crc_refused"] or tier["stale_refused"]:
        fail(f"session serving: the tier spilled and restored nothing, or "
             f"refused a payload: {tier}")
    if not probe.checked or probe.mismatched:
        fail(f"session serving: restored pages read back: {probe.numbers()}")
    res["phase_s"] = time.perf_counter() - t_phase
    log("session serving: " + json.dumps(res))
    for eng in engines.values():
        eng.close()
        st = eng.page_pool.stats()
        if st["pages_in_use"] or st["claims"] != st["releases"]:
            fail(f"session serving: not drained after close: {st}")
    del engines, all_engines
    gc.collect()
    torch.cuda.empty_cache()
    return counts["tier"]


# ------------------------------------------------------- spec serving
# the speculative phase (seed 5150): prompts of 512 tokens, 128 new tokens
# each; at concurrency 1, 4 requests one after another, then 8 at once;
# k 4 (each round proposes up to 4 tokens and verifies 5 positions)
SPEC_PROMPT, SPEC_NEW, SPEC_K, SPEC_CONC1 = 512, 128, 4, 4
# the two legs: (name, exit layer, zero o_proj and down_proj from the exit
# layer on). Zeroed, layers 4-31 add exact zeros to the residual stream,
# so the early exit at 4 computes what the target computes: a perfect
# draft (JAX tools/spec_smoke.py leg 1). Unzeroed at 8: random weights,
# acceptance is low and rollbacks run.
SPEC_LEGS = (("random", 8, False), ("perfect", 4, True))


def drive_spec(torch, np, eng, prompts, conc1, label, rec=None):
    """``prompts`` through ``eng``: one after another (``conc1``) or all at
    once, ``SPEC_NEW`` tokens each; launch counts zeroed just before and
    read just after. Fails unless every request finishes, nothing is
    captured and no page stays in use. Returns the handles, the counts
    and the numbers it prints (a speculative run also the round's host
    time, p50, and its verify replays)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    eng.metrics = ServingMetrics()
    spec = eng.speculative
    if spec is not None:
        spec.reset_stats()
        claimed0 = eng.spec_pages_claimed
        rolled0 = eng.spec_pages_rolled_back
    captures = traffic_captures(eng)
    replays0 = eng.compile_counts().get("serving::spec_verify", 0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if conc1:
        hs = []
        for p in prompts:
            hs.append(eng.submit(p, SPEC_NEW))
            if rec is not None:
                rec.add(hs[-1:])
            eng.run_until_idle()
    else:
        hs = [eng.submit(p, SPEC_NEW) for p in prompts]
        eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for h in hs:
        if h.status != "DONE" or len(h.tokens) != SPEC_NEW:
            fail(f"{label}: status {h.status} ({h.reason}), "
                 f"{len(h.tokens)} tokens")
    if traffic_captures(eng) != captures:
        fail(f"{label}: captures during traffic: {captures} -> "
             f"{traffic_captures(eng)}")
    if eng.page_pool.pages_in_use:
        fail(f"{label}: {eng.page_pool.pages_in_use} pages in use after "
             f"the traffic")
    m = eng.metrics
    per_req = [(len(h.tokens) - 1) / (h.finish_time - h.first_token_time)
               for h in hs]
    result = {
        "requests": len(hs), "concurrency": 1 if conc1 else len(hs),
        "wall_s": wall, "itl_p50_s": m.itl.percentile(50),
        "decode_s": m.decode_step_time.sum,
        "decode_tokens": m.decode_tokens.value,
        "decode_tok_per_s": m.decode_tokens.value / m.decode_step_time.sum,
        "tok_per_s_per_request": statistics.mean(per_req),
        "ttft_p50_s": m.ttft.percentile(50),
        "prefills": m.prefill_time.count}
    if spec is not None:
        result["spec"] = spec.stats()
        result["round_p50_s"] = m.decode_step_time.percentile(50)
        result["verify_replays"] = (eng.compile_counts()[
            "serving::spec_verify"] - replays0)
        result["spec_pages_claimed"] = eng.spec_pages_claimed - claimed0
        result["spec_pages_rolled_back"] = (eng.spec_pages_rolled_back
                                            - rolled0)
    log(f"{label}: " + json.dumps(result))
    return hs, counts, result


def _spec_counts(layers, exit_layer, result, counts):
    """The launches the structure gives a speculative bf16 run: a prefill
    is one forward (RMSNorm 2L + 1, rope L), a verify one decode replay a
    round (k + 1 positions on 8 rows: the decode step's RMSNorm, rope and
    paged attention), a draft prefill or step one forward of the exit
    layers over the draft's slab (no paged attention)."""
    st, e = result["spec"], exit_layer
    draft = st["draft_ingests"] + st["draft_steps"]
    if result["verify_replays"] != st["rounds"]:
        fail(f"spec serving: {result['verify_replays']} verify replays for "
             f"{st['rounds']} rounds")
    fwd = result["prefills"] + st["rounds"]
    want = {k: 0 for k in counts}
    want.update(
        rms_norm=fwd * (2 * layers + 1) + draft * (2 * e + 1),
        rope=fwd * layers + draft * e,
        paged_attention=st["rounds"] * layers)
    return want


def spec_phase(torch, np, dev, card, net, vanilla, profile=0):
    """Speculative decoding at Llama-2-7B: a paged engine with demand
    paging and ``SpeculativeDecoder(exit_layer=e, k=4)`` (graphs, after
    ``warmup()``: the base 17 programs, a draft prefill per bucket and a
    draft decode per row; the verify replays the decode program) beside
    ``vanilla``, the serving phase's graph engine, on the same requests,
    for each leg of ``SPEC_LEGS``. Fails unless every run finishes with
    nothing captured and the arena drained, the speculative runs launch
    the counts the structure gives, every speculative stream equals the
    vanilla one token for token and every verify row scored with a
    stream's tokens equals the vanilla row bit for bit (C item 3), and
    every speculative token passes the teacher-forced check. Prints
    acceptance, ITL, the round's time, tokens/s per request,
    ``decode_s``, the programs' replay times (the verify is one decode
    replay), warmup, pages claimed and rolled back; with ``profile``,
    that many replays of the decode program and of the draft decode by
    kernel group. Returns the speculative runs' launch counts, summed."""
    import gc

    from paddle_tpu_torch.serving import PagedServingEngine, SpeculativeDecoder

    cfg = net.config
    layers = cfg.num_hidden_layers
    t_phase = time.perf_counter()
    rng = np.random.RandomState(5150)
    prompts = [rng.randint(0, cfg.vocab_size, (SPEC_PROMPT,))
               for _ in range(SPEC_CONC1 + ENGINE_KW["max_batch_size"])]
    total = {}
    out = {"card": card, "k": SPEC_K, "prompt": SPEC_PROMPT,
           "new_tokens": SPEC_NEW}
    for leg, exit_layer, perfect in SPEC_LEGS:
        if perfect:
            with torch.no_grad():
                for layer in net.model.layers[exit_layer:]:
                    layer.self_attn.o_proj.weight.zero_()
                    layer.mlp.down_proj.weight.zero_()
        spec = SpeculativeDecoder(exit_layer=exit_layer, k=SPEC_K)
        eng = PagedServingEngine(net, cache_dtype="bfloat16",
                                 demand_paging=True, speculative=spec,
                                 **ENGINE_KW)
        nb = len(eng._warmup_buckets())
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        programs = eng.warmup()["programs"]
        torch.cuda.synchronize()
        warm = {"warmup_s": time.perf_counter() - t0, "programs": programs,
                "captures": eng.compile_counts(),
                "reserved_bytes": torch.cuda.memory_reserved() - reserved0}
        want_programs = 1 + 2 * nb + nb + ENGINE_KW["max_batch_size"]
        if programs != want_programs or eng.warmup()["programs"]:
            fail(f"spec serving ({leg}): warmup() captured {programs} "
                 f"programs, expected {want_programs} once")
        warm["memory_report"] = report_memory(eng, f"spec serving ({leg})")
        res = {"exit_layer": exit_layer, "warmup": warm}
        for conc1 in (True, False):
            group = prompts[:SPEC_CONC1] if conc1 else prompts[SPEC_CONC1:]
            tag = "concurrency 1" if conc1 else "8 at once"
            rv = rs = None
            if conc1:
                rv, rs = RowRecorder(vanilla, []), RowRecorder(eng, [])
            van, _, van_res = drive_spec(torch, np, vanilla, group, conc1,
                                         f"spec serving ({leg}, vanilla, "
                                         f"{tag})", rv)
            hs, counts, spec_res = drive_spec(torch, np, eng, group, conc1,
                                              f"spec serving ({leg}, {tag})",
                                              rs)
            want = _spec_counts(layers, exit_layer, spec_res, counts)
            if counts != want:
                fail(f"spec serving ({leg}, {tag}): launches {counts}, "
                     f"expected {want}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            ties, gap = teacher_forced(torch, dev, hs,
                                       lambda ids: net(ids)[0],
                                       f"spec serving ({leg}, {tag})")
            differ = _tokens_differing(np, hs, van)
            res[tag] = {"vanilla": van_res, "speculative": spec_res,
                        "tokens_differing_from_vanilla": differ,
                        "tokens": sum(len(h.tokens) for h in hs),
                        "near_ties": ties, "near_tie_max_gap": gap}
            if differ:
                fail(f"spec serving ({leg}, {tag}): {differ} tokens differ "
                     f"from the vanilla streams")
            if conc1:
                rv.remove()
                rs.remove()
                rows = compare_rows(np, rs, rv, hs, van)
                res[tag]["verify_rows_vs_vanilla"] = rows
                if not (rows["rows"]
                        and rows["rows_bit_equal"] == rows["rows"]):
                    fail(f"spec serving ({leg}, {tag}): verify rows against "
                         f"vanilla rows: {rows}")
        st = eng.page_pool.stats()
        if st["pages_in_use"] or st["claims"] != st["releases"]:
            fail(f"spec serving ({leg}): not drained: {st}")
        # one replay of each program of a round, CUDA events: the verify
        # is one replay of the decode program (its inputs are the last
        # round's, whose pages are free again: the replays write only
        # free pages and the garbage page)
        res["replay_ms"] = {"verify_decode": replay_ms(
            torch, eng._programs.get(("decode",)).graph),
            "spec_ddecode_0": replay_ms(
                torch, eng._programs.get(("spec_ddecode", 0)).graph)}
        if profile:
            res["profile"] = {
                name: profile_steps(torch, eng._programs.get(k).graph.replay,
                                    profile)
                for name, k in (("verify_decode", ("decode",)),
                                ("spec_ddecode_0", ("spec_ddecode", 0)))}
        res["pages"] = {"claimed": eng.spec_pages_claimed,
                        "rolled_back": eng.spec_pages_rolled_back}
        out[leg] = res
        log(f"spec serving ({leg}): " + json.dumps(res))
        eng.close()
        del eng, spec
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("spec serving: " + json.dumps(out))
    return total


# ------------------------------------------------------- beam search
BEAM_B, BEAM_K, BEAM_PROMPT, BEAM_NEW = 2, 4, 128, 64
# generate's modes at 7B, each as the program and with graphs=False
GENERATE_MODES = {
    "greedy": dict(),
    "sampled": dict(do_sample=True, temperature=0.8, top_p=0.9, seed=7),
    "beam": dict(num_beams=BEAM_K),
}


def graph_nodes(body, inputs, pool, stream):
    """The node count of ``body`` over ``inputs`` captured once more into
    a kept graph (``keep_graph=True``; ``cuGraphGetNodes`` of
    ``libcuda``), or None where this PyTorch or libcuda cannot say.
    The capture is dropped after."""
    import ctypes

    import torch

    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        body(*inputs)
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        n = ctypes.c_size_t(0)
        rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                 None, ctypes.byref(n))
        return int(n.value) if rc == 0 else None
    except (OSError, AttributeError, RuntimeError):
        return None
    finally:
        del graph


def beam_phase(torch, np, dev, card, net):
    """``generate`` at Llama-2-7B, B 2, prompt 128, 64 new tokens, bf16
    cache: greedy, sampled (temperature 0.8, top_p 0.9, seed 7) and beam
    search (4 beams), each with ``graphs=False`` (the eager loop) and as
    its program (the whole prefill and decode, one CUDA graph per
    signature: the first call captures, the second replays), timed (host
    clock to a sync); then the beam search again (the eager loop) with
    the winning beam's first token as EOS. Fails unless every program's
    tokens equal the eager loop's, a repeated signature captures nothing,
    the outputs are in the vocabulary, the beam's kernels launched, and
    after its first EOS a row emits only EOS. Prints ms a step for both, the
    capturing call's seconds (``capture_call_s``), the growth of reserved
    memory over that call from an emptied cache (``graph_pool_bytes``)
    and the node count of the greedy and beam graphs. Returns the launch counts of the phase."""
    import gc

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models.generation import generate_programs

    ids = torch.as_tensor(np.random.RandomState(777).randint(
        0, net.config.vocab_size, (BEAM_B, BEAM_PROMPT)), device=dev)
    cache = generate_programs(net)
    t_phase = time.perf_counter()

    def timed(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net.generate(ids, max_new_tokens=BEAM_NEW, **kw)
        torch.cuda.synchronize()
        return out.cpu().numpy(), time.perf_counter() - t0

    kernels.reset_launch_counts()
    res = {"card": card, "batch": BEAM_B, "num_beams": BEAM_K,
           "prompt": BEAM_PROMPT, "new_tokens": BEAM_NEW}
    outs = {}
    for mode, kw in GENERATE_MODES.items():
        eager, eager_s = timed(graphs=False, **kw)
        n0, before = cache.captures, set(cache)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        first, first_s = timed(**kw)
        pool_bytes = torch.cuda.memory_reserved() - reserved
        n1 = cache.captures
        again, again_s = timed(**kw)
        if cache.captures != n1 or n1 != n0 + 1:
            fail(f"beam ({mode}): captures {n0} -> {n1} -> "
                 f"{cache.captures}; one capture a signature expected")
        for got, when in ((first, "capturing"), (again, "replayed")):
            if not np.array_equal(got, eager):
                fail(f"beam ({mode}): the {when} program's tokens differ "
                     f"from the eager loop's in "
                     f"{int((got != eager).sum())} places")
        if eager.shape != (BEAM_B, BEAM_PROMPT + BEAM_NEW) \
                or eager.min() < 0 or eager.max() >= net.config.vocab_size:
            fail(f"beam ({mode}): output of shape {eager.shape}, ids "
                 f"{eager.min()}..{eager.max()}")
        prog = cache[next(k for k in cache if k not in before)]
        res[mode] = {"eager_ms_per_step": 1e3 * eager_s / BEAM_NEW,
                     "program_ms_per_step": 1e3 * again_s / BEAM_NEW,
                     "capture_call_s": first_s,
                     "graph_pool_bytes": pool_bytes,
                     "eager_s": eager_s, "program_s": again_s}
        if mode in ("greedy", "beam") and prog.program.cuda:
            p = prog.program
            res[mode]["graph_nodes"] = graph_nodes(p.body, p.inputs, p.pool,
                                                   p.stream)
        outs[mode] = eager
    counts = kernels.launch_counts()
    if not (counts["rms_norm"] and counts["rope"]):
        fail(f"beam: launches {counts}")
    beam = outs["beam"]
    eos = int(beam[0, BEAM_PROMPT])
    frozen, _ = timed(num_beams=BEAM_K, eos_token_id=eos, graphs=False)
    for row in frozen[:, BEAM_PROMPT:]:
        hit = np.flatnonzero(row == eos)
        if len(hit) and (row[hit[0]:] != eos).any():
            fail(f"beam: a row emitted past its EOS: {row.tolist()}")
    res.update({
        "signatures": [list(s) for s in cache],
        "captures": cache.captures,
        "tokens_differing_from_greedy": int(
            (beam[:, BEAM_PROMPT:] != outs["greedy"][:, BEAM_PROMPT:]).sum()),
        "eos": eos, "eos_row_0": frozen[0, BEAM_PROMPT:].tolist(),
        "launches": {k: v for k, v in counts.items() if v},
        "phase_s": time.perf_counter() - t_phase})
    log("beam: " + json.dumps(res))
    # the programs' graph pool goes back before the spec phase
    cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------ full-depth live reload
RELOAD_DIR = os.path.join(HERE, "build", "chip_smoke_reload")


def full_reload_phase(torch, np, dev, card, eng):
    """Live reload at full depth: the serving phase's graph engine
    (Llama-2-7B bf16, 8 rows x 2048 slots, warmed) reloads a bf16
    checkpoint (13.5 GB) of a second net from seed 1, which a fresh engine
    served first (the reference streams), then was saved and committed by
    a ``CheckpointManager`` and freed. Gates: the 12 serving requests'
    post-swap streams equal the fresh engine's token for token, and no
    program was captured again (nor during traffic) and the parameters'
    addresses stayed. Prints the save, the prepare split into verify (the
    CRCs), read and host-to-device copy, the swap's copy (the pause of an
    idle engine), ``torch.cuda.mem_get_info()`` and the peak allocated
    during staging. Returns the post-swap run's launch counts."""
    import gc
    import shutil

    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import PagedServingEngine

    t_phase = time.perf_counter()
    cfg = eng.config
    shutil.rmtree(RELOAD_DIR, ignore_errors=True)
    net1 = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=1)
    fresh = PagedServingEngine(net1, cache_dtype="bfloat16", **ENGINE_KW)
    ref = drive_requests(torch, np, fresh, cfg, "graphs",
                         "full reload (fresh engine, seed 1)")
    fresh.close()
    mgr = CheckpointManager(RELOAD_DIR, network=net1, async_saves=False)
    t0 = time.perf_counter()
    mgr.save(1)
    save_s = time.perf_counter() - t0
    mgr.close()
    del fresh, net1, mgr
    gc.collect()
    torch.cuda.empty_cache()
    captures = eng.compile_counts()
    ptrs = _weight_ptrs(eng.net)
    torch.cuda.synchronize()
    info = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    staged = eng.prepare_reload(RELOAD_DIR)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not staged.ok:
        fail(f"full reload: prepare_reload: {staged.to_json()}")
    seen = _timed_apply(eng)
    eng.commit_reload(staged)
    if not staged.applied:
        fail(f"full reload: an idle engine did not apply: "
             f"{staged.to_json()}")
    reloads = eng.metrics.reloads.by_label()
    timings = dict(staged.timings)
    del staged
    gc.collect()
    run = drive_requests(torch, np, eng, cfg, "graphs",
                         "full reload (reloaded engine)")
    differ = sum(a != b for h, r in zip(run["handles"], ref["handles"])
                 for a, b in zip(h.tokens, r.tokens))
    if differ:
        fail(f"full reload: {differ} tokens differ from the fresh engine's")
    if run["captures"] != captures or run["captures_before"] != captures \
            or _weight_ptrs(eng.net) != ptrs:
        fail(f"full reload: captures {captures} -> "
             f"{run['captures_before']} -> {run['captures']}, or the "
             f"parameters moved")
    shutil.rmtree(RELOAD_DIR, ignore_errors=True)
    res = {"card": card, "save_s": save_s, "prepare_s": prepare_s,
           "timings": timings,
           "read_gb_per_s": timings["bytes"] / timings["read_s"] / 1e9,
           "reloads": reloads, "apply_s": seen.get("apply_s"),
           "mem_get_info_before_prepare": list(info),
           "peak_allocated_above_start_bytes": peak - alloc0,
           "weights_version": eng.weights_version,
           "phase_s": time.perf_counter() - t_phase}
    log("full reload: " + json.dumps(res))
    return run["counts"]


PTQ_PROMPTS, PTQ_PROMPT_LEN = 2, 64


def ptq_build(torch, np, dev, net, card):
    """The quantized model as a PTQ user builds it, in place on the bf16
    7B: ``PTQ(QuantConfig)`` with an ``AbsmaxObserver`` on each Linear's
    input and a ``PerChannelAbsmaxObserver`` on its weight (a type
    config: a global one would wrap the model's top-level children, as
    in JAX), two calibration prompts, ``convert``; then, one layer at a
    time, each ObservedLayer's int8 weight and scales as
    ``quantize_for_serving`` makes them (``_from_observed``: the frozen
    per-channel scales) must equal a direct quantization of the same
    weight bit for bit. The caller then runs ``quantize_for_serving``."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.kernels.int8_matmul import quantize_weight
    from paddle_tpu_torch.quantization import (PTQ, AbsmaxObserver,
                                               PerChannelAbsmaxObserver,
                                               QuantConfig)
    from paddle_tpu_torch.quantization.qat import ObservedLayer
    from paddle_tpu_torch.quantization.serving import _from_observed

    t0 = time.perf_counter()
    qcfg = QuantConfig()
    qcfg.add_type_config(pnn.Linear, activation=AbsmaxObserver(),
                         weight=PerChannelAbsmaxObserver())
    ptq = PTQ(qcfg)
    ptq.quantize(net, inplace=True)
    rng = np.random.RandomState(31)
    # no_grad, not inference_mode: the model's rope tables cached here
    # are used by the engines and checks after
    with torch.no_grad():
        for _ in range(PTQ_PROMPTS):
            ids = torch.as_tensor(rng.randint(
                0, net.config.vocab_size, (1, PTQ_PROMPT_LEN)), device=dev)
            net(ids)
    ptq.convert(net, inplace=True)
    observed = [(k, m) for k, m in net.named_modules()
                if isinstance(m, ObservedLayer)]
    for k, m in observed:
        with torch.no_grad():
            got = _from_observed(m)
            wq, ws = quantize_weight(m._inner.weight.detach())
        if not (torch.equal(got.weight_q, wq)
                and torch.equal(got.weight_scale, ws)):
            fail(f"ptq: {k}'s int8 weight or scales differ from a direct "
                 f"quantize_for_serving of the same weight")
        del got, wq, ws
    acts = [float(m.act_scale) for _, m in observed]
    res = {"card": card, "observed_layers": len(observed),
           "calibration": f"{PTQ_PROMPTS} prompts of {PTQ_PROMPT_LEN} "
                          f"tokens",
           "act_scale_min": min(acts), "act_scale_max": max(acts),
           "int8_equal_to_direct": True,
           "seconds": time.perf_counter() - t0}
    log("ptq: " + json.dumps(res))
    if len(observed) != QUANT_MM_PER_FORWARD:
        fail(f"ptq: {len(observed)} ObservedLayers, expected "
             f"{QUANT_MM_PER_FORWARD}")
    return res


def quant_serving_phase(torch, np, dev, card, profile_steps=0):
    """Llama-2-7B at full width and depth, quantized: the serving phase's
    random bf16 weights (seed 0) through PTQ (``ptq_build``) and
    quantize_for_serving in place,
    two engines (graphs, eager) each with an int8 KV arena of 1025 pages
    x 16 slots, the same 12 requests through each."""
    import gc

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.generation import alloc_kv_caches
    from paddle_tpu_torch.quantization import quantize_for_serving
    from paddle_tpu_torch.serving import PagedServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = LlamaConfig.llama2_7b()
    layers = cfg.num_hidden_layers
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    ptq = ptq_build(torch, np, dev, net, card)
    quantize_for_serving(net, inplace=True)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    weight_bytes = sum(b.numel() * b.element_size() for b in net.buffers())
    log(f"quantized serving: Llama-2-7B, {layers} layers, int8 weights "
        f"({weight_bytes / 1e9:.2f} GB with scales) + bf16 embeddings and "
        f"norms, built and quantized in {time.perf_counter() - t_phase:.1f}"
        f" s")
    eng = PagedServingEngine(net, cache_dtype="int8", **ENGINE_KW)
    eager = PagedServingEngine(net, cache_dtype="int8", graphs=False,
                               **ENGINE_KW)
    log(f"quantized serving: two engines (graphs, eager), each an int8 "
        f"page arena of {eng.page_pool.num_pages + 1} pages x 16 slots, "
        f"{eng.page_pool.arena_bytes() / 1e9:.2f} GB")
    warm = warm_engine(torch, eng, "quantized serving")

    def want_counts(run):
        fwd = run["decode_steps"] + run["prefills"]
        want = {k: 0 for k in run["counts"]}
        want.update(rms_norm=(2 * layers + 1) * fwd, rope=layers * fwd,
                    paged_attention_int8=layers * run["decode_steps"],
                    int8_matmul=QUANT_MM_PER_FORWARD * fwd)
        # bf16 activations: every W8A16 launch on the tensor-core design
        designs = run["designs"]["int8_matmul"]
        if designs != {"tc_launches": want["int8_matmul"],
                       "cc_launches": 0}:
            fail(f"quantized serving ({run['mode']}): W8A16 launches by "
                 f"design {designs}, expected all {want['int8_matmul']} "
                 f"on the tensor cores")
        return want

    runs, summary = serve_modes(
        torch, np, cfg, {"graphs": eng, "eager": eager}, ("eager", "graphs"),
        "quantized serving", want_counts)
    graph_run = runs[1]

    # teacher-forced check against one slab prefill of the whole sequence
    # with an int8 cache: the same quantization on write, dequantized on
    # read, composed attention
    def slab_prefill(ids):
        caches = alloc_kv_caches(cfg, 1, int(ids.shape[1]), "int8",
                                 device=dev)
        return net(ids, caches=caches, pos=0)[0][0]

    ties, worst_gap = teacher_forced(torch, dev, graph_run["handles"],
                                     slab_prefill, "quantized serving")
    published = quant_decode_published(torch, np, net)
    res = {"card": card,
           "model": f"Llama-2-7B, {layers} layers, int8 weights (W8A16) "
                    f"and int8 KV cache, random weights",
           "weight_bytes": weight_bytes, "ptq": ptq,
           "arena_bytes": eng.page_pool.arena_bytes(),
           "decode_steps": graph_run["decode_steps"],
           "prefills": graph_run["prefills"],
           "int8_matmul_launches_by_design":
               graph_run["designs"]["int8_matmul"],
           "launches_per_decode_step": {
               "paged_attention_int8": layers,
               "int8_matmul": QUANT_MM_PER_FORWARD},
           "warmup": warm, "modes": summary,
           "near_ties": ties, "near_tie_max_gap": worst_gap,
           "decode_published": published,
           "phase_s": time.perf_counter() - t_phase}
    log("quantized serving: " + json.dumps(res))
    if profile_steps:
        profile_decode(torch, np, eng, cfg, profile_steps, "decode_int8")
        profile_decode(torch, np, eager, cfg, profile_steps,
                       "decode_int8_eager")
        profile_prefill(torch, np, eng, cfg, "prefill_1024_int8")
    # the fleet's int8 transfer leg, beside this phase's graph engine
    eager.close()
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    int8_fleet_counts = fleet_int8_leg(torch, np, card, net, eng, cfg,
                                       graph_run)
    return graph_run["counts"], runs[0]["counts"], int8_fleet_counts


def quant_decode_published(torch, np, net):
    """Decode-written KV against one prefill on the quantized 7B (int8
    weights and arena): the prefix traffic's first prompt with 64 new
    tokens through an eager prefix engine of 8 rows (the decode step's
    row count) and a 256-page arena; measured, not gated."""
    from paddle_tpu_torch.serving import PagedServingEngine

    kw = dict(ENGINE_KW, num_pages=256)
    eng = PagedServingEngine(net, cache_dtype="int8", prefix_cache=True,
                             graphs=False, **kw)
    prompt = prefix_traffic(np, net.config)[0][0]
    h = eng.submit(prompt, SERVE_MAX_NEW)
    eng.run_until_idle()
    out = published_vs_prefill(
        torch, eng, [int(t) for t in h.output_ids],
        h.request.prompt_len + SERVE_MAX_NEW - 1)
    eng.close()
    return out


def profile_steps(torch, step_fn, steps):
    """Device time by kernel group over ``steps`` calls of ``step_fn``
    (torch.profiler), and the device's idle share of that window (1 -
    summed kernel time / wall time; the profiler's own overhead makes
    the wall time an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {}
    kernels = []
    for e in prof.key_averages():
        # kernels only: a CPU op's self device time repeats the time of
        # the kernels it launched
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us <= 0:
            continue
        name = e.key
        low = name.lower()
        # flash by kernel name: flash_fwd_tc_kernel<D> (bf16),
        # flash_fwd_split_kernel<D> (fp32; also the fp32 rope-on-load
        # forward's) and flash_fwd_kernel<T, D, false> (CUDA cores) are
        # the forward, split3_kernel the split design's pre-pass (flash
        # forward and backward, the rope-on-load forward's v, the fp32
        # fused head's weight: "split_parts"),
        # rope_attention_fwd_tc_kernel<D> (bf16), rope_split3_kernel
        # (fp32's rotate-and-split pre-pass) and flash_fwd_kernel<T, D,
        # true> the rope-on-load forward,
        # norm_rstd_kernel, norm_split3t_kernel and norm_matmul_* the fused
        # head,
        # flash_bwd_* (both designs) the backward passes
        # paged attention: its scores and values kernels, the int8
        # flavour's instantiated over signed char;
        # the optimizer layer's kernels (csrc/multi_tensor.cu: the update,
        # its sums of squares and Lamb's): "multi_tensor"; AMP O3's
        # fp8_gemm_kernel and fp8_quantize_kernel their own; the rest of the
        # elementwise work (casts, adds, SwiGLU, the loss): "other"
        paged = "paged_scores_kernel" in low or "paged_values_kernel" in low
        group = ("paged_attention_int8" if paged and "signed char" in low
                 else "int8_matmul" if "int8_matmul" in low
                 else "rms_norm_matmul" if ("norm_matmul" in low
                                            or "norm_rstd" in low
                                            or "norm_split3t" in low)
                 else "rope_attention" if ("rope_attention_fwd_tc" in low
                                           or "rope_split3" in low)
                 else "flash_attention_fwd" if ("flash_fwd_tc_kernel" in low
                                                or "flash_fwd_split" in low)
                 else "split_parts" if "split3_kernel" in low
                 else "rope_attention" if "flash_fwd_kernel<" in low
                 and ", true>" in low
                 else "flash_attention_fwd" if "flash_fwd_kernel<" in low
                 and ", false>" in low
                 else "paged_attention" if paged
                 else "flash_attention_bwd" if "flash_bwd_" in low
                 else "rms_norm" if "rms_norm_fwd_kernel" in low
                 else "rms_norm_bwd" if ("rms_norm_bwd_kernel" in low
                                         or "rms_norm_dw_kernel" in low)
                 else "rope" if "rope_kernel" in low
                 else "multi_tensor" if any(s in low for s in MT_KERNEL_NAMES)
                 else "fp8_gemm" if "fp8_gemm_kernel" in low
                 else "fp8_quantize" if "fp8_quantize_kernel" in low
                 else "gemm" if any(s in low for s in (
                     "gemm", "nvjet", "xmma", "cutlass", "gemv", "splitk"))
                 else "other")
        groups[group] = groups.get(group, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, e.count, name[:90]))
    busy = sum(groups.values())
    kernels.sort(reverse=True)
    return {
        "steps": steps, "wall_ms": wall_ms,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
        "ms_per_step_by_group": {k: v / steps for k, v in
                                 sorted(groups.items())},
        "top_kernels": [{"ms": ms, "count": c, "name": n}
                        for ms, c, n in kernels[:12]],
    }


def replay_ms(torch, graph, n=20, repeats=5):
    """Device time of one replay of a captured program: CUDA events
    around ``n`` back-to-back replays, the median of ``repeats``."""
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def profile_decode(torch, np, eng, cfg, steps, kind):
    """The decode-step profile with all 8 rows busy: ``steps`` engine
    steps under torch.profiler (whether it names the kernels a CUDA graph
    replays: ``kernels_by_name``), then ``steps`` more on the host clock
    alone; for a graph engine also its decode program's replay timed by
    CUDA events (the device time of a step without the host's), and the
    idle share that leaves of the host-clock step. The replays repeat
    the last step's inputs, which rewrites the same cache slots with the
    same values."""
    rng = np.random.RandomState(99)
    hs = [eng.submit(rng.randint(0, cfg.vocab_size, (int(n),)), 64)
          for n in rng.randint(32, 1025, size=8)]
    while any(h.status == "QUEUED" for h in hs):
        eng.step()
    prof = profile_steps(torch, eng.step, steps)
    groups = prof["ms_per_step_by_group"]
    prof["kernels_by_name"] = any(g.startswith("paged_attention")
                                  for g in groups)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    prof["step_ms_host_clock"] = (time.perf_counter() - t0) * 1e3 / steps
    prog = eng._programs.get(("decode",)) if eng.graphs else None
    if prog is not None:
        prof["replay_ms"] = replay_ms(torch, prog.graph)
        prof["replay_idle_share"] = (1.0 - prof["replay_ms"]
                                     / prof["step_ms_host_clock"])
    log("profile: " + json.dumps(dict(prof, rows=8, kind=kind,
                                      graphs=eng.graphs)))
    eng.run_until_idle()
    if eng.page_pool.pages_in_use:
        fail("pages leaked after the profiled steps")


PREFILL_PROFILE_LEN, PREFILL_PROFILES = 1000, 3


def profile_prefill(torch, np, eng, cfg, kind):
    """The prefill profile: PREFILL_PROFILES engine steps on an idle
    engine, each admitting one request of PREFILL_PROFILE_LEN prompt
    tokens (the 1024 bucket) and one new token, so the step is the
    prefill and nothing else."""
    rng = np.random.RandomState(98)
    prompt = rng.randint(0, cfg.vocab_size, (PREFILL_PROFILE_LEN,))

    def one_prefill():
        h = eng.submit(prompt, 1)
        eng.step()
        if h.status != "DONE":
            fail(f"{kind}: the profiled step did not finish its request")

    prof = profile_steps(torch, one_prefill, PREFILL_PROFILES)
    log("profile: " + json.dumps(dict(prof, prompt_len=PREFILL_PROFILE_LEN,
                                      kind=kind)))
    if eng.page_pool.pages_in_use:
        fail("pages leaked after the profiled prefills")


# ------------------------------------------------------------------ fleet
# the launched fleet's knobs: Llama-2-7B widths at 4 layers
# (``LlamaConfig.tiny`` caps positions at 128), the launch's defaults else
FLEET_CLI = ["--hidden", "4096", "--heads", "32", "--vocab", "32000",
             "--layers", "4", "--max-seq", "128", "--min-bucket", "16",
             "--page-size", "16"]
# the same-prefix leg through the router: requests over one shared prefix
FLEET_PREFIX_REQUESTS, FLEET_PREFIX_LEN, FLEET_PREFIX_NEW = 6, 512, 8
# the launched fleet's traffic: prompts (seed 31) and new tokens
FLEET_LAUNCH_PROMPTS, FLEET_LAUNCH_NEW = 6, 16


def _row_pages(eng, handle):
    """The page ids of the arena row ``handle`` runs in."""
    for i, seq in enumerate(eng._seqs):
        if seq is not None and seq.handle is handle:
            return list(eng._row_pages[i])
    fail(f"no row holds request {handle.request.request_id}")


def adopted_pages_equal(torch, local, remote, prompt, label):
    """Admit ``prompt`` (2 new tokens) into ``local`` and into ``remote``
    (prefill and adopt, no decode step), and compare the two rows' pages
    across every arena buffer (codes and scales of an int8 arena alike);
    then drain both. Fails unless bit-equal. Returns the bytes compared."""
    handles = []
    for eng in (local, remote):
        h = eng.submit(prompt, 2)
        popped = eng.scheduler.pop_next(eng._admission_budget(),
                                        fits=eng._admission_fits())
        if popped is not h:
            fail(f"{label}: the admission popped another request")
        eng._admit_one(h)
        handles.append(h)
    pl, pr = (_row_pages(e, h) for e, h in zip((local, remote), handles))
    nbytes = 0
    with torch.inference_mode():
        for a, b in zip(local._page_leaves(local._caches),
                        remote._page_leaves(remote._caches)):
            x, y = a[pl], b[pr]
            if not torch.equal(x, y):
                fail(f"{label}: the adopted pages of a {len(prompt)}-token "
                     f"prompt differ from a local prefill's "
                     f"(max {float((x.float() - y.float()).abs().max())})")
            nbytes += x.numel() * x.element_size()
    for eng in (local, remote):
        eng.run_until_idle()
    return nbytes


def transfer_stats(eng, client, handles):
    """Per remote admission (in admission order): the bucket, the bytes
    on the wire and the seconds of the admission (the transfer, the
    staging copy and the adopt); and the client's totals."""
    order = sorted(handles, key=lambda h: h.admitted_step)
    secs = list(eng.metrics.prefill_time._samples)[-len(order):]
    cfg = eng.config
    rows = []
    for h, s in zip(order, secs):
        b = eng.pool.bucket_for(h.request.prompt_len)
        rows.append({"prompt_len": h.request.prompt_len, "bucket": b,
                     "bytes": b * 2 * cfg.num_hidden_layers * cfg.kv_heads
                     * cfg.head_dim * eng.pool.dtype.itemsize,
                     "seconds": s})
    return {"transfers": client.transfers.by_label(),
            "bytes_total": client.transfer_bytes.value, "per_request": rows}


def fleet_phase(torch, np, dev, card, net, eng, cfg, graph_run, want_counts,
                fe_res):
    """The fleet at Llama-2-7B (the serving phase's net and warmed graph
    engine ``eng``; ``graph_run`` its 12-request run, ``fe_res`` the front
    end's numbers):

    (a) a ``PrefillWorker`` over the net, its programs captured before
        traffic (one request a bucket, ``launch._warmup``), and a graph
        engine with ``prefill_transport=RemotePrefillClient``: the 12
        serving requests all prefill remotely (no fallback, no local
        prefill), their streams equal ``graph_run``'s, the launches follow
        the structure, nothing is captured in traffic; two prompts'
        adopted pages equal a local prefill's bit for bit; then the worker
        stops and the next request falls back exactly once, its stream
        unchanged;
    (c) two prefix-cache engines over the net behind ``ServingFrontend``s
        and a ``FleetRouter``: 12 SSE streams through the router equal
        ``graph_run``'s, both replicas serve some, same-prefix requests
        converge on one replica (its prefix hits), and ``/metrics``
        carries the per-replica series;
    (d) the fleet as the README starts it: ``launch.spawn`` children on
        the card (a prefill worker, two replicas attached to it, a
        router) at FLEET_CLI; streams through the router equal an
        in-process engine over the same seeded weights; a replica killed
        mid-stream ends that stream ``replica_failed`` while unstarted
        requests complete on the survivor, which leaks no page; every
        other child exits 0 on SIGTERM.

    Returns the launch counts of (a) and (c) (the launched children count
    in their own processes)."""
    import gc
    import types

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import (FleetRouter, PagedServingEngine,
                                          PrefillWorker, RemotePrefillClient,
                                          ServingFrontend)
    from paddle_tpu_torch.serving.fleet import launch

    t_phase = time.perf_counter()
    legs, total = {}, {}
    # ---- (a) in-process disaggregation
    t0 = time.perf_counter()
    worker = PrefillWorker(net, weights_version="v0").start()
    client = RemotePrefillClient("127.0.0.1", worker.port, timeout_s=600,
                                 expected_weights_version="v0")
    disagg = PagedServingEngine(net, cache_dtype="bfloat16",
                                prefill_transport=client, **ENGINE_KW)
    warm = warm_engine(torch, disagg, "fleet (remote)")
    t1 = time.perf_counter()
    launch._warmup(disagg, types.SimpleNamespace(
        min_bucket=disagg.pool.min_bucket, max_seq=disagg.max_seq_len))
    worker_warm_s = time.perf_counter() - t1
    caps = worker.compile_counts()
    nb = len(disagg._warmup_buckets())
    if caps != {"serving::prefill": nb}:
        fail(f"fleet: the worker captured {caps}, expected {nb} prefill "
             f"programs before traffic")
    run = drive_requests(torch, np, disagg, cfg, "remote", "fleet")
    _add_counts(total, run["counts"])
    if run["counts"] != want_counts(run):
        fail(f"fleet (remote): launches {run['counts']}, expected "
             f"{want_counts(run)}")
    moved = {k: run["captures"][k] - run["captures_before"][k]
             for k in run["captures"]}
    if any(moved.values()) or worker.compile_counts() != caps:
        fail(f"fleet (remote): captures in traffic: engine {moved}, "
             f"worker {worker.compile_counts()}")
    if (disagg.remote_prefills, disagg.remote_prefill_fallbacks,
            disagg.local_prefills) != (12, 0, 0):
        fail(f"fleet (remote): {disagg.remote_prefills} remote, "
             f"{disagg.remote_prefill_fallbacks} fallbacks, "
             f"{disagg.local_prefills} local prefills; expected 12, 0, 0")
    for h, ref in zip(run["handles"], graph_run["handles"]):
        if h.tokens != ref.tokens:
            fail(f"fleet (remote): request {h.request.request_id}'s stream "
                 f"differs from the serving phase's graph run")
    stats = transfer_stats(disagg, client, run["handles"])
    lens, prompts = serving_prompts(np, cfg)
    order = np.argsort(lens)
    kernels.reset_launch_counts()
    compared = [adopted_pages_equal(torch, eng, disagg, prompts[i],
                                    "fleet (remote)")
                for i in (order[0], order[-1])]
    _add_counts(total, kernels.launch_counts())
    worker.stop()
    fb0 = (disagg.remote_prefill_fallbacks, disagg.local_prefills)
    kernels.reset_launch_counts()
    h = disagg.submit(prompts[0], SERVE_MAX_NEW)
    disagg.run_until_idle()
    _add_counts(total, kernels.launch_counts())
    fb = (disagg.remote_prefill_fallbacks - fb0[0],
          disagg.local_prefills - fb0[1])
    if fb != (1, 1) or client.available() \
            or h.tokens != graph_run["handles"][0].tokens:
        fail(f"fleet (remote): after the worker stopped, {fb} fallbacks and "
             f"local prefills (expected one each), the client "
             f"{'available' if client.available() else 'cooling down'}, "
             f"the stream {'equal' if h.tokens == graph_run['handles'][0].tokens else 'different'}")
    if disagg.page_pool.pages_in_use:
        fail(f"fleet (remote): {disagg.page_pool.pages_in_use} pages leaked")
    remote = {
        "card": card, "warmup": {"engine_s": warm["warmup_s"],
                                 "worker_s": worker_warm_s,
                                 "worker_programs": caps},
        "remote_prefills": 12, "fallback_after_stop": fb[0],
        "ttft_p50_s": run["result"]["ttft_p50_s"],
        "ttft_p50_local_s": graph_run["result"]["ttft_p50_s"],
        "itl_p50_s": run["result"]["itl_p50_s"],
        "itl_p50_local_s": graph_run["result"]["itl_p50_s"],
        "prefill_p50_s": run["result"]["prefill_p50_s"],
        "adopted_pages_bit_equal_bytes": compared, **stats}
    log("fleet (remote): " + json.dumps(remote))
    disagg.close()
    del disagg, worker, client
    gc.collect()
    torch.cuda.empty_cache()
    legs["remote_s"] = time.perf_counter() - t0

    # ---- (c) the router over two prefix-cache replicas
    t0 = time.perf_counter()
    reps = [PagedServingEngine(net, cache_dtype="bfloat16", prefix_cache=True,
                               **ENGINE_KW) for _ in range(2)]
    fes = [ServingFrontend(e, host="127.0.0.1", port=0).start() for e in reps]
    router = FleetRouter([("127.0.0.1", fe.port) for fe in fes],
                         health_interval_s=0.05).start()
    warm_s = time.perf_counter() - t0
    try:
        for e in reps:
            e.metrics = type(e.metrics)()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        streams = _in_threads([
            (lambda p=p: _sse("127.0.0.1", router.port, {
                "input_ids": [int(t) for t in p],
                "max_new_tokens": SERVE_MAX_NEW}))
            for p in prompts])
        counts = kernels.launch_counts()
        streams_s = time.perf_counter() - t1
        _add_counts(total, counts)
        run = {"counts": counts,
               "decode_steps": sum(e.metrics.decode_step_time.count
                                   for e in reps),
               "prefills": sum(e.metrics.prefill_time.count for e in reps)}
        if counts != want_counts(run):
            fail(f"fleet (router): launches {counts}, expected "
                 f"{want_counts(run)}")
        wire_ttft, wire_itl = [], []
        for i, (st, events, body) in enumerate(streams):
            if st != 200 or not events or events[-1][0] != "done":
                fail(f"fleet (router): stream {i} ended {st} {body}")
            toks = [d["token"] for e, d, _ in events if e == "token"]
            if toks != graph_run["handles"][i].tokens:
                fail(f"fleet (router): stream {i} differs from the serving "
                     f"phase's graph run")
            times = [t for e, _, t in events if e == "token"]
            wire_ttft.append(times[0])
            wire_itl.extend(b - a for a, b in zip(times, times[1:]))
        routed = router.metrics.requests.by_label()
        if sorted(routed) != ["0", "1"] or min(routed.values()) < 1:
            fail(f"fleet (router): requests by replica {routed}")
        # same-prefix requests converge on the replica holding the prefix
        rng = np.random.RandomState(77)
        prefix = [int(t) for t in rng.randint(0, cfg.vocab_size,
                                              (FLEET_PREFIX_LEN,))]
        # both caches emptied first: cached pages count against a
        # replica's free pages, and the score's capacity term would
        # otherwise weigh the 12 streams' leftovers against the bonus
        for fe, e in zip(fes, reps):
            with fe._lock:
                e.prefix_cache.flush()
        hits0 = [e.prefix_cache.hits.value for e in reps]
        routed0 = dict(routed)
        for _ in range(FLEET_PREFIX_REQUESTS):
            router._scrape_all()  # every placement sees an idle fleet
            st, events, body = _sse("127.0.0.1", router.port, {
                "input_ids": prefix + [int(t) for t in rng.randint(
                    0, cfg.vocab_size, (32,))],
                "max_new_tokens": FLEET_PREFIX_NEW})
            if st != 200 or events[-1][0] != "done":
                fail(f"fleet (router): a same-prefix request ended {st} "
                     f"{body}")
        hits = [e.prefix_cache.hits.value - h for e, h in zip(reps, hits0)]
        routed = router.metrics.requests.by_label()
        moved = sorted(routed.get(k, 0) - routed0.get(k, 0)
                       for k in ("0", "1"))
        if sorted(hits) != [0, FLEET_PREFIX_REQUESTS - 1] \
                or moved != [0, FLEET_PREFIX_REQUESTS]:
            fail(f"fleet (router): same-prefix requests placed {moved}, "
                 f"prefix hits {hits}: they did not converge")
        st, data, scrape_s = _http("127.0.0.1", router.port, "GET",
                                   "/metrics")
        scrape = obs.parse_prometheus_text(data.decode("utf-8"))
        for name in ("paddle_fleet_replica_free_pages",
                     "paddle_fleet_replica_prefix_hits",
                     "paddle_fleet_replica_healthy"):
            if sorted(lab.get("replica") for lab, _ in scrape.get(name, ())
                      ) != ["0", "1"]:
                fail(f"fleet (router): /metrics lacks {name} by replica")
        if "paddle_fleet_requests_total" not in scrape:
            fail("fleet (router): /metrics lacks paddle_fleet_requests_total")
    finally:
        router.stop()
        for fe in fes:
            fe.stop(close_engine=True)
            if fe.driver_errors:
                fail(f"fleet (router): driver errors "
                     f"{list(fe.driver_errors)}")

    def p(xs, q):
        return float(np.percentile(np.asarray(xs), q))

    res = {"card": card, "warmup_s": warm_s, "streams_s": streams_s,
           "requests_by_replica": routed0, "prefix_hits": hits,
           "prefix_placed": moved,
           "wire_ttft_p50_s": p(wire_ttft, 50),
           "wire_itl_p50_s": p(wire_itl, 50),
           "wire_itl_p90_s": p(wire_itl, 90),
           "frontend_wire_ttft_p50_s": fe_res["wire_ttft_p50_s"],
           "frontend_wire_itl_p50_s": fe_res["wire_itl_p50_s"],
           "scrape_bytes": len(data), "scrape_s": scrape_s}
    log("fleet (router): " + json.dumps(res))
    del reps, fes, router
    gc.collect()
    torch.cuda.empty_cache()
    legs["router_s"] = time.perf_counter() - t0

    # ---- (d) the fleet as the README starts it
    t0 = time.perf_counter()
    launched = launch_leg(torch, np, dev, card)
    legs["launched_s"] = time.perf_counter() - t0
    log("fleet phase: " + json.dumps({
        "card": card, "legs_s": legs, "launched": launched,
        "phase_s": time.perf_counter() - t_phase}))
    return total


def launch_leg(torch, np, dev, card):
    """``python -m paddle_tpu_torch.serving.fleet.launch`` children on the
    card (the kernels are built: the children load the library): a
    prefill worker, two replicas attached to it, a router; see
    :func:`fleet_phase` (d)."""
    import threading

    from paddle_tpu_torch.serving import PagedServingEngine
    from paddle_tpu_torch.serving.fleet import launch

    t0 = time.perf_counter()
    procs = []
    try:
        procs.append(launch.spawn("prefill", FLEET_CLI, timeout_s=300))
        worker = f"127.0.0.1:{procs[0].port}"
        procs += launch.spawn_all(
            [("replica", FLEET_CLI + ["--prefill-worker", worker])] * 2,
            timeout_s=300)
        replicas = procs[1:3]
        procs.append(launch.spawn("router", [
            "--replicas", ",".join(f"127.0.0.1:{r.port}" for r in replicas)],
            timeout_s=120))
        router = procs[3]
        spawn_s = time.perf_counter() - t0
        # the in-process reference over the same seeded weights
        args = launch._parser().parse_args(["--role", "replica",
                                            *FLEET_CLI])
        ref_net = launch.build_net(args)
        ref = PagedServingEngine(
            ref_net, max_batch_size=args.max_batch, max_seq_len=args.max_seq,
            min_bucket=args.min_bucket, page_size=args.page_size,
            cache_dtype=args.cache_dtype)
        rng = np.random.RandomState(31)
        prompts = [[int(t) for t in rng.randint(0, args.vocab, (int(n),))]
                   for n in rng.randint(4, args.max_seq - FLEET_LAUNCH_NEW,
                                        FLEET_LAUNCH_PROMPTS)]
        # one request at a time (each alone in its batch, through the
        # router and in process): token for token
        alone = [ref.generate([np.asarray(p)], FLEET_LAUNCH_NEW)[0].tokens
                 for p in prompts]
        for i, p in enumerate(prompts):
            st, events, body = _sse("127.0.0.1", router.port, {
                "input_ids": p, "max_new_tokens": FLEET_LAUNCH_NEW})
            toks = [d["token"] for e, d, _ in events if e == "token"]
            if st != 200 or events[-1][0] != "done" or toks != alone[i]:
                fail(f"fleet (launched): request {i} alone through the "
                     f"router ended {st} {body} "
                     f"{events[-1][:2] if events else None}, tokens "
                     f"{'equal' if toks == alone[i] else 'different'} to "
                     f"the in-process engine's")
        # all at once, through the router and in process (which rows
        # share a decode step differs): token for token
        want = [h.tokens for h in ref.generate(
            [np.asarray(p) for p in prompts], FLEET_LAUNCH_NEW)]

        def at_once(n, label):
            """The first ``n`` prompts through the router at once: each
            stream done and equal to ``want``."""
            streams = _in_threads([
                (lambda p=p: _sse("127.0.0.1", router.port, {
                    "input_ids": p, "max_new_tokens": FLEET_LAUNCH_NEW}))
                for p in prompts[:n]])
            got = [[d["token"] for e, d, _ in ev if e == "token"]
                   for _, ev, _ in streams]
            if got != want[:n] or any(st != 200 or ev[-1][0] != "done"
                                      for st, ev, _ in streams):
                log(f"fleet (launched, {label}) mismatch: " + json.dumps({
                    "ends": [(st, ev[-1][:2] if ev else None)
                             for st, ev, _ in streams],
                    "got": got, "want": want[:n]}))
                fail(f"fleet (launched): the streams sent {label} through "
                     f"the router differ from the in-process engine's")

        at_once(len(prompts), "at once")
        # in process: the same prompt alone and beside another request,
        # and the prompts at once in the reverse order (which rows share
        # a decode step changes), measured
        paired = ref.generate([np.asarray(prompts[1]),
                               np.asarray(prompts[0])], FLEET_LAUNCH_NEW)
        beside = paired[1].tokens
        reverse = [h.tokens for h in ref.generate(
            [np.asarray(p) for p in prompts[::-1]], FLEET_LAUNCH_NEW)][::-1]
        reorder = sum(a != b for x, y in zip(reverse, want)
                      for a, b in zip(x, y))
        # a replica killed mid-stream: its stream ends replica_failed,
        # unstarted requests complete on the survivor
        started = threading.Event()
        victim = []
        long_new = args.max_seq - 2
        th = threading.Thread(target=lambda: victim.append(_sse(
            "127.0.0.1", router.port, {"input_ids": [1],
                                       "max_new_tokens": long_new},
            first_token=started)))
        th.start()
        if not started.wait(120):
            fail("fleet (launched): the long stream did not start")
        st, data, _ = _http("127.0.0.1", router.port, "GET", "/replicas")
        busy = [r["port"] for r in json.loads(data)["replicas"]
                if r["in_flight_routed"]]
        dead = [r for r in replicas if r.port in busy]
        if len(dead) != 1:
            fail(f"fleet (launched): the long stream is on ports {busy}")
        dead[0].kill()
        survivor = [r for r in replicas if r is not dead[0]][0]
        at_once(3, "after the kill")
        th.join(300)
        st, events, _ = victim[0]
        n_tok = sum(e == "token" for e, _, _ in events)
        if st != 200 or events[-1][0] != "error" \
                or events[-1][1].get("reason") != "replica_failed" \
                or not 0 < n_tok < long_new:
            fail(f"fleet (launched): the killed replica's stream ended "
                 f"{st} {events[-1][:2] if events else None} after {n_tok} "
                 f"tokens")
        health = json.loads(_http("127.0.0.1", survivor.port, "GET",
                                  "/healthz")[1])
        if health["page_pool"]["pages_in_use"] or health["active"]:
            fail(f"fleet (launched): the survivor holds "
                 f"{health['page_pool']['pages_in_use']} pages, "
                 f"{health['active']} rows after its streams")
        st, data, _ = _http("127.0.0.1", router.port, "GET", "/metrics")
        text = data.decode("utf-8")
        out = {"card": card, "spawn_s": spawn_s,
               "alone_equal": len(prompts),
               "at_once_equal": len(prompts),
               "after_kill_equal": 3,
               "in_process_alone_vs_beside_another_equal":
                   beside == alone[0],
               "in_process_reverse_order_tokens_differing": reorder,
               "killed_after_tokens": n_tok,
               "unstarted_completed": 3,
               "router_retries": [ln for ln in text.splitlines()
                                  if ln.startswith("paddle_fleet_retries")],
               "router_stream_aborts": [
                   ln for ln in text.splitlines()
                   if ln.startswith("paddle_fleet_stream_aborts")]}
    finally:
        rcs = {}
        for p in procs:
            if p.alive:
                rcs[f"{p.role}:{p.port}"] = p.terminate(timeout_s=60)
            else:
                rcs[f"{p.role}:{p.port}"] = p.proc.returncode
    if sorted(rcs.values()) != [-9, 0, 0, 0]:
        fail(f"fleet (launched): exit codes {rcs} (the killed replica -9, "
             f"every other child 0 on SIGTERM)")
    out["exit_codes"] = rcs
    out["leg_s"] = time.perf_counter() - t0
    del ref, ref_net
    return out


def fleet_int8_leg(torch, np, card, net, eng, cfg, graph_run):
    """The int8 transfer leg of the fleet phase, on the quantized serving
    phase's net (int8 weights) and warmed graph engine ``eng`` (int8
    arena): a worker and a disaggregated int8 graph engine; 4 requests
    remote, their streams equal ``eng``'s for the same requests at once
    and, printed, the quantized phase's run; two prompts' adopted pages
    (codes and scales) equal a local prefill's bit for bit. Returns the
    launch counts."""
    import types

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import (PagedServingEngine, PrefillWorker,
                                          RemotePrefillClient)
    from paddle_tpu_torch.serving.fleet import launch

    t0 = time.perf_counter()
    total = {}
    worker = PrefillWorker(net, weights_version="v0").start()
    client = RemotePrefillClient("127.0.0.1", worker.port, timeout_s=600,
                                 expected_weights_version="v0")
    disagg = PagedServingEngine(net, cache_dtype="int8",
                                prefill_transport=client, **ENGINE_KW)
    disagg.warmup()
    launch._warmup(disagg, types.SimpleNamespace(
        min_bucket=disagg.pool.min_bucket, max_seq=disagg.max_seq_len))
    caps = worker.compile_counts()
    lens, prompts = serving_prompts(np, cfg)
    kernels.reset_launch_counts()
    runs = {}
    for name, e in (("local", eng), ("remote", disagg)):
        hs = [e.submit(p, SERVE_MAX_NEW) for p in prompts[:4]]
        e.run_until_idle()
        runs[name] = [h.tokens for h in hs]
    order = np.argsort(lens[:4])
    compared = [adopted_pages_equal(torch, eng, disagg, prompts[i],
                                    "fleet (int8)")
                for i in (order[0], order[-1])]
    _add_counts(total, kernels.launch_counts())
    if runs["remote"] != runs["local"]:
        fail("fleet (int8): the remote streams differ from the local ones")
    if (disagg.remote_prefills, disagg.remote_prefill_fallbacks,
            disagg.local_prefills) != (6, 0, 0) \
            or worker.compile_counts() != caps:
        fail(f"fleet (int8): {disagg.remote_prefills} remote, "
             f"{disagg.remote_prefill_fallbacks} fallbacks, "
             f"{disagg.local_prefills} local; worker captures "
             f"{worker.compile_counts()} after {caps}")
    res = {"card": card, "requests": 4,
           "streams_equal_quantized_phase": runs["remote"] == [
               h.tokens for h in graph_run["handles"][:4]],
           "adopted_pages_bit_equal_bytes": compared,
           "transfers": client.transfers.by_label(),
           "bytes_total": client.transfer_bytes.value,
           "leg_s": time.perf_counter() - t0}
    log("fleet (int8): " + json.dumps(res))
    worker.stop()
    disagg.close()
    return total


# ------------------------------------------------------------- resilience
RES_STEPS = 6
RES_DIR = os.path.join(HERE, "build", "chip_smoke_resilience")


def resilience_phase(torch, np, dev, card):
    """The resilient training runtime on the checkpoint phase's model
    (Llama-2-7B widths, CKPT_LAYERS layers, fp32, AdamW with its warmup
    and clip; B 2 x S 2048, a batch of its own each step):

    - skip, ``sync=True``, NaN through ``train.loss`` at step 3 of 5: the
      parameters and moments after the run equal a run over batches 1, 2,
      4, 5 bit for bit;
    - skip, ``sync=False``, NaN at step 3 of 8 (made on the device, with
      no synchronization): the detection lag in steps (printed);
    - rollback, NaN at step 5 after the commit of step 4: ``run_resilient``
      ends with the losses and every parameter of the uninterrupted
      RES_STEPS-step run, bit for bit;
    - the watchdog (``stall_seconds`` 2, started): a 3 s block at
      ``train.step_begin`` fires ``wedged_step`` once, with a flight
      bundle; a 3 s stall reported through ``note_blocked`` fires none.

    Every trainer call launches the training kernels the structure gives.
    Returns the launch counts."""
    import gc
    import shutil

    from paddle_tpu_torch import chaos, kernels
    from paddle_tpu_torch.checkpoint import CheckpointManager, CheckpointPolicy
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import (FlightRecorder,
                                                get_step_meter)
    from paddle_tpu_torch.training import (AnomalySentinel, SentinelPolicy,
                                           TrainWatchdog, run_resilient)

    t_phase = time.perf_counter()
    shutil.rmtree(RES_DIR, ignore_errors=True)
    os.makedirs(RES_DIR)
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=CKPT_LAYERS)
    batches = {}
    for s in range(1, 9):
        ids = torch.as_tensor(np.random.RandomState(1000 + s).randint(
            0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)),
            dtype=torch.long, device=dev)
        batches[s] = ([ids[:, :-1].contiguous()], [ids[:, 1:].contiguous()])
    calls = [0]
    total = {}
    per_step = _train_per_step(CKPT_LAYERS)

    def fresh():
        net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
        step, opt, sched = _trainer(torch, net)
        return net, step, opt, sched

    def drive(step, sched, order, steps, losses=None):
        """``run_resilient`` over the batches of ``order``, the schedule
        stepped after each step that stood (a skipped step's batch is
        dropped, its update undone, so the schedule does not move)."""

        def batch_fn(i):
            calls[0] += 1
            return batches[order[i - 1]]

        def on_step(i, loss, action):
            if action is None:
                sched.step()
                if losses is not None:
                    losses[i] = float(loss)

        return run_resilient(step, batch_fn, steps=steps, on_step=on_step)

    def check_counts(label, n):
        counts = kernels.launch_counts()
        want = {k: v * n for k, v in per_step.items()}
        if counts != want:
            fail(f"resilience ({label}): launches {counts}, expected {want} "
                 f"for {n} trainer calls")
        _add_counts(total, counts)

    def state(net, opt):
        return ([p for p in net.parameters()]
                + [opt._accumulators[k] for k in sorted(opt._accumulators)])

    def nan(value=None, **_):
        return float("nan")

    def device_nan(value=None, **_):
        # the NaN made on the device, after the step's work: a host float
        # would cross in a synchronous copy, and the lag would read 0
        return value * float("nan")

    out = {"card": card}
    # ---- skip, synchronous
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    calls[0] = 0
    net, step, opt, sched = fresh()
    sentinel = AnomalySentinel(SentinelPolicy(nan_action="skip"), sync=True)
    sentinel.attach(step)
    with chaos.chaos() as m:
        m.on("train.loss", nan, after=2, times=1)
        summary = drive(step, sched, [1, 2, 3, 4, 5], 5)
    ref_net, ref_step, ref_opt, ref_sched = fresh()
    drive(ref_step, ref_sched, [1, 2, 4, 5], 4)
    torch.cuda.synchronize()
    check_counts("skip", calls[0])
    a, b = state(net, opt), state(ref_net, ref_opt)
    equal = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    if summary["skipped_steps"] != 1 or opt._step_count != 4 or not equal:
        fail(f"resilience (skip): {summary}, step count {opt._step_count}, "
             f"parameters and moments "
             f"{'equal' if equal else 'different'} to a run without batch 3")
    out["skip"] = {"summary": summary, "bit_equal_tensors": len(a),
                   "leg_s": time.perf_counter() - t0}
    log("resilience (skip): " + json.dumps(out["skip"]))
    del net, step, opt, sched, ref_net, ref_step, ref_opt, ref_sched
    del sentinel, a, b
    gc.collect()
    torch.cuda.empty_cache()
    # ---- skip, asynchronous: the detection lag
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    calls[0] = 0
    net, step, opt, sched = fresh()
    sentinel = AnomalySentinel(SentinelPolicy(nan_action="skip"), sync=False)
    sentinel.attach(step)
    seen = {}

    def on_step(i, loss, action):
        if action is not None:
            seen.update(step=i, dropped=action.dropped_steps,
                        bad_step=action.step)
        else:
            sched.step()

    with chaos.chaos() as m:
        m.on("train.loss", device_nan, after=2, times=1)

        def batch_fn(i):
            calls[0] += 1
            return batches[i]

        summary = run_resilient(step, batch_fn, steps=8, on_step=on_step)
    if not seen:
        # not ready within the run: the blocking check judges it now
        act = sentinel.check(block=True)
        seen.update(step=9, dropped=act.dropped_steps, bad_step=act.step)
    torch.cuda.synchronize()
    check_counts("skip async", calls[0])
    if seen["bad_step"] != 3:
        fail(f"resilience (skip async): the skip judged step "
             f"{seen['bad_step']}, not 3")
    out["skip_async"] = {"summary": summary,
                         "detected_at_step": seen["step"],
                         "lag_steps": seen["step"] - 3,
                         "dropped_steps": seen["dropped"],
                         "leg_s": time.perf_counter() - t0}
    log("resilience (skip async): " + json.dumps(out["skip_async"]))
    del net, step, opt, sched, sentinel
    gc.collect()
    torch.cuda.empty_cache()
    # ---- rollback and replay
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    calls[0] = 0
    order = list(range(1, RES_STEPS + 1))
    ref_losses = {}
    ref_net, ref_step, ref_opt, ref_sched = fresh()
    drive(ref_step, ref_sched, order, RES_STEPS, ref_losses)
    net, step, opt, sched = fresh()
    # a blocking save: step 4 is committed before step 5 is judged (the
    # ladder offers a rollback only over a committed checkpoint)
    mgr = step.attach_checkpoint(CheckpointManager(
        RES_DIR, async_saves=False,
        policy=CheckpointPolicy(save_every_steps=4, keep_last_k=1)))
    sentinel = AnomalySentinel(SentinelPolicy(nan_action="rollback"),
                               manager=mgr, sync=True)
    step.attach_sentinel(sentinel)
    losses = {}
    with chaos.chaos() as m:
        m.on("train.loss", nan, after=4, times=1)
        summary = drive(step, sched, order, RES_STEPS, losses)
    mgr.close()
    torch.cuda.synchronize()
    check_counts("rollback", calls[0])
    a, b = state(net, opt), state(ref_net, ref_opt)
    equal = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    if summary["replays"] != 1 or summary["completed_steps"] != RES_STEPS \
            or [losses[i] for i in order] != [ref_losses[i] for i in order] \
            or not equal:
        fail(f"resilience (rollback): {summary}, losses {losses} against "
             f"{ref_losses}, parameters and moments "
             f"{'equal' if equal else 'different'}")
    out["rollback"] = {"summary": summary, "losses": [losses[i]
                                                      for i in order],
                       "bit_equal_tensors": len(a), "calls": calls[0],
                       "leg_s": time.perf_counter() - t0}
    log("resilience (rollback): " + json.dumps(out["rollback"]))
    del ref_net, ref_step, ref_opt, ref_sched, a, b, mgr, sentinel
    del net, step, opt, sched
    gc.collect()
    torch.cuda.empty_cache()
    # ---- the watchdog, on a trainer of its own (the rollback leg's
    # manager would save at step 8, and a blocking save reports its stall
    # only once it ends: the watchdog would see a wedge)
    t0 = time.perf_counter()
    net, step, opt, sched = fresh()
    kernels.reset_launch_counts()
    calls[0] = 0
    rec = FlightRecorder(dump_dir=os.path.join(RES_DIR, "flight"))
    wd = TrainWatchdog(stall_seconds=2.0, recorder=rec)
    wd.attach(step)
    wd.start()
    try:
        with chaos.chaos() as m:
            m.on("train.step_begin", lambda **_: time.sleep(3.0), times=1)
            calls[0] += 1
            step(*batches[1])
            torch.cuda.synchronize()
        wedged = dict(wd.fires.series())
        bundle = wd.last_dump_path
        with chaos.chaos() as m:
            m.on("train.step_begin", lambda **_: (
                get_step_meter().note_blocked(3.0), time.sleep(3.0)),
                times=1)
            calls[0] += 1
            step(*batches[2])
            torch.cuda.synchronize()
        fires = dict(wd.fires.series())
    finally:
        wd.stop()
    check_counts("watchdog", calls[0])
    want = {(("kind", "wedged_step"),): 1}
    if wedged != want or fires != want or not bundle \
            or not os.path.isfile(bundle):
        fail(f"resilience (watchdog): fires {wedged} after the wedged step, "
             f"{fires} after the blocked one, bundle {bundle}")
    with open(bundle) as f:
        reason = json.load(f)["reason"]
    out["watchdog"] = {"fires": 1, "bundle_reason": reason,
                       "leg_s": time.perf_counter() - t0}
    del net, step, opt, sched
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(RES_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log("resilience: " + json.dumps(out))
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="after each serving phase (bf16, quantized), "
                         "profile this many decode steps with every row "
                         "busy, and a 1024-bucket prefill")
    ap.add_argument("--profile-train-steps", type=int, default=0,
                    help="after the training phase, profile this many "
                         "more training steps")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = smi

    nvcc = _build.find_nvcc()
    if nvcc is None:
        fail("nvcc not found")
    _build.build(nvcc)
    _build.load()
    log(f"build: {_build.build_seconds:.1f} s, {_build.LIB_PATH}")

    results = {}
    for name, modname, cases_fn in (
            ("rms_norm", "rms_norm", rms_norm_cases),
            ("rope", "rope", rope_cases),
            ("paged_attention", "paged_attention", paged_cases),
            ("rms_norm_bwd", "rms_norm", rms_norm_bwd_cases),
            ("rope_bwd", "rope", rope_bwd_cases),
            ("flash_attention", "flash_attention", flash_cases),
            ("paged_attention_int8", "paged_attention", paged_int8_cases),
            ("int8_matmul", "int8_matmul", int8_matmul_cases),
            ("rms_norm_matmul", "fused_norm_matmul", norm_matmul_cases),
            ("rope_attention", "fused_rope_attention",
             rope_attention_cases),
            ("rope_attention_bwd", "fused_rope_attention",
             rope_attention_bwd_cases),
            ("multi_tensor", "fused_adam", multi_tensor_cases),
            ("fp16", None, fp16_kernel_cases),
            ("fp8", "fp8_matmul", fp8_kernel_cases)):
        cases = cases_fn(torch, getattr(kernels, modname) if modname
                         else kernels, dev)
        torch.cuda.synchronize()
        named = (dict(zip(("flash_attention_fwd", "flash_attention_bwd"),
                          cases)) if name == "flash_attention"
                 else cases if isinstance(cases, dict) else {name: cases})
        for kname, kcases in named.items():
            for c in kcases:
                log(f"kernel {kname}: " + json.dumps(c))
                if c.get("cuda_core_ms") is not None \
                        and not c["ms"] < c["cuda_core_ms"]:
                    fail(f"{kname} {c['dtype']} {c['shape']}: {c['ms']} ms, "
                         f"not faster than the CUDA-core design it "
                         f"replaced ({c['cuda_core_ms']} ms)")
                for chk in c.get("checks", [c]):
                    if not (chk["max_abs_err"] <= chk["tolerance"]
                            and chk.get("err_over_tol", 0.0) <= 1.0):
                        fail(f"{kname} {c['dtype']} {c['shape']} "
                             f"{chk.get('output', '')}: max_abs_err "
                             f"{chk['max_abs_err']}, tolerance "
                             f"{chk['tolerance']}, largest error over "
                             f"its entry's tolerance "
                             f"{chk.get('err_over_tol')}")
            results[kname] = kcases
    crossover = int8_crossover(torch, kernels.int8_matmul, dev)
    log("kernel int8_matmul crossover: " + json.dumps(crossover))
    crossover = norm_matmul_crossover(torch, kernels.fused_norm_matmul, dev)
    log("kernel rms_norm_matmul crossover: " + json.dumps(crossover))
    crossover = norm_matmul_fp32_crossover(torch, kernels.fused_norm_matmul,
                                           dev)
    log("kernel rms_norm_matmul fp32 crossover: " + json.dumps(crossover))
    floor = launch_floor(torch, dev, results)
    log("launch floor: " + json.dumps(floor))
    for row in paged_chunk_sweep(torch, kernels.paged_attention, dev):
        log("kernel paged_attention chunk sweep: " + json.dumps(row))

    small_parity(torch, np, dev)
    prefix_parity(torch, np, dev)
    spec_parity_counts = spec_parity(torch, np, dev)
    fused_parity(torch, np, dev)
    tiny_train_parity(torch, np, dev)
    tiny_o3_counts = tiny_o3_parity(torch, np, dev)
    (train_counts, fused_train_counts, fp32_train_counts,
     fused_fp32_train_counts, opt_counts, new_counts) = training_phase(
        torch, np, dev, card, args.profile_train_steps)
    checkpoint_counts = checkpoint_phase(torch, np, dev, card)
    resilience_counts = resilience_phase(torch, np, dev, card)
    (serve_counts, serve_eager_counts,
     (fused_serve_counts, fused_serve_eager_counts),
     (prefix_counts, prefix_eager_counts), session_counts, spec_counts,
     beam_counts, reload_counts, frontend_counts,
     fleet_counts) = serving_phase(torch, np, dev, card, args.profile_steps)
    quant_counts, quant_eager_counts, fleet_int8_counts = quant_serving_phase(
        torch, np, dev, card, args.profile_steps)

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "paddle_tpu."))
              or m == "paddle_tpu"]
    if leaked:
        fail(f"the port imported {leaked[:5]}")

    line = []
    for name, src, replaces in KERNELS + FP16_LINE:
        # the first case is the main path's shape: bf16 at the decode
        # shape for the serving kernels (the W8A16 matmul: q/k/v/o's
        # [8, 4096] x [4096, 4096]; the fused head: [8, 4096] x [4096,
        # 32000]), the training shape for the rest (fp32 [4096, 4096]
        # for the RMSNorm backward, the O1 residual)
        main_case = results[name][0]
        # the serving phases: their first run through the programs (CUDA
        # graphs, the default) and their first eager run
        # (the fp16 kernels' counts are only in the new phases' dicts)
        by_phase = {"serving": serve_counts, "serving_eager":
                    serve_eager_counts, "training": train_counts,
                    "quantized_serving": quant_counts,
                    "quantized_serving_eager": quant_eager_counts,
                    "fused_serving": fused_serve_counts,
                    "fused_serving_eager": fused_serve_eager_counts,
                    "prefix_serving": prefix_counts,
                    "prefix_serving_eager": prefix_eager_counts,
                    "session_serving": session_counts,
                    "spec_parity": spec_parity_counts,
                    "spec_serving": spec_counts, "beam": beam_counts,
                    "checkpoint": checkpoint_counts,
                    "full_reload": reload_counts,
                    "frontend": frontend_counts, "fleet": fleet_counts,
                    "fleet_int8": fleet_int8_counts,
                    "resilience": resilience_counts,
                    "fused_training": fused_train_counts,
                    "fp32_training": fp32_train_counts,
                    "fused_fp32_training": fused_fp32_train_counts,
                    "optimizers": opt_counts,
                    "o3_tiny_parity": tiny_o3_counts, **new_counts}
        by_phase = {k: v.get(name, 0) for k, v in by_phase.items()}
        line.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": main_case["max_abs_err"],
            "tolerance": main_case["tolerance"],
            "err_over_tol": main_case.get("err_over_tol"),
            "ms": main_case["ms"], "kernel_ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "unfused_ms": main_case.get("unfused_ms"),
            "card": card, "cases": results[name],
        })
        if "design" in main_case:
            line[-1]["design"] = main_case["design"]
        if name in MT_KERNELS:
            # measured in the O1 training steps
            line[-1]["launches_per_o1_step"] = train_counts[name] / TRAIN_STEPS
        if name.startswith("flash_attention"):
            # the design each dtype ran, at the training shape (fp32:
            # the default training step's)
            line[-1]["by_design"] = {
                f"{c['dtype']} {c['design']}": {key: c.get(key) for key in (
                    "ms", "cuda_core_ms", "plain_ms", "bound_ms",
                    "bound_by", "bound_rate", "bound_cuda_core_ms",
                    "library_ms")}
                for c in results[name]
                if c["shape"]["sq"] == c["shape"]["sk"] == TRAIN_SEQ
                and c["shape"]["d"] == 128}
        elif name in BOTH_FUSIONS:
            # each design's case at the training shape (the fp32 one is
            # the fused fp32 step's; the bf16 head's is the decode step's)
            line[-1]["by_design"] = {
                f"{c['dtype']} {c['design']}": {key: c.get(key) for key in (
                    "ms", "cuda_core_ms", "plain_ms", "unfused_ms",
                    "bound_ms", "bound_by", "bound_rate",
                    "bound_cuda_core_ms", "max_abs_err", "err_over_tol")}
                for c in results[name]
                if c["shape"].get("rows", TRAIN_BATCH * TRAIN_SEQ) in (
                    8, TRAIN_BATCH * TRAIN_SEQ)
                and c["shape"].get("s", TRAIN_SEQ) == TRAIN_SEQ
                and c["shape"].get("d", 128) == 128}
    idle = [k["name"] for k in line if not k["launches"]]
    if idle:
        fail(f"kernels never launched on a main path: {idle}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
