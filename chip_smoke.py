#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``distributeddataparallel_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

``python3 chip_smoke.py --multi-gpu [12c] [13c] [14c] [15c] [15c+] [18c]
[19b] [20c]`` on a machine with four runs only the entry-point runs over
several GPUs (all of them, or those named) after the build.

Phases (any failure exits non-zero; nothing is caught):

1. the card: name, count and ``nvidia-smi`` name/power limit;
2. the build: the flash-attention kernels compiled from the package's
   ``csrc/`` with ``nvcc`` (sm_90a);
3. each kernel (K1 forward, K2 dq, K3 dk/dv) against its plain PyTorch
   version on the card, in f32 and bf16, causal and not, GQA, ragged and
   ``Sq < Skv`` shapes; then each timed at the GPT-2 124M training shapes
   beside its plain version, a PyTorch library call
   (``scaled_dot_product_attention``, a yardstick only) and its bound, and
   all three again at a bf16 GQA shape (B=2, S=1024, H=32, Hkv=8, D=128),
   each time the device's and the host's ms per call;
4. the main path: ``dpp.main`` trains full-width GPT-2 124M (f32) for 10
   steps and one eval pass in an NCCL group of one, with the kernels'
   launch counters set to 0 just before and read just after;
5. the image path at the ImageNet shape: ``dpp.main`` trains full-width
   ResNet-50 (224x224x3, 1000 classes, f32 with TF32 off) for 10 steps of
   batch 64 on synthetic shards written to a temporary directory, then
   evaluates; the losses must be finite and fall, and the attention
   kernels must be launched 0 times; then the port's BatchNorm, in train
   mode at a ResNet-50 layer's shape and at a small batch, must leave its
   running buffers where flax's biased statistics and momentum put them;
6. the reference's own workload: ResNet-18 with the CIFAR stem at the
   reference's defaults (batch 32, SGD, lr 0.01) with augmentation and
   eval, 2 epochs of 10 steps with checkpoints, then ``--resume`` to 3
   epochs beside an uninterrupted 3-epoch run: the resumed run starts at
   epoch 2 and its losses match the uninterrupted run's epoch 2;
7. Llama-3 8B at full width (d_model 4096, 32 heads / 8 kv heads of 128,
   SwiGLU 14336, vocab 128256, untied head, bf16 activations on f32
   params, activation checkpointing), cut from 32 layers to 8:
   ``dpp.main`` trains 10 steps of 2 x 2048 tokens with AdamW and
   evaluates; the losses must be finite and fall, K1 must be launched
   twice per layer per train step (forward and recompute) and once per
   layer per eval batch, K2 and K3 once per layer per train step; the LM
   head's logits must be f32 and not bf16 values, and its forward and
   backward must match its CPU formula.  Phase 3 also checks and times
   the kernels at this phase's attention shape (B=2, S=2048, H=32, Hkv=8,
   D=128, bf16, causal);
8. the reference's own workload with telemetry: a torchvision-format
   ResNet-18 state dict (10 classes, CIFAR stem, BatchNorm running
   statistics off 0 and 1) from a seeded port model, as ``.pth`` and
   ``.safetensors``; ``dpp.main`` fine-tunes it (``--pretrained``) on
   CIFAR-10 python batches of synthetic uint8 images written to a temporary
   directory, with ``--augment --eval`` for 2 epochs at phase 6's batch and
   every telemetry flag.  It checks that the loaded state equals the file,
   that the native host kernels ran (the fused augment once a train step,
   the fused normalize once an eval batch), that the events validate
   against the port's schema, that there is one ``metrics`` snapshot every
   5 steps, a trace under ``EVENTS_DIR/xprof`` and one run record under
   ``--runs-dir``.  Then phase 6's step and wall-clock step with the native
   augment and with the plain (numpy) augment, from two loaders built here,
   whose batches must be bit-equal; the host kernels' ms per batch beside
   their numpy versions; and phase 4 once more with ``--mfu``, its MFU and
   HFU beside this script's own share of the bound;
9. the fault path at GPT-2 124M's full width (phase 4's model and batch, so
   K1-K3 run on it) and with phase 6's ResNet-18.  9a runs in a fresh
   process of the port's entry point (``python -m
   distributeddataparallel_tpu_torch.dpp``), 9c and 9e in this process
   (``dpp.main``) beside its first incarnation, and its restart alone;
   then, beside 9a's tail, 9b's stop and 9d run in fresh processes and 9b's
   resume in this process; the checkpoint costs run alone at the end:
   a. supervised chaos replay: ``--max-restarts 1`` with
      ``DDP_CHAOS=ckpt-io@0,preempt@6``, 3 epochs of 4 steps, against the
      same run uninterrupted (9e's): it exits 0 after one restart and one
      IO retry, its merged timeline validates against the port's schema,
      its final loss is within ``REPLAY_ATOL`` of the uninterrupted run's,
      and the last incarnation's K1-K3 launches are those of its 8 steps;
      the seconds from the injected death to the next incarnation's first
      step, with nothing else running;
   b. a real SIGTERM once the events show step 3: exit 0 with
      ``epoch_0.pt`` and its hash sidecar (the seconds from the signal to
      the exit, beside the others), then ``--resume`` starts at epoch 1
      and ends with a finite loss;
   c. the guard: ResNet-18 with ``--nan-guard --chaos nan-grad@2``, 3
      one-step epochs with checkpoints, then ``--resume`` to 5: one step
      skipped, the state after step 2 bitwise the state after step 1, the
      other losses finite; then a checkpoint save at GPT-2's AdamW state
      with and without its content hash (the guard's cost is 16b's);
   d. the watchdog: ResNet-18 with ``--step-timeout 5 --max-restarts 1
      --chaos slow-step@3:30``: the worker exits 75 after ``watchdog_fire``
      and the restart completes the run; the seconds from the fire to the
      next incarnation's first step;
   e. 9a's uninterrupted run with ``--coordinator 127.0.0.1:PORT
      --num-processes 1 --process-id 0`` on NCCL: its first two losses
      equal phase 4's first two.
10. the serving path:
   a. ``dpp.main`` on phase 4's GPT-2 for 2 steps with ``--generate 64``,
      then again with ``--decode-quant int8``: every generated token's
      logit within ``TF_ATOL`` of its position's maximum by a plain full
      f32 forward of the checkpointed weights (dequantized int8 weights for
      the second; the first also by the decode twin's own prefill), and
      K1-K3 launched by the training steps only;
   b. ``serve.py`` at GPT-2 124M full width (``max_seq_len`` 1024, bf16) on
      the wall clock, plain, with the fast path (prefix cache, ``--spec-k
      3``, Zipf prefixes) and with int8 KV and weights: every request
      completes, the events validate against the port's schema, 4 requests
      of each run pass the teacher-forced check against the bf16 forward
      through K1, the fast path's outputs equal a plain engine's on every
      8th of its prompts (up to a tie of the forward's logits), the
      engine launches no flash kernel; then a ``torch.profiler`` trace of
      10 decode steps with every slot busy (the device's idle share);
   c. the engine API at Llama-3 8B's full width and all 32 layers (bf16
      cast once from the f32 init, ``max_seq_len`` cut to 2048): both
      paths in f32 on the first prompt within ``LLAMA_F32_ATOL``; the
      burst's first 8 requests through an f32 engine of the same pool
      geometry, each continuation teacher-forced against the f32 decode
      twin's own prefill; then the burst of 16 requests in bf16, all
      completed, 2 of them teacher-forced against the bf16 forward through
      K1 and against the bf16 decode twin's own prefill.

11. the layouts (``--zero 1/2/3``, ``--overlap``, the comm hooks) on GPT-2,
   and Llama-3 8B under ``--zero 2`` with low-bit moments;
12. context and tensor parallelism at Llama-3 8B's attention width (32 heads,
   8 kv heads of 128, bf16):
   a. every rank's hops of the flash ring on a 4-way seq axis over a global
      sequence of 8192, replayed in this process through
      ``parallel.context_parallel``'s own hop and merge functions, against
      one full-sequence K1-K3 call (out, lse, dq, dk, dv), with the launch
      counts the ring implies (1 + r of each kernel on rank r) and each
      rank's time beside the single call's; the same replay at 2048 against
      the plain versions, in f32 at GPT-2's heads over 4096 on a 2-way axis,
      and Ulysses' head split (GQA-native on 4 ranks, the kv heads repeated
      on 16);
   b. one Llama-3 8B block (d_model 4096, FFN 14336) run as its two TP
      shards one after the other (K1-K3 at 16 heads / 4 kv heads), the
      partial outputs summed, against the unsharded block;
   c. with two GPUs or more, ``--cp 2`` (ring, Ulysses, the ring with
      ``--overlap``) and ``--tp 2`` at Llama-3 8B x 8 layers over NCCL
      against one GPU; with one, a line saying it was not run.
13. FSDP (``--fsdp``) in an NCCL group of one, through ``dpp.main``:
   a. phase 7's exact arguments plus ``--fsdp``, then plus ``--fsdp-gather
      bf16``: losses against phase 7's (f32 gathers within
      ``FSDP_LOSS_ATOL``, bf16 within ``FSDP_BF16_RTOL``), K1-K3 launched as
      the model implies, the gathers and scatters remat implies, the step,
      the peak memory and the streaming eval;
   b. phase 4's GPT-2 at 11a's size under ``--fsdp`` with a checkpoint,
      then ``--generate 16`` through the host gather: losses against 11a's
      plain run's, the continuation teacher-forced against the checkpoint's
      whole model;
   c. with four GPUs or more, Llama-3 8B at all 32 layers under ``--fsdp``
      (step, per-card peak) and at 8 layers against plain DP on the same
      four GPUs; with fewer, a line saying it was not run.
14. mixture of experts, through ``dpp.main``:
   a. Llama-3 8B's widths with 8 experts top-2 (token choice, capacity
      factor 1.25) at 1 layer, phase 7's other flags: losses finite and
      falling, ``moe_aux`` finite and near 1, K1-K3 launched as remat
      implies, the step and peak memory; then one such MoE block's forward
      and backward under ``torch.cuda.set_sync_debug_mode("error")``;
   b. GPT-2 124M at 11a's size with 8 experts top-2 in dense dispatch,
      trained in this process (``dpp.build_trainer``, ``dpp.train``), then
      ``--generate 16`` teacher-forced against the trained whole model;
   c. with two GPUs or more (four for the last three), 14a's model at
      capacity factor 8 under ``--ep 2``, ``--ep 4``, ``--ep 2 --tp 2`` and
      ``--cp 2 --ep 2`` against one GPU, with each rank's all-to-all ms;
      with one, a line saying it was not run.
15. pipelines (see ``pp_phase``).
16. bounded dispatch and the warm start (every run above already runs at
   the default ``--dispatch-depth 2``, and its kernels were built in phase 2
   into a fresh ``--compile-cache``):
   a. phase 4's GPT-2 and phase 6's ResNet-18 through ``dpp.main`` at
      depths 0 and 2: losses and parameters bit for bit, the step and
      wall-clock ms and the traced window's device idle share;
   b. GPT-2 under ``--nan-guard`` at depth 2, its loss poisoned at step 3,
      each step under ``torch.cuda.set_sync_debug_mode("error")``:
      the state after the skipped step bitwise the state before it; the
      guard's cost with the same fused AdamW on and off;
   c. phase 4's run reported ``cold``; 9a's supervised GPT-2, whose worker
      dies once (``--max-restarts 1``) under the same cache: both
      incarnations ``cache-hit``, and the restart's seconds split into
      the notice, backoff, spawn, imports, CUDA context, model, checkpoint
      read, the kernel library's load and the first step;
   b also holds a guarded GPT-2 run with no bad step bit for bit to the
   unguarded run (losses, parameters): one fused update for both.
17. the disaggregated serving fleet at GPT-2 124M's full width (bf16, max
   sequence 1024, blocks of 16):
   a. a ``ServingFleet`` 1:2 in this process under a ``VirtualClock``: a
      burst of block-exact and mid-block prompts and a second turn of
      each, prefix cache on, ``BlockAllocator.check()`` on every step of
      every engine; each request's tokens against a single
      ``InferenceEngine`` of the same pool geometry (equal, or parted at a
      tie of the forward's logits, each such position's gap stated); in a
      second run one frame corrupted once (its one bad block NAKed and
      re-sent) and ``decode-0`` killed mid-run (every request completes,
      none dropped, the outputs the first run's); the handoffs' count, bytes a block against
      the 589,824 of the model, and a handoff's extract, wire and land ms
      at 1, 16 and 36 blocks;
   b. ``python -m distributeddataparallel_tpu_torch.serve --fleet 1:2
      --model gpt2_124m --seq-len 1024 --prefix-cache --turns 3
      --kill-engine auto --smoke``: three engine processes on the card,
      its smoke checks passed, its timeline valid against the port's
      schema; per-tier TTFT, tokens/s, handoffs, the kill's requeues.
      With ``CHIP_SMOKE_FLEET_TIMELINE=PATH`` the timeline is copied to
      PATH (``scripts/check_events.py --conformance`` reads it on a machine
      with the JAX package; this script imports none of it).
18. resharding on resume (``training/elastic.py``) and the elastic gang:
   a. two CPU gloo ranks on 2 of the host's cores, started with phase 11
      (the phases beside them keep to the other cores; the
      ``elastic_path`` line names them), train GPT-2 124M at full width
      under ``--zero 1`` with AdamW
      (batch 1 a rank, sequence 128, 2 epochs of 2 steps) and checkpoint
      each epoch; their epoch-0 checkpoint restored on the card at world 1
      (its restored moment flats bitwise the two shards' contents
      concatenated, the read and restore timed, the bytes resharded), then
      ``dpp.main --resume`` at batch 2 trains epoch 1 through K1-K3, its
      losses within 1e-5 of the gang's steps 3-4.  ``python3 chip_smoke.py
      --elastic-faults`` runs 18a alone, then resumes the checkpoint with
      a fault planted in it (the moments zeroed; the step counts reset)
      and fails unless each lands above that limit;
   c. only with ``--multi-gpu`` on 2+ GPUs: on 4, ``--zero 1 --elastic
      --chaos worker-kill@3:2`` shrinks in place to 3 and its epoch 1 is
      bitwise a 3-card ``--resume`` of a 4-card checkpoint, and
      ``worker-kill@1:2`` at dispatch depth 2 shrinks mid-epoch; ``--fsdp --tp
      2`` saved on 4 cards (2 with 2 GPUs) resumes on 2.
19. the silent-data-corruption defence (``training/integrity.py``) and the
   elastic grow:
   a. GPT-2 124M at phase 4's width and batch, 8 steps at dispatch depth 2
      with ``--integrity-every 2 --integrity-shadow --nan-guard``: every
      shadow re-run's digest equal to the live step's, the losses bitwise
      those of the same run without integrity, K1-K3 launched (8 + 4) x 12
      times each, off-cadence step 3 under sync debug "error"; the
      digest's and a state copy's device ms, the cadence and off-cadence
      steps' ms, the shadow's ms, the copy's bytes and the peak memory
      beside the plain run's; then a transient fault planted in the
      shadow's copy of step 4's input (``integrity.apply_bitflip``): one
      ``sdc_detect`` by ``shadow``, the live losses unchanged;
   b. only with ``--multi-gpu`` on 4 GPUs: GPT-2 124M at phase 4's width
      and batch under ``--zero 1 --elastic --integrity-every 2 --nan-guard``
      with ``bitflip@4:2,worker-join@6:2`` goes 4 -> 3 -> 4 (the vote names
      rank 2 at step 4, no restart, no checkpoint read) and its epoch 1 is
      bitwise a 4-card ``--resume`` of its own epoch-0 checkpoint, written
      on 3; the join's seconds split and its bytes; the same flip and join
      on ``--model mlp``, whose checkpoints are bitwise those of its
      control (``nan-grad@4,worker-kill@4:2,worker-join@6:2``).
20. the autotuner and the probes (``tuning/``, ``utils/metrics.py``):
   a. phase 4's GPT-2 124M under ``--autotune search`` (the reference's
      default LM space, 3 trials of 4 measured steps, the CLI's B=8 the
      baseline): the measured trials are the top 3 by predicted score and
      the baseline, each measured (or refused by the step factory, as the
      reference records it), the winner's record on disk, the run trains
      with its knobs, K1-K3 launched as the trials' steps and the run
      imply; then ``--autotune apply`` over the same store: no trial, the
      winner's knobs, its step beside the winner's measured one;
   b. the apply run's ``--bw-probe`` at world 1: the reference's keys, one
      device, utilization 0.0;
   c. only with ``--multi-gpu`` on 2+ GPUs: ``--bw-probe`` over every GPU
      (bus GB/s at 64 MB against the 450 GB/s link peak) and
      ``overlap_probe`` at GPT-2 124M's width, plain and ``--overlap``.

It prints one ``image_paths`` JSON line (phases 5 and 6), one
``llama_path`` line (phase 7), one ``reference_workload`` line (phase 8),
one ``fault_path`` line (phase 9), one ``layouts`` line (phase 11: each
run's step ms, peak memory and losses), one ``cp_tp_path`` line (phase 12:
each replay's max errors, launches and times, the GPU count), one
``fsdp_path`` line (phase 13), one ``moe_path`` line (phase 14), one ``pp_path`` line (phase 15),
one ``warm_start_path`` line (phase 16), one ``fleet_path`` line (phase 17),
one ``elastic_path`` line (phase 18), one ``integrity_path`` line (phase
19), one ``tuning_path`` line (phase 20), one ``phase_seconds`` line, one
``serving_path`` line (phase 10,
each run's TTFT p50/p99, tokens/s, per-token latency, decode-step ms,
preemptions, evictions, prefix hits, acceptance, pool bytes against the
allocator's peak, peak memory), one ``{"kernels": [...]}`` JSON line,
the card's name and power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense), HBM3 bandwidth.  The f32 bound
# is the fastest f32-accurate rate the card has: 3xTF32 on the tensor cores
# (each f32 product as three TF32 products, as PyTorch's own f32 attention
# does), 495 / 3 TFLOP/s.  The 67 TFLOP/s of f32 on the CUDA cores is kept
# as a second bound (``bound_cuda_core_ms``), the ceiling of a kernel that
# leaves the tensor cores idle.
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_F32_CUDA_CORES = 67e12
PEAK_BYTES = 3.35e12
# The spin kernel ahead of each timed run: ~25 ms at the H100's 1.98 GHz.
SPIN_CYCLES = 50_000_000

# GPT-2 124M attention at the main path's shapes, and a bf16 GQA shape.
GPT2 = dict(B=8, Sq=1024, Skv=1024, H=12, Hkv=12, D=64, dtype="float32", causal=True)
GQA_BF16 = dict(B=2, Sq=1024, Skv=1024, H=32, Hkv=8, D=128, dtype="bfloat16", causal=True)
LLAMA = dict(B=2, Sq=2048, Skv=2048, H=32, Hkv=8, D=128, dtype="bfloat16", causal=True)
CHECK_CASES = [
    ("gpt2_f32_causal", GPT2),
    ("noncausal_ragged_f32", dict(B=2, Sq=1000, Skv=1000, H=4, Hkv=4, D=64, dtype="float32", causal=False)),
    ("sq_lt_skv_f32_causal", dict(B=2, Sq=384, Skv=1024, H=4, Hkv=4, D=128, dtype="float32", causal=True)),
    ("gqa_bf16_causal", GQA_BF16),
    ("d256_gqa_ragged_f32", dict(B=1, Sq=77, Skv=300, H=6, Hkv=2, D=256, dtype="float32", causal=True)),
    ("d40_gqa_ragged_bf16", dict(B=2, Sq=200, Skv=200, H=6, Hkv=3, D=40, dtype="bfloat16", causal=False)),
    ("llama_bf16_s2048", LLAMA),
]
# Stated tolerances, |kernel - plain| <= atol + rtol * |plain|.  f32: both
# versions are f32-accurate (the kernels' 3xTF32 products keep ~2^-22 of
# each operand), so results differ by summation order and the online
# softmax's rescaling.  bf16: every output is rounded to bf16 once at the
# end, and rtol 1e-2 covers the one bf16 ulp (2^-7 relative, at most) two
# nearby f32 values may round apart.  Before that rounding, p (and ds) are
# rounded to bf16 ahead of their second product, as the reference does: K1
# rounds p = exp(s - m) against the running max of each 64-key tile (its
# bf16 tile), the plain version against the row's max, so one p may land
# one bf16 ulp (2^-8 relative) apart and an output moves by up to
# 2^-8 sum p|v| / l, about 1e-3 on average over the 65+ keys a row crossing
# tiles sees, with tails to ~2e-3 across the millions of entries checked:
# atol 2e-3.  K2/K3 round the same f32 p and ds as the plain version when
# both get the same (out, lse), so they differ only where f32 summation
# order tips a rounding; fed the plain forward's (out, lse) instead, a
# one-ulp change of out would shift delta and tip many ds roundings, each
# worth one bf16 ulp of ds times |k| in dq.  lse is f32 in every case.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-3, 1e-2)}

# 256 examples, so 32 eval batches; the most any GPT-2 run derived from these
# takes is phase 8's 25 steps of 8.
MAIN_ARGS = [
    "--model", "gpt2", "--dataset", "synthetic-lm", "--seq-len", "1024",
    "--vocab-size", "50257", "--batch-size", "8", "--optimizer", "adamw",
    "--lr", "3e-4", "--steps-per-epoch", "10", "--epochs", "1", "--eval", "--num-examples", "256",
]

# Phase 5: ResNet-50 at the ImageNet shape, SGD with momentum 0.9.  Over 10
# steps on these 1000 synthetic classes lr 0.03 lowers the loss steadily
# (7.15 -> 6.59 on an H100); lr 0.1, the ImageNet recipe's rate for batch
# 256, is four times the linearly scaled rate for batch 64 and made the
# loss climb to 7.41 at step 7 before it came back to 7.10.
R50_ROWS = dict(train=640, val=192)
R50_ARGS = [
    "--model", "resnet50", "--dataset", "shards:{root}", "--batch-size", "64",
    "--optimizer", "sgd", "--momentum", "0.9", "--lr", "0.03", "--steps-per-epoch", "10",
    "--epochs", "1", "--eval",
]
# Phase 5's BatchNorm check: the running buffers after one train-mode call,
# against torch.var_mean (biased) in f64 through flax's update 0.9 * old +
# 0.1 * batch.  The buffers come from the statistics that the normalize op
# (cuDNN's kernel on the card) returns; a backend whose third output meant
# something other than 1 / sqrt(var + eps) would miss by far more than the
# tolerance.  Shapes: ResNet-50's first 56x56 BatchNorm at batch 64, and 16
# values a channel, at which the unbiased variance is 1/15 larger (rtol 1e-5
# cannot tell them apart at 200704 values a channel).  Inputs have
# |mean| <= 1 and std 0.5-2 per channel, as activations do; f32 sums over
# 200704 values and the invstd round trip (a few ulps) keep the error near
# 1e-6 relative: |got - want| <= 1e-5 * |want| + 1e-6.
BN_SHAPES = [(64, 256, 56, 56), (4, 64, 2, 2)]
BN_RTOL, BN_ATOL = 1e-5, 1e-6
# Phase 6: ResNet-18 (CIFAR stem) at the reference's defaults, batch 32, SGD,
# lr 0.01, on the synthetic CIFAR-shaped set.
R18_ARGS = [
    "--model", "resnet18", "--dataset", "synthetic", "--batch-size", "32", "--optimizer", "sgd",
    "--lr", "0.01", "--augment", "--eval", "--steps-per-epoch", "10", "--log-every", "1000",
]
# The resumed run starts from the saved state bit for bit, but cuDNN may
# pick weight-gradient kernels that sum with atomics, so each later step's
# gradient can differ in its last bits and the two runs drift apart by float
# rounding: ~1e-6 in loss over 10 steps of SGD at lr 0.01.  A resume at the
# wrong epoch, step, learning rate or augmentation draw moves the losses by
# more than 1e-2.
RESUME_ATOL = 1e-4
# Phase 7: Llama-3 8B width, 8 of its 32 layers.  Plain DP holds f32 params,
# gradients and two AdamW moments, 16 bytes a parameter: 32 layers (8.03 B
# parameters, ~128 GB) do not fit one 80 GB card until ZeRO/FSDP are ported;
# 8 layers are 2.80 B parameters, ~45 GB of state.  64 synthetic rows give
# 10 train steps and 32 eval batches of 2 x 2048 tokens.
LLAMA_LAYERS, LLAMA_EXAMPLES = 8, 64
LLAMA_ARGS = [
    "--model", "llama", "--dataset", "synthetic-lm", "--vocab-size", "128256",
    "--layers", str(LLAMA_LAYERS), "--seq-len", "2048", "--batch-size", "2",
    "--optimizer", "adamw", "--lr", "3e-4", "--steps-per-epoch", "10", "--epochs", "1",
    "--eval", "--num-examples", str(LLAMA_EXAMPLES),
]
# The head check: rows of the final norm's output against the f32 master
# weight, on the card and by the CPU formula (f32 products of the bf16
# operands; TF32 off).  Forward: both are f32 sums of the same bf16
# products, in another order: |diff| <= 1e-4 + 1e-4 |logit|.  Backward: the
# card rounds the f32 cotangent to bf16 before its bf16 products (2^-9
# relative per element) and rounds each result to bf16 (2^-8), so dx and
# dw are held to 2e-2 of the largest |value| of each.
HEAD_ROWS = 256
HEAD_FWD_TOL, HEAD_BWD_RTOL = (1e-4, 1e-4), 2e-2

# Phase 8: the reference's workload (ResNet-18 CIFAR, batch 32, SGD, lr
# 0.01, augment, eval) fine-tuned from a torchvision-format file, with
# every telemetry flag.  25 steps an epoch: a throughput window (20 steps,
# --log-every 20; the run's first step is kept apart) closes in each epoch,
# so the memory and alert paths run; 1000 train rows give 31 batches,
# 320 test rows 10 eval batches.
CIFAR_ROWS = dict(train=1000, test=320)
R18_TELEMETRY_ARGS = [
    "--model", "resnet18", "--dataset", "cifar10", "--data-root", "{root}", "--batch-size", "32",
    "--optimizer", "sgd", "--lr", "0.01", "--augment", "--eval", "--epochs", "2",
    "--steps-per-epoch", "25", "--log-every", "20", "--pretrained", "{weights}",
    "--events-dir", "{events}", "--metrics-every", "5", "--memory-telemetry", "--alerts",
    "--runs-dir", "{runs}", "--profile-steps", "3:5",
]
# Phase 4 again with --mfu: 25 steps, so one throughput window (20 steps
# after the first; --log-every sets it, at least 20) closes.
MFU_ARGS = [a for a in MAIN_ARGS if a != "--eval"]
MFU_ARGS[MFU_ARGS.index("--steps-per-epoch") + 1] = "25"
MFU_ARGS += ["--log-every", "20", "--mfu", "--events-dir", "{events}"]

# Phase 9: the fault path.  GPT-2 at phase 4's model and batch without eval,
# and phase 6's ResNet-18 without eval (its augment on the f32 set).
FAULT_LM_ARGS = [a for a in MAIN_ARGS if a != "--eval"]
FAULT_R18_ARGS = [a for a in R18_ARGS if a != "--eval"]
# 9a: three epochs of four steps, preempted at step 6 (epoch 1).
REPLAY_ARGS = FAULT_LM_ARGS + ["--epochs", "3", "--steps-per-epoch", "4"]
# 9a: a resume from a bitwise checkpoint replays the same steps with the same
# kernels, and cuBLAS and K1-K3 sum in a fixed order, so the losses could
# differ only by run-to-run nondeterminism of a library kernel: 1e-3 is far
# below the 1e-2 that a resume at a wrong epoch, step or learning rate moves
# GPT-2's loss by.
REPLAY_ATOL = 1e-3
# 9e: the same program as phase 4, one NCCL rank either way: its first two
# losses to f32 rounding of a reordered sum at most.
COORDINATOR_ATOL = 1e-6

# Phase 10: the serving path.  10a: phase 4's GPT-2 trained 2 steps, then
# --generate 64 (dense f32, then int8 weights); its checkpoint gives the
# trained weights to the teacher-forced check.
GEN_ARGS = [a for a in MAIN_ARGS if a != "--eval"]
GEN_ARGS[GEN_ARGS.index("--steps-per-epoch") + 1] = "2"
GEN_ARGS += ["--generate", "64", "--checkpoint-dir", "{ckpt}"]
# 10b: the serving CLI at GPT-2 124M's full width and max_seq_len (bf16 on
# the f32 init, as the reference's CLI), on the wall clock: 2 s of arrivals
# at 16 requests/s, 1 s for the int8 run, since phase 17 bought its time
# back (at 6 s and 3 s the three runs served 102, 103 and 46 requests in
# 19.1, 18.5 and 18.1 s; 8 s and 6 s before phases 13 and 14 did the same).
SERVE_ARGS = [
    "--model", "gpt2_124m", "--seq-len", "1024", "--slots", "16", "--blocks", "640", "--block-size", "16",
    "--chunk", "128", "--rate", "16", "--duration", "2", "--prompt-len", "64,768", "--output-len", "32,192",
    "--seed", "0", "--events-dir", "{events}",
]
SERVE_RUNS = {
    "plain": [],
    "fast_path": ["--prefix-cache", "--spec-k", "3", "--prefix-pool", "8", "--prefix-len", "256"],
    "int8": ["--quantize-kv", "--quantize-weights", "--duration", "1"],
}
# The fast path's outputs against a plain engine's on the same prompts: every
# FAST_SUBSET-th request of its trace (greedy outputs depend on the prompt
# and budget only, not on the schedule).
FAST_SUBSET = 8
# 10b's idle share: decode steps profiled with every slot of 10b's engine
# busy (64-token prompts, budgets of 128 keep them running).
PROFILE_DECODE = dict(steps=10, prompt=64, new=128)
# 10c: Llama-3 8B at full width and all 32 layers, bf16 cast once from the
# port's f32 init; max_seq_len cut from 8192 to 2048 (the engine gathers
# every slot's whole cache each step); a burst of 16 requests of 32 new
# tokens (64 until phase 17 bought its time back: the burst took 18.3 s).
SERVE_LLAMA = dict(max_seq_len=2048, num_slots=8, block_size=16, num_blocks=1040, chunk=256,
                   requests=16, prompt_len=(512, 1024), output_len=32, seed=0)
# The teacher-forced check: every generated token's logit within an atol of
# the maximum logit at its position, by a full forward over prompt +
# continuation.  If a path's logits are within d of the forward's, the
# token it picks (its own argmax) is at most 2d below the forward's max, so
# atol = 2d says "the token is an argmax up to the two paths' rounding", and
# stays true when cuBLAS picks other kernels for other shapes.
# - f32 (10a, GPT-2): the same f32 products summed in other orders, d ~1e-6
#   on logits of |logit| < 3; atol 1e-3, far below the ~0.1 typical gap
#   between the top two logits.
# - bf16, GPT-2 (10b, 12 layers): the decode twin's plain attention against
#   K1's tiled forward rounds hidden states an ulp (2^-8) apart here and
#   there, d up to ~2^-8 * 8 = 0.03 on logits of |logit| < 8: atol 0.0625.
# - bf16, Llama-3 8B (10c, 32 layers of random weights): those ulps grow
#   through depth; on an H100 the two paths' logits differ by 0.44-0.55 on
#   these requests (``decode_vs_forward_max_abs``, printed every run), so
#   atol = 2 x 0.625 = 1.25.  The bf16 engine's continuations are held to
#   the bf16 decode twin's own prefill by the same bound: the engine's
#   decode GEMMs run at M = 8 rows and its prefill in chunks of 256, the
#   twin's at M = the whole sequence, so cuBLAS sums in other orders and
#   the same ulps grow through the 32 layers.
# - f32, Llama-3 8B (10c's f32 engine): 1.25 is loose against the ~0.26
#   typical top-2 gap of 128256 logits, so the engine is also held in f32,
#   where the two paths' logits are within d = LLAMA_F32_ATOL: atol 2d.
TF_ATOL = {"float32": 1e-3, "bfloat16": 6.25e-2, "bfloat16_llama": 1.25, "float32_llama": 2e-2}
# 10c's f32 cross-check on the same random weights, both paths computing in
# f32 (K1 in 3xTF32, the decode twin's plain attention), 32 layers: the bf16
# distance scaled by the ratio of the unit roundoffs (2^-24 / 2^-8) is
# ~1e-5 (an H100 gives 2.4e-4); 1e-2 leaves a wide margin and is still ~50x
# below the bf16 distance, so passing it says that distance is rounding, not
# a different function.
LLAMA_F32_ATOL = 1e-2
# Phase 11: the layouts.  11a: phase 4's GPT-2 for 5 steps and 8 eval
# batches (64 synthetic rows) per layout.
LAYOUT_ARGS = [a for a in MAIN_ARGS] + ["--steps-per-epoch", "5", "--num-examples", "64"]
LAYOUTS = {
    "plain": [], "bucket_mb_1": ["--bucket-mb", "1"], "overlap": ["--overlap"],
    "bf16_hook": ["--grad-compress", "bf16"],
    "powersgd_r4": ["--grad-compress", "powersgd", "--powersgd-rank", "4"],
    "zero1": ["--zero", "1"], "zero2": ["--zero", "2"], "zero3": ["--zero", "3"],
}
# --overlap reduces the same buckets as --bucket-mb 1 at one rank: the same
# f32 values, so its losses are the plain run's.  Under ZeRO the Linear
# weights are transposed views of the flat layout (the reference's element
# order), so cuBLAS gets the other operand layout and may sum the f32
# products in another order: ~1e-7 relative a product, and 5 AdamW steps at
# lr 3e-4 move the loss by far less than 1e-4 (a wrong reduction, a missing
# bucket or a stale shard moves it by more than 1e-2).
LAYOUT_ATOL = 1e-4
# 11b: phase 7's Llama without eval, its 10 steps, ZeRO-2 with f32 moments
# (the yardstick) and with low-bit ones.
LLAMA_ZERO_ARGS = [a for a in LLAMA_ARGS if a != "--eval"] + ["--zero", "2"]
# The deepest Llama with int8 moments and 5 GiB of the card's 79.18 GiB to
# spare, at one rank: f32 parameters 4 bytes a parameter, f32 gradients 4,
# two int8 moments ~2.0 (an f32 scale a 2048-block beside them): ~10 bytes a
# parameter against plain DP's 16.  A layer is 218.1 M parameters.  On an
# H100 80GB HBM3 (700 W) this phase measured 34.87 GiB at 8 layers and
# 70.52 GiB at 26, 1.98 GiB a layer (10 bytes a parameter are 2.03):
# 34.87 + 1.98 (L - 8) <= 74.18 gives L <= 27.8.
LLAMA_DEEP_LAYERS = 27
LLAMA_SPARE_GIB = 5.0

# Phase 12: context and tensor parallelism at Llama-3 8B's attention width
# (32 heads, 8 kv heads of 128, bf16).  12a runs parallel.context_parallel's
# own flash ring for every rank of a 4-way seq axis in this process (one
# thread a rank, the exchange in memory), at a global sequence of 8192
# (Llama-3 8B's max_seq_len, 2048 a rank: phase 7's), against one
# full-sequence K1-K3 call and against the ring's hops through the plain
# versions; again at 2048 against the plain versions; in f32 at GPT-2's
# heads (12 of 64) over 4096 on a 2-way axis; then the module's Ulysses
# (native at 4 ranks, the kv heads repeated at 16).  12b runs one Llama-3
# 8B block (d_model 4096, FFN 14336) as its two TP shards.
CP_RING = dict(B=1, Sq=8192, Skv=8192, H=32, Hkv=8, D=128, n=4, dtype="bfloat16")
CP_RING_PLAIN = dict(CP_RING, Sq=2048, Skv=2048)
CP_RING_F32 = dict(B=1, Sq=4096, Skv=4096, H=12, Hkv=12, D=64, n=2, dtype="float32")
ULYSSES_N = {"native_n4": 4, "expand_n16": 16}
TP_BLOCK = dict(B=1, S=2048, tp=2)
# Tolerances of 12a/12b, |x - ref| <= atol + rtol |ref| + slack max|ref|:
# - out: TOL.  The ring rounds each hop's output to bf16 (half an ulp of a
#   hop's value) before the f32 merge, then rounds once more; both stay
#   under TOL's bf16 bound, which covers a one-ulp difference.
# - lse: f32 in both, merged by logaddexp against one pass: TOL's f32.
# - dq, dk, dv: each hop's piece is rounded to bf16 and the pieces are
#   summed in bf16, one rounding per hop: up to n - 1 more half-ulp
#   roundings of the running sum than the oracle's one, each at most
#   2^-8 of the largest value: slack n 2^-8 of the largest value against
#   the full-sequence oracle, and (n - 1) 2^-8 of it against the plain
#   replay (the same sums of pieces each within TOL of the plain one, whose
#   n - 1 additions may each round one ulp apart).  Ulysses' repeated kv
#   heads (rep copies of one) get their dk/dv pieces rounded to bf16 and
#   summed: (rep - 1) 2^-8 of the largest value more.
# - 12b: the TP block sums two bf16 partials where the full block rounds
#   one f32 sum: up to 1.5 bf16 ulps of the largest partial before the
#   residual, carried through the next norm and MLP: 4 ulps (4 2^-8) of
#   each tensor's largest value, for the output and every gradient.
ULP_BF16 = 2.0 ** -8
# A replayed rank that waits this long for its neighbour's exchange fails
# the phase (hops take milliseconds).
EXCHANGE_TIMEOUT_S = 60
CP_TP_ENTRY_ARGS = [a for a in LLAMA_ARGS if a != "--eval"] + ["--steps-per-epoch", "3"]
CP_TP_ENTRY = {"cp2_ring": ["--cp", "2", "--cp-impl", "ring"], "cp2_ulysses": ["--cp", "2", "--cp-impl", "ulysses"],
               "cp2_ring_overlap": ["--cp", "2", "--cp-impl", "ring", "--overlap"], "tp2": ["--tp", "2"]}
# With four GPUs or more, also the 4-way ring (its masked hops skipped on
# three of the ranks) and CP x TP.
CP_TP_ENTRY_4 = {"cp4_ring": ["--cp", "4", "--cp-impl", "ring"], "cp2_tp2": ["--cp", "2", "--tp", "2"]}
# 12c: losses of the multi-GPU runs against one GPU's on the same global
# batch, bf16 activations through 8 layers, loss ~12.55: the sound runs on
# four H100s read gaps of 1.05e-3 to 3.04e-3 (the 2-way ring's, on its
# third step), so 1e-2 holds them with a margin of 3.
CP_TP_ENTRY_ATOL = 1e-2

# Phase 13: FSDP in an NCCL group of one (the gathers and scatters are
# copies: the path runs whole, and buys no memory on one card).  13a: phase
# 7's exact arguments (so the LR schedule, a function of the total steps,
# is phase 7's) plus --fsdp, then plus --fsdp-gather bf16.
FSDP_LLAMA = {"f32_gather": ["--fsdp"], "bf16_gather": ["--fsdp", "--fsdp-gather", "bf16"]}
# With one rank a gather is a copy and each gathered leaf a contiguous copy
# in the plain model's layout, so the step runs phase 7's cuBLAS calls and
# kernels on the same values and the losses should be phase 7's bit for
# bit (on the CPU the port's FSDP equals plain DP bit for bit at 1 and 2
# ranks); the bound is 1e-5, ~10 f32 ulps of a loss of 12.5.
FSDP_LOSS_ATOL = 1e-5
# bf16 gathers round every f32 master to bf16 before its use; the matrices
# were rounded per use anyway, so the norm scales and the embeddings change:
# the reference test's bound (tests/test_fsdp.py:326), relative.
FSDP_BF16_RTOL = 2e-2
# 13b: phase 4's GPT-2 at 11a's size (5 steps, 8 eval batches) under
# --fsdp, checkpointed, then --generate 16 through the host gather; its
# losses against 11a's plain run within LAYOUT_ATOL.
FSDP_GPT2_ARGS = LAYOUT_ARGS + ["--fsdp", "--generate", "16", "--checkpoint-dir", "{ckpt}"]
# 13c, with four GPUs or more: Llama-3 8B at all 32 layers under --fsdp (3
# steps, each card keeping 1/4 of the 8.03 B parameters' 16 bytes), and at
# 8 layers against plain DP on the same four GPUs (the same global batch of
# 4 x 2 rows; bf16 activations through 8 layers, 12c's bound).
FSDP_DEEP_ARGS = [a for a in LLAMA_ARGS if a != "--eval"] + ["--steps-per-epoch", "3"]
FSDP_ENTRY_GPUS = 4

# Phase 14: mixture of experts.  14a: Llama-3 8B's widths (phase 7's flags:
# bf16 on f32 params, remat, AdamW, 10 steps and the eval pass) with
# Mixtral 8x7B's expert count and top-k (8 experts, top 2, token choice at
# capacity factor 1.25), cut to 1 layer: the embedding and the untied head
# are 1.05 B parameters, the block 1.45 B (1.41 B of experts), 2.50 B at 16
# bytes a parameter ~40 GB; 2 layers (3.95 B, ~63 GB of state) leave no
# room for AdamW's temporaries and the activations on an 80 GB card.
MOE_LAYERS = 1
MOE_FLAGS = ["--moe-experts", "8", "--moe-top-k", "2", "--moe-capacity-factor", "1.25"]


def _set(args, flag, value):
    out = list(args)
    out[out.index(flag) + 1] = value
    return out


LLAMA_MOE_ARGS = _set(LLAMA_ARGS, "--layers", str(MOE_LAYERS)) + MOE_FLAGS
# 14b: phase 4's GPT-2 at 11a's size (12 layers, f32, GELU) with 8 experts
# top-2 in dense dispatch (every token through every expert: exact, so the
# continuation holds to the trained whole model), then --generate 16.
GPT2_MOE_ARGS = LAYOUT_ARGS + ["--moe-experts", "8", "--moe-top-k", "2", "--generate", "16"]
# 14c, with two GPUs or more (four for the last three): 14a's model at
# capacity factor 8 (= E: no token dropped, so every layout computes the
# same function) for 3 steps, one data replica: the global batch is the
# one-GPU run's.  The all-to-all's time comes from a trace of steps 1-2.
MOE_ENTRY_ARGS = _set(_set([a for a in LLAMA_MOE_ARGS if a != "--eval"], "--moe-capacity-factor", "8"),
                      "--steps-per-epoch", "3")
MOE_ENTRY = {"ep2": (["--ep", "2"], 2), "ep4": (["--ep", "4"], 4), "ep2_tp2": (["--ep", "2", "--tp", "2"], 4),
             "cp2_ep2": (["--cp", "2", "--ep", "2"], 4)}
# Their losses against one GPU's (loss ~12.58): bf16 activations, the expert
# GEMMs at other row counts (cuBLAS may sum in other orders) and, under
# --tp / --cp, 12c's partial sums.  The first four-card run on H100s read gaps
# of 2.30e-4 (--ep 2) to 5.23e-3 (--ep 2 --tp 2) over 3 steps, so 1.6e-2
# holds them with a margin of 3, as 12c's bound does.
MOE_ENTRY_ATOL = 1.6e-2

# Phase 15: pipeline parallelism.  15a and 15b replay the module's own
# schedule code (parallel.pipeline_parallel.run_schedule) with every stage a
# thread of this process and the exchange in memory (LocalPipe), against the
# unpipelined model's step on the same weights and batch.  15a: GPT-2 124M
# at full width and all 12 layers (f32), phase 4's batch of 8 x 1024, M = 8,
# on 2 and 4 stages.  The pipelined loss is the mean of 8 microbatch means
# where the oracle takes one mean over the batch, and every GEMM runs at 1/8
# of the rows (cuBLAS may sum in another order): f32 summation order only,
# ~1e-6 relative; the bounds are 1e-5 of the loss and 1e-4 of each
# gradient's largest |value|.  A missing or doubled pipe sum moves the
# embedding's gradient by half of itself, a wrong stage slice every layer's.
PP_GPT2 = dict(B=8, S=1024, M=8)
PP_F32_TOL = dict(loss_rtol=1e-5, grad_rtol=1e-4)
# 15a's runs, (stages, schedule, virtual chunks a stage): GPipe, 1F1B and zb
# on 2 and 4 stages, and interleaved 1F1B on 2 stages at 3 and 2 layers a
# chunk.  zb's gradients are held to 1F1B's on the same stages within
# PP_F32_TOL (the same GEMMs in the same order: equal on the CPU; cuBLAS
# may pick another algorithm for a call on the card).
PP_GPT2_RUNS = [(2, "gpipe", 1), (2, "1f1b", 1), (2, "zb", 1), (2, "1f1b", 2), (2, "1f1b", 3),
                (4, "gpipe", 1), (4, "1f1b", 1), (4, "zb", 1)]
# 15d: 15a's weights and batch under --pp 2 --cp 2, ring and Ulysses inside
# each stage, GPipe and 1F1B, four threads; f32, so PP_F32_TOL.
PP_CP = dict(n=2, cp=2, impls=("ring", "ulysses"), schedules=("gpipe", "1f1b"))
# 15b: phase 7's Llama-3 8B width x 8 layers (bf16, remat) at 8 x 2048 on 2
# stages (4 layers each; the memory reckoning is in PERF.md), M = 4 and 8.
# bf16 GEMMs at other row counts round elsewhere.  The first run on an H100
# 80GB HBM3 (700 W) read loss errors of 0 and gradient errors of 5.60e-3
# (M = 4) and 4.53e-3 (M = 8) of each gradient's largest |value|: the
# bounds are 2e-2 (a margin of 3.6) and the CPU tests' 2e-3 on the loss.
PP_LLAMA = dict(B=8, S=2048, n=2, M=(4, 8))
PP_BF16_TOL = dict(loss_atol=2e-3, grad_rtol=2e-2)
# 15b's runs at M = 8 after GPipe and 1F1B: zb (its gradients against
# 1F1B's, whose copy the run holds), then 1F1B with 2 chunks a stage over
# the same parameter tensors (``restage``).
PP_LLAMA_MORE = (("zb", 1), ("1f1b", 2))
# 15c, with two GPUs or more: the entry point over NCCL.  With four,
# Llama-3 8B at all 32 layers under --pp 4 (GPipe and 1F1B, 8 x 2048, M = 8,
# 3 steps, eval, steps 1-2 traced), and at 8 layers --pp 4, --pp 2 --tp 2
# against one GPU on 4 x 2048 (M = 4), and --pp 2 --ep 2 at 14a's MoE
# config (2 layers, capacity factor 8) against --ep 2; with two, --pp 2 at 8
# layers against one GPU.  The losses' bound is 12c's (bf16 through 8
# layers; set from four H100s' gaps).
PP_DEEP_ARGS = _set(_set(_set(_set(LLAMA_ARGS, "--layers", "32"), "--batch-size", "8"), "--steps-per-epoch", "3"),
                    "--num-examples", "32") + ["--pp-microbatches", "8"]
PP_ENTRY_ARGS = _set(_set([a for a in LLAMA_ARGS if a != "--eval"], "--batch-size", "4"), "--steps-per-epoch", "3")
PP_MOE_ARGS = _set(_set(MOE_ENTRY_ARGS, "--layers", "2"), "--batch-size", "2")
PP_ENTRY_ATOL = CP_TP_ENTRY_ATOL
# 15c+: zb, virtual stages and PP x CP over NCCL against one GPU on
# PP_ENTRY_ARGS (M = 2), steps 1-2 traced for each rank's P2P wait; name ->
# (flags, GPUs).  --pp 2 --pp-virtual 2 puts a stage's two messages to its
# one peer in each exchange (the wrap link's posting order).
PP_ENTRY_16B = {
    "pp2_v2": (["--pp", "2", "--pp-schedule", "1f1b", "--pp-virtual", "2"], 2),
    "pp2_zb": (["--pp", "2", "--pp-schedule", "zb"], 2),
    "pp2_cp2_ring": (["--pp", "2", "--cp", "2", "--cp-impl", "ring"], 4),
    "pp2_cp2_ulysses": (["--pp", "2", "--cp", "2", "--cp-impl", "ulysses"], 4),
}

# Phase 16: bounded dispatch and the warm start.  16a: phase 4's GPT-2 and
# phase 6's ResNet-18 (20 steps) at --dispatch-depth 0 and 2 (the step and
# wall ms; ResNet-18, whose host time varies by several ms from run to run,
# in the order 0, 2, 2, 0), then each once more at each depth with steps
# 3-5 (of 6) and 10-19 traced for the device's idle share (a traced run's
# wall clock holds the trace's export);
# ResNet-18 under cuDNN's
# deterministic algorithms at both depths (its default weight-gradient
# kernels sum with atomics, so two runs differ in the last bits whatever
# the depth, RESUME_ATOL above), so the losses compare bit for bit.
DEPTH_RUNS = {"gpt2_phase4": (FAULT_LM_ARGS, ["--steps-per-epoch", "6", "--profile-steps", "3:6"], (0, 2)),
              "resnet18_phase6": (FAULT_R18_ARGS + ["--epochs", "1", "--steps-per-epoch", "20"],
                                  ["--profile-steps", "10:20"], (0, 2, 2, 0))}
# 16b: phase 4's GPT-2 under --nan-guard at depth 2, its loss poisoned at
# step GUARD_POISON (chaos nan-grad needs a float input; GPT-2's are token
# ids), every step under sync debug mode "error"; then the
# guard's cost, with the same fused AdamW on and off (runs off, on, on, off).
GUARD_ARGS = FAULT_LM_ARGS + ["--nan-guard", "--dispatch-depth", "2"]
GUARD_POISON = 3
# 16c reads phase 9a's supervised restart, which runs under the script's
# --compile-cache.

# Phase 17: the serving fleet at GPT-2 124M's full width (bf16 cast once
# from the f32 init, max_seq_len 1024, blocks of 16).  17a: a 1:2 fleet in
# this process under a VirtualClock (FLEET_DT a step): FLEET_BASE prompts at
# t=0 (64, 128, 256 and 400 end on a block, the rest mid-block), then a
# second turn of each at t=1 s extending it by FLEET_TURN tokens (the
# router's affinity pins it to the decode engine holding the first turn's
# blocks), FLEET_NEW tokens each; a second run corrupts one frame and kills
# decode-0 at fleet step FLEET_KILL_STEP.  One GPT-2 block: 16 positions x 12
# heads x 64 x 2 bytes (bf16) x 2 (k, v) x 12 layers.
FLEET_ENGINE = dict(num_slots=8, num_blocks=256, block_size=16, prefill_chunk=128, prefix_cache=True)
FLEET_BASE = (64, 77, 128, 200, 256, 333, 400, 511)
FLEET_TURN, FLEET_NEW, FLEET_DT, FLEET_KILL_STEP = 24, 32, 0.01, 12
FLEET_BLOCK_BYTES = 16 * 12 * 64 * 2 * 2 * 12
# 17b: the multi-process fleet through its CLI, three engine processes on
# the card (the smoke keeps --model and --seq-len).
FLEET_ARGS = ["--fleet", "1:2", "--model", "gpt2_124m", "--seq-len", "1024", "--prefix-cache", "--turns", "3",
              "--kill-engine", "auto", "--smoke", "--events-dir", "{events}"]

# Phase 18: resharding on resume.  18a's gang: two CPU gloo ranks (started
# with phase 11, beside phases 11-17) train GPT-2 124M at
# full width under --zero 1 with AdamW, batch 1 a rank at sequence 128, 2
# epochs of 2 steps, and checkpoint each epoch.  The card resumes their
# epoch-0 checkpoint at world 1 with batch 2 (the same global batch, the
# same rows in the same order) for epoch 1's 2 steps.  Its losses against
# the gang's steps 3-4: f32 on both, in another reduction order (the two
# ranks' gradient mean against one card's sum, K1-K3 against the CPU's
# plain attention): 1e-5 on a loss of ~10.9, ten f32 ulps there (the
# readings were 9.5e-7 and 0.0).  ``--elastic-faults`` plants a fault in
# the checkpoint (the moments zeroed, the step counts reset) and shows that
# each lands above it.
ELASTIC_CPU_ARGS = ["--device", "cpu", "--fake-devices", "2", "--model", "gpt2", "--seq-len", "128",
                    "--vocab-size", "50257", "--batch-size", "1", "--optimizer", "adamw", "--lr", "3e-4",
                    "--zero", "1", "--epochs", "2", "--steps-per-epoch", "2", "--num-examples", "64"]
ELASTIC_CARD_ARGS = _set(ELASTIC_CPU_ARGS[4:], "--batch-size", "2")
# The gang runs on 2 of the host's cores (one thread a rank), and this
# process and the ones it starts keep to the others while it runs.
ELASTIC_CPU_CORES = 2
ELASTIC_LOSS_ATOL = 1e-5
# 18c (2+ GPUs): GPT-2 124M at sequence 256, batch 2 a rank, 2 epochs of 4
# steps; the kill of member 2 after step 3, the last of epoch 0, and after
# step 1, mid-epoch, at dispatch depth 2 (the hosts run up to two steps
# apart).
ELASTIC_ENTRY_ARGS = _set(_set(ELASTIC_CARD_ARGS, "--seq-len", "256"), "--steps-per-epoch", "4")
ELASTIC_ENTRY_ATOL = 1e-4  # --fsdp --tp 2 at data 2 against data 1: f32, another reduction order

# Phase 19: the silent-data-corruption defence.  19a: GPT-2 124M at phase
# 4's model and batch (f32, B=8, S=1024, AdamW), 8 steps at dispatch depth 2
# under the guard, with the digest every 2 steps and the shadow re-run of
# each cadence step, against the same run without integrity: the losses
# bit for bit (the shadow compares two runs of one step bit for bit, so the
# step must be deterministic on the card; nothing is loosened).  Off-cadence
# step INTEGRITY_SYNC_STEP runs under sync debug "error".  Then a transient
# fault is planted in the shadow's copy of step INTEGRITY_PLANT_STEP's input
# (``integrity.apply_bitflip`` on the copy): one ``sdc_detect`` by
# ``shadow`` and the live run's losses unchanged.
INTEGRITY_PLAIN_ARGS = _set(FAULT_LM_ARGS, "--steps-per-epoch", "8") + ["--nan-guard", "--dispatch-depth", "2"]
INTEGRITY_ARGS = INTEGRITY_PLAIN_ARGS + ["--integrity-every", "2", "--integrity-shadow"]
INTEGRITY_SYNC_STEP = 3
INTEGRITY_PLANT_STEP = 4
INTEGRITY_PLANT_STEPS = 6
# 19b (4 GPUs), 2 epochs of 6 steps under --zero 1 --elastic
# --integrity-every 2 --nan-guard: rank 2's parameters flipped before step 4
# (caught at that cadence step), a new process for it taken back before
# step 6, epoch 1's first.  GPT-2 124M at phase 4's width and batch (B=8 a
# rank) carries the flip and the grow (the live ZeRO-1 reshard and the
# joiner's state transfer at that size), its epoch 1 against a 4-card
# --resume of its own epoch-0 checkpoint, written on 3 cards.  The
# control, which skips step 4 by a NaN and kills member 2 after it, needs
# a float batch (an LM's tokens are not; both packages refuse it), so the
# flip run's checkpoints are held bitwise to the control's on the
# reference's acceptance model, ``--model mlp`` at batch 32 a rank.
INTEGRITY_ENTRY_FLAGS = ["--zero", "1", "--elastic", "--integrity-every", "2", "--nan-guard", "--log-every", "1000"]
INTEGRITY_GPT2_ARGS = _set(_set(FAULT_LM_ARGS, "--steps-per-epoch", "6"), "--epochs", "2") + INTEGRITY_ENTRY_FLAGS
INTEGRITY_ENTRY_ARGS = ["--model", "mlp", "--batch-size", "32", "--optimizer", "adamw", "--lr", "1e-3",
                        "--epochs", "2", "--steps-per-epoch", "6", "--num-examples", "1024"] + INTEGRITY_ENTRY_FLAGS
INTEGRITY_ENTRY_CHAOS = {"flip": "bitflip@4:2,worker-join@6:2", "control": "nan-grad@4,worker-kill@4:2,worker-join@6:2"}

# Phase 20: the autotuner and the probes.  20a: phase 4's GPT-2 124M (S=1024,
# f32, AdamW, B=8 the CLI's baseline) under --autotune search over the
# reference's default LM space (batch 1/2/4 x accum 1/2 x remat x ZeRO 0/1/2
# x f32/bf16 moments x bucket None/4 MB), the top 3 by predicted throughput
# and the baseline measured for 4 steps each after one accounted apart; then
# 4 training steps with the winner and the eval of 64 examples; then the same
# run under --autotune apply with --bw-probe (20b) over the same store.
TUNE_ARGS = _set(FAULT_LM_ARGS, "--steps-per-epoch", "4") + [
    "--num-examples", "64", "--eval", "--tune-trials", "3", "--tune-steps", "4"]
TUNE_LAYERS = 12
TUNE_TRIAL_STEPS = 1 + 4  # each measured trial's steps: the first, then the window
# The reference's space holds trials its step factory refuses (zero=1 with a
# bucket size; its problems() does not foresee it): they are recorded with
# the reference's own status, and launch nothing.
TUNE_REFUSED = "error: ValueError: zero=1 does its own reduction"
# 20c (2+ GPUs): --bw-probe over every GPU (a short MLP run), and
# overlap_probe at GPT-2 124M's width (B=8 a rank, S=1024, AdamW), its plain
# step and its --overlap step, with a 64 MB all-reduce beside.
TUNE_ENTRY_ARGS = ["--model", "mlp", "--dataset", "synthetic", "--batch-size", "8", "--num-examples", "256",
                   "--epochs", "1", "--steps-per-epoch", "2", "--bw-probe"]
OVERLAP_PROBE = dict(B=8, S=1024, iters=5, cfg={})  # cfg: overrides of gpt2_124m (none on the card)

DEVICE = "cuda"  # phases 10, 12, 15, 16 and 17's device

KERNELS = [
    # name, replaces, matmuls per visible (q, k) pair
    ("flash_fwd", "distributeddataparallel_tpu/ops/pallas_attention.py:190", 2),
    ("flash_bwd_dq", "distributeddataparallel_tpu/ops/pallas_attention.py:394", 3),
    ("flash_bwd_dkv", "distributeddataparallel_tpu/ops/pallas_attention.py:421", 4),
]
SOURCE = "distributeddataparallel_tpu_torch/csrc/flash_attention.cu"


def log(*a):
    print(*a, flush=True)


def ptxas_report(build_log: str) -> list[str]:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output:
    template arguments, registers and spills."""
    out, name = [], None
    for line in build_log.splitlines():
        if line.startswith("#"):
            out.append(line.strip())
        m = re.search(r"Compiling entry function '.*\d(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(.*?)EEvNS", line)
        if m:
            args = m.group(2).replace("13__nv_bfloat16", "bf16").replace("Li", ",").replace("E", "")
            name = f"{m.group(1)}<{args.replace('f,', 'float,', 1) if args.startswith('f') else args}>"
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
            name = None
    return out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def inputs(torch, c, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = getattr(torch, c["dtype"])
    mk = lambda S, H: torch.randn(c["B"], S, H, c["D"], generator=g, device=DEVICE).to(dt)
    return mk(c["Sq"], c["H"]), mk(c["Skv"], c["Hkv"]), mk(c["Skv"], c["Hkv"]), mk(c["Sq"], c["H"])


def check_case(torch, fa, name, c, seed):
    """K1 (out, lse) and K2/K3 (dq, dk, dv through FlashAttention's backward)
    against the plain versions on the same inputs: the plain backward gets
    the (out, lse) that K1 gave the kernels.  Returns max abs errors."""
    q, k, v, do = inputs(torch, c, seed)
    causal = c["causal"]
    out, lse = fa.flash_fwd(q, k, v, causal)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention(qg, kg, vg, causal).backward(do)
    ref = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_plain(q, k, v, out, lse, do, causal)))
    got = {"out": out, "lse": lse, "dq": qg.grad, "dk": kg.grad, "dv": vg.grad}
    ref.update(out=ref_out, lse=ref_lse)
    torch.cuda.synchronize()
    errs = {}
    for key, x in got.items():
        atol, rtol = TOL["float32" if key == "lse" else c["dtype"]]
        a, b = x.float(), ref[key].float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: {key} has non-finite values")
        errs[key] = float((a - b).abs().max())
        bad = (a - b).abs() > atol + rtol * b.abs()
        if bad.any():
            raise AssertionError(
                f"{name}: {key} disagrees with the plain version at {int(bad.sum())} "
                f"entries (max abs err {errs[key]:.3e}, atol {atol}, rtol {rtol})"
            )
    log(f"  {name}: ok  " + "  ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    return errs


def time_ms(torch, fn, iters, warmup=3):
    """(device ms, host ms) per call over ``iters`` calls after warm-up.

    The timed calls are enqueued behind a spin kernel, so the CUDA events
    around them time the device's work back to back: without it, a host
    slower than the device (Python and launch cost per call, a CPU shared
    with other jobs) leaves gaps that the events count.  The host's time to
    enqueue a call is returned beside; a spin that ends before the host is
    done is lengthened and the timing taken again."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for cycles in (SPIN_CYCLES, 8 * SPIN_CYCLES):
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        end.record()
        covered = not start.query()  # the spin still held the stream
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters, host_ms
    raise RuntimeError(f"time_ms: the host took {host_ms:.3f} ms per call, longer than the spin")


def visible_pairs(c) -> int:
    """(q, k) pairs the mask leaves visible per (batch, head)."""
    Sq, Skv = c["Sq"], c["Skv"]
    if not c["causal"]:
        return Sq * Skv
    off = Skv - Sq
    return sum(min(off + i + 1, Skv) for i in range(Sq))


def bound(c, matmuls, bytes_moved, peak_flops=None):
    """Least time (ms) for the work and what sets it: the visible pairs'
    operations at the dtype's peak, or the bytes at the memory rate."""
    flops = 2 * c["D"] * visible_pairs(c) * c["B"] * c["H"] * matmuls
    t_ops = flops / (peak_flops or PEAK_FLOPS[c["dtype"]]) * 1e3
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def measure(torch, fa, c, seed, names):
    """Kernel, plain and library times of the named kernels at shapes c."""
    import torch.nn.functional as F

    q, k, v, do = inputs(torch, c, seed)
    causal = c["causal"]
    out, lse = fa.flash_fwd(q, k, v, causal)
    delta = fa.attention_delta(out, do)
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)

    # Library yardstick: SDPA on (B, H, S, D) views, forward and backward.
    gqa = c["Hkv"] != c["H"]
    ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_fwd = lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=gqa)
    o_lib = lib_fwd()
    do_l = do.transpose(1, 2)
    lib_bwd = lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do_l, retain_graph=True)
    lib_fwd_times = time_ms(torch, lib_fwd, 20)  # (device ms, host ms)
    lib_bwd_times = time_ms(torch, lib_bwd, 20)

    runs = {
        "flash_fwd": (
            lambda: fa.flash_fwd(q, k, v, causal),
            lambda: fa.flash_fwd_plain(q, k, v, causal),
            nbytes(q, k, v, out, lse), lib_fwd_times,
            "F.scaled_dot_product_attention forward",
        ),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal),
            nbytes(q, k, v, do, lse, delta, dq), lib_bwd_times,
            "F.scaled_dot_product_attention backward (dq, dk and dv together)",
        ),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal),
            nbytes(q, k, v, do, lse, delta, dk, dv), lib_bwd_times,
            "F.scaled_dot_product_attention backward (dq, dk and dv together)",
        ),
    }
    res = {}
    for name, replaces, matmuls in KERNELS:
        if name not in names:
            continue
        kern, plain, nb, (lib_ms, lib_host_ms), lib_call = runs[name]
        b_ms, b_by = bound(c, matmuls, nb)
        ms, host_ms = time_ms(torch, kern, 20)
        res[name] = {
            "ms": ms,
            "host_ms": host_ms,
            "plain_ms": time_ms(torch, plain, 5)[0],
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_ms,
            "library_host_ms": lib_host_ms,
            "library_call": lib_call,
            "bytes": nb,
        }
        if c["dtype"] == "float32":
            res[name]["bound_cuda_core_ms"] = bound(c, matmuls, nb, PEAK_F32_CUDA_CORES)[0]
        log(f"  {name}: {ms:.3f} ms (host {host_ms:.3f}; plain {res[name]['plain_ms']:.3f}, "
            f"library {lib_ms:.3f} (host {lib_host_ms:.3f}), bound {b_ms:.3f} by {b_by})")
    return res


def step_flops(torch, model, batch_shape) -> int:
    """FLOPs of one forward and backward (the convolutions and matmuls), as
    ``torch.utils.flop_counter`` counts them, on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        model(torch.empty(batch_shape, device="meta")).sum().backward()
    return counter.get_total_flops()


def bn_buffer_check(torch) -> dict:
    """The port's BatchNorm buffers after one train-mode call on the card,
    against the biased statistics (``BN_SHAPES``); max error over the
    tolerance's scale, per shape."""
    from distributeddataparallel_tpu_torch.models.layers import BatchNorm

    g = torch.Generator(device="cuda").manual_seed(7)
    errs = {}
    for shape in BN_SHAPES:
        c = shape[1]
        bn = BatchNorm(c, device="cuda")
        bn.reset_parameters()
        bn.running_mean.uniform_(-1.0, 1.0, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
        old = (bn.running_mean.double(), bn.running_var.double())
        std = torch.rand(c, 1, 1, device="cuda", generator=g) * 1.5 + 0.5
        mean = torch.rand(c, 1, 1, device="cuda", generator=g) * 2.0 - 1.0
        x = torch.randn(shape, device="cuda", generator=g) * std + mean
        bn.train()
        bn(x.contiguous(memory_format=torch.channels_last))
        var, mu = torch.var_mean(x.double(), dim=(0, 2, 3), unbiased=False)
        worst = 0.0
        for got, o, batch in ((bn.running_mean, old[0], mu), (bn.running_var, old[1], var)):
            want = 0.9 * o + 0.1 * batch
            worst = max(worst, float(((got.double() - want).abs() / (BN_RTOL * want.abs() + BN_ATOL)).max()))
        errs["x".join(map(str, shape))] = worst
        if not worst <= 1.0:
            raise AssertionError(f"BatchNorm buffers at {shape}: error {worst:.2f} x the tolerance")
    return errs


def resnet50_phase(torch, dpp, fa, smi):
    """[5] ResNet-50 at the ImageNet shape on synthetic shards."""
    from distributeddataparallel_tpu_torch.data.sharded import write_synthetic_image_shards
    from distributeddataparallel_tpu_torch.models.resnet import ResNet50

    with tempfile.TemporaryDirectory(prefix="r50_shards_") as root:
        t0 = time.perf_counter()
        for split, rows in R50_ROWS.items():
            write_synthetic_image_shards(os.path.join(root, split), rows, (224, 224, 3), 1000,
                                         seed=0 if split == "train" else 1)
        log(f"[5] resnet50: shards {R50_ROWS} of 224x224x3 written in {time.perf_counter() - t0:.1f} s")
        args = [a.format(root=root) for a in R50_ARGS]
        log("    dpp.main " + " ".join(args))
        fa.reset_launches()
        summary = dpp.main(args)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
    losses, batch = summary["losses"], 64
    flops = step_flops(torch, ResNet50(num_classes=1000, device="meta"), (batch, 224, 224, 3))
    bound_ms = flops / PEAK_F32_CUDA_CORES * 1e3
    step_ms = summary["step_time_s"] * 1e3
    log(f"    losses {['%.4f' % x for x in losses]}; eval {summary['eval']}; attention launches {launches}")
    if summary["train_steps"] != 10 or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"resnet50: {summary['train_steps']} steps, losses {losses}")
    if summary["eval"] is None or not math.isfinite(summary["eval"]["loss"]):
        raise AssertionError(f"resnet50: eval {summary['eval']}")
    if any(launches.values()):
        raise AssertionError(f"resnet50: attention kernels launched {launches}")
    bn_err = bn_buffer_check(torch)
    log(f"    BatchNorm buffers vs biased var_mean, error / tolerance: {bn_err}")
    log(f"    step {step_ms:.1f} ms (first {summary['first_step_time_s']:.2f} s), "
        f"{summary['images_per_s']:.0f} images/s; with the loader, "
        f"{summary['wall_step_time_s'] * 1e3:.1f} ms and {summary['images_per_s_wall']:.0f} images/s; peak memory "
        f"{summary['peak_memory_bytes'] / 2**30:.2f} GiB; {flops / 1e9:.1f} GFLOP a step, "
        f"bound {bound_ms:.2f} ms at 67 TFLOP/s f32 ({bound_ms / step_ms:.1%} of it reached) on {smi}")
    return {
        "args": R50_ARGS, "train_steps": summary["train_steps"], "losses": losses,
        "eval": summary["eval"], "eval_batches": summary["eval_batches"], "step_ms": step_ms,
        "first_step_s": summary["first_step_time_s"], "images_per_s": summary["images_per_s"],
        "wall_step_ms": summary["wall_step_time_s"] * 1e3, "images_per_s_wall": summary["images_per_s_wall"],
        "peak_memory_bytes": summary["peak_memory_bytes"], "step_flops": flops,
        "bn_buffers_err_over_tol": bn_err, "bn_tol": {"rtol": BN_RTOL, "atol": BN_ATOL},
        "bound_ms_f32_cuda_cores": bound_ms, "bound_share": bound_ms / step_ms,
        "attention_launches": launches, "num_params": summary["num_params"],
    }


def resnet18_resume_phase(torch, dpp, fa, smi):
    """[6] ResNet-18 CIFAR: 2 epochs with checkpoints, --resume to 3, and an
    uninterrupted 3-epoch run."""
    with tempfile.TemporaryDirectory(prefix="r18_ckpt_") as ckpt:
        fa.reset_launches()
        runs = {}
        for name, extra in (
            ("first", ["--epochs", "2", "--checkpoint-dir", ckpt]),
            ("resumed", ["--epochs", "3", "--checkpoint-dir", ckpt, "--resume"]),
            ("straight", ["--epochs", "3"]),
        ):
            log(f"[6] resnet18 {name}: dpp.main " + " ".join(R18_ARGS + extra))
            runs[name] = dpp.main(R18_ARGS + extra)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
    first, resumed, straight = runs["first"], runs["resumed"], runs["straight"]
    epoch2 = straight["losses"][20:]
    diff = max(abs(a - b) for a, b in zip(resumed["losses"], epoch2))
    log(f"    resumed at epoch {resumed['start_epoch']}: losses {['%.4f' % x for x in resumed['losses']]}")
    log(f"    uninterrupted epoch 2:  {['%.4f' % x for x in epoch2]}; max |diff| {diff:.2e} "
        f"(atol {RESUME_ATOL}); attention launches {launches}")
    if (first["train_steps"], resumed["train_steps"], straight["train_steps"]) != (20, 10, 30):
        raise AssertionError(f"resnet18 steps {first['train_steps']}, {resumed['train_steps']}, "
                             f"{straight['train_steps']}")
    if resumed["start_epoch"] != 2 or not diff <= RESUME_ATOL:
        raise AssertionError(f"resnet18 resume: start epoch {resumed['start_epoch']}, max diff {diff}")
    if not all(math.isfinite(x) for x in straight["losses"]) or not math.isfinite(straight["eval"]["loss"]):
        raise AssertionError(f"resnet18: losses {straight['losses']}, eval {straight['eval']}")
    if any(launches.values()):
        raise AssertionError(f"resnet18: attention kernels launched {launches}")
    log(f"    uninterrupted: step {straight['step_time_s'] * 1e3:.2f} ms, "
        f"{straight['images_per_s']:.0f} images/s, eval {straight['eval']} on {smi}")
    return {
        "args": R18_ARGS, "start_epoch": resumed["start_epoch"], "resumed_losses": resumed["losses"],
        "uninterrupted_epoch2_losses": epoch2, "max_abs_diff": diff, "atol": RESUME_ATOL,
        "step_ms": straight["step_time_s"] * 1e3, "images_per_s": straight["images_per_s"],
        "wall_step_ms": straight["wall_step_time_s"] * 1e3, "images_per_s_wall": straight["images_per_s_wall"],
        "peak_memory_bytes": straight["peak_memory_bytes"], "eval": straight["eval"],
        "attention_launches": launches,
    }


def lm_step_flops(cfg, B: int, S: int) -> tuple[int, int]:
    """(FLOPs of one train step as the port runs it, the same without the
    recompute): the matmuls, 2 per multiply-add; forward 1, backward 2 and,
    under remat, the layers' recompute 1 more.  Attention counts each
    kernel's products per visible pair as ``KERNELS`` does (K1 2, K2 3,
    K3 4), K1 twice under remat."""
    d, H, Hkv, D, F, V, L = (cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.dims_per_head,
                             cfg.d_ff, cfg.vocab_size, cfg.num_layers)
    layer = 2 * d * H * D + 2 * d * Hkv * D + (3 if cfg.activation == "swiglu" else 2) * d * F
    tokens = B * S
    pairs = visible_pairs(dict(Sq=S, Skv=S, causal=True)) * B * H * 2 * D * L
    passes = 4 if cfg.remat else 3
    run = 2 * tokens * (layer * L * passes + d * V * 3) + pairs * (2 * (passes - 2) + 3 + 4)
    model = 2 * tokens * (layer * L + d * V) * 3 + pairs * (2 + 3 + 4)
    return run, model


def head_check(torch, tfm) -> dict:
    """The LM head of a full-width Llama (one layer) on the card: its logits
    are f32 and not bf16 values; then ``f32_logits``' forward and backward
    at the head's shapes against the CPU formula (``HEAD_*`` above)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    cfg = tfm.llama3_8b(num_layers=1, max_seq_len=HEAD_ROWS)
    model = tfm.TransformerLM(cfg, device="cuda", generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (1, HEAD_ROWS), device="cuda", generator=g)
    with torch.no_grad():
        logits = model(tokens)
    off_bf16 = float((logits != logits.to(torch.bfloat16).float()).float().mean())
    if logits.dtype != torch.float32 or not off_bf16 > 0.5:
        raise AssertionError(f"LM head: logits {logits.dtype}, {off_bf16:.1%} of them not bf16 values")
    w = model.lm_head.weight.detach().clone().requires_grad_()
    del model, logits
    x = torch.randn(HEAD_ROWS, cfg.d_model, device="cuda", generator=g).to(torch.bfloat16).requires_grad_()
    out = tfm.f32_logits(x, w, torch.bfloat16)
    gout = torch.randn(out.shape, device="cuda", generator=g) / out.shape[1] ** 0.5
    out.backward(gout)
    wb = w.detach().to(torch.bfloat16).float()
    ref = x.detach().float() @ wb.t()
    errs = {"logits": float((out.detach() - ref).abs().max())}
    atol, rtol = HEAD_FWD_TOL
    if out.dtype != torch.float32 or ((out.detach() - ref).abs() > atol + rtol * ref.abs()).any():
        raise AssertionError(f"LM head forward: {out.dtype}, max abs err {errs['logits']:.3e}")
    for name, got, want in (("dx", x.grad, (gout @ wb).to(torch.bfloat16)),
                            ("dw", w.grad, (gout.t() @ x.detach().float()).to(torch.bfloat16))):
        err = float((got.float() - want.float()).abs().max())
        errs[name] = err
        if not err <= HEAD_BWD_RTOL * float(want.float().abs().max()):
            raise AssertionError(f"LM head backward {name}: max abs err {err:.3e}")
    return {"logits_not_bf16_share": off_bf16, "max_abs_err": errs, "rows": HEAD_ROWS}


def llama_phase(torch, dpp, fa, tfm, smi) -> dict:
    """[7] Llama-3 8B width, LLAMA_LAYERS layers, bf16, remat."""
    torch.cuda.empty_cache()
    cfg = dpp.build_config(dpp.parse_args(LLAMA_ARGS))
    width = dict(d_model=4096, num_heads=32, kv_heads=8, dims_per_head=128, d_ff=14336,
                 vocab_size=128256, num_layers=LLAMA_LAYERS, dtype=torch.bfloat16, remat=True,
                 tie_embeddings=False)
    if any(getattr(cfg, k) != v for k, v in width.items()):
        raise AssertionError(f"llama config {cfg} is not Llama-3 8B's width")
    log("[7] llama-3 8B width: dpp.main " + " ".join(LLAMA_ARGS))
    fa.reset_launches()
    summary = dpp.main(LLAMA_ARGS)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    losses, steps, evals = summary["losses"], summary["train_steps"], summary["eval_batches"]
    L = LLAMA_LAYERS
    expect = {"flash_fwd": L * (2 * steps + evals), "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps}
    log(f"    losses {['%.4f' % x for x in losses]}; eval {summary['eval']}")
    log(f"    launches {launches}, expected {expect}")
    if steps != 10 or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"llama: {steps} steps, losses {losses}")
    if summary["eval"] is None or not math.isfinite(summary["eval"]["loss"]):
        raise AssertionError(f"llama: eval {summary['eval']}")
    if launches != expect:
        raise AssertionError(f"llama launches {launches} != expected {expect}")
    head = head_check(torch, tfm)
    log(f"    LM head: {head}")
    flops, model_flops = lm_step_flops(cfg, 2, 2048)
    step_ms = summary["step_time_s"] * 1e3
    bound_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    log(f"    step {step_ms:.1f} ms (first {summary['first_step_time_s']:.2f} s), "
        f"{summary['tokens_per_s']:.0f} tokens/s, peak memory {summary['peak_memory_bytes'] / 2**30:.2f} GiB, "
        f"{summary['num_params'] / 1e9:.3f} B params; {flops / 1e12:.2f} TFLOP a step "
        f"({model_flops / 1e12:.2f} without the recompute), bound {bound_ms:.2f} ms at 989 TFLOP/s "
        f"bf16 ({bound_ms / step_ms:.1%} of it reached) on {smi}")
    return {
        "args": LLAMA_ARGS, "num_params": summary["num_params"], "train_steps": steps, "losses": losses,
        "eval": summary["eval"], "eval_batches": evals, "step_ms": step_ms,
        "first_step_s": summary["first_step_time_s"], "tokens_per_s": summary["tokens_per_s"],
        "wall_step_ms": summary["wall_step_time_s"] * 1e3, "tokens_per_s_wall": summary["tokens_per_s_wall"],
        "peak_memory_bytes": summary["peak_memory_bytes"], "step_flops": flops,
        "model_flops": model_flops, "bound_ms_bf16": bound_ms, "bound_share": bound_ms / step_ms,
        "model_flops_share": model_flops / PEAK_FLOPS["bfloat16"] * 1e3 / step_ms,
        "attention_launches": launches, "head": head,
    }


def write_cifar_batches(root: str) -> None:
    """CIFAR-10 python batches (``cifar-10-batches-py``: five train batches
    and ``test_batch`` of (N, 3072) uint8 CHW planes) holding the port's
    class-conditional synthetic uint8 images."""
    import pickle

    import numpy as np

    from distributeddataparallel_tpu_torch.data.datasets import SyntheticClassification

    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    splits = {"train": [f"data_batch_{i}" for i in range(1, 6)], "test": ["test_batch"]}
    for split, names in splits.items():
        ds = SyntheticClassification(CIFAR_ROWS[split], keep_u8=True, seed=0 if split == "train" else 1)
        planes = ds.images.transpose(0, 3, 1, 2).reshape(len(ds), 3072)
        for name, rows in zip(names, np.array_split(np.arange(len(ds)), len(names))):
            with open(os.path.join(d, name), "wb") as fh:
                pickle.dump({b"data": planes[rows], b"labels": ds.labels[rows].tolist()}, fh)


def torchvision_weights(torch, tio, root: str) -> tuple[dict, list[str]]:
    """A torchvision-format ResNet-18 state dict (10 classes, CIFAR stem)
    from a seeded port model, BatchNorm running statistics off 0 and 1 and
    torchvision's ``num_batches_tracked``, saved as .pth and .safetensors."""
    from distributeddataparallel_tpu_torch.models.resnet import ResNet18

    g = torch.Generator().manual_seed(8)
    model = ResNet18(num_classes=10, stem="cifar", generator=g)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_mean"):
            v = torch.rand(v.shape, generator=g) - 0.5
        elif k.endswith("running_var"):
            v = torch.rand(v.shape, generator=g) + 0.5
        sd[k] = v.clone()
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(100)
    paths = [os.path.join(root, "resnet18.pth"), os.path.join(root, "resnet18.safetensors")]
    torch.save(sd, paths[0])
    tio.save_safetensors({k: v.numpy() for k, v in sd.items()}, paths[1])
    return sd, paths


def host_kernel_times(native, images) -> dict:
    """ms per call of each native host kernel at phase 6's batch (32 rows of
    the uint8 CIFAR images), on the host: with the threads ``threads_for``
    gives it (``ms``), with the reference's up to 8 a call
    (``ms_threads8``), and its numpy version (``numpy_ms``)."""
    import numpy as np

    rng = np.random.default_rng(3)
    idx = rng.permutation(len(images))[:32]
    f32 = native.gather_normalize_u8_numpy(images, np.arange(len(images)))
    oy, ox, flip = rng.integers(0, 9, 32), rng.integers(0, 9, 32), rng.random(32) < 0.5
    chw = np.ascontiguousarray(f32[idx].transpose(0, 3, 1, 2))
    runs = {
        "gather_rows": ((f32, idx), {}),
        "gather_normalize_u8": ((images, idx), {}),
        "gather_augment_u8": ((images, idx, oy, ox, flip), {"padding": 4}),
        "chw_to_hwc": ((chw,), {}),
    }

    def per_call(fn, a, kw, n=200):
        for _ in range(5):
            fn(*a, **kw)
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*a, **kw)
        return (time.perf_counter() - t0) * 1e3 / n

    out, sized = {}, native.BYTES_PER_THREAD
    for name, (a, kw) in runs.items():
        fn, plain = getattr(native, name), getattr(native, name + "_numpy")
        if fn(*a, **kw).tobytes() != plain(*a, **kw).tobytes():
            raise AssertionError(f"native {name} is not bit-equal to its numpy version")
        res = {"ms": per_call(fn, a, kw), "numpy_ms": per_call(plain, a, kw),
               "threads": native.threads_for(fn(*a, **kw).nbytes)}
        native.BYTES_PER_THREAD = 1
        try:
            res["ms_threads8"] = per_call(fn, a, kw)
        finally:
            native.BYTES_PER_THREAD = sized
        out[name] = res
    return out


def augment_timing(torch, dpp, root: str) -> dict:
    """Phase 6's step and wall-clock step with loaders built here over the
    same uint8 CIFAR rows: the fused native augment (``CifarAugment``, one
    native pass) with the threads ``threads_for`` gives it (``native``) and
    with the reference's up to 8 a call (``native_threads8``), and the plain
    one (the rows normalized once into float32, then numpy's gather, crop
    and flip, as phase 6 runs), in the order plain, native_threads8,
    native, native, native_threads8, plain.  Their first batches must be
    bit-equal."""
    import numpy as np

    from distributeddataparallel_tpu_torch import native
    from distributeddataparallel_tpu_torch.data.datasets import ArrayDataset, load_cifar10
    from distributeddataparallel_tpu_torch.data.loader import DataLoader
    from distributeddataparallel_tpu_torch.data.transforms import CifarAugment, cifar_augment

    args = dpp.parse_args(["--model", "resnet18", "--dataset", "cifar10", "--data-root", root,
                           "--batch-size", "32", "--optimizer", "sgd", "--lr", "0.01", "--epochs", "1",
                           "--steps-per-epoch", "25", "--log-every", "1000"])
    u8 = load_cifar10(root, keep_u8=True, synthetic_fallback=False)
    f32 = ArrayDataset(native.gather_normalize_u8_numpy(u8.images, np.arange(len(u8))), u8.labels)
    native_loader = lambda: DataLoader(u8, per_replica_batch=32, device="cuda", seed=0,
                                       augment=CifarAugment())
    loaders = {
        "native": native_loader, "native_threads8": native_loader,
        "plain": lambda: DataLoader(f32, per_replica_batch=32, device="cuda", seed=0,
                                    augment=lambda b, rng, rows: cifar_augment(b, rng, rows)),
    }
    first = {k: next(iter(loaders[k]()))["image"].cpu().numpy() for k in ("native", "plain")}
    if first["native"].tobytes() != first["plain"].tobytes():
        raise AssertionError("the fused native augment's batch differs from the numpy augment's")
    runs, sized = {k: [] for k in loaders}, native.BYTES_PER_THREAD
    for which in ("plain", "native_threads8", "native", "native", "native_threads8", "plain"):
        trainer = dpp.build_trainer(args, torch.device("cuda"))
        trainer.loader = loaders[which]()
        native.BYTES_PER_THREAD = 1 if which == "native_threads8" else sized
        try:
            s = dpp.train(args, trainer, torch.device("cuda"))
        finally:
            native.BYTES_PER_THREAD = sized
        runs[which].append({"step_ms": s["step_time_s"] * 1e3, "wall_step_ms": s["wall_step_time_s"] * 1e3})
    out = {k: {m: sum(r[m] for r in v) / len(v) for m in ("step_ms", "wall_step_ms")}
           for k, v in runs.items()}
    for k, v in out.items():
        v["runs"] = runs[k]
        v["host_share_of_wall"] = 1 - v["step_ms"] / v["wall_step_ms"]
    out["batches_bit_equal"] = True
    return out


def mfu_run(torch, dpp, fa, smi) -> dict:
    """Phase 4 again with ``--mfu``: the port's MFU and HFU (cost model:
    full S x S attention, 3x / 4x the forward, peak 67 TFLOP/s f32 with TF32
    off) beside this script's share of the bound (``lm_step_flops``: the
    causal pairs each kernel computes, at the same 67 TFLOP/s)."""
    from distributeddataparallel_tpu_torch.observability import read_events

    with tempfile.TemporaryDirectory(prefix="mfu_events_") as events:
        args = [a.format(events=events) for a in MFU_ARGS]
        log("    dpp.main " + " ".join(args))
        fa.reset_launches()
        summary = dpp.main(args)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        mfu = [r for r in read_events(os.path.join(events, "events-p0.jsonl")) if r["kind"] == "mfu"]
    steps = summary["train_steps"]
    expect = {"flash_fwd": 12 * steps, "flash_bwd_dq": 12 * steps, "flash_bwd_dkv": 12 * steps}
    if launches != expect or not mfu or mfu[-1]["mfu"] is None:
        raise AssertionError(f"--mfu run: launches {launches} (expected {expect}), mfu events {mfu}")
    cfg = dpp.build_config(dpp.parse_args(args))
    flops, model_flops = lm_step_flops(cfg, 8, 1024)
    window_ms = 1e3 / summary["throughput_windows"][-1]["steps_per_s"]
    out = {
        "mfu": mfu[-1]["mfu"], "hfu": mfu[-1]["hfu"], "peak_flops": mfu[-1]["peak_flops_per_chip"],
        "model_flops_per_s": mfu[-1]["model_flops_per_s"], "window_step_ms": window_ms,
        "step_ms": summary["step_time_s"] * 1e3, "smoke_step_flops": flops,
        "smoke_bound_share": flops / PEAK_F32_CUDA_CORES * 1e3 / window_ms,
        "smoke_model_flops_share": model_flops / PEAK_F32_CUDA_CORES * 1e3 / window_ms,
        "launches": launches,
    }
    log(f"    MFU {out['mfu']:.2%} HFU {out['hfu']:.2%} (cost model) vs this script's share of the "
        f"bound {out['smoke_bound_share']:.2%} at 67 TFLOP/s; window step {window_ms:.1f} ms on {smi}")
    return out


def reference_workload_phase(torch, dpp, fa, smi) -> dict:
    """[8] ResNet-18 CIFAR fine-tuned from torchvision-format weights, with
    the native input kernels and every telemetry flag."""
    import glob

    import numpy as np

    from distributeddataparallel_tpu_torch import native
    from distributeddataparallel_tpu_torch.data.datasets import load_cifar10
    from distributeddataparallel_tpu_torch.data.transforms import CifarAugment
    from distributeddataparallel_tpu_torch.models import io as tio
    from distributeddataparallel_tpu_torch.observability import validate_file

    with tempfile.TemporaryDirectory(prefix="r18_reference_") as root:
        write_cifar_batches(root)
        sd, paths = torchvision_weights(torch, tio, root)
        want = {k: v for k, v in sd.items() if "num_batches" not in k}
        for path in paths:  # the loaded state equals the file, both formats
            cfg = [a.format(root=root, weights=path, events=os.path.join(root, "ev"),
                            runs=os.path.join(root, "runs")) for a in R18_TELEMETRY_ARGS]
            model = dpp.build_trainer(dpp.parse_args(cfg), torch.device("cuda")).state.model
            got = model.state_dict()
            if set(got) != set(want) or any(not torch.equal(got[k].cpu(), v) for k, v in want.items()):
                raise AssertionError(f"--pretrained {path}: the model's state differs from the file")
            del model, got
        events, runs = os.path.join(root, "events"), os.path.join(root, "runs")
        args = [a.format(root=root, weights=paths[1], events=events, runs=runs) for a in R18_TELEMETRY_ARGS]
        log("[8] reference workload: dpp.main " + " ".join(args))
        fa.reset_launches()
        native.reset_calls()
        summary = dpp.main(args)
        torch.cuda.synchronize()
        launches, calls = dict(fa.LAUNCHES), dict(native.CALLS)

        steps, evals = summary["train_steps"], summary["eval_batches"]
        losses = summary["losses"]
        if steps != 50 or not all(math.isfinite(x) for x in losses) or not math.isfinite(summary["eval"]["loss"]):
            raise AssertionError(f"reference workload: {steps} steps, losses {losses}, eval {summary['eval']}")
        if any(launches.values()):
            raise AssertionError(f"reference workload: attention kernels launched {launches}")
        if calls["gather_augment_u8"] != steps or calls["gather_normalize_u8"] != evals:
            raise AssertionError(f"native calls {calls}: expected {steps} fused augments and "
                                 f"{evals} fused normalizes")
        files = sorted(glob.glob(os.path.join(events, "*.jsonl")))
        problems = {f: validate_file(f) for f in files}
        if len(files) != 2 or any(problems.values()):
            raise AssertionError(f"events: {problems}")
        records = [json.loads(x) for x in open(os.path.join(events, "timeline.jsonl"))]
        kinds = [r["kind"] for r in records]
        periodic = [r for r in records if r["kind"] == "metrics" and "step" in r]
        if len(periodic) != steps // 5:
            raise AssertionError(f"{len(periodic)} metrics snapshots for {steps} steps every 5")
        traces = glob.glob(os.path.join(events, "xprof", "*.json"))
        if not traces:
            raise AssertionError("no trace under EVENTS_DIR/xprof")
        trace = json.load(open(traces[0]))
        device_events = sum(1 for e in trace.get("traceEvents", []) if e.get("cat") == "kernel")
        index = open(os.path.join(runs, "index.jsonl")).read().splitlines()
        if len(index) != 1:
            raise AssertionError(f"{len(index)} run records under --runs-dir")
        run_summary = json.loads(index[0])

        # One augmented batch against its numpy version on this machine.
        images = load_cifar10(root, keep_u8=True, synthetic_fallback=False).images
        idx = np.random.default_rng(1).permutation(len(images))[:32]
        fused = CifarAugment().gather_u8(images, idx, np.random.default_rng(2))
        g = np.random.default_rng(2)
        oy, ox, flip = g.integers(0, 9, 32), g.integers(0, 9, 32), g.random(32) < 0.5
        plain = native.gather_augment_u8_numpy(images, idx, oy, ox, flip, padding=4)
        if fused.tobytes() != plain.tobytes():
            raise AssertionError("the fused augment's batch is not bit-equal to its numpy version")
        host = host_kernel_times(native, images)
        log("    phase 6 with the native and the plain augment:")
        augment = augment_timing(torch, dpp, root)
    mems = [r for r in records if r["kind"] == "memory"]
    out = {
        "args": R18_TELEMETRY_ARGS, "train_steps": steps, "eval_batches": evals, "losses": losses,
        "eval": summary["eval"], "step_ms": summary["step_time_s"] * 1e3,
        "wall_step_ms": summary["wall_step_time_s"] * 1e3, "native_calls": calls,
        "attention_launches": launches, "event_kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
        "metrics_snapshots": len(periodic), "trace_files": [os.path.basename(t) for t in traces],
        "trace_device_kernel_events": device_events, "run_summary": run_summary,
        "memory_last": mems[-1] if mems else None, "augment_batch_bit_equal": True,
        "host_kernels_ms_per_batch": host, "phase6_augment": augment,
    }
    log(f"    {steps} steps, losses {losses[0]:.4f} -> {losses[-1]:.4f}, eval {summary['eval']}; native "
        f"calls {calls}; events {out['event_kinds']}; trace {out['trace_files']} "
        f"({device_events} kernel events); host kernels {host}; augment {augment} on {smi}")
    log("    --mfu on phase 4's GPT-2:")
    out["mfu"] = mfu_run(torch, dpp, fa, smi)
    return out


HERE = os.path.dirname(os.path.abspath(__file__))


def _entry_env(extra: dict | None = None) -> dict:
    """The environment of an entry-point process: this one's, without the
    variables that would turn on telemetry or chaos it was not asked for."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DDP_", "_DDP_")) or k == "DDP_COMPILE_CACHE"}
    env.update(extra or {})
    return env


def start_entry(args, env=None) -> subprocess.Popen:
    """The port's entry point in a fresh process."""
    return subprocess.Popen([sys.executable, "-m", "distributeddataparallel_tpu_torch.dpp", *args], cwd=HERE,
                            env=_entry_env(env), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_entry(proc: subprocess.Popen, what: str, timeout: float = 600) -> dict:
    """Wait for an entry-point process; its summary (the last line of its
    output).  A non-zero exit fails the phase."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def run_entry(args, what: str, env=None) -> dict:
    log(f"    {what}: python -m distributeddataparallel_tpu_torch.dpp " + " ".join(args))
    return finish_entry(start_entry(args, env), what)


def timeline(events_dir: str) -> list[dict]:
    """The merged timeline, validated against the port's copy of the event
    schema: the check ``scripts/check_events.py`` makes, without that
    script's import of the JAX package."""
    from distributeddataparallel_tpu_torch.observability import read_events, validate_file

    path = os.path.join(events_dir, "timeline.jsonl")
    problems = validate_file(path)
    if problems:
        raise AssertionError(f"{path}: {problems}")
    return read_events(path)


def expect_launches(summary: dict, what: str, layers: int = 12) -> dict:
    """A GPT-2 run's K1-K3 launches, which must be one per layer per train
    step (K1 also per eval batch)."""
    steps, got = summary["train_steps"], summary["attention_launches"]
    want = {"flash_fwd": layers * (steps + summary["eval_batches"]), "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want} for {steps} steps")
    return got


def live_event(path: str, pred) -> bool:
    """Does a live events file hold a record ``pred`` accepts?  (A line
    still being written is skipped.)"""
    if not os.path.exists(path):
        return False
    with open(path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if pred(rec):
                return True
    return False


def await_event(proc: subprocess.Popen, path: str, pred, what: str, timeout: float = 300) -> None:
    """Wait until the events file of the running ``proc`` shows a record
    ``pred`` accepts; fail if the process ends first or the time runs out."""
    deadline = time.monotonic() + timeout
    while not live_event(path, pred):
        if proc.poll() is not None:
            out, err = proc.communicate()
            raise AssertionError(f"{what}: exit {proc.returncode} before the awaited event\n{err[-4000:]}")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: no awaited event in {timeout} s")
        time.sleep(0.05)


def start_replay() -> tuple[subprocess.Popen, str]:
    """[9a] The supervised chaos replay in a fresh process (its directory
    is the caller's to remove)."""
    d = tempfile.mkdtemp(prefix="fault_9a_")
    sup = REPLAY_ARGS + ["--checkpoint-dir", os.path.join(d, "ck"), "--events-dir", os.path.join(d, "ev"),
                         "--max-restarts", "1"]
    log("    9a supervised, DDP_CHAOS=ckpt-io@0,preempt@6: python -m distributeddataparallel_tpu_torch.dpp "
        + " ".join(sup))
    return start_entry(sup, env={"DDP_CHAOS": "ckpt-io@0,preempt@6"}), d


def restart_record(summary: dict, records: list[dict]) -> dict:
    """A supervised run's ``warm_start`` mode by attempt and its restart's
    seconds, from the chaos death to the next incarnation's first step:
    the supervisor's notice and backoff, the spawn, the interpreter and
    imports, the CUDA context, the process group with the model and
    loader, the checkpoint read, the kernel library's load and the first
    step (the last incarnation's ``startup`` against the timeline)."""
    from distributeddataparallel_tpu_torch.runtime.launcher import RESTART_BACKOFF_S

    warm = {r["attempt"]: r for r in records if r["kind"] == "warm_start"}
    start = [r["ts"] for r in records if r["kind"] == "run_start" and r["attempt"] == 1][0]
    death = [r["ts"] for r in records if r["kind"] == "chaos_inject" and r["entry"].startswith("preempt")][0]
    notice = [r["ts"] for r in records if r["kind"] == "restart_attempt"][0]
    st = summary["startup"]
    split = {
        "notice_s": notice - death,
        "backoff_s": RESTART_BACKOFF_S,
        "spawn_s": st["process_start_unix"] - notice - RESTART_BACKOFF_S,
        "interpreter_and_imports_s": st["run_entry_unix"] - st["process_start_unix"],
        "cuda_context_s": st["cuda_context_s"],
        "group_model_loader_s": start - st["run_entry_unix"] - st["cuda_context_s"],
        "checkpoint_read_s": st["restore_s"],
        "kernel_library_load_s": st["kernel_build_s"],
        "first_step_s": st["first_step_s"],
        "death_to_first_step_s": warm[1]["ts"] - death,
    }
    return {"modes": {a: r["mode"] for a, r in sorted(warm.items())}, "split": split,
            "kernel_builds": summary["kernel_builds"]}


def check_replay(chaotic, records, straight, smi) -> dict:
    """[9a] The replay against the uninterrupted run (9e's, which ran beside
    9a's first incarnation)."""
    kinds = [r["kind"] for r in records]
    diff = abs(chaotic["losses"][-1] - straight["losses"][-1])
    death = [r["ts"] for r in records if r["kind"] == "chaos_inject" and r["entry"] == "preempt@6"]
    first = [r["ts"] for r in records if r["kind"] == "warm_start" and r["attempt"] == 1]
    if (kinds.count("restart_attempt"), kinds.count("ckpt_retry"), chaotic["faults"]["restarts"]) != (1, 1, 1):
        raise AssertionError(f"9a: {kinds.count('restart_attempt')} restarts, {kinds.count('ckpt_retry')} "
                             f"IO retries, summary faults {chaotic['faults']}")
    if (chaotic["start_epoch"], chaotic["train_steps"]) != (1, 8) or not diff <= REPLAY_ATOL:
        raise AssertionError(f"9a: resumed at epoch {chaotic['start_epoch']} for {chaotic['train_steps']} "
                             f"steps, final loss {chaotic['losses'][-1]} vs {straight['losses'][-1]}")
    launches = expect_launches(chaotic, "9a last incarnation")
    out = {
        "final_loss": chaotic["losses"][-1], "uninterrupted_final_loss": straight["losses"][-1],
        "final_loss_abs_diff": diff, "atol": REPLAY_ATOL, "restarts": 1, "io_retries": 1,
        "death_to_first_step_s": first[0] - death[0], "last_incarnation_launches": launches,
        "last_incarnation_step_ms": chaotic["step_time_s"] * 1e3,
        "restart": restart_record(chaotic, records),  # phase 16c reads it
    }
    log(f"    9a: exit 0 after 1 restart and 1 IO retry; final loss {chaotic['losses'][-1]:.6f} vs "
        f"{straight['losses'][-1]:.6f} (|diff| {diff:.2e}, atol {REPLAY_ATOL}); death to the next "
        f"incarnation's first step {out['death_to_first_step_s']:.2f} s; launches {launches} on {smi}")
    return out


def sigterm_stop(d: str) -> dict:
    """[9b] A real SIGTERM once the events show step 3 (beside 9a's tail and
    9d): exit 0 with ``epoch_0.pt`` and its hash sidecar in ``d``."""
    import signal

    run = FAULT_LM_ARGS + ["--epochs", "2", "--checkpoint-dir", os.path.join(d, "ck")]
    args = run + ["--events-dir", os.path.join(d, "ev")]
    log("    9b: python -m distributeddataparallel_tpu_torch.dpp " + " ".join(args))
    proc = start_entry(args)
    await_event(proc, os.path.join(d, "ev", "events-p0.jsonl"),
                lambda r: r.get("kind") == "span" and r.get("name") == "step" and r.get("step") == 3, "9b")
    t_sig = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    stopped = finish_entry(proc, "9b SIGTERM")
    t_exit = time.perf_counter()
    files = sorted(f for f in os.listdir(os.path.join(d, "ck")) if not f.startswith("."))
    if stopped["preempted_epoch"] != 0 or files != ["epoch_0.pt", "hash_0.json"]:
        raise AssertionError(f"9b: preempted epoch {stopped['preempted_epoch']}, files {files}")
    return {"run": run, "stopped": stopped, "signal_to_exit_s": t_exit - t_sig}


def sigterm_resume(dpp, stop: dict, smi) -> dict:
    """[9b] ``--resume`` of the stopped run, in this process: it starts at
    epoch 1 and ends with a finite loss."""
    run, stopped = stop["run"], stop["stopped"]
    log("    9b --resume: dpp.main " + " ".join(run + ["--resume"]))
    resumed = dpp.main(run + ["--resume"])
    if resumed["start_epoch"] != 1 or resumed["train_steps"] != 10 or not math.isfinite(resumed["losses"][-1]):
        raise AssertionError(f"9b resume: epoch {resumed['start_epoch']}, {resumed['train_steps']} steps, "
                             f"losses {resumed['losses']}")
    out = {
        "steps_before_stop": stopped["train_steps"], "signal_to_exit_s_beside_others": stop["signal_to_exit_s"],
        "resumed_start_epoch": 1, "resumed_final_loss": resumed["losses"][-1],
        "launches": {"preempted": expect_launches(stopped, "9b preempted run"),
                     "resumed": expect_launches(resumed, "9b resumed run")},
    }
    log(f"    9b: stopped after {stopped['train_steps']} steps, exit 0 {stop['signal_to_exit_s']:.2f} s after "
        f"the signal (beside 9a's tail and 9d) with epoch_0.pt + hash_0.json; --resume from epoch 1, "
        f"final loss {resumed['losses'][-1]:.4f} on {smi}")
    return out


def fault_guard(torch, dpp) -> dict:
    """[9c] The skip-step guard on ResNet-18: steps 0-2 with one-step epochs
    and checkpoints, then --resume for steps 3-4; both runs in this process
    (``dpp.main``: it times nothing, and two fresh processes cost ~40 s)."""
    from distributeddataparallel_tpu_torch.training import checkpoint as ck

    with tempfile.TemporaryDirectory(prefix="fault_9c_") as d:
        run = FAULT_R18_ARGS + ["--nan-guard", "--chaos", "nan-grad@2", "--steps-per-epoch", "1",
                                "--checkpoint-dir", d]
        log("    9c steps 0-2: dpp.main " + " ".join(run + ["--epochs", "3"]))
        first = dpp.main(run + ["--epochs", "3"])
        one, two = (torch.load(os.path.join(d, f"epoch_{e}.pt"), weights_only=True) for e in (1, 2))
        log("    9c --resume, steps 3-4: dpp.main " + " ".join(run + ["--epochs", "5", "--resume"]))
        rest = dpp.main(run + ["--epochs", "5", "--resume"])
    same = {
        "model": one["model"].keys() == two["model"].keys()
        and all(torch.equal(one["model"][k], two["model"][k]) for k in one["model"]),
        "optimizer": ck.state_content_hash(one["optimizer"]) == ck.state_content_hash(two["optimizer"]),
        "scheduler": one["scheduler"] == two["scheduler"],
    }
    losses = first["losses"] + rest["losses"]
    if first["faults"]["nonfinite_steps"] != 1 or not all(same.values()) or two["step"] != one["step"] + 1:
        raise AssertionError(f"9c: faults {first['faults']}, equal after the skipped step {same}")
    if [math.isfinite(x) for x in losses] != [True, True, False, True, True]:
        raise AssertionError(f"9c: losses {losses}")
    log(f"    9c: 1 step skipped; params, optimizer and BN buffers after step 2 bitwise those after "
        f"step 1 ({same}); losses {['%.4f' % x for x in losses]}")
    return {"nonfinite_steps": 1, "state_equal_after_skip": same,
            "losses": [x if math.isfinite(x) else None for x in losses]}


def checkpoint_cost(torch, dpp, smi) -> dict:
    """A save of GPT-2 124M's AdamW state (after one step) without the
    content hash (the host copy and ``torch.save``) and with it
    (``CheckpointFiles.write``: the copy, the hash and its sidecar, the file),
    (one each since phase 17 bought its time back; two saves of one kind
    spread 0.6-1.2 s, so the hash timed alone is the cost to read); the
    hash alone; and the read with its verification."""
    from distributeddataparallel_tpu_torch.training import checkpoint as ck

    trainer = dpp.build_trainer(dpp.parse_args(FAULT_LM_ARGS), torch.device("cuda"))
    trainer.step_fn(trainer.state, next(iter(trainer.loader)))
    torch.cuda.synchronize()
    runs = {"without": [], "with": []}
    with tempfile.TemporaryDirectory(prefix="fault_ckpt_") as d:
        saver = ck.CheckpointFiles(d)
        for which in ("without", "with"):
            t0 = time.perf_counter()
            if which == "with":
                saver.write(trainer.state, 0)
            else:
                torch.save(ck.host_payload(trainer.state, 0), os.path.join(d, "plain.pt"))
            runs[which].append(time.perf_counter() - t0)
        payload = ck.host_payload(trainer.state, 0)
        t0 = time.perf_counter()
        ck.state_content_hash(payload)
        t1 = time.perf_counter()
        saver.read(0)
        t2 = time.perf_counter()
    tensors = [*payload["model"].values(), *(t for st in payload["optimizer"]["state"].values()
                                             for t in st.values() if torch.is_tensor(t))]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    del trainer, payload
    torch.cuda.empty_cache()
    mean = {k: sum(v) / len(v) for k, v in runs.items()}
    out = {"payload_bytes": nbytes, "runs_s": runs, "save_without_hash_s": mean["without"],
           "save_with_hash_s": mean["with"], "hash_s": t1 - t0, "read_verified_s": t2 - t1}
    log(f"    checkpoint of {nbytes / 1e9:.3f} GB (GPT-2's AdamW state): save {mean['with']:.2f} s with the "
        f"hash, {mean['without']:.2f} s without (runs {runs}); the hash alone {t1 - t0:.2f} s; read and "
        f"verify {t2 - t1:.2f} s on {smi}")
    return out


def start_watchdog():
    """[9d] The step watchdog under supervision, in a fresh process started
    once 9a's restart is timed: it checks and times nothing alone (9a's
    restart is the phase's restart latency)."""
    d = tempfile.mkdtemp(prefix="fault_9d_")
    args = FAULT_R18_ARGS + ["--epochs", "2", "--steps-per-epoch", "5", "--step-timeout", "5", "--max-restarts", "1",
                             "--chaos", "slow-step@3:30", "--checkpoint-dir", os.path.join(d, "ck"),
                             "--events-dir", os.path.join(d, "ev")]
    log("    9d watchdog: python -m distributeddataparallel_tpu_torch.dpp " + " ".join(args))
    return start_entry(args), d


def finish_watchdog(started, smi) -> dict:
    import shutil

    proc, d = started
    try:
        summary = finish_entry(proc, "9d watchdog")
        records = timeline(os.path.join(d, "ev"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    fires = [r for r in records if r["kind"] == "watchdog_fire"]
    restarts = [r["failed"] for r in records if r["kind"] == "restart_attempt"]
    first = [r["ts"] for r in records if r["kind"] == "warm_start" and r["attempt"] == 1]
    if len(fires) != 1 or restarts != [[[0, 75]]] or summary["train_steps"] != 5:
        raise AssertionError(f"9d: fires {fires}, restarts {restarts}, {summary['train_steps']} steps after it")
    out = {"exit_code": 75, "seconds_since_heartbeat": fires[0]["seconds_since_heartbeat"],
           "fire_to_first_step_s_beside_others": first[0] - fires[0]["ts"],
           "resumed_start_epoch": summary["start_epoch"]}
    log(f"    9d: watchdog fired {out['seconds_since_heartbeat']:.2f} s after the last heartbeat, exit 75, "
        f"the restart completed (fire to the next incarnation's first step "
        f"{out['fire_to_first_step_s_beside_others']:.2f} s, beside 9a's tail and 9b) on {smi}")
    return out


def coordinated_replay(dpp, phase4_losses, smi) -> tuple[dict, dict]:
    """[9e] 9a's uninterrupted run, in this process (beside 9a's first
    incarnation), with the multi-host
    flags on one host of one card (``--coordinator`` on a port outside the
    ephemeral ranges, ``free_port``): its first two losses against phase
    4's.  Returns its summary (9a's reference) and 9e's record."""
    from distributeddataparallel_tpu_torch.runtime.distributed import free_port

    args = REPLAY_ARGS + ["--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1",
                          "--process-id", "0"]
    log("    9a uninterrupted, over --coordinator (9e): dpp.main " + " ".join(args))
    summary = dpp.main(args)
    diff = max(abs(a - b) for a, b in zip(summary["losses"][:2], phase4_losses[:2]))
    if summary["train_steps"] != 12 or not diff <= COORDINATOR_ATOL:
        raise AssertionError(f"9e: losses {summary['losses'][:2]} vs phase 4's {phase4_losses[:2]}")
    launches = expect_launches(summary, "9e")
    log(f"    9e: losses {summary['losses'][:2]} vs phase 4's first two {phase4_losses[:2]} (|diff| {diff:.1e}) "
        f"on {smi}")
    return summary, {"losses": summary["losses"][:2], "phase4_losses": phase4_losses[:2], "max_abs_diff": diff,
                     "atol": COORDINATOR_ATOL, "launches": launches}


def fault_path_phase(torch, dpp, phase4_losses, smi) -> dict:
    """[9] The fault path.  9a starts first; 9c and 9e (with 9a's
    uninterrupted run) run in this process while its first incarnation
    trains, and its restart (from the injected death to the next
    incarnation's first step) runs alone.  Then, beside 9a's tail: 9d and
    9b's stop (fresh processes), then 9b's resume in this process.  The
    checkpoint costs run alone at the end."""
    import gc
    import shutil

    gc.collect()
    torch.cuda.empty_cache()  # the entry-point processes need the card's memory
    t0 = time.perf_counter()
    log("[9] fault path")
    out, seconds = {}, {}
    replay, d9a = start_replay()
    events9a = os.path.join(d9a, "ev", "events-p0.jsonl")
    d9b = tempfile.mkdtemp(prefix="fault_9b_")
    try:
        out["guard"] = fault_guard(torch, dpp)
        straight, out["coordinator"] = coordinated_replay(dpp, phase4_losses, smi)
        # Did 9c and 9e end before 9a's injected death?  Then its restart ran
        # alone.
        out["restart_alone"] = not live_event(
            events9a, lambda r: r.get("kind") == "chaos_inject" and str(r.get("entry", "")).startswith("preempt"))
        seconds["9c_9e_beside_9a"] = time.perf_counter() - t0
        await_event(replay, events9a, lambda r: r.get("kind") == "warm_start" and r.get("attempt") == 1, "9a")
        seconds["9a_to_restart"] = time.perf_counter() - t0
        if not out["restart_alone"]:
            log("    9a's restart was timed beside 9c or 9e (they ended after its injected death)")
        t = time.perf_counter()
        watchdog = start_watchdog()
        out["sigterm"] = sigterm_resume(dpp, sigterm_stop(d9b), smi)
        chaotic = finish_entry(replay, "9a supervised")
        out["replay"] = check_replay(chaotic, timeline(os.path.join(d9a, "ev")), straight, smi)
        out["watchdog"] = finish_watchdog(watchdog, smi)
        seconds["9a_tail_9b_9d"] = time.perf_counter() - t
    finally:
        if replay.poll() is None:
            replay.kill()
        shutil.rmtree(d9a, ignore_errors=True)
        shutil.rmtree(d9b, ignore_errors=True)
    t = time.perf_counter()
    out["guard"]["checkpoint_cost"] = checkpoint_cost(torch, dpp, smi)
    seconds["costs"] = time.perf_counter() - t
    out["check_seconds"] = seconds
    runs = [out["replay"]["last_incarnation_launches"], *out["sigterm"]["launches"].values(),
            out["coordinator"]["launches"]]
    out["launches"] = {k: sum(r[k] for r in runs) for k in runs[0]}
    out["seconds"] = time.perf_counter() - t0
    log(f"    phase 9 in {out['seconds']:.1f} s ({seconds}); K1-K3 launches in its checked GPT-2 runs "
        f"{out['launches']}")
    return out


def forward_twin(torch, dm, qparams=None, dtype=None):
    """A non-decode TransformerLM on ``dm``'s weights (no copy; the int8
    tree's, dequantized, under ``qparams``), computing in ``dtype`` (default
    ``dm``'s): the full forward the teacher-forced check reads, through K1
    on the card."""
    from distributeddataparallel_tpu_torch.models import io as tio
    from distributeddataparallel_tpu_torch.models import transformer as tfm
    from distributeddataparallel_tpu_torch.ops.quant import dequantize

    cfg = dataclasses.replace(dm.cfg, decode=False, quant_serving=False, remat=False,
                              dtype=dtype or dm.cfg.dtype)
    if qparams is None:
        sd = {k: p for k, p in dm.named_parameters()}
    else:
        sd = {}
        for i in range(cfg.num_layers):
            sd.update({f"layers.{i}.{k}": v for k, v in tio.layer_weights(qparams, i, cfg).items()})
        top = tio.top_weights(qparams, cfg)
        sd.update({f"final_norm.{k}": v for k, v in top["final_norm"].items()})
        sd["token_embed.weight"] = dequantize(qparams["token_embed"]["embedding"], cfg.dtype)
        if cfg.positional == "learned":
            sd["pos_embed"] = dequantize(qparams["pos_embed"], cfg.dtype)
        if not cfg.tie_embeddings:
            sd["lm_head.weight"] = top["head"]
    fwd = tfm.TransformerLM(cfg, device="meta")
    fwd.load_state_dict(sd, assign=True)
    if cfg.positional == "rope":
        fwd.rope_cos, fwd.rope_sin = dm.rope_cos, dm.rope_sin
    return fwd.eval().requires_grad_(False)


def twin_prefill(torch, decode_dm, tokens):
    """The decode twin's logits of one prefill over ``tokens`` (B, S) into
    a fresh dense cache: the decode path without the engine's pool."""
    from distributeddataparallel_tpu_torch.models.generate import init_cache

    tokens = torch.as_tensor(tokens, device=DEVICE).long()
    with torch.no_grad():
        return decode_dm(tokens, positions=torch.arange(tokens.shape[1], device=DEVICE),
                         cache=init_cache(decode_dm, tokens.shape[0])).float()


def hold_margins(torch, logits, tokens, n_prompt: int, atol: float, what: str) -> dict:
    """Every generated token's logit within ``atol`` of its position's
    maximum under ``logits`` (B, S - 1, V) of prompt + continuation."""
    rows = logits[:, n_prompt - 1:]  # the rows that chose tokens[:, n_prompt:]
    chosen = rows.gather(-1, tokens[:, n_prompt:, None])[..., 0]
    margin = rows.max(dim=-1).values - chosen
    out = {"tokens_checked": int(margin.numel()), "max_margin": float(margin.max()),
           "margins_over_1e-3": int((margin > 1e-3).sum()), "atol": atol}
    if not out["max_margin"] <= atol:
        bad = torch.nonzero(margin > atol)[0].tolist()
        raise AssertionError(f"{what}: token at {bad} is {out['max_margin']:.3e} below its row's max "
                             f"(atol {atol}); {out}")
    return out


def teacher_forced(torch, fwd, tokens, n_prompt: int, atol: float, what: str, decode_dm=None) -> dict:
    """[10] Every generated token's logit within ``atol`` of its position's
    maximum, by ``fwd``'s full forward over prompt + continuation (B, S);
    with ``decode_dm``, also by the decode twin's own prefill (``twin``),
    and the distance of the two paths' logits."""
    tokens = torch.as_tensor(tokens, device=DEVICE).long()
    with torch.no_grad():
        full = fwd(tokens[:, :-1]).float()
    out = hold_margins(torch, full, tokens, n_prompt, atol, what)
    if decode_dm is not None:
        got = twin_prefill(torch, decode_dm, tokens[:, :-1])
        out["decode_vs_forward_max_abs"] = float((got - full).abs().max())
        out["twin"] = hold_margins(torch, got, tokens, n_prompt, atol, f"{what} (decode twin)")
    return out


def generate_phase(torch, dpp, fa, smi) -> dict:
    """[10a] Phase 4's GPT-2, 2 steps, then --generate 64, dense and with
    int8 weights; each continuation held to the plain full f32 forward of
    the trained weights (from the run's checkpoint)."""
    from distributeddataparallel_tpu_torch.models import transformer as tfm
    from distributeddataparallel_tpu_torch.models.generate import decode_model, quantize_model
    from distributeddataparallel_tpu_torch.training.checkpoint import CheckpointFiles

    out = {}
    for name, extra in (("f32", []), ("int8", ["--decode-quant", "int8"])):
        with tempfile.TemporaryDirectory(prefix="gen_10a_") as d:
            args = [a.replace("{ckpt}", d) for a in GEN_ARGS] + extra
            log(f"    10a {name}: dpp.main " + " ".join(args))
            fa.reset_launches()
            summary = dpp.main(args)
            torch.cuda.synchronize()
            launches = dict(fa.LAUNCHES)
            expect_launches(summary, f"10a {name}")
            gen = summary["generate"]
            cfg = dpp.build_config(dpp.parse_args(args))
            model = tfm.TransformerLM(dataclasses.replace(cfg, attn_impl="plain"), device=DEVICE)
            model.load_state_dict(CheckpointFiles(d).read(0)["model"])
        if name == "int8":
            qparams = quantize_model(model)
            fwd = forward_twin(torch, decode_model(model, quant_serving=True), qparams)
            decode_dm = None
        else:
            fwd, decode_dm = model, decode_model(model)
        n_prompt = len(gen["prompt"][0])
        check = teacher_forced(torch, fwd, gen["tokens"], n_prompt, TF_ATOL["float32"], f"10a {name}", decode_dm)
        out[name] = {"prompt_tokens": n_prompt, "new_tokens": len(gen["tokens"][0]) - n_prompt,
                     "prefill_ms": gen["prefill_ms"], "decode_ms_per_token": gen["decode_ms_per_token"],
                     "losses": summary["losses"], "teacher_forced": check, "attention_launches": launches}
        log(f"    10a {name}: prefill {gen['prefill_ms']:.2f} ms ({n_prompt} tokens x 2 rows), decode "
            f"{gen['decode_ms_per_token']:.3f} ms a token, teacher-forced {check} on {smi}")
        del model, fwd, decode_dm
    return out


def profile_decode(torch, model, config, smi) -> dict:
    """[10b] Device idle share of the engine's decode step with every slot
    busy, from a ``torch.profiler`` trace (as ``profile_step`` reads one)."""
    from collections import defaultdict

    import numpy as np

    from distributeddataparallel_tpu_torch.profile_step import _group
    from distributeddataparallel_tpu_torch.serving import InferenceEngine

    engine = InferenceEngine(model, config)
    rng = np.random.default_rng(1)
    slots, p = config.num_slots, PROFILE_DECODE
    for _ in range(slots):
        engine.submit(rng.integers(0, model.cfg.vocab_size, p["prompt"], dtype=np.int32), p["new"])
    while len(engine.scheduler.running) < slots:
        engine.step()
    for _ in range(3):  # warm
        engine.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(p["steps"]):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    host_names = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    per_kernel: dict = defaultdict(float)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host_names:
            per_kernel[e.key] += float(e.self_device_time_total)
    n = p["steps"]
    busy_ms = sum(per_kernel.values()) / 1e3 / n
    groups: dict = defaultdict(float)
    for k, us in per_kernel.items():
        groups[_group(k)] += us / 1e3 / n
    out = {"steps": n, "slots_busy": slots, "wall_ms_per_step": wall * 1e3 / n, "device_busy_ms_per_step": busy_ms,
           "device_idle_share": (1.0 - busy_ms / (wall * 1e3 / n)) if busy_ms else None,
           "kernels_per_step": sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                                   and e.key not in host_names) / n,
           "device_ms_per_step_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}
    log(f"    decode step profile ({slots} slots busy): {out} on {smi}")
    return out


def serve_phase(torch, fa, smi) -> dict:
    """[10b] The serving CLI's three runs at GPT-2 124M full width on the
    wall clock: every request completes, the events validate, 4 requests of
    each run pass the teacher-forced check, and the fast path's outputs
    equal a plain engine's on the same prompts (up to a tie of the
    forward's logits, after which they may part)."""
    from distributeddataparallel_tpu_torch import serve

    out = {}
    model = None
    for name, extra in SERVE_RUNS.items():
        with tempfile.TemporaryDirectory(prefix="serve_10b_") as d:
            argv = [a.replace("{events}", d) for a in SERVE_ARGS] + extra
            log(f"    10b {name}: python -m distributeddataparallel_tpu_torch.serve " + " ".join(argv))
            args = serve.parse_args(argv)
            model = model if model is not None else serve.build_model(args)
            fa.reset_launches()
            summary, engine, trace = serve.serve(args, model)
            torch.cuda.synchronize()
            launches = dict(fa.LAUNCHES)
            problems = serve.timeline_problems(d, ("request_admit", "prefill_chunk", "decode_step",
                                                    "request_done"), f"10b {name}")
        if summary["completed"] != len(trace) or problems:
            raise AssertionError(f"10b {name}: {summary['completed']}/{len(trace)} completed; {problems}")
        if any(launches.values()):
            raise AssertionError(f"10b {name}: the engine launched the flash kernels {launches}")
        fwd = forward_twin(torch, engine._dm, engine.qparams)
        rids = sorted(engine.completed)[:: max(len(engine.completed) // 4, 1)][:4]
        checks = [teacher_forced(torch, fwd, engine.output_tokens(r)[None], engine.completed[r].prompt_len,
                                 TF_ATOL["bfloat16"], f"10b {name} request {r}") for r in rids]
        bytes_per_block = summary["kv_pool_bytes"] / args.blocks
        entry = {k: summary.get(k) for k in (
            "requests", "completed", "tokens_out", "elapsed_s", "serve_tok_s", "serve_p50_ttft_s",
            "serve_p99_ttft_s", "mean_tok_latency_s", "decode_step_ms", "steps", "preemptions", "evictions",
            "prefix_hit_frac", "prefill_flops_avoided_frac", "cow_copies", "spec_accept_mean")}
        entry.update(kv_pool_bytes=summary["kv_pool_bytes"], peak_live_blocks=summary["peak_live_blocks"],
                     peak_live_bytes=summary["peak_live_blocks"] * bytes_per_block,
                     teacher_forced_max_margin=max(c["max_margin"] for c in checks),
                     teacher_forced_tokens=sum(c["tokens_checked"] for c in checks), attention_launches=launches)
        if name == "fast_path":
            entry["vs_plain"] = fast_vs_plain(torch, model, engine, trace, fwd)
        out[name] = entry
        log(f"    10b {name}: {entry} on {smi}")
        del engine, fwd
    out["decode_profile"] = profile_decode(torch, model, serve.engine_config(serve.parse_args(
        [a.replace("{events}", "") for a in SERVE_ARGS])), smi)
    return out


def fast_vs_plain(torch, model, fast, trace, fwd) -> dict:
    """[10b] The fast path's continuations against a plain engine's on every
    FAST_SUBSET-th prompt of its trace (same slots and pool)."""
    import numpy as np

    from distributeddataparallel_tpu_torch.serving import EngineConfig, InferenceEngine, VirtualClock

    c = fast.config
    clock = VirtualClock(0.01)
    plain = InferenceEngine(model, EngineConfig(num_slots=c.num_slots, num_blocks=c.num_blocks,
                                                block_size=c.block_size, prefill_chunk=c.prefill_chunk),
                            time_fn=clock)
    picked = list(range(0, len(trace), FAST_SUBSET))
    for i in picked:
        plain.submit(trace[i]["prompt"], trace[i]["max_new_tokens"])
    plain.run()
    equal, tie_parted = 0, []
    for j, i in enumerate(picked):
        a, b = fast.output_tokens(i), plain.output_tokens(j)
        if np.array_equal(a, b):
            equal += 1
            continue
        t = int(np.nonzero(a != b)[0][0])
        with torch.no_grad():
            row = fwd(torch.as_tensor(a[None, :t], device=DEVICE).long())[0, -1].float()
        gap = float(row.max() - min(row[int(a[t])], row[int(b[t])]))
        if not gap <= TF_ATOL["bfloat16"]:
            raise AssertionError(f"10b fast path: request {i} parts from the plain engine at {t} where the "
                                 f"forward's logits are {gap:.3e} apart (not a tie)")
        tie_parted.append({"request": i, "position": t, "gap": gap})
    return {"compared": len(picked), "equal": equal, "parted_at_a_tie": tie_parted}


def llama_f32_engine(torch, f32, f32_twin, trace) -> dict:
    """[10c] The engine in f32 at Llama-3 8B's full depth on SERVE_LLAMA's
    pool geometry, every slot busy: each continuation held to the f32
    decode twin's own prefill over prompt + continuation within
    ``TF_ATOL["float32_llama"]``, which a slot reading wrong KV would miss
    by far more."""
    from distributeddataparallel_tpu_torch.serving import EngineConfig, InferenceEngine, run_load

    c = SERVE_LLAMA
    engine = InferenceEngine(f32, EngineConfig(num_slots=c["num_slots"], num_blocks=c["num_blocks"],
                                               block_size=c["block_size"], prefill_chunk=c["chunk"]))
    summary = run_load(engine, trace)
    if summary["completed"] != len(trace):
        raise AssertionError(f"10c f32 engine: {summary['completed']}/{len(trace)} completed")
    checks = []
    for r in sorted(engine.completed):
        tokens = torch.as_tensor(engine.output_tokens(r)[None], device=DEVICE).long()
        checks.append(hold_margins(torch, twin_prefill(torch, f32_twin, tokens[:, :-1]), tokens,
                                   engine.completed[r].prompt_len, TF_ATOL["float32_llama"],
                                   f"10c f32 engine request {r}"))
    step_ms = engine.decode_step_ms()
    del engine
    torch.cuda.empty_cache()
    return {"requests": len(trace), "decode_step_ms": step_ms,
            "tokens_checked": sum(k["tokens_checked"] for k in checks),
            "max_margin": max(k["max_margin"] for k in checks),
            "margins_over_1e-3": sum(k["margins_over_1e-3"] for k in checks), "atol": TF_ATOL["float32_llama"]}


def llama_serve_phase(torch, fa, smi) -> dict:
    """[10c] Llama-3 8B at full width and depth through the engine API: the
    engine in f32 on the burst's first 8 requests, then a burst of 16 in
    bf16; 2 of them held to the bf16 forward through K1 and to the bf16
    decode twin's own prefill."""
    import gc

    import numpy as np

    from distributeddataparallel_tpu_torch.models import transformer as tfm
    from distributeddataparallel_tpu_torch.models.generate import decode_model
    from distributeddataparallel_tpu_torch.serving import EngineConfig, InferenceEngine, run_load

    gc.collect()
    torch.cuda.empty_cache()
    c = SERVE_LLAMA
    cfg = tfm.llama3_8b(max_seq_len=c["max_seq_len"])
    rng = np.random.default_rng(c["seed"])
    lo, hi = c["prompt_len"]
    trace = [{"arrival_s": 0.0, "prompt": rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)),
                                                     dtype=np.int32), "max_new_tokens": c["output_len"]}
             for _ in range(c["requests"])]
    t0 = time.perf_counter()
    model = tfm.TransformerLM(cfg, device=DEVICE, generator=torch.Generator(device=DEVICE).manual_seed(c["seed"]))
    n_params = sum(p.numel() for p in model.parameters())
    build_s = time.perf_counter() - t0
    # Both paths in f32 at full depth on the first prompt, on the f32 masters.
    fa.reset_launches()
    f32 = forward_twin(torch, model, dtype=torch.float32)
    prompt = torch.as_tensor(trace[0]["prompt"][None], device=DEVICE).long()
    with torch.no_grad():
        want = f32(prompt).float()
    f32_twin = decode_model(f32)
    f32_dist = float((twin_prefill(torch, f32_twin, prompt) - want).abs().max())
    del want
    f32_launches = dict(fa.LAUNCHES)
    if not f32_dist <= LLAMA_F32_ATOL:
        raise AssertionError(f"10c: in f32 the decode twin's logits are {f32_dist:.3e} from the forward's "
                             f"(atol {LLAMA_F32_ATOL})")
    f32_engine = llama_f32_engine(torch, f32, f32_twin, trace[:c["num_slots"]])
    del f32, f32_twin
    t0 = time.perf_counter()
    dm = decode_model(model)  # bf16, cast once
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    build_s += time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(dm, EngineConfig(num_slots=c["num_slots"], num_blocks=c["num_blocks"],
                                              block_size=c["block_size"], prefill_chunk=c["chunk"]))
    fa.reset_launches()
    summary = run_load(engine, trace)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if summary["completed"] != len(trace) or any(launches.values()):
        raise AssertionError(f"10c: {summary['completed']}/{len(trace)} completed, launches {launches}")
    fwd = forward_twin(torch, dm)
    fa.reset_launches()
    checks = [teacher_forced(torch, fwd, engine.output_tokens(r)[None], engine.completed[r].prompt_len,
                             TF_ATOL["bfloat16_llama"], f"10c request {r}", dm) for r in (0, 1)]
    torch.cuda.synchronize()
    check_launches = dict(fa.LAUNCHES)
    if check_launches["flash_fwd"] != 2 * cfg.num_layers or f32_launches["flash_fwd"] != cfg.num_layers:
        raise AssertionError(f"10c: the checks launched {check_launches} and {f32_launches}, not K1 once per layer")
    out = {"num_params": n_params, "layers": cfg.num_layers, "max_seq_len": cfg.max_seq_len, "config": c,
           "build_s": build_s, "peak_memory_bytes": peak,
           # tokens of the decode steps (each request's first comes from its
           # prefill) over the time spent in them
           "decode_tok_s": (summary["tokens_out"] - summary["completed"]) / engine.decode_time_s,
           **{k: summary[k] for k in ("completed", "tokens_out", "elapsed_s", "serve_tok_s", "serve_p50_ttft_s",
                                       "serve_p99_ttft_s", "mean_tok_latency_s", "steps", "preemptions")},
           "decode_step_ms": engine.decode_step_ms(), "teacher_forced": checks,
           "f32_decode_vs_forward_max_abs": f32_dist, "f32_atol": LLAMA_F32_ATOL, "f32_engine": f32_engine,
           "attention_launches": launches,
           "check_launches": {k: check_launches[k] + f32_launches[k] for k in check_launches}}
    log(f"    10c llama-3 8B x32 layers: {out} on {smi}")
    del engine, dm, fwd
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serving_path_phase(torch, dpp, fa, smi) -> dict:
    """[10] Generation after training, the serving CLI, and the engine at
    Llama-3 8B's full depth; K1-K3's launches in each."""
    t0 = time.perf_counter()
    log("[10] serving path")
    out = {"generate": generate_phase(torch, dpp, fa, smi)}
    out["serve_gpt2"] = serve_phase(torch, fa, smi)
    out["serve_llama"] = llama_serve_phase(torch, fa, smi)
    runs = [r["attention_launches"] for r in out["generate"].values()]
    runs += [r["attention_launches"] for k, r in out["serve_gpt2"].items() if k != "decode_profile"]
    runs.append(out["serve_llama"]["attention_launches"])  # the checks' own launches stay apart
    out["attention_launches"] = {k: sum(r[k] for r in runs) for k in runs[0]}
    out["seconds"] = time.perf_counter() - t0
    log(f"    phase 10 in {out['seconds']:.1f} s; K1-K3 launches {out['attention_launches']}")
    return out


def powersgd_conservation(torch) -> dict:
    """PowerSGD's error feedback on the card at GPT-2's MLP kernel shape
    (768 x 3072, rank 4, one rank): ``err + m_hat`` equals ``g + err_prev``
    up to two f32 roundings of the largest element."""
    from distributeddataparallel_tpu_torch.parallel import powersgd

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    g = torch.randn(768, 3072, generator=gen, device=DEVICE)
    prev = 0.1 * torch.randn(768, 3072, generator=gen, device=DEVICE)
    state = [powersgd.PowerSGDLeaf(q=torch.randn(3072, 4, generator=gen, device=DEVICE), err=prev)]
    (m_hat,), (new,) = powersgd.powersgd_sync([g], state)
    want = g + prev
    err = float((new.err + m_hat - want).abs().max())
    # Two roundings (err = mat - m_hat, then err + m_hat), each within half
    # an ulp of the largest magnitude M involved: |diff| <= 2^-23 M; twice.
    big = max(float(t.abs().max()) for t in (want, m_hat, new.err))
    tol = 2 * 2.0 ** -23 * big
    if not err <= tol:
        raise AssertionError(f"11a: PowerSGD error feedback off by {err} > {tol}")
    return {"max_abs_err": err, "tolerance": tol}


def layouts_phase(torch, dpp, fa, smi) -> dict:
    """[11] The sharded update and the comm hooks: GPT-2 under each layout,
    Llama-3 8B under ZeRO-2 with low-bit moments, and the deepest Llama the
    int8 moments fit."""
    t0 = time.perf_counter()
    log("[11] the sharded update and the comm hooks")
    fa.reset_launches()
    out: dict = {"gpt2": {}, "llama": {}}
    for name, extra in LAYOUTS.items():
        release(torch)
        s = dpp.main(LAYOUT_ARGS + extra)
        torch.cuda.synchronize()
        losses = s["losses"]
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"11a {name}: losses {losses}")
        out["gpt2"][name] = {
            "flags": extra, "step_ms": s["step_time_s"] * 1e3, "peak_gib": s["peak_memory_bytes"] / 2**30,
            "losses": losses, "eval_loss": s["eval"]["loss"], "overlap_buckets": s["overlap_buckets"],
            "attention_launches": expect_launches(s, f"11a {name}"),
        }
        log(f"    11a {name}: step {s['step_time_s'] * 1e3:.1f} ms, peak {s['peak_memory_bytes'] / 2**30:.2f} GiB, "
            f"losses {['%.5f' % x for x in losses]}")
    plain = out["gpt2"]["plain"]["losses"]
    for name in ("overlap", "zero1", "zero2", "zero3"):
        run = out["gpt2"][name]
        diff = max(abs(a - b) for a, b in zip(run["losses"], plain))
        run.update(max_abs_diff_vs_plain=diff, bitwise_vs_plain=run["losses"] == plain)
        if not diff <= LAYOUT_ATOL:
            raise AssertionError(f"11a {name}: losses {run['losses']} vs plain {plain} (|diff| {diff})")
    buckets, steps = out["gpt2"]["overlap"]["overlap_buckets"], len(plain)
    if buckets["after_backward"] or not buckets["in_backward"] or buckets["in_backward"] % steps:
        raise AssertionError(f"11a overlap: bucket launches {buckets} over {steps} steps")
    out["overlap_buckets_per_step"] = buckets["in_backward"] // steps
    out["powersgd_conservation"] = powersgd_conservation(torch)
    log(f"    11a: |loss - plain| {{{', '.join(f'{k}: {out['gpt2'][k]['max_abs_diff_vs_plain']:.1e}' for k in ('overlap', 'zero1', 'zero2', 'zero3'))}}}, "
        f"{out['overlap_buckets_per_step']} buckets a step all from hooks; PowerSGD {out['powersgd_conservation']}")

    L = LLAMA_LAYERS
    for md in ("f32", "int8", "bf16"):
        release(torch)
        s = dpp.main(LLAMA_ZERO_ARGS + ["--moment-dtype", md])
        torch.cuda.synchronize()
        out["llama"][md] = llama_zero_record(s, L, f"11b {md}")
    total = torch.cuda.get_device_properties(0).total_memory
    release(torch)
    args = LLAMA_ZERO_ARGS + ["--moment-dtype", "int8", "--layers", str(LLAMA_DEEP_LAYERS), "--steps-per-epoch", "3"]
    s = run_entry(args, f"11b int8 at {LLAMA_DEEP_LAYERS} layers",
                  env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    deep = llama_zero_record(s, LLAMA_DEEP_LAYERS, f"11b int8 x{LLAMA_DEEP_LAYERS}")
    deep["spare_gib"] = (total - s["peak_memory_bytes"]) / 2**30
    deep["kept_spare"] = deep["spare_gib"] >= LLAMA_SPARE_GIB
    out["llama"][f"int8_{LLAMA_DEEP_LAYERS}_layers"] = deep
    out["card_gib"] = total / 2**30
    log(f"    11b: {LLAMA_DEEP_LAYERS} layers, peak {deep['peak_gib']:.2f} GiB of {total / 2**30:.2f}: "
        f"{deep['spare_gib']:.2f} GiB spare ({'kept' if deep['kept_spare'] else 'NOT kept'} "
        f"{LLAMA_SPARE_GIB} GiB)")
    # The in-process runs' counts, and the deep run's own (its process's).
    out["attention_launches"] = {k: n + deep["attention_launches"][k] for k, n in fa.LAUNCHES.items()}
    out["seconds"] = time.perf_counter() - t0
    log(f"    phase 11 in {out['seconds']:.1f} s; K1-K3 launches {out['attention_launches']} on {smi}")
    return out


def _chunk(t, j: int, n: int):
    L = t.shape[1] // n
    return t[:, j * L : (j + 1) * L].contiguous()


class LocalRing:
    """The flash ring's exchange (``context_parallel._Ring``'s ``idx``,
    ``n``, ``post``, ``wait``) among the ranks of a replay, each a thread of
    this process: ``post`` puts copies of the tensors in the next rank's
    mailbox, ``wait`` takes the previous rank's in post order (each rank
    posts the same sequence, as over a process group).  It keeps what it
    received, for ``CannedRing``.  With ``a2a`` (a mailbox per (receiver,
    sender) pair) it is also Ulysses' exchange: ``all_to_all``.  A wait that
    outlasts EXCHANGE_TIMEOUT_S raises: a replay fails, it never hangs."""

    def __init__(self, boxes, idx: int, a2a=None):
        self.boxes, self.idx, self.n, self.a2a = boxes, idx, len(boxes), a2a
        self.sent, self.received = 0, []

    def post(self, tensors):
        tag = self.sent
        self.sent += 1
        self.boxes[(self.idx + 1) % self.n].put((tag, [t.clone() for t in tensors]))
        return tag

    def wait(self, tag):
        got, tensors = self.boxes[self.idx].get(timeout=EXCHANGE_TIMEOUT_S)
        if got != tag:
            raise AssertionError(f"rank {self.idx} waited for exchange {tag}, got {got}")
        self.received.append(tensors)
        return tensors

    def all_to_all(self, x):
        """Ulysses' exchange among the replay's ranks, differentiable (its
        backward is the same exchange of the gradient): block j of ``x``
        goes to rank j, block j of the result came from rank j."""
        import torch

        if not _ALL_TO_ALL:
            class AllToAll(torch.autograd.Function):
                @staticmethod
                def forward(ctx, x, ring):
                    ctx.ring = ring
                    return ring.exchange_blocks(x)

                @staticmethod
                def backward(ctx, g):
                    return ctx.ring.exchange_blocks(g), None

            _ALL_TO_ALL.append(AllToAll)
        return _ALL_TO_ALL[0].apply(x, self)

    def exchange_blocks(self, x):
        import queue

        for j in range(self.n):
            if j != self.idx:
                self.a2a[j, self.idx].put(x[j].detach().clone())
        out = x.detach().clone()
        for j in range(self.n):
            if j != self.idx:
                try:
                    out[j] = self.a2a[self.idx, j].get(timeout=EXCHANGE_TIMEOUT_S)
                except queue.Empty:
                    raise AssertionError(f"rank {self.idx} waited {EXCHANGE_TIMEOUT_S} s for rank {j}'s "
                                         f"all-to-all block") from None
        return out


_ALL_TO_ALL: list = []  # LocalRing.all_to_all's autograd Function, made at its first use


class CannedRing:
    """One rank's exchange run alone: ``wait`` gives back what its
    ``LocalRing`` received, in order, and ``post`` sends nowhere.  Times
    one rank's hops through the module's own loop."""

    def __init__(self, idx: int, n: int, received):
        self.idx, self.n, self.received, self.sent = idx, n, received, 0

    def post(self, tensors):
        self.sent += 1
        return self.sent - 1

    def wait(self, tag):
        return self.received[tag]


def ring_replay(torch, cp, q, k, v, do, n: int) -> dict:
    """[12a] ``parallel.context_parallel``'s flash ring, its own forward and
    backward loops (hop order, the lse merge, the dq and travelling dk/dv
    accumulators, the final rotation), for every rank of an ``n``-way axis:
    each rank a thread of this process, stepping with the others through
    ``LocalRing``.  Returns the global out, lse, dq, dk, dv and, under
    ``received``, each rank's (forward, backward) receipts."""
    import queue
    import threading

    boxes = {"fwd": [queue.Queue() for _ in range(n)], "bwd": [queue.Queue() for _ in range(n)]}
    results, errors = [None] * n, []

    def rank(r):
        try:
            ring_f, ring_b = LocalRing(boxes["fwd"], r), LocalRing(boxes["bwd"], r)
            qr, kr, vr, dr = (_chunk(t, r, n) for t in (q, k, v, do))
            out, lse = cp.flash_ring_forward(qr, kr, vr, ring_f)
            dq, dk, dv = cp.flash_ring_backward(qr, kr, vr, out, lse, dr, ring_b)
            results[r] = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv,
                          "received": (ring_f.received, ring_b.received)}
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=4 * EXCHANGE_TIMEOUT_S)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"ring replay: a rank did not finish in {4 * EXCHANGE_TIMEOUT_S} s")
    out = {key: torch.cat([res[key] for res in results], dim=2 if key == "lse" else 1)
           for key in ("out", "lse", "dq", "dk", "dv")}
    out["received"] = [res["received"] for res in results]
    return out


def plain_ring(torch, fa, cp, q, k, v, do, n: int) -> dict:
    """[12a] The ring replay's oracle: every rank's live hops one after the
    other through K1-K3's plain versions, merged by ``cp.ring_merge``,
    dq summed in q's dtype in hop order and each chunk's dk/dv in k's
    dtype in the order the ring carries them (its owner's diagonal hop
    first, then ranks j+1 .. n-1).  Global out, lse, dq, dk, dv."""
    outs, lses, dqs, dks, dvs = [], [], [], [None] * n, [None] * n
    for r in range(n):
        qr, dor = _chunk(q, r, n), _chunk(do, r, n)
        hops = [(s, _chunk(k, r - s, n), _chunk(v, r - s, n)) for s in range(n) if cp.hop_live(r, s)]
        of, lse = None, None
        for s, kc, vc in hops:
            oh, lseh = fa.flash_fwd_plain(qr, kc, vc, causal=s == 0)
            of, lse = (oh.float(), lseh) if s == 0 else cp.ring_merge(of, lse, oh, lseh)
        out = of.to(q.dtype)
        delta = fa.attention_delta(out, dor)
        dq = None
        for s, kc, vc in hops:
            dq_h = fa.flash_bwd_dq_plain(qr, kc, vc, dor, lse, delta, causal=s == 0)
            dk_h, dv_h = fa.flash_bwd_dkv_plain(qr, kc, vc, dor, lse, delta, causal=s == 0)
            dq = dq_h if dq is None else dq + dq_h
            j = r - s
            dks[j] = dk_h if dks[j] is None else dks[j] + dk_h
            dvs[j] = dv_h if dvs[j] is None else dvs[j] + dv_h
        outs.append(out)
        lses.append(lse)
        dqs.append(dq)
    cat = lambda ts, dim=1: torch.cat(ts, dim=dim)
    return {"out": cat(outs), "lse": cat(lses, 2), "dq": cat(dqs), "dk": cat(dks), "dv": cat(dvs)}


def full_oracle(fa, q, k, v, do) -> dict:
    """One full-sequence K1-K3 call (causal)."""
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.attention_delta(out, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    return {"out": out, "lse": lse, "dq": fa.flash_bwd_dq(q, k, v, do, lse, delta, True), "dk": dk, "dv": dv}


def hold(torch, got: dict, ref: dict, dtype: str, slack: dict, what: str) -> dict:
    """Max abs error of each output, each within TOL (lse: f32's) plus
    ``slack[key]`` (rtol, of-max) where given; raises otherwise."""
    errs = {}
    for key, x in got.items():
        if key == "received":
            continue
        atol, rtol = TOL["float32" if key == "lse" else dtype]
        a, b = x.float(), ref[key].float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: {key} has non-finite values")
        extra_rtol, of_max = slack.get(key, (0.0, 0.0))
        err = (a - b).abs()
        bound = atol + (rtol + extra_rtol) * b.abs() + of_max * float(b.abs().max())
        errs[key] = float(err.max())
        if dtype == "bfloat16" and key != "lse":
            errs[f"{key}_bf16_ulps_of_max"] = errs[key] / (ULP_BF16 * float(b.abs().max()))
        if (err > bound).any():
            raise AssertionError(f"{what}: {key} off at {int((err > bound).sum())} entries (max abs err "
                                 f"{errs[key]:.3e}; atol {atol}, rtol {rtol} + {extra_rtol}, {of_max} of max)")
    log(f"    {what}: " + "  ".join(f"{k} {e:.2e}" for k, e in errs.items() if "ulps" not in k))
    return errs


def ring_timing(torch, fa, cp, q, k, v, do, n: int, received) -> dict:
    """Device and host ms of each rank's forward and backward through the
    module's loops (``CannedRing``: the exchange replays what the rank
    received in ``ring_replay``, so no transfer is timed), of the merges
    alone, and of one full-sequence K1-K3 call."""
    def rank_run(r):
        qr, kr, vr, dr = (_chunk(t, r, n) for t in (q, k, v, do))
        out, lse = cp.flash_ring_forward(qr, kr, vr, CannedRing(r, n, received[r][0]))
        cp.flash_ring_backward(qr, kr, vr, out, lse, dr, CannedRing(r, n, received[r][1]))

    ranks = []
    for r in range(n):
        ms, host_ms = time_ms(torch, lambda: rank_run(r), 10)
        ranks.append({"rank": r, "hops": r + 1, "ms": ms, "host_ms": host_ms, "host_ms_per_hop": host_ms / (r + 1)})
    last = n - 1
    oh, lse = fa.flash_fwd(_chunk(q, last, n), _chunk(k, last, n), _chunk(v, last, n), True)
    of = oh.float()
    merge_ms = time_ms(torch, lambda: cp.ring_merge(of, lse, oh, lse), 20)[0]
    full_ms, full_host = time_ms(torch, lambda: full_oracle(fa, q, k, v, do), 10)
    busiest = ranks[last]
    return {"ranks": ranks, "full_sequence_ms": full_ms, "full_sequence_host_ms": full_host,
            "merge_ms": merge_ms, "merge_share_busiest_rank": (n - 1) * merge_ms / busiest["ms"],
            "busiest_rank_over_full": busiest["ms"] / full_ms}


def ulysses_replay(torch, cp, q, k, v, do, n: int) -> dict:
    """[12a] ``parallel.context_parallel``'s Ulysses (``ulysses_ranks``: the
    kv repeat to lcm(Hkv, n) where ``n`` does not divide the kv heads, the
    exchanges' block layouts, FlashAttention over the whole sequence on each
    rank's heads) for every rank of an ``n``-way axis in this process, the
    all-to-all done in memory, the backward through autograd.  Returns the
    global out, dq, dk, dv."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    chunks = [[_chunk(t, r, n) for r in range(n)] for t in leaves]
    exchange = lambda ys: [torch.stack([y[r] for y in ys]) for r in range(n)]
    out = torch.cat(cp.ulysses_ranks(*chunks, n, exchange, causal=True, impl="kernel"), dim=1)
    out.backward(do)
    return {"out": out.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad, "dv": leaves[2].grad}


def tp_block_replay(torch, tfm, dtype) -> dict:
    """[12b] One Llama-3 8B block (bf16 on f32 params) and its tp=2 column /
    row shards run one after the other on this card: the shards'
    attention and MLP partials summed (the forward all-reduce) ahead of
    each residual, against the unsharded block; output, input gradient
    and every parameter's gradient (the shards' merged)."""
    from distributeddataparallel_tpu_torch.ops.attention import rope_frequencies
    from distributeddataparallel_tpu_torch.parallel.tensor_parallel import merge_tp_shards, shard_state_dict_tp

    tp, B, S = TP_BLOCK["tp"], TP_BLOCK["B"], TP_BLOCK["S"]
    cfg = tfm.llama3_8b(num_layers=1, max_seq_len=S)
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    full = tfm.DecoderBlock(cfg, device=DEVICE)
    with torch.no_grad():
        for p in full.parameters():
            p.normal_(0.0, 0.02, generator=gen) if p.dim() > 1 else p.fill_(1.0)
    local_cfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.kv_heads // tp,
                                    d_ff=cfg.d_ff // tp, head_dim=cfg.dims_per_head)
    shards = []
    for r in range(tp):
        blk = tfm.DecoderBlock(local_cfg, device=DEVICE)
        blk.load_state_dict(shard_state_dict_tp(full.state_dict(), r, tp))
        shards.append(blk)
    rope = rope_frequencies(cfg.dims_per_head, S, theta=cfg.rope_theta, device=DEVICE)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=DEVICE).to(dtype)
    g = torch.randn(B, S, cfg.d_model, generator=gen, device=DEVICE).to(dtype)
    xf = x.clone().requires_grad_()
    ref_out = full(xf, rope)
    ref_out.backward(g)
    xs = x.clone().requires_grad_()
    y = shards[0].attn_norm(xs)
    x1 = xs + sum(blk.attn(y, rope) for blk in shards)
    z = shards[0].mlp_norm(x1)
    out = x1 + sum(blk.mlp(z) for blk in shards)
    out.backward(g)
    grads = merge_tp_shards([{n: p.grad for n, p in blk.named_parameters() if p.grad is not None}
                             for blk in shards])
    got = {"out": out.detach(), "dx": xs.grad, **{f"d:{n}": grads[n] for n in sorted(grads)}}
    want = {"out": ref_out.detach(), "dx": xf.grad, **{f"d:{n}": p.grad for n, p in sorted(full.named_parameters())}}
    errs, ulps = {}, {}
    for key in want:
        a, b = got[key].float(), want[key].float()
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        errs[key], ulps[key] = err, err / (ULP_BF16 * scale)
        if not math.isfinite(err) or err > 4 * ULP_BF16 * scale:
            raise AssertionError(f"12b: {key} off by {err:.3e} > 4 bf16 ulps of its largest |value| {scale:.3e}")
    log(f"    12b tp={tp} block B={B} S={S}: out {errs['out']:.2e}, dx {errs['dx']:.2e}, largest weight-gradient "
        f"error {max(v for k, v in errs.items() if k.startswith('d:')):.2e}")
    log(f"    12b in bf16 ulps of each tensor's largest |value|: out {ulps['out']:.2f}, dx {ulps['dx']:.2f}, "
        f"weight gradients up to {max(v for k, v in ulps.items() if k.startswith('d:')):.2f}")
    return {"shapes": dict(TP_BLOCK, d_model=cfg.d_model, d_ff=cfg.d_ff, local_heads=local_cfg.num_heads,
                           local_kv_heads=local_cfg.num_kv_heads), "max_abs_err": errs, "bf16_ulps_of_max": ulps}


def cp_tp_entry(torch, smi) -> dict:
    """[12c] The entry point over NCCL on two GPUs: Llama-3 8B x 8 layers
    under ``--cp 2`` (ring, Ulysses) and ``--tp 2`` against one GPU on the
    same global batch (one data replica: the ranks split its sequence or
    its heads); with four, ``--cp 4`` and ``--cp 2 --tp 2`` too.  Only
    where two GPUs are visible."""
    count = torch.cuda.device_count()
    if count < 2:
        log(f"    12c needs two GPUs and was not run: {count} visible")
        return {"ran": False, "gpus": count}
    base = run_entry(CP_TP_ENTRY_ARGS, "12c one GPU")
    out = {"ran": True, "gpus": count, "one_gpu": {"losses": base["losses"], "step_ms": base["step_time_s"] * 1e3}}
    runs = [(name, extra, 2) for name, extra in CP_TP_ENTRY.items()]
    if count >= 4:
        runs += [(name, extra, 4) for name, extra in CP_TP_ENTRY_4.items()]
    import glob

    from distributeddataparallel_tpu_torch.parallel.overlap import overlap_report, trace_kernels

    for name, extra, gpus in runs:
        with tempfile.TemporaryDirectory(prefix="cp_tp_ev_") as ev:
            # The ring runs trace steps 1-2 on every rank: the NCCL kernels'
            # time and the part of it under the hops' kernels.
            prof = ["--events-dir", ev, "--profile-steps", "1:3"] if "ring" in name else []
            s = run_entry(CP_TP_ENTRY_ARGS + extra + ["--num-processes", str(gpus)] + prof, f"12c {name}")
            exchange = [overlap_report(trace_kernels(path))
                        for path in sorted(glob.glob(os.path.join(ev, "xprof", "trace_*_p*.json")))]
        diff = max(abs(a - b) for a, b in zip(s["losses"], base["losses"]))
        out[name] = {"gpus": gpus, "losses": s["losses"], "step_ms": s["step_time_s"] * 1e3, "max_abs_diff": diff,
                     "peak_memory_bytes": s["peak_memory_bytes"], "attention_launches": s["attention_launches"],
                     "exchange_by_rank": exchange}
        if not diff <= CP_TP_ENTRY_ATOL:
            raise AssertionError(f"12c {name}: losses {s['losses']} vs one GPU {base['losses']}")
        log(f"    12c {name}: step {out[name]['step_ms']:.1f} ms, |loss - one GPU| {diff:.2e} on {smi}")
    return out


def cp_tp_phase(torch, fa, tfm, smi) -> dict:
    """[12] Context and tensor parallelism: the flash ring's and Ulysses'
    call patterns of K1-K3 and a TP block, replayed on this card."""
    from distributeddataparallel_tpu_torch.parallel import context_parallel as cp

    t0 = time.perf_counter()
    log("[12] context and tensor parallelism (replays on one card)")
    out: dict = {"launches": {}}
    c = CP_RING
    n = c["n"]
    q, k, v, do = inputs(torch, c, 120)
    fa.reset_launches()
    oracle = full_oracle(fa, q, k, v, do)
    replay = ring_replay(torch, cp, q, k, v, do, n)
    torch.cuda.synchronize()
    want = {name: 1 + sum(r + 1 for r in range(n)) for name in fa.LAUNCHES}
    if fa.LAUNCHES != want:
        raise AssertionError(f"12a ring launches {fa.LAUNCHES} != {want} (the replay's 1 + r a rank, and the oracle's 1)")
    out["launches"]["ring_s8192"] = dict(fa.LAUNCHES)
    slack = {key: (0.0, n * ULP_BF16) for key in ("dq", "dk", "dv")}
    out["ring_s8192_vs_full"] = hold(torch, replay, oracle, c["dtype"], slack, f"12a ring n={n} S={c['Sq']} vs one call")
    slack = {key: (0.0, (n - 1) * ULP_BF16) for key in ("dq", "dk", "dv")}
    out["ring_s8192_vs_plain"] = hold(torch, replay, plain_ring(torch, fa, cp, q, k, v, do, n), c["dtype"], slack,
                                      f"12a ring n={n} S={c['Sq']} vs plain")
    out["ring_timing"] = ring_timing(torch, fa, cp, q, k, v, do, n, replay["received"])
    rt_ = out["ring_timing"]
    log(f"    12a ring per rank ms {[round(x['ms'], 3) for x in rt_['ranks']]} (host ms per hop "
        f"{[round(x['host_ms_per_hop'], 3) for x in rt_['ranks']]}); one call at S={c['Sq']} {rt_['full_sequence_ms']:.3f} ms; "
        f"merge {rt_['merge_ms']:.3f} ms, {rt_['merge_share_busiest_rank']:.1%} of the busiest rank on {smi}")
    for name, m in ULYSSES_N.items():
        fa.reset_launches()
        got = ulysses_replay(torch, cp, q, k, v, do, m)
        torch.cuda.synchronize()
        if fa.LAUNCHES != {k_: m for k_ in fa.LAUNCHES}:
            raise AssertionError(f"12a ulysses {name}: launches {fa.LAUNCHES}, want {m} each")
        out["launches"][f"ulysses_{name}"] = dict(fa.LAUNCHES)
        rep = cp.ulysses_kv_repeat(c["H"], c["Hkv"], m)
        slack = {key: (0.0, (rep - 1) * ULP_BF16) for key in ("dk", "dv")}
        out[f"ulysses_{name}"] = hold(torch, got, {kk: oracle[kk] for kk in got}, c["dtype"], slack,
                                      f"12a ulysses {name} (Hkv {k.shape[2]} on {m}) vs one call")
    del q, k, v, do, oracle, replay
    cs = CP_RING_PLAIN
    q, k, v, do = inputs(torch, cs, 121)
    fa.reset_launches()
    got = ring_replay(torch, cp, q, k, v, do, cs["n"])
    plain = plain_ring(torch, fa, cp, q, k, v, do, cs["n"])
    out["launches"]["ring_s2048"] = dict(fa.LAUNCHES)
    slack = {key: (0.0, (cs["n"] - 1) * ULP_BF16) for key in ("dq", "dk", "dv")}
    out["ring_s2048_vs_plain"] = hold(torch, got, plain, cs["dtype"], slack, f"12a ring n={cs['n']} S={cs['Sq']} vs plain")
    cf = CP_RING_F32
    q, k, v, do = inputs(torch, cf, 122)
    fa.reset_launches()
    oracle = full_oracle(fa, q, k, v, do)
    got = ring_replay(torch, cp, q, k, v, do, cf["n"])
    out["launches"]["ring_f32"] = dict(fa.LAUNCHES)
    out["ring_f32_vs_full"] = hold(torch, got, oracle, cf["dtype"], {}, f"12a ring f32 n={cf['n']} S={cf['Sq']} vs one call")
    del q, k, v, do, oracle, got, plain
    fa.reset_launches()
    out["tp_block"] = tp_block_replay(torch, tfm, torch.bfloat16)
    torch.cuda.synchronize()
    tp = TP_BLOCK["tp"]
    if fa.LAUNCHES != {k_: 1 + tp for k_ in fa.LAUNCHES}:
        raise AssertionError(f"12b launches {fa.LAUNCHES}, want {1 + tp} each (the shards' and the full block's)")
    out["launches"]["tp_block"] = dict(fa.LAUNCHES)
    release(torch)
    out["entry"] = cp_tp_entry(torch, smi)
    # The replays' launches as the path runs them: every replay but the
    # oracle calls and the plain comparison's own.
    L = out["launches"]
    out["attention_launches"] = {k_: L["ring_s8192"][k_] - 1 + L["ulysses_native_n4"][k_] + L["ulysses_expand_n16"][k_]
                                 + L["ring_s2048"][k_] + L["ring_f32"][k_] - 1 + L["tp_block"][k_] - 1
                                 for k_ in fa.LAUNCHES}
    out["gpus"] = torch.cuda.device_count()
    out["seconds"] = time.perf_counter() - t0
    log(f"    phase 12 in {out['seconds']:.1f} s; K1-K3 launches {out['attention_launches']} on {smi}")
    return out


def gib(nbytes) -> str:
    return "n/a" if nbytes is None else f"{nbytes / 2**30:.2f}"


def expect_remat_launches(s: dict, layers: int, what: str) -> dict:
    """A Llama run's K1-K3 launches under remat: K1 twice a layer a step
    (forward and recompute) and once a layer an eval batch, K2 and K3 once
    a layer a step."""
    steps, evals, got = s["train_steps"], s["eval_batches"], s["attention_launches"]
    want = {"flash_fwd": layers * (2 * steps + evals), "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")
    return got


def fsdp_collectives(s: dict, layers: int, remat: bool, what: str) -> dict:
    """A run's FSDP gathers and scatters, as its layers imply: under remat
    each step gathers every layer twice (forward and recompute) and the
    rest flat four times (embed and head, each recomputed), without remat
    once and twice; each eval batch gathers L + 2 times; each step
    scatters L + 2 times (the rest once for each of its uses)."""
    steps, evals = s["train_steps"], s["eval_batches"]
    want = {"gather": steps * (layers + 2) * (2 if remat else 1) + evals * (layers + 2),
            "scatter": steps * (layers + 2)}
    if s["fsdp_collectives"] != want:
        raise AssertionError(f"{what}: FSDP collectives {s['fsdp_collectives']} != {want}")
    return want


def fsdp_llama(torch, dpp, llama_losses, smi) -> dict:
    """[13a] Phase 7's arguments under --fsdp, f32 then bf16 gathers."""
    out, L = {}, LLAMA_LAYERS
    for name, extra in FSDP_LLAMA.items():
        release(torch)
        log(f"    13a {name}: dpp.main " + " ".join(LLAMA_ARGS + extra))
        s = dpp.main(LLAMA_ARGS + extra)
        torch.cuda.synchronize()
        steps, evals, losses = s["train_steps"], s["eval_batches"], s["losses"]
        launches = expect_remat_launches(s, L, f"13a {name}")
        if s["layout"] != "fsdp" or not math.isfinite(s["eval"]["loss"]):
            raise AssertionError(f"13a {name}: layout {s['layout']}, eval {s['eval']}")
        diff = max(abs(a - b) for a, b in zip(losses, llama_losses))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, llama_losses))
        ok = diff <= FSDP_LOSS_ATOL if name == "f32_gather" else rel <= FSDP_BF16_RTOL
        if steps != len(llama_losses) or not ok:
            raise AssertionError(f"13a {name}: losses {losses} vs phase 7's {llama_losses} "
                                 f"(|diff| {diff:.3e}, rel {rel:.3e})")
        out[name] = {"flags": extra, "losses": losses, "max_abs_diff_vs_phase7": diff,
                     "max_rel_diff_vs_phase7": rel, "bitwise_vs_phase7": losses == llama_losses,
                     "step_ms": s["step_time_s"] * 1e3, "tokens_per_s": s["tokens_per_s"],
                     "peak_memory_bytes": s["peak_memory_bytes"], "eval": s["eval"], "eval_batches": evals,
                     "fsdp_collectives": fsdp_collectives(s, L, True, f"13a {name}"), "attention_launches": launches}
        log(f"    13a {name}: step {out[name]['step_ms']:.1f} ms, peak {gib(s['peak_memory_bytes'])} GiB, "
            f"|loss - phase 7| {diff:.3e} ({'bitwise' if out[name]['bitwise_vs_phase7'] else 'not bitwise'}), "
            f"eval {s['eval']['loss']:.4f}, collectives {s['fsdp_collectives']} on {smi}")
    return out


def fsdp_gpt2(torch, dpp, plain_losses, smi) -> dict:
    """[13b] GPT-2 under --fsdp, checkpointed, then --generate 16 through
    the host gather, held to the checkpoint's whole model."""
    from distributeddataparallel_tpu_torch.models import transformer as tfm
    from distributeddataparallel_tpu_torch.models.generate import decode_model
    from distributeddataparallel_tpu_torch.training.checkpoint import CheckpointFiles

    release(torch)
    with tempfile.TemporaryDirectory(prefix="fsdp_13b_") as d:
        args = [a.replace("{ckpt}", d) for a in FSDP_GPT2_ARGS]
        log("    13b: dpp.main " + " ".join(args))
        s = dpp.main(args)
        torch.cuda.synchronize()
        payload = CheckpointFiles(d).read(0)
    launches = expect_launches(s, "13b")
    diff = max(abs(a - b) for a, b in zip(s["losses"], plain_losses))
    if payload.get("layout") != "fsdp" or not diff <= LAYOUT_ATOL:
        raise AssertionError(f"13b: layout {payload.get('layout')}, losses {s['losses']} vs 11a plain "
                             f"{plain_losses}")
    cfg = dpp.build_config(dpp.parse_args(args))
    model = tfm.TransformerLM(dataclasses.replace(cfg, attn_impl="plain"), device=DEVICE)
    model.load_state_dict(payload["model"])
    gen = s["generate"]
    n_prompt = len(gen["prompt"][0])
    check = teacher_forced(torch, model, gen["tokens"], n_prompt, TF_ATOL["float32"], "13b", decode_model(model))
    out = {"losses": s["losses"], "max_abs_diff_vs_11a_plain": diff, "bitwise_vs_11a_plain": s["losses"] == plain_losses,
           "step_ms": s["step_time_s"] * 1e3, "peak_memory_bytes": s["peak_memory_bytes"], "eval": s["eval"],
           "new_tokens": len(gen["tokens"][0]) - n_prompt, "prefill_ms": gen["prefill_ms"],
           "decode_ms_per_token": gen["decode_ms_per_token"], "teacher_forced": check,
           "fsdp_collectives": fsdp_collectives(s, 12, False, "13b"), "attention_launches": launches}
    log(f"    13b: step {out['step_ms']:.1f} ms, |loss - 11a plain| {diff:.2e}, generated "
        f"{out['new_tokens']} tokens, teacher-forced {check} on {smi}")
    del model
    return out


def fsdp_entry(torch, smi) -> dict:
    """[13c] Only where four GPUs are visible: Llama-3 8B at all 32 layers
    under --fsdp over NCCL, and at 8 layers against plain DP on the same
    GPUs."""
    count = torch.cuda.device_count()
    if count < FSDP_ENTRY_GPUS:
        log(f"    13c needs {FSDP_ENTRY_GPUS} GPUs and was not run: {count} visible")
        return {"ran": False, "gpus": count}
    procs = ["--num-processes", str(FSDP_ENTRY_GPUS)]
    out = {"ran": True, "gpus": count}
    deep = run_entry(FSDP_DEEP_ARGS + ["--layers", "32", "--fsdp"] + procs, "13c 32 layers --fsdp")
    out["llama_32_layers"] = {"losses": deep["losses"], "step_ms": deep["step_time_s"] * 1e3,
                              "peak_memory_bytes_rank0": deep["peak_memory_bytes"], "num_params": deep["num_params"]}
    plain = run_entry(FSDP_DEEP_ARGS + procs, "13c 8 layers plain DP")
    sharded = run_entry(FSDP_DEEP_ARGS + ["--fsdp"] + procs, "13c 8 layers --fsdp")
    diff = max(abs(a - b) for a, b in zip(sharded["losses"], plain["losses"]))
    out["llama_8_layers"] = {"plain_losses": plain["losses"], "fsdp_losses": sharded["losses"], "max_abs_diff": diff,
                             "plain_step_ms": plain["step_time_s"] * 1e3, "fsdp_step_ms": sharded["step_time_s"] * 1e3,
                             "plain_peak_memory_bytes": plain["peak_memory_bytes"],
                             "fsdp_peak_memory_bytes": sharded["peak_memory_bytes"]}
    if not all(math.isfinite(x) for x in deep["losses"]) or not diff <= CP_TP_ENTRY_ATOL:
        raise AssertionError(f"13c: 32 layers {deep['losses']}; 8 layers {sharded['losses']} vs {plain['losses']}")
    log(f"    13c: 32 layers {out['llama_32_layers']}; 8 layers |loss - plain DP| {diff:.2e} on {smi}")
    return out


def fsdp_phase(torch, dpp, fa, llama_losses, plain_gpt2_losses, smi) -> dict:
    """[13] FSDP: 13a, 13b on this card, 13c with four GPUs."""
    from distributeddataparallel_tpu_torch.parallel import fsdp

    t0 = time.perf_counter()
    log("[13] FSDP")
    fa.reset_launches()
    fsdp.reset_counts()
    out = {"llama": fsdp_llama(torch, dpp, llama_losses, smi), "gpt2": fsdp_gpt2(torch, dpp, plain_gpt2_losses, smi)}
    out["attention_launches"] = dict(fa.LAUNCHES)
    out["fsdp_counts"] = dict(fsdp.COUNTS)
    out["entry"] = fsdp_entry(torch, smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"    phase 13 in {out['seconds']:.1f} s; K1-K3 launches {out['attention_launches']} on {smi}")
    return out


def moe_llama(torch, dpp, smi) -> dict:
    """[14a] Llama-3 8B width x 1 layer, 8 experts top-2, token choice."""
    release(torch)
    log("    14a: dpp.main " + " ".join(LLAMA_MOE_ARGS))
    s = dpp.main(LLAMA_MOE_ARGS)
    torch.cuda.synchronize()
    losses, aux = s["losses"], s["moe_aux"]
    launches = expect_remat_launches(s, MOE_LAYERS, "14a")
    if s["train_steps"] != 10 or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"14a: losses {losses}")
    if not aux or len(aux) != len(losses) or not all(math.isfinite(a) and a >= 1.0 - 1e-4 for a in aux):
        raise AssertionError(f"14a: moe_aux {aux} (1 at perfect balance)")
    if not math.isfinite(s["eval"]["loss"]):
        raise AssertionError(f"14a: eval {s['eval']}")
    out = {"flags": LLAMA_MOE_ARGS, "num_params": s["num_params"], "losses": losses, "moe_aux": aux,
           "step_ms": s["step_time_s"] * 1e3, "tokens_per_s": s["tokens_per_s"],
           "peak_memory_bytes": s["peak_memory_bytes"], "eval": s["eval"], "eval_batches": s["eval_batches"],
           "attention_launches": launches}
    log(f"    14a: step {out['step_ms']:.1f} ms, peak {gib(s['peak_memory_bytes'])} GiB, "
        f"{s['num_params'] / 1e9:.3f} B params, losses {['%.4f' % x for x in losses]}, "
        f"moe_aux {['%.4f' % a for a in aux]} on {smi}")
    return out


def moe_no_sync(torch, tfm) -> dict:
    """[14a] One MoE block at 14a's widths, forward and backward, under
    ``torch.cuda.set_sync_debug_mode("error")``: any op that makes the
    host wait for the device raises.  A first pass outside the mode builds
    what the first call builds (cuBLAS handles, the kernels' load)."""
    release(torch)
    cfg = tfm.llama3_8b(num_layers=1, max_seq_len=2048, moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
                        remat=False)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    blk = tfm.DecoderBlock(cfg, device=DEVICE)
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    rope = tfm.rope_frequencies(cfg.dims_per_head, cfg.max_seq_len, theta=cfg.rope_theta, device=DEVICE)
    x = torch.randn(2, 2048, cfg.d_model, device=DEVICE, generator=gen).to(cfg.dtype).requires_grad_()

    def step():
        y, aux = blk(x, rope)
        (y.float().pow(2).mean() + aux).backward()

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out = {"block_params": sum(p.numel() for p in blk.parameters()), "synchronising_ops": 0,
           "router_grad_finite": bool(torch.isfinite(blk.mlp.router.weight.grad).all())}
    del blk, x
    return out


def moe_gpt2(torch, dpp, smi) -> dict:
    """[14b] GPT-2 124M x 12 layers with 8 dense-dispatch experts, then
    --generate 16, held to the trained whole model: ``dpp.build_trainer``
    and ``dpp.train`` in this process (what ``dpp.main`` runs), so the
    trained model is at hand without a 6.3 GB checkpoint of it."""
    from distributeddataparallel_tpu_torch.models import transformer as tfm
    from distributeddataparallel_tpu_torch.models.generate import decode_model
    from distributeddataparallel_tpu_torch.runtime import distributed as rt

    release(torch)
    args = dpp.parse_args(GPT2_MOE_ARGS)
    device = dpp.device_for(args)
    log("    14b: dpp.build_trainer, dpp.train " + " ".join(GPT2_MOE_ARGS))
    rt.init_process_group(device=device)
    try:
        trainer = dpp.build_trainer(args, device)
        s = dpp.train(args, trainer, device)
        torch.cuda.synchronize()
    finally:
        rt.destroy_process_group()
    trained = trainer.state.model.state_dict()
    del trainer
    launches = expect_launches(s, "14b")
    losses = s["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0] or not s["moe_aux"]:
        raise AssertionError(f"14b: losses {losses}, moe_aux {s['moe_aux']}")
    cfg = dpp.build_config(args)
    model = tfm.TransformerLM(dataclasses.replace(cfg, attn_impl="plain"), device=DEVICE)
    model.load_state_dict(trained)
    del trained
    gen = s["generate"]
    n_prompt = len(gen["prompt"][0])
    check = teacher_forced(torch, model, gen["tokens"], n_prompt, TF_ATOL["float32"], "14b", decode_model(model))
    out = {"losses": losses, "moe_aux": s["moe_aux"], "step_ms": s["step_time_s"] * 1e3,
           "peak_memory_bytes": s["peak_memory_bytes"], "num_params": s["num_params"], "eval": s["eval"],
           "new_tokens": len(gen["tokens"][0]) - n_prompt, "prefill_ms": gen["prefill_ms"],
           "decode_ms_per_token": gen["decode_ms_per_token"], "teacher_forced": check, "attention_launches": launches}
    log(f"    14b: step {out['step_ms']:.1f} ms, peak {gib(s['peak_memory_bytes'])} GiB, losses "
        f"{['%.4f' % x for x in losses]}, generated {out['new_tokens']} tokens, teacher-forced {check} on {smi}")
    del model
    return out


def alltoall_ms(trace_paths, steps: int) -> list:
    """Each rank's NCCL send/recv kernels' (the all-to-all's) device ms a
    step, from its trace of ``steps`` steps."""
    from distributeddataparallel_tpu_torch.parallel.overlap import trace_kernels

    out = []
    for path in trace_paths:
        kernels = [k for k in trace_kernels(path) if "sendrecv" in k["name"].lower()]
        out.append(sum(k["end"] - k["start"] for k in kernels) / 1e3 / steps)
    return out


def moe_entry(torch, smi) -> dict:
    """[14c] Only where two GPUs are visible (four for the last three
    runs): 14a's model at capacity factor 8 under --ep 2, --ep 4,
    --ep 2 --tp 2 and --cp 2 --ep 2 over NCCL, one data replica, against
    one GPU on the same global batch."""
    import glob

    count = torch.cuda.device_count()
    if count < 2:
        log(f"    14c needs two GPUs and was not run: {count} visible")
        return {"ran": False, "gpus": count}
    base = run_entry(MOE_ENTRY_ARGS, "14c one GPU")
    out = {"ran": True, "gpus": count, "atol": MOE_ENTRY_ATOL,
           "one_gpu": {"losses": base["losses"], "step_ms": base["step_time_s"] * 1e3,
                       "peak_memory_bytes": base["peak_memory_bytes"]}}
    for name, (extra, gpus) in MOE_ENTRY.items():
        if gpus > count:
            log(f"    14c {name} needs {gpus} GPUs and was not run: {count} visible")
            continue
        with tempfile.TemporaryDirectory(prefix="moe_ev_") as ev:
            s = run_entry(MOE_ENTRY_ARGS + extra + ["--num-processes", str(gpus), "--events-dir", ev,
                                                    "--profile-steps", "1:3"], f"14c {name}")
            a2a = alltoall_ms(sorted(glob.glob(os.path.join(ev, "xprof", "trace_*_p*.json"))), 2)
        diff = max(abs(a - b) for a, b in zip(s["losses"], base["losses"]))
        out[name] = {"gpus": gpus, "losses": s["losses"], "step_ms": s["step_time_s"] * 1e3, "max_abs_diff": diff,
                     "peak_memory_bytes_rank0": s["peak_memory_bytes"], "alltoall_ms_per_step_by_rank": a2a,
                     "attention_launches": s["attention_launches"]}
        if not diff <= MOE_ENTRY_ATOL:
            raise AssertionError(f"14c {name}: losses {s['losses']} vs one GPU {base['losses']}")
        log(f"    14c {name}: step {out[name]['step_ms']:.1f} ms, peak {gib(s['peak_memory_bytes'])} GiB, "
            f"|loss - one GPU| {diff:.2e}, all-to-all {a2a} ms a step on {smi}")
    return out


def moe_phase(torch, dpp, fa, tfm, smi) -> dict:
    """[14] Mixture of experts: 14a and 14b through dpp.main with the
    kernels' counters set to 0 just before each and read just after, the
    no-sync block; 14c with two GPUs or more."""
    t0 = time.perf_counter()
    log("[14] mixture of experts")
    fa.reset_launches()
    seconds = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        result = fn(*a)
        seconds[name] = time.perf_counter() - t
        return result

    llama = timed("14a", moe_llama, torch, dpp, smi)
    gpt2 = timed("14b", moe_gpt2, torch, dpp, smi)
    out = {"llama_8x_top2": llama, "gpt2_8x_dense": gpt2, "attention_launches": dict(fa.LAUNCHES)}
    out["no_sync_block"] = timed("no_sync", moe_no_sync, torch, tfm)
    log(f"    14a: one MoE block's forward and backward ran under sync debug mode 'error': {out['no_sync_block']}")
    out["entry"] = timed("14c", moe_entry, torch, smi)
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = seconds
    log(f"    phase 14 in {out['seconds']:.1f} s; K1-K3 launches {out['attention_launches']} on {smi}")
    return out


class LocalPipe:
    """``pipeline_parallel._Pipe``'s members among the stages of a replay,
    each a thread of this process: a send puts a copy of the tensor in the
    neighbour's mailbox (``fwd[s]`` holds what stage s receives from its
    previous stage, ``bwd[s]`` what it receives from its next; ``wrap``
    joins stage n-1 and stage 0, as virtual stages do), a receive takes the
    oldest, as over a process group.  It keeps what it received, for
    ``CannedPipe``.  A receive that outlasts EXCHANGE_TIMEOUT_S raises: a
    replay fails, it never hangs."""

    def __init__(self, fwd, bwd, stage: int, wrap: bool = False):
        self.fwd, self.bwd, self.stage, self.n = fwd, bwd, stage, len(fwd)
        self.has_prev, self.has_next = stage > 0 or wrap, stage < self.n - 1 or wrap
        self.like, self.received = None, []

    def _take(self, box, what: str):
        import queue

        try:
            t = box.get(timeout=EXCHANGE_TIMEOUT_S)
        except queue.Empty:
            raise AssertionError(f"stage {self.stage} waited {EXCHANGE_TIMEOUT_S} s for its {what}") from None
        self.received.append(t)
        return t

    def exchange(self, send_next=None, send_prev=None, recv_prev=False, recv_next=False):
        if send_next is not None:
            self.fwd[(self.stage + 1) % self.n].put(send_next.detach().clone())
        if send_prev is not None:
            self.bwd[(self.stage - 1) % self.n].put(send_prev.detach().clone())
        got_prev = self._take(self.fwd[self.stage], "activations") if recv_prev else None
        return got_prev, self._take(self.bwd[self.stage], "cotangent") if recv_next else None

    def recv_forward(self):
        return self.exchange(recv_prev=True)[0] if self.has_prev else None

    def send_forward(self, y) -> None:
        if self.has_next:
            self.exchange(send_next=y)

    def recv_backward(self):
        return self.exchange(recv_next=True)[1] if self.has_next else None

    def send_backward(self, dx) -> None:
        if self.has_prev:
            self.exchange(send_prev=dx)

    def send_forward_recv_backward(self, y):
        return self.exchange(send_next=y, recv_next=True)[1] if self.has_next else None

    def send_backward_recv_forward(self, dx):
        return self.exchange(send_prev=dx, recv_prev=True)[0] if self.has_prev else None


class CannedPipe:
    """One stage's exchange run alone: its receives give back, in order,
    copies of what its ``LocalPipe`` received; its sends go nowhere.  Runs
    one stage's units through the module's own schedule, to count and time
    them."""

    def __init__(self, local: LocalPipe):
        self.stage, self.n, self.received, self.i, self.like = local.stage, local.n, local.received, 0, None
        self.has_prev, self.has_next = local.has_prev, local.has_next

    def _next(self):
        self.i += 1
        return self.received[self.i - 1].detach().clone()

    def exchange(self, send_next=None, send_prev=None, recv_prev=False, recv_next=False):
        got_prev = self._next() if recv_prev else None
        return got_prev, self._next() if recv_next else None

    def recv_forward(self):
        return self._next() if self.has_prev else None

    def recv_backward(self):
        return self._next() if self.has_next else None

    def send_forward(self, y) -> None:
        pass

    def send_backward(self, dx) -> None:
        pass

    def send_forward_recv_backward(self, y):
        return self.recv_backward()

    def send_backward_recv_forward(self, dx):
        return self.recv_forward()


def pp_threads(torch, pp, jobs, M: int, schedule: str, what: str):
    """The module's schedule for every rank of a replay at once, a thread a
    rank; ``jobs`` holds each rank's (stage, pipe, inputs, targets, seq
    exchange).  Each thread runs its own backward (autograd's per-device
    worker thread, shared by every thread, would queue one rank's ring
    backward behind its peer's, which waits for it).  Gradients accumulate
    in the stages' ``.grad``; returns each rank's ``StageRun``."""
    import threading

    runs, errors = [None] * len(jobs), []

    def work(i):
        stage, pipe, inputs, targets, seq = jobs[i]
        try:
            with torch.autograd.set_multithreading_enabled(False):
                runs[i] = pp.run_schedule(stage, pipe, inputs, targets, microbatches=M, schedule=schedule, seq=seq)
        except BaseException as e:  # noqa: BLE001 — reported below, the replay fails
            errors.append(f"rank {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if errors:
        raise AssertionError(f"{what}: {errors}")
    return runs


def local_pipes(n: int, wrap: bool) -> list:
    import queue

    fwd, bwd = [queue.Queue() for _ in range(n)], [queue.Queue() for _ in range(n)]
    return [LocalPipe(fwd, bwd, s, wrap) for s in range(n)]


def pp_replay(torch, pp, stages, inputs, targets, M: int, schedule: str):
    """The module's schedule for every stage at once, a thread a stage:
    each stage's ``StageRun`` and ``LocalPipe``."""
    pipes = local_pipes(len(stages), stages[0].virtual > 1)
    runs = pp_threads(torch, pp, [(st, pipes[s], inputs, targets, None) for s, st in enumerate(stages)], M,
                      schedule, f"{schedule} replay on {len(stages)} stages")
    return runs, pipes


def restage(torch, pp, cfg, stages, virtual: int) -> list:
    """The stages of ``virtual`` chunks a stage over the same parameter
    tensors as ``stages`` (no copy: 15b's model does not fit twice): each
    new stage takes its layers from whichever old stage holds them, its
    replicated leaves and RoPE tables from the old stage of its index."""
    n = len(stages)
    merged = pp.merge_pp_shards([dict(st.named_parameters()) for st in stages])
    out = []
    for s, old in enumerate(stages):
        sd = pp.shard_state_dict_pp(merged, s, n, virtual)
        sd.update({k: p for k, p in old.named_parameters() if pp.is_replicated(k)})
        with torch.device("meta"):
            new = pp.StageLM(cfg, s, n, virtual=virtual)
        new.load_state_dict(sd, assign=True)
        for name, buf in old.named_buffers():
            setattr(new, name, buf)
        out.append(new)
    return out


def zero_stage_grads(torch, stages) -> None:
    for st in stages:
        for p in st.parameters():
            p.grad = None
        for p in st.parameters():
            p.grad = torch.zeros_like(p)


def layer_home(stages) -> dict:
    """Global layer index -> (stage, index in the stage) for a replay's
    stages, chunk-major under virtual chunks (``stage_layers``' order)."""
    home = {}
    for s, st in enumerate(stages):
        per, n = len(st.layers), st.n_stages
        lc = per // st.virtual
        for i in range(per):
            home[(i // lc * n + s) * lc + i % lc] = (s, i)
    return home


def stage_grad(stages, name: str, home=None):
    """The whole model's gradient ``name`` from the stages' parameters: a
    layer's from the stage that holds it, a replicated leaf's summed over
    the stages (the pipe sum)."""
    m = re.match(r"layers\.(\d+)\.(.*)", name)
    if m:
        s, i = (home or layer_home(stages))[int(m.group(1))]
        return dict(stages[s].named_parameters())[f"layers.{i}.{m.group(2)}"].grad
    return sum(dict(st.named_parameters())[name].grad for st in stages)


def grad_error(grad_of, want: dict) -> tuple[float, str]:
    """The largest |got - want| over each gradient's largest |want| (at
    least 1e-3 of the model's largest: a gradient that is 0 in exact
    arithmetic, such as a key bias's under the softmax, holds rounding
    alone), and where it is; ``grad_of(name)`` is the pipelined gradient."""
    floor = 1e-3 * max(float(w.float().abs().max()) for w in want.values())
    worst, where = 0.0, None
    for k, w in want.items():
        g = grad_of(k)
        err = float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), floor)
        if err >= worst:
            worst, where = err, k
    return worst, where


def pp_grad_error(stages, want: dict) -> tuple[float, str]:
    home = layer_home(stages)
    return grad_error(lambda k: stage_grad(stages, k, home), want)


def stage_grads(stages, names) -> dict:
    home = layer_home(stages)
    return {k: stage_grad(stages, k, home).clone() for k in names}


def pp_oracle(torch, model, inputs, targets):
    """The unpipelined model's loss and gradients on the whole batch."""
    from distributeddataparallel_tpu_torch.ops.losses import lm_cross_entropy

    loss = lm_cross_entropy(model(inputs), targets)
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}


def pp_expected(per: int, M: int, n: int, s: int, schedule: str, remat: bool, virtual: int = 1,
                hops: int = 1) -> dict:
    """K1-K3 launches of stage s: every unit's forward with gradients runs
    K1 once a layer (twice under remat: the recompute); 1F1B's and zb's
    forward units a no-gradient forward first, but for the model's last
    chunk (the last stage's, of ``per / virtual`` layers); K2 and K3 once a
    layer a microbatch.  Under CP each count is per live ring hop
    (``hops``: 1 + the seq rank on the ring, 1 under Ulysses)."""
    k1 = (2 if remat else 1) * per * M
    if schedule != "gpipe":
        k1 += per * M - (per // virtual * M if s == n - 1 else 0)
    return {"flash_fwd": hops * k1, "flash_bwd_dq": hops * per * M, "flash_bwd_dkv": hops * per * M}


def check_counts(pp, runs, n: int, M: int, virtual: int, schedule: str, what: str) -> None:
    """Each stage's executed [F, B, W] units are the reference table's:
    M v forwards and backwards, M v weight units under zb, their sum the
    stage's useful slots in ``pp_bubble_fraction``."""
    want = [M * virtual, M * virtual, M * virtual if schedule == "zb" else 0]
    useful = pp.pp_bubble_fraction(n, M, virtual, schedule)["useful_slots"] if schedule != "gpipe" else 2 * M
    if any(r.counts != want or sum(r.counts) != useful for r in runs):
        raise AssertionError(f"{what}: units {[r.counts for r in runs]}, want {want} ({useful} useful slots)")


def pp_gpt2(torch, fa, tfm, pp, smi):
    """[15a] GPT-2 124M (12 layers, f32): the runs of PP_GPT2_RUNS against
    the unpipelined step, zb's gradients against 1F1B's on the same stages,
    1F1B's against GPipe's; each stage alone through its received tensors
    (``CannedPipe``) for its launches and its time.  Returns the record
    and what 15d reuses (the weights, the batch, the oracle)."""
    B, S, M = PP_GPT2["B"], PP_GPT2["S"], PP_GPT2["M"]
    cfg = tfm.gpt2_124m(scan_layers=True)
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    model = tfm.TransformerLM(cfg, device=DEVICE, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), device=DEVICE, generator=gen)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    want_loss, want = pp_oracle(torch, model, inputs, targets)
    full = model.state_dict()
    del model
    out, launches = {"oracle_loss": want_loss, "tolerance": PP_F32_TOL}, {k: 0 for k in fa.LAUNCHES}
    stages, kept = None, {}
    for n, schedule, v in PP_GPT2_RUNS:
        if stages is None or (stages[0].n_stages, stages[0].virtual) != (n, v):
            stages = None  # the last layout's memory goes before the next is made
            stages = [pp.stage_model(cfg, full, s, n, virtual=v, device=DEVICE) for s in range(n)]
        per = cfg.num_layers // n
        name = schedule + (f"_v{v}" if v > 1 else "")
        zero_stage_grads(torch, stages)
        fa.reset_launches()
        runs, pipes = pp_replay(torch, pp, stages, inputs, targets, M, schedule)
        total = dict(fa.LAUNCHES)
        loss = float(runs[-1].loss_sum) / M
        grad_err, where = pp_grad_error(stages, want)
        rec = {"loss": loss, "loss_abs_err": abs(loss - want_loss), "grad_rel_err": grad_err, "worst": where,
               "launches": total, "held": [r.max_held for r in runs], "counts": [r.counts for r in runs]}
        if not (rec["loss_abs_err"] <= PP_F32_TOL["loss_rtol"] * abs(want_loss)
                and grad_err <= PP_F32_TOL["grad_rtol"]):
            raise AssertionError(f"15a n={n} {name}: {rec}")
        check_counts(pp, runs, n, M, v, schedule, f"15a n={n} {name}")
        # 1F1B against GPipe, zb against 1F1B: the same stages' gradients.
        against = {"1f1b": "gpipe", "zb": "1f1b"}.get(schedule) if v == 1 else None
        if against:
            other_loss, other = kept[n, against]
            gap = pp_grad_error(stages, other)[0]
            rec[f"vs_{against}"] = {"loss_abs_diff": abs(loss - other_loss), "grad_rel_err": gap,
                                    "bitwise": all(torch.equal(stage_grad(stages, k), g) for k, g in other.items())}
            if not (rec[f"vs_{against}"]["loss_abs_diff"] <= PP_F32_TOL["loss_rtol"] * abs(want_loss)
                    and gap <= PP_F32_TOL["grad_rtol"]):
                raise AssertionError(f"15a n={n}: {name} against {against} {rec[f'vs_{against}']}")
        if v == 1 and schedule != "zb":
            kept[n, schedule] = (loss, stage_grads(stages, want))
        # Each stage alone: its launches exactly, and its time.
        rec["stage_ms"], rec["stage_launches"] = [], []
        for s, st in enumerate(stages):
            fa.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pp.run_schedule(st, CannedPipe(pipes[s]), inputs, targets, microbatches=M, schedule=schedule)
            torch.cuda.synchronize()
            rec["stage_ms"].append((time.perf_counter() - t0) * 1e3)
            got, exp = dict(fa.LAUNCHES), pp_expected(per, M, n, s, schedule, cfg.remat, v)
            if got != exp:
                raise AssertionError(f"15a n={n} {name} stage {s}: launches {got} != {exp}")
            rec["stage_launches"].append(got)
            for k, c in got.items():
                launches[k] += c
        if total != {k: sum(x[k] for x in rec["stage_launches"]) for k in total}:
            raise AssertionError(f"15a n={n} {name}: the replay's launches {total} are not its stages'")
        for k, c in total.items():
            launches[k] += c
        if schedule != "gpipe":
            rec["bubble"] = pp.pp_bubble_fraction(n, M, v, schedule)["bubble_fraction"]
        out.setdefault(f"n{n}", {})[name] = rec
        log(f"    15a n={n} {name}: loss {loss:.6f} (|err| {rec['loss_abs_err']:.1e}), gradients within "
            f"{grad_err:.1e} of their largest (worst {where})"
            + (f", against {against} {rec[f'vs_{against}']['grad_rel_err']:.1e}"
               f"{' (bit for bit)' if rec[f'vs_{against}']['bitwise'] else ''}" if against else "")
            + f", units {rec['counts'][0]} a stage, held {rec['held']}, stage ms "
            f"{['%.1f' % x for x in rec['stage_ms']]}, launches a stage {rec['stage_launches']}")
    out["attention_launches"] = launches
    del stages, kept
    release(torch)
    return out, (full, inputs, targets, want_loss, want)


def pp_cp(torch, fa, tfm, pp, full, inputs, targets, want_loss, want, smi) -> dict:
    """[15d] 15a's GPT-2 weights and batch under --pp 2 --cp 2: ring and
    Ulysses inside each stage, GPipe and 1F1B, every (stage, seq rank) a
    thread of this process, its pipe a ``LocalPipe`` among its seq rank's
    stages and its seq exchange a ``LocalRing`` among its stage's seq ranks
    (passed to ``run_schedule(seq=)``), against the unpipelined step: the
    loss (the seq ranks' mean), the gradients (their mean, pipe-summed),
    K1-K3 launches per live hop."""
    n, ncp, M = PP_CP["n"], PP_CP["cp"], PP_GPT2["M"]
    S = inputs.shape[1] // ncp
    ins = [inputs[:, q * S : (q + 1) * S].contiguous() for q in range(ncp)]
    tgts = [targets[:, q * S : (q + 1) * S].contiguous() for q in range(ncp)]
    out, launches = {"tolerance": PP_F32_TOL}, {k: 0 for k in fa.LAUNCHES}
    for impl in PP_CP["impls"]:
        import queue

        cfg = tfm.gpt2_124m(scan_layers=True, cp_axis="seq", cp_impl=impl)
        per = cfg.num_layers // n
        grid = [[pp.stage_model(cfg, full, s, n, device=DEVICE) for s in range(n)] for _ in range(ncp)]
        for schedule in PP_CP["schedules"]:
            for stages in grid:
                zero_stage_grads(torch, stages)
            pipes = [local_pipes(n, False) for _ in range(ncp)]
            rings = []
            for _ in range(n):
                boxes = [queue.Queue() for _ in range(ncp)]
                a2a = {(i, j): queue.Queue() for i in range(ncp) for j in range(ncp)}
                rings.append([LocalRing(boxes, q, a2a) for q in range(ncp)])
            jobs = [(grid[q][s], pipes[q][s], ins[q], tgts[q], rings[s][q]) for q in range(ncp) for s in range(n)]
            fa.reset_launches()
            t0 = time.perf_counter()
            runs = pp_threads(torch, pp, jobs, M, schedule, f"15d {impl} {schedule}")
            wall = time.perf_counter() - t0
            got = dict(fa.LAUNCHES)
            exp = {k: sum(pp_expected(per, M, n, s, schedule, False, 1, 1 + q if impl == "ring" else 1)[k]
                          for q in range(ncp) for s in range(n)) for k in got}
            loss = sum(float(runs[q * n + n - 1].loss_sum) for q in range(ncp)) / (ncp * M)
            homes = [layer_home(stages) for stages in grid]
            grad_err, where = grad_error(
                lambda k: sum(stage_grad(grid[q], k, homes[q]) for q in range(ncp)) / ncp, want)
            rec = {"loss": loss, "loss_abs_err": abs(loss - want_loss), "grad_rel_err": grad_err, "worst": where,
                   "launches": got, "wall_ms": wall * 1e3}
            if got != exp:
                raise AssertionError(f"15d {impl} {schedule}: launches {got} != {exp}")
            if not (rec["loss_abs_err"] <= PP_F32_TOL["loss_rtol"] * abs(want_loss)
                    and grad_err <= PP_F32_TOL["grad_rtol"]):
                raise AssertionError(f"15d {impl} {schedule}: {rec}")
            if schedule != "gpipe":
                check_counts(pp, runs, n, M, 1, schedule, f"15d {impl} {schedule}")
            for k, c in got.items():
                launches[k] += c
            out[f"{impl}_{schedule}"] = rec
            log(f"    15d --pp {n} --cp {ncp} {impl} {schedule}: loss {loss:.6f} (|err| {rec['loss_abs_err']:.1e}), "
                f"gradients within {grad_err:.1e} of their largest (worst {where}), launches {got}, "
                f"{rec['wall_ms']:.0f} ms on {smi}")
        del grid
    out["attention_launches"] = launches
    release(torch)
    return out


def pp_llama(torch, fa, tfm, pp, smi) -> dict:
    """[15b] Llama-3 8B width x 8 layers (bf16, remat) on 2 stages, GPipe
    and 1F1B at M = 4 and 8, then zb and 1F1B with 2 chunks a stage at M =
    8, against the unpipelined step; zb's gradients against 1F1B's; the
    peak memory above the resident stages and gradients, and the
    microbatches each stage held."""
    B, S, n = PP_LLAMA["B"], PP_LLAMA["S"], PP_LLAMA["n"]
    cfg = tfm.llama3_8b(num_layers=LLAMA_LAYERS, max_seq_len=S)
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    model = tfm.TransformerLM(cfg, device=DEVICE, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), device=DEVICE, generator=gen)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    want_loss, want = pp_oracle(torch, model, inputs, targets)
    full = model.state_dict()
    stages = [pp.stage_model(cfg, full, s, n, device=DEVICE) for s in range(n)]
    del model, full  # the oracle's gradients stay
    release(torch)
    per = cfg.num_layers // n
    out, launches = {"oracle_loss": want_loss, "tolerance": PP_BF16_TOL, "stages": n}, {k: 0 for k in fa.LAUNCHES}
    f1b = None
    runs_15b = [(M, schedule, 1) for M in PP_LLAMA["M"] for schedule in ("gpipe", "1f1b")]
    runs_15b += [(PP_LLAMA["M"][-1], schedule, v) for schedule, v in PP_LLAMA_MORE]
    for M, schedule, v in runs_15b:
        if stages[0].virtual != v:
            stages = restage(torch, pp, cfg, stages, v)
        name = f"{schedule}_m{M}" + (f"_v{v}" if v > 1 else "")
        zero_stage_grads(torch, stages)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        runs, _ = pp_replay(torch, pp, stages, inputs, targets, M, schedule)
        wall = time.perf_counter() - t0
        got = dict(fa.LAUNCHES)
        exp = {k: sum(pp_expected(per, M, n, s, schedule, True, v)[k] for s in range(n)) for k in got}
        loss = float(runs[-1].loss_sum) / M
        grad_err, where = pp_grad_error(stages, want)
        rec = {"loss": loss, "loss_abs_err": abs(loss - want_loss), "grad_rel_err": grad_err, "worst": where,
               "launches": got, "held": [r.max_held for r in runs], "counts": [r.counts for r in runs],
               "wall_ms": wall * 1e3, "peak_above_resident_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
               "resident_gib": base / 2**30}
        if got != exp:
            raise AssertionError(f"15b {name}: launches {got} != {exp}")
        if not (rec["loss_abs_err"] <= PP_BF16_TOL["loss_atol"] and grad_err <= PP_BF16_TOL["grad_rtol"]):
            raise AssertionError(f"15b {name}: {rec}")
        if schedule != "gpipe":
            check_counts(pp, runs, n, M, v, schedule, f"15b {name}")
        if schedule == "zb":
            gap = pp_grad_error(stages, f1b[1])[0]
            rec["vs_1f1b"] = {"loss_abs_diff": abs(loss - f1b[0]), "grad_rel_err": gap,
                              "bitwise": all(torch.equal(stage_grad(stages, k), g) for k, g in f1b[1].items())}
            if not (rec["vs_1f1b"]["loss_abs_diff"] <= PP_BF16_TOL["loss_atol"] and gap <= PP_BF16_TOL["grad_rtol"]):
                raise AssertionError(f"15b {name} against 1F1B: {rec['vs_1f1b']}")
            f1b = None  # its 14 GiB go before the next run
        elif (M, schedule, v) == (PP_LLAMA["M"][-1], "1f1b", 1) and any(sc == "zb" for sc, _ in PP_LLAMA_MORE):
            f1b = (loss, stage_grads(stages, want))
        for k, c in got.items():
            launches[k] += c
        out[name] = rec
        log(f"    15b {name}: loss {loss:.5f} (|err| {rec['loss_abs_err']:.1e}), gradients within "
            f"{grad_err:.2e} of their largest (worst {where})"
            + (f", against 1F1B {rec['vs_1f1b']['grad_rel_err']:.1e}"
               f"{' (bit for bit)' if rec['vs_1f1b']['bitwise'] else ''}" if "vs_1f1b" in rec else "")
            + f", held {rec['held']}, {rec['peak_above_resident_gib']:.2f} GiB above {rec['resident_gib']:.2f} "
            f"resident, {rec['wall_ms']:.0f} ms on {smi}")
    # 1F1B holds at most n - s microbatches on stage s whatever M; GPipe all M.
    for M in PP_LLAMA["M"]:
        if out[f"1f1b_m{M}"]["held"] != [min(n - s, M) for s in range(n)] or out[f"gpipe_m{M}"]["held"] != [M] * n:
            raise AssertionError(f"15b M={M}: held {out[f'1f1b_m{M}']['held']}, {out[f'gpipe_m{M}']['held']}")
        if not out[f"1f1b_m{M}"]["peak_above_resident_gib"] < out[f"gpipe_m{M}"]["peak_above_resident_gib"]:
            raise AssertionError(f"15b M={M}: 1F1B's peak is not below GPipe's")
    out["attention_launches"] = launches
    del stages, want
    release(torch)
    return out


def pp_entry(torch, smi) -> dict:
    """[15c] Only where two GPUs are visible: the entry point over NCCL
    (see PP_DEEP_ARGS), each run in fresh processes."""
    import glob

    from distributeddataparallel_tpu_torch.parallel.pipeline_parallel import pp_bubble_fraction
    from distributeddataparallel_tpu_torch.profile_step import pp_split

    count = torch.cuda.device_count()
    if count < 2:
        log(f"    15c needs two GPUs and was not run: {count} visible")
        return {"ran": False, "gpus": count}
    n = 4 if count >= 4 else 2
    out = {"ran": True, "gpus": count, "atol": PP_ENTRY_ATOL}

    def against(name, base, args, gpus):
        s = run_entry(args + ["--num-processes", str(gpus)], f"15c {name}")
        diff = max(abs(a - b) for a, b in zip(s["losses"], base["losses"]))
        out[name] = {"gpus": gpus, "losses": s["losses"], "step_ms": s["step_time_s"] * 1e3, "max_abs_diff": diff,
                     "peak_memory_bytes_rank0": s["peak_memory_bytes"], "attention_launches": s["attention_launches"]}
        if not diff <= PP_ENTRY_ATOL:
            raise AssertionError(f"15c {name}: losses {s['losses']} vs {base['losses']}")
        log(f"    15c {name}: step {out[name]['step_ms']:.1f} ms, rank 0 peak {gib(s['peak_memory_bytes'])} GiB, "
            f"|loss - base| {diff:.2e} on {smi}")

    base = run_entry(PP_ENTRY_ARGS, "15c one GPU")
    out["one_gpu"] = {"losses": base["losses"], "step_ms": base["step_time_s"] * 1e3,
                      "peak_memory_bytes": base["peak_memory_bytes"]}
    for schedule in ("gpipe", "1f1b"):
        against(f"pp{n}_{schedule}", base, PP_ENTRY_ARGS + ["--pp", str(n), "--pp-schedule", schedule], n)
    if count < 4:
        log(f"    15c's --pp 2 --tp 2, --pp 2 --ep 2 and 32 layers under --pp 4 need four GPUs: {count} visible")
        return out
    against("pp2_tp2", base, PP_ENTRY_ARGS + ["--pp", "2", "--tp", "2"], 4)
    moe_base = run_entry(PP_MOE_ARGS + ["--ep", "2", "--num-processes", "2"], "15c --ep 2 (MoE, 2 layers)")
    against("pp2_ep2_moe", moe_base, PP_MOE_ARGS + ["--ep", "2", "--pp", "2"], 4)
    for schedule in ("gpipe", "1f1b"):
        with tempfile.TemporaryDirectory(prefix="pp_ev_") as ev:
            s = run_entry(PP_DEEP_ARGS + ["--pp", "4", "--pp-schedule", schedule, "--num-processes", "4",
                                          "--events-dir", ev, "--profile-steps", "1:3"], f"15c 32 layers {schedule}")
            split = pp_split(sorted(glob.glob(os.path.join(ev, "xprof", "trace_*_p*.json"))), 2)
        if not all(math.isfinite(x) for x in s["losses"]) or s["eval"] is None:
            raise AssertionError(f"15c 32 layers {schedule}: losses {s['losses']}, eval {s['eval']}")
        out[f"deep_{schedule}"] = {"losses": s["losses"], "eval": s["eval"], "step_ms": s["step_time_s"] * 1e3,
                                   "peak_memory_bytes_rank0": s["peak_memory_bytes"], "num_params_rank0": s["num_params"],
                                   "split_by_rank": split, "bubble": pp_bubble_fraction(4, 8)["bubble_fraction"]
                                   if schedule == "1f1b" else None}
        log(f"    15c 32 layers {schedule}: step {out[f'deep_{schedule}']['step_ms']:.1f} ms, rank 0 peak "
            f"{gib(s['peak_memory_bytes'])} GiB, losses {['%.4f' % x for x in s['losses']]}, per rank "
            f"{split} on {smi}")
    return out


def pp_entry_16b(torch, smi) -> dict:
    """[15c+] Only where two GPUs are visible: the runs of PP_ENTRY_16B that
    the visible GPUs hold, each in fresh processes against one GPU; the
    losses, step ms and each rank's P2P wait (``profile_step.pp_split``
    over steps 1-2)."""
    import glob

    from distributeddataparallel_tpu_torch.profile_step import pp_split

    count = torch.cuda.device_count()
    if count < 2:
        log(f"    15c+ needs two GPUs and was not run: {count} visible")
        return {"ran": False, "gpus": count}
    base = run_entry(PP_ENTRY_ARGS, "15c+ one GPU")
    out = {"ran": True, "gpus": count, "atol": PP_ENTRY_ATOL,
           "one_gpu": {"losses": base["losses"], "step_ms": base["step_time_s"] * 1e3}}
    for name, (extra, gpus) in PP_ENTRY_16B.items():
        if gpus > count:
            log(f"    15c+ {name} needs {gpus} GPUs and was not run: {count} visible")
            out[name] = {"ran": False, "gpus": gpus}
            continue
        with tempfile.TemporaryDirectory(prefix="pp16b_") as ev:
            s = run_entry(PP_ENTRY_ARGS + extra + ["--num-processes", str(gpus), "--events-dir", ev,
                                                   "--profile-steps", "1:3"], f"15c+ {name}")
            split = pp_split(sorted(glob.glob(os.path.join(ev, "xprof", "trace_*_p*.json"))), 2)
        diff = max(abs(a - b) for a, b in zip(s["losses"], base["losses"]))
        out[name] = {"ran": True, "gpus": gpus, "losses": s["losses"], "step_ms": s["step_time_s"] * 1e3,
                     "max_abs_diff": diff, "peak_memory_bytes_rank0": s["peak_memory_bytes"],
                     "p2p_ms_by_rank": [r["p2p_ms"] for r in split],
                     "compute_ms_by_rank": [r["compute_ms"] for r in split]}
        if not diff <= PP_ENTRY_ATOL:
            raise AssertionError(f"15c+ {name}: losses {s['losses']} vs {base['losses']}")
        log(f"    15c+ {name}: step {out[name]['step_ms']:.1f} ms (one GPU {out['one_gpu']['step_ms']:.1f}), "
            f"|loss - base| {diff:.2e}, P2P ms a rank {['%.1f' % x for x in out[name]['p2p_ms_by_rank']]} on {smi}")
    return out


def pp_phase(torch, fa, tfm, smi) -> dict:
    """[15] Pipeline parallelism: 15a, 15b and 15d replay the module's own
    schedules on this card (the kernels' counters summed over the replays,
    the oracles left out); 15c and 15c+ with two GPUs or more."""
    from distributeddataparallel_tpu_torch.parallel import pipeline_parallel as pp

    t0 = time.perf_counter()
    log("[15] pipeline parallelism")
    seconds = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        result = fn(*a)
        seconds[name] = time.perf_counter() - t
        return result

    gpt2, reused = timed("15a", pp_gpt2, torch, fa, tfm, pp, smi)
    out = {"gpt2_12_layers": gpt2, "cp": timed("15d", pp_cp, torch, fa, tfm, pp, *reused, smi)}
    del reused
    out["llama_8_layers"] = timed("15b", pp_llama, torch, fa, tfm, pp, smi)
    out["attention_launches"] = {k: sum(out[part]["attention_launches"][k]
                                        for part in ("gpt2_12_layers", "cp", "llama_8_layers")) for k in fa.LAUNCHES}
    out["entry"] = timed("15c", pp_entry, torch, smi)
    out["entry_16b"] = timed("15c+", pp_entry_16b, torch, smi)
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = seconds
    log(f"    phase 15 in {out['seconds']:.1f} s ({seconds}); K1-K3 launches {out['attention_launches']} on {smi}")
    return out


@contextlib.contextmanager
def sync_errors(torch):
    """Any host synchronisation inside raises (``set_sync_debug_mode``)."""
    if DEVICE != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def idle_share(trace_path: str, steps: int) -> dict:
    """The device's busy ms a step (the union of its kernels) and its idle
    share over the traced window, first kernel to last."""
    from distributeddataparallel_tpu_torch.parallel.overlap import trace_kernels

    spans = sorted((k["start"], k["end"]) for k in trace_kernels(trace_path))
    if not spans:  # a CPU dry run: no device kernels
        return {"busy_ms_per_step": None, "window_ms_per_step": None, "idle_share": None}
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = spans[-1][1] - spans[0][0]
    return {"busy_ms_per_step": busy / 1e3 / steps, "window_ms_per_step": window / 1e3 / steps,
            "idle_share": 1.0 - busy / window}


def depth_runs(torch, dpp, smi) -> dict:
    """[16a] Each DEPTH_RUNS run at its depths: the losses and the final
    parameter norm bit for bit across every run, the step ms (CUDA events
    past depth 0, the host clock around each synchronised step at 0) and
    the wall-clock step; then a traced run at each depth: the device's
    busy ms a step and its idle share over the traced window."""
    import glob

    out = {}
    for name, (args, traced, order) in DEPTH_RUNS.items():
        window = [int(x) for x in traced[traced.index("--profile-steps") + 1].split(":")]
        runs = {0: [], 2: []}
        first = None
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = name.startswith("resnet")
        try:
            for depth in order:
                s = dpp.main(args + ["--device", DEVICE, "--dispatch-depth", str(depth)])
                release(torch)
                first = first or (s["losses"], s["param_norm"])
                if (s["losses"], s["param_norm"]) != first:
                    raise AssertionError(f"16a {name}: depth {depth} {s['losses']} != {first[0]}")
                runs[depth].append({"step_ms": s["step_time_s"] * 1e3, "wall_ms": s["wall_step_time_s"] * 1e3})
            traces = {}
            for depth in (0, 2):
                with tempfile.TemporaryDirectory(prefix="depth_ev_") as ev:
                    dpp.main(args + ["--device", DEVICE, "--dispatch-depth", str(depth)] + traced
                             + ["--events-dir", ev])
                    (trace,) = glob.glob(os.path.join(ev, "xprof", "trace_*_p0.json"))
                    traces[depth] = idle_share(trace, window[1] - window[0])
                release(torch)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        mean = {d: {k: sum(r[k] for r in rs) / len(rs) for k in ("step_ms", "wall_ms")} for d, rs in runs.items()}
        out[name] = {"bitwise": True, "losses": first[0], "order": list(order),
                     **{f"depth{d}": {**mean[d], "runs": runs[d], "traced": traces[d]} for d in (0, 2)}}

        def pair(get):
            vals = [get(d) for d in (0, 2)]
            return " / ".join("-" if v is None else f"{v:.3f}" for v in vals)

        log(f"    16a {name}: losses and parameters bitwise across depths {list(order)}; step "
            f"{pair(lambda d: mean[d]['step_ms'])} ms, wall {pair(lambda d: mean[d]['wall_ms'])} ms "
            f"(runs {runs}); traced: device idle {pair(lambda d: traces[d]['idle_share'])}, busy "
            f"{pair(lambda d: traces[d]['busy_ms_per_step'])} of {pair(lambda d: traces[d]['window_ms_per_step'])} "
            f"ms a step; at depth 0 / 2 on {smi}")
    return out


def _in_group(torch, dpp, fn):
    """``fn(args)`` inside an NCCL group of one (the process group
    ``dpp.run`` forms)."""
    from distributeddataparallel_tpu_torch.runtime import distributed as rt

    rt.init_process_group(device=torch.device("cuda", 0) if DEVICE == "cuda" else torch.device("cpu"))
    try:
        return fn()
    finally:
        rt.destroy_process_group()


def _snapshot(state) -> list:
    """Device copies of the whole train state (no host read)."""
    opt = [t for st in state.optimizer.state.values() for t in st.values() if hasattr(t, "clone")]
    bufs = [b for b in state.model.buffers()]
    return [t.detach().clone() for t in [*state.model.parameters(), *opt, *bufs, state.scheduler.count]]


def guard_run(torch, dpp, smi) -> dict:
    """[16b] GUARD_ARGS with the loss poisoned at step GUARD_POISON: every
    step under sync debug mode "error" (the step reads nothing from the
    card; the loop's settles and drains do, outside it), the state after
    the skipped step bitwise the state before it, the breaker's one skip;
    then the guard's cost over guarded and unguarded runs with no bad step,
    each bit for bit the first."""
    from distributeddataparallel_tpu_torch.training.train_step import make_train_step

    device = torch.device("cuda", 0) if DEVICE == "cuda" else torch.device("cpu")
    args = dpp.parse_args(GUARD_ARGS + ["--device", DEVICE])
    snaps = {}

    def poisoned():
        trainer = dpp.build_trainer(args, device)
        calls = []

        def loss_fn(model, batch, **kw):
            loss, aux = dpp._loss_fn(model, batch)
            return (loss * float("nan") if len(calls) == GUARD_POISON else loss), aux

        inner = make_train_step(loss_fn, nonfinite_guard=True)

        def step_fn(state, batch, seed=None):
            with sync_errors(torch):
                if len(calls) == GUARD_POISON:
                    snaps["before"] = _snapshot(state)
                m = inner(state, batch, seed)
                if len(calls) == GUARD_POISON:
                    snaps["after"] = _snapshot(state)
            calls.append(None)
            return m

        trainer.step_fn = step_fn
        return dpp.train(args, trainer, device)

    s = _in_group(torch, dpp, poisoned)
    exact = len(snaps["before"]) == len(snaps["after"]) and all(
        torch.equal(a, b) for a, b in zip(snaps["before"], snaps["after"]))
    losses = s["losses"]
    if not exact or s["faults"]["nonfinite_steps"] != 1 or not math.isnan(losses[GUARD_POISON]) or not all(
            math.isfinite(x) for i, x in enumerate(losses) if i != GUARD_POISON):
        raise AssertionError(f"16b: skip exact {exact}, faults {s['faults']}, losses {losses}")
    del snaps["before"], snaps["after"]
    release(torch)
    log(f"    16b: step {GUARD_POISON} skipped on the card; params, AdamW moments and steps, the LR count and "
        f"buffers after it bitwise before it ({len(s['losses'])} steps under sync debug \"error\", one nan_skip)")

    first = {}

    def timed(guard):
        """One 6-step GPT-2 run, guarded or not (the same fused AdamW:
        ``build_optimizer`` builds one update kind); its step ms, and its
        losses and parameters held bit for bit to the first run's."""
        a = dpp.parse_args(FAULT_LM_ARGS + ["--device", DEVICE, "--steps-per-epoch", "6"]
                           + (["--nan-guard"] if guard else []))

        def go():
            trainer = dpp.build_trainer(a, device)
            s = dpp.train(a, trainer, device)
            params = [p.detach().clone() for p in trainer.state.model.parameters()]
            if not first:
                first.update(losses=s["losses"], params=params)
            elif s["losses"] != first["losses"] or not all(torch.equal(x, y)
                                                           for x, y in zip(params, first["params"])):
                raise AssertionError(f"16b: a {'guarded' if guard else 'unguarded'} run with no bad step "
                                     f"is not the first run bit for bit: losses {s['losses']} vs "
                                     f"{first['losses']}")
            return s["step_time_s"] * 1e3

        ms = _in_group(torch, dpp, go)
        release(torch)
        return ms

    runs = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        runs[which].append(timed(which == "on"))
    del first["params"]
    release(torch)
    mean = {k: sum(v) / len(v) for k, v in runs.items()}
    log(f"    16b guarded and unguarded runs bit for bit (losses, parameters; 4 runs of 6 steps); guard cost, "
        f"fused AdamW both: {mean['off']:.2f} ms off, {mean['on']:.2f} ms on (runs {runs}) on {smi}")
    return {"poisoned_step": GUARD_POISON, "skip_exact": exact, "losses": [x if math.isfinite(x) else None
                                                                          for x in losses],
            "sync_debug": "error", "step_ms_off": mean["off"], "step_ms_on": mean["on"],
            "cost_ms": mean["on"] - mean["off"], "runs_ms": runs,
            "guarded_equals_unguarded": {"runs": 4, "losses": first["losses"], "params_bitwise": True}}


def warm_restart(phase4_faults: dict, restart: dict, smi) -> dict:
    """[16c] The kernels' first build went into this script's fresh
    ``--compile-cache`` in phase 2 (``cold``, as phase 4's run reports);
    9a's supervised run under the same cache (``DDP_COMPILE_CACHE``, its
    worker dead once at step 6 and restarted) must say ``cache-hit`` in
    both incarnations with no build, and its restart is split
    (``restart_record``)."""
    modes, split = restart["modes"], restart["split"]
    if phase4_faults.get("warm_start") != "cold" or modes != {0: "cache-hit", 1: "cache-hit"} \
            or restart["kernel_builds"]["misses"] != 0:
        raise AssertionError(f"16c: phase 4 {phase4_faults.get('warm_start')}, 9a's modes {modes}, "
                             f"builds {restart['kernel_builds']}")
    log(f"    16c: phase 4 cold (built in phase 2), 9a's attempt 0 {modes[0]}, attempt 1 {modes[1]} "
        f"({restart['kernel_builds']}); its restart " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f" on {smi}")
    return {"phase4_mode": "cold", **restart}


def warm_start_phase(torch, dpp, phase4_faults, restart, smi) -> dict:
    """[16] Bounded dispatch and the warm start (16a, 16b; 16c from phase
    9a's supervised run, ``restart``)."""
    log("[16] bounded dispatch and the warm start")
    release(torch)
    return {"depths": depth_runs(torch, dpp, smi), "guard": guard_run(torch, dpp, smi),
            "restart": warm_restart(phase4_faults, restart, smi)}


def fleet_trace(vocab: int) -> list[dict]:
    """[17a] FLEET_BASE prompts at t=0 and a second turn of each at t=1 s
    that extends it by FLEET_TURN tokens (a session a prompt)."""
    import numpy as np

    rng = np.random.default_rng(17)
    base = [rng.integers(0, vocab, n, dtype=np.int32) for n in FLEET_BASE]
    turns = [np.concatenate([p, rng.integers(0, vocab, FLEET_TURN, dtype=np.int32)]) for p in base]
    return ([{"arrival_s": 0.0, "prompt": p, "max_new_tokens": FLEET_NEW, "session": i} for i, p in enumerate(base)]
            + [{"arrival_s": 1.0, "prompt": p, "max_new_tokens": FLEET_NEW, "session": i} for i, p in enumerate(turns)])


def drive_fleet(fleet, clock, trace, kill_step=None) -> int:
    """[17a] ``loadgen.run_load``'s loop over a fleet (arrivals released on
    the virtual clock, one fleet step a tick), killing decode-0 at fleet
    step ``kill_step``; returns the requests the kill requeued."""
    i = steps = 0
    requeued = None
    while i < len(trace) or fleet.has_work():
        while i < len(trace) and trace[i]["arrival_s"] <= clock():
            r = trace[i]
            fleet.submit(r["prompt"], r["max_new_tokens"], arrival_s=r["arrival_s"], session=r["session"])
            i += 1
        if fleet.has_work():
            fleet.step()
            steps += 1
            if steps == kill_step:
                requeued = fleet.kill_engine("decode-0")
        clock.tick()
        if steps > 20_000:
            raise AssertionError("17a: the fleet did not drain")
    if kill_step is not None and requeued is None:
        raise AssertionError(f"17a: the fleet drained before step {kill_step}: no kill")
    return requeued


class FlipOnce:
    """[17a] A handoff channel that flips one byte of its ``nth`` frame."""

    def __init__(self, chan, nth: int):
        self._chan, self._nth, self._sends = chan, nth, 0

    def send(self, frame):
        self._sends += 1
        if self._sends == self._nth:
            frame = bytearray(frame)
            frame[len(frame) // 2] ^= 0xFF
        self._chan.send(bytes(frame))

    def __getattr__(self, name):
        return getattr(self._chan, name)


def handoff_bench(torch, dm) -> dict:
    """[17a] One handoff of n blocks of a GPT-2 pool, 12 times (the median
    of the last 10): the extraction (a gather per leaf, one copy to pinned
    host memory), the wire (the sender's digests and frames over a pipe,
    the receiver's reassembly and digest checks, the ACK) and the landing
    (one pinned copy to the card, a write per leaf), the card synchronised
    around the device parts."""
    import statistics

    from distributeddataparallel_tpu_torch.serving.handoff import (
        HandoffPayload,
        HandoffReceiver,
        HandoffSender,
        PipeChannel,
        block_nbytes,
        extract_kv_blocks,
        unpack_blocks,
    )
    from distributeddataparallel_tpu_torch.serving.kv_cache import make_pool, set_pool_blocks

    pool = make_pool(dm, 80, FLEET_ENGINE["block_size"], device=DEVICE)
    out = {}
    for n in (1, 16, 36):
        src, dst = list(range(1, n + 1)), torch.arange(80 - n, 80, device=DEVICE)
        a, b = PipeChannel.pair()
        sender, receiver = HandoffSender(a), HandoffReceiver(b)
        runs = {"extract": [], "wire": [], "land": []}
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blocks = extract_kv_blocks(pool, src)
            t1 = time.perf_counter()
            sender.offer(HandoffPayload({"fid": 0}, blocks))
            (got,) = receiver.poll()
            (done,) = sender.poll()
            t2 = time.perf_counter()
            set_pool_blocks(pool, unpack_blocks(pool, got.blocks), dst)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for k, v in zip(runs, (t1 - t0, t2 - t1, t3 - t2)):
                runs[k].append(v)
        nbytes = n * block_nbytes(pool)
        med = {k: statistics.median(v[2:]) for k, v in runs.items()}
        out[n] = {"bytes": nbytes, **{f"{k}_ms": 1e3 * v for k, v in med.items()},
                  **{f"{k}_GB_per_s": nbytes / v / 1e9 for k, v in med.items()}}
    del pool
    return out


def fleet_inprocess(torch, fa, smi) -> dict:
    """[17a] The in-process fleet at GPT-2 124M's full width: every request
    completes with the allocator's invariants held on every step of every
    engine; tokens against a single engine of the same pool geometry (a
    differing request parts at a tie of the forward's logits, each gap
    stated); a corrupted frame costs one re-sent block and no token, and a
    kill of decode-0 drops nothing (one run for both).  K1-K3 are not on
    this path: the engines' attention is plain attention over the cache."""
    import numpy as np

    from distributeddataparallel_tpu_torch import serve
    from distributeddataparallel_tpu_torch.models.generate import decode_model
    from distributeddataparallel_tpu_torch.serving import (
        EngineConfig,
        FleetConfig,
        InferenceEngine,
        ServingFleet,
        VirtualClock,
        run_load,
    )
    from distributeddataparallel_tpu_torch.serving.handoff import block_nbytes

    args = serve.parse_args(["--model", "gpt2_124m", "--seq-len", "1024", "--device", DEVICE])
    dm = decode_model(serve.build_model(args))  # bf16, cast once; every engine shares it
    release(torch)
    trace = fleet_trace(dm.cfg.vocab_size)
    ecfg = EngineConfig(**FLEET_ENGINE)

    def run(corrupt=False, kill=False):
        clock = VirtualClock(FLEET_DT)
        fleet = ServingFleet(dm, ecfg, FleetConfig(prefill=1, decode=2), time_fn=clock, check_invariants=True)
        if corrupt:  # frame 2 of prefill-0 -> decode-1 (the link the kill's requeues take, which
            # the kill leaves standing) is block 0 of its first handoff
            snd = fleet._senders[("prefill-0", "decode-1")]
            snd._chan = FlipOnce(snd._chan, 2)
        t = time.perf_counter()
        requeued = drive_fleet(fleet, clock, trace, FLEET_KILL_STEP if kill else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        s = fleet.summary()
        if s["completed"] != len(trace) or s["dropped_req_total"] or sorted(fleet.completed) != list(range(len(trace))):
            raise AssertionError(f"17a{' corrupt' if corrupt else ''}{' kill' if kill else ''}: {s}")
        outs = [list(fleet.completed[f].generated) for f in range(len(trace))]
        rejected = sum(r.rejected_blocks for r in fleet._receivers.values())
        return fleet, s, outs, {"wall_s": wall, "requeued_by_kill": requeued, "rejected_blocks": rejected}

    fa.reset_launches()
    fleet, s, outs, meta = run()
    pool_block = block_nbytes(fleet.engines["decode-0"].pool)
    _, s_bad, outs_bad, meta_bad = run(corrupt=True, kill=True)
    clock = VirtualClock(FLEET_DT)
    single = InferenceEngine(dm, ecfg, time_fn=clock)
    run_load(single, trace, clock=clock)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"17a: the fleet launched the flash kernels {launches}")
    want = [list(single.completed[r].generated) for r in range(len(trace))]
    if pool_block != FLEET_BLOCK_BYTES or s["handoff_bytes"] % FLEET_BLOCK_BYTES:
        raise AssertionError(f"17a: {pool_block} bytes a block, {s['handoff_bytes']} handed off; a GPT-2 "
                             f"block is {FLEET_BLOCK_BYTES}")
    if outs_bad != outs or s_bad["re_handoff_blocks"] != 1 or meta_bad["rejected_blocks"] != 1:
        raise AssertionError(f"17a corrupt and kill: outputs equal {outs_bad == outs}, re-sent "
                             f"{s_bad['re_handoff_blocks']}, rejected {meta_bad['rejected_blocks']} (want 1 and 1)")
    if s_bad["kills"] != 1 or not meta_bad["requeued_by_kill"]:
        raise AssertionError(f"17a kill: {s_bad}, requeued {meta_bad['requeued_by_kill']}")
    fwd = forward_twin(torch, dm)
    parted = []
    for i, (a, b) in enumerate(zip(outs, want)):
        if a == b:
            continue
        t = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.concatenate([trace[i]["prompt"], np.asarray(a[:t], np.int32)])
        with torch.no_grad():
            row = fwd(torch.as_tensor(ctx[None], device=DEVICE).long())[0, -1].float()
        gap = float(row.max() - min(row[a[t]], row[b[t]]))
        if not gap <= TF_ATOL["bfloat16"]:
            raise AssertionError(f"17a: request {i} parts from the single engine at {t} where the forward's "
                                 f"logits are {gap:.3e} apart (not a tie)")
        parted.append({"request": i, "position": t, "gap": gap})
    bench = handoff_bench(torch, dm)
    del fwd, single, fleet
    release(torch)
    out = {
        "requests": len(trace), "prompt_lens": list(FLEET_BASE), "turn_tokens": FLEET_TURN, "new_tokens": FLEET_NEW,
        "engine": FLEET_ENGINE, "handoffs": s["handoffs"], "handoff_bytes": s["handoff_bytes"],
        "handoff_blocks": s["handoff_bytes"] // pool_block, "bytes_per_block": pool_block,
        "bytes_per_block_computed": FLEET_BLOCK_BYTES, "affinity_hits": s["affinity_hits"],
        "wall_s": meta["wall_s"], "equal_to_single_engine": len(trace) - len(parted),
        "parted_at_a_tie": parted, "allocator_checked_every_step": True,
        "corrupt_and_kill": {"re_handoff_blocks": s_bad["re_handoff_blocks"],
                             "rejected_blocks": meta_bad["rejected_blocks"], "kill_at_step": FLEET_KILL_STEP,
                             "requeued": meta_bad["requeued_by_kill"], "completed": s_bad["completed"],
                             "dropped_req_total": s_bad["dropped_req_total"], "outputs_equal_clean_run": True},
        "handoff_ms_by_blocks": bench, "attention_launches": launches,
    }
    log(f"    17a: {out} on {smi}")
    return out


def fleet_service(smi) -> dict:
    """[17b] ``serve --fleet 1:2`` at GPT-2 124M full width in a fresh
    process: three engine processes on the card, the smoke's checks passed,
    the timeline valid against the port's schema."""
    import shutil

    with tempfile.TemporaryDirectory(prefix="fleet_17b_") as d:
        argv = [a.replace("{events}", d) for a in FLEET_ARGS]
        log("    17b: python -m distributeddataparallel_tpu_torch.serve " + " ".join(argv))
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "distributeddataparallel_tpu_torch.serve", *argv], cwd=HERE,
                              env=_entry_env(), capture_output=True, text=True, timeout=400)
        wall = time.perf_counter() - t
        keep = os.environ.get("CHIP_SMOKE_FLEET_TIMELINE")
        if keep and os.path.exists(os.path.join(d, "timeline.jsonl")):
            os.makedirs(os.path.dirname(os.path.abspath(keep)), exist_ok=True)
            shutil.copy(os.path.join(d, "timeline.jsonl"), keep)
        if proc.returncode != 0 or "fleet smoke OK" not in proc.stdout:
            raise AssertionError(f"17b: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        text = proc.stdout
        summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
        records = timeline(d)
    tiers = {r["tier"]: {k: r[k] for k in ("completed", "p50_ttft_s", "p99_ttft_s")}
             for r in records if r["kind"] == "tier_summary"}
    verdicts = [{k: r[k] for k in ("engine", "rung", "requeued", "reason")}
                for r in records if r["kind"] == "engine_verdict"]
    out = {k: summary.get(k) for k in ("requests", "completed", "dropped_req_total", "handoffs", "requeued", "kills",
                                       "elapsed_s", "tokens_out", "serve_tok_s", "serve_p50_ttft_s",
                                       "serve_p99_ttft_s", "tpot_p50_s", "tpot_p99_s", "ttft_decomp")}
    out.update(tiers=tiers, engine_verdicts=verdicts, wall_s=wall, args=FLEET_ARGS,
               kv_handoff_events=sum(r["kind"] == "kv_handoff" for r in records),
               affinity_routed=sum(r["kind"] == "route_admit" and bool(r.get("affinity")) for r in records))
    log(f"    17b: {out} on {smi}")
    return out


def fleet_phase(torch, fa, smi) -> dict:
    """[17] The disaggregated serving fleet (17a in this process, 17b
    across processes)."""
    log("[17] the serving fleet")
    release(torch)
    t = time.perf_counter()
    out = {"inprocess": fleet_inprocess(torch, fa, smi)}
    out["seconds_17a"] = time.perf_counter() - t
    out["service"] = fleet_service(smi)
    out["seconds_17b"] = time.perf_counter() - t - out["seconds_17a"]
    out["attention_launches"] = out["inprocess"]["attention_launches"]
    return out


def _pin(cores: set) -> None:
    """Every thread of this process onto ``cores`` (the processes it starts
    later inherit them)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except OSError:  # the thread has ended
            pass


class ElasticGang:
    """[18a] The CPU gang that writes the checkpoint the card resumes
    (module constants), in the background on the host's last
    ``ELASTIC_CPU_CORES`` cores.  While it runs, this process and those it
    starts keep to the other cores; ``running()`` gives them back once it
    has ended.  ``beside`` names the phases that started while it ran."""

    def __init__(self):
        self.ck = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
        self.all = os.sched_getaffinity(0)
        self.cores = set(sorted(self.all)[-ELASTIC_CPU_CORES:])
        self.beside: list[str] = []
        log(f"    18a CPU gang on cores {sorted(self.cores)}: python -m distributeddataparallel_tpu_torch.dpp "
            + " ".join(ELASTIC_CPU_ARGS))
        cores = self.cores
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "distributeddataparallel_tpu_torch.dpp", *ELASTIC_CPU_ARGS, "--checkpoint-dir",
             self.ck], cwd=HERE, env=_entry_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            preexec_fn=lambda: os.sched_setaffinity(0, cores))
        if self.all - self.cores:
            _pin(self.all - self.cores)

    def running(self) -> bool:
        if self.proc.poll() is None:
            return True
        _pin(self.all)
        return False

    def finish(self) -> dict:
        try:
            return finish_entry(self.proc, "18a CPU gang", timeout=900)
        finally:
            _pin(self.all)

    def stop(self) -> None:
        """Kill the gang if it still runs (a phase before 18 failed)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        _pin(self.all)


def elastic_phase(torch, dpp, fa, gang: ElasticGang, smi) -> dict:
    """[18a] The CPU gang's ZeRO-1 epoch-0 checkpoint (2 ranks) restored on
    the card at world 1: the moments bitwise the two shards' contents
    concatenated, then ``dpp.main --resume`` trains epoch 1 through K1-K3,
    its losses against the gang's own steps 3-4."""
    from distributeddataparallel_tpu_torch.training.checkpoint import CheckpointFiles

    cpu, ck = gang.finish(), gang.ck
    d = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    for f in ("epoch_0.pt", "hash_0.json"):  # epoch 0 alone: --resume takes the newest
        os.link(os.path.join(ck, f), os.path.join(d, f))
    args = dpp.parse_args(ELASTIC_CARD_ARGS + ["--checkpoint-dir", d])
    device = dpp.device_for(args)
    t0 = time.perf_counter()
    payload = CheckpointFiles(d).read(0)
    read_s = time.perf_counter() - t0
    trainer = dpp.build_trainer(args, device, 0, 1)
    t0 = time.perf_counter()
    CheckpointFiles.load_into(trainer.state, payload)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    layout, opt = trainer.state.zero, trainer.state.optimizer
    true, moved = sum(layout.sizes), 0
    for key in ("exp_avg", "exp_avg_sq"):
        got = torch.cat([opt.state[p][key] for p in layout.shard_params]).cpu()
        want = torch.cat([torch.cat([part["optimizer"]["state"][i][key] for i in sorted(part["optimizer"]["state"])])
                          for part in payload["ranks"]])
        if not (torch.equal(got[:true], want[:true]) and not got[true:].any()):
            raise AssertionError(f"18a: the restored {key} is not the two shards' contents concatenated")
        moved += want.numel() * want.element_size()
    ranks = len(payload["ranks"])
    del trainer, payload, opt, layout
    release(torch)
    fa.reset_launches()
    log("    18a card: dpp.main " + " ".join(ELASTIC_CARD_ARGS + ["--checkpoint-dir", d, "--resume"]))
    summary = dpp.main(ELASTIC_CARD_ARGS + ["--checkpoint-dir", d, "--resume"])
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    if summary["start_epoch"] != 1 or summary["train_steps"] != 2:
        raise AssertionError(f"18a: resumed at epoch {summary['start_epoch']} for {summary['train_steps']} steps")
    expect_launches(dict(summary, attention_launches=launches), "18a")
    diff = max(abs(a - b) for a, b in zip(summary["losses"], cpu["losses"][2:4]))
    if len(cpu["losses"]) != 4 or diff > ELASTIC_LOSS_ATOL:
        raise AssertionError(f"18a: card losses {summary['losses']} against the CPU gang's {cpu['losses']}")
    return {"saved_ranks": ranks, "world": summary["world_size"], "moments_bitwise": True,
            "read_s": read_s, "restore_s": restore_s, "resume_restore_s": summary["startup"]["restore_s"],
            "bytes_resharded": moved, "losses": summary["losses"], "cpu_losses": cpu["losses"],
            "max_loss_diff": diff, "loss_atol": ELASTIC_LOSS_ATOL, "step_ms": summary["step_time_s"] * 1e3,
            "attention_launches": launches, "gang_beside_phases": gang.beside}


def elastic_faults(torch, dpp, gang: ElasticGang, cpu_losses: list) -> dict:
    """[18a, ``--elastic-faults``] Faults planted in the CPU gang's epoch-0
    checkpoint (the AdamW moments zeroed; the step counts, the run's and
    the optimizer's, reset to 0), each resumed on the card as 18a resumes
    the sound one: its losses must land above ``ELASTIC_LOSS_ATOL`` from
    the gang's steps 3-4, or 18a's check could not tell it."""
    from distributeddataparallel_tpu_torch.training.checkpoint import CheckpointFiles

    out = {}
    for fault in ("moments_zeroed", "step_reset"):
        payload = CheckpointFiles(gang.ck).read(0)
        for part in payload["ranks"]:
            for st in part["optimizer"]["state"].values():
                for key in (("exp_avg", "exp_avg_sq") if fault == "moments_zeroed" else ("step",)):
                    st[key].zero_()
        if fault == "step_reset":
            payload["step"] = 0
        d = tempfile.mkdtemp(prefix=f"chip_smoke_fault_{fault}_")
        CheckpointFiles(d).write(None, 0, payload)
        del payload
        summary = dpp.main(ELASTIC_CARD_ARGS + ["--checkpoint-dir", d, "--resume"])
        diff = max(abs(a - b) for a, b in zip(summary["losses"], cpu_losses[2:4]))
        out[fault] = {"losses": summary["losses"], "max_loss_diff": diff, "caught": diff > ELASTIC_LOSS_ATOL}
        log(f"    18a planted fault {fault}: losses {summary['losses']}, max diff {diff:.3g} against "
            f"the limit {ELASTIC_LOSS_ATOL}")
        release(torch)
    if not all(r["caught"] for r in out.values()):
        raise AssertionError(f"18a: a planted fault stays within {ELASTIC_LOSS_ATOL}: {out}")
    return out


def elastic_entry(torch, smi) -> dict:
    """[18c] Only with 2+ GPUs.  With 4: GPT-2 ``--zero 1 --elastic --chaos
    worker-kill@3:2`` shrinks in place to 3 after epoch 0's last step, and
    its epoch-1 losses must equal, bit for bit, those of a 3-card
    ``--resume`` from a 4-card run's epoch-0 checkpoint; ``worker-kill@1:2``
    at dispatch depth 2 shrinks mid-epoch and runs the epoch's tail and
    epoch 1 at 3 cards; and ``--fsdp --tp
    2`` saved on 4 cards resumes on 2 (data 2 -> 1), its epoch-1 losses
    against the uninterrupted 4-card run's."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"    18c: not run ({n} GPU visible; it needs 2 or more)")
        return {"ran": False, "gpus": n}
    out: dict = {"ran": True, "gpus": n}
    base = ELASTIC_ENTRY_ARGS
    if n >= 4:
        g, a_ck, b_ck = (tempfile.mkdtemp(prefix=f"chip_smoke_18c_{x}_") for x in "gab")
        a = run_entry(base + ["--num-processes", "4", "--elastic", "--elastic-dir", g, "--chaos", "worker-kill@3:2",
                              "--checkpoint-dir", a_ck], "18c in-place shrink 4 -> 3")
        run_entry(_set(base, "--epochs", "1") + ["--num-processes", "4", "--checkpoint-dir", b_ck], "18c 4-card save")
        b = run_entry(base + ["--num-processes", "3", "--checkpoint-dir", b_ck, "--resume"], "18c 3-card resume")
        if a["world_size"] != 3 or a["losses"][4:] != b["losses"]:
            raise AssertionError(f"18c: the shrink's epoch 1 {a['losses'][4:]} (world {a['world_size']}) is not the "
                                 f"3-card resume's {b['losses']} bit for bit")
        out["zero1_shrink"] = {"losses": a["losses"], "resume_losses": b["losses"], "bitwise": True,
                               "resizes": a["elastic"]["resizes"], "world": a["world_size"]}
        m = run_entry(base + ["--num-processes", "4", "--elastic", "--elastic-dir", tempfile.mkdtemp(
            prefix="chip_smoke_18c_m_"), "--chaos", "worker-kill@1:2", "--dispatch-depth", "2"],
            "18c mid-epoch shrink 4 -> 3")
        # Steps 0-1 at 4 cards are the first run's; the epoch's other 2 and
        # epoch 1's 4 run at 3.
        if m["world_size"] != 3 or len(m["elastic"]["resizes"]) != 1 or m["losses"][:2] != a["losses"][:2] \
                or len(m["losses"]) != 8 or not all(math.isfinite(x) for x in m["losses"]):
            raise AssertionError(f"18c: the mid-epoch shrink: world {m['world_size']}, resizes "
                                 f"{m['elastic']['resizes']}, losses {m['losses']} (the first run's {a['losses']})")
        out["zero1_mid_epoch_shrink"] = {"losses": m["losses"], "resizes": m["elastic"]["resizes"],
                                         "world": m["world_size"]}
    at = base.index("--zero")
    fs = base[:at] + base[at + 2:] + ["--fsdp", "--tp", "2"]
    c_ck = tempfile.mkdtemp(prefix="chip_smoke_18c_c_")
    procs = 4 if n >= 4 else 2
    straight = run_entry(fs + ["--num-processes", str(procs)], f"18c --fsdp --tp 2 on {procs} cards")
    run_entry(_set(fs, "--epochs", "1") + ["--num-processes", str(procs), "--checkpoint-dir", c_ck],
              f"18c --fsdp --tp 2 save on {procs}")
    # The same global batch at data 1: the batch a rank doubles.
    rows = str(int(fs[fs.index("--batch-size") + 1]) * (procs // 2))
    d = run_entry(_set(fs, "--batch-size", rows) + ["--num-processes", "2", "--checkpoint-dir", c_ck, "--resume"],
                  "18c --fsdp --tp 2 resume on 2")
    diff = max(abs(x - y) for x, y in zip(d["losses"], straight["losses"][4:]))
    if d["start_epoch"] != 1 or diff > ELASTIC_ENTRY_ATOL:
        raise AssertionError(f"18c: the 2-card resume's {d['losses']} against {straight['losses'][4:]}")
    out["fsdp_tp_resume"] = {"saved_on": procs, "losses": d["losses"], "straight": straight["losses"][4:],
                             "max_diff": diff, "atol": ELASTIC_ENTRY_ATOL}
    return out


def integrity_phase(torch, dpp, fa, smi) -> dict:
    """[19a] The SDC defence on one card (INTEGRITY_ARGS): every shadow
    re-run's digest equal to the live step's, the losses bitwise the run
    without integrity's, K1-K3 launched (8 steps + 4 shadow re-runs) x 12
    times each, off-cadence step INTEGRITY_SYNC_STEP with no host sync; the
    digest's device ms, the cadence and off-cadence steps' device ms (CUDA
    events around the step function), the shadow's ms, the state copy's
    bytes and the peak memory beside the plain run's.  Then the planted
    transient: one ``sdc_detect`` by ``shadow``, the counters to match, the
    live losses unchanged."""
    from distributeddataparallel_tpu_torch.training import integrity

    device = torch.device("cuda", 0) if DEVICE == "cuda" else torch.device("cpu")

    def run(argv, wrap=None):
        args = dpp.parse_args(argv + ["--device", DEVICE])

        def go():
            trainer = dpp.build_trainer(args, device)
            if wrap is not None:
                trainer.step_fn = wrap(trainer.step_fn)
            return dpp.train(args, trainer, device)

        out = _in_group(torch, dpp, go)
        release(torch)
        return out

    plain = run(INTEGRITY_PLAIN_ARGS)
    record = {"step": [], "shadow": [], "copies": [], "in_shadow": False}

    def timed_step(inner):
        def step_fn(state, batch, seed=None):
            live = not record["in_shadow"]
            ctx = sync_errors(torch) if live and state.step == INTEGRITY_SYNC_STEP else contextlib.nullcontext()
            start = end = None
            if live and DEVICE == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            cadence = state.step % 2 == 0
            with ctx:
                m = inner(state, batch, seed)
            if start is not None:
                end.record()
                record["step"].append((cadence, start, end))
            return m
        return step_fn

    real_shadow, real_copy = dpp.IntegrityLoop.shadow, integrity.copy_tree

    def shadow(self, state, pend, batch, seed):
        record["in_shadow"] = True
        t0 = time.perf_counter()
        try:
            agree = real_shadow(self, state, pend, batch, seed)
        finally:
            record["in_shadow"] = False
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        record["shadow"].append((agree, (time.perf_counter() - t0) * 1e3))
        return agree

    def copy_tree(state):
        c = real_copy(state)
        record["copies"].append(c.nbytes())
        return c

    fa.reset_launches()
    dpp.IntegrityLoop.shadow, integrity.copy_tree = shadow, copy_tree
    try:
        armed = run(INTEGRITY_ARGS, timed_step)
    finally:
        dpp.IntegrityLoop.shadow, integrity.copy_tree = real_shadow, real_copy
    launches = dict(fa.LAUNCHES)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    steps, shadows = armed["train_steps"], len(record["shadow"])
    want = {k: 12 * (steps + shadows) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    faults = armed["faults"]
    if steps != 8 or shadows != 4 or not all(a for a, _ in record["shadow"]) \
            or (DEVICE == "cuda" and launches != want) \
            or faults.get("sdc_checks") != 4 or faults.get("sdc_detects") != 0:
        raise AssertionError(f"19a: {steps} steps, shadows {record['shadow']}, launches {launches} != {want}, "
                             f"faults {faults}")
    if armed["losses"] != plain["losses"]:
        raise AssertionError(f"19a: losses with integrity {armed['losses']} != without {plain['losses']}")
    times = {True: [], False: []}
    for cadence, a, b in record["step"][1:]:  # step 0 pays the first step's one-time costs
        times[cadence].append(a.elapsed_time(b))
    cadence_ms = sum(times[True]) / max(len(times[True]), 1)
    off_ms = sum(times[False]) / max(len(times[False]), 1)
    shadow_ms = sum(ms for _, ms in record["shadow"]) / shadows

    # The digest of a GPT-2 124M state (its parameters and AdamW moments)
    # and one state copy, timed on the card.
    args = dpp.parse_args(INTEGRITY_ARGS + ["--device", DEVICE])

    def digest_cost():
        trainer = dpp.build_trainer(args, device)
        state = trainer.state
        trainer.loader.set_epoch(0)
        trainer.step_fn(state, next(iter(trainer.loader)))  # the moments exist
        fn = integrity.make_digest_fn(None, 0)
        n_cols = int(fn(state).shape[1])
        if DEVICE != "cuda":
            return {"columns": n_cols}
        digest_ms, digest_host_ms = time_ms(torch, lambda: fn(state), 5)
        copy_ms, copy_host_ms = time_ms(torch, lambda: integrity.copy_tree(state), 3)
        return {"columns": n_cols, "digest_ms": digest_ms, "digest_host_ms": digest_host_ms, "copy_ms": copy_ms,
                "copy_host_ms": copy_host_ms}

    cost = _in_group(torch, dpp, digest_cost)
    release(torch)

    # The planted transient: a bit of the shadow's copy of step
    # INTEGRITY_PLANT_STEP's input flipped on the card.
    planted = {"n": 0}

    def flipped_copy(state):
        c = real_copy(state)
        if state.step == INTEGRITY_PLANT_STEP and not planted["n"]:
            integrity.apply_bitflip(state, rank=0, copy=c)
            planted["n"] += 1
        return c

    ev = tempfile.mkdtemp(prefix="chip_smoke_19a_")
    integrity.copy_tree = flipped_copy
    try:
        hit = run(_set(INTEGRITY_ARGS, "--steps-per-epoch", str(INTEGRITY_PLANT_STEPS)) + ["--events-dir", ev])
    finally:
        integrity.copy_tree = real_copy
    detects = [r for r in timeline(ev) if r["kind"] == "sdc_detect"]
    hf = hit["faults"]
    if planted["n"] != 1 or [(r["step"], r["method"], r["rank"]) for r in detects] != [
            (INTEGRITY_PLANT_STEP, "shadow", -1)] or hf.get("sdc_detects") != 1 or hf.get("sdc_evictions", 0) != 0 \
            or hf.get("sdc_checks") != INTEGRITY_PLANT_STEPS // 2 or hit["losses"] != plain["losses"][:INTEGRITY_PLANT_STEPS]:
        raise AssertionError(f"19a planted: {planted}, detects {detects}, faults {hf}, losses {hit['losses']}")
    out = {
        "steps": steps, "shadow_runs": shadows, "shadow_digests_equal": True, "losses_bitwise_unarmed": True,
        "losses": armed["losses"], "attention_launches": launches, "sync_debug_step": INTEGRITY_SYNC_STEP,
        "step_ms_cadence": cadence_ms, "step_ms_off_cadence": off_ms, "shadow_ms": shadow_ms,
        "step_ms_summary": {"armed": armed["step_time_s"] * 1e3, "plain": plain["step_time_s"] * 1e3},
        "copy_bytes": max(record["copies"]), **cost,  # the largest: a copy with the moments
        "peak_memory_bytes": {"armed": armed["peak_memory_bytes"], "plain": plain["peak_memory_bytes"]},
        "planted": {"step": INTEGRITY_PLANT_STEP, "detects": [{k: r[k] for k in ("step", "method", "rank")}
                                                             for r in detects], "faults": hf},
    }
    log(f"    19a: 8 steps, 4 shadow re-runs each bit for bit the live step, losses bitwise the unarmed run's, "
        f"K1-K3 {launches}; step {cadence_ms:.2f} ms on cadence vs {off_ms:.2f} off, shadow {shadow_ms:.1f} ms, "
        f"digest {cost.get('digest_ms', float('nan')):.3f} ms over {cost['columns']} columns, copy "
        f"{cost.get('copy_ms', float('nan')):.3f} ms of {out['copy_bytes']} bytes; planted transient at step "
        f"{INTEGRITY_PLANT_STEP}: one sdc_detect by shadow on {smi}")
    return out


def integrity_entry(torch, smi) -> dict:
    """[19b] Only with 4 GPUs (fewer: not run, said so).  Each run
    supervised.  GPT-2 (INTEGRITY_GPT2_ARGS) with the flip and the join
    goes 4 -> 3 -> 4, the vote naming rank 2 at step 4, with no restart and
    no checkpoint read; its epoch 1 (losses and checkpoint) is bitwise a
    4-card ``--resume`` of its own epoch-0 checkpoint, written on 3 cards;
    the join's seconds split into the process start, the group and the
    state transfer, and the bytes sent.  The MLP flip-and-join run
    (INTEGRITY_ENTRY_ARGS) goes the same way, and its checkpoints are
    bitwise its control's (INTEGRITY_ENTRY_CHAOS)."""
    import shutil

    n = torch.cuda.device_count()
    if n < 4:
        log(f"    19b: not run ({n} GPU visible; it needs 4)")
        return {"ran": False, "gpus": n}
    dirs = {name: tempfile.mkdtemp(prefix=f"chip_smoke_19b_{name}_") for name in ("flip", "control", "gpt2", "resume")}
    sup = ["--num-processes", "4", "--max-restarts", "1"]

    def faulted(base, name, chaos):
        d = dirs[name]
        return run_entry(base + sup + ["--chaos", chaos, "--checkpoint-dir", os.path.join(d, "ck"),
                                       "--events-dir", os.path.join(d, "ev")], f"19b {name}")

    def hashes(name):
        ck = os.path.join(dirs[name], "ck")
        return {f: json.load(open(os.path.join(ck, f)))["sha256"] for f in sorted(os.listdir(ck))
                if f.startswith("hash_")}

    def grown(name, summary):
        """The flip run's timeline: the vote, the sizes, no restart."""
        recs = timeline(os.path.join(dirs[name], "ev"))
        detects = [r for r in recs if r["kind"] == "sdc_detect"]
        sizes = [(r["old_size"], r["new_size"]) for r in recs if r["kind"] == "gang_resize" and r["proc"] == 0]
        restarts = sum(r["kind"] == "restart_attempt" for r in recs)
        if {(r["rank"], r["step"], r["method"]) for r in detects} != {(2, 4, "vote")} or sizes != [(4, 3), (3, 4)] \
                or restarts or summary["world_size"] != 4:
            raise AssertionError(f"19b {name}: detects {detects}, sizes {sizes}, {restarts} restarts, world "
                                 f"{summary['world_size']}")
        join = json.load(open(os.path.join(dirs[name], "ev", "gang", "blobs", "join-proc2")))
        return {"sizes": sizes, "leaves": sorted({x for r in detects for x in r["leaves"]}), "join": join,
                "resizes": summary["elastic"]["resizes"], "losses": summary["losses"]}

    g = faulted(INTEGRITY_GPT2_ARGS, "gpt2", INTEGRITY_ENTRY_CHAOS["flip"])
    res_ck = os.path.join(dirs["resume"], "ck")
    os.makedirs(res_ck)
    for f in ("epoch_0.pt", "hash_0.json"):
        os.link(os.path.join(dirs["gpt2"], "ck", f), os.path.join(res_ck, f))
    resumed = run_entry(INTEGRITY_GPT2_ARGS + ["--num-processes", "4", "--checkpoint-dir", res_ck, "--resume",
                                               "--elastic-dir", os.path.join(dirs["resume"], "gang")],
                        "19b GPT-2 4-card resume")
    gpt2 = grown("gpt2", g)
    if resumed["start_epoch"] != 1 or resumed["losses"] != g["losses"][6:] \
            or hashes("resume").get("hash_1.json") != hashes("gpt2").get("hash_1.json"):
        raise AssertionError(f"19b GPT-2: epoch 1 {g['losses'][6:]} against the 4-card resume's "
                             f"{resumed['losses']} (start epoch {resumed['start_epoch']}); checkpoints "
                             f"{hashes('gpt2')} / {hashes('resume')}")
    gpt2.update(resume_losses=resumed["losses"], grow_bitwise_resume=True, attention_launches=g["attention_launches"])
    runs = {name: faulted(INTEGRITY_ENTRY_ARGS, name, chaos) for name, chaos in INTEGRITY_ENTRY_CHAOS.items()}
    mlp = grown("flip", runs["flip"])
    if hashes("flip") != hashes("control"):
        raise AssertionError(f"19b MLP: checkpoints {hashes('flip')} != the control's {hashes('control')}")
    mlp.update(control_losses=runs["control"]["losses"], checkpoints_bitwise_control=True)
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    j = gpt2["join"]
    log(f"    19b: GPT-2 124M 4 -> 3 -> 4, rank 2 voted out at step 4 ({gpt2['leaves']}), epoch 1 bitwise a "
        f"4-card resume of its epoch-0 checkpoint (written on 3); the join: process start "
        f"{j['process_start_s']:.2f} s, group {j['group_s']:.2f} s, state transfer {j['transfer_s']:.2f} s (the "
        f"trainer's build with the grown group's first collective {j['transfer_build_s']:.2f} s, the receipt "
        f"{j['transfer_recv_s']:.2f} s; {j['bytes']} bytes); MLP: checkpoints bitwise the control's, the join's "
        f"transfer {mlp['join']['transfer_s']:.2f} s for {mlp['join']['bytes']} bytes; on {smi}")
    return {"ran": True, "gpus": n, "gpt2": gpt2, "mlp": mlp}


def tune_launches(layers: int, steps: int, accum: int, remat: bool, evals: int = 0) -> dict:
    """K1-K3 launches of ``steps`` GPT-2 steps of ``accum`` microbatches:
    K1 once a layer a microbatch (twice under remat: the recompute), K2 and
    K3 once, K1 once a layer an eval batch."""
    return {"flash_fwd": layers * (steps * accum * (2 if remat else 1) + evals),
            "flash_bwd_dq": layers * steps * accum, "flash_bwd_dkv": layers * steps * accum}


def trial_knobs(config: dict, lm: bool) -> dict:
    """The dpp flags a tuned config sets (``dpp._apply_trial_to_args``)."""
    out = {"batch_size": config["batch_per_chip"], "accum_steps": config["accum_steps"], "zero": config["zero"],
           "moment_dtype": None if config["moment_dtype"] == "f32" else config["moment_dtype"],
           "bucket_mb": config["bucket_mb"], "dispatch_depth": config["dispatch_depth"]}
    if lm:
        out["remat"] = "on" if config["remat"] else "off"
    return out


def run_launches(s: dict, layers: int) -> dict:
    """A run's K1-K3 launches as its steps, its knobs and its eval imply;
    fails unless the run's own count is that."""
    knobs = s["autotune"]["knobs"]
    want = tune_launches(layers, s["train_steps"], knobs["accum_steps"], knobs["remat"] == "on", s["eval_batches"])
    if s["attention_launches"] != want:
        raise AssertionError(f"20a: the run's launches {s['attention_launches']} != {want}")
    return want


def tuning_phase(torch, dpp, fa, smi) -> dict:
    """[20] 20a: ``--autotune search`` at GPT-2 124M (TUNE_ARGS): the
    measured trials are the top ``--tune-trials`` by predicted score and
    the baseline, each measured or baseline (or refused by the step
    factory, TUNE_REFUSED), the winner's record on disk, the run trains
    with its knobs, K1-K3 launched as the trials' steps and the run imply;
    then ``--autotune apply`` over the same store: no trial, ``applied``,
    the winner's knobs, its step beside the winner's measured one.  20b:
    the apply run's ``--bw-probe`` at world 1 (the reference's keys, 1
    device, utilization 0.0)."""
    import shutil

    log("[20] the autotuner and the probes")
    lm = TUNE_ARGS[TUNE_ARGS.index("--model") + 1] in dpp.LM_MODELS
    layers = TUNE_LAYERS if lm else 0
    d = tempfile.mkdtemp(prefix="tune_20_")
    try:
        common = TUNE_ARGS + ["--tune-dir", os.path.join(d, "tuned"), "--device", DEVICE]
        argv = common + ["--autotune", "search", "--events-dir", os.path.join(d, "ev_search")]
        log("    20a search: dpp.main " + " ".join(argv))
        fa.reset_launches()
        searched = dpp.main(argv)
        search_launches = dict(fa.LAUNCHES)
        events = [r for r in timeline(os.path.join(d, "ev_search")) if r["kind"].startswith("tune_")]
        tuned = searched["autotune"]
        records = tuned["records"]
        chosen = [r for r in records if r["status"] not in ("pruned-cost", "pruned-memory")]
        picks = [r for r in chosen if r["status"] != "baseline"]
        feasible = [r for r in records if r["status"] != "pruned-memory"]
        worst_pick = min((r["predicted_score"] or 0.0) for r in picks)
        if (len(picks) != min(3, len(feasible) - 1) or [r["status"] for r in chosen].count("baseline") != 1
                or any((r["predicted_score"] or 0.0) > worst_pick for r in records if r["status"] == "pruned-cost")):
            raise AssertionError(f"20a: measured {[(r['trial'], r['status']) for r in chosen]} are not the top 3 "
                                 f"by predicted score and the baseline")
        measured = [r for r in chosen if r["status"] in ("measured", "baseline")]
        refused = [r for r in chosen if r["status"].startswith(TUNE_REFUSED)]
        if len(measured) + len(refused) != len(chosen) or not all(r["measured_step_s"] for r in measured):
            raise AssertionError(f"20a: trial statuses {[(r['trial'], r['status']) for r in chosen]}")
        kinds = [r["kind"] for r in events]
        result = [r for r in events if r["kind"] == "tune_result"]
        if kinds.count("tune_trial") != len(records) or [r["mode"] for r in result] != ["search"] \
                or result[0]["winner"] != tuned["winner"]:
            raise AssertionError(f"20a: tune events {kinds}, result {result}")
        with open(tuned["store_path"]) as fh:
            stored = json.load(fh)
        if stored["config"] != tuned["config"] or tuned["knobs"] != trial_knobs(tuned["config"], lm) | (
                {} if lm else {"remat": tuned["knobs"]["remat"]}):
            raise AssertionError(f"20a: stored {stored['config']}, run knobs {tuned['knobs']} vs {tuned['config']}")
        want = tune_launches(0, 0, 1, False)
        for r in measured:
            c = r["config"]
            for k, v in tune_launches(layers, TUNE_TRIAL_STEPS, c["accum_steps"], c["remat"]).items():
                want[k] += v
        run = run_launches(searched, layers)
        want = {k: want[k] + run[k] for k in want}
        if search_launches != want:
            raise AssertionError(f"20a: launches {search_launches} != {want} (trials and run)")
        trials = []
        for r in chosen:
            rec = {"trial": r["trial"], "status": r["status"]}
            if r in measured:
                rec.update(step_ms=r["measured_step_s"] * 1e3, mfu=r["mfu"], first_step_s=r["first_step_s"],
                           predicted_step_ms=r["predicted_step_s"] * 1e3 if r["predicted_step_s"] else None,
                           drift_frac=r["drift_frac"], required_gib=r["required_bytes"] / 2**30,
                           peak_gib=r["peak_bytes"] / 2**30 if r["peak_bytes"] else None)
                log(f"    20a trial {r['trial']} ({r['status']}): {rec['step_ms']:.2f} ms a step, MFU "
                    f"{r['mfu'] if r['mfu'] is None else round(r['mfu'], 4)}, predicted "
                    f"{rec['predicted_step_ms'] if rec['predicted_step_ms'] is None else round(rec['predicted_step_ms'], 2)}"
                    f" ms (drift {r['drift_frac'] if r['drift_frac'] is None else round(r['drift_frac'], 3)}), "
                    f"first step {r['first_step_s']:.2f} s, peak "
                    f"{rec['peak_gib'] if rec['peak_gib'] is None else round(rec['peak_gib'], 2)} GiB "
                    f"(analytic {rec['required_gib']:.2f})")
            else:
                log(f"    20a trial {r['trial']}: {r['status']}")
            trials.append(rec)
        winner = next(r for r in measured if r["trial"] == tuned["winner"])
        log(f"    20a: winner {tuned['winner']} (gain {tuned['gain_frac']:+.3f} over the baseline), "
            f"{len(records)} trials priced, {len(measured)} measured, {len(refused)} refused; the run: "
            f"{searched['train_steps']} steps at {searched['step_time_s'] * 1e3:.2f} ms, {searched['eval_batches']} "
            f"eval batches; launches {search_launches} on {smi}")

        argv = common + ["--autotune", "apply", "--bw-probe", "--events-dir", os.path.join(d, "ev_apply")]
        log("    20a apply + 20b: dpp.main " + " ".join(argv))
        fa.reset_launches()
        applied = dpp.main(argv)
        apply_launches = dict(fa.LAUNCHES)
        events = [r for r in timeline(os.path.join(d, "ev_apply")) if r["kind"].startswith("tune_")]
        if [r["kind"] for r in events] != ["tune_result"] or events[0]["mode"] != "apply" \
                or events[0]["applied"] is not True or events[0]["winner"] != tuned["config"]:
            raise AssertionError(f"20a apply: tune events {events}")
        if applied["autotune"]["knobs"] != tuned["knobs"]:
            raise AssertionError(f"20a apply: knobs {applied['autotune']['knobs']} != {tuned['knobs']}")
        if apply_launches != run_launches(applied, layers):
            raise AssertionError(f"20a apply: launches {apply_launches}")
        probe = applied["bw_probe"]
        if set(probe) != {"devices", "payload_mb", "time_s", "bus_bw_gb_s", "peak_gb_s", "utilization"} or \
                (probe["devices"], probe["bus_bw_gb_s"], probe["utilization"]) != (1, 0.0, 0.0):
            raise AssertionError(f"20b: probe {probe}")
        log(f"    20a apply: no trial, the winner's knobs {applied['autotune']['knobs']}; step "
            f"{applied['step_time_s'] * 1e3:.2f} ms against the winner's measured {winner['measured_step_s'] * 1e3:.2f} "
            f"ms on {smi}")
        log(f"    20b: --bw-probe at world 1: {probe}")
        launches = {k: search_launches[k] + apply_launches[k] for k in search_launches}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {
        "winner": tuned["winner"], "config": tuned["config"], "gain_frac": tuned["gain_frac"],
        "knobs": tuned["knobs"], "trials": trials, "n_priced": len(records), "refused": len(refused),
        "run": {"steps": searched["train_steps"], "step_ms": searched["step_time_s"] * 1e3,
                "eval_batches": searched["eval_batches"], "losses": searched["losses"],
                "peak_gib": searched["peak_memory_bytes"] / 2**30 if searched["peak_memory_bytes"] else None},
        "apply": {"step_ms": applied["step_time_s"] * 1e3, "winner_measured_step_ms": winner["measured_step_s"] * 1e3,
                  "losses": applied["losses"]},
        "bw_probe": probe, "attention_launches": launches,
        "launches": {"search": search_launches, "apply": apply_launches},
    }


def overlap_worker(rank: int, nprocs: int, store_address: str, out_path: str, device_type: str,
                   c: dict) -> None:
    """[20c] One rank of ``overlap_probe`` at GPT-2 124M's width over NCCL
    (a ``runtime.launcher.spawn`` member): the plain step and the
    ``--overlap`` step, and a 64 MB all-reduce; rank 0 writes the result."""
    import numpy as np
    import torch

    from distributeddataparallel_tpu_torch.models import transformer as tfm
    from distributeddataparallel_tpu_torch.ops.losses import lm_cross_entropy
    from distributeddataparallel_tpu_torch.runtime import distributed as rt
    from distributeddataparallel_tpu_torch.training.state import TrainState
    from distributeddataparallel_tpu_torch.utils.metrics import allreduce_bandwidth, overlap_probe

    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    rt.init_process_group(store_address=store_address, world_size=nprocs, rank=rank, device=device)
    try:
        cfg = tfm.gpt2_124m(**c["cfg"])
        model = tfm.TransformerLM(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
        state = TrainState(model, torch.optim.AdamW(model.parameters(), lr=3e-4, fused=True))
        tokens = np.random.default_rng(rank).integers(0, cfg.vocab_size, size=(c["B"], c["S"] + 1), dtype=np.int32)
        batch = {"tokens": torch.from_numpy(tokens).to(device)}

        def loss(m, b):
            return lm_cross_entropy(m(b["tokens"][:, :-1]), b["tokens"][:, 1:]), {}

        out = {"plain": overlap_probe(loss, state, batch, iters=c["iters"]),
               "overlap": overlap_probe(loss, state, batch, iters=c["iters"], overlap=True),
               "bw_64mb": allreduce_bandwidth(size_mb=64.0, iters=10)}
        if rank == 0:
            with open(out_path, "w") as fh:
                json.dump(out, fh)
    finally:
        rt.destroy_process_group()


def tuning_entry(torch, smi) -> dict:
    """[20c] With 2+ GPUs: ``--bw-probe`` over every GPU (bus GB/s at 64 MB
    against the 450 GB/s link peak) and ``overlap_probe`` at GPT-2 124M's
    width (``step_ms``, ``compute_ms``, ``comm_ms``, ``overlap_frac``)."""
    from distributeddataparallel_tpu_torch import dpp
    from distributeddataparallel_tpu_torch.runtime import launcher

    n = torch.cuda.device_count() if DEVICE == "cuda" else 4
    if n < 2:
        log(f"    20c: needs 2+ GPUs ({n} visible): not run")
        return {"ran": False, "gpus": n}
    argv = TUNE_ENTRY_ARGS + ["--num-processes", str(n), "--device", DEVICE]
    log("[20c] dpp.main " + " ".join(argv))
    probe = dpp.main(argv)["bw_probe"]
    if probe["devices"] != n or not probe["bus_bw_gb_s"] > 0 or (DEVICE == "cuda" and not probe["utilization"] > 0):
        raise AssertionError(f"20c: probe {probe}")
    log(f"    20c --bw-probe: {n} ranks, {probe['payload_mb']:.0f} MB -> {probe['bus_bw_gb_s']:.1f} GB/s bus, "
        f"{100 * probe['utilization']:.1f}% of {probe['peak_gb_s']} GB/s on {smi}")
    with tempfile.TemporaryDirectory(prefix="overlap_20c_") as d:
        path = os.path.join(d, "overlap.json")
        launcher.spawn(overlap_worker, args=(path, DEVICE, OVERLAP_PROBE), nprocs=n)
        with open(path) as fh:
            overlap = json.load(fh)
    for name in ("plain", "overlap"):
        o = overlap[name]
        if o["devices"] != n or o["overlap_frac"] is None or not 0.0 <= o["overlap_frac"] <= 1.0:
            raise AssertionError(f"20c: overlap_probe {name} {o}")
        log(f"    20c overlap_probe {name}: step {o['step_ms']:.2f} ms, compute {o['compute_ms']:.2f} ms, comm "
            f"{o['comm_ms']:.2f} ms, overlap_frac {o['overlap_frac']} ({o['grad_mb']} MB of gradients) on {smi}")
    return {"ran": True, "gpus": n, "bw_probe": probe, "overlap_probe": overlap}


def release(torch) -> None:
    """Free what earlier runs left (a model held by a reference cycle, say,
    the reducer's hooks) before the next run's peak is measured."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def llama_zero_record(s: dict, layers: int, what: str) -> dict:
    """A ZeRO Llama run's checks (K1 twice a layer a step: forward and
    recompute; K2, K3 once; losses finite and falling) and numbers."""
    steps, losses = s["train_steps"], s["losses"]
    want = {"flash_fwd": 2 * layers * steps, "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps}
    if s["attention_launches"] != want:
        raise AssertionError(f"{what}: launches {s['attention_launches']} != {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: losses {losses}")
    rec = {"layers": layers, "num_params": s["num_params"], "step_ms": s["step_time_s"] * 1e3,
           "peak_gib": s["peak_memory_bytes"] / 2**30, "losses": losses,
           "attention_launches": s["attention_launches"]}
    log(f"    {what}: step {rec['step_ms']:.1f} ms, peak {rec['peak_gib']:.2f} GiB (phase 7, plain DP at 8 "
        f"layers: 52.14), {s['num_params'] / 1e9:.3f} B params, losses {['%.4f' % x for x in losses]}")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a GPU", file=sys.stderr)
        return 1
    from distributeddataparallel_tpu_torch import dpp
    from distributeddataparallel_tpu_torch.models import transformer as tfm
    from distributeddataparallel_tpu_torch.ops import flash_attention as fa

    t_all = time.perf_counter()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"[1] card: {kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    from distributeddataparallel_tpu_torch.training import warm_start

    # The kernels' first build goes into a fresh compile cache, which every
    # later run of this script (in this process, or a fresh one through
    # DDP_COMPILE_CACHE) loads from: phase 16c's cold, then cache-hit.
    cache = warm_start.enable_compile_cache(tempfile.mkdtemp(prefix="chip_smoke_cache_"))
    t0 = time.perf_counter()
    so = fa.build()
    log(f"[2] build: {so.name} in {time.perf_counter() - t0:.1f} s into the fresh --compile-cache {cache} "
        f"({warm_start.warm_start_mode()}: {warm_start.STATS.misses} built, {warm_start.STATS.hits} found)")
    for line in ptxas_report(so.with_suffix(".log").read_text()):
        log("    " + line)
    if "--elastic-faults" in sys.argv[1:]:
        # Phase 18a alone, then the faults planted in its checkpoint.
        gang = ElasticGang()
        try:
            fa.reset_launches()
            sound = elastic_phase(torch, dpp, fa, gang, smi)
        finally:
            gang.stop()
        faults = elastic_faults(torch, dpp, gang, sound["cpu_losses"])
        log(json.dumps({"elastic_faults": {"sound": sound, "planted": faults}, "card": smi,
                        "seconds": time.perf_counter() - t_all}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0
    if "--multi-gpu" in sys.argv[1:]:
        # Only the entry-point runs over several GPUs (12c, 13c, 14c, 15c,
        # 15c+, 18c, or those named after the flag): what a one-card run
        # skips.
        entries = {"12c": cp_tp_entry, "13c": fsdp_entry, "14c": moe_entry, "15c": pp_entry, "15c+": pp_entry_16b,
                   "18c": elastic_entry, "19b": integrity_entry, "20c": tuning_entry}
        picked = [a for a in sys.argv[sys.argv.index("--multi-gpu") + 1:] if a in entries] or list(entries)
        out = {name: entries[name](torch, smi) for name in picked}
        log(json.dumps({"multi_gpu": out, "card": smi, "seconds": time.perf_counter() - t_all}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    log("[3] kernels against their plain versions (|err| <= atol + rtol*|plain|)")
    errs = {}
    for i, (name, c) in enumerate(CHECK_CASES):
        errs[name] = check_case(torch, fa, name, c, seed=i)
    log(f"    timing at the GPT-2 shapes {GPT2} ({smi})")
    timing = measure(torch, fa, GPT2, 100, [name for name, _, _ in KERNELS])
    log(f"    timing at the bf16 GQA shapes {GQA_BF16}")
    timing_bf16 = measure(torch, fa, GQA_BF16, 101, [name for name, _, _ in KERNELS])
    log(f"    timing at phase 7's attention shapes {LLAMA}")
    timing_llama = measure(torch, fa, LLAMA, 102, [name for name, _, _ in KERNELS])

    log("[4] main path: dpp.main " + " ".join(MAIN_ARGS))
    fa.reset_launches()
    summary = dpp.main(MAIN_ARGS)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    losses = summary["losses"]
    steps, evals = summary["train_steps"], summary["eval_batches"]
    layers = 12
    expect = {
        "flash_fwd": layers * (steps + evals),
        "flash_bwd_dq": layers * steps,
        "flash_bwd_dkv": layers * steps,
    }
    log(f"    losses {['%.4f' % x for x in losses]}; eval {summary['eval']}")
    log(f"    launches {launches}, expected {expect}")
    if steps != 10 or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"main path: {steps} steps, losses {losses}")
    if summary["eval"] is None or not math.isfinite(summary["eval"]["loss"]):
        raise AssertionError(f"main path: eval {summary['eval']}")
    if launches != expect:
        raise AssertionError(f"main path launches {launches} != expected {expect}")
    log(f"    step {summary['step_time_s'] * 1e3:.1f} ms (first {summary['first_step_time_s']:.2f} s), "
        f"{summary['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{summary['peak_memory_bytes'] / 2**30:.2f} GiB on {smi}")

    seconds = {"1_4": time.perf_counter() - t_all}
    gang = None

    def timed(name, fn, *a):
        if gang is not None and gang.running():
            gang.beside.append(name)
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        return out

    image_paths = timed("5_6", lambda: {
        "resnet50_imagenet_shape": resnet50_phase(torch, dpp, fa, smi),
        "resnet18_cifar_resume": resnet18_resume_phase(torch, dpp, fa, smi),
    })
    llama = timed("7", llama_phase, torch, dpp, fa, tfm, smi)
    reference = timed("8", reference_workload_phase, torch, dpp, fa, smi)
    fault = timed("9", fault_path_phase, torch, dpp, losses, smi)
    serving = timed("10", serving_path_phase, torch, dpp, fa, smi)
    # Phase 18a's CPU gang, from phase 11 on, on 2 cores of its own, the
    # phases beside it on the others (not beside 9 or 10, whose host-side
    # latencies are figures of their own); the phases it ran beside are in
    # the elastic_path line.
    gang = ElasticGang()
    try:
        layouts = timed("11", layouts_phase, torch, dpp, fa, smi)
        cp_tp = timed("12", cp_tp_phase, torch, fa, tfm, smi)
        fsdp_path = timed("13", fsdp_phase, torch, dpp, fa, llama["losses"], layouts["gpt2"]["plain"]["losses"],
                          smi)
        moe_path = timed("14", moe_phase, torch, dpp, fa, tfm, smi)
        pp_path = timed("15", pp_phase, torch, fa, tfm, smi)
        fa.reset_launches()
        warm_path = timed("16", warm_start_phase, torch, dpp, summary["faults"], fault["replay"]["restart"], smi)
        warm_path["attention_launches"] = dict(fa.LAUNCHES)
        fleet_path = timed("17", fleet_phase, torch, fa, smi)
        fa.reset_launches()
        elastic_path = timed("18", elastic_phase, torch, dpp, fa, gang, smi)
    finally:
        gang.stop()
    log("    18c: only with --multi-gpu on 2+ GPUs (not run on this one-card call)")
    integrity_path = timed("19", integrity_phase, torch, dpp, fa, smi)
    log("    19b: only with --multi-gpu on 4 GPUs (not run on this one-card call)")
    tuning_path = timed("20", tuning_phase, torch, dpp, fa, smi)
    log("    20c: only with --multi-gpu on 2+ GPUs (not run on this one-card call)")

    kernels = []
    for name, replaces, _ in KERNELS:
        t = timing[name]
        outputs = ("out", "lse") if name == "flash_fwd" else ("dq",) if name == "flash_bwd_dq" else ("dk", "dv")
        entry = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name],
            "launches_image_paths": sum(p["attention_launches"][name] for p in image_paths.values()),
            "launches_llama": llama["attention_launches"][name],
            "launches_reference_workload": reference["attention_launches"][name],
            "launches_fault_path": fault["launches"][name],
            "launches_serving_path": serving["attention_launches"][name],
            "launches_layouts": layouts["attention_launches"][name],
            "launches_cp_tp_path": cp_tp["attention_launches"][name],
            "launches_fsdp_path": fsdp_path["attention_launches"][name],
            "launches_moe_path": moe_path["attention_launches"][name],
            "launches_pp_path": pp_path["attention_launches"][name],
            "launches_warm_start_path": warm_path["attention_launches"][name],
            "launches_fleet_path": fleet_path["attention_launches"][name],
            "launches_elastic_path": elastic_path["attention_launches"][name],
            "launches_integrity_path": integrity_path["attention_launches"][name],
            "launches_tuning_path": tuning_path["attention_launches"][name],
            "max_abs_err": max(errs["gpt2_f32_causal"][k] for k in outputs),
            "ms": t["ms"], "host_ms": t["host_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_cuda_core_ms": t["bound_cuda_core_ms"], "library_ms": t["library_ms"],
            "library_host_ms": t["library_host_ms"], "library_call": t["library_call"],
            "shapes": GPT2,
        }
        if name in timing_bf16:
            tb = timing_bf16[name]
            entry["bf16"] = {k: tb[k] for k in (
                "ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_host_ms")}
            entry["bf16"]["shapes"] = GQA_BF16
        tl = timing_llama[name]
        entry["llama"] = {k: tl[k] for k in (
            "ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_host_ms")}
        entry["llama"].update(shapes=LLAMA, max_abs_err=max(errs["llama_bf16_s2048"][k] for k in outputs))
        kernels.append(entry)
    main_path = {
        "step_ms": summary["step_time_s"] * 1e3, "tokens_per_s": summary["tokens_per_s"],
        "peak_memory_bytes": summary["peak_memory_bytes"], "losses": losses,
        "eval": summary["eval"], "train_steps": steps, "eval_batches": evals,
    }
    log(json.dumps({"checks": {"tolerance": TOL, "max_abs_err": errs}, "card": smi}))
    log(json.dumps({"main_path": main_path, "card": smi}))
    log(json.dumps({"image_paths": image_paths, "card": smi}))
    log(json.dumps({"llama_path": llama, "card": smi}))
    log(json.dumps({"reference_workload": reference, "card": smi}))
    log(json.dumps({"fault_path": fault, "card": smi}))
    log(json.dumps({"serving_path": serving, "card": smi}))
    log(json.dumps({"layouts": layouts, "card": smi}))
    log(json.dumps({"cp_tp_path": cp_tp, "card": smi}))
    log(json.dumps({"fsdp_path": fsdp_path, "card": smi}))
    log(json.dumps({"moe_path": moe_path, "card": smi}))
    log(json.dumps({"pp_path": pp_path, "card": smi}))
    log(json.dumps({"warm_start_path": warm_path, "card": smi}))
    log(json.dumps({"fleet_path": fleet_path, "card": smi}))
    log(json.dumps({"elastic_path": elastic_path, "card": smi}))
    log(json.dumps({"integrity_path": integrity_path, "card": smi}))
    log(json.dumps({"tuning_path": tuning_path, "card": smi}))
    log(json.dumps({"phase_seconds": seconds, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(nvidia_smi())  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
