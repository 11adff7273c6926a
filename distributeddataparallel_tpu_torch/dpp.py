"""Data-parallel trainer: the port's entry point.

    python -m distributeddataparallel_tpu_torch.dpp --model resnet18 \\
        --dataset synthetic --augment --eval
    python -m distributeddataparallel_tpu_torch.dpp --model resnet50 \\
        --dataset shards:DIR --batch-size 64 --optimizer sgd --momentum 0.9
    python -m distributeddataparallel_tpu_torch.dpp --model gpt2 \\
        --dataset synthetic-lm --seq-len 1024 --vocab-size 50257 \\
        --batch-size 8 --optimizer adamw --lr 3e-4 --steps-per-epoch 10 --eval
    python -m distributeddataparallel_tpu_torch.dpp --model llama --layers 8 \\
        --dataset tokens:train.npy --seq-len 2048 --batch-size 2 \\
        --optimizer adamw --lr 3e-4 [--dropout 0.1] [--pretrained FILE]

Counterpart of the plain data-parallel subset of the reference's ``dpp.py``
(image models ``mlp``, ``cnn`` (the default), ``resnet18`` (CIFAR stem) and
``resnet50``; the LMs ``gpt2`` and ``llama`` (Llama-3 8B: bf16 activations
on f32 params, activation checkpointing, GQA)), with the same flag names and
defaults.  LMs train on ``synthetic-lm`` or on a token file (``tokens:FILE``,
``data.tokens``; eval reads its sibling val split).
``--checkpoint-dir`` saves every epoch and ``--resume`` continues at the
epoch after the newest one saved.  It runs on the GPU unless ``--device cpu``
is given; ``--device cuda`` (the default) raises when no GPU is present.
``--num-processes N`` starts one process per device (``cuda:0`` ..
``cuda:N-1``, or N CPU processes on gloo; ``--fake-devices N`` on the CPU
too); rank 0's summary is returned by ``main`` and printed as the last line
of output.  A multi-host job gives every host the same ``--coordinator
HOST:PORT`` and ``--num-processes`` (hosts) and its own ``--process-id``;
each host starts one process per local device (all visible GPUs, or
``--fake-devices`` CPU ranks).

Fault tolerance, with the reference's flags (``training.fault_tolerance``,
``utils.chaos``, ``runtime.launcher``): ``--nan-guard`` skips a step whose
gradients are not finite (``--max-bad-steps`` in a row stop the run);
``--checkpoint-dir`` saves hash-checked checkpoints with retry, falls back
past a corrupt one on ``--resume``, and on SIGTERM saves the interrupted
epoch and exits 0; ``--step-timeout`` exits 75 from a wedged step after a
best-effort save; ``--max-restarts N`` runs the trainer under a supervisor
that restarts it with ``--resume``; ``--chaos SPEC`` (or ``DDP_CHAOS``)
injects faults to prove it.

Image models take ``--pretrained`` torchvision ResNet state dicts (``.pth``
or safetensors).  Telemetry, with the reference's flags
(``training.telemetry``): ``--events-dir DIR`` writes schema-versioned
JSONL events (spans, metrics snapshots every ``--metrics-every`` steps,
goodput, the run summary) and rank 0 merges them into
``DIR/timeline.jsonl``; ``--mfu`` and ``--memory-telemetry`` report MFU/HFU
and the allocator's bytes at every throughput window; ``--alerts [SPEC]``
evaluates the SLO rules there; ``--runs-dir DIR`` appends the run summary
to ``DIR/index.jsonl``; ``--profile-steps A:B`` writes a ``torch.profiler``
Chrome trace of steps [A, B) to ``--profile-dir`` or ``DIR/xprof``, and
``--profile-dir`` alone traces the first epoch.

The sharded update and the comm hooks, with the reference's flags and
composition rules: ``--zero [1|2|3]`` (``parallel.zero``; ``--bucket-mb``
sizes the level 2/3 buckets) with ``--moment-dtype f32|bf16|int8``,
``--overlap`` (bucket all-reduces launched from backward's hooks,
``parallel.overlap``), and ``--grad-compress bf16|powersgd``
(``--powersgd-rank``; ``parallel.powersgd``).  ``--fsdp`` shards the
parameters, gradients and optimizer state of an LM over the data ranks and
gathers each layer inside the step (``parallel.fsdp``; ``--fsdp-gather
bf16`` gathers in bf16), composing with ``--tp``; its ``--eval`` streams the
same gathers and ``--generate`` decodes the host-gathered whole model.

Model-axis layouts for the LMs, with the reference's flags and checks:
``--cp N`` shards the sequence over a ``seq`` axis (``--cp-impl ring``,
the flash ring, or ``ulysses``; ``parallel.context_parallel``) and ``--tp
N`` shards heads and hidden units over a ``model`` axis (Megatron,
``parallel.tensor_parallel``).  The ranks form the reference's mesh: data
outermost, then ``seq``, then ``model`` (``runtime.distributed.make_mesh``).
They compose with each other and with ``--accum-steps``, ``--zero 1``,
``--grad-clip``, ``--eval``, ``--remat`` and ``--dropout``, and ``--cp`` with
``--overlap`` (one mean over the data x seq ranks launched from backward)
and ``--grad-compress powersgd`` (after the seq mean, over the data ranks).

Mixture of experts, with the reference's flags and checks: ``--moe-experts
E`` makes every LM block's MLP E experts routed top-``--moe-top-k``, dense
dispatch or, with ``--moe-capacity-factor`` > 0, capacity-bounded token
choice (``models.transformer.MoEMLP``, ``ops.moe``); the loss adds
``--moe-aux-weight`` times the load-balance term, reported as ``moe_aux``.
``--ep N`` shards the experts over an ``expert`` axis
(``parallel.expert_parallel``; the mesh: data, seq, expert, model), with
``--cp`` or ``--tp``, ``--zero 1``, the comm hooks but PowerSGD,
``--accum-steps``, ``--grad-clip``, ``--eval`` and checkpoints.

Pipeline parallelism, with the reference's flags and checks: ``--pp N``
splits the layers into N stages over a ``pipe`` axis (the mesh: data, seq,
pipe, expert, model) and ``--pp-schedule gpipe|1f1b|zb`` runs
``--pp-microbatches`` microbatches through them
(``parallel.pipeline_parallel``; zb is the zero-bubble schedule), each
stage in ``--pp-virtual`` interleaved chunks under 1f1b and zb, with
``--tp``, ``--ep`` or ``--cp`` (ring or Ulysses inside each stage; not
with zb), ``--zero 1``, ``--grad-clip``, ``--eval`` (pipelined) and
checkpoints; 1F1B and zb emit one ``pp_phase`` event.

Bounded dispatch and the warm start, with the reference's flags
(``training.warm_start``): the loop keeps up to ``--dispatch-depth`` K steps
(default 2) in flight and settles each step's handle (the nonfinite flag
under ``--nan-guard``, else the loss) when it leaves the window, draining
everything at a throughput window, a log line, a checkpoint and the epoch
edge; K = 0 settles every step at once.  The guard decides its skip on the
device.  ``--compile-cache DIR`` (env ``DDP_COMPILE_CACHE``) roots the
kernels' builds at ``DIR/build/``, inherited by spawned and restarted
processes; the ``warm_start`` event says ``cold``, ``cache-hit`` or
``eager``.

The elastic gang on one host (``--elastic``; ``runtime.elastic_gang``):
a member lost at a step boundary (chaos ``worker-kill``, an SDC eviction)
is resized around in place with the live state, and a chaos ``worker-join``
takes a new process for a member back before its step (the launcher's join
rung starts it; the survivors wait for it, reshard and send it the live
state; it reads no checkpoint).  The silent-data-corruption defence
(``training.integrity``): ``--integrity-every N`` digests the step's input
state every N steps and all-gathers the digests; a mismatch discards the
step's update, the vote names the corrupt rank, and under ``--elastic`` it
is evicted in place (else the run stops); ``--integrity-shadow`` runs each
cadence step a second time on a copy of its inputs and compares the
digests (a transient fault, even at world 1).  Cadence steps are drain
points.

The autotuner and the probes, with the reference's flags and checks:
``--autotune search`` (``tuning``) prices the DP/ZeRO knob space
(``--batch-size``, ``--accum-steps``, ``--remat``, ``--zero``,
``--moment-dtype``, ``--bucket-mb``, ``--dispatch-depth``) analytically,
measures the top ``--tune-trials`` and the CLI's own values for
``--tune-steps`` steps each, persists the winner under ``--tune-dir``, and
trains with it; ``--autotune apply`` replays a persisted winner with no
trial (the CLI's values, loudly, when none matches).  ``tune_trial`` and
``tune_result`` events go to the run's event log and the outcome to the
summary's ``autotune``.  ``--bw-probe`` measures the gradient all-reduce's
bus bandwidth over the data axis before training (the summary's
``bw_probe``).

The run's first step is recorded (``analysis.graph_lint``): the
fingerprint of the collectives it issued is the summary's
``collective_fp``.  ``--lint-step`` lints that step as it runs (its
manifest, a device-to-host sync inside it, the schedule its factory
attaches) and stops the run on a finding; the step is the run's own, so
the losses are those of the run without the flag.

Every flag of the reference runs (``UNPORTED_FLAGS`` is empty).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import signal
import sys
import tempfile
import time

import numpy as np
import torch

from distributeddataparallel_tpu_torch.data.datasets import (
    SyntheticClassification,
    SyntheticLM,
    load_cifar10,
)
from distributeddataparallel_tpu_torch.data.loader import DataLoader
from distributeddataparallel_tpu_torch.data.sharded import ShardedImageDataset
from distributeddataparallel_tpu_torch.data.tokens import TokenFileDataset
from distributeddataparallel_tpu_torch.data.transforms import CifarAugment
from distributeddataparallel_tpu_torch.models import transformer as tfm
from distributeddataparallel_tpu_torch.models.io import jax_leaf_pieces, load_pretrained
from distributeddataparallel_tpu_torch.models.resnet import ResNet18, ResNet50
from distributeddataparallel_tpu_torch.models.simple_cnn import SimpleCNN, TinyMLP
from distributeddataparallel_tpu_torch.observability import (
    mlp_fwd_flops,
    parse_alert_spec,
    parse_profile_steps,
    simple_cnn_fwd_flops,
    train_step_flops,
    transformer_fwd_flops,
)
from distributeddataparallel_tpu_torch.observability.pipeline import phase_counts_payload
from distributeddataparallel_tpu_torch.ops import flash_attention
from distributeddataparallel_tpu_torch.ops.dropout import fold_seed
from distributeddataparallel_tpu_torch.ops.losses import (
    accuracy,
    cross_entropy_loss,
    lm_cross_entropy,
    per_example_accuracy,
    per_example_cross_entropy,
)
from distributeddataparallel_tpu_torch.ops.preprocess import normalize_u8_images
from distributeddataparallel_tpu_torch.parallel import fsdp, overlap, pipeline_parallel
from distributeddataparallel_tpu_torch.parallel.data_parallel import broadcast_params
from distributeddataparallel_tpu_torch.parallel.powersgd import leaf_shapes, powersgd_state
from distributeddataparallel_tpu_torch.parallel.expert_parallel import shard_model_axes
from distributeddataparallel_tpu_torch.parallel.zero import zero_state
from distributeddataparallel_tpu_torch.runtime import distributed as rt
from distributeddataparallel_tpu_torch.runtime import launcher
from distributeddataparallel_tpu_torch.training import integrity, warm_start
from distributeddataparallel_tpu_torch.training.fault_tolerance import (
    NonFiniteBreaker,
    ResilientCheckpointer,
    StepWatchdog,
)
from distributeddataparallel_tpu_torch.training.optim import build_optimizer
from distributeddataparallel_tpu_torch.training.state import TrainState
from distributeddataparallel_tpu_torch.training.telemetry import Telemetry
from distributeddataparallel_tpu_torch.training.train_step import (
    make_eval_step,
    make_train_step,
)
from distributeddataparallel_tpu_torch.utils.chaos import (
    FaultInjector,
    SimulatedPreemption,
    check_ported,
    parse_chaos_spec,
)
from distributeddataparallel_tpu_torch.utils.logging import log0, warn0, warn_all
from distributeddataparallel_tpu_torch.utils.metrics import allreduce_bandwidth


LM_MODELS = ("gpt2", "llama")


def _dataset_arg(v: str) -> str:
    if v in ("synthetic", "cifar10", "synthetic-lm") or v.startswith(("shards:", "tokens:")):
        return v
    raise argparse.ArgumentTypeError(
        f"{v!r} is not one of synthetic | cifar10 | synthetic-lm | shards:DIR | tokens:FILE"
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--model", choices=["mlp", "cnn", "resnet18", "resnet50", *LM_MODELS],
                   default="cnn", help="model family (resnet18 has the CIFAR stem)")
    p.add_argument("--dataset", type=_dataset_arg, default=None,
                   help="synthetic | cifar10 | synthetic-lm | shards:DIR (memory-mapped "
                        "image shards, DIR or DIR/{train,val}) | tokens:FILE (memory-mapped "
                        ".npy token stream or rows; eval reads the sibling val split); "
                        "default synthetic-lm for LMs, synthetic otherwise")
    p.add_argument("--data-root", default="data", help="where cifar10 looks for its batches")
    p.add_argument("--workers", type=int, default=0,
                   help="background input-pipeline threads (0 = inline; any other "
                        "value gathers on one background thread)")
    p.add_argument("--augment", action="store_true",
                   help="CIFAR training augmentation (random crop pad 4 + horizontal "
                        "flip), deterministic per (seed, epoch, step); image datasets only")
    p.add_argument("--seq-len", type=int, default=128, help="LM sequence length")
    p.add_argument("--token-stride", type=int, default=None,
                   help="window-start spacing for tokens:FILE flat streams (< seq-len "
                        "overlaps windows; default seq-len); train split only")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="LM embedding and residual dropout rate, in (0, 1)")
    p.add_argument("--remat", choices=["auto", "on", "off"], default="auto",
                   help="activation checkpointing for LMs: auto keeps the family's "
                        "default (llama on, gpt2 off)")
    p.add_argument("--pretrained", default=None, metavar="FILE",
                   help="initialize from a torchvision ResNet state_dict (image "
                        "models), HF GPT-2 / Llama tensors (LMs) or this framework's "
                        "save_params safetensors (format sniffed from the keys)")
    p.add_argument("--vocab-size", type=int, default=256,
                   help="LM vocab size (synthetic data; a token file's sidecar overrides it)")
    p.add_argument("--num-examples", type=int, default=2048)
    p.add_argument("--layers", type=int, default=None,
                   help="override the model family's layer count")
    p.add_argument("--d-model", type=int, default=None,
                   help="override the model family's width (heads = d_model // 16; "
                        "llama's kv heads the largest divisor of heads up to heads // 4)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-replica batch (global = batch x replicas)")
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="cap the training steps of each epoch")
    p.add_argument("--optimizer", choices=["sgd", "adam", "adamw"], default="sgd")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="decoupled weight decay (adamw; ignored otherwise)")
    p.add_argument("--lr-schedule", choices=["constant", "cosine", "linear"], default="constant")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--min-lr", type=float, default=0.0)
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation (DDP no_sync analog)")
    p.add_argument("--bucket-mb", type=float, default=None,
                   help="coalesce the gradient all-reduce into buckets of this size (MiB); "
                        "under --zero 2/3 the size of the reduce-scatter buckets")
    p.add_argument("--zero", type=int, nargs="?", const=1, default=0, choices=[0, 1, 2, 3],
                   metavar="LEVEL",
                   help="ZeRO weight-update sharding across the ranks. --zero (or --zero 1): "
                        "optimizer state 1/N (reduce_scatter + sharded update + all_gather). "
                        "--zero 2: bucketed reduce-scatter straight into the 1/N flat grad shard. "
                        "--zero 3: params stay sharded between steps too (1/N stored), gathered "
                        "per bucket at the step's top. Levels 2/3 compose with --bucket-mb and "
                        "--overlap")
    p.add_argument("--moment-dtype", choices=["f32", "bf16", "int8"], default=None,
                   help="optimizer-moment storage under --zero: bf16 or blockwise int8 with "
                        "stochastic rounding (error-compensated, ops/quant.py) halve/quarter the "
                        "moment bytes; f32 = unchanged")
    p.add_argument("--fsdp", action="store_true",
                   help="fully-sharded data parallelism (parallel.fsdp): parameters, gradients "
                        "and optimizer state 1/N per rank, each layer's weights gathered inside "
                        "the step (LMs; composes with --tp only)")
    p.add_argument("--fsdp-gather", choices=["f32", "bf16"], default="f32",
                   help="dtype of the FSDP weight gathers: bf16 halves the gathered bytes and "
                        "the gathered weights' memory (f32 master shards either way)")
    p.add_argument("--overlap", action="store_true",
                   help="overlap the gradient reduction with backward: ~1 MiB buckets (or "
                        "--bucket-mb) launched from autograd hooks as their gradients become "
                        "ready (DDP's reducer); under --zero 2/3 the bucket reduce-scatters")
    p.add_argument("--grad-compress", choices=["bf16", "powersgd"], default=None,
                   help="comm-hook gradient compression (torch DDP ddp_comm_hooks analog). "
                        "bf16: gradients cross the wire in bfloat16, half the f32 bytes; "
                        "composes with --overlap/--bucket-mb/--accum-steps/--grad-clip. "
                        "powersgd: rank-r low-rank factors with per-replica error feedback "
                        "(lossy)")
    p.add_argument("--powersgd-rank", type=int, default=4,
                   help="PowerSGD approximation rank (with --grad-compress powersgd)")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="clip the synced gradient to this global L2 norm")
    p.add_argument("--cp", type=int, default=1,
                   help="context-parallel degree: shard the sequence over a 'seq' mesh axis "
                        "with collective attention (LM only)")
    p.add_argument("--cp-impl", choices=["ring", "ulysses"], default="ring",
                   help="sequence-parallel attention collective: 'ring' (the flash ring, "
                        "O(S/N) memory) or 'ulysses' (all_to_all to a head-sharded layout; "
                        "local flash attention over the full sequence, needs num_heads %% cp == 0)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: Megatron column/row sharding of attention "
                        "heads + MLP hidden over a 'model' mesh axis (LM only)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel degree: shard the layer stack into this many stages over a "
                        "'pipe' mesh axis (LM only; --layers divisible by it)")
    p.add_argument("--pp-microbatches", type=int, default=None,
                   help="pipeline microbatches per step (default: --pp); --batch-size divisible by it")
    p.add_argument("--pp-schedule", default="gpipe", choices=["gpipe", "1f1b", "zb"],
                   help="pipeline schedule: gpipe (all forwards, then all backwards), 1f1b (one "
                        "forward, one backward; at most --pp microbatches held) or zb (1f1b with each "
                        "backward split into the input gradient, sent upstream at once, and the weight "
                        "gradients after it; needs --pp-microbatches >= --pp)")
    p.add_argument("--pp-virtual", type=int, default=1,
                   help="virtual layer chunks per pipeline stage (interleaved 1f1b/zb): stage s runs "
                        "the round-robin chunks s, s+pp, ...; --layers divisible by --pp x this")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="replace every block's MLP with this many routed experts (LM only; "
                        "0 = dense MLP)")
    p.add_argument("--moe-top-k", type=int, default=1,
                   help="experts per token: 1 = Switch routing, 2 = Mixtral-style with "
                        "renormalized gates")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel degree: shard the experts over an 'expert' mesh axis "
                        "(requires --moe-experts)")
    p.add_argument("--moe-aux-weight", type=float, default=0.01,
                   help="weight of the switch load-balance auxiliary loss (0 disables)")
    p.add_argument("--moe-capacity-factor", type=float, default=0.0,
                   help="token-choice dispatch: each expert takes at most ceil(k*T/E*factor) "
                        "tokens, the overflow dropped through the residual; 0 = dense dispatch "
                        "(every token through every expert)")
    p.add_argument("--buffer-sync", choices=["mean", "broadcast"], default="mean",
                   help="BatchNorm buffers across ranks: 'mean' averages the running "
                        "stats, 'broadcast' adopts rank 0's (DDP broadcast_buffers)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true", help="run eval after each epoch")
    p.add_argument("--decode-quant", choices=["int8"], default=None,
                   help="serve --generate with int8-quantized matrices "
                        "(ops.quant): ~half the per-step weight bytes of "
                        "bf16, <1%% per-channel quantization error")
    p.add_argument("--generate", type=int, default=0,
                   help="after training, greedily generate N tokens from a "
                        "training prompt via the KV-cache decode path "
                        "(LM models)")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--checkpoint-dir", default=None, help="save a checkpoint after every epoch")
    p.add_argument("--resume", action="store_true",
                   help="continue at the epoch after the newest checkpoint")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --coordinator: the number of hosts.  Otherwise the processes "
                        "to start on this host, one per device, on a localhost rendezvous "
                        "(default --fake-devices or 1; 1 runs in this process)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host rendezvous (TCP store on global rank 0): every host "
                        "passes the same address and --num-processes, and its own "
                        "--process-id; each host runs one process per local device")
    p.add_argument("--process-id", type=int, default=None,
                   help="this host's index in [0, --num-processes) (with --coordinator)")
    p.add_argument("--fake-devices", type=int, default=0,
                   help="with --device cpu: CPU ranks on this host (the reference's N-device "
                        "CPU simulation): the local device count of a --coordinator host, "
                        "else the processes to start when --num-processes is not given")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="supervise the trainer and restart it up to N times on any crash "
                        "(preemption, watchdog exit, injected chaos), torchrun "
                        "--max-restarts style.  Requires --checkpoint-dir; each restart "
                        "resumes from the newest intact checkpoint")
    p.add_argument("--step-timeout", type=float, default=None,
                   help="wall-clock deadline in seconds per train step (armed after the "
                        "first step, which builds the kernels): a wedged step logs a "
                        "diagnostic, best-effort checkpoints the last completed state and "
                        "exits 75 instead of hanging; with --max-restarts the supervisor "
                        "then restarts")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="deterministic fault injection for testing the recovery paths "
                        "(utils.chaos; also via the DDP_CHAOS env var): comma-separated "
                        "ckpt-io@N[:K] | nan-grad@S | slow-step@S[:SEC] | preempt@S")
    p.add_argument("--nan-guard", action="store_true",
                   help="skip-step numerical guard: a step whose gradients contain NaN/Inf "
                        "applies NO update (params, optimizer state and BatchNorm buffers "
                        "keep their values) and is counted; --max-bad-steps consecutive bad "
                        "steps abort the run.  Reads one agreed flag on the host per step")
    p.add_argument("--max-bad-steps", type=int, default=5,
                   help="with --nan-guard: consecutive non-finite-gradient steps tolerated "
                        "before the run aborts as diverged")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first epoch here "
                        "(legacy whole-epoch capture; --profile-steps supersedes it "
                        "when both are given)")
    p.add_argument("--events-dir", default=None, metavar="DIR",
                   help="observability: write schema-versioned JSONL events (spans, "
                        "metrics snapshots, goodput, run summary) to DIR, one file per "
                        "rank, merged into DIR/timeline.jsonl at exit (env: DDP_EVENTS_DIR)")
    p.add_argument("--metrics-every", type=int, default=100,
                   help="export a metrics-registry snapshot every N steps into the "
                        "event log (host-only work).  0 disables periodic export; "
                        "end-of-run export always happens")
    p.add_argument("--mfu", action="store_true",
                   help="report MFU/HFU per throughput window from the analytic cost "
                        "model (observability.cost_model) over the card's peak for the "
                        "step's matmul dtype; cnn/mlp and the LM models")
    p.add_argument("--memory-telemetry", action="store_true",
                   help="sample the CUDA allocator's live and reserved bytes at "
                        "throughput-window boundaries (observability.memory)")
    p.add_argument("--alerts", nargs="?", const="", default=None, metavar="SPEC",
                   help="evaluate SLO alert rules at throughput-window boundaries and "
                        "emit `alert` events.  Bare --alerts enables every rule at "
                        "defaults; SPEC overrides thresholds, e.g. "
                        "--alerts mfu_floor=0.3,step_spike=2.5 (rules: step_spike, "
                        "mfu_floor, goodput_floor, restart_storm, sdc_storm, "
                        "loader_starved, mem_growth, gang_suspect)")
    p.add_argument("--runs-dir", default=None, metavar="DIR",
                   help="longitudinal run store: append this run's run_summary to "
                        "DIR/index.jsonl at run end (env: DDP_RUNS_DIR); gate later "
                        "runs with scripts/perf_gate.py")
    p.add_argument("--profile-steps", default=None, metavar="A:B",
                   help="capture a torch.profiler trace of global steps [A, B) into "
                        "--profile-dir if set, else EVENTS_DIR/xprof")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="kernel build cache rooted at DIR (env: DDP_COMPILE_CACHE): the hand-written "
                        "kernels are built into DIR/build/ once and loaded from there after, by this "
                        "process and by spawned and restarted ones (the reference also stored its "
                        "compiled train step there; an eager PyTorch step is no such program)")
    p.add_argument("--dispatch-depth", type=int, default=2,
                   help="bounded dispatch: keep up to K steps in flight; the host syncs only at "
                        "throughput-window, log-line, checkpoint and epoch boundaries (the nan guard "
                        "then observes each step's flag with a lag of at most K).  0 = a synchronous "
                        "per-step loop")
    p.add_argument("--elastic", action="store_true",
                   help="elastic gang runtime (runtime.elastic_gang): a member lost at a step boundary (chaos "
                        "worker-kill) is resized around in place, its ZeRO-1 state resharded over the old "
                        "gang, no checkpoint read; under --max-restarts a gang that died shrunk is "
                        "respawned at the surviving size without spending the restart budget.  DP and "
                        "--zero 1 only")
    p.add_argument("--min-procs", type=int, default=1,
                   help="with --elastic: smallest gang worth resizing to; fewer survivors fall back to "
                        "the restart path")
    p.add_argument("--elastic-dir", default=None, metavar="DIR",
                   help="rendezvous store root for --elastic (env: DDP_ELASTIC_DIR); defaults to "
                        "EVENTS_DIR/gang or CHECKPOINT_DIR/.gang")
    p.add_argument("--integrity-every", type=int, default=0, metavar="N",
                   help="silent-data-corruption defence (training.integrity): every N steps the train step "
                        "digests its input state's bit patterns per data rank and all-gathers the digests; a "
                        "mismatch skips that step's update, names the corrupt rank by majority vote (2-rank "
                        "gangs fall back to a replay tiebreak), and with --elastic evicts it in place: no "
                        "restart, no checkpoint read.  0 disables.  Plain DP and --zero 1 only")
    p.add_argument("--integrity-shadow", action="store_true",
                   help="with --integrity-every: on cadence, re-run the step on a copy of the same inputs and "
                        "compare the result digests: catches a transient compute fault even at world 1 (two "
                        "runs of one deterministic step must agree bitwise).  Detections are reported "
                        "(sdc_detect, rank=-1); nothing is evicted")
    p.add_argument("--bw-probe", action="store_true",
                   help="measure grad all-reduce bandwidth utilization over the data axis before training "
                        "(bus GB/s against the card's link peak; the summary's bw_probe)")
    p.add_argument("--lint-step", action="store_true",
                   help="graph-lint the train step (analysis.graph_lint) on the first batch and abort on "
                        "violations: the collectives the run's first step issues are recorded as it runs and "
                        "held to the step factory's manifest and schedule")
    p.add_argument("--autotune", choices=["search", "apply", "off"], default="off",
                   help="attribution-driven autotuning (tuning/): 'search' runs a cost-model-pruned, "
                        "measured search before training and applies + persists the winner; 'apply' loads a "
                        "previously-persisted TunedConfig for this toolchain/devices/model fingerprint "
                        "(falling back LOUDLY to the CLI values on any mismatch) and starts training with "
                        "zero search trials")
    p.add_argument("--tune-dir", default=None, metavar="DIR",
                   help="TunedConfig store directory (default: <--compile-cache>/tuned when a compile "
                        "cache is set, else .ddp_tune)")
    p.add_argument("--tune-trials", type=int, default=3,
                   help="--autotune search: candidates measured after analytic pruning (top-K by "
                        "predicted throughput; the CLI baseline is always measured too)")
    p.add_argument("--tune-steps", type=int, default=4,
                   help="--autotune search: measured steps per candidate (after one step accounted apart)")
    args = p.parse_args(argv)
    if args.events_dir is None:
        args.events_dir = os.environ.get("DDP_EVENTS_DIR") or None
    if args.runs_dir is None:
        args.runs_dir = os.environ.get("DDP_RUNS_DIR") or None
    if args.compile_cache is None:
        args.compile_cache = os.environ.get(warm_start.ENV) or None
    if args.alerts is None and os.environ.get("DDP_ALERTS") is not None:
        args.alerts = os.environ.get("DDP_ALERTS")
    if args.elastic_dir is None:
        args.elastic_dir = os.environ.get("DDP_ELASTIC_DIR") or None
    if args.elastic and os.environ.get("DDP_ELASTIC_WORLD"):
        # A resize-respawn from the elastic supervisor: the gang comes back
        # at the surviving size, not the argv's (on the card: the first M).
        m = int(os.environ["DDP_ELASTIC_WORLD"])
        if args.num_processes:
            args.num_processes = m
        else:
            args.fake_devices = m if args.device == "cpu" else 0
            args.num_processes = None if args.device == "cpu" else m
    if args.alerts is not None:
        try:
            parse_alert_spec(args.alerts)
        except ValueError as e:
            raise SystemExit(f"--alerts: {e}") from None
    if args.mfu and args.model in ("resnet18", "resnet50"):
        raise SystemExit(
            "--mfu: no analytic cost model for resnet yet (supported: cnn, mlp, gpt2, "
            "llama) — a wrong FLOP count would report a confidently wrong MFU")
    if args.profile_steps is not None:
        try:
            parse_profile_steps(args.profile_steps)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    lm = is_lm(args)
    if args.dataset is None:
        args.dataset = "synthetic-lm" if lm else "synthetic"
    if lm != (args.dataset == "synthetic-lm" or args.dataset.startswith("tokens:")):
        p.error(f"--model {args.model} cannot train on --dataset {args.dataset}")
    if args.augment and lm:
        p.error("--augment is for image datasets only")
    if args.dropout:
        if not lm:
            p.error("--dropout applies to LM models (--model gpt2|llama)")
        if not 0.0 < args.dropout < 1.0:
            p.error("--dropout must be in (0, 1)")
    if args.remat != "auto" and not lm:
        p.error("--remat applies to LM models (--model gpt2|llama)")
    if args.resume and not args.checkpoint_dir:
        p.error("--resume needs --checkpoint-dir")
    # The reference's checks and messages (dpp.py:811-840).
    if args.decode_quant and not args.generate:
        raise SystemExit("--decode-quant only affects --generate; add --generate N")
    if args.generate and not lm:
        raise SystemExit("--generate requires an LM model")
    _validate_faults(p, args)
    _validate_reference_rules(args)
    _validate_layout(args)
    _refuse_unported(p, args)
    return args


#: The reference's flags whose feature this port does not run yet, by the
#: ROADMAP.md Queue 1 item that ports them: a value off the flag's default
#: raises ``NotImplementedError`` naming the item (after the reference's own
#: checks of the value, ``_validate_reference_rules``).
UNPORTED_FLAGS: dict[str, tuple[str, ...]] = {}


def _refuse_unported(p, args) -> None:
    for item, dests in UNPORTED_FLAGS.items():
        for dest in dests:
            if getattr(args, dest) != p.get_default(dest):
                raise NotImplementedError(f"--{dest.replace('_', '-')} is not ported yet: "
                                          f"ROADMAP.md Queue 1, item {item}")


def _bad(*pairs) -> list[str]:
    return [flag for flag, on in pairs if on]


def _validate_reference_rules(args) -> None:
    """The reference's checks of the flags whose feature is not ported yet
    (``dpp.py:454-458``, ``:562-585``, ``:654-680``, ``:716-786``), with
    its messages, so a bad value is refused as the reference refuses it
    before ``_refuse_unported`` names the item."""
    if args.dispatch_depth < 0:
        raise SystemExit(f"--dispatch-depth must be >= 0, got {args.dispatch_depth}")
    if args.pp > 1:
        if not is_lm(args):
            raise SystemExit("--pp requires an LM model (--model gpt2|llama)")
        if args.eval and args.cp > 1:
            raise SystemExit("--pp --eval does not support --cp")
        if args.accum_steps > 1:
            raise SystemExit("--pp's microbatch loop IS the accumulation; use --pp-microbatches "
                             "instead of --accum-steps")
        if args.bucket_mb:
            raise SystemExit("--pp does not support --bucket-mb")
        if args.layers and args.layers % (args.pp * args.pp_virtual):
            raise SystemExit(f"--layers {args.layers} must be divisible by --pp {args.pp}"
                             + (f" x --pp-virtual {args.pp_virtual}" if args.pp_virtual > 1 else ""))
        if args.pp_schedule == "zb":
            m = args.pp_microbatches or args.pp
            if m < args.pp:
                raise SystemExit(f"--pp-schedule zb needs --pp-microbatches >= --pp (got {m} < {args.pp}): "
                                 f"with fewer microbatches than stages the steady state never forms and "
                                 f"there is no W work to fill the bubble — use 1f1b")
            if args.cp > 1:
                raise SystemExit("--pp-schedule zb does not compose with --cp yet; use --pp-schedule "
                                 "1f1b for context-parallel pipelines")
            if args.moe_experts and args.moe_aux_weight:
                raise SystemExit("--pp-schedule zb does not support the MoE aux loss (the B/W split has "
                                 "no aux cotangent path); set --moe-aux-weight 0 or use --pp-schedule 1f1b")
        if args.pp_virtual > 1:
            if args.pp_schedule not in ("1f1b", "zb"):
                raise SystemExit("--pp-virtual requires --pp-schedule 1f1b or zb")
            if args.zero:
                raise SystemExit("--pp-virtual does not compose with --zero yet")
            if args.eval or args.generate:
                raise SystemExit("--pp-virtual does not support --eval/--generate")
    elif args.pp_virtual > 1:
        raise SystemExit("--pp-virtual requires --pp > 1")
    if args.min_procs < 1:
        raise SystemExit("--min-procs must be >= 1")
    if args.elastic:
        bad = _bad(("--fsdp", args.fsdp), ("--pp", args.pp > 1), ("--tp", args.tp > 1),
                   ("--ep", args.ep > 1), ("--cp", args.cp > 1))
        if bad:
            raise SystemExit(f"--elastic resizes over the data axis only; drop {', '.join(bad)}")
        if args.zero >= 2:
            raise SystemExit("--elastic supports plain DP and --zero 1; the ZeRO-2/3 resident weight "
                             "shards resize through supervised restart + elastic_restore instead")
        if args.moment_dtype:
            raise SystemExit("--elastic does not compose with --moment-dtype: the in-memory reshard "
                             "has no dequant/requant path for low-bit moments")
        if args.grad_compress:
            raise SystemExit("--elastic does not compose with --grad-compress: the hook state layout "
                             "is replica-count-dependent")
        if not (args.elastic_dir or args.events_dir or args.checkpoint_dir):
            raise SystemExit("--elastic needs a rendezvous root: --elastic-dir, or "
                             "--events-dir/--checkpoint-dir to derive one")
        if args.coordinator:
            raise NotImplementedError("--elastic across hosts (--coordinator) is hostgang's: ROADMAP.md "
                                      "Queue 1, item 20b")
    if args.integrity_every:
        if args.integrity_every < 0:
            raise SystemExit("--integrity-every must be >= 0")
        bad = _bad(("--fsdp", args.fsdp), ("--pp", args.pp > 1), ("--tp", args.tp > 1),
                   ("--ep", args.ep > 1), ("--cp", args.cp > 1))
        if bad:
            raise SystemExit(f"--integrity-every compares replicated data-axis state; drop {', '.join(bad)}")
        if args.zero >= 2:
            raise SystemExit("--integrity-every supports plain DP and --zero 1; ZeRO-2/3 shard the "
                             "comparable state away")
    elif args.integrity_shadow:
        raise SystemExit("--integrity-shadow needs a cadence: set --integrity-every N")
    if args.autotune != "off":
        bad = _bad(("--fsdp", args.fsdp), ("--pp", args.pp > 1), ("--tp", args.tp > 1),
                   ("--ep", args.ep > 1), ("--cp", args.cp > 1), ("--elastic", args.elastic))
        if bad:
            raise SystemExit(f"--autotune searches the DP/ZeRO space only; drop {', '.join(bad)}")
        if args.model not in ("mlp", "cnn", "gpt2"):
            raise SystemExit("--autotune supports --model mlp|cnn|gpt2 (the tuning harness "
                             f"registry); got {args.model!r}")
        if args.tune_trials < 1:
            raise SystemExit("--tune-trials must be >= 1")
        if args.tune_steps < 1:
            raise SystemExit("--tune-steps must be >= 1")


def _validate_layout(args) -> None:
    """The reference's rules for the model axes, FSDP, the sharded update,
    the comm hooks and MoE / EP (``dpp.py:554-560``, ``:620-651``,
    ``:709-713``, ``:757-868``), with its messages."""
    if args.cp < 1 or args.tp < 1:
        raise SystemExit("--cp and --tp must be >= 1")
    if args.cp > 1:
        if not is_lm(args):
            raise SystemExit("--cp requires an LM model (--model gpt2|llama)")
        if args.seq_len % args.cp:
            raise SystemExit("--seq-len must be divisible by --cp")
    if args.tp > 1 and not is_lm(args):
        raise SystemExit("--tp requires an LM model (--model gpt2|llama)")
    if args.fsdp:
        if not is_lm(args):
            raise SystemExit("--fsdp requires an LM model (--model gpt2|llama)")
        bad = _bad(("--zero", args.zero), ("--pp", args.pp > 1), ("--cp", args.cp > 1),
                   ("--ep", args.ep > 1), ("--moe-experts", bool(args.moe_experts)),
                   ("--bucket-mb", bool(args.bucket_mb)))
        if bad:
            raise SystemExit(f"--fsdp composes with --tp only; drop {', '.join(bad)}")
    if args.fsdp or args.pp > 1:
        if args.dropout:
            raise SystemExit("--dropout trains under DP/ZeRO/TP/EP/CP (scan + remat included); "
                             "--fsdp and --pp do not support it")
        if args.nan_guard:
            raise SystemExit("--nan-guard supports the DP/ZeRO/TP/EP/CP step; drop --fsdp/--pp")
    if args.zero >= 2:
        bad = _bad(("--tp", args.tp > 1), ("--ep", args.ep > 1), ("--pp", args.pp > 1))
        if bad:
            raise SystemExit(f"--zero {args.zero} shards over the data axis only; drop {', '.join(bad)} "
                             f"or use --zero 1")
    if args.moment_dtype and not args.zero:
        raise SystemExit("--moment-dtype rides the ZeRO sharded update; add --zero")
    if args.overlap:
        bad = _bad(("--zero", args.zero == 1), ("--fsdp", args.fsdp), ("--pp", args.pp > 1))
        if bad:
            raise SystemExit(f"--overlap applies to the DP all-reduce; drop {', '.join(bad)}")
    if args.grad_compress and (args.zero or args.fsdp or args.pp > 1):
        raise SystemExit("--grad-compress applies to the DP all-reduce; drop --zero/--fsdp/--pp")
    if args.grad_compress == "powersgd":
        if args.tp > 1 or args.ep > 1:
            raise SystemExit("--grad-compress powersgd supports DP/CP layouts; drop --tp/--ep")
        if args.overlap:
            raise SystemExit("--grad-compress powersgd replaces the bucketed all-reduce --overlap "
                             "schedules; pick one mechanism")
        if args.powersgd_rank < 1:
            raise SystemExit("--powersgd-rank must be >= 1")
    if args.generate and ((args.tp > 1 and not args.fsdp) or args.pp > 1 or args.ep > 1):
        raise SystemExit("--generate needs replicated params (no --tp/--pp/--ep; --fsdp [--tp N] "
                         "generates via the host gather)")
    if args.moe_experts and not is_lm(args):
        raise SystemExit("--moe-experts requires an LM model")
    if args.moe_experts and not 1 <= args.moe_top_k <= args.moe_experts:
        raise SystemExit(f"--moe-top-k {args.moe_top_k} must be in [1, {args.moe_experts}]")
    if args.moe_top_k != 1 and not args.moe_experts:
        raise SystemExit("--moe-top-k requires --moe-experts")
    if args.moe_capacity_factor and not args.moe_experts:
        raise SystemExit("--moe-capacity-factor requires --moe-experts")
    if args.moe_capacity_factor < 0:
        raise SystemExit("--moe-capacity-factor must be >= 0")
    if args.ep > 1:
        if not args.moe_experts:
            raise SystemExit("--ep requires --moe-experts")
        if args.moe_experts % args.ep:
            raise SystemExit(f"--moe-experts {args.moe_experts} must be divisible by --ep {args.ep}")
        if args.pp > 1 and args.tp > 1:
            raise SystemExit("--ep with BOTH --pp and --tp is untested")
        if args.cp > 1 and (args.pp > 1 or args.tp > 1):
            raise SystemExit("--ep with --cp composes pairwise only (no extra --pp/--tp)")


def _validate_faults(p, args) -> None:
    """The fault-tolerance and multi-host flags, as the reference checks
    them (``dpp.py:654-716``); chaos entries this port cannot inject yet are
    refused with their ROADMAP item."""
    if args.fake_devices < 0:
        p.error("--fake-devices must be >= 0")
    if args.fake_devices and args.device != "cpu":
        p.error("--fake-devices requires --device cpu")
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            p.error("--coordinator needs --num-processes (hosts) and --process-id")
        if not 0 <= args.process_id < args.num_processes:
            p.error(f"--process-id must be in [0, {args.num_processes})")
    elif args.process_id is not None:
        p.error("--process-id needs --coordinator")
    if args.max_restarts < 0:
        p.error("--max-restarts must be >= 0")
    if args.max_restarts and not args.checkpoint_dir:
        # A restart without a checkpoint replays the run from zero: a retry
        # loop, not fault tolerance.
        p.error("--max-restarts requires --checkpoint-dir (restarts resume from the last checkpoint)")
    if args.step_timeout is not None and args.step_timeout <= 0:
        p.error("--step-timeout must be > 0 seconds")
    if args.nan_guard and args.max_bad_steps < 1:
        p.error("--max-bad-steps must be >= 1")
    for name, spec in (("--chaos", args.chaos), ("DDP_CHAOS", os.environ.get("DDP_CHAOS"))):
        if spec:
            try:
                check_ported(parse_chaos_spec(spec))
            except (ValueError, NotImplementedError) as e:
                raise SystemExit(f"{name}: {e}") from None


def is_lm(args) -> bool:
    return args.model in LM_MODELS


def build_config(args, vocab_size: int | None = None) -> tfm.TransformerConfig:
    """The LM config for these flags (``vocab_size``: a token file's
    sidecar, which overrides ``--vocab-size``), as the reference's
    ``build_model`` makes it (``dpp.py:918-973``, plain DP)."""
    family = tfm.gpt2_124m if args.model == "gpt2" else tfm.llama3_8b
    overrides = dict(vocab_size=vocab_size or args.vocab_size, max_seq_len=args.seq_len)
    if args.cp > 1:
        overrides.update(cp_axis=rt.SEQ_AXIS, cp_impl=args.cp_impl)
    if args.fsdp or args.pp > 1:
        overrides["scan_layers"] = True  # FSDP's flats, the stages' slices (dpp.py:930-932)
    if args.tp > 1:
        overrides["tp_axis"] = rt.MODEL_AXIS
    if args.dropout:
        overrides["dropout_rate"] = args.dropout
    if args.moe_experts:
        overrides.update(moe_experts=args.moe_experts, moe_top_k=args.moe_top_k,
                         moe_capacity_factor=args.moe_capacity_factor)
    if args.ep > 1:
        overrides["ep_axis"] = rt.EXPERT_AXIS
    if args.layers:
        overrides["num_layers"] = args.layers
    if args.remat != "auto":
        overrides["remat"] = args.remat == "on"
    if args.d_model:
        # Scale heads with width (head_dim 16) instead of keeping the
        # family's head count — the reference's rule (dpp.py:946-955).
        if args.d_model % 16:
            raise SystemExit("--d-model must be a multiple of 16")
        heads = max(1, args.d_model // 16)
        overrides.update(d_model=args.d_model, d_ff=4 * args.d_model, num_heads=heads)
        if args.model == "llama":
            # The largest kv-head count <= heads / 4 (or --tp) that divides
            # heads and that --tp divides (dpp.py:956-973).
            kv = max((d for d in range(1, max(heads // 4, args.tp) + 1)
                      if heads % d == 0 and d % args.tp == 0), default=None)
            if kv is None:
                raise SystemExit(f"no GQA kv-head count divides heads={heads} and is divisible by "
                                 f"--tp {args.tp}; pick a larger --d-model")
            overrides["num_kv_heads"] = kv
    return family(**overrides)


def _token_path(args, train: bool) -> str:
    """tokens:FILE's path; eval reads the sibling val split: DIR/val.npy
    beside DIR/train.npy, else STEM.val.npy beside STEM.npy."""
    path = args.dataset.split(":", 1)[1]
    if train:
        return path
    if os.path.basename(path) in ("train.npy", "train"):
        val = os.path.join(os.path.dirname(path), "val.npy")
    else:
        val = (path[:-4] if path.endswith(".npy") else path) + ".val.npy"
    if not os.path.exists(val):
        raise SystemExit(f"--eval with --dataset tokens: needs a val split at {val}")
    return val


def build_dataset(args, train: bool = True):
    """The training (or eval) split for these flags, as the reference's
    ``build_dataset`` builds it."""
    seed = args.seed if train else args.seed + 1
    if args.dataset.startswith("tokens:"):
        return TokenFileDataset(_token_path(args, train), seq_len=args.seq_len,
                                stride=args.token_stride if train else None)
    if is_lm(args):
        return SyntheticLM(num_examples=args.num_examples, seq_len=args.seq_len,
                           vocab_size=args.vocab_size, seed=seed)
    if args.dataset == "synthetic":
        return SyntheticClassification(num_examples=args.num_examples, seed=seed)
    if args.dataset.startswith("shards:"):
        root = args.dataset.split(":", 1)[1]
        split = os.path.join(root, "train" if train else "val")
        if os.path.isdir(split):
            root = split
        elif not train:
            raise SystemExit(f"--eval with --dataset shards: needs {split} "
                             "(no val split in the shard directory)")
        ds = ShardedImageDataset(root, device_normalize=True)
        if ds.num_classes is None:
            raise SystemExit("shard manifest lacks num_classes: rewrite the shards with "
                             "write_image_shards(..., num_classes=...)")
        return ds
    return load_cifar10(args.data_root, train=train, keep_u8=True)


def build_model(args, dataset, device, generator):
    """The image model for ``--model``, sized by the dataset."""
    num_classes = getattr(dataset, "num_classes", None) or 10
    shape = getattr(dataset, "image_shape", None) or dataset.images.shape[1:]
    kw = dict(device=device, generator=generator)
    if args.model == "mlp":
        return TinyMLP(tuple(shape), num_classes=num_classes, **kw)
    if args.model == "cnn":
        return SimpleCNN(num_classes=num_classes, in_channels=shape[-1], **kw)
    if args.model == "resnet18":
        return ResNet18(num_classes=num_classes, stem="cifar", in_channels=shape[-1], **kw)
    return ResNet50(num_classes=num_classes, in_channels=shape[-1], **kw)


def _images(batch):
    """Float images: uint8 batches (``device_normalize`` datasets) are
    normalized here, on the device."""
    x = batch["image"]
    return normalize_u8_images(x) if x.dtype == torch.uint8 else x


def _image_loss_fn(model, batch):
    logits = model(_images(batch))
    return cross_entropy_loss(logits, batch["label"]), {"accuracy": accuracy(logits, batch["label"])}


def _image_metric_fn(model, batch):
    logits = model(_images(batch))
    return {
        "loss": per_example_cross_entropy(logits, batch["label"]),
        "accuracy": per_example_accuracy(logits, batch["label"]),
    }


def _lm_pairs(batch):
    """(inputs, targets): the loader's split under --cp (a sequence
    chunk's), else the tokens shifted by one."""
    if "inputs" in batch:
        return batch["inputs"], batch["targets"]
    tokens = batch["tokens"]
    return tokens[:, :-1], tokens[:, 1:]


def _loss_fn(model, batch, seed=None, aux_weight: float = 0.0):
    """The LM loss; with ``aux_weight`` > 0 (an MoE model, ``--moe-aux-weight``)
    plus that times the load-balance term, reported as ``moe_aux`` (ref
    ``dpp.py:1549-1568``)."""
    inputs, targets = _lm_pairs(batch)
    if aux_weight > 0:
        logits, aux = model(inputs, dropout_seed=seed, with_aux=True)
        loss = lm_cross_entropy(logits, targets) + aux_weight * aux
        return loss, {"accuracy": accuracy(logits, targets), "moe_aux": aux}
    logits = model(inputs, dropout_seed=seed)
    return lm_cross_entropy(logits, targets), {"accuracy": accuracy(logits, targets)}


def lm_loss_fn(args):
    """The LM loss_fn for these flags."""
    weight = args.moe_aux_weight if args.moe_experts else 0.0
    return functools.partial(_loss_fn, aux_weight=weight) if weight > 0 else _loss_fn


def _metric_fn(model, batch):
    inputs, targets = _lm_pairs(batch)
    logits = model(inputs)
    return {
        "loss": per_example_cross_entropy(logits, targets),
        "accuracy": per_example_accuracy(logits, targets),
    }


def step_seed(args, epoch: int, step: int) -> int | None:
    """The train step's dropout seed: a function of (seed + 1, epoch, step
    of the epoch), as the reference folds its step rng (``dpp.py:2367-2396``),
    so a resumed run continues the uninterrupted run's masks; None without
    dropout."""
    return fold_seed(args.seed + 1, epoch, step) if args.dropout else None


def _process_started() -> float | None:
    """This process's start on the wall clock (Linux ``/proc``), or None."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_for(args, rank: int = 0) -> torch.device:
    """This rank's device; on CUDA also turns TF32 off, so f32 matmuls run
    in full f32 as the reference's f32 configs compute."""
    if args.device != "cuda":
        return torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", rank)


def run(args, *, local_rank: int = 0, nprocs: int = 1, store_address: str | None = None,
        result_file: str | None = None) -> dict:
    """Train (and evaluate) as local rank ``local_rank`` of ``nprocs`` on
    this host, on its device; returns the run summary, which global rank 0
    also writes to ``result_file`` as JSON.  A chaos preemption exits 1
    without a parting checkpoint, as a real one that sends no SIGTERM
    (ref ``dpp.py:2966-2980``)."""
    entered = time.time()
    device = device_for(args, local_rank)
    if args.compile_cache:
        warm_start.enable_compile_cache(args.compile_cache)
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the CUDA context, made here and timed
    context_s = time.perf_counter() - t0
    member = os.environ.get("DDP_ELASTIC_JOIN")
    join = None
    if member:  # a grow's joiner: enters the gang's re-formed group with its live state
        join = join_gang(args, device, member, store_address)
        rank, world_size = join.gang.rank, join.gang.world
    else:
        rank, world_size = rt.init_process_group(
            store_address=store_address, world_size=nprocs, rank=local_rank, device=device,
            coordinator_address=args.coordinator, num_processes=args.num_processes,
            process_id=args.process_id)
    try:
        # Autotune BEFORE anything batch-shaped exists: apply replays a
        # persisted winner (zero trials), search measures on the live gang
        # and persists one.  Either way the tuned knobs land on ``args`` and
        # the trainer below is built from them.
        tuned = (_run_autotune(args, device, rank, world_size)
                 if args.autotune != "off" and join is None else None)
        trainer = join.trainer if join is not None else build_trainer(args, device, rank, world_size)
        trainer.tune = tuned
        summary = train(args, trainer, device, rank, world_size, join=join)
        # Where a (re)start's time went, up to the first step (the restart
        # path's split): the process's start and this function's entry on
        # the wall clock, the CUDA context, the checkpoint read, the kernel
        # libraries' builds or loads, and the first step (``train``'s).
        if "startup" in summary:  # not on a member that left the gang
            summary["startup"].update(process_start_unix=_process_started(), run_entry_unix=entered,
                                      cuda_context_s=context_s)
    except SimulatedPreemption as pe:
        warn_all("%s", pe)
        raise SystemExit(1) from pe
    finally:
        rt.destroy_process_group()
    if summary.get("rank") == 0 and result_file:  # the rank after any elastic resize
        with open(result_file, "w") as fh:
            json.dump(summary, fh)
    return summary


@dataclasses.dataclass
class Trainer:
    state: TrainState
    step_fn: object
    loader: DataLoader
    steps_per_epoch: int
    eval_step: object = None
    eval_loader: DataLoader | None = None
    # --autotune's outcome (``_run_autotune``): its summary, and its events
    # for the run's event log, which ``train`` opens.
    tune: dict | None = None
    # The fingerprint of the collectives of the run's first step, and under
    # --lint-step its lint (the summary's ``lint_step``).
    collective_fp: str | None = None
    lint_report: dict | None = None


def build_mesh(args, world_size: int):
    """The reference's mesh for ``--cp`` / ``--pp`` / ``--ep`` / ``--tp``
    (``dpp.py:511-533``): data outermost, then ``seq``, ``pipe``,
    ``expert``, ``model``; None for plain DP."""
    axes, sizes = [rt.DATA_AXIS], []
    for degree, name in ((args.cp, rt.SEQ_AXIS), (args.pp, rt.PIPE_AXIS), (args.ep, rt.EXPERT_AXIS),
                         (args.tp, rt.MODEL_AXIS)):
        if degree > 1:
            axes.append(name)
            sizes.append(degree)
    if not sizes:
        rt.clear_mesh()
        return None
    if world_size % math.prod(sizes):
        raise SystemExit(
            f"requested parallelism ({' x '.join(f'{a}={d}' for a, d in zip(axes[1:], sizes))}) "
            f"does not divide {world_size} devices")
    return rt.make_mesh(tuple(axes), (world_size // math.prod(sizes), *sizes))


def data_coords(mesh, rank: int, world_size: int) -> tuple[int, int]:
    """(this rank's data-parallel replica, the replicas): the ``data``
    axis's index and size on a mesh, the rank and world otherwise."""
    if mesh is None:
        return rank, world_size
    return mesh.index(rt.DATA_AXIS), mesh.size(rt.DATA_AXIS)


def build_trainer(args, device: torch.device, rank: int = 0, world_size: int = 1) -> Trainer:
    """Model (rank 0's weights on every rank), optimizer, step functions and
    loaders for these flags; the process group, if any, is formed.
    ``train`` restores the newest checkpoint with ``--resume``.  Under
    ``--cp`` / ``--ep`` / ``--tp`` the mesh is formed here; every rank builds
    the full model from the seed and keeps its TP and EP shard of it (under
    ``--fsdp`` its chunk of the flats, of its TP shard with ``--tp``; under
    ``--pp`` its stage's layers and the replicated leaves)."""
    lm = is_lm(args)
    pp = args.pp > 1
    mesh = build_mesh(args, world_size)
    d_index, n_data = data_coords(mesh, rank, world_size)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    dataset = build_dataset(args, train=True)
    if lm:
        cfg = build_config(args, getattr(dataset, "vocab_size", None))
        if pp:
            # The reference's checks of the step factory's inputs (dpp.py:1610-1621).
            if args.batch_size % (args.pp_microbatches or args.pp):
                raise SystemExit(f"--batch-size {args.batch_size} must be divisible by "
                                 f"--pp-microbatches {args.pp_microbatches or args.pp}")
            if cfg.num_layers % (args.pp * args.pp_virtual):
                raise SystemExit(f"model layer count {cfg.num_layers} must be divisible by --pp {args.pp}"
                                 + (f" x --pp-virtual {args.pp_virtual}" if args.pp_virtual > 1 else ""))
        model = tfm.TransformerLM(dataclasses.replace(cfg, tp_axis=None, ep_axis=None), device=device,
                                  generator=gen)
    else:
        model = build_model(args, dataset, device, gen)
    if args.pretrained:
        model.load_state_dict(load_pretrained(args.pretrained, model))
        if rank == 0:
            print(f"loaded pretrained weights from {args.pretrained}", flush=True)
    broadcast_params(model)  # DDP constructor broadcast
    if lm and (cfg.tp_axis or cfg.ep_axis or pp) and not args.fsdp:  # FSDP cuts its TP shards from the whole model
        full = shard_model_axes(model.state_dict(), cfg.tp_axis, cfg.ep_axis)
        del model
        if pp:  # this stage's layers and the replicated leaves
            model = pipeline_parallel.stage_model(cfg, full, mesh.index(rt.PIPE_AXIS), args.pp,
                                                  virtual=args.pp_virtual, device=device)
        else:
            model = tfm.TransformerLM(cfg, device=device)
            model.load_state_dict(full)
        del full
    seq_shard = (mesh.index(rt.SEQ_AXIS), mesh.size(rt.SEQ_AXIS)) if args.cp > 1 else None

    loader = DataLoader(dataset, per_replica_batch=args.batch_size, rank=d_index,
                        num_replicas=n_data, device=device, shuffle=True,
                        seed=args.seed, drop_last=True, workers=args.workers > 0,
                        augment=CifarAugment() if args.augment else None, seq_shard=seq_shard)
    spe = len(loader) if not args.steps_per_epoch else min(len(loader), args.steps_per_epoch)
    if spe == 0:
        raise SystemExit(
            f"no training steps: dataset gives {len(loader)} batches per replica "
            f"(dataset too small for --batch-size {args.batch_size} x {n_data} replicas)"
        )
    bucket_bytes = int(args.bucket_mb * 1024 * 1024) if args.bucket_mb else None
    total_steps = max(spe * args.epochs, 1)
    data_group = rt.axis_group(rt.DATA_AXIS) if mesh is not None else None
    if args.fsdp:
        # This rank's chunk of every layer flat (of its TP shard) and of
        # the rest; the whole model is dropped.
        params = model.state_dict()
        del model
        state = fsdp.fsdp_state(cfg, params, lambda shards: build_optimizer(args, shards, total_steps),
                                group=data_group, tp_axis=cfg.tp_axis,
                                gather_dtype=torch.bfloat16 if args.fsdp_gather == "bf16" else None)
        del params
    elif args.zero:
        # The optimizer steps this rank's shard of the flat layout.
        state = zero_state(model, lambda shard: build_optimizer(args, shard, total_steps),
                           level=args.zero, moment_dtype=args.moment_dtype, seed=args.seed,
                           bucket_bytes=bucket_bytes if args.zero >= 2 else None,
                           group=data_group, tp_axis=cfg.tp_axis if lm else None,
                           ep_axis=cfg.ep_axis if lm else None, pp_axis=rt.PIPE_AXIS if pp else None)
    else:
        state = TrainState(model, *build_optimizer(args, model.parameters(), total_steps))
        if args.grad_compress == "powersgd":
            state.comm_state = powersgd_state(leaf_shapes(jax_leaf_pieces(model)), args.powersgd_rank,
                                              seed=args.seed, device=device)
    if args.fsdp:
        step_fn = fsdp.make_fsdp_train_step(_loss_fn, accum_steps=args.accum_steps, grad_clip=args.grad_clip,
                                            tp_axis=cfg.tp_axis)
    elif pp:
        # The microbatch loop is the accumulation (dpp.py:1606-1629).
        step_fn = pipeline_parallel.make_pp_train_step(
            cfg, microbatches=args.pp_microbatches or args.pp, schedule=args.pp_schedule, zero=args.zero,
            grad_clip=args.grad_clip, moe_aux_weight=args.moe_aux_weight if args.moe_experts else 0.0,
            virtual=args.pp_virtual)
    else:
        step_fn = make_train_step(
            lm_loss_fn(args) if lm else _image_loss_fn, accum_steps=args.accum_steps,
            bucket_bytes=bucket_bytes, grad_clip=args.grad_clip, buffer_sync=args.buffer_sync,
            nonfinite_guard=args.nan_guard, overlap=args.overlap, zero=args.zero,
            grad_compress=args.grad_compress, cp_axis=cfg.cp_axis if lm else None,
            tp_axis=cfg.tp_axis if lm else None, ep_axis=cfg.ep_axis if lm else None,
            integrity_every=args.integrity_every or None,
        )
    trainer = Trainer(state=state, step_fn=step_fn, loader=loader, steps_per_epoch=spe)
    if args.eval:
        metric_fn = _metric_fn if lm else _image_metric_fn
        if args.fsdp:  # streams the per-layer gathers
            trainer.eval_step = fsdp.make_fsdp_eval_step()
        elif pp:  # GPipe forwards, masked over the padded tail (dpp.py:2000-2015)
            trainer.eval_step = pipeline_parallel.make_pp_eval_step(cfg, microbatches=args.pp_microbatches or args.pp)
        else:
            trainer.eval_step = make_eval_step(metric_fn, seq_axis=cfg.cp_axis if lm else None)
        trainer.eval_loader = DataLoader(
            build_dataset(args, train=False),
            per_replica_batch=args.batch_size, rank=d_index, num_replicas=n_data,
            device=device, shuffle=False, seed=args.seed, drop_last=False, with_mask=True,
            seq_shard=seq_shard,
        )
    return trainer


def build_telemetry(args, trainer: Trainer, device: torch.device, rank: int,
                    world_size: int, proc: int | None = None) -> Telemetry:
    """The telemetry these flags ask for (``training.telemetry``), with the
    analytic FLOP count of a step for ``--mfu`` (the reference's cost model,
    ``dpp.py:2126-2186``).  ``proc``: the event file's writer when it is
    not the rank (a grow's joiner writes as its member)."""
    rows = args.batch_size * data_coords(rt.current_mesh(), rank, world_size)[1]
    lm = is_lm(args)
    tel = Telemetry(args, rank=rank, world_size=world_size, proc=proc,
                    items_per_step=rows * args.seq_len if lm else rows,
                    unit="tok" if lm else "img", sync=lambda: _sync(device), layout=layout_name(args))
    if args.mfu:
        model, dataset = trainer.state.model, trainer.loader.dataset
        remat = False
        if lm:
            # The LM step trains on the shifted sequence: seq_len - 1
            # positions, as the reference counts them.
            cfg = getattr(model, "full_cfg", model.cfg)  # a pipeline stage's: the whole model's
            fwd = transformer_fwd_flops(cfg, batch=rows, seq_len=args.seq_len - 1)
            remat = bool(cfg.remat)
        else:
            shape = tuple(getattr(dataset, "image_shape", None) or dataset.images.shape[1:])
            classes = getattr(dataset, "num_classes", None) or 10
            if args.model == "cnn":
                fwd = simple_cnn_fwd_flops(batch=rows, image_shape=shape, num_classes=classes)
            else:  # mlp (resnet is refused in parse_args)
                fwd = mlp_fwd_flops(batch=rows, in_features=math.prod(shape), num_classes=classes)
        tel.arm_mfu(train_step_flops(fwd, remat=remat), device=device,
                    dtype=model.cfg.dtype if lm else torch.float32, n_chips=world_size)
    if args.memory_telemetry:
        tel.arm_memory(device)
    tel.bind_loader(trainer.loader)
    return tel


#: Multi-rank preemption agreement cadence: the flag's all-reduce is a
#: collective and a host sync, so it runs every k batches, not every batch
#: (a bounded k-step response to the signal at 1/k the cost).
PREEMPT_CHECK_EVERY = 8


@dataclasses.dataclass
class Faults:
    """The loop's fault-tolerance wiring (ref ``dpp.py:1770-1809``,
    ``:1886-1980``, ``:2271-2309``): the injector, the guard's breaker, the
    checkpointer, the step watchdog and the SIGTERM flag."""
    injector: FaultInjector
    breaker: NonFiniteBreaker | None = None
    checkpointer: ResilientCheckpointer | None = None
    watchdog: StepWatchdog | None = None
    signal: int | None = None  # set by the SIGTERM handler
    gang: "Gang | None" = None


@dataclasses.dataclass
class Gang:
    """This process's membership of the elastic gang (``--elastic``, ref
    ``dpp.py:1815-1850``): the coordinator, this process's member name
    (``proc{rank}`` at start), the members in rank order, and this
    process's rank and world size now (each resize renumbers the
    survivors in that order); ``left`` once a resize took it out."""
    coordinator: object
    member: str
    order: list
    rank: int
    world: int
    left: bool = False
    resizes: list = dataclasses.field(default_factory=list)  # (old world, new world, seconds) of each
    spe: int = 0  # the run's steps an epoch, which number its global steps at every size


def gang_coordinator(args, member: str, events=None):
    """This process's coordinator of the elastic gang, as ``member``."""
    from distributeddataparallel_tpu_torch.runtime.elastic_gang import ElasticGangCoordinator

    hb, sus = os.environ.get("DDP_HEARTBEAT_TIMEOUT"), os.environ.get("DDP_SUSPECT_AFTER")
    return ElasticGangCoordinator(elastic_store_dir(args), world=[member], min_size=args.min_procs, events=events,
                                  heartbeat_timeout_s=float(hb) if hb else None,
                                  suspect_after_s=float(sus) if sus else None)


def build_gang(args, injector: FaultInjector, events, rank: int, world_size: int) -> Gang:
    """Join the elastic gang as ``proc{rank}`` and agree its first epoch;
    the chaos worker-kill tombstones members through it, and every fired
    chaos entry leaves a breadcrumb in the store for the supervisor's
    verdict."""
    member = f"proc{rank}"
    coordinator = gang_coordinator(args, member, events)
    coordinator.store.join(member)
    rt.barrier()  # every member has joined before the first epoch is proposed over the live set
    coordinator.start()
    gang = Gang(coordinator, member, [f"proc{r}" for r in range(world_size)], rank, world_size)
    wire_gang(args, injector, gang)
    return gang


def wire_gang(args, injector: FaultInjector, gang: Gang) -> None:
    """The chaos kinds that act on the gang act through its coordinator;
    chaos rank R is member ``proc{R}``."""
    from distributeddataparallel_tpu_torch.runtime.elastic_gang import member_index

    injector.gang = gang.coordinator
    injector.hosts = {str(r): f"proc{r}" for r in range(max(member_index(m) for m in gang.order) + 1)}
    if injector.fault_log is None:
        injector.fault_log = os.path.join(elastic_store_dir(args), "faults.jsonl")


@dataclasses.dataclass
class Join:
    """A grow's joiner once it is in the gang (``join_gang``): its
    membership, its trainer holding the live state, and where in the run it
    starts (``epoch``, batch ``consumed`` of ``tail``)."""
    gang: Gang
    trainer: Trainer
    epoch: int
    consumed: int
    tail: DataLoader


def join_gang(args, device: torch.device, member: str, store_address: str | None) -> Join:
    """The start-up of a process the launcher's join rung started for
    ``member`` (``DDP_ELASTIC_JOIN``): it joins the elastic store and the
    transition the waiting survivors run, enters their re-formed process
    group as rank ``roster.index(member)`` (``rt.enter_process_group``),
    builds the trainer at the grown world (whose seeded init is then
    overwritten), and receives from the first survivor the live
    parameters, optimizer state, schedule, step and the loader's position
    (``runtime.elastic_gang.recv_live_state``).  No checkpoint is read.
    Its seconds (process start, group, state transfer) go into the store's
    ``join-<member>`` blob (the transfer's: the trainer's build, with the
    grown group's first collective, and the receipt)."""
    from distributeddataparallel_tpu_torch.runtime.elastic_gang import recv_live_state
    from distributeddataparallel_tpu_torch.training.optim import load_optimizer_state

    t_store = time.time()
    coordinator = gang_coordinator(args, member)
    coordinator.start()  # in the store: the waiting survivors see it alive
    decision = coordinator.poll()
    if decision is None or member not in decision.joined:
        raise RuntimeError(f"elastic join: {member} was not taken into the gang ({decision})")
    order = _roster_order(decision)
    rank, world = order.index(member), len(order)
    rt.enter_process_group(rank, world, decision.epoch, store_address=store_address, device=device)
    t_group = time.time()
    trainer = build_trainer(args, device, rank, world)  # its broadcast is the new group's first collective
    t_built = time.time()
    live, nbytes = recv_live_state(_grow_source(order, decision.prev_roster), device)
    state = trainer.state
    with torch.no_grad(), state.full_params():
        for k, v in state.model.state_dict().items():
            v.copy_(live["model"][k])
    load_optimizer_state(state.optimizer, live["optimizer"])
    if state.scheduler is not None:
        state.scheduler.load_state_dict(live["scheduler"])
    state.step = live["step"]
    _sync(device)
    t_ready = time.time()
    tail = tail_loader(args, trainer, device, rank, world, len(decision.prev_roster), decision, live["epoch"],
                       live["consumed"])
    requested = float(os.environ.get("DDP_ELASTIC_JOIN_REQUESTED", "nan"))
    started = _process_started()
    coordinator.store.put_blob(f"join-{member}", json.dumps({
        "member": member, "epoch": decision.epoch, "rank": rank, "world": world, "step": live["step"],
        "process_start_s": t_store - requested, "process_started_s": (started - requested) if started else None,
        "group_s": t_group - t_store, "transfer_s": t_ready - t_group,
        "transfer_build_s": t_built - t_group, "transfer_recv_s": t_ready - t_built,
        "bytes": nbytes}))
    return Join(Gang(coordinator, member, order, rank, world, spe=live["spe"]), trainer, live["epoch"],
                live["consumed"], tail)


class _SwappableStream:
    """``(batch index, batch)`` of at most ``cap`` batches of a loader that
    the elastic resize can swap mid-epoch for the rest of the epoch, dealt
    to the new gang; the index keeps counting (ref ``dpp.py:880-902``)."""

    def __init__(self, loader, cap: int):
        self._it, self._idx, self.cap = iter(loader), -1, cap

    def __iter__(self):
        return self

    def __next__(self):
        if self._idx + 1 >= self.cap:  # no batch is gathered past the cap
            raise StopIteration
        batch = next(self._it)
        self._idx += 1
        return self._idx, batch

    def swap(self, loader, at: int | None = None) -> None:
        """Take the rest of the batches from ``loader``; with ``at`` the
        next one has index ``at`` (a grow before that step takes its batch
        from the new gang's deal)."""
        close = getattr(self._it, "close", None)
        if close is not None:
            close()
        self._it = iter(loader)
        if at is not None:
            self._idx = at - 1


def _roster_order(decision) -> list[str]:
    """The agreed roster in rank order (members by index)."""
    from distributeddataparallel_tpu_torch.runtime.elastic_gang import member_index

    return sorted(decision.roster, key=member_index)


def _grow_source(order: list[str], previous) -> int:
    """The new rank that sends a grow's joiners their state: the first
    member that was in the gang before it (after an SDC eviction every such
    member is one the vote found healthy)."""
    return min(order.index(m) for m in order if m in set(previous))


def tail_loader(args, trainer: Trainer, device: torch.device, rank: int, world: int, old_world: int,
                decision, epoch: int, consumed: int) -> DataLoader:
    """The rest of epoch ``epoch`` after a resize at its batch ``consumed``,
    dealt to ``world`` replicas: ``resize_index_plan``'s exactly-once tail;
    before the epoch's first batch (a grow at an epoch's edge), the epoch's
    own deal at the new world, which a ``--resume`` at that world reads."""
    from distributeddataparallel_tpu_torch.data.sharded import resize_index_plan

    if consumed == 0:
        trainer.loader.set_epoch(epoch)
        return trainer.loader
    plan = resize_index_plan(len(trainer.loader.dataset), per_replica_batch=args.batch_size, old_world=old_world,
                             new_world=world, consumed_steps=consumed, seed=args.seed, epoch=epoch,
                             membership_epoch=decision.epoch)
    return DataLoader(trainer.loader.dataset, per_replica_batch=args.batch_size, rank=rank, num_replicas=world,
                      device=device, shuffle=True, seed=args.seed, drop_last=True, workers=args.workers > 0,
                      augment=CifarAugment() if args.augment else None, index_shards=plan)


def elastic_resize(args, trainer: Trainer, device: torch.device, tel: Telemetry, log, gang: Gang, decision,
                   epoch: int, consumed: int):
    """The in-place resize after an agreed membership change (ref
    ``dpp.py:2799-2925``), every step in flight drained: the live ZeRO-1
    state resharded over the OLD group (the leaving member takes part), the
    process group re-formed over the new roster in rank order (a joiner
    enters it from outside), the trainer rebuilt at the new world with the
    live parameters, optimizer state, schedule and step, a grow's joiners
    sent that state by the first survivor (``runtime.elastic_gang.
    send_live_state``), and the rest of this epoch dealt to the new gang
    (``tail_loader``; ``consumed`` batches were trained).  Returns the tail
    loader, or None on the member that left.  No checkpoint is read."""
    from distributeddataparallel_tpu_torch.runtime.elastic_gang import (
        measure_downtime,
        reshard_live_state,
        send_live_state,
    )
    from distributeddataparallel_tpu_torch.training.elastic import saved_groups
    from distributeddataparallel_tpu_torch.training.optim import load_optimizer_state, optimizer_state_dict

    t_rs = time.perf_counter()
    state, old_world = trainer.state, gang.world
    order = _roster_order(decision)
    joiners = [order.index(m) for m in order if m not in set(gang.order)]
    new_rank = order.index(gang.member) if gang.member in order else None
    source = _grow_source(order, gang.order)
    zero = reshard_live_state(state, new_rank, len(order),  # a collective of the old group
                              extra_ranks=joiners if new_rank is not None and new_rank == source else ())
    live = None
    if new_rank is not None:
        live = {"model": state.model.state_dict(), "step": state.step,
                "optimizer": None if zero else optimizer_state_dict(state.optimizer),
                "scheduler": state.scheduler.state_dict() if state.scheduler is not None else None}
    got = rt.rebuild_process_group([gang.order.index(m) if m in gang.order else None for m in order],
                                   decision.epoch)
    gang.order = order
    if got is None:
        gang.left = True
        tel.rank, tel.world_size = None, 1  # no barrier with the gang it left, no timeline merge
        return None
    gang.rank, gang.world = got
    new = build_trainer(args, device, gang.rank, gang.world)
    with new.state.full_params():
        new.state.model.load_state_dict(live["model"])
    layout = new.state.zero
    load_optimizer_state(new.state.optimizer, live["optimizer"] if zero is None else layout.optimizer_state(
        zero["flats"], zero["scalars"], saved_groups(zero, new.state.optimizer)))
    if new.state.scheduler is not None:
        new.state.scheduler.load_state_dict(live["scheduler"])
    new.state.step = live["step"]
    del live, state
    sent = 0
    if gang.rank == source:
        for r in joiners:  # the joiner's own chunk of the flats; the rest is every rank's
            sent += send_live_state({
                "model": new.state.model.state_dict(), "step": new.state.step, "epoch": epoch,
                "consumed": consumed, "spe": gang.spe,
                "optimizer": optimizer_state_dict(new.state.optimizer) if zero is None else layout.optimizer_state(
                    zero["extra"][r], zero["scalars"], saved_groups(zero, new.state.optimizer)),
                "scheduler": new.state.scheduler.state_dict() if new.state.scheduler is not None else None,
            }, r, device)
    tail = tail_loader(args, new, device, gang.rank, gang.world, old_world, decision, epoch, consumed)
    for f in dataclasses.fields(Trainer):
        setattr(trainer, f.name, getattr(new, f.name))
    tel.rank, tel.world_size = gang.rank, gang.world
    tel.items_per_step = args.batch_size * gang.world * (args.seq_len if is_lm(args) else 1)
    tel.timer.n_chips = gang.world
    tel.bind_loader(tail)
    if tel.mfu_meter is not None:
        tel.mfu_meter = None
        log0("elastic resize: MFU meter disabled (chip count changed mid-run)")
    downtime = measure_downtime(t_rs)
    if tel.events is not None:
        tel.events.emit("resize_downtime", epoch=decision.epoch, seconds=round(downtime, 3))
    tel.add_goodput("resize", downtime)
    gang.resizes.append({"old_size": old_world, "new_size": gang.world, "epoch": decision.epoch,
                         "seconds": downtime, "left": list(decision.left), "joined": list(decision.joined),
                         **({"bytes_sent": sent} if sent else {})})
    log(f"elastic resize: {old_world} -> {gang.world} replicas (membership epoch {decision.epoch}, left: "
        f"{list(decision.left)}, joined: {list(decision.joined)}) in {downtime:.2f}s — no checkpoint read")
    tel.reset_window()
    return tail


def build_injector(args, rank: int, world_size: int, events=None) -> FaultInjector:
    """The fault injector of ``--chaos`` or ``DDP_CHAOS``.  Its once-markers
    live in ``DDP_CHAOS_STATE`` or ``<checkpoint-dir>/.chaos``, one
    directory per rank when there are several: each rank's injector fires
    each entry once, as the reference's one process does for all of its
    devices."""
    state_dir = os.environ.get("DDP_CHAOS_STATE") or (
        os.path.join(args.checkpoint_dir, ".chaos") if args.checkpoint_dir else None)
    if state_dir and world_size > 1:
        state_dir = os.path.join(state_dir, f"rank{rank}")
    return FaultInjector(args.chaos or os.environ.get("DDP_CHAOS", ""), state_dir, events=events)


def _preempt_agreed(faults: Faults, batch_idx: int, world_size: int) -> bool:
    """Do ALL ranks agree to stop after this batch?  A SIGTERM can reach
    the ranks on either side of a batch boundary; acting on the local flag
    alone would send them into mismatched collectives.  So every rank joins
    one all-reduce of the flag at the same batch indices, and any signalled
    rank stops everyone (one rank acts at the next boundary)."""
    if world_size == 1:
        return faults.signal is not None
    if batch_idx % PREEMPT_CHECK_EVERY:
        return False
    return rt.any_rank(faults.signal is not None)


@dataclasses.dataclass
class _InFlight:
    """One dispatched step until the loop settles it: where it is in the
    run, its handles (the loss, ``moe_aux``, the guard's flag) and how its
    time is read.  On the card past depth 0 the handles are copied to
    pinned host memory without blocking and the step is bracketed by CUDA
    events, so settling it waits for that step alone."""
    epoch: int
    batch: int
    gstep: int
    keys: tuple
    values: torch.Tensor
    host_s: float | None = None
    events: tuple | None = None


def _dispatched(metrics: dict, where: tuple, t0: float, device: torch.device, depth: int,
                start=None) -> _InFlight:
    """The step's handles, queued for their host read: stacked on the
    device, then (on the card past depth 0) copied to pinned memory behind
    an event; elsewhere the host clock times the step."""
    keys = tuple(k for k in ("loss", "moe_aux", "nonfinite_grad") if k in metrics)
    vec = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=device).reshape(())
                       for k in keys])
    if start is None:
        if depth == 0:
            _sync(device)
        return _InFlight(*where, keys, vec, host_s=time.perf_counter() - t0)
    host = torch.empty(len(keys), dtype=torch.float32, pin_memory=True)
    host.copy_(vec, non_blocking=True)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    return _InFlight(*where, keys, host, events=(start, end))


class IntegrityLoop:
    """``--integrity-every``'s host side (ref ``dpp.py:2320-2610``): the
    checker, the 2-rank replay arbiter and the shadow's digest function,
    re-armed at every resize (``rearm``: the arbiter only at world 2
    without ``--integrity-shadow``, which needs the step's input copy for
    itself)."""

    def __init__(self, args, tel: Telemetry, step_fn, world: int):
        self.args = args
        self.checker = integrity.IntegrityChecker(every=args.integrity_every, events=tel.events,
                                                  counters=tel.counters)
        self.rearm(step_fn, world)

    def rearm(self, step_fn, world: int) -> None:
        self.step_fn = step_fn
        self.digest_fn = integrity.make_digest_fn(None, self.args.zero)
        self.checker.arbiter = (integrity.ShadowArbiter(step_fn, self.digest_fn)
                                if world == 2 and not self.args.integrity_shadow else None)

    def wants_copy(self, state) -> bool:
        return self.checker.due(state.step) and (self.checker.arbiter is not None or self.args.integrity_shadow)

    def shadow(self, state, pend, batch, seed) -> bool:
        """The step run again on ``pend`` (a copy of its input) in the live
        state's tensors, the live values put back after: do the two runs'
        digests agree?"""
        live_d = self.digest_fn(state)
        shadow_d = integrity.replay_digest(state, pend, [(batch, seed)], self.step_fn, self.digest_fn)
        return bool(torch.equal(live_d, shadow_d))


def _loop(args, trainer: Trainer, device: torch.device, tel: Telemetry, log, faults: Faults,
          start_epoch: int, rank: int, world_size: int, start_at: tuple | None = None):
    """The epochs: train steps, eval and checkpoint, under telemetry and the
    fault-tolerance wiring.  Returns early, with the epoch, when a SIGTERM
    was agreed and its checkpoint saved.  ``start_at=(batch, loader)``: a
    grow's joiner starts ``start_epoch`` at that batch of that loader.

    Up to ``--dispatch-depth`` steps are in flight (``BoundedDispatch``):
    a step is settled (its loss, ``moe_aux`` and guard flag read on the
    host, the breaker fed, ``nan_skip`` emitted with its epoch and batch,
    its time read) when it leaves the window, and every step in flight at
    a drain: the telemetry's device sync (its throughput windows and the
    first step), a log line, a checkpoint, an integrity cadence step (its
    digest matrix is read before the next step is dispatched) and the
    epoch's edge.  The device is synchronised only there.  Depth 0 settles
    each step right after it, as a synchronous loop."""
    state, step_fn, loader, spe = trainer.state, trainer.step_fn, trainer.loader, trainer.steps_per_epoch
    eval_step, eval_loader, model = trainer.eval_step, trainer.eval_loader, trainer.state.model
    injector, ckpt, watchdog, gang = faults.injector, faults.checkpointer, faults.watchdog, faults.gang
    if gang is not None:
        spe = gang.spe = gang.spe or spe
    losses, step_times, eval_batches, evals, moe_aux = [], [], 0, [], []
    wall, wall_steps, preempted = 0.0, 0, None
    depth = args.dispatch_depth
    dispatch = warm_start.BoundedDispatch(depth)
    on_events = device.type == "cuda" and depth > 0

    def settle(rec: _InFlight) -> None:
        if rec.events is not None:
            rec.events[1].synchronize()
            step_times.append(rec.events[0].elapsed_time(rec.events[1]) / 1e3)
        else:
            step_times.append(rec.host_s)
        got = dict(zip(rec.keys, rec.values.tolist()))
        losses.append(got["loss"])
        if "moe_aux" in got:
            moe_aux.append(got["moe_aux"])
            tel.gauge("moe_aux", got["moe_aux"])
        if faults.breaker is not None:
            bad = got["nonfinite_grad"]
            if bad:
                tel.nan_skip(rec.gstep, rec.epoch, rec.batch)
            faults.breaker.observe(bad)
        if watchdog is not None and not watchdog.running:
            # Armed once the first step is settled: it builds the kernels.
            watchdog.start(epoch=rec.epoch, batch=rec.batch, gstep=rec.gstep)

    def drain() -> None:
        for rec, _ in dispatch.drain():
            settle(rec)
        _sync(device)

    tel.sync = drain  # the telemetry's device syncs (windows, first step, traces) are drains
    if gang is not None:
        # Every rank fires the same worker-kill@S / worker-join@S: its
        # tombstone or request waits for this barrier, so no rank whose host
        # ran ahead by the dispatch depth shows it to a rank still polling
        # an earlier step.
        injector.sync = lambda: (drain(), rt.barrier())
    integ = IntegrityLoop(args, tel, step_fn, world_size) if args.integrity_every else None
    counts = None  # the first pipeline step's unit counts (on the device)
    first = True  # the run's first step is recorded (and linted under --lint-step)
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        if tel.loader is not loader:
            tel.bind_loader(loader)
        ends = []
        with tel.span("epoch", epoch=epoch), tel.epoch_trace(epoch == start_epoch):
            stream = _SwappableStream(loader, trainer.steps_per_epoch)
            if start_at is not None and epoch == start_epoch:
                stream.swap(start_at[1], at=start_at[0])
            for i, batch in stream:
                # Stable across restarts: (epoch, batch)-derived.
                gstep = epoch * spe + i
                tel.step_start(gstep)
                if injector.enabled:
                    injector.before_step(gstep)  # slow-step / worker-join / preempt
                    if gang is not None and injector.joins:
                        # The grow lands before this step: the survivors
                        # wait here for the joiner, resize, and take this
                        # step's batch from the grown gang's deal.
                        members, injector.joins = injector.joins, []
                        injector.sync()
                        c = gang.coordinator
                        if gang.rank == 0:
                            for m in members:
                                c.rejoin(m)
                        c.await_members(members)
                        decision = c.poll()
                        if decision is None:
                            raise RuntimeError(f"elastic join of {members}: the gang agreed no new epoch")
                        tail = elastic_resize(args, trainer, device, tel, log, gang, decision, epoch, i)
                        stream.swap(tail, at=i)
                        state, step_fn, loader = trainer.state, trainer.step_fn, trainer.loader
                        eval_step, eval_loader, model = trainer.eval_step, trainer.eval_loader, state.model
                        rank, world_size = gang.rank, gang.world
                        if integ is not None:
                            integ.rearm(step_fn, world_size)
                        i, batch = next(stream)
                    if rank == 0:
                        # The reference poisons row 0 of the global batch,
                        # which is data rank 0's.
                        batch = injector.corrupt_batch(batch, gstep)
                    # A silent bit flip in one rank's parameters (bitflip).
                    injector.corrupt_state(state, gstep)
                on_cadence = integ is not None and integ.checker.due(state.step)
                pend = None
                if on_cadence:
                    integ.checker.leaf_names = integrity.digest_leaf_names(integrity.digest_parts(state, args.zero))
                    if integ.wants_copy(state):
                        # The replay base / the shadow's input: this step's
                        # input state, copied before the step updates it.
                        pend = integrity.copy_tree(state)
                seed = step_seed(args, epoch, i)
                t0 = time.perf_counter()
                with tel.span("step", step=gstep):
                    start = None
                    if on_events:
                        start = torch.cuda.Event(enable_timing=True)
                        start.record()
                    if first:
                        metrics = _first_step(args, trainer, step_fn, state, batch, seed, tel, log)
                        first = False
                    else:
                        metrics = step_fn(state, batch, seed)
                    rec = _dispatched(metrics, (epoch, i, gstep), t0, device, depth, start)
                for old, _ in dispatch.push(rec):
                    settle(old)
                if on_cadence:
                    drain()  # the verdict is read before the next step is dispatched
                    _integrity_check(args, integ, metrics, state, pend, batch, seed, gstep, gang, log)
                if integ is not None and integ.checker.arbiter is not None:
                    integ.checker.arbiter.hold(batch, seed)
                if watchdog is not None and watchdog.running:
                    watchdog.beat(epoch=epoch, batch=i, gstep=gstep)
                if counts is None and "pp_phase_counts" in metrics:
                    counts = metrics["pp_phase_counts"]
                    # 1F1B's or zb's units a stage: read once, when telemetry
                    # emits them after the first step (a drained device).
                    tel.step_end(gstep, pp_phase=lambda: phase_counts_payload(
                        counts.cpu(), schedule=args.pp_schedule, n_stages=args.pp, virtual=args.pp_virtual,
                        microbatches=args.pp_microbatches or args.pp, accounting=step_fn.bubble_accounting,
                        step=gstep))
                else:
                    tel.step_end(gstep)
                ends.append(time.perf_counter())
                if (state.step % args.log_every == 0) or i == spe - 1:
                    drain()
                    aux = f" moe_aux {moe_aux[-1]:.4f}" if "moe_aux" in rec.keys else ""
                    log(f"epoch {epoch} step {state.step} loss {losses[-1]:.4f} "
                        f"acc {float(metrics['accuracy']):.4f}{aux} {step_times[-1] * 1e3:.1f} ms")
                if ckpt is not None and _preempt_agreed(faults, i, world_size):
                    drain()  # checkpoint edge: every step settled
                    t_ck = time.perf_counter()
                    with tel.span("ckpt_save", epoch=epoch):
                        ckpt.save(state, epoch)
                    tel.add_goodput("checkpoint", time.perf_counter() - t_ck)
                    # Epoch granularity, as the reference: --resume continues
                    # at the NEXT epoch and the rest of this one is skipped
                    # (no batch is ever applied twice).
                    log(f"preempted: checkpoint saved mid-epoch {epoch}; --resume continues "
                        f"from epoch {epoch + 1}")
                    preempted = epoch
                    break
                decision = None
                if gang is not None:
                    # Store files, no device value: the poll keeps the no
                    # host read in a step rule.
                    injector.after_step(gstep)
                    c = gang.coordinator
                    decision = c.await_departure() if c.leaving() else c.poll()
                if decision is not None:
                    drain()  # nothing in flight crosses the swap
                    tail = elastic_resize(args, trainer, device, tel, log, gang, decision, epoch, i + 1)
                    if tail is None:  # this member left the gang
                        break
                    stream.swap(tail)
                    state, step_fn, loader = trainer.state, trainer.step_fn, trainer.loader
                    eval_step, eval_loader, model = trainer.eval_step, trainer.eval_loader, state.model
                    rank, world_size = gang.rank, gang.world
                    if integ is not None:
                        integ.rearm(step_fn, world_size)
        drain()  # the epoch's edge: eval and checkpoint see every step settled
        ends[-1] = time.perf_counter()
        # Steps 2.. of the epoch on the wall clock, the loader's time included.
        wall, wall_steps = wall + ends[-1] - ends[0], wall_steps + len(ends) - 1
        if preempted is not None or (gang is not None and gang.left):
            break
        if eval_step is not None:
            t_ev = time.perf_counter()
            with tel.span("eval", epoch=epoch), state.full_params():
                parts = []
                for batch in eval_loader:
                    parts.append(eval_step(model, batch))
                    eval_batches += 1
                total = sum(float(n) for _, n in parts)
            tel.add_goodput("eval", time.perf_counter() - t_ev)
            mean = {k: sum(float(m[k]) * float(n) for m, n in parts) / total for k in parts[0][0]}
            evals.append(mean)
            log(f"epoch {epoch} eval: {mean}")
        if ckpt is not None:
            t_ck = time.perf_counter()
            with tel.span("ckpt_save", epoch=epoch):
                ckpt.save(state, epoch)
            tel.add_goodput("checkpoint", time.perf_counter() - t_ck)
        if eval_step is not None or ckpt is not None:
            tel.reset_window()  # eval and saves stay out of the throughput window
    return losses, step_times, eval_batches, evals, wall, wall_steps, preempted, moe_aux


def _first_step(args, trainer: Trainer, step_fn, state, batch, seed, tel: Telemetry, log) -> dict:
    """The run's first step, under the collective recorder
    (``analysis.graph_lint``): the fingerprint of what it issued is the
    summary's ``collective_fp`` (the reference's ``fp_target``, a trace of
    the step; here the step itself).  Under ``--lint-step`` the step is
    linted as it runs (the reference's ``dpp.py:2408-2470``): the factory's
    manifest, a device-to-host sync inside it (on CUDA the step runs under
    the sync debug mode "error"), the schedule the step carries; findings
    stop the run, else one ``lint-step`` line.  No second step is run, so
    GL002's two-step comparison is left to the lint CLI."""
    from distributeddataparallel_tpu_torch.analysis import graph_lint
    from distributeddataparallel_tpu_torch.observability.memory import hbm_budget_bytes

    if args.lint_step:
        rep = graph_lint.lint_train_step(step_fn, state, batch, seed, check_order=False,
                                         hbm_budget_bytes=hbm_budget_bytes())
        ir, sched = graph_lint.lint_step_schedule(step_fn, state, rep)
        findings = rep.findings + sched
        if findings:
            raise SystemExit("--lint-step: train step violates its SPMD invariants:\n"
                             + "\n".join(str(f) for f in findings))
        log(f"lint-step [{rep.mode}] clean: collective fp={rep.fingerprint} counts {rep.collective_counts}"
            f" collectives={len(rep.collectives)}" + (f" schedule={ir.kind}" if ir is not None else ""))
        trainer.lint_report = {"mode": rep.mode, "fingerprint": rep.fingerprint, "counts": rep.collective_counts,
                               "collectives": len(rep.collectives), "schedule": ir.kind if ir is not None else None}
        metrics, fp = rep.metrics, rep.fingerprint
    else:
        with graph_lint.CollectiveRecorder() as rec:
            metrics = step_fn(state, batch, seed)
        fp = graph_lint.collective_fingerprint(rec.collectives)
    trainer.collective_fp = fp
    if tel.summary_builder is not None:
        tel.summary_builder.sample(collective_fp=fp)
    return metrics


def _integrity_check(args, integ: IntegrityLoop, metrics: dict, state, pend, batch, seed, gstep: int,
                     gang: Gang | None, log) -> None:
    """One cadence step's verdict (ref ``dpp.py:2531-2607``), everything in
    flight drained: the digest matrix read (the only integrity host read),
    the vote; on a clean check the replay base committed and the shadow
    run; on a mismatch the corrupt ranks tombstoned for the gang's poll at
    this boundary (the step already discarded its update), or, without an
    eviction path, the run stopped."""
    checker = integ.checker
    verdict = checker.check(metrics["sdc_digest"].cpu().numpy(), step=gstep)
    if verdict.ok:
        if checker.arbiter is not None:
            checker.arbiter.commit(pend, state)
        if args.integrity_shadow and pend is not None and not integ.shadow(state, pend, batch, seed):
            # Same step, same inputs, second run: a disagreement is a
            # transient compute fault, caught even at world 1.
            checker.note_shadow_mismatch(step=gstep)
            log(f"integrity: shadow re-run of step {gstep} disagrees with the live run (transient fault)")
    elif verdict.corrupt and gang is not None:
        # Closed loop: the corrupt ranks are tombstoned and this boundary's
        # poll lands the shrink over the survivors' verified live state;
        # nothing the liar sent reached their parameters.  No restart
        # budget, no checkpoint read.
        for bad in verdict.corrupt:
            gang.coordinator.kill(gang.order[bad])
            checker.note_eviction(bad, step=gstep)
        log(f"integrity: digest mismatch at step {gstep} — rank(s) {list(verdict.corrupt)} corrupt "
            f"({verdict.method}, leaves {list(verdict.leaves)}); evicting via elastic resize")
    else:
        raise SystemExit(f"integrity: replica digest mismatch at step {gstep} (corrupt={list(verdict.corrupt)}, "
                         f"tie={verdict.tie}) and no eviction path — rerun with --elastic, or restore from a "
                         f"verified checkpoint")


def build_faults(args, state: TrainState, tel: Telemetry, rank: int, world_size: int,
                 gang: Gang | None = None) -> Faults:
    """The injector, the breaker, the resilient checkpointer and the step
    watchdog these flags ask for, reporting into ``tel``; under
    ``--elastic`` this process's gang membership (``gang``: a joiner's,
    already in the gang)."""
    faults = Faults(injector=build_injector(args, rank, world_size, tel.events))
    if args.nan_guard:
        faults.breaker = NonFiniteBreaker(args.max_bad_steps)
    if args.checkpoint_dir:
        faults.checkpointer = ResilientCheckpointer(
            args.checkpoint_dir, injector=faults.injector, counters=tel.counters, events=tel.events)
    if args.step_timeout:
        ckpt = faults.checkpointer

        def on_wedge(diag: dict) -> None:
            tel.watchdog_fire(diag)
            if ckpt is None or rank != 0:
                return
            # Best-effort, rank 0's write alone (a collective would wait on
            # the wedged ranks): the watchdog's grace timer ends the process
            # even if the save itself wedges.
            try:
                ckpt.write(state, int(diag["last_known_state"].get("epoch", 0)))
            # ddplint: allow[broad-except] — a parting save while the process exits must not mask the hang report
            except Exception:  # noqa: BLE001 — the process is exiting
                warn_all("watchdog: emergency checkpoint failed")

        faults.watchdog = StepWatchdog(args.step_timeout, on_timeout=on_wedge)
    if args.elastic:
        if gang is None:
            faults.gang = build_gang(args, faults.injector, tel.events, rank, world_size)
        else:
            faults.gang = gang
            gang.coordinator.events = tel.events
            wire_gang(args, faults.injector, gang)
    return faults


@contextlib.contextmanager
def _sigterm_sets(faults: Faults, enabled: bool):
    """While the loop runs, SIGTERM only sets ``faults.signal``: the loop
    finishes the step, checkpoints and exits 0 (cloud preemption notices
    arrive as SIGTERM).  The previous handler is put back afterwards."""
    def on_term(signum, frame):
        faults.signal = signum
        log0("signal %d: will checkpoint at the current epoch and exit", signum)

    prev = None
    if enabled:
        try:
            prev = signal.signal(signal.SIGTERM, on_term)
        except ValueError:  # not the main thread (library use): no handler
            enabled = False
    try:
        yield
    finally:
        if enabled:
            signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)


def _apply_trial_to_args(args, config: dict, *, n_chips: int = 0) -> None:
    """Overwrite the tunable knobs on ``args`` with a TunedConfig (ref
    ``dpp.py:1083-1121``).

    Only the knobs the tuner owns are touched — everything else
    (model, dataset, steps, parallelism axes) keeps its CLI value, so
    an applied record can never change WHAT trains, only how fast.
    A persisted batch that would starve the dataset (global batch >
    examples, possible when a record tuned against one --num-examples
    is replayed against a smaller one) keeps the CLI batch/accum
    instead of training zero steps.
    """
    from distributeddataparallel_tpu_torch.tuning import TrialConfig

    trial = TrialConfig.from_dict(config)
    cap = (args.num_examples // n_chips
           if n_chips and getattr(args, "num_examples", None) else None)
    if cap is not None and trial.batch_per_chip > cap:
        warn0("tuned batch %d/chip needs %d examples but --num-examples is %d — keeping --batch-size %d "
              "(re-run --autotune search against this dataset)",
              trial.batch_per_chip, trial.batch_per_chip * n_chips, args.num_examples, args.batch_size)
    else:
        args.batch_size = trial.batch_per_chip
        args.accum_steps = trial.accum_steps
    args.zero = trial.zero
    # dpp stores "no override" as None; the tuner's explicit "f32" is
    # the same thing (and would trip the --moment-dtype-needs---zero
    # gate at zero=0 if kept literal).
    args.moment_dtype = None if trial.moment_dtype == "f32" else trial.moment_dtype
    args.bucket_mb = trial.bucket_mb
    args.dispatch_depth = trial.dispatch_depth
    if is_lm(args):
        args.remat = "on" if trial.remat else "off"


def _tune_dir_for(args) -> str:
    if args.tune_dir:
        return args.tune_dir
    if args.compile_cache:
        return os.path.join(args.compile_cache, "tuned")
    return ".ddp_tune"


class _EventBuffer:
    """The tune events, kept until ``train`` opens the run's event log."""

    def __init__(self):
        self.records: list[tuple[str, dict]] = []

    def emit(self, kind: str, **fields) -> None:
        self.records.append((kind, fields))


def _tuned_knobs(args) -> dict:
    return {k: getattr(args, k) for k in ("batch_size", "accum_steps", "remat", "zero", "moment_dtype",
                                          "bucket_mb", "dispatch_depth")}


def _run_autotune(args, device: torch.device, rank: int, world_size: int) -> dict:
    """``--autotune`` (ref ``dpp.py:1132-1250``): mutate ``args`` in place
    before anything model-shaped is built; returns ``{"summary",
    "events"}`` (the tune events, for the run's event log).

    ``apply`` loads the persisted TunedConfig for this (toolchain, devices,
    model) fingerprint and replays it — zero search trials, loud fallback
    to the CLI values on any key mismatch.  ``search`` runs the full
    prune→measure pipeline on the live gang first (every rank in step,
    ``tuning.harness``), persists the winner (rank 0), then applies it;
    the next run can use ``apply``."""
    import dataclasses as dc

    from distributeddataparallel_tpu_torch.tuning import (
        TrialConfig,
        TuningStore,
        default_space_for,
        default_tuned_key,
        search_model,
    )

    rt.clear_mesh()  # plain DP over the world: the tuner refuses the model axes
    events = _EventBuffer()
    model = "gpt2-small" if args.model == "gpt2" else args.model
    n_chips = world_size
    name = f"{model}@d{n_chips}"
    seq = args.seq_len if is_lm(args) else 128
    store = TuningStore(_tune_dir_for(args))
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    key = default_tuned_key(model, n_devices=n_chips, device_name=device_name, seq=seq)

    if args.autotune == "apply":
        record = store.load(name, key)
        applied = record is not None
        if applied:
            _apply_trial_to_args(args, record["config"], n_chips=n_chips)
            log0("autotune apply: %r -> %s (score %s, tuned %s)", name, record["config"],
                 record.get("score"), os.path.join(store.root, name))
        else:
            warn0("autotune apply: no matching TunedConfig %r under %s — running with the CLI defaults "
                  "(use --autotune search to create one)", name, store.root)
        events.emit("tune_result", mode="apply", winner=record["config"] if applied else None,
                    applied=applied, score=record.get("score") if applied else None, store_path=store.root)
        summary = {"mode": "apply", "applied": applied, "config": record["config"] if applied else None,
                   "score": record.get("score") if applied else None,
                   "measured_step_s": record.get("measured_step_s") if applied else None,
                   "store_path": store.root, "knobs": _tuned_knobs(args)}
        return {"summary": summary, "events": events.records}

    # Cap the space by what the dataset can feed: a winner whose global
    # batch exceeds --num-examples would train zero steps when applied.
    space = default_space_for(model)
    if getattr(args, "num_examples", None):
        cap = max(1, args.num_examples // n_chips)
        fit = tuple(b for b in space.batch_per_chip if b <= cap)
        space = dc.replace(space, batch_per_chip=fit or (min(cap, args.batch_size),))
    # The CLI flags as given ARE the hand-picked baseline: it is always
    # measured and always eligible to win, so the reported gain_frac is
    # an honest "what did tuning buy over what I typed".
    baseline = TrialConfig(
        batch_per_chip=args.batch_size,
        accum_steps=args.accum_steps,
        remat=(args.remat == "on" if args.remat != "auto" else is_lm(args) and args.model == "gpt2"),
        zero=args.zero,
        moment_dtype=args.moment_dtype or "f32",
        bucket_mb=args.bucket_mb,
        dispatch_depth=args.dispatch_depth,
    )
    result = search_model(
        model, n_data=n_chips, rank=rank, device=device, seq=seq, space=space, top_k=args.tune_trials,
        measure_steps=args.tune_steps, seed=args.seed, baseline=baseline, tune_store=store,
        store_name=name, key=key, events=events,
    )
    winner = result["winner"]
    summary = {"mode": "search", "applied": winner is not None,
               "winner": winner["trial"] if winner is not None else None,
               "config": winner["config"] if winner is not None else None, "gain_frac": result["gain_frac"],
               "store_path": result["store_path"], "records": result["records"]}
    if winner is None:
        warn0("autotune search measured no viable trial — keeping the CLI defaults")
    else:
        _apply_trial_to_args(args, winner["config"], n_chips=n_chips)
        log0("autotune search: winner %s (gain %+.1f%% vs baseline), persisted to %s", winner["trial"],
             100.0 * (result.get("gain_frac") or 0.0), result.get("store_path"))
    summary["knobs"] = _tuned_knobs(args)
    return {"summary": summary, "events": events.records}


def train(args, trainer: Trainer, device: torch.device, rank: int = 0, world_size: int = 1,
          join: Join | None = None) -> dict:
    """Run ``trainer`` for these flags on this rank, from the newest
    checkpoint with ``--resume``; returns the run summary (under
    ``--elastic``, of this rank after every resize; a member that left the
    gang returns ``{"left_gang": True}`` with its losses).  A grow's joiner
    (``join``) reads no checkpoint: it starts where the survivors are."""
    def log(*a):
        gang = faults.gang if faults is not None else None
        if (rank if gang is None else -1 if gang.left else gang.rank) == 0:
            print(*a, flush=True)

    state, model = trainer.state, trainer.state.model
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tel = build_telemetry(args, trainer, device, rank, world_size,
                          proc=None if join is None else int(join.gang.member.removeprefix("proc")))
    if trainer.tune is not None and tel.events is not None:
        for kind, fields in trainer.tune["events"]:
            tel.events.emit(kind, **fields)
    probe = None
    if args.bw_probe and join is None:  # a joiner's gang ran it at its start
        probe = allreduce_bandwidth(rt.current_mesh())
        log0("all-reduce probe: %d dev, %.0f MB -> %.1f GB/s bus BW, %.1f%% of %s GB/s link peak",
             probe["devices"], probe["payload_mb"], probe["bus_bw_gb_s"], 100 * probe["utilization"],
             f"{probe['peak_gb_s']:.0f}" if probe["peak_gb_s"] else "unknown")
    launches0 = dict(flash_attention.LAUNCHES)
    builds0 = (warm_start.STATS.hits, warm_start.STATS.misses)
    buckets0 = dict(overlap.COUNTS)
    fsdp0 = dict(fsdp.COUNTS)
    status, faults = "ok", None
    try:
        faults = build_faults(args, state, tel, rank, world_size, gang=None if join is None else join.gang)
        start_epoch, t_restore = 0, time.perf_counter()
        if join is not None:
            start_epoch = join.epoch
            faults.injector.fast_forward(join.epoch * join.gang.spe + join.consumed)
        elif args.resume:
            _, start_epoch = faults.checkpointer.restore_latest(state)
        restore_s = time.perf_counter() - t_restore
        if start_epoch >= args.epochs:
            raise SystemExit(f"the newest checkpoint is of epoch {start_epoch - 1}: "
                             f"nothing left to train for --epochs {args.epochs}")
        if start_epoch and join is None:
            log(f"resumed at epoch {start_epoch} (step {state.step})")
        with _sigterm_sets(faults, enabled=faults.checkpointer is not None):
            losses, step_times, eval_batches, evals, wall, wall_steps, preempted, moe_aux = _loop(
                args, trainer, device, tel, log, faults, start_epoch, rank, world_size,
                start_at=None if join is None else (join.consumed, join.tail))
        if faults.gang is not None and not faults.gang.left:  # a member that left is tombstoned already
            rt.barrier()  # no survivor is still polling when the first one leaves the store
            faults.gang.coordinator.stop()  # a later run in this store starts from an empty gang
    # ddplint: allow[broad-except] — records the run's end status for telemetry, then re-raises
    except BaseException as e:
        status = type(e).__name__
        raise
    finally:
        if faults is not None and faults.watchdog is not None:
            faults.watchdog.stop()
        tel.sync = lambda: _sync(device)  # the loop's drain ends with the loop
        tel.close(status)
    if faults.gang is not None:
        if faults.gang.left:
            return {"left_gang": True, "rank": None, "losses": losses}
        rank, world_size = faults.gang.rank, faults.gang.world
    state, model = trainer.state, trainer.state.model

    # Step 1 pays the one-time costs (kernel build and load, allocator
    # warm-up); the steady-state step time excludes it when there are more.
    steady = step_times[1:] or step_times
    step_time = sum(steady) / len(steady)
    wall_step_time = wall / wall_steps if wall_steps else None
    if state.fsdp is not None:
        param_norm = state.fsdp.param_norm()
    else:
        with torch.no_grad(), state.full_params():
            param_norm = math.sqrt(sum(float(p.double().pow(2).sum()) for p in model.parameters()))
    rows_per_step = args.batch_size * data_coords(rt.current_mesh(), rank, world_size)[1]
    rate = ("tokens_per_s", rows_per_step * args.seq_len) if is_lm(args) else ("images_per_s", rows_per_step)
    summary = {
        "model": args.model,
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "rank": rank,
        "world_size": world_size,
        "layout": layout_name(args),
        "num_params": state.num_params(),
        "collective_fp": trainer.collective_fp,
        "lint_step": trainer.lint_report,
        "start_epoch": start_epoch,
        "preempted_epoch": preempted,
        "train_steps": len(losses),
        "losses": losses,
        # Each step's load-balance term (MoE with --moe-aux-weight > 0).
        "moe_aux": moe_aux or None,
        "eval_batches": eval_batches,
        "eval": evals[-1] if evals else None,
        "step_time_s": step_time,
        "first_step_time_s": step_times[0],
        rate[0]: rate[1] / step_time,
        "wall_step_time_s": wall_step_time,
        f"{rate[0]}_wall": rate[1] / wall_step_time if wall_steps else None,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "param_norm": param_norm,
        "throughput_windows": tel.readings,
        "faults": tel.counters.summary(),
        # This run's flash-attention kernel launches.
        "attention_launches": {k: n - launches0[k] for k, n in flash_attention.LAUNCHES.items()},
        # --overlap's bucket launches: from backward's hooks, and after it.
        "overlap_buckets": {k: n - buckets0[k] for k, n in overlap.COUNTS.items()},
        # FSDP's flat gathers (forward and remat's recompute) and scatters.
        "fsdp_collectives": {k: n - fsdp0[k] for k, n in fsdp.COUNTS.items()},
        "dispatch_depth": args.dispatch_depth,
        # --elastic: each in-place resize of the gang (sizes, membership
        # epoch, seconds from the agreed decision to the rebuilt trainer).
        "elastic": {"resizes": faults.gang.resizes} if faults.gang is not None else None,
        # This run's kernel library builds: found in the cache, or compiled.
        "kernel_builds": {"cache": args.compile_cache, "hits": warm_start.STATS.hits - builds0[0],
                          "misses": warm_start.STATS.misses - builds0[1]},
        "startup": {"restore_s": restore_s, "first_step_s": tel.counters.compile_s,
                    "kernel_build_s": sum(r["seconds"] for r in warm_start.STATS.records[sum(builds0):])},
        # --autotune's outcome (its mode, the winner or the applied record,
        # the knobs this run trained with); --bw-probe's reading.
        "autotune": trainer.tune["summary"] if trainer.tune is not None else None,
        "bw_probe": probe,
    }
    log(f"train: {len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{step_time * 1e3:.1f} ms/step, {summary[rate[0]]:.0f} {rate[0]}")
    if args.generate:
        if state.fsdp is not None:
            # The whole model from the host gather (a collective), TP-free
            # and in the compute dtype, on the device of every rank.
            gen_model = fsdp.host_model(state.fsdp, device)
            if rank == 0:
                summary["generate"] = run_generate(args, gen_model, trainer.loader.dataset, log)
            del gen_model
        else:
            with state.full_params():  # a collective under ZeRO-3
                if rank == 0:
                    summary["generate"] = run_generate(args, model, trainer.loader.dataset, log)
    return summary


def elastic_store_dir(args) -> str:
    """The rendezvous root the trainers and their supervisor share (each
    derives it from the same argv, so a respawn finds the same store)."""
    if args.elastic_dir:
        return args.elastic_dir
    if args.events_dir:
        return os.path.join(args.events_dir, "gang")
    return os.path.join(args.checkpoint_dir, ".gang")


def layout_name(args) -> str:
    """The weight-update layout, as the reference's checkpoint topology
    names it (``dpp.py:1910-1914``)."""
    return "fsdp" if args.fsdp else f"zero{args.zero}" if args.zero else "replicated"


def run_generate(args, model, dataset, log) -> dict:
    """The KV-cache decode path after training (ref ``dpp.py:3056-3086``):
    greedily continue the first two training rows' first quarter with the
    trained params (``models.generate``), int8 matrices under
    ``--decode-quant``.  Returns the prompt, the output ids and the time of
    the prefill and of a decode step."""
    from distributeddataparallel_tpu_torch.models.generate import generate

    n_prompt = max(args.seq_len // 4, 1)
    prompt = torch.as_tensor(np.stack([np.asarray(dataset[i]["tokens"])[:n_prompt] for i in range(2)]))
    n_new = min(args.generate, model.cfg.max_seq_len - prompt.shape[1])
    timings: dict = {}
    out = generate(model, prompt, n_new, quantize=args.decode_quant, timings=timings)
    last8 = out[0, -8:].tolist()
    log(f"generate: prompt {tuple(prompt.shape)} -> {tuple(out.shape)} (last 8 tokens: {last8})"
        + (" [int8 weights]" if args.decode_quant else ""))
    return {
        "prompt": prompt.tolist(), "tokens": out.tolist(), "quantize": args.decode_quant,
        "prefill_ms": timings["prefill_s"] * 1e3,
        "decode_ms_per_token": timings["decode_s"] * 1e3 / max(n_new - 1, 1),
    }


def _worker(local_rank: int, nprocs: int, store_address: str | None, argv: list[str],
            result_file: str) -> None:
    """One rank of this host's gang (``runtime.launcher.spawn``)."""
    args = parse_args(argv)
    if args.device == "cpu":
        # Share the cores this process may run on between the ranks
        # instead of oversubscribing them; OMP_NUM_THREADS caps the share.
        share = max(1, len(os.sched_getaffinity(0)) // nprocs)
        torch.set_num_threads(min(share, int(os.environ.get("OMP_NUM_THREADS") or share)))
    run(args, local_rank=local_rank, nprocs=nprocs, store_address=store_address, result_file=result_file)


def local_ranks(args) -> int:
    """The processes this host starts: one per local device with
    ``--coordinator`` (all visible GPUs, or ``--fake-devices`` CPU ranks),
    else ``--num-processes`` (default ``--fake-devices`` or 1)."""
    if args.coordinator:
        return torch.cuda.device_count() if args.device == "cuda" else args.fake_devices or 1
    return args.num_processes or args.fake_devices or 1


def main(argv=None) -> dict | None:
    """Run the trainer for ``argv``; returns global rank 0's summary (None
    on a host of a multi-host job that does not hold rank 0).

    With ``--max-restarts N`` (and not already supervised) the trainer runs
    under ``runtime.launcher.spawn``'s supervisor with ``--resume`` added to
    its argv, so every restart continues from the newest intact checkpoint;
    the budget spent, it raises (ref ``dpp.py:3120-3160``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.compile_cache:
        # Exported before any child starts: every spawned or restarted
        # process builds into (and loads from) the same cache.
        warm_start.enable_compile_cache(args.compile_cache)
    n = local_ranks(args)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: torch.cuda.is_available() is false; pass "
                "--device cpu to run on the CPU"
            )
        if n > torch.cuda.device_count():
            raise RuntimeError(f"--num-processes {n} > {torch.cuda.device_count()} CUDA devices")
    supervised = args.max_restarts > 0 and not os.environ.get("_DDP_SUPERVISED")
    if n == 1 and not supervised:
        return run(args)
    if supervised and "--resume" not in argv:
        argv.append("--resume")
    env = None
    if supervised:
        env = {"_DDP_SUPERVISED": "1"}
        if args.elastic:
            # One rendezvous root for every incarnation: the supervisor
            # reads its tombstones to tell a shrunk gang from a crash.
            env["DDP_ELASTIC_DIR"] = elastic_store_dir(args)
    with tempfile.TemporaryDirectory(prefix="ddp_summary_") as d:
        result = os.path.join(d, "summary.json")
        launcher.spawn(
            _worker, args=(argv, result), nprocs=n, env=env,
            max_restarts=args.max_restarts if supervised else 0,
            # The supervisor writes the gang timeline and the runs-store
            # record: only its view spans every incarnation.
            events_dir=args.events_dir if supervised else None,
            runs_dir=args.runs_dir if supervised else None,
            # The resize rung (supervised) and the join rung read it.
            elastic_store=elastic_store_dir(args) if args.elastic else None,
            min_procs=args.min_procs,
        )
        if not os.path.exists(result):
            return None
        with open(result) as fh:
            return json.load(fh)


if __name__ == "__main__":
    print(json.dumps(main()))
