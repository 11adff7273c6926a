"""Where a training step's device time goes, from a ``torch.profiler`` trace.

    python -m distributeddataparallel_tpu_torch.profile_step [dpp flags] \\
        [--profile-steps 3]

Builds the trainer exactly as ``dpp`` does (same flags and defaults: give
GPT-2's ``--model gpt2 --seq-len 1024 --vocab-size 50257 --batch-size 8
--optimizer adamw``, Llama-3's ``--model llama --layers 8 --seq-len 2048
--vocab-size 128256 --batch-size 2 --optimizer adamw``, or the image paths'
``--model resnet50 --dataset shards:DIR --batch-size 64 ...``), runs two
warm-up steps, then profiles ``--profile-steps`` steps.  It prints one
JSON line: wall time per step, device busy time per step and the idle
share, device time per step by kernel group (the three flash-attention
kernels, convolutions, GEMMs, dtype casts and copies, BatchNorm /
elementwise / reductions, the optimizer's, NCCL's, the rest) with the ten
largest kernels, and the collectives' overlap with compute
(``parallel.overlap.overlap_report`` over the trace: NCCL kernel time, the
part of it under compute on another stream, their ratio; on one GPU NCCL
launches no kernel and the ratio is None).  For an MoE model
(``--moe-experts``) it also splits the step's device time into the router,
sort and dispatch/combine ops, the expert GEMMs, attention (K1-K3), the LM
head, AdamW and the rest (``moe_split``): each kernel is charged to the op
that launched it (the profiler's self device time of that op, with its
input shapes), so a forward op and its backward's ops land together.

A pipeline (``--pp``) runs one process per GPU, so its split comes from the
per-rank traces of a ``dpp --pp N --events-dir DIR --profile-steps A:B``
run (``pp_split``):

    python -m distributeddataparallel_tpu_torch.profile_step --pp-traces DIR/xprof \
        --profile-steps B-A

prints each stage's device ms a step: compute (every kernel but NCCL's),
P2P (NCCL's send/recv kernels: the transfer and the wait for the peer,
since such a kernel spins until its peer joins), the other collectives
(the pipe completion, the data mean) and the span from the first kernel to
the last; and, from the run's ``timeline.jsonl`` beside ``xprof/``, its
schedule's measured bubble (``observability.pipeline``'s
``measured_bubble_fraction``: the schedule, the virtual chunks, each
stage's executed F, B and W units against the analytic table).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict

import torch

from distributeddataparallel_tpu_torch import dpp
from distributeddataparallel_tpu_torch.observability.events import TIMELINE_NAME, read_events
from distributeddataparallel_tpu_torch.observability.pipeline import measured_bubble_fraction
from distributeddataparallel_tpu_torch.parallel.overlap import overlap_report, trace_kernels
from distributeddataparallel_tpu_torch.runtime import distributed as rt


def _group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "flash_fwd (K1)"
    if "flash_bwd_dq_kernel" in name:
        return "flash_bwd_dq (K2)"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_bwd_dkv (K3)"
    # cuDNN's convolution kernels (fprop / dgrad / wgrad engines and their
    # layout transforms) before GEMMs: implicit-GEMM conv kernels say "gemm".
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn", "winograd",
                              "nchwtonhwc", "nhwctonchw")):
        return "conv (cuDNN)"
    if any(k in low for k in ("gemm", "cutlass", "matmul", "nvjet")):  # nvjet: cuBLAS's Hopper GEMMs
        return "gemm"
    if "copy_kernel" in low:  # dtype casts (f32 params to bf16 per use) and copies
        return "casts/copies"
    if any(k in low for k in ("batch_norm", "bn_fw", "bn_bw", "welford", "reduce_kernel",
                              "elementwise")):
        return "batchnorm/elementwise/reductions"
    if "multi_tensor_apply" in low:  # the fused optimizers launch through it too
        return "optimizer (fused)"
    if "nccl" in low:
        return "nccl"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other kernels"


#: The ops of MoE routing and dispatch/combine (``models.transformer.MoEMLP``,
#: ``ops.moe``), forward and backward; the router's own matmul is told apart
#: by its output width, the expert count.
ROUTING_OPS = {"aten::sort", "aten::argsort", "aten::topk", "aten::index_select", "aten::index_add",
               "aten::index_add_", "aten::scatter", "aten::scatter_add_", "aten::gather", "aten::cumsum",
               "aten::_softmax", "aten::_softmax_backward_data", "aten::index", "aten::index_put_",
               "aten::eq", "aten::where"}
MM_OPS = {"aten::mm", "aten::addmm", "aten::_mm_dtype"}


def moe_split(key_averages, groups: dict, n: int, experts: int, vocab: int) -> dict:
    """Device ms a step of an MoE step by what launched it (module
    docstring): the router, sort, dispatch/combine ops, the expert GEMMs,
    the head's and the other GEMMs from the ops' self device time (from
    ``key_averages(group_by_input_shape=True)``), K1-K3 and AdamW from the
    kernel ``groups`` (ms a step), the rest of the busy time as ``other``."""
    out: dict[str, float] = defaultdict(float)
    for e in key_averages:
        if e.device_type != torch.autograd.DeviceType.CPU or e.self_device_time_total <= 0:
            continue
        name = e.key
        dims = {d for shape in (e.input_shapes or []) for d in (shape or []) if isinstance(d, int)}
        if name in ROUTING_OPS or (name in MM_OPS and experts in dims and vocab not in dims):
            out["router, sort, dispatch/combine"] += e.self_device_time_total / 1e3 / n
        elif name in ("aten::bmm", "aten::baddbmm"):
            out["expert GEMMs"] += e.self_device_time_total / 1e3 / n
        elif name in MM_OPS:
            out["LM head" if vocab in dims else "other GEMMs"] += e.self_device_time_total / 1e3 / n
    out["attention (K1-K3)"] = sum(ms for g, ms in groups.items() if g.startswith("flash_"))
    out["AdamW (fused)"] = groups.get("optimizer (fused)", 0.0)
    out["other"] = sum(groups.values()) - sum(out.values())
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


P2P_KERNEL = re.compile(r"nccl.*(sendrecv|send|recv)", re.IGNORECASE)


def pp_split(trace_paths, steps: int) -> list[dict]:
    """Each pipeline rank's device ms a step from its trace of ``steps``
    steps (module docstring), in the order of ``trace_paths``."""
    out = []
    for path in trace_paths:
        kernels = trace_kernels(path)
        ms = lambda ks: sum(k["end"] - k["start"] for k in ks) / 1e3 / steps
        nccl = [k for k in kernels if "nccl" in k["name"].lower()]
        p2p = [k for k in nccl if P2P_KERNEL.search(k["name"])]
        out.append({
            "trace": os.path.basename(path),
            "compute_ms": ms([k for k in kernels if "nccl" not in k["name"].lower()]),
            "p2p_ms": ms(p2p),
            "collectives_ms": ms([k for k in nccl if not P2P_KERNEL.search(k["name"])]),
            "span_ms": ((max(k["end"] for k in kernels) - min(k["start"] for k in kernels)) / 1e3 / steps
                        if kernels else None),
        })
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--profile-steps", type=int, default=3)
    p.add_argument("--pp-traces", default=None, metavar="DIR",
                   help="split the per-rank traces of a dpp --pp run (module docstring)")
    own, rest = p.parse_known_args(argv)
    if own.pp_traces:
        import glob

        out = {"pp_split": pp_split(sorted(glob.glob(os.path.join(own.pp_traces, "trace_*_p*.json"))),
                                    own.profile_steps)}
        timeline = os.path.join(os.path.dirname(os.path.abspath(own.pp_traces)), TIMELINE_NAME)
        if os.path.exists(timeline):
            out["bubble"] = measured_bubble_fraction(read_events(timeline))
        print(json.dumps(out), flush=True)
        return out
    args = dpp.parse_args(rest)
    if args.device != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("profile_step measures the GPU: it needs --device cuda and a GPU")
    device = dpp.device_for(args)
    rt.init_process_group(device=device)
    try:
        tr = dpp.build_trainer(args, device)
        batches = iter(tr.loader)
        for i in range(2):  # warm-up: kernel build/load, allocator, cuBLAS handles
            tr.step_fn(tr.state, next(batches), dpp.step_seed(args, 0, i))
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        moe = dpp.is_lm(args) and args.moe_experts > 0
        with torch.profiler.profile(activities=acts, record_shapes=moe) as prof:
            t0 = time.perf_counter()
            for i in range(2, 2 + own.profile_steps):
                tr.step_fn(tr.state, next(batches), dpp.step_seed(args, 0, i))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        rt.destroy_process_group()
    n = own.profile_steps
    per_kernel: dict[str, float] = defaultdict(float)
    events = prof.key_averages()
    # Device-side kernels only: a CPU op's self device time repeats the time
    # of the kernels it launched, and a range annotated on the host (the
    # optimizer step's) reappears on the GPU timeline spanning its kernels,
    # under the host range's name.
    host_names = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    for evt in events:
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.key not in host_names:
            per_kernel[evt.key] += float(evt.self_device_time_total)
    busy_ms = sum(per_kernel.values()) / 1e3 / n
    groups: dict[str, float] = defaultdict(float)
    for name, us in per_kernel.items():
        groups[_group(name)] += us / 1e3 / n
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        comm = overlap_report(trace_kernels(path))  # over the profiled steps
    out = {
        "device": torch.cuda.get_device_name(device),
        "flags": rest,
        "profiled_steps": n,
        "wall_ms_per_step": wall * 1e3 / n,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (1.0 - busy_ms / (wall * 1e3 / n)) if busy_ms else None,
        "device_ms_per_step_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": {k[:120]: us / 1e3 / n for k, us in top},
        "comm_overlap": comm,
    }
    if moe:
        out["moe_split"] = moe_split(prof.key_averages(group_by_input_shape=True), groups, n,
                                     args.moe_experts, tr.state.model.cfg.vocab_size)
    if not per_kernel:
        out["note"] = "the profiler recorded no device time; time kernels with CUDA events instead"
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
