"""Where a training step's device time goes, from a ``torch.profiler`` trace.

    python -m distributeddataparallel_tpu_torch.profile_step [dpp flags] \\
        [--profile-steps 3]

Builds the trainer exactly as ``dpp`` does (same flags and defaults: give
GPT-2's ``--model gpt2 --seq-len 1024 --vocab-size 50257 --batch-size 8
--optimizer adamw``, or the image paths' ``--model resnet50 --dataset
shards:DIR --batch-size 64 ...``), runs two warm-up steps, then profiles
``--profile-steps`` steps on one GPU.  It prints one JSON line: wall time per
step, device busy time per step and the idle share, and device time per
step by kernel group (the three flash-attention kernels, convolutions,
GEMMs, BatchNorm / elementwise / reductions, the optimizer's, the rest)
with the ten largest kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import torch

from distributeddataparallel_tpu_torch import dpp
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
    if "gemm" in low or "cutlass" in low or "matmul" in low:
        return "gemm"
    if any(k in low for k in ("batch_norm", "bn_fw", "bn_bw", "welford", "reduce_kernel",
                              "elementwise")):
        return "batchnorm/elementwise/reductions"
    if "multi_tensor_apply" in low:
        return "optimizer (foreach)"
    if "nccl" in low:
        return "nccl"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other kernels"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--profile-steps", type=int, default=3)
    own, rest = p.parse_known_args(argv)
    args = dpp.parse_args(rest)
    if args.device != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("profile_step measures the GPU: it needs --device cuda and a GPU")
    device = dpp.device_for(args)
    rt.init_process_group(device=device)
    try:
        tr = dpp.build_trainer(args, device)
        batches = iter(tr.loader)
        for _ in range(2):  # warm-up: kernel build/load, allocator, cuBLAS handles
            tr.step_fn(tr.state, next(batches))
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(own.profile_steps):
                tr.step_fn(tr.state, next(batches))
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
    out = {
        "device": torch.cuda.get_device_name(device),
        "flags": rest,
        "profiled_steps": n,
        "wall_ms_per_step": wall * 1e3 / n,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (1.0 - busy_ms / (wall * 1e3 / n)) if busy_ms else None,
        "device_ms_per_step_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": {k[:120]: us / 1e3 / n for k, us in top},
    }
    if not per_kernel:
        out["note"] = "the profiler recorded no device time; time kernels with CUDA events instead"
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
