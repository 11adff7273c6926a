#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``distributeddataparallel_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

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
   epoch 2 and its losses match the uninterrupted run's epoch 2.

It prints one ``image_paths`` JSON line (phases 5 and 6), one
``{"kernels": [...]}`` JSON line, the card's name and power limit, and as
its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

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
CHECK_CASES = [
    ("gpt2_f32_causal", GPT2),
    ("noncausal_ragged_f32", dict(B=2, Sq=1000, Skv=1000, H=4, Hkv=4, D=64, dtype="float32", causal=False)),
    ("sq_lt_skv_f32_causal", dict(B=2, Sq=384, Skv=1024, H=4, Hkv=4, D=128, dtype="float32", causal=True)),
    ("gqa_bf16_causal", GQA_BF16),
    ("d256_gqa_ragged_f32", dict(B=1, Sq=77, Skv=300, H=6, Hkv=2, D=256, dtype="float32", causal=True)),
    ("d40_gqa_ragged_bf16", dict(B=2, Sq=200, Skv=200, H=6, Hkv=3, D=40, dtype="bfloat16", causal=False)),
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

MAIN_ARGS = [
    "--model", "gpt2", "--dataset", "synthetic-lm", "--seq-len", "1024",
    "--vocab-size", "50257", "--batch-size", "8", "--optimizer", "adamw",
    "--lr", "3e-4", "--steps-per-epoch", "10", "--epochs", "1", "--eval",
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
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, c["dtype"])
    mk = lambda S, H: torch.randn(c["B"], S, H, c["D"], generator=g, device="cuda").to(dt)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a GPU", file=sys.stderr)
        return 1
    from distributeddataparallel_tpu_torch import dpp
    from distributeddataparallel_tpu_torch.ops import flash_attention as fa

    t_all = time.perf_counter()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"[1] card: {kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    so = fa.build()
    log(f"[2] build: {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_report(so.with_suffix(".log").read_text()):
        log("    " + line)

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

    image_paths = {
        "resnet50_imagenet_shape": resnet50_phase(torch, dpp, fa, smi),
        "resnet18_cifar_resume": resnet18_resume_phase(torch, dpp, fa, smi),
    }

    kernels = []
    for name, replaces, _ in KERNELS:
        t = timing[name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name],
            "launches_image_paths": sum(p["attention_launches"][name] for p in image_paths.values()),
            "max_abs_err": max(errs["gpt2_f32_causal"][k] for k in (
                ("out", "lse") if name == "flash_fwd" else ("dq",) if name == "flash_bwd_dq" else ("dk", "dv"))),
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
        kernels.append(entry)
    main_path = {
        "step_ms": summary["step_time_s"] * 1e3, "tokens_per_s": summary["tokens_per_s"],
        "peak_memory_bytes": summary["peak_memory_bytes"], "losses": losses,
        "eval": summary["eval"], "train_steps": steps, "eval_batches": evals,
    }
    log(json.dumps({"checks": {"tolerance": TOL, "max_abs_err": errs}, "card": smi}))
    log(json.dumps({"main_path": main_path, "card": smi}))
    log(json.dumps({"image_paths": image_paths, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(nvidia_smi())  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
