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
   (``scaled_dot_product_attention``, a yardstick only) and its bound;
4. the main path: ``dpp.main`` trains full-width GPT-2 124M (f32) for 10
   steps and one eval pass in an NCCL group of one, with the kernels'
   launch counters set to 0 just before and read just after.

It prints one ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# bf16 tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

# GPT-2 124M attention at the main path's shapes.
GPT2 = dict(B=8, Sq=1024, Skv=1024, H=12, Hkv=12, D=64, dtype="float32", causal=True)
CHECK_CASES = [
    ("gpt2_f32_causal", GPT2),
    ("noncausal_ragged_f32", dict(B=2, Sq=1000, Skv=1000, H=4, Hkv=4, D=64, dtype="float32", causal=False)),
    ("sq_lt_skv_f32_causal", dict(B=2, Sq=384, Skv=1024, H=4, Hkv=4, D=128, dtype="float32", causal=True)),
    ("gqa_bf16_causal", dict(B=2, Sq=1024, Skv=1024, H=32, Hkv=8, D=128, dtype="bfloat16", causal=True)),
    ("d256_gqa_ragged_f32", dict(B=1, Sq=77, Skv=300, H=6, Hkv=2, D=256, dtype="float32", causal=True)),
    ("d40_gqa_ragged_bf16", dict(B=2, Sq=200, Skv=200, H=6, Hkv=3, D=40, dtype="bfloat16", causal=False)),
]
# Stated tolerances, |kernel - plain| <= atol + rtol * |plain|.  Both
# versions compute in f32, so f32 results differ only by summation order
# and the online softmax's rescaling.  bf16 outputs are each rounded to
# bf16 once at the end: rtol 1e-2 covers the one bf16 ulp (2^-7 relative,
# at most) that two f32 values a few f32 ulps apart may round to, and atol
# the f32 differences before rounding.  lse is f32 in every case.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 1e-2)}

MAIN_ARGS = [
    "--model", "gpt2", "--dataset", "synthetic-lm", "--seq-len", "1024",
    "--vocab-size", "50257", "--batch-size", "8", "--optimizer", "adamw",
    "--lr", "3e-4", "--steps-per-epoch", "10", "--epochs", "1", "--eval",
]

KERNELS = [
    # name, replaces, matmuls per visible (q, k) pair
    ("flash_fwd", "distributeddataparallel_tpu/ops/pallas_attention.py:190", 2),
    ("flash_bwd_dq", "distributeddataparallel_tpu/ops/pallas_attention.py:394", 3),
    ("flash_bwd_dkv", "distributeddataparallel_tpu/ops/pallas_attention.py:421", 4),
]
SOURCE = "distributeddataparallel_tpu_torch/csrc/flash_attention.cu"


def log(*a):
    print(*a, flush=True)


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
    against the plain versions on the same inputs; returns max abs errors."""
    q, k, v, do = inputs(torch, c, seed)
    causal = c["causal"]
    out, lse = fa.flash_fwd(q, k, v, causal)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention(qg, kg, vg, causal).backward(do)
    ref = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_plain(q, k, v, ref_out, ref_lse, do, causal)))
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
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(c) -> int:
    """(q, k) pairs the mask leaves visible per (batch, head)."""
    Sq, Skv = c["Sq"], c["Skv"]
    if not c["causal"]:
        return Sq * Skv
    off = Skv - Sq
    return sum(min(off + i + 1, Skv) for i in range(Sq))


def bound(c, matmuls, bytes_moved):
    flops = 2 * c["D"] * visible_pairs(c) * c["B"] * c["H"] * matmuls
    t_ops = flops / PEAK_FLOPS[c["dtype"]] * 1e3
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def measure(torch, fa, c, seed):
    """Kernel, plain and library times at the main path's shapes."""
    import torch.nn.functional as F

    q, k, v, do = inputs(torch, c, seed)
    causal = c["causal"]
    out, lse = fa.flash_fwd(q, k, v, causal)
    delta = fa.attention_delta(out, do)
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)

    # Library yardstick: SDPA on (B, H, S, D) views, forward and backward.
    ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_fwd = lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    o_lib = lib_fwd()
    do_l = do.transpose(1, 2)
    lib_bwd = lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do_l, retain_graph=True)
    lib_fwd_ms = time_ms(torch, lib_fwd, 20)
    lib_bwd_ms = time_ms(torch, lib_bwd, 20)

    runs = {
        "flash_fwd": (
            lambda: fa.flash_fwd(q, k, v, causal),
            lambda: fa.flash_fwd_plain(q, k, v, causal),
            nbytes(q, k, v, out, lse), lib_fwd_ms,
            "F.scaled_dot_product_attention forward",
        ),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal),
            nbytes(q, k, v, do, lse, delta, dq), lib_bwd_ms,
            "F.scaled_dot_product_attention backward (dq, dk and dv together)",
        ),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal),
            nbytes(q, k, v, do, lse, delta, dk, dv), lib_bwd_ms,
            "F.scaled_dot_product_attention backward (dq, dk and dv together)",
        ),
    }
    res = {}
    for name, replaces, matmuls in KERNELS:
        kern, plain, nb, lib_ms, lib_call = runs[name]
        b_ms, b_by = bound(c, matmuls, nb)
        res[name] = {
            "ms": time_ms(torch, kern, 20),
            "plain_ms": time_ms(torch, plain, 5),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_ms,
            "library_call": lib_call,
            "bytes": nb,
        }
        log(f"  {name}: {res[name]['ms']:.3f} ms (plain {res[name]['plain_ms']:.3f}, "
            f"library {lib_ms:.3f}, bound {b_ms:.3f} by {b_by})")
    return res


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
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("#"):
            log("    " + line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    log("[3] kernels against their plain versions (|err| <= atol + rtol*|plain|)")
    errs = {}
    for i, (name, c) in enumerate(CHECK_CASES):
        errs[name] = check_case(torch, fa, name, c, seed=i)
    log(f"    timing at the GPT-2 shapes {GPT2} ({smi})")
    timing = measure(torch, fa, GPT2, seed=100)

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

    kernels = []
    for name, replaces, _ in KERNELS:
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(errs["gpt2_f32_causal"][k] for k in (
                ("out", "lse") if name == "flash_fwd" else ("dq",) if name == "flash_bwd_dq" else ("dk", "dv"))),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_call": t["library_call"], "shapes": GPT2,
        })
    main_path = {
        "step_ms": summary["step_time_s"] * 1e3, "tokens_per_s": summary["tokens_per_s"],
        "peak_memory_bytes": summary["peak_memory_bytes"], "losses": losses,
        "eval": summary["eval"], "train_steps": steps, "eval_batches": evals,
    }
    log(json.dumps({"checks": {"tolerance": TOL, "max_abs_err": errs}, "card": smi}))
    log(json.dumps({"main_path": main_path, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(nvidia_smi())  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
