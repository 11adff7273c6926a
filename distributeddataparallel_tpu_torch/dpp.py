"""Data-parallel LM trainer: the port's entry point.

    python -m distributeddataparallel_tpu_torch.dpp --model gpt2 \\
        --dataset synthetic-lm --seq-len 1024 --vocab-size 50257 \\
        --batch-size 8 --optimizer adamw --lr 3e-4 --steps-per-epoch 10 --eval

Counterpart of the LM subset of the reference's ``dpp.py``: the same flag
names and defaults.  It runs on the GPU unless ``--device cpu`` is given;
``--device cuda`` (the default) raises when no GPU is present.
``--num-processes N`` starts one process per device (``cuda:0`` ..
``cuda:N-1``, or N CPU processes on gloo); rank 0's summary is returned by
``main`` and printed as the last line of output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import torch

from distributeddataparallel_tpu_torch.data.datasets import SyntheticLM
from distributeddataparallel_tpu_torch.data.loader import DataLoader
from distributeddataparallel_tpu_torch.models import transformer as tfm
from distributeddataparallel_tpu_torch.ops.losses import (
    accuracy,
    lm_cross_entropy,
    per_example_accuracy,
    per_example_cross_entropy,
)
from distributeddataparallel_tpu_torch.parallel.data_parallel import broadcast_params
from distributeddataparallel_tpu_torch.runtime import distributed as rt
from distributeddataparallel_tpu_torch.training.optim import build_optimizer
from distributeddataparallel_tpu_torch.training.state import TrainState
from distributeddataparallel_tpu_torch.training.train_step import (
    make_eval_step,
    make_train_step,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--model", choices=["gpt2"], default="gpt2")
    p.add_argument("--dataset", choices=["synthetic-lm"], default="synthetic-lm")
    p.add_argument("--seq-len", type=int, default=128, help="LM sequence length")
    p.add_argument("--vocab-size", type=int, default=256,
                   help="LM vocab size (synthetic data)")
    p.add_argument("--num-examples", type=int, default=2048)
    p.add_argument("--layers", type=int, default=None,
                   help="override the model family's layer count")
    p.add_argument("--d-model", type=int, default=None,
                   help="override the model family's width (heads = d_model // 16)")
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
                   help="coalesce the gradient all-reduce into buckets of this size")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="clip the synced gradient to this global L2 norm")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true", help="run eval after each epoch")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes to start, one per device (default 1, in this process)")
    return p.parse_args(argv)


def build_config(args) -> tfm.TransformerConfig:
    overrides = dict(vocab_size=args.vocab_size, max_seq_len=args.seq_len)
    if args.layers:
        overrides["num_layers"] = args.layers
    if args.d_model:
        # Scale heads with width (head_dim 16) instead of keeping the
        # family's head count — the reference's rule (dpp.py:946-955).
        if args.d_model % 16:
            raise SystemExit("--d-model must be a multiple of 16")
        overrides.update(d_model=args.d_model, d_ff=4 * args.d_model,
                         num_heads=max(1, args.d_model // 16))
    return tfm.gpt2_124m(**overrides)


def _loss_fn(model, batch):
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = model(inputs)
    return lm_cross_entropy(logits, targets), {"accuracy": accuracy(logits, targets)}


def _metric_fn(model, batch):
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = model(inputs)
    return {
        "loss": per_example_cross_entropy(logits, targets),
        "accuracy": per_example_accuracy(logits, targets),
    }


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


def run(args, *, rank: int = 0, world_size: int = 1, init_method: str | None = None) -> dict:
    """Train (and evaluate) on this rank's device; returns the run summary."""
    device = device_for(args, rank)
    rt.init_process_group(init_method=init_method, world_size=world_size, rank=rank, device=device)
    try:
        return _train(args, build_trainer(args, device, rank, world_size), device, rank, world_size)
    finally:
        rt.destroy_process_group()


@dataclasses.dataclass
class Trainer:
    state: TrainState
    step_fn: object
    loader: DataLoader
    steps_per_epoch: int
    eval_step: object = None
    eval_loader: DataLoader | None = None


def build_trainer(args, device: torch.device, rank: int = 0, world_size: int = 1) -> Trainer:
    """Model (rank 0's weights on every rank), optimizer, step functions and
    loaders for these flags; the process group, if any, is already formed."""
    cfg = build_config(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = tfm.TransformerLM(cfg, device=device, generator=gen)
    broadcast_params(model)  # DDP constructor broadcast

    dataset = SyntheticLM(num_examples=args.num_examples, seq_len=args.seq_len,
                          vocab_size=args.vocab_size, seed=args.seed)
    loader = DataLoader(dataset, per_replica_batch=args.batch_size, rank=rank,
                        num_replicas=world_size, device=device, shuffle=True,
                        seed=args.seed, drop_last=True)
    spe = len(loader) if not args.steps_per_epoch else min(len(loader), args.steps_per_epoch)
    if spe == 0:
        raise SystemExit(
            f"no training steps: dataset gives {len(loader)} batches per replica "
            f"(dataset too small for --batch-size {args.batch_size} x {world_size} replicas)"
        )
    optimizer, scheduler = build_optimizer(args, model.parameters(), max(spe * args.epochs, 1))
    trainer = Trainer(
        state=TrainState(model, optimizer, scheduler),
        step_fn=make_train_step(
            _loss_fn, accum_steps=args.accum_steps,
            bucket_bytes=int(args.bucket_mb * 1024 * 1024) if args.bucket_mb else None,
            grad_clip=args.grad_clip,
        ),
        loader=loader,
        steps_per_epoch=spe,
    )
    if args.eval:
        trainer.eval_step = make_eval_step(_metric_fn)
        trainer.eval_loader = DataLoader(
            SyntheticLM(num_examples=args.num_examples, seq_len=args.seq_len,
                        vocab_size=args.vocab_size, seed=args.seed + 1),
            per_replica_batch=args.batch_size, rank=rank, num_replicas=world_size,
            device=device, shuffle=False, seed=args.seed, drop_last=False, with_mask=True,
        )
    return trainer


def _train(args, trainer: Trainer, device: torch.device, rank: int, world_size: int) -> dict:
    log = (lambda *a: print(*a, flush=True)) if rank == 0 else (lambda *a: None)
    state, step_fn, loader, spe = trainer.state, trainer.step_fn, trainer.loader, trainer.steps_per_epoch
    eval_step, eval_loader, model = trainer.eval_step, trainer.eval_loader, trainer.state.model

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_times, eval_batches, evals = [], [], 0, []
    tokens_per_step = args.batch_size * world_size * args.seq_len
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        for i, batch in enumerate(loader):
            if i >= spe:
                break
            t0 = time.perf_counter()
            metrics = step_fn(state, batch)
            _sync(device)
            step_times.append(time.perf_counter() - t0)
            losses.append(metrics["loss"])
            if (state.step % args.log_every == 0) or i == spe - 1:
                log(f"epoch {epoch} step {state.step} loss {float(metrics['loss']):.4f} "
                    f"acc {float(metrics['accuracy']):.4f} {step_times[-1] * 1e3:.1f} ms")
        if eval_step is not None:
            parts = []
            for batch in eval_loader:
                parts.append(eval_step(model, batch))
                eval_batches += 1
            total = sum(float(n) for _, n in parts)
            mean = {k: sum(float(m[k]) * float(n) for m, n in parts) / total for k in parts[0][0]}
            evals.append(mean)
            log(f"epoch {epoch} eval: {mean}")

    losses = [float(x) for x in losses]
    # Step 1 pays the one-time costs (kernel build and load, allocator
    # warm-up); the steady-state step time excludes it when there are more.
    steady = step_times[1:] or step_times
    step_time = sum(steady) / len(steady)
    with torch.no_grad():
        param_norm = math.sqrt(sum(float(p.double().pow(2).sum()) for p in model.parameters()))
    summary = {
        "model": args.model,
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "world_size": world_size,
        "num_params": sum(p.numel() for p in model.parameters()),
        "train_steps": len(losses),
        "losses": losses,
        "eval_batches": eval_batches,
        "eval": evals[-1] if evals else None,
        "step_time_s": step_time,
        "first_step_time_s": step_times[0],
        "tokens_per_s": tokens_per_step / step_time,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "param_norm": param_norm,
    }
    log(f"train: {len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{step_time * 1e3:.1f} ms/step, {summary['tokens_per_s']:.0f} tok/s")
    return summary


def _worker(rank: int, args, world_size: int, init_method: str, results) -> None:
    if args.device == "cpu":
        # Share the cores between the ranks instead of oversubscribing them.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    summary = run(args, rank=rank, world_size=world_size, init_method=init_method)
    if rank == 0:
        results["summary"] = summary


def _spawn(args, n: int) -> dict:
    """One process per device, each a rank of an n-way group; returns rank
    0's summary.  ``mp.spawn`` raises if any rank fails and ends the others."""
    import torch.multiprocessing as mp

    init_method = f"tcp://localhost:{rt.free_port()}"
    with mp.get_context("spawn").Manager() as manager:
        results = manager.dict()
        mp.spawn(_worker, args=(args, n, init_method, results), nprocs=n, join=True)
        return dict(results["summary"])


def main(argv=None) -> dict:
    args = parse_args(argv)
    n = args.num_processes or 1
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: torch.cuda.is_available() is false; pass "
                "--device cpu to run on the CPU"
            )
        if n > torch.cuda.device_count():
            raise RuntimeError(f"--num-processes {n} > {torch.cuda.device_count()} CUDA devices")
    if n > 1:
        return _spawn(args, n)
    return run(args)


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
