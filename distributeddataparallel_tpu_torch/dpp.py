"""Data-parallel trainer: the port's entry point.

    python -m distributeddataparallel_tpu_torch.dpp --model resnet18 \\
        --dataset synthetic --augment --eval
    python -m distributeddataparallel_tpu_torch.dpp --model resnet50 \\
        --dataset shards:DIR --batch-size 64 --optimizer sgd --momentum 0.9
    python -m distributeddataparallel_tpu_torch.dpp --model gpt2 \\
        --dataset synthetic-lm --seq-len 1024 --vocab-size 50257 \\
        --batch-size 8 --optimizer adamw --lr 3e-4 --steps-per-epoch 10 --eval

Counterpart of the plain data-parallel subset of the reference's ``dpp.py``
(image models ``mlp``, ``cnn`` (the default), ``resnet18`` (CIFAR stem) and
``resnet50``; the ``gpt2`` LM), with the same flag names and defaults.
``--checkpoint-dir`` saves every epoch and ``--resume`` continues at the
epoch after the newest one saved.  It runs on the GPU unless ``--device cpu``
is given; ``--device cuda`` (the default) raises when no GPU is present.
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

from distributeddataparallel_tpu_torch.data.datasets import (
    SyntheticClassification,
    SyntheticLM,
    load_cifar10,
)
from distributeddataparallel_tpu_torch.data.loader import DataLoader
from distributeddataparallel_tpu_torch.data.sharded import ShardedImageDataset
from distributeddataparallel_tpu_torch.data.transforms import CifarAugment
from distributeddataparallel_tpu_torch.models import transformer as tfm
from distributeddataparallel_tpu_torch.models.resnet import ResNet18, ResNet50
from distributeddataparallel_tpu_torch.models.simple_cnn import SimpleCNN, TinyMLP
from distributeddataparallel_tpu_torch.ops.losses import (
    accuracy,
    cross_entropy_loss,
    lm_cross_entropy,
    per_example_accuracy,
    per_example_cross_entropy,
)
from distributeddataparallel_tpu_torch.ops.preprocess import normalize_u8_images
from distributeddataparallel_tpu_torch.parallel.data_parallel import broadcast_params
from distributeddataparallel_tpu_torch.runtime import distributed as rt
from distributeddataparallel_tpu_torch.training.checkpoint import Checkpointer
from distributeddataparallel_tpu_torch.training.optim import build_optimizer
from distributeddataparallel_tpu_torch.training.state import TrainState
from distributeddataparallel_tpu_torch.training.train_step import (
    make_eval_step,
    make_train_step,
)


LM_MODELS = ("gpt2",)


def _dataset_arg(v: str) -> str:
    if v in ("synthetic", "cifar10", "synthetic-lm") or v.startswith("shards:"):
        return v
    raise argparse.ArgumentTypeError(
        f"{v!r} is not one of synthetic | cifar10 | synthetic-lm | shards:DIR"
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--model", choices=["mlp", "cnn", "resnet18", "resnet50", *LM_MODELS],
                   default="cnn", help="model family (resnet18 has the CIFAR stem)")
    p.add_argument("--dataset", type=_dataset_arg, default=None,
                   help="synthetic | cifar10 | synthetic-lm | shards:DIR (memory-mapped "
                        "image shards, DIR or DIR/{train,val}); default synthetic-lm "
                        "for LMs, synthetic otherwise")
    p.add_argument("--data-root", default="data", help="where cifar10 looks for its batches")
    p.add_argument("--workers", type=int, default=0,
                   help="background input-pipeline threads (0 = inline; any other "
                        "value gathers on one background thread)")
    p.add_argument("--augment", action="store_true",
                   help="CIFAR training augmentation (random crop pad 4 + horizontal "
                        "flip), deterministic per (seed, epoch, step); image datasets only")
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
    p.add_argument("--buffer-sync", choices=["mean", "broadcast"], default="mean",
                   help="BatchNorm buffers across ranks: 'mean' averages the running "
                        "stats, 'broadcast' adopts rank 0's (DDP broadcast_buffers)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true", help="run eval after each epoch")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--checkpoint-dir", default=None, help="save a checkpoint after every epoch")
    p.add_argument("--resume", action="store_true",
                   help="continue at the epoch after the newest checkpoint")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes to start, one per device (default 1, in this process)")
    args = p.parse_args(argv)
    lm = is_lm(args)
    if args.dataset is None:
        args.dataset = "synthetic-lm" if lm else "synthetic"
    if lm != (args.dataset == "synthetic-lm"):
        p.error(f"--model {args.model} cannot train on --dataset {args.dataset}")
    if args.augment and lm:
        p.error("--augment is for image datasets only")
    if args.resume and not args.checkpoint_dir:
        p.error("--resume needs --checkpoint-dir")
    return args


def is_lm(args) -> bool:
    return args.model in LM_MODELS


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


def build_dataset(args, train: bool = True):
    """The training (or eval) split for these flags, as the reference's
    ``build_dataset`` builds it."""
    seed = args.seed if train else args.seed + 1
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
    checkpointer: Checkpointer | None = None
    start_epoch: int = 0


def build_trainer(args, device: torch.device, rank: int = 0, world_size: int = 1) -> Trainer:
    """Model (rank 0's weights on every rank), optimizer, step functions,
    loaders and checkpointer for these flags, restored from the newest
    checkpoint with ``--resume``; the process group, if any, is formed."""
    lm = is_lm(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    dataset = build_dataset(args, train=True)
    if lm:
        model = tfm.TransformerLM(build_config(args), device=device, generator=gen)
    else:
        model = build_model(args, dataset, device, gen)
    broadcast_params(model)  # DDP constructor broadcast

    loader = DataLoader(dataset, per_replica_batch=args.batch_size, rank=rank,
                        num_replicas=world_size, device=device, shuffle=True,
                        seed=args.seed, drop_last=True, workers=args.workers > 0,
                        augment=CifarAugment() if args.augment else None)
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
            _loss_fn if lm else _image_loss_fn, accum_steps=args.accum_steps,
            bucket_bytes=int(args.bucket_mb * 1024 * 1024) if args.bucket_mb else None,
            grad_clip=args.grad_clip, buffer_sync=args.buffer_sync,
        ),
        loader=loader,
        steps_per_epoch=spe,
    )
    if args.eval:
        trainer.eval_step = make_eval_step(_metric_fn if lm else _image_metric_fn)
        trainer.eval_loader = DataLoader(
            build_dataset(args, train=False),
            per_replica_batch=args.batch_size, rank=rank, num_replicas=world_size,
            device=device, shuffle=False, seed=args.seed, drop_last=False, with_mask=True,
        )
    if args.checkpoint_dir:
        trainer.checkpointer = Checkpointer(args.checkpoint_dir)
        if args.resume:
            _, trainer.start_epoch = trainer.checkpointer.restore_latest(trainer.state)
    return trainer


def _train(args, trainer: Trainer, device: torch.device, rank: int, world_size: int) -> dict:
    log = (lambda *a: print(*a, flush=True)) if rank == 0 else (lambda *a: None)
    state, step_fn, loader, spe = trainer.state, trainer.step_fn, trainer.loader, trainer.steps_per_epoch
    eval_step, eval_loader, model = trainer.eval_step, trainer.eval_loader, trainer.state.model
    if trainer.start_epoch >= args.epochs:
        raise SystemExit(f"the newest checkpoint is of epoch {trainer.start_epoch - 1}: "
                         f"nothing left to train for --epochs {args.epochs}")
    if trainer.start_epoch:
        log(f"resumed at epoch {trainer.start_epoch} (step {state.step})")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_times, eval_batches, evals = [], [], 0, []
    wall, wall_steps = 0.0, 0
    for epoch in range(trainer.start_epoch, args.epochs):
        loader.set_epoch(epoch)
        ends = []
        for i, batch in enumerate(loader):
            if i >= spe:
                break
            t0 = time.perf_counter()
            metrics = step_fn(state, batch)
            _sync(device)
            step_times.append(time.perf_counter() - t0)
            ends.append(time.perf_counter())
            losses.append(metrics["loss"])
            if (state.step % args.log_every == 0) or i == spe - 1:
                log(f"epoch {epoch} step {state.step} loss {float(metrics['loss']):.4f} "
                    f"acc {float(metrics['accuracy']):.4f} {step_times[-1] * 1e3:.1f} ms")
        # Steps 2.. of the epoch on the wall clock, the loader's time included.
        wall, wall_steps = wall + ends[-1] - ends[0], wall_steps + len(ends) - 1
        if eval_step is not None:
            parts = []
            for batch in eval_loader:
                parts.append(eval_step(model, batch))
                eval_batches += 1
            total = sum(float(n) for _, n in parts)
            mean = {k: sum(float(m[k]) * float(n) for m, n in parts) / total for k in parts[0][0]}
            evals.append(mean)
            log(f"epoch {epoch} eval: {mean}")
        if trainer.checkpointer is not None:
            trainer.checkpointer.save(state, epoch)

    losses = [float(x) for x in losses]
    # Step 1 pays the one-time costs (kernel build and load, allocator
    # warm-up); the steady-state step time excludes it when there are more.
    steady = step_times[1:] or step_times
    step_time = sum(steady) / len(steady)
    wall_step_time = wall / wall_steps if wall_steps else None
    with torch.no_grad():
        param_norm = math.sqrt(sum(float(p.double().pow(2).sum()) for p in model.parameters()))
    rows_per_step = args.batch_size * world_size
    rate = ("tokens_per_s", rows_per_step * args.seq_len) if is_lm(args) else ("images_per_s", rows_per_step)
    summary = {
        "model": args.model,
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "world_size": world_size,
        "num_params": sum(p.numel() for p in model.parameters()),
        "start_epoch": trainer.start_epoch,
        "train_steps": len(losses),
        "losses": losses,
        "eval_batches": eval_batches,
        "eval": evals[-1] if evals else None,
        "step_time_s": step_time,
        "first_step_time_s": step_times[0],
        rate[0]: rate[1] / step_time,
        "wall_step_time_s": wall_step_time,
        f"{rate[0]}_wall": rate[1] / wall_step_time if wall_steps else None,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "param_norm": param_norm,
    }
    log(f"train: {len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{step_time * 1e3:.1f} ms/step, {summary[rate[0]]:.0f} {rate[0]}")
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
