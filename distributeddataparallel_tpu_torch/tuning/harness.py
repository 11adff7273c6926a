"""Model harness + end-to-end search entry point for the autotuner.

Counterpart of the reference's ``tuning/harness.py`` over the port's
models and step: ``build_trial_case`` builds one runnable case for a
``TrialConfig`` — the trial's remat in the transformer config, its
accumulation, bucket size and ZeRO level in ``make_train_step``, its
moment dtype in ``zero_state`` (``ZeroLayout`` / ``LowBitMoments``), and a
synthetic batch drawn with numpy from ``seed`` (each data rank takes its
rows of the global batch) — and ``measure_trial`` times it.
``search_model`` is the orchestrator ``dpp --autotune search`` calls:
statics → predictions → ``Autotuner.search`` → winner persisted in the
``TuningStore`` → ``tune_result`` event.  The models are the reference
harness's registry: its ``mlp`` and ``cnn`` (8x8x1 images), ``tiny-lm``
(4 layers) and ``gpt2-small`` (GPT-2 124M at full width, so every
measured trial runs K1–K3 through the port's normal step).  The LMs are
built unscanned, as ``dpp``'s plain data-parallel path builds them: the
trials measure the step the run trains with.

Stated divergences from the reference:

- **No executable store.**  The reference hands ``exec_store`` to a
  ``BackgroundPrecompiler`` (``prepare``) and to ``warm_train_step``: its
  next candidate compiles while the current one is measured.  Serialized
  XLA executables have no torch counterpart (ROADMAP.md Queue 1), so here
  ``prepare`` is None and every trial's ``warm_mode`` is None; the kernels'
  library is built once per process by ``warm_start.build_library`` (under
  ``--compile-cache`` when set), and the first step of each trial is
  accounted apart (``compile_or_load_s``), as in the reference.  There is
  no abstract (``concrete=False``) case either: it existed only to feed
  those background compiles.
- **Only running out of memory is a trial's own failure**
  (``tuning.autotuner``).  A trial that runs out of memory is freed before
  its ``error:`` status is recorded; a trial whose layout the step factory
  refuses raises ``TrialRefused`` before anything is built.
- **The tuned key is the port's own** (``tuning.store.tuned_key``).
- **Several processes.**  The reference's search is one program over its
  mesh.  Here every data rank runs the same search in step (the trials'
  steps hold the gang's collectives): the trial list, its order and the
  predictions are the same on every rank by construction, and a measured
  window is the slowest rank's (one ``all_reduce(MAX)``), so every rank
  picks the same winner.  Rank 0 alone writes the store.  An out-of-memory
  error on one rank only is not agreed: the other ranks wait in the step's
  collective.

Each measured trial also records its peak allocated bytes
(``peak_bytes``); the case is dropped, ``gc.collect()``,
``torch.cuda.empty_cache()`` and ``torch.cuda.reset_peak_memory_stats()``
run before the next trial, so a later trial meets an empty allocator.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from distributeddataparallel_tpu_torch.tuning.autotuner import Autotuner, TrialRefused
from distributeddataparallel_tpu_torch.tuning.space import SearchSpace, TrialConfig
from distributeddataparallel_tpu_torch.tuning.store import TuningStore, tuned_key
from distributeddataparallel_tpu_torch.utils.logging import get_logger

#: models the tuner can search (the reference's mesh_sim registry)
TUNE_MODELS = ("mlp", "cnn", "tiny-lm", "gpt2-small")

#: dpp model names -> registry names
_ALIASES = {"gpt2": "gpt2-small"}

#: optimizer moment bytes per param for the analytic memory ladder
#: (adam: two moments; see parallel.zero.LowBitMoments)
_MOMENT_BYTES = {"f32": 8.0, "bf16": 4.0, "int8": 2.0}

#: the image models' input (NHWC) and class count, as the reference's
_IMAGE_SHAPE = {"cnn": (8, 8, 1), "mlp": (64,)}
_CLASSES = 10


def canonical_model(name: str) -> str:
    name = _ALIASES.get(name, name)
    if name not in TUNE_MODELS:
        raise ValueError(
            f"autotuner does not support model {name!r} (have {TUNE_MODELS})"
        )
    return name


def model_config_for(model: str, *, seq: int = 128, remat: bool = False):
    """The transformer config for LM models (with the trial's remat
    policy applied), or None for cnn/mlp."""
    if model in ("cnn", "mlp"):
        return None
    from distributeddataparallel_tpu_torch.models import transformer as tfm

    cfg = tfm.gpt2_124m() if model == "gpt2-small" else tfm.tiny_lm(num_layers=4)
    return dataclasses.replace(cfg, remat=remat)


def _build_model(model: str, cfg, device, generator=None):
    from distributeddataparallel_tpu_torch.models import transformer as tfm
    from distributeddataparallel_tpu_torch.models.simple_cnn import SimpleCNN, TinyMLP

    if model == "mlp":
        return TinyMLP(_IMAGE_SHAPE["mlp"], num_classes=_CLASSES, device=device, generator=generator)
    if model == "cnn":
        return SimpleCNN(num_classes=_CLASSES, in_channels=_IMAGE_SHAPE["cnn"][-1], device=device,
                         generator=generator)
    return tfm.TransformerLM(cfg, device=device, generator=generator)


def model_statics(model: str, *, seq: int = 128) -> dict:
    """Trial-independent facts the analytic pruning stage prices with:
    parameter count/bytes (a model on the ``meta`` device — nothing
    allocates) and closures for forward FLOPs and per-chip
    activation/batch bytes as a function of the trial.  Coarse by design —
    ranking fuel, not ground truth."""
    from distributeddataparallel_tpu_torch.observability.cost_model import (
        mlp_fwd_flops,
        simple_cnn_fwd_flops,
        transformer_fwd_flops,
    )

    model = canonical_model(model)
    cfg = model_config_for(model, seq=seq)
    if model in ("cnn", "mlp"):
        if model == "cnn":
            def fwd_flops(rows):
                return simple_cnn_fwd_flops(batch=rows, image_shape=_IMAGE_SHAPE["cnn"])

            row_bytes = 4 * (8 * 8 * 1 + 4)  # image + label + slack
            act_row_bytes = 4 * 3 * (8 * 8 * 32 + 4 * 4 * 64 + 10)
        else:
            def fwd_flops(rows):
                return mlp_fwd_flops(batch=rows, in_features=64)

            row_bytes = 4 * (64 + 4)
            act_row_bytes = 4 * 3 * (64 + 128 + 128 + 10)
        seq = 0

        def act_row_bytes_for(trial, _b=act_row_bytes):
            return _b
    else:
        seq = min(seq, cfg.max_seq_len)

        def fwd_flops(rows, _cfg=cfg, _seq=seq):
            return transformer_fwd_flops(_cfg, batch=rows, seq_len=_seq)

        row_bytes = 4 * (seq + 1)
        # Residual-stream activations (~14 f32 copies of S*d per layer
        # per row; remat keeps layer BOUNDARIES only and replays the
        # rest, so one layer's working set + boundaries) plus the
        # logits + softmax-grad buffers, which dominate small models
        # (S*vocab).
        d, layers, vocab = cfg.d_model, cfg.num_layers, cfg.vocab_size
        act_row_remat = 4 * seq * d * (14 + layers) + 8 * seq * vocab
        act_row_full = 4 * seq * d * 14 * layers + 8 * seq * vocab

        def act_row_bytes_for(trial):
            return act_row_remat if trial.remat else act_row_full

    params = list(_build_model(model, cfg, "meta").parameters())
    return {
        "model": model,
        "seq": seq,
        "params_count": sum(p.numel() for p in params),
        "params_bytes": sum(p.numel() * p.element_size() for p in params),
        "fwd_flops": fwd_flops,
        # Microbatching divides the live activation set; the logits
        # buffer scales the same way, so one divisor is honest enough.
        "act_bytes": lambda trial: (
            trial.batch_per_chip
            // max(1, trial.accum_steps)
            * act_row_bytes_for(trial)
        ),
        "batch_bytes": lambda trial: trial.batch_per_chip * row_bytes,
    }


def _image_loss(model, batch):
    from distributeddataparallel_tpu_torch.ops.losses import cross_entropy_loss

    return cross_entropy_loss(model(batch["image"]), batch["label"]), {}


def _lm_loss(model, batch):
    from distributeddataparallel_tpu_torch.ops.losses import lm_cross_entropy

    toks = batch["tokens"]
    return lm_cross_entropy(model(toks[:, :-1]), toks[:, 1:]), {}


def build_trial_case(
    model: str,
    trial: TrialConfig,
    *,
    n_data: int = 1,
    rank: int = 0,
    device="cpu",
    seq: int = 128,
    seed: int = 0,
) -> dict:
    """One runnable case for ``trial`` on this data rank: ``{"step",
    "state", "batch", "fwd_flops"}``.  The global batch of
    ``batch_per_chip * n_data`` rows is drawn with numpy from ``seed`` (the
    reference's draws), and this rank keeps its rows.  The step factory's
    composition check runs first: a layout it refuses raises
    ``TrialRefused`` before any model or state exists."""
    from distributeddataparallel_tpu_torch.observability.cost_model import (
        mlp_fwd_flops,
        simple_cnn_fwd_flops,
        transformer_fwd_flops,
    )
    from distributeddataparallel_tpu_torch.parallel.zero import zero_state
    from distributeddataparallel_tpu_torch.training.state import TrainState
    from distributeddataparallel_tpu_torch.training.train_step import make_train_step

    model = canonical_model(model)
    device = torch.device(device)
    rows = trial.batch_per_chip * n_data
    mine = slice(rank * trial.batch_per_chip, (rank + 1) * trial.batch_per_chip)
    host = np.random.default_rng(seed)
    bucket_bytes = (
        int(trial.bucket_mb * 1024 * 1024) if trial.bucket_mb else None
    )
    lm = model not in ("cnn", "mlp")
    try:
        step = make_train_step(_lm_loss if lm else _image_loss, accum_steps=trial.accum_steps,
                               bucket_bytes=bucket_bytes, zero=trial.zero)
    except ValueError as exc:  # the factory's composition rules
        raise TrialRefused(exc) from exc

    cfg = model_config_for(model, seq=seq, remat=trial.remat)
    if lm:
        seq = min(seq, cfg.max_seq_len)
        tokens = host.integers(0, cfg.vocab_size, size=(rows, seq + 1), dtype=np.int32)
        batch = {"tokens": tokens[mine]}
        fwd = transformer_fwd_flops(cfg, batch=rows, seq_len=seq)
    else:
        x_shape = _IMAGE_SHAPE[model]
        image = host.normal(size=(rows,) + x_shape).astype(np.float32)
        label = host.integers(0, _CLASSES, size=(rows,), dtype=np.int32)
        batch = {"image": image[mine], "label": label[mine]}
        fwd = (simple_cnn_fwd_flops(batch=rows, image_shape=x_shape) if model == "cnn"
               else mlp_fwd_flops(batch=rows, in_features=64))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}

    net = _build_model(model, cfg, device, torch.Generator(device=device).manual_seed(seed))

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3, fused=True), None

    if trial.zero:
        state = zero_state(net, adam, level=trial.zero,
                           moment_dtype=None if trial.moment_dtype == "f32" else trial.moment_dtype,
                           bucket_bytes=bucket_bytes if trial.zero >= 2 else None, seed=seed)
    else:
        state = TrainState(net, *adam(net.parameters()))
    return {"step": step, "state": state, "batch": batch, "fwd_flops": fwd}


def default_space_for(model: str) -> SearchSpace:
    """A modest per-model default space — wide enough to beat a bad
    hand-pick, small enough that enumeration + analytic pruning stays
    sub-second and top-K measurement stays minutes."""
    model = canonical_model(model)
    if model in ("cnn", "mlp"):
        return SearchSpace(
            batch_per_chip=(16, 32, 64),
            accum_steps=(1, 2),
            remat=(False,),
            zero=(0, 1),
            moment_dtype=("f32",),
            bucket_mb=(None,),
            dispatch_depth=(2,),
        )
    return SearchSpace(
        batch_per_chip=(1, 2, 4),
        accum_steps=(1, 2),
        remat=(False, True),
        zero=(0, 1, 2),
        moment_dtype=("f32", "bf16"),
        bucket_mb=(None, 4.0),
        dispatch_depth=(2,),
    )


def default_tuned_key(model: str, *, n_devices: int, device_name: str, seq: int = 128) -> dict:
    """The TunedConfig key ``dpp`` derives for a search run and a later
    apply run alike, so both agree on identity without coordination: the
    toolchain, the devices, the mesh (``{"data": n_devices}``), the model
    config and the run identity (model, seq, param count, optimizer
    family) — never the tunable knobs."""
    model = canonical_model(model)
    statics = model_statics(model, seq=seq)
    return tuned_key(
        n_devices=n_devices,
        device_name=device_name,
        model_config=model_config_for(model, seq=seq),
        extra={
            "model": model,
            "seq": statics["seq"],
            "params_count": statics["params_count"],
            "optimizer": "adam",
        },
    )


def trial_key(base_key: dict, trial: TrialConfig) -> dict:
    """One trial's key: the base fingerprint PLUS the knobs (the
    reference's executable-store key for a trial)."""
    key = dict(base_key)
    key["trial"] = trial.as_dict()
    return key


def _sync(device: torch.device):
    return (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else None


def measure_trial(
    case: dict,
    trial: TrialConfig,
    *,
    n_chips: int,
    warmup_steps: int = 1,
    measure_steps: int = 4,
    peak_flops_per_chip: float | None = None,
    device="cpu",
) -> dict:
    """Short measured window for one case.

    The first step is ticked through ``StepTimer`` so the one-time costs
    (the kernels' library load, the allocator's warm-up) are attributed
    separately (``compile_or_load_s``); the window itself is
    ``measure_steps`` steps with one device synchronisation at its end
    (no per-step host read: no step's loss is read).  Over several ranks
    the window is the slowest rank's.  Score is model FLOP/s — the MFU
    numerator, so ranking is peak-independent; ``mfu`` is reported when
    the peak is known.  ``peak_bytes``: the allocator's peak over the
    trial (None off the card).
    """
    import torch.distributed as dist

    from distributeddataparallel_tpu_torch.observability.cost_model import train_step_flops
    from distributeddataparallel_tpu_torch.utils.metrics import StepTimer

    device = torch.device(device)
    sync = _sync(device)
    flops = train_step_flops(case["fwd_flops"], remat=trial.remat)
    rows = trial.batch_per_chip * n_chips
    timer = StepTimer(window=measure_steps, n_chips=n_chips)
    step, s, batch = case["step"], case["state"], case["batch"]

    step(s, batch)
    timer.tick(rows, sync=sync)  # first step, accounted apart
    for _ in range(max(0, warmup_steps - 1)):
        step(s, batch)
    if warmup_steps > 1 and sync is not None:
        sync()
    timer.reset()

    reading = None
    for _ in range(measure_steps):
        step(s, batch)
        r = timer.tick(rows, sync=sync)
        reading = r or reading
    window_s = reading["window_s"]
    if dist.is_initialized() and dist.get_world_size() > 1:
        slowest = torch.tensor([window_s], dtype=torch.float64,
                               device=device if dist.get_backend() == "nccl" else "cpu")
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        window_s = float(slowest.item())
    steps_per_s = measure_steps / window_s
    score = steps_per_s * flops["model_flops"]
    return {
        "step_s": 1.0 / steps_per_s,
        "steps_per_s": steps_per_s,
        "score": score,
        "mfu": (
            score / (peak_flops_per_chip * n_chips)
            if peak_flops_per_chip else None
        ),
        "warm_mode": None,
        "model_flops": flops["model_flops"],
        "compile_or_load_s": timer.compile_s,
        "peak_bytes": int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else None,
    }


def _release(device: torch.device) -> None:
    """Free what a trial left before the next one is built and its peak
    measured."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def search_model(
    model: str,
    *,
    n_data: int = 1,
    rank: int = 0,
    device="cpu",
    seq: int = 128,
    space: SearchSpace | None = None,
    trials: list[TrialConfig] | None = None,
    baseline: TrialConfig | None = None,
    top_k: int = 3,
    warmup_steps: int = 1,
    measure_steps: int = 4,
    seed: int = 0,
    efficiency: float | None = None,
    budget_bytes: int | None = None,
    tune_store: TuningStore | None = None,
    store_name: str | None = None,
    key: dict | None = None,
    events=None,
) -> dict:
    """Run the full search for ``model`` on ``n_data`` data ranks (this
    process being ``rank``, on ``device``) and persist the winner; returns
    the summary dict (winner, per-trial records, gain_frac vs the
    baseline, store path)."""
    from distributeddataparallel_tpu_torch.analysis.mesh_sim import analytic_memory_fit
    from distributeddataparallel_tpu_torch.observability import cost_model
    from distributeddataparallel_tpu_torch.observability.memory import hbm_budget_bytes

    model = canonical_model(model)
    device = torch.device(device)
    n_chips = int(n_data)
    statics = model_statics(model, seq=seq)
    seq = statics["seq"] or seq
    cfg = model_config_for(model, seq=seq)
    peak = cost_model.peak_flops_for(device, cfg.dtype if cfg is not None else "float32")
    budget = budget_bytes or hbm_budget_bytes()
    eff = efficiency or cost_model.DEFAULT_EFFICIENCY
    space = space or default_space_for(model)
    trial_list = trials if trials is not None else space.enumerate(seed=seed)
    if key is None:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        key = default_tuned_key(model, n_devices=n_chips, device_name=name, seq=seq)
    store_name = store_name or f"{model}@d{n_chips}"

    def _predict(trial: TrialConfig) -> dict:
        fwd = statics["fwd_flops"](trial.batch_per_chip * n_chips)
        fl = cost_model.train_step_flops(fwd, remat=trial.remat)
        return {
            "model_flops": fl["model_flops"],
            "step_s": cost_model.predict_step_s(
                fl["hardware_flops"], n_chips=n_chips,
                peak_flops_per_chip=peak, efficiency=eff,
            ),
            "fit": analytic_memory_fit(
                params_bytes=statics["params_bytes"],
                params_count=statics["params_count"],
                n_devices=n_chips,
                zero_level=trial.zero,
                moment_bytes_per_param=_MOMENT_BYTES[trial.moment_dtype],
                act_bytes=statics["act_bytes"](trial),
                batch_bytes=statics["batch_bytes"](trial),
                budget_bytes=budget,
            ),
        }

    def _measure(trial: TrialConfig) -> dict:
        _release(device)
        case, oom = {}, None
        try:
            case = build_trial_case(model, trial, n_data=n_chips, rank=rank, device=device, seq=seq,
                                    seed=seed)
            return measure_trial(case, trial, n_chips=n_chips, warmup_steps=warmup_steps,
                                 measure_steps=measure_steps, peak_flops_per_chip=peak, device=device)
        except torch.cuda.OutOfMemoryError as exc:
            # Re-raised below without this frame's traceback, which holds
            # the trial's tensors: the case is freed first.
            oom = torch.cuda.OutOfMemoryError(str(exc))
        finally:
            case.clear()
        _release(device)
        raise oom

    tuner = Autotuner(predict=_predict, measure=_measure, top_k=top_k, events=events)
    try:
        winner, records = tuner.search(trial_list, baseline=baseline)
    finally:
        _release(device)

    base_rec = next((r for r in records if r.status == "baseline"), None)
    gain_frac = None
    if winner is not None and base_rec is not None and base_rec.score:
        gain_frac = (winner.score - base_rec.score) / base_rec.score

    store_path = None
    if tune_store is not None and winner is not None:
        store_path = tune_store.path(store_name)
        if rank == 0:
            tune_store.save(
                store_name, key,
                config=winner.trial.as_dict(),
                objective="model_flops_per_s",
                score=winner.score,
                measured_step_s=winner.measured_step_s,
                predicted_step_s=winner.predicted_step_s,
                baseline_step_s=(
                    base_rec.measured_step_s if base_rec is not None else None
                ),
                gain_frac=gain_frac,
                trials=[r.as_dict() for r in records],
            )
            get_logger().info(
                "autotune winner %s (score %.3g) persisted to %s",
                winner.trial.label, winner.score or 0.0, store_path,
            )

    if events is not None:
        events.emit(
            "tune_result",
            mode="search",
            winner=winner.trial.label if winner is not None else None,
            config=winner.trial.as_dict() if winner is not None else None,
            score=winner.score if winner is not None else None,
            mfu=winner.mfu if winner is not None else None,
            gain_frac=gain_frac,
            n_trials=len(records),
            n_measured=sum(
                1 for r in records if r.status in ("measured", "baseline")
            ),
            store_path=store_path,
        )

    return {
        "model": model,
        "name": store_name,
        "key": key,
        "n_chips": n_chips,
        "winner": winner.as_dict() if winner is not None else None,
        "baseline": base_rec.as_dict() if base_rec is not None else None,
        "gain_frac": gain_frac,
        "records": [r.as_dict() for r in records],
        "store_path": store_path,
    }
