"""Fully-sharded data parallelism (FSDP / ZeRO-3) for the LMs.

Counterpart of ``distributeddataparallel_tpu/parallel/fsdp.py``.  Plain DP
keeps the whole model, its gradients and its optimizer state on every
rank; FSDP keeps 1/N of each, and a layer's whole weights exist only while
that layer runs:

1. **Storage.**  Each layer is one flat f32 vector: its leaves in the
   reference's order and layout (``models.io.jax_leaf_pieces``: sorted
   paths, Dense kernels transposed), zero-padded to a multiple of the
   ``data`` ranks.  The stacked layers are one ``(L, chunk)`` tensor per
   rank; everything else (embeddings, final norm, untied head, GPT-2's
   ``pos_embed``) one ``rest`` flat, sharded the same way.  Rank r of the
   data group keeps chunk r, so its shard holds the same elements, padding
   included, as the reference's device at that data index.
2. **Compute.**  ``FsdpLM.forward`` runs embed -> layers -> head.  Each
   layer gathers its shard over the data group (``all_gather``, cast to the
   gather dtype first), unflattens it into the port's parameter shapes and
   applies the model's own ``DecoderBlock`` to it (``functional_call`` on a
   template block on the meta device).  Under ``cfg.remat`` the gather and
   the block run under ``torch.utils.checkpoint``, so the backward gathers
   each layer again instead of keeping it: one layer's weights are live at
   a time.  The ``rest`` flat is gathered around each of its two uses,
   embedding in and head out, and checkpointed the same way.  Attention
   goes through ``ops.attention``, so the flash kernels run on the card.
3. **Gradient sync** is the gather's transpose: the backward of
   ``_GatherFlat`` reduce-scatters the full flat's gradient (a sum, in the
   gather dtype) back to this rank's shard, where it accumulates in f32.
   The step divides by the data ranks (the mean), clips, and steps the
   optimizer on the shards (``make_fsdp_train_step``).

With ``tp_axis`` (FSDP x Megatron TP) each model position flattens its own
TP shard of the layers (``parallel.tensor_parallel``'s rules: the
reference's model-major layout) and a whole copy of ``rest``; the gathers
stay on the data axis.  The clip's norm weights each element a model
position holds whole by ``1 / n_tp`` (``flat_chunk_sumsq``).

``fsdp_gather_params`` assembles the whole model (host RAM with
``host=True``, one layer on the device at a time) for checkpoints and
``--generate``; ``make_fsdp_eval_step`` evaluates with the same per-layer
gathers, so no whole replicated model is ever built on the device.
``COUNTS`` counts the gathers and the scatters.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributeddataparallel_tpu_torch.models.io import jax_leaf_pieces, port_view, ref_view
from distributeddataparallel_tpu_torch.models.transformer import (
    DecoderBlock,
    TransformerLM,
    _make_norm,
    f32_logits,
)
from distributeddataparallel_tpu_torch.ops.attention import rope_frequencies
from distributeddataparallel_tpu_torch.parallel.data_parallel import (
    flat_chunk_sumsq,
    group_active,
    group_size,
    sumsq_f32,
)
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import (
    flax_tp_dim,
    merge_tp_shards,
    shard_state_dict_tp,
    tp_dim,
)
from distributeddataparallel_tpu_torch.runtime.distributed import axis_group, axis_index, axis_size

#: Gathers of a flat (forward, and the recompute under remat) and the
#: reduce-scatters of its gradient, summed over steps (``reset_counts``).
COUNTS = {"gather": 0, "scatter": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def check_config(cfg) -> None:
    """The reference's guards (``fsdp.py:76-92``)."""
    if not cfg.scan_layers:
        raise ValueError("FSDP requires scan_layers=True")
    if cfg.dropout_rate:
        raise ValueError("FSDP does not support dropout")
    if cfg.cp_axis is not None or cfg.ep_axis is not None:
        raise ValueError("FSDP v2 composes with TP only: unset cp/ep_axis")


@dataclasses.dataclass(frozen=True)
class _Item:
    """One parameter's place in a flat: its port name (block-local for a
    layer), how the reference lays it out (``kind``), its (TP-local) port
    shape, its offset and size in the flat, and its reference path."""

    name: str
    kind: str
    shape: tuple
    offset: int
    numel: int
    path: str


class _Flat:
    """A flat's leaves in order, its size, and its per-rank chunk over
    ``n`` data ranks (``padded = chunk * n``)."""

    def __init__(self, items: list[_Item], n: int):
        self.items = items
        self.size = sum(it.numel for it in items)
        self.chunk = -(-self.size // n)
        self.padded = self.chunk * n

    def flatten(self, tensors: dict, prefix: str = "", device=None) -> torch.Tensor:
        """The leaves ``tensors[prefix + name]`` (moved to ``device``) as one
        zero-padded f32 vector in the reference's element order."""
        parts = [ref_view(tensors[prefix + it.name].to(device), it.kind).reshape(-1).float()
                 for it in self.items]
        flat = torch.cat(parts)
        return F.pad(flat, (0, self.padded - flat.shape[0]))

    def unflatten(self, flat: torch.Tensor, prefix: str = "", contiguous: bool = False) -> dict:
        """Inverse of ``flatten``: ``{prefix + name: view}`` in the port's
        shapes (contiguous copies with ``contiguous``)."""
        out = {}
        for it in self.items:
            t = port_view(flat[it.offset : it.offset + it.numel], it.shape, it.kind)
            out[prefix + it.name] = t.contiguous() if contiguous else t
        return out


class FsdpMeta:
    """The flat layout of a config over ``n`` data ranks (the reference's
    ``_Meta``): the layer and ``rest`` flats' leaves, TP-local with
    ``tp_axis`` (``n_tp`` model positions), taken from the whole model's
    parameters on the meta device."""

    def __init__(self, cfg, n: int, tp_axis: str | None = None, n_tp: int = 1):
        if (tp_axis is None) != (cfg.tp_axis is None):
            # A cfg.tp_axis over whole (not localized) weights would reduce
            # over the model axis what is not a partial sum: wrong, not a
            # shape error.
            raise ValueError("pass tp_axis to BOTH the config and the FSDP entry point")
        check_config(cfg)
        self.cfg, self.tp_axis = cfg, tp_axis
        self.n_tp = n_tp if tp_axis is not None else 1
        self.L = cfg.num_layers
        whole = TransformerLM(dataclasses.replace(cfg, tp_axis=None), device="meta")
        self.total = sum(p.numel() for p in whole.parameters())
        names = {id(p): k for k, p in whole.named_parameters()}
        layer, rest = [], []
        for path, pieces in jax_leaf_pieces(whole):
            p, kind, _ = pieces[0]
            name = names[id(p)]
            shape = self._localize(name, tuple(p.shape))
            if path.startswith("layers/"):
                local = name.split(".", 2)[2]  # layers.0.attn.q_proj.weight -> attn.q_proj.weight
                layer.append(_Item(local, kind, shape, sum(i.numel for i in layer), math.prod(shape), path))
            else:
                rest.append(_Item(name, kind, shape, sum(i.numel for i in rest), math.prod(shape), path))
        self.layer, self.rest = _Flat(layer, n), _Flat(rest, n)
        # The clip's weights: how many model positions hold each layer
        # leaf whole (the sharded ones: one).
        self.layer_dups = [1 if flax_tp_dim(it.path) is not None else self.n_tp for it in layer]

    def _localize(self, name: str, shape: tuple) -> tuple:
        dim = tp_dim(name)
        if self.n_tp == 1 or dim is None:
            return shape
        if shape[dim] % self.n_tp:
            raise ValueError(f"tp={self.n_tp} does not divide dim {dim} of {name} {shape}")
        return shape[:dim] + (shape[dim] // self.n_tp,) + shape[dim + 1:]

    @property
    def layer_chunk(self) -> int:
        return self.layer.chunk

    @property
    def rest_chunk(self) -> int:
        return self.rest.chunk

    def local_rows(self, sd: dict) -> torch.Tensor:
        """A (TP-local) model ``state_dict`` -> its ``(L, padded)`` layer
        flats."""
        return torch.stack([self.layer.flatten(sd, f"layers.{i}.") for i in range(self.L)])

    def flatten_full(self, sd: dict) -> dict:
        """A whole model's ``state_dict`` -> the reference's global flats:
        ``layers`` ``(L, n_tp * padded)`` (model positions major, each its
        TP shard's layer flats), ``rest`` its flat tiled ``n_tp`` times."""
        parts = [self.local_rows(shard_state_dict_tp(sd, j, self.n_tp)) for j in range(self.n_tp)]
        return {"layers": torch.cat(parts, dim=1), "rest": self.rest.flatten(sd).repeat(self.n_tp)}

    def unflatten_full(self, flat: dict) -> dict:
        """Inverse of ``flatten_full`` (whole, gathered flats) -> the whole
        model's ``state_dict``: each model position's layers unflattened,
        the sharded leaves concatenated (``merge_tp_shards``)."""
        w = self.layer.padded
        shards = []
        for j in range(self.n_tp):
            sd = self.rest.unflatten(flat["rest"][: self.rest.padded], contiguous=True)
            for i in range(self.L):
                sd.update(self.layer.unflatten(flat["layers"][i, j * w : (j + 1) * w], f"layers.{i}.", True))
            shards.append(sd)
        return merge_tp_shards(shards)


# ------------------------------------------------------------- gathers ---

def _all_gather(shard: torch.Tensor, n: int, group) -> torch.Tensor:
    full = torch.empty(shard.numel() * n, dtype=shard.dtype, device=shard.device)
    if dist.is_initialized():
        dist.all_gather_into_tensor(full, shard.contiguous(), group=group)
    else:
        full.copy_(shard)
    return full


class _GatherFlat(torch.autograd.Function):
    """Forward: this rank's f32 shard cast to ``dtype`` and all-gathered
    over ``group`` into the whole flat, returned as the flat's leaves in the
    port's shapes (contiguous, so each matmul sees the plain model's
    operand layout).  Backward, the transpose: the leaves' gradients laid
    out in the flat (zero padding) and reduce-scattered over ``group`` in
    ``dtype``, a sum, to this rank's f32 shard."""

    @staticmethod
    def forward(ctx, shard, spec: _Flat, group, dtype):
        ctx.set_materialize_grads(False)
        ctx.spec, ctx.group, ctx.dtype = spec, group, dtype
        full = _all_gather(shard.to(dtype), spec.padded // spec.chunk, group)
        COUNTS["gather"] += 1
        return tuple(spec.unflatten(full, contiguous=True).values())

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        buf = torch.empty(spec.padded, dtype=ctx.dtype, device=next(g for g in grads if g is not None).device)
        buf[spec.size:].zero_()
        for it, g in zip(spec.items, grads):
            view = port_view(buf[it.offset : it.offset + it.numel], it.shape, it.kind)
            if g is None:
                view.zero_()
            else:
                view.copy_(g)
        out = torch.empty(spec.chunk, dtype=ctx.dtype, device=buf.device)
        if dist.is_initialized():
            dist.reduce_scatter_tensor(out, buf, group=ctx.group)
        else:
            out.copy_(buf)
        COUNTS["scatter"] += 1
        return out.float(), None, None, None


def gather(shard: torch.Tensor, spec: _Flat, group, dtype=torch.float32) -> dict:
    """The whole flat of ``shard`` as ``{name: tensor}`` (differentiable:
    the gradient reduce-scatters back to ``shard``)."""
    return dict(zip((it.name for it in spec.items), _GatherFlat.apply(shard, spec, group, dtype)))


# --------------------------------------------------------------- model ---

class FsdpLM(nn.Module):
    """The LM over its FSDP shards: ``forward(tokens) -> logits`` as
    ``TransformerLM``'s, with each layer's weights gathered inside the call
    (module docstring).  Its parameters are this rank's shards: one per
    layer row (views into ``layers``, the ``(L, chunk)`` storage) and
    ``rest``."""

    def __init__(self, meta: FsdpMeta, layers: torch.Tensor, rest: torch.Tensor, *, group=None,
                 gather_dtype: torch.dtype | None = None):
        super().__init__()
        self.meta, self.cfg, self.group = meta, meta.cfg, group
        self.gather_dtype = gather_dtype or torch.float32
        self.layers = layers
        self.layer_shards = nn.ParameterList(nn.Parameter(layers[i]) for i in range(meta.L))
        self.rest_shard = nn.Parameter(rest)
        cfg = self.cfg
        # The model's own block and final norm on the meta device, in a
        # tuple: not submodules, so their (meta) parameters stay out of
        # parameters() and the state.
        self._templates = (DecoderBlock(cfg, device="meta"), _make_norm(cfg, "meta"))
        if cfg.positional == "rope":
            cos, sin = rope_frequencies(cfg.dims_per_head, cfg.max_seq_len, theta=cfg.rope_theta,
                                        device=layers.device)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)

    def shards(self) -> list[nn.Parameter]:
        """The parameters in the optimizer's order: the layer rows, then
        ``rest``."""
        return [*self.layer_shards, self.rest_shard]

    @property
    def data_index(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else (
            dist.get_rank() if dist.is_initialized() else 0)

    def _gather(self, shard, spec):
        return gather(shard, spec, self.group, self.gather_dtype)

    def _embed(self, rest, tokens):
        cfg = self.cfg
        p = self._gather(rest, self.meta.rest)
        x = F.embedding(tokens, p["token_embed.weight"]).to(cfg.dtype)
        if cfg.positional == "learned":
            x = x + p["pos_embed"][: tokens.shape[1]].to(cfg.dtype)
        return x

    def _layer(self, shard, x):
        rope = (self.rope_cos, self.rope_sin) if self.cfg.positional == "rope" else None
        return torch.func.functional_call(self._templates[0], self._gather(shard, self.meta.layer), (x, rope))

    def _head(self, rest, x):
        cfg = self.cfg
        p = self._gather(rest, self.meta.rest)
        norm = {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith("final_norm.")}
        x = torch.func.functional_call(self._templates[1], norm, (x,))
        w = p["token_embed.weight"] if cfg.tie_embeddings else p["lm_head.weight"]
        return f32_logits(x, w, cfg.dtype)

    def _run(self, fn, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(self, tokens: torch.Tensor, *, dropout_seed: int | None = None) -> torch.Tensor:
        if dropout_seed is not None:
            raise ValueError("FSDP does not support dropout")
        S = tokens.shape[1]
        if S > self.cfg.max_seq_len:
            raise ValueError(f"global seq len {S} > max_seq_len {self.cfg.max_seq_len}")
        x = self._run(self._embed, self.rest_shard, tokens)
        for shard in self.layer_shards:
            x = self._run(self._layer, shard, x)
        return self._run(self._head, self.rest_shard, x)

    # ------------------------------------------------ norms and gathers --
    def _sumsq(self, layer_rows: list[torch.Tensor], rest: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """The global sum of squares of a layout-shaped set of shards (the
        gradients, or the parameters), in ``dtype`` without TP: exact over
        the data group (the shards partition the flats; padding is zero),
        each element a model position holds whole counted ``1 / n_tp``
        under TP (in f32, ``flat_chunk_sumsq``)."""
        meta = self.meta
        if meta.n_tp == 1:
            total = sum(t.to(dtype).pow(2).sum() for t in layer_rows + [rest])
        else:
            start, sizes = self.data_index * meta.layer_chunk, [it.numel for it in meta.layer.items]
            total = sum(flat_chunk_sumsq(r, start, sizes, meta.layer_dups) for r in layer_rows)
            total = total + sumsq_f32([rest]) / meta.n_tp
        if group_active(self.group):
            dist.all_reduce(total, group=self.group)
        if meta.n_tp > 1:
            dist.all_reduce(total, group=axis_group(meta.tp_axis))
        return total

    def grad_sumsq(self) -> torch.Tensor:
        return self._sumsq([p.grad for p in self.layer_shards], self.rest_shard.grad)

    @torch.no_grad()
    def param_norm(self) -> float:
        # ddplint: allow[host-sync] — a diagnostic norm, never called inside a step
        return math.sqrt(float(self._sumsq(list(self.layer_shards), self.rest_shard, torch.float64)))

    @torch.no_grad()
    def load_full(self, sd: dict) -> None:
        """This rank's shards from a whole model's ``state_dict``."""
        meta, d = self.meta, self.data_index
        if meta.n_tp > 1:
            sd = shard_state_dict_tp(sd, axis_index(meta.tp_axis), meta.n_tp)
        dev, c, rc = self.layers.device, meta.layer_chunk, meta.rest_chunk
        for i in range(meta.L):
            self.layers[i].copy_(meta.layer.flatten(sd, f"layers.{i}.", dev)[d * c : (d + 1) * c])
        self.rest_shard.copy_(meta.rest.flatten(sd, device=dev)[d * rc : (d + 1) * rc])


# --------------------------------------------------------------- state ---

def fsdp_state(cfg, params: dict, build_optimizer, *, group=None, tp_axis: str | None = None,
               gather_dtype: torch.dtype | None = None):
    """The fully-sharded ``TrainState`` from a whole model's ``state_dict``
    ``params`` (the reference's ``fsdp_state``): this rank's chunk of every
    layer flat and of ``rest`` (of its TP shard under ``tp_axis``), the
    model an ``FsdpLM`` over them, and ``build_optimizer(shards)``
    (returning ``(optimizer, scheduler)``) stepping the shards.  ``group``:
    the data axis's process group (None: the world)."""
    from distributeddataparallel_tpu_torch.training.state import TrainState

    n = group_size(group)
    meta = FsdpMeta(cfg, n, tp_axis, axis_size(tp_axis))
    device = next(iter(params.values())).device
    model = FsdpLM(meta, torch.zeros(meta.L, meta.layer_chunk, device=device),
                   torch.zeros(meta.rest_chunk, device=device), group=group, gather_dtype=gather_dtype)
    model.load_full(params)
    optimizer, scheduler = build_optimizer(model.shards())
    return TrainState(model, optimizer, scheduler, fsdp=model)


@torch.no_grad()
def fsdp_gather_params(model: FsdpLM, *, host: bool = False) -> dict:
    """The whole model's ``state_dict`` from the shards (the reference's
    ``fsdp_gather_params``), on every rank: a collective.  One layer flat at
    a time is gathered over the data group (and, under TP, every model
    position's over the model group); ``host=True`` moves each piece to the
    host at once, so at most one layer's flats are on the device."""
    meta, group = model.meta, model.group
    n = group_size(group)
    tp_group = axis_group(meta.tp_axis) if meta.n_tp > 1 else None
    # ddplint: allow[host-sync] — host consolidation for a checkpoint, off the step path
    move = (lambda t: t.cpu()) if host else (lambda t: t)

    def whole(shard):  # (n_tp, padded): every model position's whole flat
        full = _all_gather(shard.contiguous(), n, group)
        return _all_gather(full, meta.n_tp, tp_group).view(meta.n_tp, -1) if tp_group is not None else full[None]

    rest = whole(model.rest_shard)
    shards = [{k: move(v) for k, v in meta.rest.unflatten(rest[j], contiguous=True).items()}
              for j in range(meta.n_tp)]
    for i in range(meta.L):
        row = whole(model.layers[i])
        for j in range(meta.n_tp):
            shards[j].update({k: move(v) for k, v in meta.layer.unflatten(row[j], f"layers.{i}.", True).items()})
    return merge_tp_shards(shards)


def host_model(model: FsdpLM, device) -> TransformerLM:
    """A TP-free ``TransformerLM`` of the whole model on ``device`` from the
    host gather (``--generate``): bf16 configs are cast on the host first
    (the reference's ``full_params``), so the device holds the
    compute-dtype copy only.  A collective."""
    sd = fsdp_gather_params(model, host=True)
    cfg = dataclasses.replace(model.cfg, tp_axis=None)
    if cfg.dtype != torch.float32:
        sd = {k: v.to(cfg.dtype) for k, v in sd.items()}
    out = TransformerLM(cfg, device="meta")
    out.load_state_dict({k: v.to(device) for k, v in sd.items()}, assign=True)
    if cfg.positional == "rope":
        out.rope_cos, out.rope_sin = model.rope_cos, model.rope_sin
    return out


# --------------------------------------------------------------- steps ---

def make_fsdp_train_step(loss_fn, *, accum_steps: int = 1, grad_clip: float | None = None,
                         tp_axis: str | None = None):
    """The FSDP train step (the reference's ``make_fsdp_train_step``):
    ``step(state, batch[, seed]) -> metrics`` for a state from
    ``fsdp_state``.  Each microbatch's backward reduce-scatters the
    gradients into the shards, where they sum; the step scales them by
    ``1 / accum_steps`` and ``1 / n`` (the mean over the data ranks),
    clips to ``grad_clip`` by the global norm and steps the optimizer on
    the shards.  The metrics are the trainer's (``make_train_step``'s):
    the loss and the loss_fn's aux values, averaged over the data
    ranks."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    from distributeddataparallel_tpu_torch.training.train_step import make_train_step

    return make_train_step(loss_fn, accum_steps=accum_steps, grad_clip=grad_clip, fsdp=True, tp_axis=tp_axis)


def lm_metrics(model, batch) -> dict:
    """Per-row cross-entropy and accuracy of an LM on ``batch["tokens"]``."""
    from distributeddataparallel_tpu_torch.ops.losses import per_example_accuracy, per_example_cross_entropy

    tokens = batch["tokens"]
    logits = model(tokens[:, :-1])
    return {"loss": per_example_cross_entropy(logits, tokens[:, 1:]),
            "accuracy": per_example_accuracy(logits, tokens[:, 1:])}


def make_fsdp_eval_step():
    """Streaming masked evaluation over the shards (the reference's
    ``make_fsdp_eval_step``): ``eval_step(model, batch) -> (means, count)``
    with ``make_eval_step``'s contract, through ``FsdpLM``'s forward, whose
    per-layer gathers keep one layer whole on the device at a time."""
    from distributeddataparallel_tpu_torch.training.train_step import make_eval_step

    return make_eval_step(lm_metrics)


# ------------------------------------------------- optimizer interchange --

def _plain_names(meta: FsdpMeta) -> list[str]:
    """The whole model's parameter names in ``parameters()`` order: the
    order of a plain optimizer's state."""
    return [k for k, _ in TransformerLM(dataclasses.replace(meta.cfg, tp_axis=None), device="meta")
            .named_parameters()]


def plain_optimizer_state(meta: FsdpMeta, shard_states: list[dict], param_groups: list) -> dict:
    """The optimizer ``state_dict`` of a plain run of the whole model from
    every FSDP shard ``state_dict``, model position major (each position's
    data ranks in order; one position without TP): every per-element state
    (moments, momentum) gathered into each position's flats, unflattened
    per parameter and its TP shards merged (``merge_tp_shards``), the
    scalars (AdamW's step) as they are.  ``param_groups``: the plain
    optimizer's own."""
    n = len(shard_states) // meta.n_tp
    per_name: dict[str, dict] = {}
    specs = [(meta.layer, f"layers.{i}.") for i in range(meta.L)] + [(meta.rest, "")]
    for idx, (spec, prefix) in enumerate(specs):
        states = [s["state"].get(idx, {}) for s in shard_states]
        for key, v in states[0].items():
            if v.dim() == 0:
                for it in spec.items:
                    per_name.setdefault(prefix + it.name, {})[key] = v.clone()
                continue
            positions = [spec.unflatten(torch.cat([s[key] for s in states[j * n : (j + 1) * n]]), prefix, True)
                         for j in range(meta.n_tp)]
            for name, t in merge_tp_shards(positions).items():
                per_name.setdefault(name, {})[key] = t
    names = _plain_names(meta)
    return {"state": {i: per_name[n] for i, n in enumerate(names) if n in per_name},
            "param_groups": param_groups}


def shard_optimizer_state(model: FsdpLM, plain_state: dict, param_groups: list) -> dict:
    """Inverse of ``plain_optimizer_state`` for this rank: its FSDP shard
    optimizer ``state_dict`` from a plain run's, each per-element state cut
    to this rank's TP shard first."""
    meta, d = model.meta, model.data_index
    tp = axis_index(meta.tp_axis) if meta.n_tp > 1 else 0
    by_name = {n: plain_state["state"].get(i, {}) for i, n in enumerate(_plain_names(meta))}
    out = {}
    specs = [(meta.layer, f"layers.{i}.") for i in range(meta.L)] + [(meta.rest, "")]
    for idx, (spec, prefix) in enumerate(specs):
        first = by_name[prefix + spec.items[0].name]
        state = {}
        for key, v in first.items():
            if v.dim() == 0:
                state[key] = v.clone()
                continue
            whole = {it.name: by_name[prefix + it.name][key] for it in spec.items}
            flat = spec.flatten(shard_state_dict_tp(whole, tp, meta.n_tp))
            state[key] = flat[d * spec.chunk : (d + 1) * spec.chunk].clone()
        if state:
            out[idx] = state
    return {"state": out, "param_groups": param_groups}
