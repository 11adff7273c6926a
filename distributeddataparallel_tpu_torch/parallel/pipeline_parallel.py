"""Pipeline parallelism: GPipe, 1F1B and zero-bubble over a ``pipe`` mesh axis.

Counterpart of ``distributeddataparallel_tpu/parallel/pipeline_parallel.py``.
Stage ``s`` of ``n`` holds ``L / n`` layers of the model and the replicated
leaves: the token embedding, the positional embedding, ``final_norm`` and
``lm_head``.  With ``virtual`` = 1 its layers are ``[s L/n, (s+1) L/n)``
(the leading-dim slice of the reference's stacked layout,
``pp_param_specs``); with ``v`` virtual chunks (interleaved 1F1B, Megatron-LM
arXiv 2104.04473 §2.3) it owns the round-robin chunks ``{s, s+n, ...,
s+(v-1)n}`` of ``L/(n v)`` layers each, stored chunk-major
(``interleave_layer_perm``, the reference's ``shard_state_pp(virtual=v)``
placement).  ``StageLM`` is the model's own ``TransformerLM`` cut to those
layers: stage 0 embeds with its ``embed``, every stage runs its ``blocks``
(the model's ``DecoderBlock``s, checkpointed under ``remat``; ``chunk=c``
runs chunk c's), stage n-1 applies its ``head`` and the loss.  A step
splits the rank's rows into M microbatches (``inputs.reshape(M, B/M, S)``)
and passes each microbatch's activations (in ``cfg.dtype``) to the next
stage and its cotangent back, point to point over the ``pipe`` group
(``_Pipe``).

- GPipe (``pp_loss`` in the reference): every forward, then every backward
  in reverse order; each microbatch's graph lives until its backward.
- 1F1B (``_pp_1f1b_loss_and_grads``): ``n - s - 1`` warm-up forwards, then
  one forward and one backward in turn, then the cool-down backwards
  (Megatron-LM's schedule, §2.2).  A forward unit runs without gradients
  and keeps only the stage's input; the backward unit runs the stage
  forward again under autograd (stage-granular checkpointing, the
  reference's recompute in its B tick), so at most ``n - s`` microbatches
  are held, whatever M.  The last stage's forward unit keeps its input
  only: its backward unit, which comes next, runs the stage forward with
  gradients.  In the steady state a stage's send and the receive it waits
  for go in one ``batch_isend_irecv`` (``send_forward_recv_backward``), so
  neighbours never both block on a send.
- Interleaved 1F1B (``virtual`` > 1): the unit is a (chunk, microbatch)
  pair in the reference's order (``_decode_unit``): groups of n
  microbatches, chunk-major for the forwards and reverse chunk-major for
  the backwards; a unit whose microbatch is >= M is skipped on every stage
  alike (no ``M % n`` is needed).  Every stage runs the reference's tick
  table: at tick t the forward of unit ``t - s``, then the backward of unit
  ``t - (v n - 1) - (n - 1 - s)``, then one exchange with both neighbours
  carrying what the next tick needs.  Chunk c's output leaves stage n-1
  for chunk c+1 on stage 0, and its cotangent goes back the other way (the
  wrap link).  Each unit holds only its chunk's input, as in 1F1B.
- Zero-bubble (``schedule="zb"``, the reference's ZB-H1 rendering at
  deferral depth 0; arXiv 2401.10241): each backward unit is B, the
  cotangent of the stage input (sent upstream at once), then W, the
  layers' weight gradients, in the same unit after B's send.  B runs the
  backward once with every dense product's weight-gradient GEMM queued
  (``models.transformer.WeightGradStore``: the operands ``x`` and ``dy``
  it already has); W runs the queue.  The norms, the biases, the
  embeddings, the MoE router and expert stacks keep their gradients in B;
  under remat the checkpoint's recompute happens inside B.  Every schedule
  routes the dense products through the store (deferring only under zb),
  so zb's gradients are 1F1B's bit for bit.  With or without ``virtual``.

The loss is the last stage's microbatch losses summed over the pipe and
divided by M; with MoE and ``moe_aux_weight`` > 0 it adds ``moe_aux_weight
x (the pipe sum of each stage chunk's per-microbatch aux terms) / (n v M)``,
each aux term's cotangent that constant (reference ``:1068-1115``,
``:475-480``).  After the schedule the replicated leaves' gradients are
summed over the pipe (only stages 0 and n-1 contribute; GPT-2's tied
embedding gets both); under CP the gradients and the metrics are then
averaged over the ``seq`` group (each rank's loss saw its chunk of the
sequence); then the data-parallel mean, or ZeRO-1 over ``data`` on the
stage-local layout, then the clip, whose norm sums the layer slices over the
pipe (and the model and expert axes) and counts the replicated leaves once.

TP, EP and CP compose inside a stage (the blocks' own collectives over the
``model`` / ``expert`` / ``seq`` groups; every seq peer of a stage runs the
same units, so the ring's exchanges pair up).  Under CP a stage embeds and
attends at its chunk's global positions (``context_parallel.cp_positions``)
and the pipe carries ``(B/M, S/n_cp, d_model)``.  ``run_schedule`` takes a
``seq`` exchange object (``context_parallel``'s members) for stages that
are threads of one process; without it the ``cp_axis`` group is used.
Refused, as the reference refuses them: zb with ``cp_axis`` or the MoE aux
loss, virtual stages under GPipe, dropout, and pipelined eval under CP.
The tick arithmetic (``_1f1b_ticks``, ``_zb_segments``,
``pp_bubble_fraction``) is the reference's: it counts, and the 1F1B and zb
steps' ``pp_phase_counts`` must equal its table.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re

import torch
import torch.distributed as dist
from torch import nn

from distributeddataparallel_tpu_torch.analysis.rules import ANY_COLLECTIVE, collective_manifest
from distributeddataparallel_tpu_torch.analysis.schedule_lint import (
    gpipe_schedule_ir,
    one_f_one_b_schedule_ir,
    zb_schedule_ir,
)
from distributeddataparallel_tpu_torch.models import transformer as tfm
from distributeddataparallel_tpu_torch.ops.losses import (
    accuracy,
    lm_cross_entropy,
    per_example_accuracy,
    per_example_cross_entropy,
)
from distributeddataparallel_tpu_torch.parallel.context_parallel import cp_positions, group_coords
from distributeddataparallel_tpu_torch.parallel.data_parallel import (
    all_reduce_gradients,
    clip_scale,
    group_active,
    metric_pack,
    sumsq_f32,
)
from distributeddataparallel_tpu_torch.parallel.expert_parallel import ep_dim
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import tp_dim
from distributeddataparallel_tpu_torch.runtime.distributed import (
    DATA_AXIS,
    PIPE_AXIS,
    axis_group,
    axis_index,
    axis_size,
    current_mesh,
)

SCHEDULES = ("gpipe", "1f1b", "zb")


# --- the tick arithmetic (the reference's, for every schedule) -----------

def _1f1b_ticks(n: int, M: int, v: int) -> tuple[int, int]:
    """(last valid unit index, scan length T) of the reference's 1F1B
    schedule: THE tick arithmetic its bubble accounting shares."""
    j_last = ((M - 1) // n) * n * v + (v - 1) * n + (M - 1) % n
    return j_last, j_last + v * n + n - 1


def _zb_segments(n: int, M: int, v: int) -> tuple[int, int, int, int]:
    """(warmup, steady, drain, f_end) tick-segment lengths of the
    reference's zero-bubble schedule."""
    j_last, T = _1f1b_ticks(n, M, v)
    warm = v * n - 1
    f_end = j_last + n
    return warm, f_end - warm, T - f_end, f_end


def _decode_unit(j: int, n: int, v: int, M: int):
    """Unit index -> (chunk, microbatch), or None when the unit is off the
    schedule (the reference's ``_decode_unit``): groups of n microbatches
    cycle chunk-major."""
    if j < 0:
        return None
    g, r = divmod(j, n * v)
    m = g * n + r % n
    return None if m >= M else (r // n, m)


def pp_bubble_fraction(n: int, microbatches: int, virtual: int = 1, schedule: str = "1f1b") -> dict:
    """The reference's slot accounting of a schedule's bubble: useful
    unit-slots over the slot capacity of its tick table (1F1B: ``2 M v`` of
    ``2 T``; zb: ``3 M v`` of ``3 (j_last + n)``)."""
    M, v = microbatches, virtual
    j_last, T = _1f1b_ticks(n, M, v)
    if schedule == "zb":
        warm, steady, drain, f_end = _zb_segments(n, M, v)
        useful, total = 3 * M * v, 3 * f_end
        return {
            "n_stages": n, "microbatches": M, "virtual": v, "schedule": "zb", "ticks": T,
            "segments": {"warmup": warm, "steady": steady, "drain": drain},
            "slot_windows": {"F": (0, f_end), "B": (v * n - 1, T), "W": (v * n - 1, T)},
            "useful_slots": useful, "slot_capacity": total,
            "bubble_fraction": round((total - useful) / total, 4),
            "bubble_stage_units": round((total - useful) / (3 * v), 4),
        }
    useful, total = 2 * M * v, 2 * T
    return {
        "n_stages": n, "microbatches": M, "virtual": v, "schedule": "1f1b", "ticks": T,
        "slot_windows": {"F": (0, T), "B": (0, T)},
        "useful_slots": useful, "slot_capacity": total,
        "bubble_fraction": round((total - useful) / total, 4),
        "bubble_stage_units": round((total - useful) / (2 * v), 4),
    }


# --- the stage's parameters ----------------------------------------------

_LAYER = re.compile(r"^layers\.(\d+)\.")


def interleave_layer_perm(num_layers: int, n: int, virtual: int) -> list[int]:
    """Storage order of the layers for ``virtual`` chunks a stage (the
    reference's ``interleave_layer_perm``): ``stored = logical[perm]``, each
    stage's ``L/n`` rows its chunks ``s, s+n, ..., s+(v-1)n`` in chunk-major
    order, stage after stage."""
    Lc = num_layers // (n * virtual)
    return [(c * n + s) * Lc + i for s in range(n) for c in range(virtual) for i in range(Lc)]


def stage_layers(num_layers: int, n: int, stage: int, virtual: int = 1) -> list[int]:
    """The global indices of stage ``stage``'s layers, in its storage
    order (chunk-major under ``virtual``)."""
    if num_layers % (n * virtual):
        raise ValueError(f"pipeline: num_layers {num_layers} not divisible by {n} stages"
                         + (f" x {virtual} virtual chunks" if virtual > 1 else ""))
    per = num_layers // n
    return interleave_layer_perm(num_layers, n, virtual)[stage * per : (stage + 1) * per]


def _layer_count(state_dict: dict) -> int:
    return 1 + max((int(m.group(1)) for k in state_dict if (m := _LAYER.match(k))), default=-1)


def shard_state_dict_pp(state_dict: dict, stage: int, n: int, virtual: int = 1) -> dict:
    """Stage ``stage``'s part of a whole LM ``state_dict``: its layers in
    storage order, renumbered from 0, and every replicated leaf (the
    reference's ``shard_state_pp`` for one position)."""
    local = {g: i for i, g in enumerate(stage_layers(_layer_count(state_dict), n, stage, virtual))}
    out = {}
    for k, t in state_dict.items():
        m = _LAYER.match(k)
        if m is None:
            out[k] = t
        elif int(m.group(1)) in local:
            out[f"layers.{local[int(m.group(1))]}.{k[m.end():]}"] = t
    return out


def merge_pp_shards(shards: list[dict], virtual: int = 1) -> dict:
    """Inverse of ``shard_state_dict_pp``: the whole ``state_dict`` in
    logical layer order from every stage's part, in stage order (the
    replicated leaves from stage 0)."""
    out = {k: t for k, t in shards[0].items() if not _LAYER.match(k)}
    L, layers = sum(_layer_count(sd) for sd in shards), {}
    for s, sd in enumerate(shards):
        mine = stage_layers(L, len(shards), s, virtual)
        for k, t in sd.items():
            if m := _LAYER.match(k):
                layers.setdefault(mine[int(m.group(1))], []).append((k[m.end():], t))
    for i in sorted(layers):
        out.update((f"layers.{i}.{rest}", t) for rest, t in layers[i])
    return out


def is_replicated(name: str) -> bool:
    """Is parameter ``name`` on every stage (not a layer's)?"""
    return _LAYER.match(name) is None


def _check_config(cfg: tfm.TransformerConfig) -> None:
    """The reference's checks of a pipelined config (``:337``, ``:1007``)."""
    if not cfg.scan_layers:
        raise ValueError("pipeline parallelism requires scan_layers=True")
    if cfg.dropout_rate:
        raise ValueError("pipeline v1 does not support dropout")


def stage_config(cfg: tfm.TransformerConfig, n: int, virtual: int = 1) -> tfm.TransformerConfig:
    """The config of one of ``n`` stages: ``L / n`` layers."""
    _check_config(cfg)
    return dataclasses.replace(cfg, num_layers=len(stage_layers(cfg.num_layers, n, 0, virtual)))


class StageLM(tfm.TransformerLM):
    """Stage ``stage`` of ``n_stages``: a ``TransformerLM`` of the stage's
    ``L / n`` layers (in storage order, renumbered from 0) with every
    replicated leaf; ``virtual`` chunks of ``L / (n v)`` layers.  The
    schedules call its ``embed``, ``blocks`` and ``head``; ``full_cfg`` is
    the whole model's config."""

    def __init__(self, cfg: tfm.TransformerConfig, stage: int, n_stages: int, *, virtual: int = 1, device=None,
                 generator=None):
        super().__init__(stage_config(cfg, n_stages, virtual), device=device, generator=generator)
        self.full_cfg, self.stage, self.n_stages, self.virtual = cfg, stage, n_stages, virtual

    def blocks(self, x, positions=None, dropout_seed=None, *, chunk: int | None = None, seq=None):
        """The blocks of chunk ``chunk`` (all of the stage's by default)."""
        layers = self.layers
        if chunk is not None:
            per = len(layers) // self.virtual
            layers = layers[chunk * per : (chunk + 1) * per]
        return super().blocks(x, positions, dropout_seed, layers=layers, seq=seq)

    def forward(self, *args, **kwargs):
        raise TypeError("a pipeline stage runs through make_pp_train_step / make_pp_eval_step")


def stage_model(cfg, full_state_dict: dict, stage: int, n: int, *, virtual: int = 1, device=None) -> StageLM:
    """Stage ``stage`` of ``n`` (``virtual`` chunks) with its part of
    ``full_state_dict``."""
    model = StageLM(cfg, stage, n, virtual=virtual, device=device)
    model.load_state_dict(shard_state_dict_pp(full_state_dict, stage, n, virtual))
    return model


# --- the exchange --------------------------------------------------------

class _Pipe:
    """A stage's point-to-point exchange with its neighbours over the pipe
    group.  ``stage`` and ``n`` are its place; ``wrap`` (virtual stages)
    joins stage n-1 to stage 0, so every stage has both neighbours.  The
    six methods are the 1F1B and GPipe schedules' (Megatron-LM's names): a
    first or last stage's missing neighbour makes its sends no-ops and its
    receives None.  ``exchange`` is the tick's: any of the four transfers,
    the receives returned as ``(from_prev, from_next)``.  Each call posts
    its sends and receives in one ``batch_isend_irecv`` and waits for them.
    ``like`` (shape, dtype, device) sizes the receive buffers; the schedules
    set it per step.  Any object with these members can stand in (stages as
    threads of one process)."""

    def __init__(self, group, stage: int, n: int, wrap: bool = False):
        self.group, self.stage, self.n = group, stage, n
        glob = (lambda i: i) if group is None else (lambda i: dist.get_global_rank(group, i))
        self.prev = glob((stage - 1) % n) if stage > 0 or wrap else None
        self.next = glob((stage + 1) % n) if stage < n - 1 or wrap else None
        self.like = None
        self._warm = False

    def _buf(self):
        shape, dtype, device = self.like
        return torch.empty(shape, dtype=dtype, device=device)

    def exchange(self, send_next=None, send_prev=None, recv_prev=False, recv_next=False):
        if not self._warm:
            # A group's first batch_isend_irecv must involve every rank of it
            # (NCCL): one all-reduce over the pipe group comes first.
            dist.all_reduce(torch.zeros(1, device=self.like[2]), group=self.group)
            self._warm = True
        # NCCL pairs two ranks' point-to-point messages by posting order
        # alone (no tags), and with the wrap at n = 2 a stage's prev and next
        # are one peer, with activations and cotangents of one shape: so
        # every stage posts in one order, the activation (forward direction)
        # before the cotangent, for its sends (to next, then to prev) and
        # for its receives (from prev, then from next).  A peer's two
        # messages then meet in the same order on both sides.
        ops, got = [], {}
        if send_next is not None:
            ops.append(dist.P2POp(dist.isend, send_next.contiguous(), self.next, self.group))
        if send_prev is not None:
            ops.append(dist.P2POp(dist.isend, send_prev.contiguous(), self.prev, self.group))
        if recv_prev:
            got["prev"] = self._buf()
            ops.append(dist.P2POp(dist.irecv, got["prev"], self.prev, self.group))
        if recv_next:
            got["next"] = self._buf()
            ops.append(dist.P2POp(dist.irecv, got["next"], self.next, self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return got.get("prev"), got.get("next")

    def recv_forward(self):
        return None if self.prev is None else self.exchange(recv_prev=True)[0]

    def send_forward(self, y) -> None:
        if self.next is not None:
            self.exchange(send_next=y)

    def recv_backward(self):
        return None if self.next is None else self.exchange(recv_next=True)[1]

    def send_backward(self, dx) -> None:
        if self.prev is not None:
            self.exchange(send_prev=dx)

    def send_forward_recv_backward(self, y):
        return None if self.next is None else self.exchange(send_next=y, recv_next=True)[1]

    def send_backward_recv_forward(self, dx):
        return None if self.prev is None else self.exchange(send_prev=dx, recv_prev=True)[0]


# --- the schedules -------------------------------------------------------

@dataclasses.dataclass
class StageRun:
    """One stage's results of a schedule: the sums over its microbatches of
    the loss and the accuracy (last stage; 0 elsewhere) and of its aux
    terms (tensors on the device), its executed [F, B, W] units, and the
    most units it held between their forward and their backward."""
    loss_sum: torch.Tensor
    acc_sum: torch.Tensor
    aux_sum: torch.Tensor
    counts: list
    max_held: int


@contextlib.contextmanager
def _weight_grad_store(stage: StageLM, store: tfm.WeightGradStore):
    """``store`` on every dense product of the stage for the block."""
    dense = [m for m in stage.modules() if isinstance(m, nn.Linear)]
    for m in dense:
        m.weight_grad_store = store
    try:
        yield
    finally:
        for m in dense:
            del m.weight_grad_store


def _seq_sharding(cfg, seq, S: int, device):
    """(global positions of this rank's chunk or None, the seq axis size)
    under CP: over ``seq`` when given, else the ``cp_axis`` group."""
    over = seq if seq is not None else axis_group(cfg.cp_axis) if axis_size(cfg.cp_axis) > 1 else None
    if over is None:
        return None, 1
    return cp_positions(S, over, device=device), group_coords(over)[1]


def run_schedule(stage: StageLM, pipe, inputs, targets, *, microbatches: int, schedule: str = "gpipe",
                 moe_aux_weight: float = 0.0, seq=None) -> StageRun:
    """Stage ``stage``'s part of one pipelined forward and backward over
    ``inputs`` / ``targets`` (B, S: this rank's chunk of the sequence under
    CP) through ``pipe``: the gradients of ``sum_m loss_m / M`` (+ the aux
    term) accumulate in the stage's ``.grad`` buffers.  ``schedule``:
    ``"gpipe"``, ``"1f1b"`` or ``"zb"``, interleaved when the stage has
    virtual chunks.  ``seq``: the sequence-parallel exchange object (module
    docstring)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    M, n, s, v = microbatches, stage.n_stages, stage.stage, stage.virtual
    if v > 1 and schedule == "gpipe":
        raise ValueError("virtual (interleaved) stages require schedule='1f1b' — the GPipe path runs whole "
                         "contiguous stages")
    B, S = inputs.shape
    if B % M:
        raise ValueError(f"per-replica batch {B} is not divisible by {M} microbatches")
    cfg = stage.cfg
    positions, n_cp = _seq_sharding(cfg, seq, S, inputs.device)
    if S * n_cp > cfg.max_seq_len:
        raise ValueError(f"global seq len {S * n_cp} > max_seq_len {cfg.max_seq_len}")
    ins, tgts = inputs.reshape(M, B // M, S), targets.reshape(M, B // M, S)
    pipe.like = ((B // M, S, cfg.d_model), cfg.dtype, inputs.device)
    first, last = s == 0, s == n - 1
    use_aux = cfg.moe_experts > 0 and moe_aux_weight > 0
    if use_aux and schedule == "zb":
        raise ValueError("zb schedule does not support the MoE aux loss")
    aux_grad = moe_aux_weight / (n * v * M)
    zero = torch.zeros((), device=inputs.device)
    run = StageRun(zero, zero, zero, [0, 0, 0], 0)
    store = tfm.WeightGradStore(defer=schedule == "zb")

    def body(x, chunk=None):
        """The chunk's blocks on ``x``: ``(y, aux)``, aux the mean of its
        layers' load-balance terms (None without MoE; ref
        ``moe_aux_from_intermediates`` over the chunk's slice)."""
        y, auxes = stage.blocks(x, positions, chunk=chunk, seq=seq)
        return y, (sum(auxes) / len(auxes) if auxes else None)

    def embed(m):
        return stage.embed(ins[m], positions)

    def output(m, y):
        """The microbatch loss (its sums kept) from the last chunk's y."""
        logits = stage.head(y)
        loss = lm_cross_entropy(logits, tgts[m])
        run.loss_sum = run.loss_sum + loss.detach()
        run.acc_sum = run.acc_sum + accuracy(logits, tgts[m]).detach()
        return loss

    def backward(x, out, aux, dy, head: bool, embedded: bool):
        """A unit's backward through its graph (``out`` from input x: the
        loss for the model's last chunk, y elsewhere, which takes the
        cotangent dy); returns the cotangent of x (None for an embedded x).
        Under zb this is B: the weight-gradient GEMMs wait in ``store``."""
        outs, grads = [out], [torch.full_like(out, 1.0 / M) if head else dy]
        if use_aux:
            run.aux_sum = run.aux_sum + aux.detach()
            outs.append(aux)
            grads.append(torch.full_like(aux, aux_grad))
        torch.autograd.backward(outs, grads)
        run.counts[1] += 1
        return None if embedded else x.grad

    def weight_unit():
        """W: the unit's queued weight gradients (zb only)."""
        if store.defer:
            store.flush()
            run.counts[2] += 1

    with _weight_grad_store(stage, store):
        if schedule == "gpipe":
            _gpipe(run, pipe, M, first, last, body, embed, output, backward)
        elif v == 1:
            _one_f_one_b(run, pipe, M, n, s, body, embed, output, backward, weight_unit)
        else:
            _interleaved(run, pipe, M, n, s, v, body, embed, output, backward, weight_unit)
    return run


def _gpipe(run, pipe, M, first, last, body, embed, output, backward) -> None:
    held = []
    for m in range(M):
        x = embed(m) if first else pipe.recv_forward().requires_grad_()
        y, aux = body(x)
        if not last:
            pipe.send_forward(y.detach())
        held.append((x, output(m, y) if last else y, aux))
        run.counts[0] += 1
    run.max_held = len(held)
    for _ in range(M):
        x, out, aux = held.pop()
        pipe.send_backward(backward(x, out, aux, None if last else pipe.recv_backward(), last, first))


def _one_f_one_b(run, pipe, M, n, s, body, embed, output, backward, weight_unit) -> None:
    """Megatron-LM's 1F1B (module docstring); zb's W after each B's send."""
    first, last = s == 0, s == n - 1
    stored = collections.deque()  # the held microbatches' stage inputs, oldest first
    nxt = {"f": 0, "b": 0}

    def forward_unit(received):
        m = nxt["f"]
        nxt["f"] += 1
        stored.append(received)
        run.counts[0] += 1
        run.max_held = max(run.max_held, len(stored))
        if last:  # its backward unit, next, runs the stage forward with gradients
            return None
        with torch.no_grad():
            return body(embed(m) if first else received)[0]

    def backward_unit(dy):
        m = nxt["b"]
        nxt["b"] += 1
        received = stored.popleft()
        x = embed(m) if first else received.requires_grad_()
        y, aux = body(x)
        return backward(x, output(m, y) if last else y, aux, dy, last, first)

    warm = min(n - s - 1, M)
    rest = M - warm
    for _ in range(warm):
        pipe.send_forward(forward_unit(pipe.recv_forward()))
    received = pipe.recv_forward() if rest else None
    for i in range(rest):
        dy = pipe.send_forward_recv_backward(forward_unit(received))
        dx = backward_unit(dy)
        if i == rest - 1:
            pipe.send_backward(dx)
        else:
            received = pipe.send_backward_recv_forward(dx)
        weight_unit()
    for _ in range(warm):
        pipe.send_backward(backward_unit(pipe.recv_backward()))
        weight_unit()


def _interleaved(run, pipe, M, n, s, v, body, embed, output, backward, weight_unit) -> None:
    """The reference's tick table for ``v`` chunks a stage (module
    docstring).  A transfer at the end of tick t is what a neighbour's unit
    at tick t+1 needs; both sides derive it from the same unit, so every
    send meets its receive in the same tick's exchange."""
    first, last = s == 0, s == n - 1
    _, T = _1f1b_ticks(n, M, v)

    def f_unit(t):
        return _decode_unit(t - s, n, v, M)

    def b_unit(t):
        u = _decode_unit(t - (v * n - 1) - (n - 1 - s), n, v, M)
        return None if u is None else (v - 1 - u[0], u[1])

    held = {}  # (chunk, microbatch) -> the unit's received input (None: embedded)
    from_prev = from_next = None
    for t in range(T):
        y = dx = None
        if (f := f_unit(t)) is not None:
            c, m = f
            held[f] = None if first and c == 0 else from_prev
            run.counts[0] += 1
            run.max_held = max(run.max_held, len(held))
            if not (last and c == v - 1):  # the model's last chunk: its backward unit runs it
                with torch.no_grad():
                    y = body(embed(m) if held[f] is None else held[f], c)[0]
        if (b := b_unit(t)) is not None:
            c, m = b
            received = held.pop(b)
            x = embed(m) if received is None else received.requires_grad_()
            yb, aux = body(x, c)
            head = last and c == v - 1
            dx = backward(x, output(m, yb) if head else yb, aux, None if head else from_next, head, received is None)
        nf, nb = f_unit(t + 1), b_unit(t + 1)
        from_prev, from_next = pipe.exchange(
            send_next=y, send_prev=dx,
            recv_prev=nf is not None and not (first and nf[0] == 0),
            recv_next=nb is not None and not (last and nb[0] == v - 1))
        if b is not None:
            weight_unit()


# --- the train and eval steps --------------------------------------------

class _Groups:
    """The step's process groups, resolved from the current mesh when the
    step first runs."""

    def __init__(self, cfg):
        mesh = current_mesh()
        if mesh is None or PIPE_AXIS not in mesh.axes:
            raise ValueError(f"pipeline parallelism needs a mesh with the {PIPE_AXIS!r} axis "
                             f"(runtime.distributed.make_mesh)")
        self.n, self.stage = axis_size(PIPE_AXIS), axis_index(PIPE_AXIS)
        self.pipe = axis_group(PIPE_AXIS)
        self.data = axis_group(DATA_AXIS) if DATA_AXIS in mesh.axes else None
        self.n_seq = axis_size(cfg.cp_axis)
        self.seq = axis_group(cfg.cp_axis) if self.n_seq > 1 else None
        self.model = axis_group(cfg.tp_axis) if axis_size(cfg.tp_axis) > 1 else None
        self.expert = axis_group(cfg.ep_axis) if axis_size(cfg.ep_axis) > 1 else None


def _check_stage(model, g: _Groups, virtual: int = 1) -> None:
    if not isinstance(model, StageLM) or (model.stage, model.n_stages, model.virtual) != (g.stage, g.n, virtual):
        raise ValueError(f"the model must be StageLM stage {g.stage} of {g.n}"
                         + (f" with {virtual} virtual chunks" if virtual > 1 else "")
                         + " (pipeline_parallel.stage_model)")


def _pipe_complete(state, g: _Groups) -> None:
    """Sum the replicated leaves' gradients over the pipe, in place (under
    ZeRO, their ranges of the flat gradient buffer)."""
    if not group_active(g.pipe):
        return
    replicated = [p for k, p in state.model.named_parameters() if is_replicated(k)]
    if state.zero is not None:
        ids = {id(p) for p in replicated}
        for pc in state.zero.pieces:
            if id(pc.param) in ids:
                dist.all_reduce(state.zero.grad[pc.offset : pc.offset + pc.param.numel()], group=g.pipe)
        return
    for p in replicated:
        dist.all_reduce(p.grad, group=g.pipe)


def pp_sumsq(model, g: _Groups) -> torch.Tensor:
    """The global sum of squares of the synced gradients: each stage's
    layer leaves summed over the pipe (their TP / expert shards over the
    ``model`` / ``expert`` groups first), the replicated leaves (equal on
    every stage once completed) counted once (ref ``model_axes_sumsq``)."""
    named = [(k, p.grad) for k, p in model.named_parameters()]
    device = named[0][1].device
    f32 = lambda gs: torch.as_tensor(sumsq_f32(gs), dtype=torch.float32, device=device)
    layers = [(k, t) for k, t in named if not is_replicated(k)]
    total = f32([t for k, t in layers if tp_dim(k) is None and ep_dim(k) is None])
    for group, on in ((g.model, tp_dim), (g.expert, ep_dim)):
        part = f32([t for k, t in layers if on(k) is not None])
        if group is not None:
            dist.all_reduce(part, group=group)
        total = total + part
    if group_active(g.pipe):
        dist.all_reduce(total, group=g.pipe)
    return total + f32([t for k, t in named if is_replicated(k)])


def make_pp_train_step(cfg, *, microbatches: int, schedule: str = "gpipe", zero: bool | int = False,
                       grad_clip: float | None = None, moe_aux_weight: float = 0.0, virtual: int = 1):
    """Build ``step(state, batch[, seed]) -> metrics`` for DP x PP (x TP,
    EP or CP inside the stages): ``state.model`` is this rank's ``StageLM``
    (``stage_model(..., virtual=)``), or ZeRO-1's state over it
    (``zero_state(..., pp_axis=...)``), and ``batch = {"tokens": (B, S +
    1)}`` this data replica's rows (the same on every stage of its pipe
    line), or under CP ``{"inputs", "targets"}``: its chunk of the sequence
    with the next-token shift made on the host (``DataLoader(seq_shard=)``);
    ``B`` divisible by ``microbatches``.

    The metrics are the loss, the accuracy (the last stage's, over its
    microbatches) and with MoE ``moe_aux``, means over the seq and data
    ranks; under 1F1B and zb also ``pp_phase_counts``, the ``(n, 3)`` [F, B,
    W] table of units each stage ran (the reference's, gathered over the
    pipe).  ``step.last`` is this stage's ``StageRun`` of the last step;
    ``step.bubble_accounting`` is ``pp_bubble_fraction(n, M, virtual,
    schedule)`` under 1F1B and zb (None under GPipe, as the reference)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if virtual < 1:
        raise ValueError(f"virtual must be >= 1, got {virtual}")
    if virtual > 1 and schedule == "gpipe":
        raise ValueError("virtual (interleaved) stages require schedule='1f1b' — the GPipe path runs whole "
                         "contiguous stages")
    if schedule == "zb":
        if cfg.cp_axis is not None:
            raise ValueError("zb schedule does not compose with cp_axis yet — use schedule='1f1b' for "
                             "context-parallel pipelines")
        if cfg.moe_experts > 0 and moe_aux_weight > 0.0:
            raise ValueError("zb schedule does not support the MoE aux loss (the B/W split has no aux "
                             "cotangent path) — set moe_aux_weight=0.0 or use schedule='1f1b'")
    zero_level = int(zero)
    if zero_level not in (0, 1):
        raise ValueError("pipeline parallelism composes with zero=1 only (the reference's rule)")
    _check_config(cfg)
    M = microbatches
    resolved: list[_Groups] = []
    exchanges: dict = {}

    def step(state, batch: dict, seed=None) -> dict:
        if not resolved:
            resolved.append(_Groups(cfg))
        g = resolved[0]
        model = state.model
        _check_stage(model, g, virtual)
        if zero_level and state.zero is None:
            raise ValueError("zero=1 needs a state from parallel.zero.zero_state(pp_axis=...)")
        ex = exchanges.setdefault(id(model), _Pipe(g.pipe, g.stage, g.n, wrap=virtual > 1))
        model.train()
        if state.zero is not None:
            state.zero.prepare_grads()
        else:
            for p in model.parameters():
                p.grad = None
        if "inputs" in batch:
            inputs, targets = batch["inputs"], batch["targets"]
        else:
            inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        run = run_schedule(model, ex, inputs, targets, microbatches=M, schedule=schedule,
                           moe_aux_weight=moe_aux_weight)
        step.last = run
        for p in model.parameters():
            if p.grad is None:  # a leaf this stage does not use: a zero gradient
                p.grad = torch.zeros_like(p)
        # The metrics and the unit counts in one pipe sum: the loss and the
        # accuracy from the last stage, every stage's aux terms and counts.
        vec = metric_pack(torch.zeros(3 + 3 * g.n, device=inputs.device))
        vec[0], vec[1], vec[2] = run.loss_sum, run.acc_sum, run.aux_sum
        # The schedule's unit counts, filled from Python numbers: a copy from
        # host memory would wait for the device (the first step's too).
        for i, c in enumerate(run.counts):
            vec[3 + 3 * g.stage + i].fill_(c)
        if group_active(g.pipe):
            dist.all_reduce(vec, group=g.pipe)
        _pipe_complete(state, g)
        if g.seq is not None:
            # Each seq rank's loss saw its chunk: the seq mean completes the
            # gradients (model math, ref pmean over cp_axis), and the metrics.
            grads = [state.zero.grad] if state.zero is not None else [p.grad for p in model.parameters()]
            for t in grads + [metric_pack(vec[:3])]:
                dist.all_reduce(t, group=g.seq)
                t.div_(g.n_seq)
        if state.zero is not None:
            from distributeddataparallel_tpu_torch.parallel.zero import zero_update

            zero_update(state, grad_clip)
        else:
            all_reduce_gradients([p.grad for p in model.parameters()], group=g.data)
            if grad_clip is not None:
                scale = clip_scale(torch.sqrt(pp_sumsq(model, g)), grad_clip)
                for p in model.parameters():
                    p.grad.mul_(scale)
            state.apply_gradients()
        metrics = {"loss": vec[0] / M, "accuracy": vec[1] / M}
        if cfg.moe_experts:
            metrics["moe_aux"] = vec[2] / (g.n * virtual * M)
            metrics["loss"] = metrics["loss"] + moe_aux_weight * metrics["moe_aux"]
        if group_active(g.data):
            keys = list(metrics)
            means = metric_pack(torch.stack([metrics[k] for k in keys]))
            dist.all_reduce(means, group=g.data)
            metrics = dict(zip(keys, (means / dist.get_world_size(g.data)).unbind()))
        if schedule != "gpipe":
            # On the device: the train loop reads the first step's, once.
            metrics["pp_phase_counts"] = vec[3:].reshape(g.n, 3).to(torch.int64)
        return metrics

    step.last = None
    n_stages = axis_size(PIPE_AXIS)
    step.bubble_accounting = (None if schedule == "gpipe"
                              else pp_bubble_fraction(n_stages, M, virtual, schedule))
    # The manifest for the graph linter (the reference's,
    # ``pipeline_parallel.py:1255-1277``, in torch's names): the stage
    # boundary's sends on the pipe axis, the data-parallel reduction (ZeRO-1's
    # reduce-scatter and gather), anything inside a stage on its own axes.
    data = ({"reduce_scatter_tensor": (1, None), "all_gather_into_tensor": (1, None), "all_reduce": (0, None)}
            if zero_level else {"all_reduce": (1, None)})
    reduce = {DATA_AXIS: data, PIPE_AXIS: {"batch_isend_irecv": (1, None), "all_reduce": (0, None)}}
    for ax in (cfg.cp_axis, cfg.tp_axis, cfg.ep_axis):
        if ax is not None:
            reduce.setdefault(ax, ANY_COLLECTIVE)
    step.collective_manifest = collective_manifest("pp-zero" if zero_level else "pp", grad_reduce=reduce,
                                                   allow_f32_reduce=True)
    # Schedule-as-data for the SL3xx linter: the tick table this step claims
    # to run, rebuilt from the schedule's definition (not from the tick
    # arithmetic above; ``bubble_accounting`` is what SL304 compares).
    step.schedule_ir = (gpipe_schedule_ir(n_stages, M, hop_axis=PIPE_AXIS) if schedule == "gpipe" else
                        {"1f1b": one_f_one_b_schedule_ir, "zb": zb_schedule_ir}[schedule](
                            n_stages, M, virtual, hop_axis=PIPE_AXIS))
    return step


def make_pp_eval_step(cfg, *, microbatches: int):
    """Forward-only pipelined evaluation (the reference's
    ``make_pp_eval_step``): ``eval_step(model, batch) -> (means, count)``
    with ``make_eval_step``'s contract, ``batch = {"tokens": (B, S + 1),
    "valid": (B,)}``.  GPipe forwards over M microbatches, the rows padded
    with ``valid = 0`` up to a multiple of M; the last stage's masked sums
    of the per-row loss and accuracy are summed over the pipe and then over
    the data replicas.  Not under CP (the reference's refusal)."""
    _check_config(cfg)
    if cfg.cp_axis is not None:
        raise ValueError("pipelined eval does not support cp_axis")
    M = microbatches
    resolved: list[_Groups] = []
    exchanges: dict = {}

    @torch.no_grad()
    def eval_step(model, batch: dict):
        if not resolved:
            resolved.append(_Groups(cfg))
        g = resolved[0]
        _check_stage(model, g)
        ex = exchanges.setdefault(id(model), _Pipe(g.pipe, g.stage, g.n))
        model.eval()
        tokens, valid = batch["tokens"], batch["valid"].float()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        pad = (-inputs.shape[0]) % M
        if pad:  # a tail the microbatches do not divide: rows of weight 0
            inputs = torch.cat([inputs, inputs.new_zeros(pad, inputs.shape[1])])
            targets = torch.cat([targets, targets.new_zeros(pad, targets.shape[1])])
            valid = torch.cat([valid, valid.new_zeros(pad)])
        B, S = inputs.shape
        if S > model.cfg.max_seq_len:
            raise ValueError(f"global seq len {S} > max_seq_len {model.cfg.max_seq_len}")
        ex.like = ((B // M, S, model.cfg.d_model), model.cfg.dtype, inputs.device)
        sums = torch.zeros(3, device=inputs.device)
        for m, (x_in, tgt, v) in enumerate(zip(inputs.chunk(M), targets.chunk(M), valid.chunk(M))):
            x = model.embed(x_in) if g.stage == 0 else ex.recv_forward()
            y, _ = model.blocks(x)
            if g.stage < g.n - 1:
                ex.send_forward(y)
                continue
            logits = model.head(y)
            sums += torch.stack([(per_example_cross_entropy(logits, tgt) * v).sum(),
                                 (per_example_accuracy(logits, tgt) * v).sum(), v.sum()])
        for group in (g.pipe, g.data):
            if group_active(group):
                dist.all_reduce(sums, group=group)
        denom = sums[2].clamp(min=1.0)
        return {"loss": sums[0] / denom, "accuracy": sums[1] / denom}, sums[2]

    return eval_step
