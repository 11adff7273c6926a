"""Decoder-only transformer LM family: one stack, GPT-2 and Llama configs.

Counterpart of ``distributeddataparallel_tpu/models/transformer.py``.  One
``TransformerLM`` covers both families through ``TransformerConfig``:

==============  =====================  =========================
feature         GPT-2                  Llama-3
==============  =====================  =========================
norm            LayerNorm (pre-LN)     RMSNorm
positional      learned embeddings     RoPE (theta 500000)
MLP             GELU (tanh), 4×d       SwiGLU, 3 mats
attention       MHA                    GQA (8 kv heads)
embeddings      tied in/out            untied
==============  =====================  =========================

Params are f32; activations and matmuls run in ``cfg.dtype``; norms are
computed in f32.  The logits are the f32 product of ``cfg.dtype`` operands
(the reference's ``preferred_element_type=float32``), not a ``cfg.dtype``
product cast up.  Attention goes through ``ops.attention.attention`` (the
flash kernels for CUDA tensors).

- ``remat``: each block runs under ``torch.utils.checkpoint`` while
  gradients are recorded (the reference's ``nn.remat``), so its
  activations are recomputed in the backward; the forward runs twice.
- ``dropout_rate``: the embedding output and each residual branch are
  dropped in training (``ops.dropout``), from a seed that the caller
  passes per step (``forward(dropout_seed=...)``) and that is folded per
  layer and site; a checkpointed block's recompute draws the same masks.
- ``scan_layers``: PyTorch has no scan, so the layers are a loop either
  way; the flag selects the reference's stacked ``layers/block`` parameter
  layout in ``models.io`` (and, for int8 serving, its per-layer scales).
- ``decode``: the KV-cache twin (``models.generate`` builds it).  The
  caller passes global ``positions`` and the cache, a per-layer list of
  ``(k, v)`` tensors of shape ``(B, max_seq_len, kv_heads, head_dim)``
  that each layer writes in place: contiguous ``(S,)`` positions insert at
  ``positions[0]`` (clamped as XLA's ``dynamic_update_slice`` clamps) under
  the causal bias at that offset; per-row ``(B, S)`` positions scatter each
  row at its own positions under the bias ``kv_pos <= position[b, i]``.
  Attention is the plain f32-softmax ``dot_product_attention`` over the
  whole cache, as the reference's decode branch, never the flash kernels.
- ``quant_serving``: the decode forward takes an int8 tree
  (``ops.quant``, the reference's layout) and dequantizes one layer's
  matrices inside that layer's call, so only the int8 stack stays resident.

- ``tp_axis``: Megatron tensor parallelism over that axis of the current
  mesh (``parallel.tensor_parallel``): each rank holds ``H / tp`` query and
  ``Hkv / tp`` kv heads and ``d_ff / tp`` hidden units, ``copy_to_tp`` and
  ``reduce_from_tp`` sit where the reference puts them, and the row-parallel
  biases are added after the reduction.  Unbound (no mesh, or no such
  axis), the model has the full shapes.
- ``cp_axis``: the sequence is sharded over that axis: the model sees its
  rank's chunk, RoPE and learned positions use the chunk's global positions
  (``context_parallel.cp_positions``), attention is the ring or Ulysses
  (``cp_impl``), and the length guard checks the global length.
- ``moe_experts``: every block's MLP is a ``MoEMLP`` of that many experts,
  routed top-``moe_top_k``, dense or token-choice dispatch
  (``moe_capacity_factor``), on every path (remat, dropout, decode, TP with
  the experts replicated over ``model``, CP with each chunk routing its own
  tokens); ``forward(with_aux=True)`` also returns the load-balance term.
  ``ep_axis`` shards the experts over that axis
  (``parallel.expert_parallel``).
- ``forward`` is ``embed``, ``blocks`` and ``head`` in turn: a pipeline
  stage (``parallel.pipeline_parallel.StageLM``, a ``TransformerLM`` of its
  layers) calls them one by one, ``blocks`` over a run of its layers (a
  virtual chunk) and with the sequence-parallel exchange it was handed
  (``seq=``).  A schedule sets a ``WeightGradStore`` on the stage's dense
  layers (``weight_grad_store``): their products then run through
  ``_Dense``, whose weight gradients the zero-bubble schedule defers.

Config fields of the reference that this port does not run yet are kept so
configs carry over, and raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributeddataparallel_tpu_torch.ops.attention import (
    NEG_INF,
    apply_rope,
    attention,
    causal_mask_bias,
    dot_product_attention,
    repeat_kv,
    rope_frequencies,
)
from distributeddataparallel_tpu_torch.ops import moe
from distributeddataparallel_tpu_torch.ops.dropout import dropout, fold_seed
from distributeddataparallel_tpu_torch.parallel import context_parallel as cp
from distributeddataparallel_tpu_torch.parallel.expert_parallel import (
    ep_all_to_all,
    ep_shard_tokens,
    ep_unshard_tokens,
)
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import copy_to_tp, reduce_from_tp, tp_size
from distributeddataparallel_tpu_torch.runtime.distributed import axis_group, axis_index, axis_size


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    num_layers: int
    num_heads: int
    d_model: int
    d_ff: int
    max_seq_len: int
    num_kv_heads: int | None = None  # None -> MHA (= num_heads)
    head_dim: int | None = None      # None -> d_model // num_heads
    norm: str = "layernorm"          # "layernorm" | "rmsnorm"
    activation: str = "gelu"         # "gelu" | "swiglu"
    positional: str = "learned"      # "learned" | "rope"
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.float32  # activation/matmul dtype
    remat: bool = False
    scan_layers: bool = False
    attn_impl: str = "auto"          # "auto" | "plain" | "kernel"
    dropout_rate: float = 0.0
    use_bias: bool = True            # proj biases: GPT-2 yes, Llama no
    cp_axis: str | None = None
    cp_impl: str = "ring"            # "ring" | "ulysses"
    tp_axis: str | None = None
    decode: bool = False
    moe_experts: int = 0             # > 0: every block's MLP is a MoEMLP of this many experts
    moe_top_k: int = 1
    ep_axis: str | None = None
    moe_capacity_factor: float = 0.0  # 0: dense dispatch; > 0: token choice
    grad_sync_axis: str | None = None
    quant_serving: bool = False

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


# --- Named configs (sizes per the public GPT-2 / Llama-3 papers) ---------

def gpt2_124m(**overrides) -> TransformerConfig:
    """GPT-2 small: 12L/12H/768d, 4×d GELU MLP, 50257 vocab, tied embs."""
    base = dict(
        vocab_size=50257, num_layers=12, num_heads=12, d_model=768,
        d_ff=3072, max_seq_len=1024, norm="layernorm", activation="gelu",
        positional="learned", tie_embeddings=True,
    )
    base.update(overrides)
    return TransformerConfig(**base)


def llama3_8b(**overrides) -> TransformerConfig:
    """Llama-3 8B: 32L/32H(8kv)/4096d, 14336 SwiGLU, 128256 vocab, RoPE."""
    base = dict(
        vocab_size=128256, num_layers=32, num_heads=32, num_kv_heads=8,
        d_model=4096, d_ff=14336, max_seq_len=8192, norm="rmsnorm",
        activation="swiglu", positional="rope", rope_theta=500000.0,
        tie_embeddings=False, dtype=torch.bfloat16, remat=True,
        scan_layers=True, use_bias=False,
    )
    base.update(overrides)
    return TransformerConfig(**base)


def tiny_lm(**overrides) -> TransformerConfig:
    """Test-sized config."""
    base = dict(
        vocab_size=256, num_layers=2, num_heads=2, d_model=32, d_ff=64,
        max_seq_len=128, norm="rmsnorm", activation="swiglu",
        positional="rope", tie_embeddings=True,
    )
    base.update(overrides)
    return TransformerConfig(**base)


#: Config features outside this port's slice -> the ROADMAP item (Queue 1)
#: that ports them.
_NOT_PORTED = (
    ("grad_sync_axis", "no in-scan gradient sync: the port's layers are a ModuleList, so "
                       "--overlap's autograd hooks (parallel/overlap.py) sync the stacked layout too"),
)


def check_ported(cfg: TransformerConfig) -> None:
    """Raise NotImplementedError for a config feature this port lacks."""
    for field, item in _NOT_PORTED:
        if getattr(cfg, field):
            raise NotImplementedError(
                f"TransformerConfig.{field}={getattr(cfg, field)!r} is not "
                f"ported yet: ROADMAP.md Queue 1, {item}"
            )


class WeightGradStore:
    """Where a pipeline stage's dense products put their weight gradients
    (``parallel.pipeline_parallel`` sets one on every ``nn.Linear`` of a
    stage for the length of a schedule, as ``weight_grad_store``).  Each
    such product runs through ``_Dense``: its backward computes ``dx`` and
    the bias gradient, and the weight gradient ``dy^T x`` (with the f32
    cast's backward) either at once (``defer=False``: 1F1B, GPipe) or into
    ``queue`` (``defer=True``: the zero-bubble schedule's B unit, Megatron's
    ``WeightGradStore``); ``flush`` is the W unit, the queued products in
    the order the backward queued them.  The GEMMs are the same either way,
    so deferred and immediate gradients agree bit for bit."""

    def __init__(self, defer: bool):
        self.defer, self.queue = defer, []

    def flush(self) -> int:
        """Run the queued weight-gradient products into the weights'
        ``.grad``; returns how many ran."""
        ran = len(self.queue)
        for weight, dy, x in self.queue:
            _accumulate(weight, (dy.t() @ x).to(weight.dtype))
        self.queue.clear()
        return ran


def _accumulate(p: torch.Tensor, g: torch.Tensor) -> None:
    """``p.grad += g`` as autograd's accumulation does it."""
    if p.grad is None:
        p.grad = g
    else:
        p.grad.add_(g)


class _Dense(torch.autograd.Function):
    """``x @ w.T (+ b)`` with ``w`` and ``b`` cast to ``x``'s dtype, whose
    weight gradient goes through a ``WeightGradStore``."""

    @staticmethod
    def forward(ctx, x, weight, bias, store):
        w = weight.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.weight, ctx.store, ctx.has_bias = weight, store, bias is not None
        return F.linear(x, w, None if bias is None else bias.to(x.dtype))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dy @ w if ctx.needs_input_grad[0] else None
        dy2, x2 = dy.reshape(-1, dy.shape[-1]), x.reshape(-1, x.shape[-1])
        db = dy2.sum(0).to(ctx.weight.dtype) if ctx.has_bias else None
        dw = None
        if ctx.store.defer:
            ctx.store.queue.append((ctx.weight, dy2, x2))
        else:
            dw = (dy2.t() @ x2).to(ctx.weight.dtype)
        return dx, dw, db, None


def _linear(layer: nn.Linear, x: torch.Tensor, bias) -> torch.Tensor:
    """``layer``'s product on ``x`` (already in the compute dtype) with
    ``bias`` (f32, or None), through its weight-gradient store when a
    pipeline schedule set one and gradients are recorded."""
    store = getattr(layer, "weight_grad_store", None)
    if store is not None and torch.is_grad_enabled():
        return _Dense.apply(x, layer.weight, bias, store)
    return F.linear(x, layer.weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Linear with cfg.dtype operands (f32 params cast per use)."""
    return _linear(layer, x.to(dtype), layer.bias)


class _F32Product(torch.autograd.Function):
    """``x @ w.T`` for ``x`` (N, d) and ``w`` (V, d) of one low-precision
    dtype, with f32 accumulation and an f32 result (the reference's
    ``dot_general(..., preferred_element_type=float32)``).

    CUDA: ``torch.mm(out_dtype=float32)`` (bf16 tensor cores, f32 output).
    Its backward rounds the f32 cotangent to the operands' dtype and runs
    the two products in that dtype with f32 accumulation, each result
    rounded to the operand dtype once, as the reference's transposed
    products are.  On the TPU the reference's f32 x bf16 products take bf16
    operands too; an f32 product here would make the vocab-sized head's
    backward an f32 GEMM.  CPU: the same formulas with the cotangent kept in
    f32 (the exact f32 products of the rounded operands, as XLA computes
    them on the CPU)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w.t(), out_dtype=torch.float32)
        return x.float() @ w.float().t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if g.is_cuda:
            g = g.to(x.dtype)
            return g @ w, g.t() @ x
        return (g @ w.float()).to(x.dtype), (g.t() @ x.float()).to(w.dtype)


def f32_logits(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(..., d) x (V, d) -> (..., V) f32: the f32 product of ``dtype``
    operands (the casts of the f32 params are differentiable)."""
    if dtype == torch.float32:
        return F.linear(x.float(), w.float())
    lead = x.shape[:-1]
    out = _F32Product.apply(x.to(dtype).reshape(-1, x.shape[-1]), w.to(dtype))
    return out.view(*lead, w.shape[0])


class RMSNorm(nn.Module):
    """Llama-style RMS normalization; stats in f32, scale param f32."""

    def __init__(self, dim: int, epsilon: float = 1e-5, *, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.epsilon)
        return (xf * self.weight).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) computed in f32 whatever the input dtype; like
    the reference's ``nn.LayerNorm(dtype=float32)`` it returns f32."""

    def __init__(self, dim: int, *, device=None):
        super().__init__(dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # .float(): the serving twin's params may be cast to bf16 (as the
        # reference casts every f32 leaf); the math stays f32.
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


def _make_norm(cfg: TransformerConfig, device) -> nn.Module:
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.d_model, device=device)
    if cfg.norm == "layernorm":
        return LayerNorm(cfg.d_model, device=device)
    raise ValueError(f"unknown norm {cfg.norm!r}")


def _row_parallel(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, tp_axis) -> torch.Tensor:
    """A row-parallel Linear (ref ``_RowParallelOut``): the partial product
    of this rank's input features summed over the TP axis, then the
    replicated bias added once."""
    y = reduce_from_tp(_linear(layer, x.to(dtype), None), tp_axis)
    return y if layer.bias is None else y + layer.bias.to(dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        H, Hkv, D, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, cfg.d_model
        if H % Hkv:
            raise ValueError(f"num_heads {H} not a multiple of kv heads {Hkv}")
        n_tp = tp_size(cfg.tp_axis)
        if H % n_tp or Hkv % n_tp:
            raise ValueError(f"tp={n_tp} must divide num_heads={H} and kv_heads={Hkv}")
        self.tp = n_tp > 1
        # This rank's head counts (all of them without TP).
        self.heads, self.kv_heads = H // n_tp, Hkv // n_tp
        lin = lambda i, o: nn.Linear(i, o, bias=cfg.use_bias, device=device)
        self.q_proj = lin(d, self.heads * D)
        self.k_proj = lin(d, self.kv_heads * D)
        self.v_proj = lin(d, self.kv_heads * D)
        self.o_proj = lin(self.heads * D, d)

    def forward(self, x, rope=None, positions=None, seq=None):
        """``seq``: the sequence-parallel exchange to attend over (an
        object with ``context_parallel``'s exchange members, ranks of one
        process); without it, the ``cp_axis`` group when that axis is
        bound."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = self.heads, self.kv_heads, cfg.dims_per_head
        if self.tp:
            x = copy_to_tp(x, cfg.tp_axis)
        q = _dense(self.q_proj, x, cfg.dtype).view(B, S, H, D)
        k = _dense(self.k_proj, x, cfg.dtype).view(B, S, Hkv, D)
        v = _dense(self.v_proj, x, cfg.dtype).view(B, S, Hkv, D)
        if cfg.positional == "rope":
            cos, sin = rope
            q = apply_rope(q, cos, sin, positions=positions)
            k = apply_rope(k, cos, sin, positions=positions)
        # GQA kv stays at its own head count: the kernels index the shared
        # head natively; the plain path expands internally.  So do both
        # sequence-parallel collectives (the ring carries kv at Hkv heads).
        if seq is not None or axis_size(cfg.cp_axis) > 1:
            over = seq if seq is not None else axis_group(cfg.cp_axis)
            if cfg.cp_impl == "ulysses":
                out = cp.ulysses_attention(q, k, v, over, causal=True, impl=cfg.attn_impl)
            elif cfg.cp_impl == "ring":
                out = cp.ring_attention(q, k, v, over, causal=True, impl=cfg.attn_impl)
            else:
                raise ValueError(f"unknown cp_impl {cfg.cp_impl!r}")
        else:
            out = attention(q, k, v, causal=True, impl=cfg.attn_impl)
        out = out.reshape(B, S, H * D)
        if self.tp:
            return _row_parallel(self.o_proj, out, cfg.dtype, cfg.tp_axis)
        return _dense(self.o_proj, out, cfg.dtype)

    def decode(self, x, rope, positions, kv):
        """KV-cache attention (ref ``Attention.__call__``'s decode branch):
        insert this call's k/v into ``kv`` in place at ``positions`` and
        attend against the whole cache under a positional bias."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = self.heads, self.kv_heads, cfg.dims_per_head
        q = _dense(self.q_proj, x, cfg.dtype).view(B, S, H, D)
        k = _dense(self.k_proj, x, cfg.dtype).view(B, S, Hkv, D)
        v = _dense(self.v_proj, x, cfg.dtype).view(B, S, Hkv, D)
        if cfg.positional == "rope":
            cos, sin = rope
            q = apply_rope(q, cos, sin, positions=positions)
            k = apply_rope(k, cos, sin, positions=positions)
        ck, cv = kv
        T = ck.shape[1]
        if positions.dim() == 2:
            # Per-row positions (continuous batching; S > 1 is a verify
            # window).  Rows past a slot's position hold stale values that
            # the finite NEG_INF bias zeroes exactly in the softmax.
            if tuple(positions.shape) != (B, S):
                raise ValueError(f"per-row positions must be ({B}, {S}), got {tuple(positions.shape)}")
            row = torch.arange(B, device=x.device)[:, None]
            ck.index_put_((row, positions), k.to(ck.dtype))
            cv.index_put_((row, positions), v.to(cv.dtype))
            kv_pos = torch.arange(T, device=x.device)
            bias = torch.where(kv_pos[None, None, None, :] <= positions[:, None, :, None],
                               0.0, NEG_INF)  # (B, 1, S, T) f32
        else:
            # Contiguous positions from positions[0]: the insert starts
            # there, clamped so the S rows fit (XLA's dynamic_update_slice),
            # and the mask is the causal bias at that q offset.
            start = positions[0].clamp(0, T - S)
            idx = start + torch.arange(S, device=x.device)
            ck.index_copy_(1, idx, k.to(ck.dtype))
            cv.index_copy_(1, idx, v.to(cv.dtype))
            bias = causal_mask_bias(S, T, q_offset=positions[0], device=x.device)[None, None]
        out = dot_product_attention(q, repeat_kv(ck, H // Hkv), repeat_kv(cv, H // Hkv),
                                    causal=False, bias=bias)
        return _dense(self.o_proj, out.reshape(B, S, H * D), cfg.dtype)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.activation not in ("gelu", "swiglu"):
            raise ValueError(f"unknown activation {cfg.activation!r}")
        n_tp = tp_size(cfg.tp_axis)
        if cfg.d_ff % n_tp:
            raise ValueError(f"tp={n_tp} must divide d_ff={cfg.d_ff}")
        self.tp = n_tp > 1
        ff = cfg.d_ff // n_tp  # this rank's hidden units
        lin = lambda i, o: nn.Linear(i, o, bias=cfg.use_bias, device=device)
        if cfg.activation == "swiglu":
            self.gate_proj = lin(cfg.d_model, ff)
        self.up_proj = lin(cfg.d_model, ff)
        self.down_proj = lin(ff, cfg.d_model)

    def forward(self, x):
        dt = self.cfg.dtype
        if self.tp:
            x = copy_to_tp(x, self.cfg.tp_axis)
        if self.cfg.activation == "swiglu":
            h = F.silu(_dense(self.gate_proj, x, dt)) * _dense(self.up_proj, x, dt)
        else:
            h = F.gelu(_dense(self.up_proj, x, dt), approximate="tanh")
        if self.tp:
            return _row_parallel(self.down_proj, h, dt, self.cfg.tp_axis)
        return _dense(self.down_proj, h, dt)


@contextlib.contextmanager
def _full_f32_matmuls():
    """f32 matmuls in full f32 (no TF32) inside the block, whatever the
    global setting: a top-k near a tie flips on TF32's ~1e-3 error."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class MoEMLP(nn.Module):
    """Top-k-routed mixture-of-experts MLP (ref ``MoEMLP``).

    Routing: an f32 router (``Linear(d, E)``, no bias) on ``x`` in f32, a
    softmax, and the top ``moe_top_k`` experts (the lower index first on a
    tie, as ``jax.lax.top_k``).  K = 1 is the Switch convention (the raw top
    probability gates the output); K > 1 renormalizes the gates over the
    chosen k.  ``forward`` returns ``(out, aux)``: ``aux`` is the
    load-balance term ``E * sum_e frac_e * mean_prob_e`` (1 at perfect
    balance; ``frac`` counts routing slots and carries no gradient).

    The expert stacks are parameters in the reference's element order,
    ``experts_up``/``experts_gate`` ``(E_local, d, f)`` and ``experts_down``
    ``(E_local, f, d)``, read by ``torch.bmm`` as they are.  Under
    ``ep_axis`` a rank holds experts ``[r*E_local, (r+1)*E_local)``
    (``parallel.expert_parallel``).  Two dispatch modes:

    - dense (``moe_capacity_factor`` 0): every token through every local
      expert, blended by the ``(B, S, E)`` gate weights; under EP the
      tokens enter through ``copy_to_tp`` and the partial blends leave
      through ``reduce_from_tp`` over the expert group;
    - token choice (``> 0``, ``ops.moe``): each token in at most K slots of
      a capacity-bounded buffer, the overflow dropped through the residual;
      under EP each rank routes its 1/ep slice of the tokens (the capacity
      from that slice), the slot buffers travel to their experts' ranks and
      back by all-to-all, and the combined slices are gathered.

    Nothing here reads a device value on the host."""

    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        E, K = cfg.moe_experts, cfg.moe_top_k
        n_ep = axis_size(cfg.ep_axis)
        if E % n_ep:
            raise ValueError(f"ep={n_ep} must divide moe_experts={E}")
        if not 1 <= K <= E:
            raise ValueError(f"moe_top_k={K} must be in [1, {E}]")
        if cfg.activation not in ("gelu", "swiglu"):
            raise ValueError(f"unknown activation {cfg.activation!r}")
        self.n_ep, self.local = n_ep, E // n_ep
        d, f = cfg.d_model, cfg.d_ff
        self.router = nn.Linear(d, E, bias=False, device=device)
        stack = lambda *shape: nn.Parameter(torch.empty(self.local, *shape, device=device))
        self.experts_up = stack(d, f)
        if cfg.activation == "swiglu":
            self.experts_gate = stack(d, f)
        self.experts_down = stack(f, d)

    def _route(self, x):
        """Gates (B, S, K), expert ids (B, S, K), the aux term."""
        E, K = self.cfg.moe_experts, self.cfg.moe_top_k
        with _full_f32_matmuls():
            logits = F.linear(x.float(), self.router.weight.float())
        probs = torch.softmax(logits, dim=-1)  # (B, S, E)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[..., :K], idx[..., :K]
        if K > 1:
            vals = vals / vals.sum(dim=-1, keepdim=True)
        sel = (idx[..., None] == torch.arange(E, device=x.device)).float()  # (B, S, K, E)
        frac = sel.mean(dim=(0, 1, 2))
        aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))
        return vals, idx, sel, aux

    def _experts(self, z):
        """The local experts' MLPs: (E_local, n, d) -> (E_local, n, d)."""
        dt = self.cfg.dtype
        h = torch.matmul(z, self.experts_up.to(dt))
        if self.cfg.activation == "swiglu":
            h = F.silu(torch.matmul(z, self.experts_gate.to(dt))) * h
        else:
            h = F.gelu(h, approximate="tanh")
        return torch.matmul(h, self.experts_down.to(dt))

    def forward(self, x):
        cfg = self.cfg
        vals, idx, sel, aux = self._route(x)
        if cfg.moe_capacity_factor > 0:
            return self._token_choice(x, vals, idx), aux
        B, S, d = x.shape
        ep = cfg.ep_axis if self.n_ep > 1 else None
        w = torch.sum(sel * vals[..., None], dim=2)  # (B, S, E): a token's gate per expert
        if ep is not None:
            x, w = copy_to_tp(x, ep), copy_to_tp(w, ep)
        # (1, T, d) against the (E_local, d, f) stacks: x is not copied per expert.
        y = self._experts(x.to(cfg.dtype).reshape(1, B * S, d))  # (E_local, T, d)
        first = axis_index(ep) * self.local if ep is not None else 0
        w_local = w[..., first : first + self.local].reshape(B * S, self.local)
        out = torch.einsum("etd,te->td", y, w_local.to(cfg.dtype)).reshape(B, S, d)
        if ep is not None:
            out = reduce_from_tp(out, ep)
        return out, aux

    def _token_choice(self, x, vals, idx):
        cfg = self.cfg
        E, K, El, n = cfg.moe_experts, cfg.moe_top_k, self.local, self.n_ep
        B, S, d = x.shape
        T = B * S
        ep = cfg.ep_axis if n > 1 else None
        if ep is not None and T % n:
            raise ValueError(f"token-choice EP needs tokens ({T}) divisible by the expert-axis size ({n})")
        Tl = T // n
        xt, vt, it = x.reshape(T, d), vals.reshape(T, K), idx.reshape(T, K)
        if ep is not None:
            xt, vt = ep_shard_tokens(xt, ep), ep_shard_tokens(vt, ep)
            r = axis_index(ep)
            it = it[r * Tl : (r + 1) * Tl]
        C = moe.moe_capacity(Tl, E, K, cfg.moe_capacity_factor)
        tok, gate = moe.token_choice_slots(it, vt, E, C)
        z = moe.dispatch(xt.to(cfg.dtype), tok)  # (E*C, d)
        if ep is not None:
            # Expert block j's slots go to rank j; received block s is source s's.
            z = ep_all_to_all(z.reshape(n, El, C, d), ep).transpose(0, 1).reshape(El, n * C, d)
        else:
            z = z.reshape(E, C, d)
        y = self._experts(z)
        if ep is not None:
            # Back to the sources: received block j holds expert block j's outputs.
            y = ep_all_to_all(y.reshape(El, n, C, d).transpose(0, 1), ep)
        out = moe.combine(y.reshape(E * C, d), tok, gate, Tl)
        if ep is not None:
            out = ep_unshard_tokens(out, ep)
        return out.reshape(B, S, d)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.rate = cfg.dropout_rate
        self.moe = cfg.moe_experts > 0
        self.attn_norm = _make_norm(cfg, device)
        self.attn = Attention(cfg, device=device)
        self.mlp_norm = _make_norm(cfg, device)
        self.mlp = MoEMLP(cfg, device=device) if self.moe else MLP(cfg, device=device)

    def forward(self, x, rope=None, seed=None, positions=None, kv=None, seq=None):
        """``seed`` (an int) turns on dropout of both residual branches;
        ``kv`` (this layer's cache pair) selects KV-cache attention at
        ``positions`` (without it, ``positions`` are the tokens' global
        positions for RoPE: a sequence chunk's under ``cp_axis``); ``seq``
        is the attention's sequence-parallel exchange (``Attention``).  An
        MoE block returns ``(x, aux)``: the aux term is an output, so
        checkpointing's recompute carries it."""
        y = self.attn_norm(x)
        h = self.attn(y, rope, positions, seq) if kv is None else self.attn.decode(y, rope, positions, kv)
        if seed is not None:
            h = dropout(h, self.rate, fold_seed(seed, 0))
        x = x + h
        h = self.mlp(self.mlp_norm(x))
        if self.moe:
            h, aux = h
        if seed is not None:
            h = dropout(h, self.rate, fold_seed(seed, 1))
        return (x + h, aux) if self.moe else x + h


def _hidden(out):
    """A block's hidden state (an MoE block also returns its aux term)."""
    return out[0] if isinstance(out, tuple) else out


class TransformerLM(nn.Module):
    """Decoder-only LM: tokens (B, S) int -> logits (B, S, vocab) f32.

    ``generator`` (on ``device``) seeds the initialization, which follows
    the reference's initializers: N(0, 0.02) for embeddings and
    projections, N(0, 0.02 / sqrt(2 L)) for the attention output, zero
    biases, unit norm scales."""

    def __init__(self, cfg: TransformerConfig, *, device=None, generator=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        # A meta skeleton (the decode and forward twins, which assign real
        # tensors) is not initialized: ``normal_`` on a meta tensor imports
        # torch._dynamo (seconds of a serving process's start-up).
        meta = device is not None and torch.device(device).type == "meta"
        self.token_embed = nn.Embedding(
            cfg.vocab_size, cfg.d_model, device=device,
            _weight=torch.empty(cfg.vocab_size, cfg.d_model, device=device) if meta else None,
        )
        if cfg.positional == "learned":
            self.pos_embed = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.d_model, device=device)
            )
        elif cfg.positional == "rope":
            cos, sin = rope_frequencies(
                cfg.dims_per_head, cfg.max_seq_len, theta=cfg.rope_theta, device=device
            )
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)
        else:
            raise ValueError(f"unknown positional {cfg.positional!r}")
        self.layers = nn.ModuleList(
            DecoderBlock(cfg, device=device) for _ in range(cfg.num_layers)
        )
        self.final_norm = _make_norm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False, device=device)
        if not meta:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        normal = lambda t, std: nn.init.normal_(t, 0.0, std, generator=generator)
        o_std = 0.02 / math.sqrt(2 * self.cfg.num_layers)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                normal(p, o_std if name.endswith("o_proj.weight") else 0.02)

    def forward(self, tokens: torch.Tensor, *, dropout_seed: int | None = None,
                positions: torch.Tensor | None = None, cache=None, qparams=None,
                with_aux: bool = False):
        """Logits for ``tokens``.  In training mode with ``dropout_rate > 0``
        the masks are functions of ``dropout_seed``, which is then required
        (the trainer derives it per step, ``ops.dropout.fold_seed``).
        ``with_aux``: ``(logits, aux)``, ``aux`` the mean over layers of the
        MoE blocks' load-balance terms (ref ``moe_aux_from_intermediates``;
        0 without MoE).

        ``cfg.decode``: ``positions`` and ``cache`` are required (module
        docstring); ``qparams`` is an int8 tree under ``quant_serving``."""
        cfg = self.cfg
        if cfg.decode:
            if cfg.cp_axis is not None:
                # The cache has no sequence-sharded layout; the decode twin
                # (models.generate) turns cp_axis off.
                raise ValueError("decode does not compose with cp_axis/remat")
            return self._decode(tokens, positions, cache, qparams)
        B, S = tokens.shape
        # Under CP the model sees its chunk: the guard checks the global
        # length, or RoPE / pos_embed lookups past the tables would clamp.
        n_seq = axis_size(cfg.cp_axis)
        if S * n_seq > cfg.max_seq_len:
            detail = (f"global seq len {S * n_seq} ({S} local x {n_seq} {cfg.cp_axis!r} shards)"
                      if n_seq > 1 else f"seq len {S}")
            raise ValueError(f"{detail} > max_seq_len {cfg.max_seq_len}")
        if n_seq > 1 and positions is None:
            positions = cp.cp_positions(S, axis_group(cfg.cp_axis), device=tokens.device)
        drop = self.training and cfg.dropout_rate > 0
        if drop and dropout_seed is None:
            raise ValueError("training with dropout_rate > 0 needs forward(dropout_seed=...)")
        seed = dropout_seed if drop else None
        x, auxes = self.blocks(self.embed(tokens, positions, seed), positions, seed)
        logits = self.head(x)
        if not with_aux:
            return logits
        return logits, sum(auxes) / len(auxes) if auxes else torch.zeros((), device=logits.device)

    def embed(self, tokens, positions=None, dropout_seed=None):
        """The input block: token (and learned positional) embeddings in
        ``cfg.dtype``, dropped with ``dropout_seed`` when it is given."""
        cfg = self.cfg
        x = self.token_embed(tokens).to(cfg.dtype)
        if cfg.positional == "learned":
            pos = self.pos_embed[: tokens.shape[1]] if positions is None else self.pos_embed[positions]
            x = x + pos.to(cfg.dtype)
        if dropout_seed is not None:
            x = dropout(x, cfg.dropout_rate, fold_seed(dropout_seed, 0))
        return x

    def blocks(self, x, positions=None, dropout_seed=None, *, layers=None, seq=None):
        """The decoder blocks on ``x`` (checkpointed under ``remat`` while
        gradients are recorded): ``(x, auxes)``, the MoE blocks'
        load-balance terms in layer order (empty without MoE).  ``layers``:
        a run of ``self.layers`` (all of them by default); ``seq``: the
        attention's sequence-parallel exchange (``Attention.forward``)."""
        cfg = self.cfg
        rope = (self.rope_cos, self.rope_sin) if cfg.positional == "rope" else None
        auxes = []
        for i, layer in enumerate(self.layers if layers is None else layers):
            seed = None if dropout_seed is None else fold_seed(dropout_seed, i + 1)
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, rope, seed, positions, None, seq, use_reentrant=False)
            else:
                x = layer(x, rope, seed, positions, None, seq)
            if cfg.moe_experts:
                x, aux = x
                auxes.append(aux)
        return x, auxes

    def head(self, x):
        """The output block: the final norm and the f32 logits."""
        x = self.final_norm(x)
        w = self.token_embed.weight if self.cfg.tie_embeddings else self.lm_head.weight
        return f32_logits(x, w, self.cfg.dtype)

    def _decode(self, tokens, positions, cache, qparams):
        """The decode twin's forward (ref ``TransformerLM.__call__`` with
        ``cfg.decode``): ``qparams`` replaces every parameter, one layer's
        dequantized matrices at a time."""
        cfg = self.cfg
        if cfg.remat:
            raise ValueError("decode does not compose with remat (generate() turns it off)")
        if positions is None or cache is None:
            raise ValueError("decode=True requires explicit positions and a cache "
                             "(models.generate passes them)")
        if cfg.quant_serving != (qparams is not None):
            raise ValueError("quant_serving and qparams go together")
        if len(cache) != cfg.num_layers:
            raise ValueError(f"cache has {len(cache)} layers, config has {cfg.num_layers}")
        B, S = tokens.shape
        if S > cfg.max_seq_len:
            raise ValueError(f"seq len {S} > max_seq_len {cfg.max_seq_len}")
        positions = positions.to(device=tokens.device, dtype=torch.long)
        # Lookups past the tables read their last row (XLA's clamping gather).
        lookup = positions.clamp(0, cfg.max_seq_len - 1)
        rope = (self.rope_cos, self.rope_sin) if cfg.positional == "rope" else None
        if qparams is None:
            x = self.token_embed(tokens).to(cfg.dtype)
            if cfg.positional == "learned":
                x = x + self.pos_embed[lookup].to(cfg.dtype)
            for i, layer in enumerate(self.layers):
                x = _hidden(layer(x, rope, None, positions, cache[i]))
            x = self.final_norm(x)
            w = self.token_embed.weight if cfg.tie_embeddings else self.lm_head.weight
            return f32_logits(x, w, cfg.dtype)
        from distributeddataparallel_tpu_torch.models.io import layer_weights, top_weights
        from distributeddataparallel_tpu_torch.ops.quant import dequantize_rows

        x = dequantize_rows(qparams["token_embed"]["embedding"], tokens, cfg.dtype)
        if cfg.positional == "learned":
            x = x + dequantize_rows(qparams["pos_embed"], lookup, cfg.dtype)
        for i, layer in enumerate(self.layers):
            # This layer's matrices, dequantized for its call only.
            x = _hidden(torch.func.functional_call(
                layer, layer_weights(qparams, i, cfg), (x, rope, None, positions, cache[i])))
        top = top_weights(qparams, cfg)
        x = torch.func.functional_call(self.final_norm, top["final_norm"], (x,))
        return f32_logits(x, top["head"], cfg.dtype)

