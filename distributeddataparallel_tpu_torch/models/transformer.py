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
computed in f32 and the logits are f32.  Attention goes through
``ops.attention.attention`` (the flash kernels for CUDA tensors).

Config fields of the reference that this port does not run yet are kept so
configs carry over, and raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from distributeddataparallel_tpu_torch.ops.attention import (
    apply_rope,
    attention,
    rope_frequencies,
)


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
    tp_axis: str | None = None
    decode: bool = False
    moe_experts: int = 0
    ep_axis: str | None = None
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
    ("cp_axis", "context parallelism, parallel/context_parallel.py"),
    ("tp_axis", "tensor parallelism, parallel/tensor_parallel.py"),
    ("moe_experts", "mixture of experts, parallel/expert_parallel.py + ops/moe.py"),
    ("ep_axis", "expert parallelism, parallel/expert_parallel.py"),
    ("decode", "KV-cache decoding, models/generate.py"),
    ("scan_layers", "stacked-layer layout, models/transformer.py (LM remainder)"),
    ("remat", "activation checkpointing, models/transformer.py (LM remainder)"),
    ("grad_sync_axis", "in-backward gradient sync, parallel/overlap.py"),
    ("quant_serving", "int8 weight-only serving, ops/quant.py"),
    ("dropout_rate", "residual dropout, models/transformer.py (LM remainder)"),
)


def check_ported(cfg: TransformerConfig) -> None:
    """Raise NotImplementedError for a config feature this port lacks."""
    for field, item in _NOT_PORTED:
        if getattr(cfg, field):
            raise NotImplementedError(
                f"TransformerConfig.{field}={getattr(cfg, field)!r} is not "
                f"ported yet: ROADMAP.md Queue 1, {item}"
            )


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Linear with cfg.dtype operands (f32 params cast per use)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


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
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


def _make_norm(cfg: TransformerConfig, device) -> nn.Module:
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.d_model, device=device)
    if cfg.norm == "layernorm":
        return LayerNorm(cfg.d_model, device=device)
    raise ValueError(f"unknown norm {cfg.norm!r}")


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        H, Hkv, D, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, cfg.d_model
        if H % Hkv:
            raise ValueError(f"num_heads {H} not a multiple of kv heads {Hkv}")
        lin = lambda i, o: nn.Linear(i, o, bias=cfg.use_bias, device=device)
        self.q_proj = lin(d, H * D)
        self.k_proj = lin(d, Hkv * D)
        self.v_proj = lin(d, Hkv * D)
        self.o_proj = lin(H * D, d)

    def forward(self, x, rope=None):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        q = _dense(self.q_proj, x, cfg.dtype).view(B, S, H, D)
        k = _dense(self.k_proj, x, cfg.dtype).view(B, S, Hkv, D)
        v = _dense(self.v_proj, x, cfg.dtype).view(B, S, Hkv, D)
        if cfg.positional == "rope":
            cos, sin = rope
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        # GQA kv stays at its own head count: the kernels index the shared
        # head natively; the plain path expands internally.
        out = attention(q, k, v, causal=True, impl=cfg.attn_impl)
        return _dense(self.o_proj, out.reshape(B, S, H * D), cfg.dtype)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.activation not in ("gelu", "swiglu"):
            raise ValueError(f"unknown activation {cfg.activation!r}")
        lin = lambda i, o: nn.Linear(i, o, bias=cfg.use_bias, device=device)
        if cfg.activation == "swiglu":
            self.gate_proj = lin(cfg.d_model, cfg.d_ff)
        self.up_proj = lin(cfg.d_model, cfg.d_ff)
        self.down_proj = lin(cfg.d_ff, cfg.d_model)

    def forward(self, x):
        dt = self.cfg.dtype
        if self.cfg.activation == "swiglu":
            h = F.silu(_dense(self.gate_proj, x, dt)) * _dense(self.up_proj, x, dt)
        else:
            h = F.gelu(_dense(self.up_proj, x, dt), approximate="tanh")
        return _dense(self.down_proj, h, dt)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.attn_norm = _make_norm(cfg, device)
        self.attn = Attention(cfg, device=device)
        self.mlp_norm = _make_norm(cfg, device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, rope=None):
        x = x + self.attn(self.attn_norm(x), rope)
        return x + self.mlp(self.mlp_norm(x))


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
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
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

    def forward(self, tokens: torch.Tensor):
        cfg = self.cfg
        B, S = tokens.shape
        if S > cfg.max_seq_len:
            raise ValueError(f"seq len {S} > max_seq_len {cfg.max_seq_len}")
        x = self.token_embed(tokens).to(cfg.dtype)
        rope = None
        if cfg.positional == "learned":
            x = x + self.pos_embed[:S].to(cfg.dtype)
        else:
            rope = (self.rope_cos, self.rope_sin)
        for layer in self.layers:
            x = layer(x, rope)
        x = self.final_norm(x)
        # f32 logits; cfg.dtype operands (a no-op under float32).
        w = self.token_embed.weight if cfg.tie_embeddings else self.lm_head.weight
        return F.linear(x.to(cfg.dtype), w.to(cfg.dtype)).float()
