"""Weight transfer between the JAX package's flax param tree and this port.

``from_jax_params`` takes the reference ``TransformerLM``'s ``params`` tree
(any array-likes: numpy, or device arrays converted with ``np.asarray``) and
returns this port's ``state_dict``; ``to_jax_params`` is its inverse, giving
nested dicts of numpy arrays.  The layout rules:

- ``DenseGeneral`` kernels ``(d_model, H, D)`` become Linear weights
  ``(H*D, d_model)``; ``o_proj``'s ``(H, D, d_model)`` likewise;
  ``(H, D)`` biases flatten to ``(H*D,)``.
- ``Dense`` kernels ``(in, out)`` transpose to Linear ``(out, in)``.
- Norm ``scale``/``bias`` become ``weight``/``bias``.
"""

from __future__ import annotations

import numpy as np
import torch

from distributeddataparallel_tpu_torch.models.transformer import TransformerConfig


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _mlp_names(cfg: TransformerConfig):
    return ("gate_proj", "up_proj", "down_proj") if cfg.activation == "swiglu" else ("up_proj", "down_proj")


def from_jax_params(params, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """Reference flax param tree -> this port's ``TransformerLM`` state_dict
    (CPU float32 tensors)."""
    H, Hkv, D, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, cfg.d_model
    out: dict[str, np.ndarray] = {"token_embed.weight": _np(params["token_embed"]["embedding"])}
    if cfg.positional == "learned":
        out["pos_embed"] = _np(params["pos_embed"])

    def norm(prefix, p):
        out[f"{prefix}.weight"] = _np(p["scale"])
        if cfg.norm == "layernorm":
            out[f"{prefix}.bias"] = _np(p["bias"])

    for i in range(cfg.num_layers):
        lp, pre = params[f"layer_{i}"], f"layers.{i}"
        norm(f"{pre}.attn_norm", lp["attn_norm"])
        norm(f"{pre}.mlp_norm", lp["mlp_norm"])
        attn = lp["attn"]
        for name, heads in (("q_proj", H), ("k_proj", Hkv), ("v_proj", Hkv)):
            out[f"{pre}.attn.{name}.weight"] = _np(attn[name]["kernel"]).reshape(d, heads * D).T
            if cfg.use_bias:
                out[f"{pre}.attn.{name}.bias"] = _np(attn[name]["bias"]).reshape(heads * D)
        out[f"{pre}.attn.o_proj.weight"] = _np(attn["o_proj"]["kernel"]).reshape(H * D, d).T
        if cfg.use_bias:
            out[f"{pre}.attn.o_proj.bias"] = _np(attn["o_proj"]["bias"])
        for name in _mlp_names(cfg):
            out[f"{pre}.mlp.{name}.weight"] = _np(lp["mlp"][name]["kernel"]).T
            if cfg.use_bias:
                out[f"{pre}.mlp.{name}.bias"] = _np(lp["mlp"][name]["bias"])
    norm("final_norm", params["final_norm"])
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = _np(params["lm_head"]["kernel"]).T
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in out.items()}


def to_jax_params(state_dict, cfg: TransformerConfig) -> dict:
    """This port's state_dict -> the reference flax param tree (nested
    dicts of float32 numpy arrays)."""
    H, Hkv, D, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, cfg.d_model
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    tree: dict = {"token_embed": {"embedding": sd["token_embed.weight"]}}
    if cfg.positional == "learned":
        tree["pos_embed"] = sd["pos_embed"]

    def norm(prefix):
        p = {"scale": sd[f"{prefix}.weight"]}
        if cfg.norm == "layernorm":
            p["bias"] = sd[f"{prefix}.bias"]
        return p

    for i in range(cfg.num_layers):
        pre = f"layers.{i}"
        attn = {}
        for name, heads in (("q_proj", H), ("k_proj", Hkv), ("v_proj", Hkv)):
            attn[name] = {"kernel": sd[f"{pre}.attn.{name}.weight"].T.reshape(d, heads, D)}
            if cfg.use_bias:
                attn[name]["bias"] = sd[f"{pre}.attn.{name}.bias"].reshape(heads, D)
        attn["o_proj"] = {"kernel": sd[f"{pre}.attn.o_proj.weight"].T.reshape(H, D, d)}
        if cfg.use_bias:
            attn["o_proj"]["bias"] = sd[f"{pre}.attn.o_proj.bias"]
        mlp = {}
        for name in _mlp_names(cfg):
            mlp[name] = {"kernel": sd[f"{pre}.mlp.{name}.weight"].T}
            if cfg.use_bias:
                mlp[name]["bias"] = sd[f"{pre}.mlp.{name}.bias"]
        tree[f"layer_{i}"] = {
            "attn_norm": norm(f"{pre}.attn_norm"),
            "attn": attn,
            "mlp_norm": norm(f"{pre}.mlp_norm"),
            "mlp": mlp,
        }
    tree["final_norm"] = norm("final_norm")
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": sd["lm_head.weight"].T}
    return {k: _contig(v) for k, v in tree.items()}


def _contig(x):
    if isinstance(x, dict):
        return {k: _contig(v) for k, v in x.items()}
    return np.ascontiguousarray(x)
