"""Weight transfer between the JAX package's flax variables and this port.

``from_jax_params(tree, model_or_cfg)`` returns this port's ``state_dict``;
``to_jax_params(state_dict, model_or_cfg)`` is its inverse, giving nested
dicts of numpy arrays.  Inputs may be any array-likes (numpy, or device
arrays converted with ``np.asarray``).

- The transformer LM (``model_or_cfg`` a ``TransformerConfig``) takes the
  ``params`` tree.  ``DenseGeneral`` kernels ``(d_model, H, D)`` become
  Linear weights ``(H*D, d_model)``, ``o_proj``'s ``(H, D, d_model)``
  likewise, and ``(H, D)`` biases flatten to ``(H*D,)``.
- The image models (``model_or_cfg`` a ``TinyMLP``, ``SimpleCNN`` or
  ``ResNet``) take the variables ``{"params", "batch_stats"}`` (or
  ``params`` alone where there are no statistics); the state dict holds
  parameters and BatchNorm buffers.  Conv kernels HWIO become OIHW, and
  BatchNorm ``scale``/``bias``/``mean``/``var`` become
  ``weight``/``bias``/``running_mean``/``running_var``.  ResNet names map
  as the reference's torchvision export does (``export_resnet_torch``):
  ``conv_init``/``bn_init`` -> ``conv1``/``bn1``; ``{Basic,Bottleneck}Block_i``
  (numbered across stages) -> ``layerS.j``; ``Conv_c``/``BatchNorm_c`` ->
  ``conv{c+1}``/``bn{c+1}``; ``conv_proj``/``norm_proj`` ->
  ``downsample.{0,1}``; ``Dense_0`` -> ``fc``.
- ``Dense`` kernels ``(in, out)`` transpose to Linear ``(out, in)``; norm
  ``scale``/``bias`` become ``weight``/``bias``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from distributeddataparallel_tpu_torch.models.resnet import ResNet
from distributeddataparallel_tpu_torch.models.simple_cnn import SimpleCNN, TinyMLP
from distributeddataparallel_tpu_torch.models.transformer import TransformerConfig


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _mlp_names(cfg: TransformerConfig):
    return ("gate_proj", "up_proj", "down_proj") if cfg.activation == "swiglu" else ("up_proj", "down_proj")


def from_jax_params(params, cfg: TransformerConfig | nn.Module) -> dict[str, torch.Tensor]:
    """Reference flax tree -> this port's state_dict (CPU float32 tensors)."""
    if not isinstance(cfg, TransformerConfig):
        return _tensors(_image_from_jax(params, cfg))
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
    return _tensors(out)


def _tensors(arrays: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in arrays.items()}


def to_jax_params(state_dict, cfg: TransformerConfig | nn.Module) -> dict:
    """This port's state_dict -> the reference flax tree (nested dicts of
    float32 numpy arrays)."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    if not isinstance(cfg, TransformerConfig):
        return _contig(_image_to_jax(sd, cfg))
    H, Hkv, D, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, cfg.d_model
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


def _image_names(model: nn.Module) -> list[tuple[str, str, str]]:
    """(flax path, port prefix, kind) for every layer of an image model;
    kind is "conv", "bn" or "dense"."""
    if isinstance(model, TinyMLP):
        n = len(model.hidden)
        return [(f"Dense_{i}", f"hidden.{i}", "dense") for i in range(n)] + [(f"Dense_{n}", "fc", "dense")]
    if isinstance(model, SimpleCNN):
        return [(f"Conv_{i}", f"convs.{i}", "conv") for i in range(len(model.convs))] + [
            ("Dense_0", "fc", "dense")]
    if not isinstance(model, ResNet):
        raise TypeError(f"no flax mapping for {type(model).__name__}")
    names = [("conv_init", "conv1", "conv"), ("bn_init", "bn1", "bn")]
    block = model.block_cls.__name__
    n_convs = 3 if block == "BottleneckBlock" else 2
    flat = 0
    for stage, n_blocks in enumerate(model.stage_sizes):
        for j in range(n_blocks):
            pre, fb = f"layer{stage + 1}.{j}", f"{block}_{flat}"
            flat += 1
            for c in range(n_convs):
                names += [(f"{fb}/Conv_{c}", f"{pre}.conv{c + 1}", "conv"),
                          (f"{fb}/BatchNorm_{c}", f"{pre}.bn{c + 1}", "bn")]
            if getattr(model, f"layer{stage + 1}")[j].downsample is not None:
                names += [(f"{fb}/conv_proj", f"{pre}.downsample.0", "conv"),
                          (f"{fb}/norm_proj", f"{pre}.downsample.1", "bn")]
    return names + [("Dense_0", "fc", "dense")]


def _at(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _image_from_jax(variables, model: nn.Module) -> dict[str, np.ndarray]:
    params = variables["params"] if "params" in variables else variables
    stats = variables.get("batch_stats", {}) if "params" in variables else {}
    out = {}
    for path, pre, kind in _image_names(model):
        p = _at(params, path)
        if kind == "conv":
            out[f"{pre}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if "bias" in p:
                out[f"{pre}.bias"] = _np(p["bias"])
        elif kind == "dense":
            out[f"{pre}.weight"] = _np(p["kernel"]).T
            out[f"{pre}.bias"] = _np(p["bias"])
        else:
            s = _at(stats, path)
            out.update({f"{pre}.weight": _np(p["scale"]), f"{pre}.bias": _np(p["bias"]),
                        f"{pre}.running_mean": _np(s["mean"]), f"{pre}.running_var": _np(s["var"])})
    return out


def _image_to_jax(sd: dict[str, np.ndarray], model: nn.Module) -> dict:
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        *parents, leaf = path.split("/")
        for k in parents:
            tree = tree.setdefault(k, {})
        tree[leaf] = value

    for path, pre, kind in _image_names(model):
        if kind == "conv":
            p = {"kernel": sd[f"{pre}.weight"].transpose(2, 3, 1, 0)}  # OIHW -> HWIO
            if f"{pre}.bias" in sd:
                p["bias"] = sd[f"{pre}.bias"]
        elif kind == "dense":
            p = {"kernel": sd[f"{pre}.weight"].T, "bias": sd[f"{pre}.bias"]}
        else:
            p = {"scale": sd[f"{pre}.weight"], "bias": sd[f"{pre}.bias"]}
            put(stats, path, {"mean": sd[f"{pre}.running_mean"], "var": sd[f"{pre}.running_var"]})
        put(params, path, p)
    return {"params": params, "batch_stats": stats} if stats else {"params": params}
