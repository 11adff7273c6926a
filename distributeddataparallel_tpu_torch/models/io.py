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
- An MoE block's ``mlp/router/kernel`` ``(d_model, E)`` becomes the
  router's Linear weight; its expert stacks ``experts_{up,gate,down}`` keep
  their shape and element order (parameters ``mlp.experts_*``).
- The LM's layers come per layer (``layer_0`` .. ``layer_{L-1}``) or in the
  reference's ``scan_layers`` layout, one ``layers/block`` subtree whose
  leaves carry a leading layer dim (``stack_scanned_layers``).
  ``from_jax_params`` reads either; ``to_jax_params`` writes the layout of
  ``cfg.scan_layers``.

Storage and other sources, the numpy counterparts of the reference's
``models/io.py``:

- ``save_params`` / ``load_params``: a flax tree as one flat safetensors
  file, keys ``/``-joined paths.  The safetensors format (a little-endian
  u64 header length, a JSON header, then the raw little-endian tensors) is
  written and read here (``save_safetensors`` / ``load_safetensors``), so
  no ``safetensors`` package is needed; ``BF16`` tensors are read as f32.
- ``convert_gpt2_hf`` / ``convert_llama_hf``: HuggingFace GPT-2 / Llama
  tensors -> the flax tree; ``export_llama_hf`` is the Llama inverse.
- ``convert_resnet_torch`` / ``export_resnet_torch``: a torchvision ResNet
  ``state_dict`` to and from the port's ResNet (the same names).
- ``load_pretrained``: the format sniffed from the key names, converted to
  this port's ``state_dict``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

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


def _expert_names(cfg: TransformerConfig):
    """An MoE block's expert stacks (the router is the fourth leaf)."""
    names = ("experts_up", "experts_down")
    return names + ("experts_gate",) if cfg.activation == "swiglu" else names


def stack_scanned_layers(params: dict, num_layers: int, prefix: str = "layer_") -> dict:
    """Per-layer subtrees (``layer_0`` .. ``layer_{L-1}``) -> the
    ``scan_layers`` layout: one ``layers/block`` subtree whose leaves carry
    a leading layer dim (the reference's ``stack_scanned_layers``)."""

    def stack(*xs):
        if isinstance(xs[0], Mapping):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack([np.asarray(x) for x in xs])

    rest = {k: v for k, v in params.items() if not k.startswith(prefix)}
    rest["layers"] = {"block": stack(*(params[f"{prefix}{i}"] for i in range(num_layers)))}
    return rest


def unstack_scanned_layers(params: Mapping, num_layers: int, prefix: str = "layer_") -> dict:
    """Inverse of ``stack_scanned_layers``."""

    def take(x, i):
        if isinstance(x, Mapping):
            return {k: take(v, i) for k, v in x.items()}
        x = np.asarray(x)
        if x.shape[0] != num_layers:
            raise ValueError(f"stacked leaf has {x.shape[0]} layers, config has {num_layers}")
        return x[i]

    block = params["layers"]["block"]
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update({f"{prefix}{i}": take(block, i) for i in range(num_layers)})
    return out


def from_jax_params(params, cfg: TransformerConfig | nn.Module, *, tp_rank: int = 0,
                    tp_size: int = 1, ep_rank: int = 0, ep_size: int = 1, pp_rank: int = 0,
                    pp_size: int = 1, virtual: int = 1) -> dict[str, torch.Tensor]:
    """Reference flax tree -> this port's state_dict (CPU float32 tensors).
    An LM tree may be in either layer layout.  With ``tp_size > 1`` the
    result is tensor-parallel rank ``tp_rank``'s shard of it
    (``parallel.tensor_parallel.shard_state_dict_tp``: its query and kv
    heads and hidden units; the rest whole); with ``ep_size > 1`` expert
    rank ``ep_rank``'s (``parallel.expert_parallel.shard_state_dict_ep``:
    experts ``[r*E/ep, (r+1)*E/ep)`` of each MoE block); with ``pp_size >
    1`` pipeline stage ``pp_rank``'s
    (``parallel.pipeline_parallel.shard_state_dict_pp``: its layers,
    renumbered from 0, and the replicated leaves; a ``StageLM``'s), its
    ``virtual`` round-robin chunks in chunk-major order with ``virtual >
    1`` (as the reference's ``shard_state_pp(virtual=)`` places them)."""
    if not isinstance(cfg, TransformerConfig):
        return _tensors(_image_from_jax(params, cfg))
    if "layers" in params:
        params = unstack_scanned_layers(params, cfg.num_layers)
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
        if cfg.moe_experts:
            out[f"{pre}.mlp.router.weight"] = _np(lp["mlp"]["router"]["kernel"]).T
            for name in _expert_names(cfg):  # (E, d, f) / (E, f, d) as they are
                out[f"{pre}.mlp.{name}"] = _np(lp["mlp"][name])
        for name in () if cfg.moe_experts else _mlp_names(cfg):
            out[f"{pre}.mlp.{name}.weight"] = _np(lp["mlp"][name]["kernel"]).T
            if cfg.use_bias:
                out[f"{pre}.mlp.{name}.bias"] = _np(lp["mlp"][name]["bias"])
    norm("final_norm", params["final_norm"])
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = _np(params["lm_head"]["kernel"]).T
    sd = _tensors(out)
    if tp_size > 1:
        from distributeddataparallel_tpu_torch.parallel.tensor_parallel import shard_state_dict_tp

        sd = shard_state_dict_tp(sd, tp_rank, tp_size)
    if ep_size > 1:
        from distributeddataparallel_tpu_torch.parallel.expert_parallel import shard_state_dict_ep

        sd = shard_state_dict_ep(sd, ep_rank, ep_size)
    if pp_size > 1:
        from distributeddataparallel_tpu_torch.parallel.pipeline_parallel import shard_state_dict_pp

        sd = shard_state_dict_pp(sd, pp_rank, pp_size, virtual)
    return sd


def _tensors(arrays: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in arrays.items()}


def to_jax_params(state_dict, cfg: TransformerConfig | nn.Module) -> dict:
    """This port's state_dict -> the reference flax tree (nested dicts of
    float32 numpy arrays).  The head and expert counts are read off the
    tensors, so a tensor- or expert-parallel shard's state_dict gives that
    shard of the tree (``parallel.tensor_parallel.merge_tp_shards`` and
    ``parallel.expert_parallel.merge_ep_shards`` put the shards'
    state_dicts back together first for the whole tree)."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    if not isinstance(cfg, TransformerConfig):
        return _contig(_image_to_jax(sd, cfg))
    D, d = cfg.dims_per_head, cfg.d_model
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
        for name in ("q_proj", "k_proj", "v_proj"):
            attn[name] = {"kernel": sd[f"{pre}.attn.{name}.weight"].T.reshape(d, -1, D)}
            if cfg.use_bias:
                attn[name]["bias"] = sd[f"{pre}.attn.{name}.bias"].reshape(-1, D)
        attn["o_proj"] = {"kernel": sd[f"{pre}.attn.o_proj.weight"].T.reshape(-1, D, d)}
        if cfg.use_bias:
            attn["o_proj"]["bias"] = sd[f"{pre}.attn.o_proj.bias"]
        mlp = {}
        if cfg.moe_experts:
            mlp["router"] = {"kernel": sd[f"{pre}.mlp.router.weight"].T}
            mlp.update({name: sd[f"{pre}.mlp.{name}"] for name in _expert_names(cfg)})
        for name in () if cfg.moe_experts else _mlp_names(cfg):
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
    if cfg.scan_layers:
        tree = stack_scanned_layers(tree, cfg.num_layers)
    return {k: _contig(v) for k, v in tree.items()}


def _contig(x):
    if isinstance(x, dict):
        return {k: _contig(v) for k, v in x.items()}
    return np.ascontiguousarray(x)


# --- The reference layout as torch tensors (int8 serving, ``ops.quant``) ---

def jax_layout(model: nn.Module) -> dict:
    """A TransformerLM's params in the reference's tree layout, as torch
    tensors on their own device: views of the port's tensors where the
    layout allows, and stacked ``layers/block`` leaves (a copy) under
    ``cfg.scan_layers``.  ``ops.quant`` groups scales by this layout's
    shapes."""
    cfg = model.cfg
    sd = {k: v.detach() for k, v in model.named_parameters()}
    H, Hkv, D, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, cfg.d_model

    def norm(prefix):
        p = {"scale": sd[f"{prefix}.weight"]}
        if cfg.norm == "layernorm":
            p["bias"] = sd[f"{prefix}.bias"]
        return p

    def dense(name, shape, bias_shape=None):
        p = {"kernel": sd[f"{name}.weight"].t().reshape(shape)}
        if cfg.use_bias:
            b = sd[f"{name}.bias"]
            p["bias"] = b if bias_shape is None else b.reshape(bias_shape)
        return p

    tree: dict = {"token_embed": {"embedding": sd["token_embed.weight"]}}
    if cfg.positional == "learned":
        tree["pos_embed"] = sd["pos_embed"]
    layers = []
    for i in range(cfg.num_layers):
        pre = f"layers.{i}"
        attn = {name: dense(f"{pre}.attn.{name}", (d, heads, D), (heads, D))
                for name, heads in (("q_proj", H), ("k_proj", Hkv), ("v_proj", Hkv))}
        attn["o_proj"] = dense(f"{pre}.attn.o_proj", (H, D, d))
        if cfg.moe_experts:
            mlp = {"router": {"kernel": sd[f"{pre}.mlp.router.weight"].t()},
                   **{name: sd[f"{pre}.mlp.{name}"] for name in _expert_names(cfg)}}
        else:
            mlp = {name: dense(f"{pre}.mlp.{name}", sd[f"{pre}.mlp.{name}.weight"].t().shape)
                   for name in _mlp_names(cfg)}
        layers.append({"attn_norm": norm(f"{pre}.attn_norm"), "attn": attn,
                       "mlp_norm": norm(f"{pre}.mlp_norm"), "mlp": mlp})
    if cfg.scan_layers:
        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return torch.stack(xs)

        tree["layers"] = {"block": stack(*layers)}
    else:
        tree.update({f"layer_{i}": layer for i, layer in enumerate(layers)})
    tree["final_norm"] = norm("final_norm")
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": sd["lm_head.weight"].t()}
    return tree


def jax_leaf_pieces(model: nn.Module) -> list[tuple[str, list[tuple[nn.Parameter, str, tuple]]]]:
    """The reference's ``params`` leaves in ``jax.tree.leaves`` order (dict
    keys sorted), each as ``(path, [(parameter, kind, shape), ...])``: the
    port's parameters whose reference-layout views (of ``shape``),
    flattened and concatenated, are that leaf's elements in row-major
    order.  A leaf has one piece, or under ``scan_layers`` one per layer
    (the stacked leaf's leading dim).  ``kind`` is how the reference lays
    a parameter's elements out: ``"same"`` (the port's row-major order),
    ``"t"`` (transposed: Dense and DenseGeneral kernels) or ``"hwio"``
    (conv kernels).  The ZeRO flat layouts (``parallel.zero``) and
    PowerSGD's matrices (``parallel.powersgd``) follow it."""
    if not hasattr(model, "cfg"):
        return _image_leaf_pieces(model)
    cfg = model.cfg
    sd = dict(model.named_parameters())
    # This rank's head counts (a tensor-parallel shard holds H / tp).
    attn0 = model.layers[0].attn if len(model.layers) else None
    H = attn0.heads if attn0 is not None else cfg.num_heads
    Hkv = attn0.kv_heads if attn0 is not None else cfg.kv_heads
    D, d = cfg.dims_per_head, cfg.d_model

    def same(name, shape=None):
        return (sd[name], "same", tuple(shape or sd[name].shape))

    def norm(prefix):
        p = {"scale": same(f"{prefix}.weight")}
        if cfg.norm == "layernorm":
            p["bias"] = same(f"{prefix}.bias")
        return p

    def dense(name, shape=None, bias_shape=None):
        w = sd[f"{name}.weight"]
        p = {"kernel": (w, "t", tuple(shape or w.shape[::-1]))}
        if cfg.use_bias:
            p["bias"] = same(f"{name}.bias", bias_shape)
        return p

    tree: dict = {"token_embed": {"embedding": same("token_embed.weight")},
                  "final_norm": norm("final_norm")}
    if cfg.positional == "learned":
        tree["pos_embed"] = same("pos_embed")
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": (sd["lm_head.weight"], "t", tuple(sd["lm_head.weight"].shape[::-1]))}
    layers = []
    for i in range(cfg.num_layers):
        pre = f"layers.{i}"
        attn = {n: dense(f"{pre}.attn.{n}", (d, h, D), (h, D))
                for n, h in (("q_proj", H), ("k_proj", Hkv), ("v_proj", Hkv))}
        attn["o_proj"] = dense(f"{pre}.attn.o_proj", (H, D, d))
        if cfg.moe_experts:
            router = sd[f"{pre}.mlp.router.weight"]
            mlp = {"router": {"kernel": (router, "t", tuple(router.shape[::-1]))},
                   **{n: same(f"{pre}.mlp.{n}") for n in _expert_names(cfg)}}
        else:
            mlp = {n: dense(f"{pre}.mlp.{n}") for n in _mlp_names(cfg)}
        layers.append({"attn_norm": norm(f"{pre}.attn_norm"), "mlp_norm": norm(f"{pre}.mlp_norm"),
                       "attn": attn, "mlp": mlp})
    if cfg.scan_layers:
        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return list(xs)

        tree["layers"] = {"block": stack(*layers)}
    else:
        tree.update({f"layer_{i}": layer for i, layer in enumerate(layers)})
    return _sorted_leaves(tree)


def ref_view(t: torch.Tensor, kind: str) -> torch.Tensor:
    """A parameter (or its gradient) of ``jax_leaf_pieces``'s ``kind`` as a
    view in the reference's element order."""
    if kind == "t":
        return t.t()
    if kind == "hwio":
        return t.permute(2, 3, 1, 0)
    return t


def port_view(flat: torch.Tensor, shape, kind: str) -> torch.Tensor:
    """Inverse of ``ref_view``: a flat slice in the reference's element
    order as a view of the port's parameter ``shape``."""
    if kind == "t":
        return flat.view(shape[1], shape[0]).t()
    if kind == "hwio":
        o, i, h, w = shape
        return flat.view(h, w, i, o).permute(3, 2, 0, 1)
    return flat.view(shape)


def _sorted_leaves(tree: dict, prefix: str = "") -> list:
    out = []
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out += _sorted_leaves(v, path)
        else:
            out.append((path, v if isinstance(v, list) else [v]))
    return out


def _image_leaf_pieces(model: nn.Module) -> list:
    sd = dict(model.named_parameters())
    tree: dict = {}
    for path, pre, kind in _image_names(model):
        node = tree
        for k in path.split("/"):
            node = node.setdefault(k, {})
        w = sd[f"{pre}.weight"]
        if kind == "bn":
            node.update(scale=(w, "same", tuple(w.shape)),
                        bias=(sd[f"{pre}.bias"], "same", tuple(w.shape)))
            continue
        if kind == "conv":  # OIHW -> HWIO
            node["kernel"] = (w, "hwio", (w.shape[2], w.shape[3], w.shape[1], w.shape[0]))
        else:
            node["kernel"] = (w, "t", tuple(w.shape[::-1]))
        if f"{pre}.bias" in sd:
            node["bias"] = (sd[f"{pre}.bias"], "same", tuple(sd[f"{pre}.bias"].shape))
    return _sorted_leaves(tree)


def _norm_weights(p: dict) -> dict:
    return {"weight": p["scale"], **({"bias": p["bias"]} if "bias" in p else {})}


def layer_weights(qparams: Mapping, i: int, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """Layer ``i`` of a (quantized) reference-layout tree, dequantized to
    ``cfg.dtype`` and named as the port's ``DecoderBlock`` parameters
    (views: the ``(d_model, H, D)`` kernel becomes the ``(H*D, d_model)``
    weight without a copy)."""
    from distributeddataparallel_tpu_torch.ops.quant import dequantize, tree_map

    if "layers" in qparams:
        lp = tree_map(lambda leaf: leaf[i], qparams["layers"]["block"])
    else:
        lp = qparams[f"layer_{i}"]
    lp = dequantize(lp, cfg.dtype)
    d = cfg.d_model
    out = {f"attn_norm.{k}": v for k, v in _norm_weights(lp["attn_norm"]).items()}
    out.update({f"mlp_norm.{k}": v for k, v in _norm_weights(lp["mlp_norm"]).items()})
    for name, p in lp["attn"].items():
        kernel = p["kernel"]
        if name == "o_proj":
            out["attn.o_proj.weight"] = kernel.reshape(-1, d).t()
        else:
            out[f"attn.{name}.weight"] = kernel.reshape(d, -1).t()
        if "bias" in p:
            out[f"attn.{name}.bias"] = p["bias"].reshape(-1)
    for name, p in lp["mlp"].items():
        if name.startswith("experts_"):  # an MoE stack, in the port's order already
            out[f"mlp.{name}"] = p
            continue
        out[f"mlp.{name}.weight"] = p["kernel"].t()
        if "bias" in p:
            out[f"mlp.{name}.bias"] = p["bias"]
    return out


def top_weights(qparams: Mapping, cfg: TransformerConfig) -> dict:
    """The final norm's weights and the ``(vocab, d_model)`` head matrix of
    a (quantized) reference-layout tree, dequantized to ``cfg.dtype``."""
    from distributeddataparallel_tpu_torch.ops.quant import dequantize

    head = (qparams["token_embed"]["embedding"] if cfg.tie_embeddings
            else qparams["lm_head"]["kernel"])
    head = dequantize(head, cfg.dtype)
    return {"final_norm": _norm_weights(dequantize(qparams["final_norm"], cfg.dtype)),
            "head": head if cfg.tie_embeddings else head.t()}


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


# ------------------------------------------------------- safetensors ----

SEP = "/"
# safetensors dtype names <-> numpy; BF16 has no numpy dtype and is read as
# f32 (a bf16 value is the high half of the f32 with the same bits).
_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U64": np.uint64,
    "U32": np.uint32, "U16": np.uint16, "U8": np.uint8, "BOOL": np.bool_,
}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def save_safetensors(arrays: Mapping[str, np.ndarray], path: str) -> None:
    """Write ``arrays`` as a safetensors file: an 8-byte little-endian
    header length, the JSON header (padded with spaces to a multiple of 8),
    then each tensor's little-endian bytes, C order, back to back."""
    header: dict[str, Any] = {}
    blobs, offset = [], 0
    for name in sorted(arrays):
        a = np.asarray(arrays[name])
        if a.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {a.dtype} has no safetensors name")
        raw = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": _ST_NAMES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(len(head).to_bytes(8, "little"))
            fh.write(head)
            for raw in blobs:
                fh.write(raw)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_safetensors(path: str) -> dict[str, np.ndarray]:
    """Read a safetensors file into numpy arrays (``BF16`` as f32)."""
    with open(path, "rb") as fh:
        n = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(n))
    header.pop("__metadata__", None)
    size = os.path.getsize(path) - 8 - n
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n, shape=(size,)) if size else np.zeros(0, np.uint8)
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= size:
            raise ValueError(f"{path}: {name} lies outside the data ({begin}, {end}, {size})")
        raw, shape = data[begin:end], tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = raw.view("<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        elif info["dtype"] in _ST_DTYPES:
            dt = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
            out[name] = np.array(raw.view(dt).reshape(shape), dtype=dt.newbyteorder("="))
        else:
            raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
    return out


def flatten_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> ``{"a/b/c": array}``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_into(like: Mapping, flat: Mapping[str, np.ndarray], *, strict: bool = True) -> dict:
    """Rebuild ``like``'s nested structure from flat keys, shape-checked;
    ``strict`` also rejects keys that ``like`` does not consume."""
    want = flatten_tree(like)
    out: dict = {}
    for key, leaf in want.items():
        if key not in flat:
            raise KeyError(f"missing weight {key!r}")
        arr = np.asarray(flat[key])
        if arr.shape != leaf.shape:
            raise ValueError(f"{key}: shape {arr.shape} != expected {leaf.shape}")
        node = out
        *parents, last = key.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arr.astype(leaf.dtype)
    if strict and (extra := set(flat) - set(want)):
        raise ValueError(f"checkpoint has {len(extra)} unconsumed keys, e.g. "
                         f"{sorted(extra)[:5]} (pass strict=False to ignore)")
    return out


def save_params(params: Mapping, path: str) -> None:
    """A flax-layout tree (nested dicts of arrays) as flat safetensors."""
    save_safetensors(flatten_tree(params), path)


def load_params(path: str, like: Mapping | None = None):
    """The flat dict of a safetensors file; with ``like``, restored into its
    structure (shape-checked)."""
    flat = load_safetensors(path)
    return flat if like is None else unflatten_into(like, flat)


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """A torch ``.pth``/``.pt``/``.bin`` state_dict as numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().float().numpy() if v.dtype == torch.bfloat16 else v.detach().numpy()
            for k, v in sd.items()}


def load_checkpoint_tensors(path: str) -> dict[str, np.ndarray]:
    """Flat name -> array from safetensors (``.safetensors``/``.st``) or a
    torch pickle."""
    if path.endswith((".safetensors", ".st")):
        return load_safetensors(path)
    return load_torch_state_dict(path)


# ---------------------------------------------------------- HF models ----

def convert_gpt2_hf(sd: Mapping[str, np.ndarray], cfg: TransformerConfig) -> dict:
    """HF GPT-2 tensors -> the flax tree (per-layer layout).  HF's Conv1D
    stores (in, out), so kernels need no transpose; ``c_attn`` packs q, k, v
    along the output dim; the head is tied to ``wte``."""
    H, D, d = cfg.num_heads, cfg.dims_per_head, cfg.d_model

    def g(key):
        for k in (key, f"transformer.{key}"):
            if k in sd:
                return np.asarray(sd[k])
        raise KeyError(key)

    params: dict[str, Any] = {
        "token_embed": {"embedding": g("wte.weight")},
        "pos_embed": g("wpe.weight")[: cfg.max_seq_len],
        "final_norm": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
    }
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        qw, kw, vw = np.split(g(p + "attn.c_attn.weight"), 3, axis=1)  # (d, 3d)
        qb, kb, vb = np.split(g(p + "attn.c_attn.bias"), 3)
        params[f"layer_{i}"] = {
            "attn_norm": {"scale": g(p + "ln_1.weight"), "bias": g(p + "ln_1.bias")},
            "attn": {
                "q_proj": {"kernel": qw.reshape(d, H, D), "bias": qb.reshape(H, D)},
                "k_proj": {"kernel": kw.reshape(d, H, D), "bias": kb.reshape(H, D)},
                "v_proj": {"kernel": vw.reshape(d, H, D), "bias": vb.reshape(H, D)},
                "o_proj": {"kernel": g(p + "attn.c_proj.weight").reshape(H, D, d),
                           "bias": g(p + "attn.c_proj.bias")},
            },
            "mlp_norm": {"scale": g(p + "ln_2.weight"), "bias": g(p + "ln_2.bias")},
            "mlp": {
                "up_proj": {"kernel": g(p + "mlp.c_fc.weight"), "bias": g(p + "mlp.c_fc.bias")},
                "down_proj": {"kernel": g(p + "mlp.c_proj.weight"), "bias": g(p + "mlp.c_proj.bias")},
            },
        }
    return params


def convert_llama_hf(sd: Mapping[str, np.ndarray], cfg: TransformerConfig) -> dict:
    """HF Llama tensors -> the flax tree (per-layer layout).  torch Linear
    stores (out, in), so every kernel transposes; q/k/v regroup at their
    head counts, o to (H, D, d).  No RoPE permutation: HF and this port both
    rotate halves.  ``lm_head.weight`` is the untied head."""
    H, Hkv, D, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, cfg.d_model

    def g(key):
        if key in sd:
            return np.asarray(sd[key])
        raise KeyError(key)

    params: dict[str, Any] = {
        "token_embed": {"embedding": g("model.embed_tokens.weight")},
        "final_norm": {"scale": g("model.norm.weight")},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": g("lm_head.weight").T}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        attn = {name: {"kernel": g(p + f"self_attn.{name}.weight").T.reshape(d, heads, D)}
                for name, heads in (("q_proj", H), ("k_proj", Hkv), ("v_proj", Hkv))}
        attn["o_proj"] = {"kernel": g(p + "self_attn.o_proj.weight").T.reshape(H, D, d)}
        params[f"layer_{i}"] = {
            "attn_norm": {"scale": g(p + "input_layernorm.weight")},
            "attn": attn,
            "mlp_norm": {"scale": g(p + "post_attention_layernorm.weight")},
            "mlp": {name: {"kernel": g(p + f"mlp.{name}.weight").T}
                    for name in ("gate_proj", "up_proj", "down_proj")},
        }
    return params


def export_llama_hf(params: Mapping, cfg: TransformerConfig) -> dict[str, np.ndarray]:
    """Inverse of ``convert_llama_hf`` (either layer layout in); every
    output C-contiguous, as safetensors stores raw buffers."""
    if "layers" in params:
        params = unstack_scanned_layers(params, cfg.num_layers)
    H, Hkv, D, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head, cfg.d_model
    sd = {
        "model.embed_tokens.weight": np.asarray(params["token_embed"]["embedding"]),
        "model.norm.weight": np.asarray(params["final_norm"]["scale"]),
    }
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = np.asarray(params["lm_head"]["kernel"]).T
    for i in range(cfg.num_layers):
        lp, p = params[f"layer_{i}"], f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = np.asarray(lp["attn_norm"]["scale"])
        for name, heads in (("q_proj", H), ("k_proj", Hkv), ("v_proj", Hkv)):
            sd[p + f"self_attn.{name}.weight"] = np.asarray(lp["attn"][name]["kernel"]).reshape(d, heads * D).T
        sd[p + "self_attn.o_proj.weight"] = np.asarray(lp["attn"]["o_proj"]["kernel"]).reshape(H * D, d).T
        sd[p + "post_attention_layernorm.weight"] = np.asarray(lp["mlp_norm"]["scale"])
        for name in ("gate_proj", "up_proj", "down_proj"):
            sd[p + f"mlp.{name}.weight"] = np.asarray(lp["mlp"][name]["kernel"]).T
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


# ------------------------------------------------------ ResNet (torch) ----

def convert_resnet_torch(sd: Mapping[str, np.ndarray], model: ResNet) -> dict[str, torch.Tensor]:
    """A torchvision ResNet ``state_dict`` -> ``model``'s state_dict.

    The port's ResNets carry torchvision's submodule names, so every
    parameter and BatchNorm running statistic maps to the key of the same
    name, shape-checked (a class-count mismatch fails at ``fc``).  Keys the
    model does not hold (torchvision's ``num_batches_tracked``) are not
    read, as the reference's ``convert_resnet_torch`` reads only the keys it
    maps."""
    out = {}
    for key, like in model.state_dict().items():
        if key not in sd:
            raise KeyError(f"missing weight {key!r}")
        arr = np.asarray(sd[key])
        if arr.shape != tuple(like.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(like.shape)}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out


def export_resnet_torch(model_or_state_dict) -> dict[str, np.ndarray]:
    """Inverse of ``convert_resnet_torch``: the torchvision layout (conv
    weights OIHW; BatchNorm ``weight``/``bias``/``running_mean``/
    ``running_var``; ``fc``), C-contiguous float32 numpy arrays."""
    sd = model_or_state_dict
    if isinstance(sd, nn.Module):
        sd = sd.state_dict()
    return {k: np.ascontiguousarray(v.detach().float().cpu().numpy()) for k, v in sd.items()}


def load_pretrained(path: str, model: nn.Module) -> dict[str, torch.Tensor]:
    """``model``'s state_dict from a pretrained checkpoint, the format
    sniffed from its key names, as the reference's ``load_pretrained``:

    - a torchvision ResNet state_dict (``conv1.weight`` and ``fc.weight``)
      -> ``convert_resnet_torch`` (parameters and BatchNorm buffers);
    - HF GPT-2 (``wte.weight``) or HF Llama (``model.embed_tokens.weight``)
      tensors, for an LM only: an image model raises ``ValueError``;
    - otherwise this framework's flat safetensors (``save_params`` of the
      flax ``params`` tree, bare or under ``params/``; an image model's
      full variables dump keyed ``params/...`` and ``batch_stats/...``).

    Shapes are checked against the model's; the layer layout of an LM's
    framework file must be the config's."""
    flat = load_checkpoint_tensors(path)
    if "conv1.weight" in flat and "fc.weight" in flat:
        if not isinstance(model, ResNet):
            raise ValueError(f"{path!r} is a torchvision ResNet state_dict, but the target "
                             f"model is a {type(model).__name__} - pass --model resnet18|resnet50")
        return convert_resnet_torch(flat, model)
    cfg = getattr(model, "cfg", None)
    lm_ckpt = any(k in flat for k in ("wte.weight", "transformer.wte.weight", "model.embed_tokens.weight"))
    if not isinstance(cfg, TransformerConfig):
        if lm_ckpt:
            # e.g. --model resnet18 --pretrained gpt2.safetensors: a clear
            # format mismatch beats an error deep in the conversion.
            raise ValueError(
                f"{path!r} looks like a GPT-2/Llama LM checkpoint, but the target model "
                f"({type(model).__name__}) has no TransformerConfig - pass a matching --model")
        like = to_jax_params(model.state_dict(), model)
        if not (flat and all(k.split(SEP, 1)[0] in like for k in flat)):
            flat = {"params" + SEP + k: v for k, v in flat.items()}
        return from_jax_params(unflatten_into(like, flat), model)
    like = to_jax_params(model.state_dict(), cfg)
    tree = None
    if "wte.weight" in flat or "transformer.wte.weight" in flat:
        tree = convert_gpt2_hf(flat, cfg)
    elif "model.embed_tokens.weight" in flat:
        tree = convert_llama_hf(flat, cfg)
    elif flat and all(k.startswith("params" + SEP) for k in flat):
        flat = {k.split(SEP, 1)[1]: v for k, v in flat.items()}
    if tree is not None:  # the converters emit the per-layer layout
        flat = flatten_tree(stack_scanned_layers(tree, cfg.num_layers) if cfg.scan_layers else tree)
    return from_jax_params(unflatten_into(like, flat), cfg)
