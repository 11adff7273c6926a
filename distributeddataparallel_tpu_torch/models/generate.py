"""Autoregressive generation with a KV cache (greedy / temperature /
top-k sampling).

Counterpart of ``distributeddataparallel_tpu/models/generate.py``:

- The per-layer KV caches are allocated at ``max_seq_len`` up front
  (``init_cache``: a list of ``(k, v)`` pairs of ``(B, max_seq_len,
  kv_heads, head_dim)``; under ``scan_layers`` views of one stacked
  ``(L, B, ...)`` tensor each, the reference's stacked cache), the prompt
  is consumed in ONE prefill call, then single-token decode steps follow.
  The decode twin (``decode_model``) writes the caches in place.
- Positions are explicit: prefill passes ``arange(P)``, decode step t the
  single global position ``P + t``.
- Sampling runs in f32 on the final-position logits: greedy argmax when
  ``temperature == 0``, else softmax sampling with optional top-k
  truncation, drawn from the caller's ``torch.Generator``.  It cannot
  equal ``jax.random.categorical`` bit for bit (different generators);
  greedy decoding is what is held to the reference.
- bf16 configs cast their f32 params to bf16 once, when the twin is built
  (the reference's one-time cast in ``_generate_jit``), so decode streams
  half the bytes and ``_dense``'s per-use casts are no-ops.
- ``quantize="int8"`` serves the matrices from the int8 tree of
  ``ops.quant``; the twin dequantizes one layer at a time.

Everything runs on the model's device and reads nothing back to the host
between steps.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from distributeddataparallel_tpu_torch.models.transformer import TransformerLM


def _sample(logits: torch.Tensor, generator, temperature: float, top_k: int | None) -> torch.Tensor:
    """Next-token ids (B,) from final-position logits (B, V)."""
    logits = logits.float()
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]  # (B, 1)
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _live_params(cfg, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The serving param policy for dense params: f32 masters cast to the
    compute dtype once (decode streams every matrix each step), other
    leaves as they are; f32 configs share the masters."""
    if cfg.dtype == torch.float32:
        return params
    return {k: v.to(cfg.dtype) if v.dtype == torch.float32 else v for k, v in params.items()}


def decode_model(model: TransformerLM, *, quant_serving: bool = False) -> TransformerLM:
    """The decode twin of a TransformerLM: KV-cache attention, remat,
    dropout and sequence sharding off, the model's params (``_live_params``: shared in f32, one
    cast copy in a lower compute dtype).  ``quant_serving`` twins compute
    from an int8 tree (``forward(qparams=...)``) and share the masters
    only for their shapes."""
    cfg = dataclasses.replace(model.cfg, decode=True, remat=False, dropout_rate=0.0,
                              cp_axis=None, quant_serving=quant_serving)
    if model.cfg == cfg:
        return model
    params = {k: p.detach() for k, p in model.named_parameters()}
    if not quant_serving:
        params = _live_params(cfg, params)
    twin = TransformerLM(cfg, device="meta")
    twin.load_state_dict(params, assign=True)
    if cfg.positional == "rope":
        twin.rope_cos, twin.rope_sin = model.rope_cos, model.rope_sin
    return twin.eval().requires_grad_(False)


def _quant_decode_model(model: TransformerLM) -> TransformerLM:
    """Decode twin for int8 serving: every layout dequantizes per layer
    (the reference does so for scanned configs, ``_ScanBlock``)."""
    return decode_model(model, quant_serving=True)


def quantize_model(model: TransformerLM):
    """The model's int8 serving tree (``ops.quant``), in the reference's
    layout: scanned configs quantize the stacked layers with per-layer
    scales.  Quantize once and pass the tree to every call."""
    from distributeddataparallel_tpu_torch.models.io import jax_layout
    from distributeddataparallel_tpu_torch.ops.quant import quantize_for_decode

    return quantize_for_decode(jax_layout(model), model.cfg.scan_layers)


def _device(model: TransformerLM) -> torch.device:
    return model.token_embed.weight.device


def init_cache(model: TransformerLM, batch_size: int, *, device=None) -> list:
    """Zeroed KV caches for ``batch_size`` rows: a per-layer list of
    ``(k, v)`` of shape ``(B, max_seq_len, kv_heads, head_dim)`` in the
    compute dtype; under ``scan_layers`` each pair is a view of one
    stacked ``(L, B, ...)`` tensor."""
    cfg = model.cfg
    device = device or _device(model)
    shape = (batch_size, cfg.max_seq_len, cfg.kv_heads, cfg.dims_per_head)
    if cfg.scan_layers:
        k, v = (torch.zeros((cfg.num_layers, *shape), dtype=cfg.dtype, device=device) for _ in range(2))
        return [(k[i], v[i]) for i in range(cfg.num_layers)]
    return [tuple(torch.zeros(shape, dtype=cfg.dtype, device=device) for _ in range(2))
            for _ in range(cfg.num_layers)]


def make_step_fns(model: TransformerLM, *, qparams=None):
    """The reference's ``(prefill_fn, decode_fn)`` over ``model``'s decode
    twin, each ``(cache, tokens, positions) -> (logits, cache)``.  The twin
    takes either position form (a shared ``(S,)`` range or a per-row
    ``(B, S)`` matrix) and writes the cache in place, so both are one
    function.  ``qparams`` (``quantize_model``) serves the matrices int8.
    Allocate the cache with :func:`init_cache`."""
    dm = decode_model(model) if qparams is None else _quant_decode_model(model)

    def step(cache, tokens, positions):
        return dm(tokens, positions=positions, cache=cache, qparams=qparams), cache

    return step, step


@torch.no_grad()
def generate(
    model: TransformerLM,
    prompt: torch.Tensor,
    max_new_tokens: int,
    *,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: int | None = None,
    quantize: str | None = None,
    qparams=None,
    timings: dict | None = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` (B, P).

    ``model`` is any TransformerLM (a training config is fine: its decode
    twin is built here).  Returns (B, P + max_new_tokens) int64 on the
    model's device.  ``temperature=0`` is greedy; otherwise pass
    ``generator`` (on the model's device) for sampling (``top_k``
    truncates first).  ``quantize="int8"`` serves the matrices int8
    (``qparams``, if given, is the tree of ``quantize_model`` and is used
    as is).  ``timings``, if given, receives ``prefill_s`` and
    ``decode_s`` (host clock, the device synchronized at each end).
    """
    B, P = prompt.shape
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if P + max_new_tokens > model.cfg.max_seq_len:
        raise ValueError(f"prompt {P} + max_new_tokens {max_new_tokens} exceeds "
                         f"max_seq_len {model.cfg.max_seq_len}")
    if temperature < 0.0:
        raise ValueError("temperature must be >= 0")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    if quantize == "int8" and qparams is None:
        qparams = quantize_model(model)
    dm = decode_model(model) if qparams is None else _quant_decode_model(model)
    device = _device(dm)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    prompt = prompt.to(device=device, dtype=torch.long)
    positions = torch.arange(P + max_new_tokens, device=device)
    cache = init_cache(dm, B)
    if timings is not None:
        sync()
        t0 = time.perf_counter()
    logits = dm(prompt, positions=positions[:P], cache=cache, qparams=qparams)
    tok = _sample(logits[:, -1], generator, temperature, top_k)
    if timings is not None:
        sync()
        t1 = time.perf_counter()
    out = [tok]
    # N - 1 decode steps: step t feeds the token at global position t and
    # samples the one after it, so no apply is wasted.
    for t in range(P, P + max_new_tokens - 1):
        logits = dm(tok[:, None], positions=positions[t:t + 1], cache=cache, qparams=qparams)
        tok = _sample(logits[:, -1], generator, temperature, top_k)
        out.append(tok)
    if timings is not None:
        sync()
        timings.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
