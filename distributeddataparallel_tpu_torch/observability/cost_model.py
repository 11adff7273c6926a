"""Analytic per-step FLOP accounting + MFU/HFU meters.

A copy of the JAX package's ``observability/cost_model.py``: the FLOP counts
(``transformer_fwd_flops``, ``simple_cnn_fwd_flops``, ``mlp_fwd_flops``,
``train_step_flops``), ``MFUMeter`` and the autotuner's ``predict_step_s``
are the reference's, so both packages
report the same numerator for the same configuration.  Only the
denominator differs: ``peak_flops_for`` reads the card.

Conventions (PaLM appendix B / the pjit-TPUv4 paper), the reference's:

- train step FLOPs = 3x forward (forward + ~2x backward);
- **MFU** counts model FLOPs only; **HFU** additionally counts the
  recompute that rematerialization performs (one extra forward, so 4x);
- gradient accumulation splits the batch into microbatches, it does NOT
  multiply the work — per-step FLOPs are accumulation-invariant;
- attention scores/values are counted over the FULL S×S square (no
  causal halving), matmul terms only (embedding lookups, norms, softmax
  are excluded).

Module-import rule: stdlib only at module scope; ``torch`` is imported
inside ``peak_flops_for``.
"""

from __future__ import annotations

# Peak dense matmul rate of one card, FLOP/s, by the step's matmul dtype.
# H100 SXM (NVIDIA data sheet, dense): f32 on the CUDA cores (the port runs
# f32 with TF32 off) and bf16 on the tensor cores.  Denominators for a
# relative utilization number, as in the reference.
PEAK_FLOPS_PER_CARD = {
    "h100": {"float32": 67e12, "bfloat16": 989e12},
}


def peak_flops_for(device, dtype="float32") -> float | None:
    """The card's peak FLOP/s for matmuls in ``dtype`` (a ``torch.dtype``
    or its name), from ``torch.cuda.get_device_name``; None on the CPU or
    an unknown card — better no MFU than one against a wrong denominator."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    dtype = str(dtype).removeprefix("torch.")
    for key, peaks in PEAK_FLOPS_PER_CARD.items():
        if key in name:
            return peaks.get(dtype)
    return None


def transformer_fwd_flops(cfg, *, batch: int, seq_len: int) -> int:
    """Matmul FLOPs of one forward pass at global ``batch`` x ``seq_len``.

    ``cfg`` is a ``models.transformer.TransformerConfig`` (duck-typed:
    only the size fields are read, so a plain namespace works in tests).
    Covers MHA/GQA, gelu (2-mat) and swiglu (3-mat) MLPs, and MoE blocks
    in both dispatch modes: dense dispatch (``moe_capacity_factor == 0``)
    runs every token through every expert (FLOPs scale with E), token-
    choice dispatch scales with top-k (capacity-dropped tokens still
    occupy their slot's FLOPs — the chip does the work whether or not
    the token keeps the result).
    """
    T = batch * seq_len
    d = cfg.d_model
    heads = cfg.num_heads
    head_dim = cfg.head_dim or d // heads
    kv_heads = getattr(cfg, "num_kv_heads", None) or heads
    attn_dim = heads * head_dim

    qkv = 2 * T * d * (attn_dim + 2 * kv_heads * head_dim)
    scores_values = 2 * 2 * batch * heads * seq_len * seq_len * head_dim
    out_proj = 2 * T * attn_dim * d

    if getattr(cfg, "activation", "gelu") == "swiglu":
        mlp_mats = 3  # gate, up, down
    else:
        mlp_mats = 2  # up, down
    mlp_one = mlp_mats * 2 * T * d * cfg.d_ff

    moe_experts = getattr(cfg, "moe_experts", 0)
    if moe_experts:
        router = 2 * T * d * moe_experts
        if getattr(cfg, "moe_capacity_factor", 0.0) > 0:
            # Token-choice: each token occupies top-k expert slots.
            mlp = getattr(cfg, "moe_top_k", 1) * mlp_one + router
        else:
            # Dense einsum dispatch: every token through every expert.
            mlp = moe_experts * mlp_one + router
    else:
        mlp = mlp_one

    logits = 2 * T * d * cfg.vocab_size
    return cfg.num_layers * (qkv + scores_values + out_proj + mlp) + logits


def simple_cnn_fwd_flops(
    *,
    batch: int,
    image_shape: tuple[int, ...],
    widths: tuple[int, ...] = (32, 64),
    num_classes: int = 10,
    kernel: int = 3,
) -> int:
    """Matmul/conv FLOPs of one ``models.SimpleCNN`` forward pass.

    SAME-padded kxk convs at full resolution followed by 2x2 max-pool
    per block, then a global-mean head — mirrors the module exactly so
    the analytic number tracks the real program within conv-padding
    noise (the reference's tests pin it against XLA's cost analysis).
    """
    h, w, c_in = image_shape
    flops = 0
    for c_out in widths:
        flops += 2 * batch * h * w * kernel * kernel * c_in * c_out
        h, w, c_in = h // 2, w // 2, c_out
    flops += 2 * batch * c_in * num_classes
    return flops


def mlp_fwd_flops(
    *,
    batch: int,
    in_features: int,
    features: tuple[int, ...] = (128, 128),
    num_classes: int = 10,
) -> int:
    """Dense FLOPs of one ``models.TinyMLP`` forward pass."""
    flops, fan_in = 0, in_features
    for f in features:
        flops += 2 * batch * fan_in * f
        fan_in = f
    return flops + 2 * batch * fan_in * num_classes


def train_step_flops(
    fwd_flops: int, *, remat: bool = False, flop_signature: dict | None = None
) -> dict:
    """Per-optimizer-step FLOPs from one full-batch forward count.

    ``flop_signature`` is the train-step factory's handoff
    (``make_train_step(...).flop_signature``): it records that the
    factory's microbatching divides the batch rather than repeating it
    (``microbatch_fraction``) — so N accumulation microbatches of B/N
    tokens cost exactly one batch of B, and this function deliberately
    takes the FULL-batch forward count and ignores the accumulation
    degree.  ``model_flops`` is the MFU numerator (3x forward);
    ``hardware_flops`` is the HFU numerator (4x under remat: the
    backward replays the forward).
    """
    mult = 3
    if flop_signature is not None:
        mult = flop_signature.get("train_flop_multiplier", mult)
    return {
        "model_flops": mult * fwd_flops,
        "hardware_flops": (mult + 1 if remat else mult) * fwd_flops,
    }


#: Assumed achieved fraction of peak for the autotuner's analytic step-time
#: prediction — deliberately a single scalar, not a tuned model: the
#: autotuner uses predictions only to RANK candidates (a shared
#: efficiency factor cancels in the ranking), and ddp_report's
#: predicted-vs-measured drift table shows how wrong it was.
DEFAULT_EFFICIENCY = 0.35


def predict_step_s(
    hardware_flops: float,
    *,
    n_chips: int,
    peak_flops_per_chip: float | None,
    efficiency: float = DEFAULT_EFFICIENCY,
) -> float | None:
    """Analytic step-time prediction: hardware FLOPs over assumed
    achieved throughput.  None when the peak is unknown (better no
    prediction than one against a made-up denominator — same policy as
    ``peak_flops_for``).  This is the autotuner's pruning/ranking
    signal; measured windows are the ground truth it drifts against.
    """
    if not peak_flops_per_chip or hardware_flops <= 0:
        return None
    return float(hardware_flops) / (
        peak_flops_per_chip * max(1, n_chips) * efficiency
    )


class MFUMeter:
    """Turns throughput readings into MFU/HFU gauges and events.

    Construction is pure host work; ``on_reading`` runs only at the
    StepTimer's window boundaries (where the loop already drained), so
    the meter adds zero per-step cost and zero device syncs.  With an
    unknown peak (``peak_flops_per_chip`` None) the meter still reports
    absolute model FLOP/s — an honest number beats a made-up fraction.
    """

    def __init__(
        self,
        step_flops: dict,
        *,
        n_chips: int,
        peak_flops_per_chip: float | None,
        registry=None,
        events=None,
    ):
        self.model_flops = float(step_flops["model_flops"])
        self.hardware_flops = float(
            step_flops.get("hardware_flops", step_flops["model_flops"])
        )
        self.n_chips = n_chips
        self.peak = peak_flops_per_chip
        self.registry = registry
        self.events = events

    def on_reading(self, reading: dict, *, step: int) -> dict:
        """Consume one StepTimer reading; returns (and records) the
        MFU numbers for that throughput window."""
        steps_per_s = reading["steps_per_s"]
        out = {
            "model_flops_per_s": steps_per_s * self.model_flops,
            "mfu": None,
            "hfu": None,
        }
        if self.peak:
            denom = self.peak * self.n_chips
            out["mfu"] = steps_per_s * self.model_flops / denom
            out["hfu"] = steps_per_s * self.hardware_flops / denom
        if self.registry is not None:
            g = self.registry.gauge
            g("model_flops_per_s").set(round(out["model_flops_per_s"], 1))
            if out["mfu"] is not None:
                g("mfu").set(round(out["mfu"], 6))
                g("hfu").set(round(out["hfu"], 6))
        if self.events is not None:
            self.events.emit(
                "mfu",
                step=step,
                mfu=out["mfu"],
                hfu=out["hfu"],
                model_flops_per_s=out["model_flops_per_s"],
                peak_flops_per_chip=self.peak,
                n_chips=self.n_chips,
            )
        return out
