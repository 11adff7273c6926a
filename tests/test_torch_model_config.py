"""The port's named transformer configs, on the CPU: GPT-2 124M at full
width with the reference's shapes and initialization scales, and every
config feature outside the port's slice raising ``NotImplementedError``
that names its ROADMAP item.
"""

import pytest
import torch

from distributeddataparallel_tpu.models import transformer as jtfm
from distributeddataparallel_tpu_torch.models import transformer as ttfm


def test_gpt2_124m_is_full_width():
    """The named config and the port's initialization: shapes, parameter
    count and the reference's init scales."""
    cfg = ttfm.gpt2_124m(num_layers=2)
    jcfg = jtfm.gpt2_124m(num_layers=2)
    for f in ("vocab_size", "num_heads", "d_model", "d_ff", "max_seq_len", "kv_heads", "dims_per_head"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    gen = torch.Generator().manual_seed(0)
    model = ttfm.TransformerLM(cfg, generator=gen)
    n = sum(p.numel() for p in model.parameters())
    # embeddings + 2 layers of (12 d^2 weights + 13 d biases and norm
    # params) + the final norm
    assert n == 50257 * 768 + 1024 * 768 + 2 * (12 * 768 * 768 + 13 * 768) + 2 * 768
    o_std = float(model.layers[0].attn.o_proj.weight.detach().std())
    assert abs(o_std - 0.02 / 2.0) < 1e-3  # 0.02 / sqrt(2 * layers)
    assert abs(float(model.token_embed.weight.detach().std()) - 0.02) < 1e-3
    assert float(model.layers[1].mlp.up_proj.bias.abs().sum()) == 0.0


@pytest.mark.parametrize(
    "override",
    [dict(cp_axis="seq"), dict(tp_axis="model"), dict(moe_experts=4), dict(decode=True),
     dict(grad_sync_axis="data"), dict(quant_serving=True)],
)
def test_features_outside_the_slice_raise(override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttfm.TransformerLM(ttfm.tiny_lm(**override))
