"""Card-only checks of the serving path (marker ``cuda``), beside
``test_torch_cuda.py``.  They decide inside a fixture whether a GPU is
present and skip without one, and import nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py -q

- The decode twin's logits (a contiguous prefill, single-token steps and
  a per-row window over the KV cache) equal the plain full forward's on
  the card, f32 with TF32 off: the same f32 products summed in other
  orders by cuBLAS kernels chosen per shape, atol 1e-4 on logits of
  |logit| < 1.
- The engine's greedy continuations equal ``generate()``'s on the card,
  except where the full forward's top-2 logits are within 1e-4 (a tie at
  the f32 rounding of differently shaped GEMMs), after which the two may
  part.
- bf16 (Llama-shaped, GQA): the decode twin, cast to bf16 once, against
  the non-decode bf16 forward through the flash kernel K1: hidden states
  of two bf16 paths differ by an ulp (2^-8 relative) here and there, so
  the logits are held to 3e-2 absolute (|logit| < 2).
"""

import numpy as np
import pytest
import torch

from distributeddataparallel_tpu_torch.models import generate as tgen
from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.ops import flash_attention as fa
from distributeddataparallel_tpu_torch.serving import EngineConfig, InferenceEngine

pytestmark = pytest.mark.cuda

GPT2ISH = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=128, d_ff=512, max_seq_len=64,
               positional="learned", norm="layernorm", activation="gelu", tie_embeddings=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the CPU tests hold the serving path to the reference")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(cuda, **kw):
    cfg = ttfm.tiny_lm(**{**GPT2ISH, **kw})
    return ttfm.TransformerLM(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))


@torch.no_grad()
def test_decode_logits_match_full_forward(cuda):
    model = _model(cuda, attn_impl="plain")
    toks = torch.randint(0, 512, (2, 24), device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    full = model(toks)
    prefill, decode = tgen.make_step_fns(model)
    cache = tgen.init_cache(tgen.decode_model(model), 2)
    lg, _ = prefill(cache, toks[:, :16], torch.arange(16, device=cuda))
    torch.testing.assert_close(lg, full[:, :16], atol=1e-4, rtol=0)
    for t in range(16, 20):
        lg, _ = decode(cache, toks[:, t:t + 1], torch.tensor([t], device=cuda))
        torch.testing.assert_close(lg[:, 0], full[:, t], atol=1e-4, rtol=0)
    win = torch.arange(20, 24, device=cuda).repeat(2, 1)
    lg, _ = decode(cache, toks[:, 20:24], win)
    torch.testing.assert_close(lg, full[:, 20:24], atol=1e-4, rtol=0)


@torch.no_grad()
def test_engine_matches_generate(cuda):
    model = _model(cuda)
    engine = InferenceEngine(model, EngineConfig(num_slots=4, num_blocks=24, block_size=8, prefill_chunk=16))
    rng = np.random.default_rng(2)
    cases = [(5, 20), (16, 12), (30, 9), (8, 25), (12, 7)]
    rids = {engine.submit(rng.integers(0, 512, p, dtype=np.int32), n): n for p, n in cases}
    engine.run()
    for rid, n in rids.items():
        got = torch.from_numpy(engine.output_tokens(rid)).to(cuda).long()
        P = got.shape[0] - n
        want = tgen.generate(model, got[None, :P], n)[0]
        diff = torch.nonzero(got != want)
        if diff.numel():
            t = int(diff[0, 0])
            top2 = model(want[None, :t])[0, -1].topk(2).values
            assert float(top2[0] - top2[1]) < 1e-4, (rid, t, top2.tolist())


@torch.no_grad()
def test_bf16_decode_twin_against_the_k1_forward(cuda):
    model = _model(cuda, positional="rope", norm="rmsnorm", activation="swiglu", num_kv_heads=2,
                   tie_embeddings=False, head_dim=64, d_model=256, dtype=torch.bfloat16)
    toks = torch.randint(0, 512, (2, 48), device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    fa.reset_launches()
    full = model(toks)  # attn_impl "auto": K1 on the card
    assert fa.LAUNCHES["flash_fwd"] == 2
    dm = tgen.decode_model(model)
    assert all(p.dtype == torch.bfloat16 for p in dm.parameters())  # cast once
    lg = dm(toks, positions=torch.arange(48, device=cuda), cache=tgen.init_cache(dm, 2))
    assert fa.LAUNCHES["flash_fwd"] == 2  # the decode twin never calls the kernels
    torch.testing.assert_close(lg, full, atol=3e-2, rtol=0)
