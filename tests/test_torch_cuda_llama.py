"""Card-only checks of the Llama path (marker ``cuda``), beside
``test_torch_cuda.py`` (kept at 12 tests or fewer, ROADMAP.md).

They decide inside a fixture whether a GPU is present and skip without
one, and import nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py -q

- remat on and off give the same logits and gradients with dropout on (the
  recompute redraws the same masks; the kernels and cuBLAS are
  deterministic at fixed shapes, so only the bf16 tolerance's one-ulp
  slack, 2e-3 + 1e-2 |value| as in ``chip_smoke.py``, is allowed), and K1
  runs twice per layer under remat;
- the bf16 LM head's f32-output product on the card against its CPU
  formula: forward, the same bf16 products summed in another order,
  1e-4 + 1e-4 |logit|; backward, the card rounds the f32 cotangent to bf16
  before its products and each result to bf16, so 2e-2 of the largest
  |value|.
"""

import dataclasses

import pytest
import torch

from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the CPU tests hold the model to the reference")
    return torch.device("cuda")


def _close_bf16(a, b):
    torch.testing.assert_close(a.float(), b.float(), atol=2e-3, rtol=1e-2)


def test_remat_with_dropout_matches_no_remat(cuda):
    cfg = ttfm.llama3_8b(vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=1, d_model=256,
                         d_ff=512, max_seq_len=96, dropout_rate=0.1)
    toks = torch.arange(2 * 96, device=cuda).view(2, 96) * 7 % 512
    runs = {}
    for remat in (True, False):
        model = ttfm.TransformerLM(dataclasses.replace(cfg, remat=remat), device=cuda,
                                   generator=torch.Generator(device=cuda).manual_seed(0))
        fa.reset_launches()
        logits = model(toks, dropout_seed=1234)
        logits.pow(2).mean().backward()
        torch.cuda.synchronize()
        runs[remat] = (logits.detach(), {n: p.grad for n, p in model.named_parameters()}, dict(fa.LAUNCHES))
    assert runs[True][2] == {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert runs[False][2] == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    _close_bf16(runs[True][0], runs[False][0])
    for n, g in runs[True][1].items():
        _close_bf16(g, runs[False][1][n])


def test_f32_head_matches_its_cpu_formula(cuda):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 256, generator=g).to(torch.bfloat16)
    w = torch.randn(1000, 256, generator=g) * 0.02
    gout = torch.randn(64, 1000, generator=g)
    res = {}
    for dev in ("cpu", cuda):
        xd, wd = (t.detach().to(dev).requires_grad_() for t in (x, w))
        out = ttfm.f32_logits(xd, wd, torch.bfloat16)
        out.backward(gout.to(dev))
        res[str(dev)] = (out.detach().cpu(), xd.grad.cpu(), wd.grad.cpu())
    (out_c, dx_c, dw_c), (out_g, dx_g, dw_g) = res["cpu"], res["cuda"]
    assert out_g.dtype == torch.float32 and (out_g != out_g.to(torch.bfloat16).float()).float().mean() > 0.5
    torch.testing.assert_close(out_g, out_c, atol=1e-4, rtol=1e-4)
    assert dx_g.dtype == torch.bfloat16 and dw_g.dtype == torch.float32
    for got, want in ((dx_g, dx_c), (dw_g, dw_c)):
        assert float((got.float() - want.float()).abs().max()) <= 2e-2 * float(want.float().abs().max())
