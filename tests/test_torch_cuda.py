"""Card-only checks of the flash-attention kernels (marker ``cuda``).

They decide inside a fixture whether a GPU is present and skip without
one.  This file imports nothing of JAX, so on a machine with a GPU and no
JAX it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as in ``chip_smoke.py``, which says why: f32 |kernel - plain|
<= 1e-4 + 1e-4 |plain| (summation order, online softmax; the kernels' 3xTF32
products are f32-accurate); bf16 2e-3 + 1e-2 |plain| (one bf16 ulp of the
result, plus p rounded to bf16 per 64-key tile in K1 and per row in the
plain version).
"""

import pytest
import torch

from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-3, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the CPU tests hold the plain versions to the reference")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,dtype,causal", [
    (2, 130, 130, 4, 4, 64, torch.float32, True),
    (1, 64, 200, 8, 2, 128, torch.bfloat16, True),
    (2, 33, 33, 3, 1, 24, torch.float32, False),
    (1, 100, 180, 2, 1, 256, torch.float32, True),
    # S not a multiple of the 64-row tiles, GQA group 4, and D = 24, which
    # the bf16 kernels pad to 32 in shared memory.
    (2, 130, 130, 8, 2, 64, torch.float32, True),
    (2, 130, 130, 8, 2, 64, torch.bfloat16, True),
    (2, 33, 70, 4, 1, 24, torch.bfloat16, True),
    # bf16 at D = 256: two column chunks of 128 that each recompute the
    # scores (K1's chunks must agree on m and l; only chunk 0 writes lse).
    (1, 200, 333, 4, 2, 256, torch.bfloat16, True),
])
def test_kernels_match_plain_versions(cuda, B, Sq, Skv, H, Hkv, D, dtype, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda S, h: torch.randn(B, S, h, D, generator=g, device=cuda).to(dtype)
    q, k, v, do = mk(Sq, H), mk(Skv, Hkv), mk(Skv, Hkv), mk(Sq, H)
    fa.reset_launches()
    out, lse = fa.flash_fwd(q, k, v, causal)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, causal)
    ref = fa.flash_bwd_plain(q, k, v, out, lse, do, causal)  # the same inputs
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    _close(out, ref_out, dtype)
    _close(lse, ref_lse, torch.float32)
    for got, want in zip((dq, dk, dv), ref):
        _close(got, want, dtype)


def test_fwd_kernel_is_deterministic(cuda):
    """K1 keeps each row's softmax and output inside one warp, with no
    atomics: two launches on the same inputs give the same out and lse."""
    g = torch.Generator(device=cuda).manual_seed(2)
    mk = lambda S, h: torch.randn(2, S, h, 64, generator=g, device=cuda)
    q, k, v = mk(300, 8), mk(300, 2), mk(300, 2)
    first = fa.flash_fwd(q, k, v, True)
    second = fa.flash_fwd(q, k, v, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_dkv_kernel_is_deterministic(cuda):
    """K3 sums each GQA group's gradients inside one block, with no atomics:
    two launches on the same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(1)
    mk = lambda S, h: torch.randn(2, S, h, 64, generator=g, device=cuda)
    q, k, v, do = mk(300, 8), mk(300, 2), mk(300, 2), mk(300, 8)
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.attention_delta(out, do)
    first = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    second = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_kernel_rejects_bad_layout(cuda):
    """A CUDA tensor the kernel cannot read raises; nothing falls back."""
    q = torch.randn(1, 64, 2, 64, device=cuda)
    head_dim_strided = q.transpose(1, 3).contiguous().transpose(1, 3)
    with pytest.raises(ValueError, match="laid out"):
        fa.flash_fwd(head_dim_strided, q, q)
    with pytest.raises(ValueError, match="devices"):
        fa.flash_fwd(q, q.cpu(), q)


def test_model_step_through_kernels_matches_plain(cuda):
    """A 2-layer GPT-2-shaped model: logits and gradients with the kernels
    equal those with plain attention."""
    kw = dict(vocab_size=128, num_layers=2, num_heads=4, d_model=256, d_ff=512, max_seq_len=96)
    grads = {}
    for impl in ("kernel", "plain"):
        model = ttfm.TransformerLM(ttfm.gpt2_124m(attn_impl=impl, **kw), device=cuda,
                                   generator=torch.Generator(device=cuda).manual_seed(0))
        toks = torch.arange(2 * 96, device=cuda).view(2, 96) % 128
        logits = model(toks)
        logits.float().pow(2).mean().backward()
        grads[impl] = (logits.detach(), {n: p.grad for n, p in model.named_parameters()})
    _close(grads["kernel"][0], grads["plain"][0], torch.float32)
    for n, gk in grads["kernel"][1].items():
        _close(gk, grads["plain"][1][n], torch.float32)
