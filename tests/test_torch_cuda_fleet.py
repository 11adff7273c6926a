"""Card-only checks of the serving fleet (marker ``cuda``), beside
``test_torch_cuda_serving.py``.  They decide inside a fixture whether a GPU
is present and skip without one, and import nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py -q

- A handoff round trip of pools on the card (unrolled bf16, scanned int8):
  the blocks' wire bytes equal those of the same pool copied to the host,
  and ``unpack_blocks`` -> ``set_pool_blocks`` lands them bitwise.
- A 1:2 ``ServingFleet`` on the card generates the single engine's tokens
  (f32, TF32 off), with the allocator's invariants held on every step;
  where they differ, the plain full forward's top-2 logits are within 1e-4
  at the first differing position (a tie at the f32 rounding of
  differently shaped GEMMs), after which the two may part.
"""

import numpy as np
import pytest
import torch

from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.serving import (
    EngineConfig,
    FleetConfig,
    InferenceEngine,
    ServingFleet,
    VirtualClock,
)
from distributeddataparallel_tpu_torch.serving import handoff as th
from distributeddataparallel_tpu_torch.serving import kv_cache as tkv

pytestmark = pytest.mark.cuda

GPT2ISH = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=128, d_ff=512, max_seq_len=64,
               positional="learned", norm="layernorm", activation="gelu", tie_embeddings=True)
ENGINE = dict(num_slots=4, num_blocks=48, block_size=8, prefill_chunk=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the CPU tests hold the fleet to the reference")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(device, **kw):
    cfg = ttfm.tiny_lm(**{**GPT2ISH, **kw})
    return ttfm.TransformerLM(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))


@pytest.mark.parametrize("layout", ["unrolled_bf16", "scanned_int8"])
def test_handoff_round_trip_of_cuda_pools(cuda, layout):
    kw = {"dtype": torch.bfloat16} if layout == "unrolled_bf16" else {"scan_layers": True, "num_layers": 3}
    model = _model(cuda, num_kv_heads=2, **kw)
    quant = layout == "scanned_int8"
    pool = tkv.make_pool(model, 12, 8, quantized_kv=quant)
    g = torch.Generator(device=cuda).manual_seed(1)
    for pair in pool:
        for leaf in pair:
            for t in (leaf.values() if tkv._is_qkv(leaf) else (leaf,)):
                if t.dtype == torch.int8:
                    t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=cuda, dtype=torch.int8))
                else:
                    t.copy_(torch.randn(t.shape, generator=g, device=cuda).to(t.dtype))
    scanned = model.cfg.scan_layers
    ids = [7, 2, 10]
    sent = th.extract_kv_blocks(pool, ids, scanned=scanned)

    def host(leaf):
        return {k: v.cpu() for k, v in leaf.items()} if tkv._is_qkv(leaf) else leaf.cpu()

    assert sent == th.extract_kv_blocks([tuple(host(x) for x in pair) for pair in pool], ids, scanned=scanned)
    assert len(sent[0]) == th.block_nbytes(pool)
    rows = th.unpack_blocks(pool, sent, scanned=scanned)
    assert all(t.is_cuda for pair in rows for leaf in pair for t in (leaf.values() if tkv._is_qkv(leaf) else (leaf,)))
    tkv.set_pool_blocks(pool, rows, torch.tensor([1, 3, 5], device=cuda))
    assert th.extract_kv_blocks(pool, [1, 3, 5], scanned=scanned) == sent


@torch.no_grad()
def test_fleet_equals_the_single_engine_on_the_card(cuda):
    model = _model(cuda)
    ecfg = EngineConfig(**ENGINE)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, n).tolist() for n in (16, 13, 21, 8, 30)]
    clock = VirtualClock()
    fleet = ServingFleet(model, ecfg, FleetConfig(prefill=1, decode=2), time_fn=clock, check_invariants=True)
    fids = [fleet.submit(p, 12) for p in prompts]
    steps = 0
    while fleet.has_work():
        fleet.step()
        clock.tick()
        steps += 1
        assert steps < 500
    single = InferenceEngine(model, ecfg, time_fn=VirtualClock())
    rids = [single.submit(p, 12) for p in prompts]
    single.run()
    s = fleet.summary()
    assert s["handoffs"] == len(prompts) and s["dropped_req_total"] == 0
    for p, f, r in zip(prompts, fids, rids):
        a, b = list(fleet.completed[f].generated), list(single.completed[r].generated)
        if a != b:
            t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            logits = model(torch.as_tensor([p + a[:t]], device=cuda))[0, -1].float()
            top2 = torch.topk(logits, 2).values
            assert float(top2[0] - top2[1]) < 1e-4, (f, t)
