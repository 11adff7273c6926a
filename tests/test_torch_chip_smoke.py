"""The CPU-side arithmetic of ``chip_smoke.py``, checked without a GPU.

- ``visible_pairs`` counts the (q, k) pairs the mask leaves, against a
  numpy mask built as the kernels build it (queries aligned to the end of
  kv), and ``bound`` turns them into the least time at the GPT-2 shapes.
- ``ptxas_report`` names each kernel instantiation from the compiler's
  mangled names and keeps its register and spill counts.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.mark.parametrize("Sq,Skv,causal", [
    (1024, 1024, True), (77, 300, True), (384, 1024, True), (200, 200, False), (1, 5, True),
])
def test_visible_pairs_and_bound(Sq, Skv, causal):
    c = dict(chip_smoke.GPT2, Sq=Sq, Skv=Skv, causal=causal)
    q_pos = (Skv - Sq) + np.arange(Sq)[:, None]
    visible = np.arange(Skv)[None, :] <= q_pos if causal else np.ones((Sq, Skv), bool)
    assert chip_smoke.visible_pairs(c) == int(visible.sum())

    # K1 at the GPT-2 shapes: two products of 2 D flops per visible pair,
    # 12.9 GFLOP at the 3xTF32 rate, far above its ~100 MB at HBM3's rate.
    flops = 2 * 64 * int(visible.sum()) * 8 * 12 * 2
    ms, by = chip_smoke.bound(c, 2, bytes_moved=100e6)
    if (Sq, Skv) == (1024, 1024):
        assert by == "operations"
        assert ms == pytest.approx(flops / (495e12 / 3) * 1e3, rel=1e-12)
        assert ms == pytest.approx(0.0782, abs=1e-4)
    else:
        assert ms == pytest.approx(max(flops / (495e12 / 3), 100e6 / 3.35e12) * 1e3, rel=1e-12)


def test_ptxas_report_names_each_instantiation():
    fwd_f32 = "_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi4ELi32ELi64ELi64EEEvNS_6ParamsE"
    dq_bf16 = "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelI13__nv_bfloat16Li4ELi64ELi128ELi128EEEvNS_6ParamsE"
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{fwd_f32}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd_f32}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 167 registers, used 1 barriers, 480 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{dq_bf16}' for 'sm_90a'",
        f"ptxas info    : Function properties for {dq_bf16}",
        "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 480 bytes cmem[0]",
    ])
    assert chip_smoke.ptxas_report(log) == [
        "flash_fwd_kernel<float,4,32,64,64>: 167 registers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "flash_bwd_dq_kernel<bf16,4,64,128,128>: 255 registers; "
        "16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads",
    ]
