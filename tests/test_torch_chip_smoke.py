"""The CPU-side arithmetic of ``chip_smoke.py``, checked without a GPU.

- ``visible_pairs`` counts the (q, k) pairs the mask leaves, against a
  numpy mask built as the kernels build it (queries aligned to the end of
  kv), and ``bound`` turns them into the least time at the GPT-2 shapes.
- ``ptxas_report`` names each kernel instantiation from the compiler's
  mangled names and keeps its register and spill counts.
- Phase 11's runs are the layouts the port ships, each accepted by the
  port's entry point, and its deepest Llama keeps the stated spare memory
  by the phase's own arithmetic; the kernels line carries their launches.
- Phase 12's replays on CPU tensors at tiny shapes (the kernels' plain
  versions stand in): the module's flash ring, its ranks as threads,
  against one full-sequence call and against the hop-by-hop plain oracle,
  and the module's Ulysses (native and repeated kv heads), within the
  phase's own tolerances; the TP=2 block within its 4-ulp bound; 12c's
  flags parse.
- Phase 14's argument lists (14a, 14b, 14c's runs) pass the port's parser
  and layout checks, build the MoE configs the phase names, 14c's runs keep
  one data replica, and 14a's 1-layer model holds the 2.50 B parameters
  its memory reckoning counts.
- Phase 15's replays at tiny widths (the module's GPipe, 1F1B, zb and
  interleaved 1F1B, stages as threads; 15d's PP x CP with ring and Ulysses,
  every (stage, seq rank) a thread) within the phase's bounds, with the
  launches, held microbatches and unit counts the schedules imply; zb's
  gradients 1F1B's bit for bit; 15c's and 15c+'s runs parse.
"""

import importlib.util
import shutil
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


def test_phase11_layouts_parse_and_the_deep_llama_fits():
    from distributeddataparallel_tpu_torch import dpp

    assert set(chip_smoke.LAYOUTS) == {"plain", "bucket_mb_1", "overlap", "bf16_hook", "powersgd_r4",
                                       "zero1", "zero2", "zero3"}
    for extra in chip_smoke.LAYOUTS.values():
        args = dpp.parse_args(chip_smoke.LAYOUT_ARGS + extra)
        assert (args.model, args.seq_len, args.vocab_size, args.steps_per_epoch) == ("gpt2", 1024, 50257, 5)
    for md in ("f32", "int8", "bf16"):
        args = dpp.parse_args(chip_smoke.LLAMA_ZERO_ARGS + ["--moment-dtype", md])
        assert (args.zero, args.layers, args.steps_per_epoch, args.eval) == (2, 8, 10, False)
    # The comment's arithmetic: 8 layers at 34.87 GiB, 1.98 GiB a layer,
    # 5 GiB of 79.18 kept.
    fits = [L for L in range(8, 33) if 34.87 + 1.98 * (L - 8) <= 79.18 - chip_smoke.LLAMA_SPARE_GIB]
    assert chip_smoke.LLAMA_DEEP_LAYERS == max(fits) == 27
    src = (ROOT / "chip_smoke.py").read_text()
    assert '"launches_layouts": layouts["attention_launches"][name]' in src


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phase12_replays_hold_on_the_cpu(monkeypatch, dtype):
    import torch

    from distributeddataparallel_tpu_torch import dpp
    from distributeddataparallel_tpu_torch.models import transformer as tfm
    from distributeddataparallel_tpu_torch.ops import flash_attention as fa
    from distributeddataparallel_tpu_torch.parallel import context_parallel as cp

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    c = dict(B=1, Sq=256, Skv=256, H=8, Hkv=2, D=32, n=4, dtype=dtype)
    q, k, v, do = chip_smoke.inputs(torch, c, 0)
    oracle = chip_smoke.full_oracle(fa, q, k, v, do)
    bf16 = dtype == "bfloat16"
    slack = {key: (0.0, c["n"] * chip_smoke.ULP_BF16 if bf16 else 0.0) for key in ("dq", "dk", "dv")}
    replay = chip_smoke.ring_replay(torch, cp, q, k, v, do, c["n"])
    chip_smoke.hold(torch, replay, oracle, dtype, slack, "ring")
    slack = {key: (0.0, (c["n"] - 1) * chip_smoke.ULP_BF16 if bf16 else 0.0) for key in ("dq", "dk", "dv")}
    chip_smoke.hold(torch, replay, chip_smoke.plain_ring(torch, fa, cp, q, k, v, do, c["n"]), dtype, slack, "plain")
    assert [len(f) for f, _ in replay["received"]] == [c["n"] - 1] * c["n"]
    assert [len(b) for _, b in replay["received"]] == [2 * c["n"] - 1] * c["n"]
    for m in (2, 8):  # the kv heads travel as they are, then repeated to 8
        rep = cp.ulysses_kv_repeat(c["H"], c["Hkv"], m)
        got = chip_smoke.ulysses_replay(torch, cp, q, k, v, do, m)
        slack = {key: (0.0, (rep - 1) * chip_smoke.ULP_BF16) for key in ("dk", "dv")}
        chip_smoke.hold(torch, got, {key: oracle[key] for key in got}, dtype, slack, f"ulysses {m}")
    if bf16:
        monkeypatch.setattr(chip_smoke, "TP_BLOCK", dict(B=1, S=32, tp=2))
        small = dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
        real = tfm.llama3_8b
        monkeypatch.setattr(tfm, "llama3_8b", lambda **kw: real(**{**small, **kw}))
        errs = chip_smoke.tp_block_replay(torch, tfm, torch.bfloat16)["max_abs_err"]
        assert set(errs) >= {"out", "dx", "d:attn.q_proj.weight", "d:mlp.down_proj.weight"}
    for extra in chip_smoke.CP_TP_ENTRY.values():
        args = dpp.parse_args(chip_smoke.CP_TP_ENTRY_ARGS + extra)
        assert (args.layers, args.seq_len, args.steps_per_epoch) == (8, 2048, 3)


def test_phase14_flags_parse_and_the_reckoning_holds():
    import torch

    from distributeddataparallel_tpu_torch import dpp
    from distributeddataparallel_tpu_torch.models import transformer as tfm

    gpt2 = [a.replace("{ckpt}", "ck") for a in chip_smoke.GPT2_MOE_ARGS]
    runs = [chip_smoke.LLAMA_MOE_ARGS, gpt2, chip_smoke.MOE_ENTRY_ARGS]
    runs += [chip_smoke.MOE_ENTRY_ARGS + extra + ["--num-processes", str(gpus)]
             for extra, gpus in chip_smoke.MOE_ENTRY.values()]
    for argv in runs:
        args = dpp.parse_args(argv)
        cfg = dpp.build_config(args)
        assert (cfg.moe_experts, cfg.moe_top_k) == (8, 2)
        assert args.num_processes in (None, args.ep * args.tp * args.cp)  # one data replica
    llama = dpp.build_config(dpp.parse_args(chip_smoke.LLAMA_MOE_ARGS))
    assert (llama.num_layers, llama.d_model, llama.d_ff, llama.vocab_size, llama.moe_capacity_factor) == (
        1, 4096, 14336, 128256, 1.25)
    assert dpp.build_config(dpp.parse_args(gpt2)).moe_capacity_factor == 0.0  # 14b: dense dispatch
    assert dpp.build_config(dpp.parse_args(chip_smoke.MOE_ENTRY_ARGS)).moe_capacity_factor == 8.0  # = E
    n = sum(p.numel() for p in tfm.TransformerLM(llama, device="meta").parameters())
    assert abs(n - 2.50e9) < 0.01e9, n


def test_phase15_replays_hold_on_the_cpu(monkeypatch):
    """Phase 15's replays at tiny widths on CPU tensors: the module's GPipe,
    1F1B, zb and interleaved 1F1B, every stage a thread (``LocalPipe``),
    within the phase's own bounds of the unpipelined step; each stage alone
    (``CannedPipe``) launches what ``pp_expected`` says (the kernels' plain
    versions stand in, counted here); 1F1B holds n - s microbatches, GPipe
    M; zb's gradients are 1F1B's bit for bit; 15d's four threads (ring and
    Ulysses over ``LocalRing``) launch K1-K3 per live hop; 15c's and 15c+'s
    runs parse with the mesh they name."""
    import torch

    from distributeddataparallel_tpu_torch import dpp
    from distributeddataparallel_tpu_torch.models import transformer as tfm
    from distributeddataparallel_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    peaks = iter([3, 1] * 2 + [1, 1])  # the 15b order: GPipe, then 1F1B, at each M; zb, 1F1B v=2
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: next(peaks))
    small = dict(vocab_size=64, num_heads=2, d_model=32, d_ff=64, attn_impl="kernel")
    gpt2, llama = tfm.gpt2_124m, tfm.llama3_8b
    monkeypatch.setattr(tfm, "gpt2_124m", lambda **kw: gpt2(**{**small, "max_seq_len": 64, "num_layers": 4, **kw}))
    monkeypatch.setattr(tfm, "llama3_8b", lambda **kw: llama(**{**small, "num_kv_heads": 1, **kw}))
    monkeypatch.setattr(chip_smoke, "LLAMA_LAYERS", 4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(chip_smoke, "PP_GPT2", dict(B=4, S=16, M=4))
    monkeypatch.setattr(chip_smoke, "PP_GPT2_RUNS", [(2, "gpipe", 1), (2, "1f1b", 1), (2, "zb", 1), (2, "1f1b", 2),
                                                     (4, "gpipe", 1), (4, "1f1b", 1), (4, "zb", 1)])
    monkeypatch.setattr(chip_smoke, "PP_LLAMA", dict(B=4, S=16, n=2, M=(2, 4)))
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(fa, key)

        def counted(*a, _real=real, _key=key, **kw):
            fa.LAUNCHES[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(fa, key, counted)
    try:
        out = chip_smoke.pp_phase(torch, fa, tfm, "cpu")
    finally:
        torch.set_num_threads(threads)
    a, b, d = out["gpt2_12_layers"], out["llama_8_layers"], out["cp"]
    assert a["n4"]["1f1b"]["held"] == [4, 3, 2, 1] and a["n4"]["gpipe"]["held"] == [4] * 4
    assert a["n2"]["1f1b"]["counts"] == [[4, 4, 0], [4, 4, 0]] and a["n2"]["1f1b"]["bubble"] == 0.3333
    assert a["n2"]["zb"]["counts"] == [[4, 4, 4], [4, 4, 4]] and a["n2"]["1f1b_v2"]["counts"] == [[8, 8, 0]] * 2
    assert a["n2"]["zb"]["vs_1f1b"]["bitwise"] and a["n4"]["zb"]["vs_1f1b"]["bitwise"]
    assert b["1f1b_m4"]["launches"] == {"flash_fwd": 40, "flash_bwd_dq": 16, "flash_bwd_dkv": 16}
    assert b["zb_m4"]["vs_1f1b"]["bitwise"] and b["1f1b_m4_v2"]["counts"] == [[8, 8, 0]] * 2
    # 15d: 2 layers a stage, M = 4, 2 seq ranks; the ring's seq rank q runs 1 + q hops.
    assert d["ring_gpipe"]["launches"] == {"flash_fwd": 48, "flash_bwd_dq": 48, "flash_bwd_dkv": 48}
    assert d["ulysses_1f1b"]["launches"] == {"flash_fwd": 48, "flash_bwd_dq": 32, "flash_bwd_dkv": 32}
    assert out["entry"] == {"ran": False, "gpus": 0} and out["entry_16b"] == {"ran": False, "gpus": 0}
    for argv, want in ((chip_smoke.PP_DEEP_ARGS + ["--pp", "4"], (32, 8, 8, 0.0)),
                       (chip_smoke.PP_ENTRY_ARGS + ["--pp", "2", "--tp", "2"], (8, 4, None, 0.0)),
                       (chip_smoke.PP_MOE_ARGS + ["--pp", "2", "--ep", "2"], (2, 2, None, 8.0))):
        args = dpp.parse_args(argv)
        cfg = dpp.build_config(args)
        assert (cfg.num_layers, args.batch_size, args.pp_microbatches, cfg.moe_capacity_factor) == want
        assert cfg.scan_layers and args.seq_len == 2048
    for extra, gpus in chip_smoke.PP_ENTRY_16B.values():
        args = dpp.parse_args(chip_smoke.PP_ENTRY_ARGS + extra + ["--num-processes", str(gpus)])
        assert args.pp * args.cp == gpus and dpp.build_config(args).num_layers % (args.pp * args.pp_virtual) == 0


def test_phase16_runs_on_the_cpu(monkeypatch, tmp_path):
    """Phase 16 at tiny widths on the CPU: 16a's depths bit for bit, 16b's
    poisoned step skipped exactly (sync debug mode is the card's alone);
    16c's record of 9a's supervised replay (``start_replay``: a worker dead
    at step 6 of 12, one restart) under a fresh compile cache, both
    incarnations' ``warm_start`` read from the merged timeline (no kernel
    is built on the CPU, so both say ``cache-hit``) and the restart split."""
    import torch

    from distributeddataparallel_tpu_torch import dpp
    from distributeddataparallel_tpu_torch.training import warm_start

    lm = ["--model", "gpt2", "--layers", "2", "--d-model", "32", "--seq-len", "16", "--vocab-size", "64",
          "--num-examples", "64", "--batch-size", "4", "--optimizer", "adamw", "--lr", "1e-2",
          "--steps-per-epoch", "6", "--epochs", "1"]
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DEPTH_RUNS", {
        "gpt2": (lm, ["--profile-steps", "2:4"], (0, 2)),
        "cnn": (["--model", "cnn", "--num-examples", "64", "--batch-size", "8", "--epochs", "1",
                 "--steps-per-epoch", "6"], ["--profile-steps", "2:4"], (0, 2, 2, 0))})
    monkeypatch.setattr(chip_smoke, "FAULT_LM_ARGS", lm)
    monkeypatch.setattr(chip_smoke, "GUARD_ARGS", lm + ["--nan-guard", "--dispatch-depth", "2"])
    monkeypatch.setattr(chip_smoke, "REPLAY_ARGS", chip_smoke._set(lm, "--steps-per-epoch", "4")
                        + ["--device", "cpu", "--epochs", "3"])
    monkeypatch.setattr(warm_start, "_cache_dir", None)
    monkeypatch.setenv(warm_start.ENV, "")
    warm_start.enable_compile_cache(str(tmp_path / "cache"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        replay, d = chip_smoke.start_replay()
        try:
            chaotic = chip_smoke.finish_entry(replay, "9a")
            records = chip_smoke.timeline(str(Path(d) / "ev"))
        finally:
            shutil.rmtree(d, ignore_errors=True)
        restart = chip_smoke.restart_record(chaotic, records)
        out = chip_smoke.warm_start_phase(torch, dpp, {"warm_start": "cold"}, restart, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert all(r["bitwise"] and len(r["losses"]) == 6 for r in out["depths"].values())
    assert len(out["depths"]["cnn"]["depth2"]["runs"]) == 2
    g = out["guard"]
    assert g["skip_exact"] and g["losses"][chip_smoke.GUARD_POISON] is None and len(g["runs_ms"]["on"]) == 2
    r = out["restart"]
    assert r["modes"] == {0: "cache-hit", 1: "cache-hit"} and chaotic["start_epoch"] == 1
    split = r["split"]
    assert split["checkpoint_read_s"] > 0 and split["death_to_first_step_s"] > split["first_step_s"] > 0


def test_phase20_runs_on_the_cpu(monkeypatch):
    """Phase 20's search and apply at the MLP on the CPU (20a's checks: the
    measured trials, their statuses, the store, the run's knobs and
    launches, none for the MLP; 20b's probe at world 1), and 20c's runs
    parse."""
    import torch

    from distributeddataparallel_tpu_torch import dpp
    from distributeddataparallel_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TUNE_ARGS", [
        "--model", "mlp", "--dataset", "synthetic", "--batch-size", "8", "--epochs", "1", "--steps-per-epoch", "4",
        "--num-examples", "64", "--eval", "--tune-trials", "3", "--tune-steps", "2"])
    monkeypatch.setattr(chip_smoke, "TUNE_TRIAL_STEPS", 3)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = chip_smoke.tuning_phase(torch, dpp, fa, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert out["attention_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert len(out["trials"]) == 4 and out["refused"] == 0 and out["knobs"]["batch_size"] in (8, 16, 32, 64)
    assert out["bw_probe"]["devices"] == 1 and out["bw_probe"]["utilization"] == 0.0
    args = dpp.parse_args(chip_smoke.TUNE_ENTRY_ARGS + ["--num-processes", "4", "--device", "cpu"])
    assert args.bw_probe and args.num_processes == 4
    lm = dpp.parse_args(chip_smoke.TUNE_ARGS + ["--autotune", "search"])
    assert lm.autotune == "search" and lm.tune_trials == 3
