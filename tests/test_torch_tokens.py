"""Token-file corpora in the port (``data/tokens.py``) against the JAX
package's, on the CPU.

- ``write_token_file`` writes the reference's bytes (the smallest lossless
  integer dtype, the ``FILE.json`` vocab sidecar).
- ``TokenFileDataset`` gives the reference's batches for a flat stream (at
  the default stride and an overlapping one) and for pre-chunked rows, with
  the sidecar's vocab; its errors and range check are the reference's.
- ``tokens:FILE`` in ``dpp``: the sibling val split, the sidecar sizing the
  model, token rows through the sampler and the masked eval (each window
  once over the ranks), and ``--model llama`` losses against the reference
  CLI's on the same token file.

Everything but the last is integer data, compared exactly.  The CLI runs
train the bf16 Llama stack (remat on) from the same weights, so their
losses agree to the bf16 tolerance that ``test_torch_llama.py`` derives
(1e-3 on a loss), plus 5e-5 for the reference's log rounding to 4 places.
"""

import json
import logging
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import dpp as jdpp  # noqa: E402  the reference entry point

from distributeddataparallel_tpu.data import tokens as jtok  # noqa: E402
from distributeddataparallel_tpu.parallel.sampler import DistributedSampler as JSampler  # noqa: E402
from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.data import tokens as ttok  # noqa: E402
from distributeddataparallel_tpu_torch.data.loader import DataLoader  # noqa: E402

SEQ = 16


def _stream(tmp_path, n=40 * SEQ + 1, vocab=80, name="corpus.npy", seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, size=n)
    path = str(tmp_path / name)
    return ttok.write_token_file(path, toks, vocab_size=vocab), toks


@pytest.mark.parametrize("layout,stride", [("stream", None), ("stream", 5), ("rows", None)])
def test_batches_equal_the_references(tmp_path, layout, stride):
    toks = np.random.default_rng(1).integers(0, 300, size=(24, SEQ + 1) if layout == "rows" else 30 * SEQ + 3)
    path = ttok.write_token_file(str(tmp_path / "t.npy"), toks, vocab_size=300)
    ours = ttok.TokenFileDataset(path, seq_len=SEQ, stride=stride)
    ref = jtok.TokenFileDataset(path, seq_len=SEQ, stride=stride)
    assert len(ours) == len(ref) and ours.vocab_size == ref.vocab_size == 300
    idx = np.random.default_rng(2).permutation(len(ref))[:7]
    a, b = ours.gather(idx)["tokens"], ref.gather(idx)["tokens"]
    assert a.dtype == b.dtype == np.int32 and a.shape == (7, SEQ + 1)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[3]["tokens"], ref[3]["tokens"])
    if layout == "stream":
        s = stride or SEQ
        np.testing.assert_array_equal(a[0], toks[idx[0] * s: idx[0] * s + SEQ + 1])


@pytest.mark.parametrize("hi", [50256, 128255])
def test_write_token_file_writes_the_references_bytes(tmp_path, hi):
    toks = np.random.default_rng(3).integers(0, hi + 1, size=500)
    toks[0] = hi
    ours = ttok.write_token_file(str(tmp_path / "a"), toks, vocab_size=hi + 1)
    ref = jtok.write_token_file(str(tmp_path / "b"), toks, vocab_size=hi + 1)
    assert ours.endswith("a.npy") and ref.endswith("b.npy")
    assert np.load(ours).dtype == (np.uint16 if hi < 2**16 else np.int32)
    assert Path(ours).read_bytes() == Path(ref).read_bytes()
    assert json.loads(Path(ours + ".json").read_text()) == {"vocab_size": hi + 1}
    np.testing.assert_array_equal(ttok.encode_bytes("héllo"), jtok.encode_bytes("héllo"))


def test_errors_and_range_check_are_the_references(tmp_path):
    path, _ = _stream(tmp_path, vocab=80)
    with open(path + ".json", "w") as fh:
        json.dump({"vocab_size": 40}, fh)  # a sidecar that the corpus exceeds
    for mod in (ttok, jtok):
        ds = mod.TokenFileDataset(path, seq_len=SEQ)
        with pytest.raises(ValueError, match="out of range"):
            ds.gather([0, 1])
        with pytest.raises(IndexError):
            ds.gather([-1])
        with pytest.raises(ValueError, match="shorter than one window"):
            mod.TokenFileDataset(path, seq_len=10_000)
        with pytest.raises(FileNotFoundError):
            mod.TokenFileDataset(str(tmp_path / "missing.npy"), seq_len=SEQ)
    rows = ttok.write_token_file(str(tmp_path / "rows.npy"), np.zeros((4, SEQ + 1), int))
    for mod in (ttok, jtok):
        with pytest.raises(ValueError, match="stride applies to flat streams"):
            mod.TokenFileDataset(rows, seq_len=SEQ, stride=4)


@pytest.mark.parametrize("train_name,val_name", [("train.npy", "val.npy"), ("c.npy", "c.val.npy")])
def test_eval_reads_the_sibling_val_split(tmp_path, train_name, val_name):
    _stream(tmp_path, name=train_name, seed=4)
    _stream(tmp_path, name=val_name, n=10 * SEQ + 1, seed=5)
    flags = ["--device", "cpu", "--model", "llama", "--dataset", f"tokens:{tmp_path / train_name}",
             "--seq-len", str(SEQ), "--token-stride", "8"]
    for train in (True, False):
        ours = tdpp.build_dataset(tdpp.parse_args(flags), train=train)
        ref = jdpp.build_dataset(jdpp.parse_args(flags), train=train)
        assert len(ours) == len(ref) == (79 if train else 10)  # the stride is the train split's only
        np.testing.assert_array_equal(ours.gather(np.arange(len(ours)))["tokens"],
                                      ref.gather(np.arange(len(ref)))["tokens"])
    os.remove(tmp_path / val_name)
    with pytest.raises(SystemExit, match="val split"):
        tdpp.build_dataset(tdpp.parse_args(flags), train=False)


def test_loader_gives_each_rank_its_rows_and_masks_the_padding(tmp_path):
    """Token windows through the sampler: rank r's rows are the reference
    sampler's indices for replica r, and the eval mask counts each of the
    41 windows once over 3 ranks."""
    path, _ = _stream(tmp_path, n=41 * SEQ + 1)
    ds = ttok.TokenFileDataset(path, seq_len=SEQ)
    valid_rows = []
    for rank in range(3):
        smp = JSampler(len(ds), num_replicas=3, rank=rank, shuffle=True, seed=7, drop_last=False)
        smp.set_epoch(2)
        own = np.asarray(list(iter(smp)))
        loader = DataLoader(ds, per_replica_batch=4, rank=rank, num_replicas=3, shuffle=True,
                            seed=7, drop_last=False, with_mask=True)
        loader.set_epoch(2)
        batches = list(loader)
        rows = np.concatenate([b["tokens"].numpy() for b in batches])
        valid = np.concatenate([b["valid"].numpy() for b in batches]).astype(bool)
        np.testing.assert_array_equal(rows, ds.gather(own)["tokens"])
        valid_rows += [tuple(r) for r in rows[valid]]
    assert len(valid_rows) == len(set(valid_rows)) == 41


def test_the_sidecar_sizes_the_model(tmp_path):
    path, _ = _stream(tmp_path, vocab=80)
    flags = ["--device", "cpu", "--model", "llama", "--dataset", f"tokens:{path}", "--seq-len", str(SEQ),
             "--layers", "1", "--d-model", "64", "--vocab-size", "64", "--batch-size", "4"]
    trainer = tdpp.build_trainer(tdpp.parse_args(flags), tdpp.device_for(tdpp.parse_args(flags)))
    ref = jdpp.build_model(jdpp.parse_args(flags), vocab_size=80)
    assert trainer.state.model.cfg.vocab_size == ref.cfg.vocab_size == 80
    assert trainer.state.model.token_embed.weight.shape == (80, 64)


def test_cli_llama_losses_match_the_reference_cli(tmp_path):
    """``dpp --model llama`` on a token file, port and reference, from the
    same weights: the port loads the reference's initial params through
    ``--pretrained`` (``save_params`` of the reference's init), and both
    train 4 SGD steps on the same rows (the reference over its 8 CPU
    replicas of 1 row each, the port one process of 8 rows: the same global
    batch)."""
    import jax
    import jax.numpy as jnp

    from distributeddataparallel_tpu.models import io as jio
    from distributeddataparallel_tpu.utils.logging import get_logger

    path, _ = _stream(tmp_path, n=32 * SEQ + 1, vocab=64)
    flags = ["--device", "cpu", "--model", "llama", "--dataset", f"tokens:{path}", "--seq-len", str(SEQ),
             "--layers", "2", "--d-model", "64", "--optimizer", "sgd", "--lr", "0.1",
             "--steps-per-epoch", "4", "--epochs", "1", "--log-every", "1"]
    jargs = jdpp.parse_args(flags + ["--batch-size", "1"])
    jmodel = jdpp.build_model(jargs, vocab_size=64)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    init = str(tmp_path / "init.safetensors")
    jio.save_params(params, init)
    jargs.pretrained = init
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    get_logger().addHandler(handler)
    try:
        ref_last = jdpp.train(jargs)
    finally:
        get_logger().removeHandler(handler)
    ref = [float(m.group(1)) for msg in messages if (m := re.search(r"Batch \d+, Loss: ([\d.]+)", msg))]
    ours = tdpp.main(flags + ["--batch-size", "8", "--pretrained", init])
    assert ours["train_steps"] == len(ref) == 4
    np.testing.assert_allclose(ours["losses"], ref, atol=1e-3 + 5e-5, rtol=0)
    assert abs(ours["losses"][-1] - ref_last) <= 1e-3
