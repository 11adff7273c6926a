"""Memmapped token-file dataset: the LM path on real tokens.

A numpy copy of the reference's ``distributeddataparallel_tpu/data/tokens.py``
(it imports nothing of JAX; the port keeps its own copy), so both packages
window a corpus into the same rows:

- **Storage**: one ``.npy`` integer array, a flat stream ``(N,)`` or
  pre-chunked rows ``(n, seq_len+1)``, opened with ``mmap_mode="r"``.
- **Windowing**: flat streams give windows starting every ``stride``
  tokens (default ``seq_len``); window ``i`` is
  ``stream[i*stride : i*stride + S + 1]``, the +1 carrying the last
  position's next-token target.  The batch gather is one sliding-window
  view fancy-indexed at the window starts.
- **Sampler semantics**: windows are rows, so the sampler's padding,
  striding and epoch reshuffle and the loader's masked eval apply
  unchanged.
- **Vocab**: an optional ``FILE.json`` sidecar (``{"vocab_size": V}``)
  pins the vocab (the CLI sizes the model from it, overriding
  ``--vocab-size``), and every gathered batch is range-checked against it:
  an embedding lookup would otherwise fail on the card only, or not at all.

``encode_bytes`` is a byte-level tokenizer (vocab 256) for test corpora.
"""

from __future__ import annotations

import json
import os

import numpy as np


def encode_bytes(text: str) -> np.ndarray:
    """Byte-level tokenization: UTF-8 bytes as token ids (vocab 256)."""
    return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(
        np.int32
    )


def write_token_file(
    path: str, tokens: np.ndarray, *, vocab_size: int | None = None
) -> str:
    """Save a token stream/rows as the dataset's .npy (+ vocab sidecar).

    Smallest lossless integer dtype is chosen automatically (uint16
    covers GPT-2's 50257-token vocab at half the int32 bytes).
    """
    tokens = np.asarray(tokens)
    if not np.issubdtype(tokens.dtype, np.integer):
        raise ValueError(f"tokens must be integers, got {tokens.dtype}")
    if tokens.size and int(tokens.min()) < 0:
        raise ValueError("negative token ids")
    hi = int(tokens.max()) if tokens.size else 0
    dt = np.uint16 if hi < 2**16 else np.int32
    np.save(path, np.ascontiguousarray(tokens.astype(dt)))
    if not path.endswith(".npy"):
        path += ".npy"
    if vocab_size is not None:
        with open(path + ".json", "w") as fh:
            json.dump({"vocab_size": int(vocab_size)}, fh)
    return path


class TokenFileDataset:
    """Next-token LM windows over a memmapped token file.

    ``stride`` (flat streams only) spaces window starts ``stride`` tokens
    apart; ``stride < seq_len`` yields overlapping windows — more training
    rows from a small corpus, the nanoGPT random-offset sampling made
    deterministic so the sampler's pad/stride/epoch semantics still apply.
    Default ``stride=seq_len`` keeps the non-overlapping layout.
    """

    def __init__(self, path: str, *, seq_len: int, stride: int | None = None):
        if not os.path.exists(path):
            raise FileNotFoundError(f"no token file at {path}")
        arr = np.load(path, mmap_mode="r")
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(
                f"{path}: token files hold integers, got {arr.dtype}"
            )
        self.seq_len = seq_len
        self.stride = seq_len if stride is None else stride
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")
        self._arr = arr
        if arr.ndim == 1:
            if len(arr) < seq_len + 1:
                raise ValueError(
                    f"{path}: stream of {len(arr)} tokens is shorter than "
                    f"one window (seq_len+1 = {seq_len + 1})"
                )
            # window i covers [i*stride, i*stride + seq_len + 1); with the
            # default stride=seq_len this is the classic (N-1)//S count.
            self._n = (len(arr) - seq_len - 1) // self.stride + 1
            self._rows = False
        elif arr.ndim == 2:
            if stride is not None and stride != seq_len:
                raise ValueError(
                    f"{path}: stride applies to flat streams; pre-chunked "
                    "row files fix their own window layout"
                )
            if arr.shape[1] != seq_len + 1:
                raise ValueError(
                    f"{path}: rows are {arr.shape[1]} wide, need "
                    f"seq_len+1 = {seq_len + 1}"
                )
            self._n = arr.shape[0]
            self._rows = True
        else:
            raise ValueError(f"{path}: rank-{arr.ndim} token array")
        self.vocab_size = None
        sidecar = path + ".json"
        if os.path.exists(sidecar):
            with open(sidecar) as fh:
                self.vocab_size = json.load(fh).get("vocab_size")

    def __len__(self) -> int:
        return self._n

    def gather(self, idx) -> dict:
        """Batch of windows (loader fast path): {"tokens": (B, S+1) i32}."""
        idx = np.asarray(idx, dtype=np.int64)
        if self._rows:
            out = np.asarray(self._arr[idx], np.int32)
        else:
            if idx.size and (idx.min() < 0 or idx.max() >= self._n):
                # The sliding-window view would wrap negative indices to
                # window starts that aren't on the dataset's stride grid
                # — silently wrong text (the old per-row loop failed
                # loudly here; keep that contract).
                raise IndexError(
                    f"window indices must be in [0, {self._n}); got "
                    f"[{idx.min()}, {idx.max()}]"
                )
            # One vectorized gather: a zero-copy sliding-window view over
            # the memmap, fancy-indexed at the window starts — numpy does
            # the whole batch copy in C (the old per-row Python loop was
            # the one data path with no fast path).
            view = np.lib.stride_tricks.sliding_window_view(
                self._arr, self.seq_len + 1
            )
            out = view[idx * self.stride].astype(np.int32, copy=False)
        if self.vocab_size is not None and out.size:
            hi, lo = int(out.max()), int(out.min())
            if hi >= self.vocab_size or lo < 0:
                # Caught here, on the host: on the card an out-of-range id
                # would surface as an asynchronous device assert.
                raise ValueError(
                    f"token ids [{lo}, {hi}] out of range for sidecar "
                    f"vocab_size {self.vocab_size} — corpus/sidecar "
                    "mismatch"
                )
        return {"tokens": out}

    def __getitem__(self, idx):
        return {"tokens": self.gather([idx])["tokens"][0]}
