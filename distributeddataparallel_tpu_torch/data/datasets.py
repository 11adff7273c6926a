"""Synthetic LM data: a numpy copy of the reference's ``SyntheticLM``
(``distributeddataparallel_tpu/data/datasets.py``), so both packages train on
identical tokens from the same seed."""

from __future__ import annotations

import numpy as np


class SyntheticLM:
    """Deterministic synthetic token sequences with learnable structure.

    Each sequence follows a fixed random Markov chain over the vocab (one
    transition table per ``proto_seed``), with ``noise`` probability of a
    uniform-random token — so an LM can drive loss toward the chain's
    entropy, and train/eval splits built with different ``seed``s share the
    same underlying process.
    """

    def __init__(
        self,
        num_examples: int = 2048,
        seq_len: int = 128,
        vocab_size: int = 256,
        seed: int = 0,
        proto_seed: int = 0,
        noise: float = 0.1,
        branching: int = 4,
    ):
        proto_rng = np.random.default_rng(proto_seed)
        # Sparse transition table: each token can be followed by `branching`
        # successors, uniformly.
        nxt = proto_rng.integers(
            0, vocab_size, size=(vocab_size, branching), dtype=np.int32
        )
        rng = np.random.default_rng(seed)
        # +1 token so loaders can split into (inputs, targets) shifted pairs.
        toks = np.empty((num_examples, seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, vocab_size, size=num_examples)
        for t in range(1, seq_len + 1):
            choice = rng.integers(0, branching, size=num_examples)
            step = nxt[toks[:, t - 1], choice]
            noisy = rng.random(num_examples) < noise
            rand = rng.integers(0, vocab_size, size=num_examples)
            toks[:, t] = np.where(noisy, rand, step)
        self.tokens = toks
        self.vocab_size = vocab_size
        self.seq_len = seq_len

    def __len__(self) -> int:
        return len(self.tokens)

    def __getitem__(self, idx):
        return {"tokens": self.tokens[idx]}

    def arrays(self) -> dict:
        return {"tokens": self.tokens}
