"""The port's data pipeline and bucket plan against the JAX package's, on
the CPU: ``SyntheticLM`` tokens, sampler indices and ``plan_buckets`` are
identical (exact equality), and the loader's masked tail covers each
example once.
"""

import numpy as np
import pytest
import torch

from distributeddataparallel_tpu import native
from distributeddataparallel_tpu.data.datasets import SyntheticLM as JSyntheticLM
from distributeddataparallel_tpu.parallel.sampler import DistributedSampler as JSampler
from distributeddataparallel_tpu_torch.data.datasets import SyntheticLM
from distributeddataparallel_tpu_torch.data.loader import DataLoader
from distributeddataparallel_tpu_torch.parallel import data_parallel as tdp
from distributeddataparallel_tpu_torch.parallel.sampler import DistributedSampler


def test_synthetic_lm_tokens_identical():
    kw = dict(num_examples=20, seq_len=33, vocab_size=50, seed=7)
    np.testing.assert_array_equal(SyntheticLM(**kw).tokens, JSyntheticLM(**kw).tokens)


@pytest.mark.parametrize("n,replicas,shuffle,drop_last,epoch", [
    (10, 3, True, False, 0), (10, 3, True, True, 2), (7, 4, False, False, 1), (3, 5, True, False, 1),
])
def test_sampler_indices_identical(n, replicas, shuffle, drop_last, epoch):
    for rank in range(replicas):
        a = DistributedSampler(n, replicas, rank, shuffle=shuffle, seed=5, drop_last=drop_last)
        b = JSampler(n, replicas, rank, shuffle=shuffle, seed=5, drop_last=drop_last)
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        np.testing.assert_array_equal(a.local_indices(), b.local_indices())
        assert len(a) == len(b)


@pytest.mark.parametrize("bucket_bytes", [1, 100, 1000, 10**9])
def test_plan_buckets_identical(bucket_bytes):
    leaf_bytes = list(np.random.default_rng(0).integers(1, 400, size=17))
    assert tdp.plan_buckets(leaf_bytes, bucket_bytes) == native.plan_buckets(leaf_bytes, bucket_bytes)
    assert tdp.plan_buckets([], 10) == []


def test_loader_masked_tail_covers_each_example_once():
    """drop_last=False with the pad mask: across ranks, the valid rows are
    exactly the dataset, each once."""
    ds = SyntheticLM(num_examples=11, seq_len=4, vocab_size=9)
    seen = []
    for rank in range(3):
        loader = DataLoader(ds, per_replica_batch=2, rank=rank, num_replicas=3,
                            shuffle=True, seed=1, drop_last=False, with_mask=True)
        assert len(loader) == 2
        for batch in loader:
            assert batch["tokens"].dtype == torch.int64
            rows = batch["tokens"][batch["valid"] > 0].numpy()
            seen.extend(map(tuple, rows))
    assert sorted(seen) == sorted(map(tuple, ds.tokens))
