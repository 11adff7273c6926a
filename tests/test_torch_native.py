"""The port's native host kernels (``distributeddataparallel_tpu_torch.native``)
against their numpy versions and the JAX package's native library, on the CPU.

Every comparison is bit for bit (tolerance 0): the kernels copy bytes, or
compute ``(x * f32(1/255) - shift) * f32(1/scale)`` in float32 with no fused
multiply-add, which the numpy versions compute in the same order and the
reference's library computes from the same source.  Cases cover padding
edges (offsets 0 and 2 * pad), flips, ``rows=(first, total)`` slices,
negative and empty indices; out-of-range indices raise; the loader's
batches with the fused augment equal the reference loader's; a source that
does not compile raises instead of taking the numpy path.
"""

import jax
import numpy as np
import pytest

import distributeddataparallel_tpu as ddp
from distributeddataparallel_tpu import native as jnative
from distributeddataparallel_tpu.data import datasets as jds
from distributeddataparallel_tpu.data import sharded as jsh
from distributeddataparallel_tpu.data import transforms as jtr
from distributeddataparallel_tpu.data.loader import DataLoader as JLoader
from distributeddataparallel_tpu_torch import native
from distributeddataparallel_tpu_torch.data import datasets as tds
from distributeddataparallel_tpu_torch.data import sharded as tsh
from distributeddataparallel_tpu_torch.data import transforms as ttr
from distributeddataparallel_tpu_torch.data.loader import DataLoader
from distributeddataparallel_tpu_torch.training import warm_start
from torch_cores import share_of_the_cores  # noqa: F401 -- an autouse fixture

IDX = {
    "rows": np.array([3, 0, 7, 7, 11]),
    "negative": np.array([-1, 2, -12]),
    "empty": np.array([], dtype=np.int64),
}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == np.ascontiguousarray(b).tobytes()


def _u8(n=12, shape=(6, 5, 3), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape), dtype=np.uint8)


@pytest.mark.parametrize("case", sorted(IDX))
def test_gathers_bit_equal_numpy_and_reference(case, monkeypatch):
    """On one thread and on as many as the call may start."""
    idx = IDX[case]
    u8 = _u8()
    f32 = np.random.default_rng(1).normal(size=(12, 4, 3)).astype(np.float32)
    wrapped = idx % 12
    native.reset_calls()
    for per_thread in (native.BYTES_PER_THREAD, 1):
        monkeypatch.setattr(native, "BYTES_PER_THREAD", per_thread)
        got = native.gather_normalize_u8(u8, idx, shift=0.25, scale=0.75)
        _same(got, native.gather_normalize_u8_numpy(u8, idx, shift=0.25, scale=0.75))
        _same(got, jnative.gather_normalize_u8(u8, wrapped, shift=0.25, scale=0.75))
        rows = native.gather_rows(f32, idx)
        _same(rows, native.gather_rows_numpy(f32, idx))
        _same(rows, jnative.gather_rows(f32, wrapped))
    assert native.CALLS["gather_normalize_u8"] == native.CALLS["gather_rows"] == 2


@pytest.mark.parametrize("pad", [4, 0])
def test_gather_augment_bit_equal_at_padding_edges_and_flips(pad, monkeypatch):
    src = _u8(10, (7, 9, 3), seed=2)
    idx = np.array([9, 0, 4, 4, 1, -3])
    oy = np.array([0, 2 * pad, pad, 0, 2 * pad, 1 if pad else 0])  # both edges
    ox = np.array([2 * pad, 0, pad, 2 * pad, 0, 0])
    flip = np.array([1, 1, 0, 0, 1, 0])
    kw = dict(padding=pad, shift=0.5, scale=0.5, fill=-1.0)
    got = native.gather_augment_u8(src, idx, oy, ox, flip, **kw)
    _same(got, native.gather_augment_u8_numpy(src, idx, oy, ox, flip, **kw))
    monkeypatch.setattr(native, "BYTES_PER_THREAD", 1)  # one row a thread
    _same(native.gather_augment_u8(src, idx, oy, ox, flip, **kw), got)
    _same(got, jnative.gather_augment_u8(src, idx % 10, oy, ox, flip, **kw))
    if pad:  # the fill is exactly -1 where the crop left the image
        assert (got[0, :pad] == -1.0).all() and (got[0, :, :pad] == -1.0).all()  # flipped
        assert (got[1, -pad:] == -1.0).all() and (got[1, :-pad, pad:] != -1.0).any()


def test_chw_to_hwc_bit_equal(monkeypatch):
    src = np.random.default_rng(4).normal(size=(3, 4, 5, 6)).astype(np.float32)
    got = native.chw_to_hwc(src)
    _same(got, native.chw_to_hwc_numpy(src))
    _same(got, jnative.chw_to_hwc(src))
    monkeypatch.setattr(native, "BYTES_PER_THREAD", 1)
    _same(native.chw_to_hwc(src), got)
    assert native.threads_for(10**9) == native.DEFAULT_THREADS and native.threads_for(0) == 1
    _same(native.chw_to_hwc(src[:, ::2]), native.chw_to_hwc_numpy(src[:, ::2]))  # strided: numpy


def test_out_of_range_indices_raise():
    u8 = _u8()
    for bad in (12, -13):
        idx = np.array([0, bad])
        with pytest.raises(IndexError):
            native.gather_normalize_u8(u8, idx)
        with pytest.raises(IndexError):
            native.gather_rows(u8.astype(np.float32), idx)
        with pytest.raises(IndexError):
            native.gather_augment_u8(u8, idx, [0, 0], [0, 0], [0, 0], padding=4)
        with pytest.raises(IndexError):
            u8[idx]  # as numpy indexing does


def test_fused_cifar_augment_equals_the_unfused_path_and_the_reference():
    """``CifarAugment.gather_u8`` equals gather + normalize +
    ``cifar_augment`` with the same generator, and the reference's fused
    augment of the whole host batch, sliced to ``rows=(first, total)``."""
    src = _u8(20, (32, 32, 3), seed=5)
    full = np.array([4, 19, 0, 7, 7, 12, 3, 15])
    seed = (9, 0xA06, 1, 2, 0)
    ref = jtr.CifarAugment().gather_u8(src, full, np.random.default_rng(seed))
    for rows, n in ((None, 8), ((0, 8), 3), ((3, 8), 3), ((5, 8), 3)):
        first = rows[0] if rows else 0
        idx = full[first:first + n]
        got = ttr.CifarAugment().gather_u8(src, idx, np.random.default_rng(seed), rows)
        plain = ttr.cifar_augment({"image": native.gather_normalize_u8_numpy(src, idx)},
                                  np.random.default_rng(seed), rows)["image"]
        _same(got, plain)
        _same(got, ref[first:first + n])


@pytest.mark.parametrize("augment", [True, False])
def test_loader_batches_equal_the_reference_loader(augment):
    """Rank r of two, over two epochs, gets rows [r B, (r + 1) B) of the
    reference loader's host batch bit for bit; the fused augment (or the
    native normalize) runs once per batch."""
    mine = tds.SyntheticClassification(num_examples=21, shape=(8, 8, 3), seed=4, keep_u8=True)
    ref = jds.SyntheticClassification(num_examples=21, shape=(8, 8, 3), seed=4, keep_u8=True)
    B = 3
    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:2])
    jl = JLoader(ref, per_replica_batch=B, mesh=mesh, seed=5, device_feed=False,
                 augment=jtr.CifarAugment() if augment else None)
    ranks = [DataLoader(mine, per_replica_batch=B, rank=r, num_replicas=2, seed=5,
                        augment=ttr.CifarAugment() if augment else None) for r in range(2)]
    native.reset_calls()
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        for r in ranks:
            r.set_epoch(epoch)
        for want, *got in zip(jl, *ranks):
            for r, batch in enumerate(got):
                _same(batch["image"].numpy(), want["image"][r * B:(r + 1) * B])
    name = "gather_augment_u8" if augment else "gather_normalize_u8"
    assert native.CALLS[name] == 2 * 2 * len(jl)


def test_sharded_f32_gather_is_native_and_equals_the_reference(tmp_path):
    root = tsh.write_synthetic_image_shards(str(tmp_path / "s"), 21, (8, 8, 3), 10, shard_rows=8)
    idx = np.array([20, 3, 8, 7, 15, 0])
    native.reset_calls()
    got = tsh.ShardedImageDataset(root).gather(idx)
    want = jsh.ShardedImageDataset(root).gather(idx)
    _same(got["image"], want["image"])
    _same(got["label"], want["label"])
    assert native.CALLS["gather_normalize_u8"] == 3  # one per shard touched


def test_a_build_that_does_not_compile_raises(tmp_path, monkeypatch):
    """A broken source raises with the compiler's message; nothing falls
    back to numpy."""
    bad = tmp_path / "ddp_native.cpp"
    bad.write_text('extern "C" void ddp_gather_norm_u8( { this does not compile }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(warm_start, "_cache_dir", None)  # builds under DEFAULT_BUILD_DIR
    monkeypatch.setattr(warm_start, "DEFAULT_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        native.gather_normalize_u8(_u8(), np.array([0, 1]))
    assert not list((tmp_path / "_build").glob("*.so"))
