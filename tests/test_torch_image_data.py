"""The port's image data path against the JAX package's, on the CPU.

Everything here is numpy on both sides, so it is held to exact equality:
``SyntheticClassification`` (f32 and u8), ``load_cifar10`` on pickle
batches the test writes (a directory and a tar.gz), the device normalize,
the crop / flip / ``CifarAugment`` draws, the shard format (files written
by either package are byte-identical and read the same through both), and
the rows each of two replicas receives, augmented or not.  The host-side
u8 normalize runs each package's copy of the same native kernel
(``x * f32(1/255)``), so it too is held to exact equality.
"""

import os
import pickle
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributeddataparallel_tpu as ddp
from distributeddataparallel_tpu.data import datasets as jds
from distributeddataparallel_tpu.data import sharded as jsh
from distributeddataparallel_tpu.data import transforms as jtr
from distributeddataparallel_tpu.data.loader import DataLoader as JLoader
from distributeddataparallel_tpu.ops import normalize_u8_images as j_norm
from distributeddataparallel_tpu_torch.data import datasets as tds
from distributeddataparallel_tpu_torch.data import sharded as tsh
from distributeddataparallel_tpu_torch.data import transforms as ttr
from distributeddataparallel_tpu_torch.data.loader import DataLoader
from distributeddataparallel_tpu_torch.ops.preprocess import normalize_u8_images



def _same(a, b):
    np.testing.assert_array_equal(a, b)
    assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("keep_u8", [False, True])
def test_synthetic_classification_identical(keep_u8):
    kw = dict(num_examples=40, shape=(6, 5, 3), num_classes=7, seed=3, proto_seed=2, keep_u8=keep_u8)
    a, b = tds.SyntheticClassification(**kw), jds.SyntheticClassification(**kw)
    _same(a.images, b.images)
    _same(a.labels, b.labels)
    assert a.normalize_u8 == b.normalize_u8 == keep_u8
    img, label = a[5]
    ref_img, ref_label = b[5]
    _same(img, ref_img)
    assert label == ref_label


def _write_cifar(root, packed):
    """Tiny CIFAR-10 python batches: 5 train batches of 3 rows, a test
    batch of 4, as (N, 3072) uint8 CHW planes."""
    rng = np.random.default_rng(0)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    for name, n in [(f"data_batch_{i}", 3) for i in range(1, 6)] + [("test_batch", 4)]:
        with open(os.path.join(d, name), "wb") as fh:
            pickle.dump({b"data": rng.integers(0, 256, size=(n, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, size=n).tolist()}, fh)
    if packed:
        with tarfile.open(os.path.join(root, "cifar-10-python.tar.gz"), "w:gz") as tf:
            tf.add(d, arcname="cifar-10-batches-py")
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))
        os.rmdir(d)


@pytest.mark.parametrize("packed", [False, True], ids=["directory", "tar.gz"])
def test_load_cifar10_identical(tmp_path, packed):
    mine, ref = tmp_path / "port", tmp_path / "ref"
    for root in (mine, ref):
        root.mkdir()
        _write_cifar(str(root), packed)
    for train in (True, False):
        for kw in (dict(), dict(keep_u8=True), dict(normalize=False)):
            a = tds.load_cifar10(str(mine), train=train, synthetic_fallback=False, **kw)
            b = jds.load_cifar10(str(ref), train=train, synthetic_fallback=False, **kw)
            _same(a.images, b.images)
            _same(a.labels, b.labels)
            assert a.images.shape == ((15 if train else 4), 32, 32, 3)
            assert a.normalize_u8 == b.normalize_u8
    with pytest.raises(FileNotFoundError):
        tds.load_cifar10(str(tmp_path / "none"), synthetic_fallback=False)
    fake = tds.load_cifar10(str(tmp_path / "none"), train=False)
    assert len(fake) == 10000 and fake.images.shape[1:] == (32, 32, 3)


def test_normalize_u8_images_matches_jax():
    x = np.arange(256, dtype=np.uint8).reshape(2, 4, 8, 4)
    got = normalize_u8_images(torch.from_numpy(x)).numpy()
    _same(got, np.asarray(j_norm(jnp.asarray(x))))
    _same(got, jds.normalize_images(x))
    _same(tds.normalize_images(x), jds.normalize_images(x))


def test_crop_flip_and_cifar_augment_draws_identical():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(7, 8, 6, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, size=(7, 8, 6, 3), dtype=np.uint8)
    g = lambda: np.random.default_rng(11)
    for img in (f32, u8):
        _same(ttr.random_crop(img, g()), jtr.random_crop(img, g()))
        _same(ttr.random_crop(img, g(), padding=2, fill=0.5), jtr.random_crop(img, g(), padding=2, fill=0.5))
        _same(ttr.random_horizontal_flip(img, g()), jtr.random_horizontal_flip(img, g()))
        batch = {"image": img, "label": np.arange(7)}
        _same(ttr.cifar_augment(batch, g())["image"], jtr.cifar_augment(batch, g())["image"])
        _same(ttr.CifarAugment()(batch, g())["image"], jtr.CifarAugment()(batch, g())["image"])
        # One rank's rows 2..4 of the 7-row host batch: the draws of the whole.
        part = ttr.CifarAugment()({"image": img[2:5]}, g(), rows=(2, 7))["image"]
        _same(part, jtr.CifarAugment()(batch, g())["image"][2:5])
    # u8 batches pad with u8 black, not -1.0 wrapped to 255.
    padded = ttr.random_crop(np.full((64, 4, 4, 1), 200, np.uint8), g(), padding=4)
    assert set(np.unique(padded)) == {0, 200}


def test_shards_byte_identical_and_read_by_both_packages(tmp_path):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(10, 4, 5, 3), dtype=np.uint8)
    labels = rng.integers(0, 6, size=10).astype(np.int32)
    dirs = {
        "port_syn": tsh.write_synthetic_image_shards(str(tmp_path / "a"), 9, (6, 4, 3), 5, shard_rows=4, seed=2),
        "ref_syn": jsh.write_synthetic_image_shards(str(tmp_path / "b"), 9, (6, 4, 3), 5, shard_rows=4, seed=2),
        "port_arr": tsh.write_image_shards(str(tmp_path / "c"), images, labels, shard_rows=3),
        "ref_arr": jsh.write_image_shards(str(tmp_path / "d"), images, labels, shard_rows=3),
    }
    for kind in ("syn", "arr"):
        a, b = dirs[f"port_{kind}"], dirs[f"ref_{kind}"]
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for f in os.listdir(a):
            with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
                assert fa.read() == fb.read(), f
    idx = np.array([8, 0, 3, 3, 7, 5])
    for root in dirs.values():
        for dn in (False, True):
            a = tsh.ShardedImageDataset(root, device_normalize=dn)
            b = jsh.ShardedImageDataset(root, device_normalize=dn)
            assert (len(a), a.num_classes, a.image_shape) == (len(b), b.num_classes, b.image_shape)
            ga, gb = a.gather(idx), b.gather(idx)
            _same(ga["label"], gb["label"])
            _same(ga["image"], gb["image"])
            _same(a[3][0], ga["image"][2])
            assert a[3][1] == b[3][1]


def _datasets(kind, tmp_path):
    if kind == "f32":
        return (tds.SyntheticClassification(num_examples=21, shape=(8, 8, 3), seed=4),
                jds.SyntheticClassification(num_examples=21, shape=(8, 8, 3), seed=4))
    if kind == "u8":
        return (tds.SyntheticClassification(num_examples=21, shape=(8, 8, 3), seed=4, keep_u8=True),
                jds.SyntheticClassification(num_examples=21, shape=(8, 8, 3), seed=4, keep_u8=True))
    root = tsh.write_synthetic_image_shards(str(tmp_path / "s"), 21, (8, 8, 3), 10, shard_rows=8)
    return (tsh.ShardedImageDataset(root, device_normalize=True),
            jsh.ShardedImageDataset(root, device_normalize=True))


@pytest.mark.parametrize("kind,augment", [("f32", True), ("shards", True), ("u8", False)])
def test_two_replica_rows_match_jax_replica_slices(kind, augment, tmp_path):
    """Rank r's batch at every step of two epochs equals rows
    [r B, (r + 1) B) of the reference's host batch over a 2-device mesh."""
    mine, ref = _datasets(kind, tmp_path)
    B = 3
    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:2])
    jl = JLoader(ref, per_replica_batch=B, mesh=mesh, seed=5, device_feed=False,
                 augment=jtr.CifarAugment() if augment else None)
    ranks = [DataLoader(mine, per_replica_batch=B, rank=r, num_replicas=2, seed=5,
                        augment=ttr.CifarAugment() if augment else None) for r in range(2)]
    assert len(jl) == len(ranks[0]) == 3
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        for r in ranks:
            r.set_epoch(epoch)
        for step, (want, *got) in enumerate(zip(jl, *ranks)):
            for r, batch in enumerate(got):
                rows = slice(r * B, (r + 1) * B)
                _same(batch["label"].numpy(), want["label"][rows].astype(np.int64))
                _same(batch["image"].numpy(), want["image"][rows])


def test_u8_images_stay_uint8_on_the_way_to_the_device(tmp_path):
    """Raw u8 batches keep their dtype (the train step normalizes them);
    labels and token ids become int64."""
    root = tsh.write_synthetic_image_shards(str(tmp_path / "s"), 12, (4, 4, 3), 3, shard_rows=5)
    batch = next(iter(DataLoader(tsh.ShardedImageDataset(root, device_normalize=True),
                                 per_replica_batch=4, with_mask=True)))
    assert batch["image"].dtype == torch.uint8 and batch["image"].shape == (4, 4, 4, 3)
    assert batch["label"].dtype == torch.int64 and batch["valid"].dtype == torch.float32
    f32 = next(iter(DataLoader(tsh.ShardedImageDataset(root), per_replica_batch=4)))
    assert f32["image"].dtype == torch.float32
    tokens = next(iter(DataLoader(tds.SyntheticLM(num_examples=4, seq_len=3, vocab_size=9),
                                  per_replica_batch=2)))
    assert tokens["tokens"].dtype == torch.int64


def test_worker_thread_gives_the_same_batches_and_stops():
    """``workers=True`` (the gather on a background thread) yields the inline
    loader's batches in order; a consumer that stops early stops the thread;
    a failing gather raises at the consumer."""
    import threading

    ds = tds.SyntheticClassification(num_examples=40, shape=(4, 4, 3), keep_u8=True)
    kw = dict(per_replica_batch=4, rank=1, num_replicas=2, seed=3, augment=ttr.CifarAugment())
    inline = list(DataLoader(ds, **kw))
    threaded = list(DataLoader(ds, workers=True, **kw))
    assert len(inline) == len(threaded) == 5
    for a, b in zip(inline, threaded):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    before = threading.active_count()
    it = iter(DataLoader(ds, workers=True, **kw))
    next(it)
    it.close()
    assert threading.active_count() == before

    class Broken:
        def __len__(self):
            return 8

        def gather(self, idx):
            raise OSError("shard unreadable")

    with pytest.raises(OSError, match="shard unreadable"):
        list(DataLoader(Broken(), per_replica_batch=4, workers=True))
