"""The port's ImageFolder ingest against the JAX package's, on the CPU.

A small tree written with PIL (3 classes x 4 images of mixed sizes, PNG and
JPEG) goes through both packages' converters under both resize policies:
every shard file and the manifest must be byte-identical (the decode is
PIL's in both, and the writers are the same numpy calls), and the port's
``ShardedImageDataset`` reads the rows back.  The port's entry point,
``python -m distributeddataparallel_tpu_torch.data.ingest``, writes the same
bytes.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from distributeddataparallel_tpu.data import ingest as jingest
from distributeddataparallel_tpu_torch.data import ingest as tingest
from distributeddataparallel_tpu_torch.data.sharded import ShardedImageDataset
from torch_cores import share_of_the_cores  # noqa: F401 -- an autouse fixture

ROOT = Path(__file__).resolve().parents[1]
SIZES = [(40, 30), (17, 23), (64, 64), (9, 50)]


def _tree(root: Path) -> Path:
    rng = np.random.default_rng(0)
    for c, name in enumerate(["zebra", "ant", "moth"]):  # not in sorted order
        d = root / name
        d.mkdir(parents=True)
        for i, (w, h) in enumerate(SIZES):
            px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            ext = "png" if (c + i) % 2 else "jpg"
            Image.fromarray(px).save(d / f"img{i}.{ext}")
    (root / "ant" / "notes.txt").write_text("not an image")
    return root


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("policy", ["crop", "stretch"])
def test_shards_and_manifest_byte_identical(policy, tmp_path):
    src = _tree(tmp_path / "tree")
    kw = dict(size=16, policy=policy, shard_rows=5, workers=2)
    jingest.ingest_image_tree(str(src), str(tmp_path / "ref"), **kw)
    tingest.ingest_image_tree(str(src), str(tmp_path / "port"), **kw)
    ref, mine = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(mine) == sorted(ref) and len(mine) == 2 * 3 + 1  # 12 rows in 3 shards
    assert mine == ref
    ds = ShardedImageDataset(str(tmp_path / "port"), device_normalize=True)
    assert len(ds) == 12 and ds.num_classes == 3 and ds.image_shape == (16, 16, 3)
    batch = ds.gather(np.arange(12))
    assert batch["label"].tolist() == [0] * 4 + [1] * 4 + [2] * 4  # ant, moth, zebra
    np.testing.assert_array_equal(batch["image"][5], tingest.decode_image(
        str(src / "moth" / "img1.png"), 16, policy))


def test_entry_point_writes_the_same_shards(tmp_path):
    src = _tree(tmp_path / "tree")
    out = subprocess.run(
        [sys.executable, "-m", "distributeddataparallel_tpu_torch.data.ingest", str(src),
         str(tmp_path / "cli"), "--size", "16", "--shard-rows", "5", "--workers", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    jingest.ingest_image_tree(str(src), str(tmp_path / "ref"), size=16, shard_rows=5, workers=2)
    assert _files(tmp_path / "cli") == _files(tmp_path / "ref")
