"""Image-tree ingestion: the torchvision ``ImageFolder`` on-ramp.

A copy of the JAX package's ``data/ingest.py`` writing through this port's
``data.sharded`` writers, so both packages turn one tree into byte-identical
shards and manifest.  Real image corpora come as ``ImageFolder`` trees
(``root/<class>/<image>`` of encoded JPEG/PNG files); the streaming shard
path (``data.sharded``) wants pre-decoded uint8 ``.npy`` shards instead —
decode once at ingest, then every epoch is page-cache IO with zero JPEG
work on the training hosts.  This module is the converter between the two:

    python -m distributeddataparallel_tpu_torch.data.ingest SRC DST \
        --size 224 --shard-rows 1024 --workers 8

- **Layout**: ``SRC/<class_name>/*.{jpg,jpeg,png,bmp,gif,webp}``; class
  ids are assigned to the SORTED class-directory names — byte-for-byte
  the ImageFolder convention, so label ids match a torch run on the same
  tree.  The manifest additionally records ``class_names`` for audits.
- **Streaming, bounded RAM**: files are decoded shard-by-shard through
  ``_write_shards``'s generator protocol — peak memory is one shard of
  uint8 rows regardless of corpus size, the same bound as the synthetic
  writer.
- **Multi-threaded decode**: PIL decode/resize releases the GIL, so a
  thread pool (``--workers``) parallelizes the dominant cost without
  process-spawn overhead.  Order within a shard is deterministic
  (``executor.map`` preserves input order).
- **Geometry**: shards hold one uniform HWC shape.  ``--policy crop``
  (default) resizes the short side to ``size`` then center-crops — the
  standard ImageNet eval prep; random-crop augmentation stays where it
  belongs, in the training loader (``--augment``, the fused native kernel).
  ``--policy stretch`` resizes both sides directly.

The output directory trains via ``--dataset shards:DST`` with no
further preparation.  PIL is imported inside ``decode_image`` only.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: ImageFolder's extension set (lowercased match, torchvision parity).
IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff",
    ".webp", ".gif",
)


def scan_image_tree(src: str):
    """Walk a ``SRC/<class>/<image>`` tree → (paths, labels, class_names).

    Classes are the sorted immediate subdirectory names; files sort
    within each class — the deterministic ImageFolder enumeration, so
    the same tree always produces the same (path, label) sequence.
    """
    if not os.path.isdir(src):
        raise FileNotFoundError(f"no image tree at {src}")
    class_names = sorted(
        d for d in os.listdir(src)
        if os.path.isdir(os.path.join(src, d))
    )
    if not class_names:
        raise ValueError(
            f"{src}: no class subdirectories — expected the ImageFolder "
            "layout SRC/<class_name>/<image files>"
        )
    paths: list[str] = []
    labels: list[int] = []
    for cid, cname in enumerate(class_names):
        cdir = os.path.join(src, cname)
        for dirpath, dirnames, filenames in os.walk(cdir):
            dirnames.sort()
            for fname in sorted(filenames):
                if os.path.splitext(fname)[1].lower() in IMG_EXTENSIONS:
                    paths.append(os.path.join(dirpath, fname))
                    labels.append(cid)
    if not paths:
        raise ValueError(
            f"{src}: class directories contain no decodable images "
            f"(extensions: {', '.join(IMG_EXTENSIONS)})"
        )
    return paths, np.asarray(labels, dtype=np.int32), class_names


def decode_image(path: str, size: int, policy: str = "crop") -> np.ndarray:
    """One encoded image file → (size, size, 3) uint8 RGB."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if policy == "crop":
            # short side → size, then center crop (ImageNet eval prep)
            w, h = im.size
            scale = size / min(w, h)
            im = im.resize(
                (max(size, round(w * scale)), max(size, round(h * scale))),
                Image.BILINEAR,
            )
            w, h = im.size
            left, top = (w - size) // 2, (h - size) // 2
            im = im.crop((left, top, left + size, top + size))
        elif policy == "stretch":
            im = im.resize((size, size), Image.BILINEAR)
        else:
            raise ValueError(f"unknown resize policy {policy!r}")
        return np.asarray(im, dtype=np.uint8)


def ingest_image_tree(
    src: str,
    dst: str,
    *,
    size: int = 224,
    policy: str = "crop",
    shard_rows: int = 1024,
    workers: int = 8,
) -> str:
    """Convert an ImageFolder tree of encoded images into a shard
    directory trainable via ``--dataset shards:DST``.

    Streamed (peak RAM = one shard) with thread-pooled decode; returns
    ``dst``.  The shard manifest carries ``num_classes`` (head sizing)
    and ``class_names`` (label-id audit trail).
    """
    from distributeddataparallel_tpu_torch.data.sharded import _write_shards

    paths, labels, class_names = scan_image_tree(src)
    shape = (size, size, 3)

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        def gen(lo: int, hi: int):
            imgs = np.stack(
                list(
                    pool.map(
                        lambda p: decode_image(p, size, policy),
                        paths[lo:hi],
                    )
                )
            )
            return imgs, labels[lo:hi]

        _write_shards(
            dst, len(paths), shape, gen, shard_rows=shard_rows,
            num_classes=len(class_names),
        )

    # Extend the manifest with the class-name table (extra keys are
    # ignored by readers that don't want them).
    import json

    mpath = os.path.join(dst, "index.json")
    with open(mpath) as fh:
        manifest = json.load(fh)
    manifest["class_names"] = class_names
    with open(mpath, "w") as fh:
        json.dump(manifest, fh)
    return dst


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Ingest an ImageFolder tree (SRC/<class>/*.jpg...) "
        "into a streaming shard directory for --dataset shards:DST",
    )
    p.add_argument("src", help="image tree root (class subdirectories)")
    p.add_argument("dst", help="output shard directory")
    p.add_argument("--size", type=int, default=224,
                   help="output image side (default 224)")
    p.add_argument("--policy", choices=("crop", "stretch"), default="crop",
                   help="short-side resize + center crop, or stretch")
    p.add_argument("--shard-rows", type=int, default=1024,
                   help="rows per shard file")
    p.add_argument("--workers", type=int, default=8,
                   help="decode threads")
    args = p.parse_args(argv)
    ingest_image_tree(
        args.src, args.dst, size=args.size, policy=args.policy,
        shard_rows=args.shard_rows, workers=args.workers,
    )
    print(f"ingested {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
