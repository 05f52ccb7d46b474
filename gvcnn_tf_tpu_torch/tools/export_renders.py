"""Export a procedural split as a JPEG view tree for the file loaders
(counterpart of `gvcnn_tf_tpu/tools/export_renders.py`).

The procedural split keeps its renders in arrays; the file loaders (the
TFRecord builder, the native decode pool, the decode-once cache) consume
an image TREE ("<class>/<shape>/<view>.jpg").  This tool writes one, so
loader measurements run through the real decode chain:

    python -m gvcnn_tf_tpu_torch.tools.export_renders \
        --out /tmp/flagship_tree --num_classes 40 --num_views 12 \
        --height 224 --num_shapes 1200 [--eval] [--hard] [--quality 90]

Layout written (discover_shapes layout 1):

    <out>/<class_name>/<class>_NNNN/view_NN.jpg

JPEG at `quality` through PIL where it imports, else through libjpeg in
the port's native library (`native_loader.encode_jpeg`, libjpeg's defaults
as PIL asks for them: the same bytes where both use the same libjpeg).
Deterministic in (seed, split, geometry) up to the JPEG encoder's version.

Prints one JSON line: tree root, shapes, views, bytes written.
"""

from __future__ import annotations

import argparse
import json
import os


def _jpeg_encoder(quality: int):
    """path, (H, W, 3) uint8 -> None: PIL where it imports, else libjpeg."""
    try:
        from PIL import Image
    except ImportError:
        from gvcnn_tf_tpu_torch.data.native_loader import encode_jpeg

        def write(path, img):
            data = encode_jpeg(img, quality)
            with open(path, "wb") as f:
                f.write(data)

        return write, "libjpeg"
    return (lambda path, img: Image.fromarray(img).save(
        path, "JPEG", quality=quality)), "PIL"


def export_tree(
    out: str,
    *,
    num_classes: int,
    num_views: int,
    height: int,
    width: int,
    num_shapes: int,
    seed: int = 0,
    train_split: bool = True,
    hard: bool = False,
    quality: int = 90,
) -> dict:
    from gvcnn_tf_tpu_torch.data.procedural import (build_procedural_split,
                                                    class_table)

    write, encoder = _jpeg_encoder(quality)
    views, labels = build_procedural_split(
        num_views=num_views, height=height, width=width,
        num_shapes=num_shapes, seed=seed, train_split=train_split,
        hard=hard, num_classes=num_classes)
    names = [n for n, _ in class_table(num_classes)]
    total_bytes = 0
    n_views = 0
    for i in range(len(views)):
        cls = names[int(labels[i])]
        sdir = os.path.join(out, cls, f"{cls}_{i:04d}")
        os.makedirs(sdir, exist_ok=True)
        for v in range(views.shape[1]):
            path = os.path.join(sdir, f"view_{v:02d}.jpg")
            if not os.path.exists(path):
                write(path, views[i, v])
            total_bytes += os.path.getsize(path)
            n_views += 1
    return {
        "out": out,
        "shapes": int(len(views)),
        "views": n_views,
        "classes": len(names),
        "geometry": [int(x) for x in views.shape[1:]],
        "jpeg_bytes": total_bytes,
        "encoder": encoder,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--num_classes", type=int, default=40)
    p.add_argument("--num_views", type=int, default=12)
    p.add_argument("--height", type=int, default=224)
    p.add_argument("--num_shapes", type=int, default=1200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true",
                   help="export the eval split (disjoint instances)")
    p.add_argument("--hard", action="store_true")
    p.add_argument("--quality", type=int, default=90)
    args = p.parse_args(argv)
    report = export_tree(
        args.out, num_classes=args.num_classes, num_views=args.num_views,
        height=args.height, width=args.height, num_shapes=args.num_shapes,
        seed=args.seed, train_split=not getattr(args, "eval"),
        hard=args.hard, quality=args.quality)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
