"""CLI for the offline TFRecord builder (counterpart of
`gvcnn_tf_tpu/data/build_tfrecords.py`; no TensorFlow).

    python -m gvcnn_tf_tpu_torch.data.build_tfrecords \
        --image_dir /data/modelnet40_views/train \
        --output_dir /data/tfrecords --split_name train \
        --num_views 12 --num_shards 4
"""

from __future__ import annotations

import argparse

from gvcnn_tf_tpu_torch.data.tfrecord import build_tfrecords


def main(argv=None):
    p = argparse.ArgumentParser(description="multi-view TFRecord builder")
    p.add_argument("--image_dir", required=True,
                   help="root of rendered views: <class>/<shape>/<view>.png")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--split_name", default="train",
                   choices=["train", "validation", "test"])
    p.add_argument("--num_views", type=int, default=12)
    p.add_argument("--num_shards", type=int, default=4)
    args = p.parse_args(argv)
    try:
        paths = build_tfrecords(
            args.image_dir, args.output_dir, args.num_views,
            split_name=args.split_name, num_shards=args.num_shards,
        )
    except (RuntimeError, FileNotFoundError, ValueError) as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.data.build_tfrecords: {e}") from e
    print("\n".join(paths))


if __name__ == "__main__":
    main()
