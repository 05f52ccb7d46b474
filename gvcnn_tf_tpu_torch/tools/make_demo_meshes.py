"""Write a ModelNet-layout OFF mesh tree from the procedural generators (a
copy of `gvcnn_tf_tpu/tools/make_demo_meshes.py`, numpy only).

Real meshes to classify with `predict.py --mesh_file`, without the
ModelNet archives:

    python -m gvcnn_tf_tpu_torch.tools.make_demo_meshes \
        --output_dir demo_meshes --per_class 2 --num_classes 40
    python -m gvcnn_tf_tpu_torch.predict --checkpoint_dir runs/mn40 \
        --mesh_file demo_meshes/chair/test/chair_10000.off

Layout: `<output_dir>/<class>/<train|test>/<class>_NNNN.off` (the ModelNet
convention `render_meshes.discover_meshes` reads).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gvcnn_tf_tpu_torch.data.procedural import class_table


def write_off(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{len(verts)} {len(faces)} 0\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write("3 " + " ".join(str(int(i)) for i in face) + "\n")


def generate(output_dir: str, per_class: int, test_per_class: int,
             seed: int = 0, num_classes: int = 10) -> int:
    n = 0
    for ci, (name, builder) in enumerate(class_table(num_classes)):
        for split, count, base in (
            ("train", per_class, 0),
            ("test", test_per_class, 10_000),
        ):
            d = os.path.join(output_dir, name, split)
            os.makedirs(d, exist_ok=True)
            for k in range(count):
                rng = np.random.RandomState(
                    seed * 2_000_003 + ci * 9_973 + base + k
                )
                verts, faces = builder(rng)
                write_off(
                    os.path.join(d, f"{name}_{base + k:04d}.off"),
                    verts, faces,
                )
                n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--per_class", type=int, default=8)
    p.add_argument("--test_per_class", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_classes", type=int, default=10,
                   help="10 or 40 (the flagship set)")
    args = p.parse_args(argv)
    n = generate(args.output_dir, args.per_class, args.test_per_class,
                 seed=args.seed, num_classes=args.num_classes)
    print(f"[make_demo_meshes] wrote {n} OFF meshes "
          f"({args.num_classes} classes) -> {args.output_dir}")


if __name__ == "__main__":
    main()
