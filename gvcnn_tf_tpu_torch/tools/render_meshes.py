"""Render OFF/OBJ mesh trees (ModelNet layout) into multi-view images (a
copy of `gvcnn_tf_tpu/tools/render_meshes.py`, numpy only).

`load_off`, `load_obj` and `load_mesh` parse a mesh into (verts, faces);
`discover_meshes` lists a tree's meshes; `render_tree` renders each mesh's
MVCNN-style V-view orbit (`data/procedural.py::render_views`, the NumPy
z-buffer rasterizer) and writes the views as PNG (`utils/png.py`, no PIL:
the same pixels as the JAX tool's PIL-written files), so a user holding
only mesh archives can go mesh -> views -> TFRecords -> train.
`predict.py --mesh_file` renders meshes read here too.

    python -m gvcnn_tf_tpu_torch.tools.render_meshes \
        --mesh_dir /data/ModelNet40 --split train \
        --output_dir /data/modelnet40_views/train --num_views 12 --res 224
    python -m gvcnn_tf_tpu_torch.data.build_tfrecords \
        --image_dir /data/modelnet40_views/train --output_dir ... --num_views 12

ModelNet mesh layout: `<root>/<class>/<train|test>/<shape>.off`; flat
`<root>/<class>/*.off` trees are also accepted (then --split is ignored).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np

from gvcnn_tf_tpu_torch.data.procedural import render_views
from gvcnn_tf_tpu_torch.utils.png import write_png


def load_off(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OFF mesh -> (verts (N,3) float32, faces (T,3) int32).

    Handles both the spec form ("OFF\\n n_v n_f n_e") and ModelNet's known
    malformed headers ("OFF n_v n_f n_e" on one line). Polygons with more
    than 3 vertices are fan-triangulated.
    """
    with open(path, "r", errors="replace") as f:
        tokens: List[str] = []
        first = f.readline().strip()
        if not first.upper().startswith("OFF"):
            raise ValueError(f"{path}: not an OFF file (header {first!r})")
        rest = first[3:].strip()
        if rest:                       # malformed one-line ModelNet header
            tokens.extend(rest.split())
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                tokens.extend(line.split())
    n_v, n_f = int(tokens[0]), int(tokens[1])
    pos = 3                            # skip n_edges
    verts = np.array(
        tokens[pos:pos + 3 * n_v], np.float32
    ).reshape(n_v, 3)
    pos += 3 * n_v
    faces: List[List[int]] = []
    for _ in range(n_f):
        k = int(tokens[pos])
        poly = [int(t) for t in tokens[pos + 1:pos + 1 + k]]
        pos += 1 + k
        for j in range(1, k - 1):      # fan triangulation
            faces.append([poly[0], poly[j], poly[j + 1]])
    return verts, np.array(faces, np.int32).reshape(-1, 3)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a (geometry-only) Wavefront OBJ -> (verts, tri faces)."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                # indices may be v, v/vt, v/vt/vn; negatives are relative
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for j in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[j], idx[j + 1]])
    return (
        np.array(verts, np.float32),
        np.array(faces, np.int32).reshape(-1, 3),
    )


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".off":
        return load_off(path)
    if ext == ".obj":
        return load_obj(path)
    raise ValueError(f"unsupported mesh format: {path}")


def discover_meshes(mesh_dir: str, split: str) -> List[Tuple[str, str, str]]:
    """-> [(class_name, shape_id, mesh_path)] for the requested split.

    Two layouts: ModelNet-style `<class>/<split>/<shape>.off`, or flat
    `<class>/<shape>.off`.  The flat fallback applies only when NO class
    has split subdirectories: a per-class silent fallback on a
    partially ModelNet-shaped tree would mix train and test meshes into
    one split.  A mixed tree (some classes with split dirs, some without)
    raises instead of guessing.
    """
    classes = [
        c for c in sorted(os.listdir(mesh_dir))
        if os.path.isdir(os.path.join(mesh_dir, c))
    ]
    has_split = {
        c: os.path.isdir(os.path.join(mesh_dir, c, split)) for c in classes
    }
    if any(has_split.values()) and not all(has_split.values()):
        flat = sorted(c for c in classes if not has_split[c])
        raise ValueError(
            f"mixed mesh tree: classes {flat} lack a {split!r} subdir while "
            "others have one; refusing to silently mix splits"
        )
    use_split_dirs = all(has_split.values()) and bool(classes)
    out = []
    for cls in classes:
        cdir = os.path.join(mesh_dir, cls)
        scan = os.path.join(cdir, split) if use_split_dirs else cdir
        for fn in sorted(os.listdir(scan)):
            if os.path.splitext(fn)[1].lower() in (".off", ".obj"):
                out.append(
                    (cls, os.path.splitext(fn)[0], os.path.join(scan, fn))
                )
    return out


def render_tree(
    mesh_dir: str,
    output_dir: str,
    *,
    split: str = "train",
    num_views: int = 12,
    res: int = 224,
    limit: int = 0,
) -> int:
    """Render every mesh into `<output_dir>/<class>/<shape>/view_##.png`
    (layout 1 of data/tfrecord.py::discover_shapes). -> #shapes rendered."""
    meshes = discover_meshes(mesh_dir, split)
    if limit:
        meshes = meshes[:limit]
    for n, (cls, shape_id, path) in enumerate(meshes):
        verts, faces = load_mesh(path)
        if len(verts) == 0 or len(faces) == 0:
            print(f"[render_meshes] skipping empty mesh {path}")
            continue
        imgs = render_views(verts, faces, num_views, res)
        odir = os.path.join(output_dir, cls, shape_id)
        os.makedirs(odir, exist_ok=True)
        for i in range(num_views):
            arr = np.repeat(
                (imgs[i] * 255).astype(np.uint8)[..., None], 3, axis=-1
            )
            write_png(os.path.join(odir, f"view_{i:02d}.png"), arr)
        if (n + 1) % 50 == 0:
            print(f"[render_meshes] {n + 1}/{len(meshes)} shapes",
                  flush=True)
    return len(meshes)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mesh_dir", required=True,
                   help="ModelNet-style root: <class>/<split>/<shape>.off")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--split", default="train", help="train | test")
    p.add_argument("--num_views", type=int, default=12)
    p.add_argument("--res", type=int, default=224)
    p.add_argument("--limit", type=int, default=0,
                   help="render at most N shapes (0 = all)")
    args = p.parse_args(argv)
    n = render_tree(
        args.mesh_dir, args.output_dir, split=args.split,
        num_views=args.num_views, res=args.res, limit=args.limit,
    )
    print(f"[render_meshes] rendered {n} shapes -> {args.output_dir}")


if __name__ == "__main__":
    main()
