"""Prediction on PyTorch and CUDA (counterpart of `gvcnn_tf_tpu/predict.py`).

`predict(config, ...)` classifies shapes given as a directory of V view
images (or a directory of such directories), as OFF/OBJ meshes rendered in
the process with the procedural split's cameras, or as an (N, V, H, W, 3)
array (float in [-1, 1], or raw uint8 normalized on the device).  Weights
as in `eval.py` (`scoring_model`).  Each record holds the shape's name, the
class index (and name, given `class_names`), its fp32 softmax probability
and, for GVCNN, the V view-discrimination scores (MVCNN and the
single-view classifier have none, and their records no `view_scores`).  Shapes go through the model
`batch_size` at a time.

Reading view images needs PIL (Pillow); where it is missing, `--view_dir`
raises and `--mesh_file` and arrays still work.

CLI:
    python -m gvcnn_tf_tpu_torch.predict --config mn40_12view \
        --checkpoint_dir runs/mn40 --mesh_file chair.off \
        --output_csv preds.csv                               # on the card
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from gvcnn_tf_tpu_torch.configs import GVCNNConfig, add_flags, config_from_flags
from gvcnn_tf_tpu_torch.data.procedural import render_views
from gvcnn_tf_tpu_torch.eval import scoring_model
from gvcnn_tf_tpu_torch.metrics import log
from gvcnn_tf_tpu_torch.tools.render_meshes import load_mesh
from gvcnn_tf_tpu_torch.utils import normalize_views, resolve_device

_IMG_EXTS = (".jpg", ".jpeg", ".png")


def load_views(view_dir: str, num_views: int, height: int,
               width: int) -> np.ndarray:
    """Read the V view images of one shape -> (V, H, W, 3) in [-1, 1]."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading view images needs PIL (Pillow), which this Python does "
            "not have; pass the views as an array (predict(views=...)) or "
            "render meshes (--mesh_file)") from e

    files = sorted(os.path.join(view_dir, f) for f in os.listdir(view_dir)
                   if f.lower().endswith(_IMG_EXTS))
    if len(files) < num_views:
        raise ValueError(f"{view_dir} holds {len(files)} views; need "
                         f"{num_views}")
    views = []
    for f in files[:num_views]:
        img = Image.open(f).convert("RGB").resize((width, height))
        views.append(np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0)
    return np.stack(views)


def render_mesh_views(mesh_files: Sequence[str], num_views: int, height: int,
                      width: int) -> np.ndarray:
    """Render V orbit views per OFF/OBJ mesh -> (N, V, H, W, 3) in [-1, 1],
    with the procedural split's camera orbit (`render_views`).  The renders
    go through uint8, as the split's do, so a model sees the values it was
    trained on."""
    if height != width:
        raise ValueError(f"mesh rendering is square; got height {height}, "
                         f"width {width}")
    out = np.empty((len(mesh_files), num_views, height, width, 3),
                   np.float32)
    for i, path in enumerate(mesh_files):
        verts, faces = load_mesh(path)
        imgs = render_views(verts, faces, num_views, height)
        q = (imgs * 255).astype(np.uint8).astype(np.float32) / 255.0
        out[i] = np.repeat(q[..., None], 3, axis=-1) * 2.0 - 1.0
    return out


def predict(config: GVCNNConfig, checkpoint_dir: Optional[str] = None,
            view_dir: Optional[str] = None, *,
            views: Optional[np.ndarray] = None,
            mesh_files: Optional[Sequence[str]] = None, state=None,
            class_names: Optional[Sequence[str]] = None,
            fold_bn: bool = False, device="cuda") -> List[dict]:
    """Classify shapes from one of `view_dir`, `mesh_files` or `views`.
    Returns [{'shape', 'class_index', 'probability', ['class_name'],
    ['view_scores']}] in input order."""
    d = config.data
    if views is None and mesh_files:
        views = render_mesh_views(mesh_files, d.num_views, d.height, d.width)
        names = [os.path.splitext(os.path.basename(m))[0]
                 for m in mesh_files]
    elif views is None:
        if view_dir is None:
            raise ValueError("need view_dir, mesh_files, or views")
        subdirs = sorted(os.path.join(view_dir, s)
                         for s in os.listdir(view_dir)
                         if os.path.isdir(os.path.join(view_dir, s)))
        dirs = subdirs or [view_dir]
        views = np.stack([load_views(s, d.num_views, d.height, d.width)
                          for s in dirs])
        names = [os.path.basename(s.rstrip("/")) for s in dirs]
    else:
        names = [f"shape_{i}" for i in range(views.shape[0])]

    outs = []
    with scoring_model(config, checkpoint_dir, state, fold_bn,
                       device) as model:
        dev = next(model.parameters()).device
        for start in range(0, len(views), d.batch_size):
            x = torch.from_numpy(np.ascontiguousarray(
                views[start:start + d.batch_size])).to(dev)
            logits, ep = model(normalize_views(x))
            probs = torch.softmax(logits.float(), -1)
            outs.append((probs.argmax(-1), probs.max(-1).values,
                         ep.get("view_discrimination_scores")))
    pred, prob, scores = (None if t[0] is None else torch.cat(t).cpu().numpy()
                          for t in zip(*outs))
    results = []
    for i, name in enumerate(names):
        idx = int(pred[i])
        rec = {"shape": name, "class_index": idx,
               "probability": float(prob[i])}
        if class_names:
            rec["class_name"] = class_names[idx]
        if scores is not None:
            rec["view_scores"] = scores[i].tolist()
        results.append(rec)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="gvcnn_tf_tpu_torch predictor "
                                            "(PyTorch + CUDA)")
    add_flags(p)
    p.add_argument("--checkpoint_dir", default=None,
                   help="directory of the port's or the JAX package's "
                        "Orbax checkpoints (default: --train_logdir)")
    p.add_argument("--view_dir", default=None,
                   help="dir of V view images, or dir of per-shape dirs")
    p.add_argument("--mesh_file", action="append", default=None,
                   help="raw OFF/OBJ mesh(es) to render and classify "
                        "in-process (repeatable)")
    p.add_argument("--output_csv", default=None)
    p.add_argument("--labels_file", default=None,
                   help="class names, one a line, in label order")
    p.add_argument("--fold_bn", action="store_true",
                   help="fold BatchNorm into conv kernels (exact)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises when no card "
                        "is present, it never falls back to the CPU")
    args = p.parse_args(argv)
    if not args.view_dir and not args.mesh_file:
        p.error("need --view_dir or --mesh_file")
    config = config_from_flags(args)
    class_names = None
    if args.labels_file:
        with open(args.labels_file) as f:
            class_names = f.read().splitlines()
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.predict: {e}") from e
    try:
        results = predict(config, checkpoint_dir=args.checkpoint_dir,
                          view_dir=args.view_dir, mesh_files=args.mesh_file,
                          class_names=class_names, fold_bn=args.fold_bn,
                          device=args.device)
    except (NotImplementedError, FileNotFoundError, ImportError) as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.predict: {e}") from e
    for r in results:
        log(f"{r['shape']}: class {r.get('class_name', r['class_index'])} "
            f"(p={r['probability']:.3f})")
    if args.output_csv:
        with open(args.output_csv, "w", newline="") as f:
            w = csv.DictWriter(
                f, fieldnames=[k for k in results[0] if k != "view_scores"],
                extrasaction="ignore")
            w.writeheader()
            w.writerows(results)


if __name__ == "__main__":
    main()
