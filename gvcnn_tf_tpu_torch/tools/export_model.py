"""Export a trained model to a `torch.export` artifact for serving
(counterpart of `gvcnn_tf_tpu/tools/export_model.py`, which writes a
`jax.export` StableHLO artifact).

The artifact is the eval-mode forward with the weights baked in, as the
JAX tool's is: BatchNorm folded into the convs by default (exact, fp32,
`utils/fold_bn.py`), the convs stored in the config's compute dtype as the
inference engine stores them (`cast_convs_`), on the device it was exported
on (channels-last on a card).  Its input is a static float32
(B, V, H, W, 3) tensor of views already normalized to [-1, 1] ((B, H, W, 3)
for the single-view classifier); its outputs are `(logits, Predictions)`.
`export_model` returns `torch.export.save`'s bytes.

The stem conv, the grouping head and the max and average pools are in the
graph as the port's `torch.library` ops, `gvcnn::stem_conv7x7s2`,
`gvcnn::group_and_fuse`, `gvcnn::max_pool_same` and `gvcnn::avg_pool_same`,
so the process that loads an artifact must have imported them first
(importing `gvcnn_tf_tpu_torch.ops` registers every op; importing this
module does).  On a card an artifact launches the CUDA kernels (built at
first use, as every entry point of the port builds them), on the CPU it
runs their plain versions.

CLI:
    python -m gvcnn_tf_tpu_torch.tools.export_model --config mn40_12view \
        --checkpoint_dir runs/mn40 --output gvcnn.pt2 \
        [--export_batch_size 8] [--no_fold_bn] [--device cuda]

Load side: `deserialize_and_call(blob, x)` below, or
`torch.export.load(path).module()(x)` after importing this module.
"""

from __future__ import annotations

import argparse
import copy
import io
from typing import Optional

import torch
import torch.nn as nn

from gvcnn_tf_tpu_torch.configs import GVCNNConfig, add_flags, config_from_flags
from gvcnn_tf_tpu_torch.eval import scoring_model
from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights, to_device
# The artifact's graph calls the port's ops: importing `ops` registers them.
import gvcnn_tf_tpu_torch.ops  # noqa: F401
from gvcnn_tf_tpu_torch.utils import fold_batch_norm, resolve_device


class _Forward(nn.Module):
    """The exported function: x -> (logits, Predictions)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor):
        logits, end_points = self.model(x)
        return logits, end_points["Predictions"]


def _eval_copy(config: GVCNNConfig, checkpoint_dir, state, fold_bn,
               device) -> nn.Module:
    """A private copy of the model to export, in eval mode on its device:
    from `state` or the newest checkpoint under `checkpoint_dir` (as
    `eval.scoring_model` reads them), else seeded weights (an untrained
    export, as the JAX tool's without a checkpoint)."""
    if state is None and not checkpoint_dir:
        model = init_weights(build_model(config), config.train.seed)
        if fold_bn:
            fold_batch_norm(model)
        return to_device(model, resolve_device(device)).eval()
    with scoring_model(config, checkpoint_dir, state, fold_bn,
                       device) as model:
        return copy.deepcopy(model)


def export_model(
    config: GVCNNConfig,
    checkpoint_dir: Optional[str] = None,
    *,
    state=None,
    batch_size: Optional[int] = None,
    fold_bn: bool = True,
    device="cuda",
) -> bytes:
    """Serialize the eval-mode forward (weights baked in) -> bytes.

    `state`: what `eval.scoring_model` takes (a `TrainState`, or JAX
    variables with numpy leaves through the bridge); else the newest
    checkpoint under `checkpoint_dir`; else seeded weights.  `fold_bn`
    (default on) folds BatchNorm into the convs first.  `batch_size`
    (default: the config's) is the artifact's static batch.  `device`: where
    the model is placed and traced (a `TrainState`'s own device wins)."""
    model = _eval_copy(config, checkpoint_dir, state, fold_bn, device)
    model.cast_convs_()
    model.requires_grad_(False)
    dev = next(model.parameters()).device
    d = config.data
    b = batch_size or d.batch_size
    shape = ((b, d.num_views, d.height, d.width, 3) if config.multi_view
             else (b, d.height, d.width, 3))
    example = torch.zeros(shape, dtype=torch.float32, device=dev)
    exported = torch.export.export(_Forward(model), (example,))
    # The artifact keeps no example input (at B = 8, 12 views of 224x224,
    # it would be 58 MB beside 13 MB of weights).
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def deserialize_and_call(blob: bytes, x: torch.Tensor):
    """Load an exported artifact and run it on x -> (logits, Predictions)
    (serving-side helper; grad mode off, so the stem's packed weight is
    kept between calls)."""
    module = torch.export.load(io.BytesIO(blob)).module()
    with torch.inference_mode():
        return module(x)


def main(argv=None):
    p = argparse.ArgumentParser(description="export a model to a "
                                            "torch.export artifact")
    add_flags(p)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--export_batch_size", type=int, default=None)
    p.add_argument("--no_fold_bn", action="store_true",
                   help="export with BatchNorm left unfolded")
    p.add_argument("--device", default="cuda",
                   help="torch device the artifact is traced on and runs "
                        "on; 'cuda' (default) raises when no card is "
                        "present, it never falls back to the CPU")
    args = p.parse_args(argv)
    config = config_from_flags(args)
    try:
        blob = export_model(
            config,
            checkpoint_dir=args.checkpoint_dir or config.train.train_logdir,
            batch_size=args.export_batch_size,
            fold_bn=not args.no_fold_bn,
            device=args.device,
        )
    except (RuntimeError, NotImplementedError, FileNotFoundError,
            ImportError) as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.tools.export_model: {e}") from e
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"wrote {len(blob)} bytes to {args.output}")


if __name__ == "__main__":
    main()
