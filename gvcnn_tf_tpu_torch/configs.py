"""Typed configs for gvcnn_tf_tpu_torch.

A copy of `gvcnn_tf_tpu/configs.py`: the same frozen dataclasses, the same
named configs and the same reference-compatible CLI flags, so that a config
or a command line means the same thing to both packages.  It is a copy and
not an import because importing any module of `gvcnn_tf_tpu` runs that
package's `__init__`, which imports JAX, Flax, optax and Orbax; the machine
that runs the port has none of them.  `tests/test_torch_bridge.py` pins the
copy to the original (every config and every flag), so the two cannot drift.
The port has one named config more, `mn40_12view_inception_resnet_v2`,
whose backbone only the port has.

Every field is kept so that configs compare equal.  A setting that only
changes how the JAX package lays out the same math (branch merging, the
space-to-depth stem, the Pallas flags) is accepted and logged or ignored as
its comment says; the port's modules refuse a setting they cannot honour
instead of ignoring it.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input-pipeline config."""

    dataset_dir: str = ""                # dir of TFRecords (or image tree)
    dataset: str = "modelnet40"          # modelnet10 | modelnet40 | synthetic
    num_classes: int = 40
    num_views: int = 12                  # V: 8 or 12 in the reference
    height: int = 224
    width: int = 224
    batch_size: int = 8                  # shapes per global batch
    shuffle_buffer: int = 1024
    # Train-time augmentation: random horizontal flip + random crop.
    augment: bool = True
    # Decoded loader only: apply the random per-view flip on the device
    # inside the train step instead of on the host.
    device_flip: bool = True
    # Stage the whole uint8 train split on the device once and gather each
    # batch by index inside the train step.
    device_resident: str = "auto"        # auto | on | off
    crop_fraction: float = 0.875         # central-crop fraction at eval
    # Preprocessing family: square (resize + crop) | slim (TF-Slim
    # inception_preprocessing geometry).
    preprocessing: str = "square"        # square | slim
    # Synthetic-data fallback so every config can run with nothing on disk.
    synthetic_num_shapes: int = 128
    prefetch_to_device: int = 2          # host->device prefetch depth
    # Input loader: auto = synthetic if no dataset_dir, TFRecords if present,
    # else the native decode pool on a rendered-view image tree.
    loader: str = "auto"                 # auto | tfrecord | native | synthetic
    # Host->device transfer dtype for views; "uint8" ships raw image bytes
    # and normalizes on the device (utils/images.py).
    transfer_dtype: str = "auto"         # auto | float32 | bfloat16 | uint8
    # Background-thread prefetch producer.
    async_prefetch: str = "auto"         # auto | on | off


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization config."""

    optimizer: str = "momentum"          # momentum | adam | sgd
    learning_rate: float = 0.01
    momentum: float = 0.9
    lr_decay_rate: float = 0.94          # slim-style exponential decay
    lr_decay_steps: int = 2000
    warmup_steps: int = 0
    weight_decay: float = 4e-5           # slim inception_arg_scope default
    num_steps: int = 10000
    # epochs > 0 overrides num_steps as round(epochs * steps_per_epoch).
    epochs: float = 0.0
    steps_per_epoch: int = 0
    log_every: int = 50
    checkpoint_every: int = 1000
    train_logdir: str = "/tmp/gvcnn_tpu/train"
    # Warm-start from a converted ImageNet checkpoint.
    checkpoint_path: str = ""
    checkpoint_exclude_scopes: Tuple[str, ...] = ("Logits", "GroupingModule")
    seed: int = 0
    label_smoothing: float = 0.0
    grad_clip_norm: float = 0.0          # 0 = off
    # Gradient accumulation microbatches per step.
    accumulate_steps: int = 1
    # Periodic in-training evaluation every N steps (0 = off).
    eval_every: int = 0


@dataclasses.dataclass(frozen=True)
class GVCNNConfig:
    """Full model+run config: backbone, number of groups M, the endpoint the
    scoring FCN taps, and the score squashing used before bucketing."""

    name: str = "gvcnn"
    # Model family: gvcnn (grouping head) | mvcnn (max-pool over views).
    model: str = "gvcnn"
    backbone: str = "inception_v1"       # inception_v1 | inception_v4 | resnet50
    num_group: int = 8                   # M groups partitioning (0,1]
    # Endpoint feeding the view-discrimination FCN ("raw view descriptor").
    raw_endpoint: str = "Mixed_3c"
    # Endpoint whose GAP is the final view descriptor (Mixed_5c + GAP).
    final_endpoint: str = "Mixed_5c"
    # Squash of the FCN output into (0,1): softmax over the view axis (the
    # parity default) or a per-view sigmoid.
    score_squash: str = "softmax"        # softmax | sigmoid | sigmoid_log
    # Group-weight variant: mean (sum/count) of member scores, or the
    # paper's ceiling-of-sum.
    group_weight: str = "mean"           # mean | ceil_sum
    dropout_keep_prob: float = 0.8       # slim inception_v1 head default
    # BatchNorm EMA decay.  None = backbone's slim default.
    bn_momentum: Optional[float] = None
    # Multi-view on/off: False = plain single-view classifier.
    multi_view: bool = True
    # Compute dtype for the backbone (params/BN stats stay fp32).
    compute_dtype: str = "bfloat16"
    # JAX package: run the grouping head as its Pallas kernel.  The port
    # accepts and logs it (`build_model`): a CUDA tensor always goes through
    # the CUDA kernel (ops/grouping_kernel.py), a CPU tensor through the
    # plain version.
    use_pallas_grouping: bool = False
    # Rematerialize backbone activations in the backward pass (the port:
    # one torch.utils.checkpoint region over the backbone call).
    remat_backbone: bool = False
    # Selective remat through this endpoint ("" = off; Inception-v1 only,
    # another backbone runs without it).
    remat_until: str = ""
    # Run the 7x7/2 stem as a 4x4/1 conv on space-to-depth(2) input.  The
    # port accepts it: same math and parameters, the stem runs as its
    # kernel (even H and W only, as in the JAX package).
    stem_space_to_depth: bool = False
    # JAX package: run the 7x7/2 stem as its Pallas kernel.  The port
    # accepts and logs it (`build_model`): a CUDA tensor always goes through
    # the CUDA stem kernel (ops/stem_kernel.py), a CPU tensor through the
    # plain version.
    stem_pallas: bool = False
    # Merge Inception Mixed-block branch convolutions into wider convs
    # ("none" | "1x1" | "full", with per-block overrides).  Same math and
    # parameters under every policy; the port runs the unmerged math.
    merge_inception_branches: str = "1x1"

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    # Data-parallel degree.  None = use all visible devices.
    num_devices: Optional[int] = None
    # Cross-replica BatchNorm statistics under data parallelism.
    bn_sync: str = "global"              # global | local

    def replace(self, **kw) -> "GVCNNConfig":
        return dataclasses.replace(self, **kw)


def resolve_transfer_dtype(config: "GVCNNConfig"):
    """DataConfig.transfer_dtype -> dtype name for the host-to-device
    copy, or None for no host-side cast (a copy of the JAX package's rule):
    "auto" sends bfloat16 exactly when the model computes in bfloat16 (the
    same bits as the cast on the device, half the bytes); float32 and uint8
    go as they are."""
    td = config.data.transfer_dtype
    if td == "auto":
        td = ("bfloat16" if config.compute_dtype == "bfloat16"
              else "float32")
    return None if td in ("float32", "uint8") else td


def _cfg(**kw) -> GVCNNConfig:
    data_kw = kw.pop("data", {})
    train_kw = kw.pop("train", {})
    return GVCNNConfig(
        data=DataConfig(**data_kw), train=TrainConfig(**train_kw), **kw
    )


# The named configs: gvcnn_tf_tpu.configs.CONFIGS, and
# mn40_12view_inception_resnet_v2, whose backbone the JAX package lacks.
CONFIGS = {
    # Inception-v1 single-view ModelNet10 classification.
    "mn10_single_view": _cfg(
        name="mn10_single_view",
        multi_view=False,
        compute_dtype="float32",
        data=dict(dataset="modelnet10", num_classes=10, num_views=1,
                  batch_size=8),
    ),
    # GVCNN 8-view ModelNet10.
    "mn10_8view": _cfg(
        name="mn10_8view",
        data=dict(dataset="modelnet10", num_classes=10, num_views=8,
                  batch_size=8),
    ),
    # GVCNN 12-view ModelNet40, Inception-v1 backbone — the flagship, and
    # the config the port serves.
    "mn40_12view": _cfg(
        name="mn40_12view",
        data=dict(dataset="modelnet40", num_classes=40, num_views=12,
                  batch_size=8),
    ),
    # GVCNN 12-view ModelNet40 with swapped backbones.
    "mn40_12view_inception_v4": _cfg(
        name="mn40_12view_inception_v4",
        backbone="inception_v4",
        raw_endpoint="Mixed_5e",
        final_endpoint="Mixed_7d",
        data=dict(dataset="modelnet40", num_classes=40, num_views=12,
                  batch_size=8),
    ),
    # The port alone: the JAX package has no Inception-ResNet-v2 backbone.
    "mn40_12view_inception_resnet_v2": _cfg(
        name="mn40_12view_inception_resnet_v2",
        backbone="inception_resnet_v2",
        raw_endpoint="Repeat",
        final_endpoint="Conv2d_7b_1x1",
        data=dict(dataset="modelnet40", num_classes=40, num_views=12,
                  batch_size=8),
    ),
    "mn40_12view_resnet50": _cfg(
        name="mn40_12view_resnet50",
        backbone="resnet50",
        raw_endpoint="block2",
        final_endpoint="block4",
        data=dict(dataset="modelnet40", num_classes=40, num_views=12,
                  batch_size=8),
    ),
    # MVCNN baseline: shared backbone + max over all view descriptors.
    "mn40_12view_mvcnn": _cfg(
        name="mn40_12view_mvcnn",
        model="mvcnn",
        data=dict(dataset="modelnet40", num_classes=40, num_views=12,
                  batch_size=8),
    ),
    # Data-parallel 12-view ModelNet40 training over 8 devices.
    "mn40_12view_dp8": _cfg(
        name="mn40_12view_dp8",
        num_devices=8,
        data=dict(dataset="modelnet40", num_classes=40, num_views=12,
                  batch_size=64),
    ),
}


def get_config(name: str) -> GVCNNConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]


# ---------------------------------------------------------------------------
# Reference-compatible CLI flags (the same names as gvcnn_tf_tpu.configs).
# ---------------------------------------------------------------------------

def add_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Register the reference's flag names."""
    p.add_argument("--config", default="mn40_12view",
                   help=f"named config, one of {sorted(CONFIGS)}")
    p.add_argument("--num_views", type=int, default=None)
    p.add_argument("--num_group", type=int, default=None)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--optimizer", default=None)
    p.add_argument("--how_many_training_steps", "--num_steps", dest="num_steps",
                   type=int, default=None)
    p.add_argument("--num_epochs", "--epochs", dest="epochs", type=float,
                   default=None,
                   help="train for N epochs over the split (overrides steps)")
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--accumulate_steps", type=int, default=None,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--eval_every", type=int, default=None,
                   help="run validation-split eval every N steps "
                        "(0 = off; single-process runs only)")
    p.add_argument("--train_logdir", default=None)
    p.add_argument("--dataset_dir", default=None)
    p.add_argument("--dataset", default=None)
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--checkpoint_exclude_scopes", default=None,
                   help="comma-separated scope prefixes to skip on warm-start")
    p.add_argument("--backbone", default=None)
    p.add_argument("--model", default=None, help="gvcnn | mvcnn")
    p.add_argument("--bn_momentum", type=float, default=None,
                   help="BN EMA decay; lower (e.g. 0.9) for short runs")
    p.add_argument("--group_weight", default=None,
                   help="group weight variant: mean | ceil_sum")
    p.add_argument("--preprocessing", default=None,
                   help="preprocessing family: square | slim")
    p.add_argument("--loader", default=None,
                   choices=["auto", "tfrecord", "native", "synthetic",
                            "procedural", "decoded"],
                   help="input loader ('decoded' = decode-once uint8 "
                        "memmap cache over an image tree)")
    p.add_argument("--transfer_dtype", default=None,
                   choices=["auto", "float32", "bfloat16", "uint8"],
                   help="host->device wire dtype for views (uint8 ships "
                        "raw renders and normalizes on the device)")
    p.add_argument("--device_resident", default=None,
                   choices=["auto", "on", "off"],
                   help="stage the procedural uint8 train split on the "
                        "card once and gather each batch inside the train "
                        "step (auto: one process, uint8 wire, at most "
                        "4 GiB; off under several ranks or bn_sync local)")
    p.add_argument("--score_squash", default=None,
                   help="score squash: softmax | sigmoid | sigmoid_log")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--stem_space_to_depth", action="store_true",
                   default=None,
                   help="run the 7x7/2 stem on space-to-depth input "
                        "(same math and parameters; the PyTorch port runs "
                        "the stem as its CUDA kernel)")
    p.add_argument("--stem_pallas", action="store_true", default=None,
                   help="JAX package: run the 7x7/2 stem as its Pallas "
                        "kernel.  Accepted and logged by the PyTorch "
                        "port, where a CUDA tensor always goes through the "
                        "hand-written CUDA stem and grouping kernels")
    p.add_argument("--merge_inception_branches", default=None,
                   help="merge Mixed-block branch convs into wider convs "
                        "(same math and parameters): "
                        "'none' | '1x1' | 'full', optionally with "
                        "per-block overrides, e.g. "
                        "'1x1,Mixed_3b=full,Mixed_3c=full'")
    p.add_argument("--remat_until", default=None,
                   help="selectively rematerialize the backbone prefix "
                        "through this endpoint in the backward pass; "
                        "'' = off")
    p.add_argument("--bn_sync", default=None, choices=["global", "local"],
                   help="BN statistics under data parallelism: 'global' "
                        "(exact global-batch stats, default) or 'local' "
                        "(per-device stats)")
    return p


def config_from_flags(args: argparse.Namespace) -> GVCNNConfig:
    cfg = get_config(args.config)
    data_kw, train_kw, top_kw = {}, {}, {}
    for field, dst in [
        ("num_views", data_kw), ("num_classes", data_kw), ("height", data_kw),
        ("width", data_kw), ("batch_size", data_kw), ("dataset_dir", data_kw),
        ("dataset", data_kw), ("preprocessing", data_kw),
        ("transfer_dtype", data_kw), ("loader", data_kw),
        ("device_resident", data_kw),
        ("learning_rate", train_kw), ("optimizer", train_kw),
        ("num_steps", train_kw), ("train_logdir", train_kw),
        ("epochs", train_kw), ("steps_per_epoch", train_kw),
        ("accumulate_steps", train_kw), ("eval_every", train_kw),
        ("checkpoint_path", train_kw), ("seed", train_kw),
        ("num_group", top_kw), ("backbone", top_kw), ("model", top_kw),
        ("bn_momentum", top_kw), ("group_weight", top_kw),
        ("score_squash", top_kw), ("stem_space_to_depth", top_kw),
        ("stem_pallas", top_kw), ("merge_inception_branches", top_kw),
        ("remat_until", top_kw), ("bn_sync", top_kw),
    ]:
        v = getattr(args, field, None)
        if v is not None:
            dst[field] = v
    if getattr(args, "checkpoint_exclude_scopes", None) is not None:
        train_kw["checkpoint_exclude_scopes"] = tuple(
            s for s in args.checkpoint_exclude_scopes.split(",") if s
        )
    if data_kw:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **data_kw))
    if train_kw:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_kw))
    if top_kw:
        cfg = cfg.replace(**top_kw)
    return cfg
