"""Operations and bytes of a configuration, counted from its published
layer shapes (the reference's tables), independent of how the program
implements them.

Every conv and matmul counts 2 FLOP a multiply-add; nothing else counts
(BatchNorm, pools, elementwise ops and the grouping head's compares are a
rounding error beside them).  A conv's multiply-adds are cin cout kh kw
h_out w_out, with the output size the backbone's own `conv_shapes` gives
under its padding; a conv with a bias and no BatchNorm (`ConvShape.bn`
false) counts the same, its bias add uncounted like a BatchNorm.  A train
step counts 3x its forward (the forward, and the backward's input and
weight gradients).  The stem conv (K2) reads its input and weight once
and writes its output once, in the compute dtype."""

from __future__ import annotations

from benchmark.reference import gvcnn

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def conv_flops(cin, cout, kernel, out) -> int:
    """FLOPs of a conv with a (kh, kw) `kernel` and an (h, w) output."""
    (kh, kw), (ho, wo) = kernel, out
    return 2 * cin * cout * kh * kw * ho * wo


def forward_flops(model: dict, shapes: int) -> int:
    """FLOPs of one forward over `shapes` shapes of `num_views` views."""
    bb = gvcnn.backbone(model["backbone"])
    h, w = model["height"], model["width"]
    per_view = sum(conv_flops(c.cin, c.cout, c.kernel, c.out)
                   for c in bb.conv_shapes(model["final_endpoint"], h, w))
    ch = bb.channels(model["final_endpoint"])
    raw = bb.spatial(model["raw_endpoint"], h, w)
    hidden = gvcnn.SCORE_HIDDEN
    per_view += conv_flops(ch[model["raw_endpoint"]], hidden, (1, 1), raw)
    per_view += conv_flops(hidden, 1, (1, 1), raw)
    head = 2 * ch[model["final_endpoint"]] * model["num_classes"]
    return shapes * (model["num_views"] * per_view + head)


def train_step_flops(model: dict, shapes: int) -> int:
    return 3 * forward_flops(model, shapes)


def stem_work(model: dict, images: int):
    """(FLOPs, bytes) of one launch of the 7x7/2 stem conv over `images`
    images: 2 multiply-adds a tap, the input, the 7x7x3x64 weight and the
    output in the compute dtype."""
    h, w = model["height"], model["width"]
    out = images * -(-h // 2) * -(-w // 2) * 64
    nb = DTYPE_BYTES[model["compute_dtype"]]
    flops = 2 * out * 7 * 7 * 3
    nbytes = nb * (images * h * w * 3 + 7 * 7 * 3 * 64 + out)
    return flops, nbytes
