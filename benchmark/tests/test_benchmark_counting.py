"""`counting.py` (published layer shapes) against the program's own work
counter (`tools/bench_layers.count_work`, what the step dispatches) on the
B=32 train step of every configuration file at its own size, on the meta
device (shapes only).  The program takes no input gradient of the first
conv, so it dispatches the counted work less that conv's forward once."""

import dataclasses
import json

import pytest
import torch

from benchmark import counting, harness
from benchmark.reference import gvcnn

CONFIGS = sorted(p.stem for p in (harness.HERE / "configs").glob("*.json"))
CONV_OPS = ("aten::convolution", "aten::convolution_backward", "aten::mm",
            "aten::addmm", "aten::bmm", "gvcnn::stem_conv7x7s2")


@pytest.mark.parametrize("config", CONFIGS)
def test_counted_step_matches_the_dispatched_convs_and_matmuls(config):
    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model
    from gvcnn_tf_tpu_torch.parallel import World
    from gvcnn_tf_tpu_torch.tools.bench_layers import count_work
    from gvcnn_tf_tpu_torch.train import (
        Optimizer, TrainState, kernel_params, train_step)

    file = json.loads((harness.HERE / "configs"
                       / f"{config}.json").read_text())
    model_cfg = file["model"]
    v, h, w = (model_cfg[k] for k in ("num_views", "height", "width"))
    cfg = get_config(file["port_config"])
    cfg = cfg.replace(dropout_keep_prob=1.0, data=dataclasses.replace(
        cfg.data, batch_size=32, num_views=v, height=h, width=w,
        num_classes=model_cfg["num_classes"]))
    model = build_model(cfg).to("meta").train()
    named = list(model.named_parameters())
    state = TrainState(
        step=0, model=model,
        optimizer=Optimizer([p for _, p in named], cfg.train),
        generators=[torch.Generator()], flip_generator=torch.Generator(),
        kernels=kernel_params(named),
        world=World(device=torch.device("meta")))
    views = torch.empty((32, v, h, w, 3), dtype=torch.uint8, device="meta")
    batch = {"views": views,
             "label": torch.empty(32, dtype=torch.long, device="meta")}
    work = count_work(lambda: train_step(state, batch, cfg))
    dispatched = sum(work.by_op[op][1] for op in CONV_OPS
                     if op in work.by_op)
    bb = gvcnn.backbone(model_cfg["backbone"])
    c = next(iter(bb.conv_shapes(model_cfg["final_endpoint"], h, w)))
    first_conv = 32 * v * counting.conv_flops(c.cin, c.cout, c.kernel, c.out)
    counted = counting.train_step_flops(model_cfg, 32)
    assert abs(counted - first_conv - dispatched) <= 1e-5 * counted
    if config == "mn40_12view":      # bench_variants' reading on the card
        assert round(dispatched / 1e9, 1) == 3470.5


def test_stem_work_is_the_published_shape():
    m = json.loads((harness.HERE / "configs"
                    / "mn40_12view.json").read_text())["model"]
    flops, nbytes = counting.stem_work(m, 384)
    assert flops == 2 * 384 * 112 * 112 * 64 * 147
    assert nbytes == 2 * (384 * 224 * 224 * 3 + 147 * 64
                          + 384 * 112 * 112 * 64)
