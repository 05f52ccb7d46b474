"""Each per-layer reader on canned records: what it reads, and nothing
where there is nothing to read."""

import pytest

from benchmark import harness, tracing
from benchmark.kernels import kernel_class

PEAKS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12,
         "bytes": 3.35e12}
MODEL = {"backbone": "inception_v1", "num_views": 12, "height": 224,
         "width": 224, "num_classes": 40, "raw_endpoint": "Mixed_3c",
         "final_endpoint": "Mixed_5c", "compute_dtype": "bfloat16"}
STEM = "(anonymous namespace)::stem_conv_mma_kernel(__nv_bfloat16 const*)"
KERNELS = {
    STEM: (10, 10 * 0.0005),
    "void at::native::max_pool_forward_nhwc<c10::BFloat16, int>": (130, 0.08),
    "void at::native::max_pool_backward_nhwc<c10::BFloat16, float>": (130, 0.14),
    "void at::native::batch_norm_collect_statistics_channels_last_kernel":
        (570, 0.05),
    "sm90_xmma_fprop_implicit_gemm_bf16bf16": (560, 0.2),
}
TRAIN = {"kind": "train_stream", "steps": 100, "window_s": 6.6,
         "steady": (30, 1.98), "views_a_step": 384, "shapes_a_step": 32,
         "model": MODEL, "peaks": PEAKS,
         "spans": {"input_wait": [0.001, 0.003], "step_call": [0.04, 0.05]},
         "profile": {"window_s": 0.7, "busy_s": 0.665, "steps": 10,
                     "kernels": KERNELS, "gaps": [],
                     "host": {"step_call": {
                         "n": 10, "s": 0.45, "runtime": {
                             "cudaGraphLaunch": 0.40,
                             "cudaLaunchKernel": 0.01}}}}}


def read(name, records):
    return harness.reader(name).read(records)


def test_train_readers():
    assert read("input_wait_ms.train", TRAIN) == pytest.approx(2.0)
    assert read("host_ms_per_step.train", TRAIN) == pytest.approx(4.0)
    assert read("device_idle_pct.train", TRAIN) == pytest.approx(5.0)
    assert read("maxpool_ms_per_step.train", TRAIN) == pytest.approx(22.0)
    assert read("bn_ms_per_step.train", TRAIN) == pytest.approx(5.0)
    flops = 3561.119809536e9
    assert read("step_mfu.train", TRAIN) == pytest.approx(
        100 * flops * 30 / 1.98 / 989e12)
    bound = (2 * 384 * 224 * 224 * 3 + 2 * 147 * 64
             + 2 * 384 * 112 * 112 * 64) / 3.35e12
    assert read("stem_conv_roofline", TRAIN) == pytest.approx(
        100 * bound / 0.0005)


def test_eval_reader():
    ev = {"kind": "eval_pass", "profile": {"window_s": 2.0, "busy_s": 1.8,
                                           "kernels": {}, "gaps": []}}
    assert read("device_idle_pct.eval", ev) == pytest.approx(10.0)


@pytest.mark.parametrize("name", [
    "input_wait_ms.train", "host_ms_per_step.train", "device_idle_pct.train",
    "device_idle_pct.eval", "step_mfu.train",
    "maxpool_ms_per_step.train", "bn_ms_per_step.train",
    "stem_conv_roofline"])
def test_nothing_to_read_gives_nothing(name):
    empty = {"kind": "train_stream", "spans": {}, "profile": None,
             "peaks": None, "model": MODEL, "steady": None}
    assert read(name, empty) is None
    no_stem = dict(TRAIN, profile=dict(TRAIN["profile"], kernels={
        k: v for k, v in KERNELS.items() if k != STEM}))
    if name == "stem_conv_roofline":
        assert read(name, no_stem) is None


def test_kernel_classes():
    assert kernel_class(STEM) == "stem_conv"
    assert kernel_class("group_and_fuse_kernel") == "group_and_fuse"
    assert kernel_class("batch_norm_backward_reduce_channels_last") == \
        "batch_norm"
    assert kernel_class("max_pool_backward_nhwc") == "max_pool"


def test_idle_gaps_are_labelled_by_the_span_they_start_in():
    class Ev:
        def __init__(self, name, lo, hi, cuda):
            import torch

            self.name = name
            self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                                else torch.autograd.DeviceType.CPU)
            self.time_range = type("R", (), {"start": lo, "end": hi})()

    class Prof:
        def events(self):
            return [Ev(tracing.WINDOW, 0, 100, False),
                    Ev("bench.input_wait", 10, 30, False),
                    Ev("cudaMemcpyAsync", 12, 20, False),
                    Ev("cudaLaunchKernel", 31, 32, False),
                    Ev("k1", 0, 10, True), Ev("k2", 40, 90, True),
                    Ev("k2", 50, 60, True)]

    w = tracing.ProfiledWindow(tracing.Spans(), "cpu")
    w.prof = Prof()
    out = w.read()
    assert out["busy_s"] == pytest.approx(60e-6)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["gaps"][0] == ["input_wait", pytest.approx(30e-6)]
    assert out["kernels"]["k2"] == (2, pytest.approx(60e-6))
    assert out["host"]["input_wait"]["n"] == 1
    assert out["host"]["input_wait"]["runtime"] == {
        "cudaMemcpyAsync": pytest.approx(8e-6)}
