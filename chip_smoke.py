"""Smoke run of the PyTorch port's serving, training, evaluation and
prediction paths on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure raises and the exit code is not 0:

1. The card (nvidia-smi name and power limit), torch and CUDA versions.
2. Build the CUDA kernels from gvcnn_tf_tpu_torch/csrc with nvcc.
3. The stem kernel against its plain PyTorch version, without and with
   its epilogue (scale in [0.5, 2], mixed-sign shift, ReLU), at the serving
   shapes, one H % 4 == 2 shape and one width that is not a multiple of 8;
   kernel, plain and cuDNN times; the whole `Stem` module (conv + BN + ReLU
   in the kernel) against the plain conv -> BatchNorm -> ReLU sequence.
4. The grouping-head kernel against its plain version, both weight modes,
   M in {1, 8, 16}, V in {1, 8, 12}, scores on the j/M edges, empty groups;
   kernel and plain times.
5. The slice: the mn40_12view inference server (seeded weights, folded BN,
   full width, 12 views of 224x224, bf16) on an HTTP port; a B=1 uint8, a
   B=8 float and a B=11 request, with the kernels' launch counts over those
   requests; the card's logits and scores for a B=2 request against the
   same weights run in fp32 on the CPU through the plain versions; request
   latency at B=1 and B=8.
6. The stem kernel's autograd Function (kernel forward, cuDNN weight
   gradient backward) against autograd through the plain version: dw at the
   B=8 training shape (96, 224, 224, 3) and at (2, 30, 30, 3) and
   (3, 8, 130, 3), and dx where x needs a gradient; the Function's forward
   + backward, its backward alone, and cuDNN's weight gradient alone.
7. The grouping kernel's autograd Function against autograd through the
   plain version: both modes, M in {1, 8, 16}, scores on the j/M edges,
   empty groups; forward + backward and backward alone.
8. The training slice: `train()` of mn40_12view at full width (B=8, 12
   views of 224x224, bf16, momentum SGD, dropout 0.8, the synthetic stream)
   into a scratch train_logdir for TRAIN_STEPS steps, then a second call
   that resumes from its last checkpoint for RESUME_STEPS more; the loss
   finite, parameters and BN statistics moved, one launch of each kernel a
   step, the resume at the right step.  One train step at B=2, full width,
   on the card (bf16) against the same seeded weights and batch in fp32 on
   the CPU through the plain versions: loss, grad_norm, each parameter
   tensor's gradient norm, and the gradient cosines (all, `Logits`, and the
   late layer groups).  Overfit: Adam at lr 1e-3, 30 steps
   on one fixed B=8 batch; the last loss below half the first.  The step
   time (CUDA events, median of 20 steps on a batch already on the card)
   and views/s.
9. Evaluation and prediction: mn40_12view at full width on the procedural
   split (40 classes, PROC_SHAPES shapes a split, raw uint8 views on the
   wire), both splits rendered first and timed.  `train()` for 10 steps
   with `eval_every` 5: the val split scored at steps 5 and 10 (6 padded
   batches of 8, one launch of each kernel a batch, 10 + 2 x 6 in all).
   `evaluate()` of the step-5 and step-10 checkpoints with a fresh model on
   the card gives the in-training results and argmaxes exactly.  The
   step-10 checkpoint on the card (bf16) against the CPU (fp32, plain
   versions) over the first CPU_SHAPES val shapes: logits within
   LOGIT_REL_TOL of max|logit| batch by batch, argmax equal wherever the
   CPU's top-2 margin is above that bound, counts equal up to the shapes
   under it.  `predict()` of three OFF meshes (and its CLI's CSV), and of a
   B=2 uint8 array card against CPU.  Times: eval views/s end to end (host
   clock, checkpoint load included, rendering excluded) and on the device
   (CUDA events over the 6 forwards of batches already on the card), and
   `train()` views/s on the procedural uint8 stream (10 resumed steps,
   without evaluations).

TF32 is turned off for the whole run (`torch.backends.cudnn.allow_tf32`,
`torch.backends.cuda.matmul.allow_tf32`), so fp32 comparisons on the card
are full fp32.  Times are CUDA-event medians of 30 runs after 5 warm-up
runs (kernels; `ms`), torch.profiler kernel durations (`device_ms`), or
host-clock medians of 20 requests (serving).  `bound_ms` is the larger of
the bytes the function must move (inputs read once, outputs written once)
over 3.35 TB/s and its operations over the peak rate for their type (bf16
tensor cores 989 TFLOP/s; fp32 67 TFLOP/s), from this run's shapes.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a card, or outside a
checkout, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import sys
import time
import urllib.request

import numpy as np
import torch

REQUESTS = 20
# (N, H, W, 3): the B=8 and B=1 serving shapes (N = B x 12 views), then
# one with H % 4 == 2 and one whose rows are not 16-byte aligned
# (W % 8 != 0: the kernel's 2-byte copy path).  The first is the one timed.
STEM_SHAPES = [(96, 224, 224, 3), (12, 224, 224, 3), (2, 30, 30, 3),
               (3, 8, 130, 3)]
STEM_TOL = dict(rtol=1e-2, atol=1e-2)      # bf16 out: one rounding apart
FORWARDS = 4                               # B=1, 8, 11: 1 + 1 + 2 chunks
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA's data sheet
BF16_FLOPS, FP32_FLOPS = 989e12, 67e12     # dense peaks, the same sheet
# Slice on the card (bf16 through ~60 conv layers) vs the CPU in fp32.
# Predicted from a bf16-vs-fp32 run on the CPU at 112x112: logits drift
# ~0.6% of max|logit|, scores ~3e-4.  The bounds leave 5x / 15x room.
LOGIT_REL_TOL = 3e-2
SCORE_ABS_TOL = 5e-3
# One train step, card (bf16) vs CPU (fp32).  Predicted from
# `measure.py train-drift` (bf16 vs fp32 on the CPU, 64x64, 4 views, B=2):
# loss 1.58% apart, grad_norm 1.58%, the Logits gradient's cosine 0.9900.
# Bounds with 3x room or more: 5%, 6%, 1 - cos <= 0.03.  The cosine of all
# gradients was 0.50 on the CPU (0.57 in the JAX package): at random init
# the early convs' gradients, which dominate its norm, swing with any
# rounding of the activations (a 1e-3 perturbation of the input alone gives
# 0.89 in fp32), so 3x room leaves no bound; it is printed and held to > 0.
TRAIN_LOSS_REL_TOL = 5e-2
TRAIN_GNORM_REL_TOL = 6e-2
TRAIN_LOGITS_COS_MIN = 0.97
# Per layer, from the four `train-drift` runs (12 views; 64x64 seeds 0-2,
# 96x96 seed 0).  Every parameter tensor's gradient norm, card over CPU:
# the worst |ln ratio| read 0.494 (a Mixed block's BatchNorm bias), so the
# bound, at 3x, is a ratio in [0.22, 4.5]; a gradient lost or scaled on
# the card fails it in any layer.  Tensors whose gradient is rounding noise
# on both sides (`measure.NOISE_REL`) are left out: at 12 views every
# view's score falls in the first group at init, so no loss gradient
# reaches the scoring FCN.  Cosines of the groups that keep their
# direction under bf16 rounding, at 1 - 3 x (1 - the worst reading):
# Mixed_5c's BatchNorm biases 0.954, `Logits.bias` 0.9997.  The earlier
# groups read 0.29-0.69, which leaves no bound with that room.
TRAIN_LAYER_LOGRATIO_MAX = 1.5
TRAIN_GROUP_COS_MIN = {"Mixed_5c/bn_bias": 0.86, "Logits/bias": 0.999}
TRAIN_STEPS, RESUME_STEPS = 20, 4
OVERFIT_STEPS = 30
# Phase 9: 44 shapes a split give 5 train steps an epoch and 5 full val
# batches of 8 plus one of 4 (padded); the first 16 val shapes go through
# the CPU.
PROC_SHAPES, EVAL_EVERY, EVAL_TRAIN_STEPS = 44, 5, 10
EVAL_FORWARDS = -(-PROC_SHAPES // 8)
CPU_SHAPES = 16
STEM_GRAD_SHAPES = [(96, 224, 224, 3), (2, 30, 30, 3), (3, 8, 130, 3)]


def log(msg):
    print(msg, flush=True)


def bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_card():
    from gvcnn_tf_tpu_torch.tools.measure import card_line

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; TF32 off for this run")
    return card


def phase_build():
    from gvcnn_tf_tpu_torch.ops import _build

    info = _build.build()
    _build.library()
    log(f"kernels: {info['path']} compiled={info['compiled']} in "
        f"{info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _bf16_ulp(t):
    """Spacing of bf16 numbers at |t| (t float32)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _check_stem_epilogue(got, want, conv, scale):
    """The kernel rounds relu(acc * scale + shift) once; the plain version
    rounds the conv, then the result.  They may differ by |scale| x one bf16
    ulp of the conv output, plus one ulp of the result, plus |scale| x 1e-5
    for fp32 sums taken in another order."""
    tol = scale.abs() * (_bf16_ulp(conv) + 1e-5) + _bf16_ulp(want)
    excess = ((got.float() - want).abs() - tol).max().item()
    if excess > 0:
        raise AssertionError(f"stem epilogue off by {excess:.3g} past its "
                             "bound")


def phase_stem(dev):
    import torch.nn.functional as F

    from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import Stem
    from gvcnn_tf_tpu_torch.ops.pool import same_pads
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv, stem_conv_plain
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms, kernel_us

    rs = np.random.RandomState(0)
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(np.float32))
    w = w.to(dev, torch.bfloat16)
    scale = torch.from_numpy(rs.uniform(0.5, 2.0, 64).astype(np.float32))
    shift = torch.from_numpy(rs.uniform(-1.0, 1.0, 64).astype(np.float32))
    scale, shift = scale.to(dev), shift.to(dev)
    max_err, timed = 0.0, None
    for shape in STEM_SHAPES:
        x = torch.from_numpy(rs.uniform(-1, 1, shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        with torch.inference_mode():
            got = stem_conv(x, w)
            fused = stem_conv(x, w, scale, shift, relu=True)
            torch.cuda.synchronize()
            want = stem_conv_plain(x, w)
            torch.testing.assert_close(got.float(), want.float(), **STEM_TOL)
            want_fused = stem_conv_plain(x, w, scale, shift, relu=True)
            _check_stem_epilogue(fused, want_fused.float(), want.float(),
                                 scale)
            err = (got.float() - want.float()).abs().max().item()
            efused = (fused.float() - want_fused.float()).abs().max().item()
        max_err = max(max_err, err, efused)
        log(f"stem {shape}: max|err| {err:.3g} (epilogue {efused:.3g})")
        if timed is not None:
            continue
        n, h, wd, _ = shape
        ph, pw = same_pads(h, 7, 2), same_pads(wd, 7, 2)
        with torch.inference_mode():
            xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
            timed = dict(
                ms=cuda_ms(lambda: stem_conv(x, w)),
                epilogue_ms=cuda_ms(
                    lambda: stem_conv(x, w, scale, shift, relu=True)),
                plain_ms=cuda_ms(lambda: stem_conv_plain(x, w)),
                library_ms=cuda_ms(lambda: F.conv2d(xn, w, stride=2)),
                device_ms=kernel_us(lambda: stem_conv(x, w),
                                    "stem_conv")[0] / 1e3)
        out_bytes = got.numel() * 2
        timed["bound_ms"], timed["bound_by"] = bound(
            x.numel() * 2 + w.numel() * 2 + out_bytes,
            2 * got.numel() * 147, BF16_FLOPS)
        log(f"stem {shape}: kernel {timed['ms']:.4f} ms (with epilogue "
            f"{timed['epilogue_ms']:.4f}, device {timed['device_ms']:.4f}), "
            f"plain {timed['plain_ms']:.4f} ms, cuDNN conv on pre-padded "
            f"input {timed['library_ms']:.4f} ms, bound "
            f"{timed['bound_ms']:.4f} ms ({timed['bound_by']})")

        # The whole Conv2d_1a_7x7 layer: conv + BN + ReLU in the kernel, vs
        # the plain conv, then BatchNorm and ReLU as two more passes.
        stem = Stem().eval()
        with torch.no_grad():
            stem.conv.weight.copy_(w.float().cpu())
            stem.BatchNorm.bias.copy_(torch.from_numpy(
                rs.randn(64).astype(np.float32)))
            stem.BatchNorm.running_mean.copy_(torch.from_numpy(
                rs.randn(64).astype(np.float32)))
            stem.BatchNorm.running_var.copy_(torch.from_numpy(
                rs.uniform(0.25, 4.0, 64).astype(np.float32)))
        stem.conv.to(torch.bfloat16)
        stem.to(dev)

        def plain_layer():
            y = stem_conv_plain(x, stem.conv.weight).permute(0, 3, 1, 2)
            return F.relu(stem.BatchNorm(y))

        with torch.inference_mode():
            layer = stem(x)
            ref = plain_layer()
            torch.testing.assert_close(layer.float(), ref.float(),
                                       rtol=2e-2, atol=5e-2)
            timed["layer_ms"] = cuda_ms(lambda: stem(x))
            timed["plain_layer_ms"] = cuda_ms(plain_layer)
        log(f"Stem module {shape}: {timed['layer_ms']:.4f} ms; plain conv "
            f"-> BatchNorm -> ReLU {timed['plain_layer_ms']:.4f} ms")
    return dict(max_abs_err=max_err, **timed)


def _clear_scores(rs, b, v, m):
    while True:
        s = rs.dirichlet(np.ones(v) * 0.7, size=b).astype(np.float32)
        if m == 1 or np.abs(s[..., None] - np.arange(1, m) / m).min() > 1e-5:
            return s


def _edge_scores(b, v, m):
    grid = np.arange(0, m + 1, dtype=np.float32) / np.float32(m)
    return grid[np.arange(b * v).reshape(b, v) * 3 % (m + 1)]


def phase_grouping(dev):
    from gvcnn_tf_tpu_torch.ops.grouping_kernel import (
        group_and_fuse,
        group_and_fuse_plain,
    )
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms, kernel_us

    rs = np.random.RandomState(1)
    cases = [(8, 12, 1024, 8, mode, False) for mode in ("mean", "ceil_sum")]
    cases += [(8, v, 1024, m, "mean", False) for m in (1, 8, 16)
              for v in (1, 8, 12)]
    cases += [(8, 12, 1024, m, mode, True) for m in (1, 8, 16)
              for mode in ("mean", "ceil_sum")]
    max_err, empty_seen = 0.0, False
    for b, v, c, m, mode, edges in cases:
        scores = _edge_scores(b, v, m) if edges else _clear_scores(rs, b, v, m)
        s = torch.from_numpy(scores).to(dev)
        d = torch.from_numpy(rs.randn(b, v, c).astype(np.float32)).to(dev)
        with torch.inference_mode():
            got = [t.cpu().numpy() for t in group_and_fuse(s, d, m, mode)]
            want = [t.cpu().numpy() for t in group_and_fuse_plain(s, d, m,
                                                                 mode)]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
        empty_seen |= bool((want[2].sum(-1) == 0).any())
        max_err = max(max_err, float(np.abs(got[0] - want[0]).max()),
                      float(np.abs(got[1] - want[1]).max()))
    if not empty_seen:
        raise AssertionError("no case had an empty group")
    log(f"grouping: {len(cases)} cases match, max|err| {max_err:.3g}")

    b, v, c, m = 8, 12, 1024, 8
    s = torch.from_numpy(_clear_scores(rs, b, v, m)).to(dev)
    d = torch.from_numpy(rs.randn(b, v, c).astype(np.float32)).to(dev)
    with torch.inference_mode():
        ms = cuda_ms(lambda: group_and_fuse(s, d, m))
        device_ms = kernel_us(lambda: group_and_fuse(s, d, m),
                              "group_and_fuse")[0] / 1e3
        plain_ms = cuda_ms(lambda: group_and_fuse_plain(s, d, m))
    # Reads scores and descriptors, writes fused, weights and scheme; per
    # channel V compares and maxima and M multiply-adds in fp32.
    bound_ms, bound_by = bound(
        4 * (b * v + b * v * c + b * c + b * m + b * m * v),
        b * c * (2 * v + 2 * m), FP32_FLOPS)
    log(f"grouping ({b}, {v}, {c}, M={m}): kernel {ms:.4f} ms (device "
        f"{device_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} "
        f"ms ({bound_by})")
    return dict(max_abs_err=max_err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def _post(url, views):
    buf = io.BytesIO()
    np.savez(buf, views=views)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise AssertionError(f"/predict returned {r.status}")
        return json.loads(r.read())


def _check_results(results, n, num_views):
    if len(results) != n:
        raise AssertionError(f"{len(results)} results for {n} shapes")
    for r in results:
        if not 0 <= r["class_index"] < 40:
            raise AssertionError(f"class_index {r['class_index']}")
        if not 0 < r["probability"] <= 1:
            raise AssertionError(f"probability {r['probability']}")
        if len(r["view_scores"]) != num_views or not np.all(
                np.isfinite(r["view_scores"])):
            raise AssertionError(f"view_scores {r['view_scores']}")
        if abs(sum(r["view_scores"]) - 1.0) > 1e-4:
            raise AssertionError(f"view_scores sum {sum(r['view_scores'])}")


def phase_slice(card):
    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.ops.grouping_kernel import group_and_fuse
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv
    from gvcnn_tf_tpu_torch.serve import serve
    from gvcnn_tf_tpu_torch.utils import fold_batch_norm

    cfg = get_config("mn40_12view")
    t0 = time.perf_counter()
    httpd, thread, engine = serve(cfg, port=0, serve_batch_size=8,
                                  block=False, device="cuda")
    try:
        log(f"engine up in {time.perf_counter() - t0:.1f} s, buckets "
            f"{engine.buckets}")
        url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
        rs = np.random.RandomState(2)
        d = cfg.data
        shape = (d.num_views, d.height, d.width, 3)
        u8 = lambda n: rs.randint(0, 256, (n,) + shape).astype(np.uint8)
        fl = lambda n: rs.uniform(-1, 1, (n,) + shape).astype(np.float32)

        stem_conv.launches = group_and_fuse.launches = 0
        for n, views in [(1, u8(1)), (8, fl(8)), (11, fl(11))]:
            _check_results(_post(url, views), n, d.num_views)
        launches = {"stem": stem_conv.launches,
                    "grouping": group_and_fuse.launches}
        log(f"launches over the B=1, 8, 11 requests: {launches} in "
            f"{FORWARDS} forwards")
        # 1 + 1 + 2 chunks (11 = 8 + 3 padded to 8), one launch each.
        if launches != {"stem": FORWARDS, "grouping": FORWARDS}:
            raise AssertionError(f"expected {FORWARDS} launches of each "
                                 f"kernel, got {launches}")

        views2 = fl(2)
        logits, scores = engine.logits_and_scores(views2)
        ref = fold_batch_norm(init_weights(build_model(
            cfg.replace(compute_dtype="float32")), cfg.train.seed)).eval()
        with torch.inference_mode():
            ref_logits, ep = ref(torch.from_numpy(views2))
        ref_logits = ref_logits.numpy()
        ref_scores = ep["view_discrimination_scores"].numpy()
        for a in (logits, scores):
            if not np.all(np.isfinite(a)):
                raise AssertionError("non-finite output on the card")
        scale = float(np.abs(ref_logits).max())
        dlogit = float(np.abs(logits - ref_logits).max())
        dscore = float(np.abs(scores - ref_scores).max())
        log(f"B=2 card (bf16) vs CPU (fp32): max|dlogit| {dlogit:.4g} of "
            f"max|logit| {scale:.4g} (rel {dlogit / scale:.3g}, bound "
            f"{LOGIT_REL_TOL}); max|dscore| {dscore:.3g} (bound "
            f"{SCORE_ABS_TOL}); argmax {logits.argmax(-1).tolist()} vs "
            f"{ref_logits.argmax(-1).tolist()}")
        if dlogit > LOGIT_REL_TOL * scale or dscore > SCORE_ABS_TOL:
            raise AssertionError("card and CPU reference disagree")
        if not np.array_equal(logits.argmax(-1), ref_logits.argmax(-1)):
            raise AssertionError("card and CPU reference argmax differ")

        for n in (1, 8):
            views = u8(n)
            http, eng = [], []
            for _ in range(REQUESTS):
                t = time.perf_counter()
                _post(url, views)
                http.append(time.perf_counter() - t)
                t = time.perf_counter()
                engine.predict(views)
                eng.append(time.perf_counter() - t)
            h50, e50 = statistics.median(http), statistics.median(eng)
            log(f"B={n} uint8 request p50: HTTP {h50 * 1e3:.2f} ms, engine "
                f"{e50 * 1e3:.2f} ms; {n * d.num_views / e50:.1f} views/s "
                f"engine, {n * d.num_views / h50:.1f} views/s HTTP [{card}]")
        log(f"/stats: {json.dumps(engine.latency_stats())}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        thread.join(timeout=60)
    return launches


def phase_stem_backward(dev):
    import torch.nn.functional as F

    from gvcnn_tf_tpu_torch.ops.pool import same_pads
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv, stem_conv_plain
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms

    rs = np.random.RandomState(6)
    w32 = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(
        np.float32)).to(dev)
    max_err, timed = 0.0, None
    for shape in STEM_GRAD_SHAPES:
        n, h, wd, _ = shape
        x = torch.from_numpy(rs.uniform(-1, 1, shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        g = torch.from_numpy(rs.randn(n, -(-h // 2), -(-wd // 2), 64).astype(
            np.float32)).to(dev, torch.bfloat16)
        need_dx = shape != STEM_GRAD_SHAPES[0]
        grads = []
        for fn in (stem_conv, stem_conv_plain):
            xg = x.clone().requires_grad_(need_dx)
            w = w32.clone().requires_grad_()
            fn(xg, w.to(torch.bfloat16)).backward(g)
            grads.append((w.grad, xg.grad))
        torch.cuda.synchronize()
        errs = []
        for got, want in zip(grads[0], grads[1]):
            if want is None:
                continue
            tol = 1e-2 * want.abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"stem gradient {shape}: max|err| "
                                     f"{err:.4g} past {tol:.4g}")
            errs.append(err / want.abs().max().item())
        max_err = max(max_err, *errs)
        log(f"stem backward {shape}: dw{' and dx' if need_dx else ''} match "
            f"autograd through the plain version (max|err| / max "
            f"{max(errs):.3g}, bound 1e-2)")
        if timed is not None:
            continue
        w = w32.clone().requires_grad_()
        wb = w.to(torch.bfloat16)

        def fwd_bwd():
            w.grad = None
            stem_conv(x, w.to(torch.bfloat16)).backward(g)

        y = stem_conv(x, wb)
        ph, pw = same_pads(h, 7, 2), same_pads(wd, 7, 2)
        xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
        gn = g.permute(0, 3, 1, 2)
        wbd = wb.detach()
        timed = dict(
            fwd_bwd_ms=cuda_ms(fwd_bwd),
            backward_ms=cuda_ms(lambda: torch.autograd.grad(
                y, wb, g, retain_graph=True)),
            plain_fwd_bwd_ms=cuda_ms(lambda: stem_conv_plain(
                x, w.to(torch.bfloat16)).backward(g)),
            backward_library_ms=cuda_ms(
                lambda: torch.ops.aten.convolution_backward(
                    gn, xn, wbd, None, [2, 2], [0, 0], [1, 1], False, [0, 0],
                    1, [False, True, False])))
        # dw: reads x and the output gradient, writes dw; 147 multiply-adds
        # per element of the output gradient.
        timed["backward_bound_ms"], timed["backward_bound_by"] = bound(
            x.numel() * 2 + g.numel() * 2 + w32.numel() * 2,
            2 * g.numel() * 147, BF16_FLOPS)
        log(f"stem backward {shape}: Function forward + backward "
            f"{timed['fwd_bwd_ms']:.4f} ms (plain "
            f"{timed['plain_fwd_bwd_ms']:.4f}"
            f"), backward alone {timed['backward_ms']:.4f} ms, cuDNN weight "
            f"gradient on pre-padded input {timed['backward_library_ms']:.4f}"
            f" ms, bound {timed['backward_bound_ms']:.4f} ms "
            f"({timed['backward_bound_by']})")
    return dict(grad_max_rel_err=max_err, **timed)


def phase_grouping_backward(dev):
    from gvcnn_tf_tpu_torch.ops.grouping_kernel import (
        group_and_fuse,
        group_and_fuse_plain,
    )
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms

    rs = np.random.RandomState(7)
    cases = [(8, 12, 1024, m, mode, edges) for m in (1, 8, 16)
             for mode in ("mean", "ceil_sum") for edges in (False, True)]
    max_err, empty_seen = 0.0, False
    for b, v, c, m, mode, edges in cases:
        scores = _edge_scores(b, v, m) if edges else _clear_scores(rs, b, v, m)
        d = rs.randn(b, v, c).astype(np.float32)
        gf = torch.from_numpy(rs.randn(b, c).astype(np.float32)).to(dev)
        gw = torch.from_numpy(rs.randn(b, m).astype(np.float32)).to(dev)
        grads = []
        for fn in (group_and_fuse, group_and_fuse_plain):
            s = torch.from_numpy(scores).to(dev).requires_grad_()
            dd = torch.from_numpy(d).to(dev).requires_grad_()
            fused, weights, scheme = fn(s, dd, m, mode)
            ((fused * gf).sum() + (weights * gw).sum()).backward()
            grads.append((s.grad, dd.grad))
        empty_seen |= bool((scheme.sum(-1) == 0).any())
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            max_err = max(max_err, (got - want).abs().max().item())
    if not empty_seen:
        raise AssertionError("no case had an empty group")
    log(f"grouping backward: {len(cases)} cases match autograd through the "
        f"plain version, max|err| {max_err:.3g}")

    b, v, c, m = 8, 12, 1024, 8
    s = torch.from_numpy(_clear_scores(rs, b, v, m)).to(dev).requires_grad_()
    d = torch.from_numpy(rs.randn(b, v, c).astype(np.float32)).to(dev)
    d.requires_grad_()
    gf = torch.ones(b, c, device=dev)

    def fwd_bwd(fn):
        s.grad = d.grad = None
        fn(s, d, m)[0].backward(gf)

    fused = group_and_fuse(s, d, m)[0]
    timed = dict(
        fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(group_and_fuse)),
        plain_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(group_and_fuse_plain)),
        backward_ms=cuda_ms(lambda: torch.autograd.grad(
            fused, (s, d), gf, retain_graph=True)))
    log(f"grouping backward ({b}, {v}, {c}, M={m}): Function forward + "
        f"backward {timed['fwd_bwd_ms']:.4f} ms (plain "
        f"{timed['plain_fwd_bwd_ms']:.4f}), backward alone (the plain "
        f"version's VJP replayed) {timed['backward_ms']:.4f} ms")
    return dict(grad_max_abs_err=max_err, **timed)


def _moved(a, b):
    return [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]


def phase_train(card, dev):
    import dataclasses
    import shutil
    from pathlib import Path

    from gvcnn_tf_tpu_torch import get_config
    from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
    from gvcnn_tf_tpu_torch.ops.grouping_kernel import group_and_fuse
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv
    from gvcnn_tf_tpu_torch.tools.measure import (
        cuda_ms,
        train_batch,
        train_step_drift,
    )
    from gvcnn_tf_tpu_torch.train import create_train_state, train, train_step

    logdir = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(logdir, ignore_errors=True)
    base = get_config("mn40_12view")
    cfg = base.replace(train=dataclasses.replace(
        base.train, train_logdir=str(logdir), log_every=10,
        checkpoint_every=10))
    d = cfg.data
    views = d.batch_size * d.num_views

    # The main path: train(), then a second train() that resumes.
    t0 = time.perf_counter()
    stem_conv.launches = group_and_fuse.launches = 0
    state, mets = train(cfg, num_steps=TRAIN_STEPS, device="cuda")
    launches = {"stem": stem_conv.launches,
                "grouping": group_and_fuse.launches}
    wall = time.perf_counter() - t0
    log(f"train(): {TRAIN_STEPS} steps in {wall:.1f} s "
        f"({TRAIN_STEPS * views / wall:.1f} views/s end to end, first step "
        f"and the synthetic stream's host time included); last {mets}")
    if not all(np.isfinite(v) for v in mets.values()):
        raise AssertionError(f"non-finite train metrics {mets}")
    if launches != {"stem": TRAIN_STEPS, "grouping": TRAIN_STEPS}:
        raise AssertionError(f"expected {TRAIN_STEPS} launches of each "
                             f"kernel in {TRAIN_STEPS} steps, got {launches}")
    init = init_weights(build_model(cfg), cfg.train.seed).state_dict()
    trained = state.model.state_dict()
    moved = _moved(init, trained)
    stats = [k for k in init if k.endswith(("running_mean", "running_var"))]
    if set(stats) - set(moved) or len(moved) < len(init) // 2:
        raise AssertionError(f"only {len(moved)} of {len(init)} tensors "
                             "moved")
    log(f"{len(moved)} of {len(init)} parameters and statistics moved, every "
        f"BN statistic among them")

    stem_conv.launches = group_and_fuse.launches = 0
    resumed, _ = train(cfg, num_steps=TRAIN_STEPS + RESUME_STEPS,
                       device="cuda")
    got = (resumed.step, stem_conv.launches, group_and_fuse.launches)
    if got != (TRAIN_STEPS + RESUME_STEPS, RESUME_STEPS, RESUME_STEPS):
        raise AssertionError(f"resume: (step, stem, grouping launches) "
                             f"{got}")
    log(f"resumed at step {TRAIN_STEPS} and ran {RESUME_STEPS} steps "
        f"(launches {got[1:]})")
    shutil.rmtree(logdir, ignore_errors=True)

    # Card vs CPU, one step at B=2.
    small = cfg.replace(data=dataclasses.replace(d, batch_size=2))
    drift = train_step_drift(small, dev)
    check_train_drift(drift)

    # Overfit one fixed batch with Adam.
    ocfg = cfg.replace(train=dataclasses.replace(
        cfg.train, optimizer="adam", learning_rate=1e-3, weight_decay=0.0))
    ostate = create_train_state(ocfg, dev)
    batch = train_batch(ocfg, np.random.RandomState(8), dev)
    losses = [float(train_step(ostate, batch, ocfg)["loss"])
              for _ in range(OVERFIT_STEPS)]
    log(f"overfit (Adam 1e-3, B=8): loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        f" in {OVERFIT_STEPS} steps")
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"overfit: {losses[0]} -> {losses[-1]}")

    # Step time on a batch already on the card (no input pipeline).
    tstate = create_train_state(cfg, dev)
    batch = train_batch(cfg, np.random.RandomState(9), dev)
    stem_conv.launches = group_and_fuse.launches = 0
    step_ms = cuda_ms(lambda: train_step(tstate, batch, cfg), runs=20,
                      warmup=5)
    per_step = {"stem": stem_conv.launches / 25,
                "grouping": group_and_fuse.launches / 25}
    log(f"train step B=8: {step_ms:.3f} ms median, {views / step_ms * 1e3:.1f}"
        f" views/s, launches per step {per_step} [{card}]")
    return dict(launches=launches, per_step=per_step, step_ms=step_ms,
                views_per_s=views / step_ms * 1e3, drift=drift)


@contextlib.contextmanager
def eval_logits():
    """The fp32 logits (on the host) of every GVCNN forward run in eval
    mode while the context is open, in a list: a global module hook, so
    that it sees the forwards inside `train()` and `evaluate()`."""
    from gvcnn_tf_tpu_torch.models.gvcnn import GVCNN

    seen = []

    def hook(module, args, out):
        if isinstance(module, GVCNN) and not module.training:
            seen.append(out[0].detach().float().cpu())

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def check_card_vs_cpu(card, cpu, what):
    """card and CPU logits (N, K): max|dlogit| within LOGIT_REL_TOL of the
    CPU's max|logit|, argmax equal wherever the CPU's top-2 margin exceeds
    that bound.  Returns the shapes under the margin."""
    scale = float(cpu.abs().max())
    bound = LOGIT_REL_TOL * scale
    dlogit = float((card - cpu).abs().max())
    top2 = cpu.topk(2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > bound
    agree = card.argmax(-1) == cpu.argmax(-1)
    log(f"{what}, card (bf16) vs CPU (fp32): max|dlogit| {dlogit:.4g} of "
        f"max|logit| {scale:.4g} (rel {dlogit / scale:.3g}, bound "
        f"{LOGIT_REL_TOL}); argmax equal on {int(agree.sum())} of "
        f"{len(agree)}, {int((~clear).sum())} under the margin")
    if not all(np.isfinite(card.numpy()).ravel()):
        raise AssertionError(f"{what}: non-finite logits on the card")
    if dlogit > bound or not bool(agree[clear].all()):
        raise AssertionError(f"{what}: card and CPU disagree")
    return int((~clear).sum())


def phase_eval(card, dev):
    import csv
    import dataclasses
    import importlib
    import itertools
    import shutil
    from pathlib import Path

    from gvcnn_tf_tpu_torch import evaluate, get_config, predict, train
    from gvcnn_tf_tpu_torch.checkpoint import Checkpointer, load_model
    from gvcnn_tf_tpu_torch.data import make_dataset
    from gvcnn_tf_tpu_torch.data.procedural import class_table
    from gvcnn_tf_tpu_torch.ops.grouping_kernel import group_and_fuse
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv
    from gvcnn_tf_tpu_torch.tools.make_demo_meshes import write_off
    from gvcnn_tf_tpu_torch.tools.measure import cuda_ms, kernel_durations_us
    from gvcnn_tf_tpu_torch.utils import normalize_views

    train_mod = importlib.import_module("gvcnn_tf_tpu_torch.train")
    predict_mod = importlib.import_module("gvcnn_tf_tpu_torch.predict")
    counts = lambda: {"stem": stem_conv.launches,                # noqa: E731
                      "grouping": group_and_fuse.launches}

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_eval"
    shutil.rmtree(root, ignore_errors=True)
    logdir = root / "train"
    base = get_config("mn40_12view")
    cfg = base.replace(
        data=dataclasses.replace(base.data, dataset="procedural",
                                 transfer_dtype="uint8",
                                 synthetic_num_shapes=PROC_SHAPES),
        train=dataclasses.replace(base.train, train_logdir=str(logdir),
                                  log_every=EVAL_EVERY,
                                  checkpoint_every=EVAL_EVERY,
                                  eval_every=EVAL_EVERY))
    cfg32 = cfg.replace(compute_dtype="float32")
    d, seed = cfg.data, cfg.train.seed
    views_per_eval = PROC_SHAPES * d.num_views

    # 1. Both splits, rendered once and kept by the split cache.
    t0 = time.perf_counter()
    for split in (True, False):
        make_dataset(d, train=split, seed=seed)
    log(f"rendered the procedural train and val splits (2 x {PROC_SHAPES} "
        f"shapes, {d.num_views} views of {d.height}x{d.width}) in "
        f"{time.perf_counter() - t0:.1f} s")

    # 2. train() with an evaluation every EVAL_EVERY steps; the in-training
    # evaluations' results, logits and times are taken as they run.
    real_evaluate, in_training = train_mod.evaluate, []

    def recorded_evaluate(*args, **kw):
        with eval_logits() as seen:
            t = time.perf_counter()
            res = real_evaluate(*args, **kw)
            dt = time.perf_counter() - t
        in_training.append((res, torch.cat(seen)[:PROC_SHAPES], dt))
        return res

    train_mod.evaluate = recorded_evaluate
    stem_conv.launches = group_and_fuse.launches = 0
    t0 = time.perf_counter()
    try:
        state, mets = train(cfg, num_steps=EVAL_TRAIN_STEPS, device="cuda")
    finally:
        train_mod.evaluate = real_evaluate
    wall = time.perf_counter() - t0
    train_eval_launches = counts()
    want = EVAL_TRAIN_STEPS + EVAL_TRAIN_STEPS // EVAL_EVERY * EVAL_FORWARDS
    with open(logdir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    vals = [(r["step"], r["val_count"]) for r in recs if "val_count" in r]
    log(f"train() with eval_every {EVAL_EVERY}: {EVAL_TRAIN_STEPS} steps "
        f"and {len(in_training)} evaluations in {wall:.1f} s (the "
        f"evaluations {', '.join(f'{e[2]:.2f}' for e in in_training)} s); "
        f"val records {vals}, accuracy "
        f"{[e[0]['accuracy'] for e in in_training]}; launches "
        f"{train_eval_launches}; last {mets}")
    if train_eval_launches != {"stem": want, "grouping": want}:
        raise AssertionError(f"expected {want} launches of each kernel, got "
                             f"{train_eval_launches}")
    if vals != [(s, PROC_SHAPES) for s in range(
            EVAL_EVERY, EVAL_TRAIN_STEPS + 1, EVAL_EVERY)]:
        raise AssertionError(f"in-training evaluation records {vals}")
    if not state.model.training:
        raise AssertionError("the model stayed in eval mode after train()")

    # 3. Fresh models from the step-5 and step-10 checkpoints.
    ckpt = Checkpointer(str(logdir))
    for (want_res, want_logits, _), step in zip(
            in_training, range(EVAL_EVERY, EVAL_TRAIN_STEPS + 1, EVAL_EVERY)):
        one = root / f"step{step}"
        one.mkdir()
        shutil.copy(ckpt.path(step), one)
        stem_conv.launches = group_and_fuse.launches = 0
        with eval_logits() as seen:
            res = evaluate(cfg, str(one), device="cuda")
        eval_launches = counts()
        logits = torch.cat(seen)[:PROC_SHAPES]
        same = bool(torch.equal(logits.argmax(-1), want_logits.argmax(-1)))
        log(f"evaluate() of the step-{step} checkpoint, fresh model: {res} "
            f"(in training: {want_res}); argmax equal on every shape: "
            f"{same}; max|dlogit| {float((logits - want_logits).abs().max())}"
            f"; launches {eval_launches}")
        if res != want_res or not same:
            raise AssertionError(f"step {step}: a fresh model scores "
                                 "otherwise than the training model did")
        if eval_launches != {"stem": EVAL_FORWARDS,
                             "grouping": EVAL_FORWARDS}:
            raise AssertionError(f"expected {EVAL_FORWARDS} launches of each "
                                 f"kernel, got {eval_launches}")
    # The end-to-end time, without the hook's copies: the main path.
    stem_conv.launches = group_and_fuse.launches = 0
    t0 = time.perf_counter()
    res = evaluate(cfg, str(one), device="cuda")
    eval_wall = time.perf_counter() - t0
    eval_launches = counts()
    if res != want_res or eval_launches != {"stem": EVAL_FORWARDS,
                                            "grouping": EVAL_FORWARDS}:
        raise AssertionError(f"evaluate() {res}, launches {eval_launches}")
    eval_vps = views_per_eval / eval_wall

    # 4. Card against CPU, the step-10 checkpoint, first CPU_SHAPES shapes.
    def first():
        return itertools.islice(make_dataset(d, train=False, seed=seed),
                                CPU_SHAPES // d.batch_size)

    with eval_logits() as card_seen:
        card_res = evaluate(cfg, str(logdir), dataset_iter=first(),
                            device="cuda")
    with eval_logits() as cpu_seen:
        cpu_res = evaluate(cfg32, str(logdir), dataset_iter=first(),
                           device="cpu")
    near = sum(check_card_vs_cpu(a, b, f"eval batch {i}")
               for i, (a, b) in enumerate(zip(card_seen, cpu_seen)))
    log(f"first {CPU_SHAPES} val shapes: card {card_res}, CPU {cpu_res}")
    if (not card_res["count"] == cpu_res["count"] == CPU_SHAPES
            or abs(card_res["correct"] - cpu_res["correct"]) > near):
        raise AssertionError("card and CPU counts disagree")

    # 5. Predict: meshes, the CLI's CSV, and a uint8 array card vs CPU.
    table = dict(class_table(d.num_classes))
    meshes = []
    for i, name in enumerate(("chair", "bottle", "lamp")):
        meshes.append(str(root / f"{name}.off"))
        write_off(meshes[-1], *table[name](np.random.RandomState(i)))
    stem_conv.launches = group_and_fuse.launches = 0
    recs = predict(cfg, str(logdir), mesh_files=meshes, device="cuda")
    got = [(r["shape"], r["class_index"], r["probability"]) for r in recs]
    log(f"predict() of 3 meshes: {got}; launches {counts()}")
    _check_results(recs, 3, d.num_views)
    if counts() != {"stem": 1, "grouping": 1}:
        raise AssertionError(f"predict of 3 shapes: launches {counts()}")
    out = root / "preds.csv"
    argv = ["--checkpoint_dir", str(logdir), "--output_csv", str(out)]
    for m in meshes:
        argv += ["--mesh_file", m]
    predict_mod.main(argv)
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    log(f"predict CLI: {rows}")
    if (rows[0] != ["shape", "class_index", "probability"]
            or [r[0] for r in rows[1:]] != ["chair", "bottle", "lamp"]):
        raise AssertionError(f"predict CSV {rows}")
    u8 = np.random.RandomState(10).randint(
        0, 256, (2, d.num_views, d.height, d.width, 3)).astype(np.uint8)
    with eval_logits() as card_seen:
        card_recs = predict(cfg, str(logdir), views=u8, device="cuda")
    with eval_logits() as cpu_seen:
        predict(cfg32, str(logdir), views=u8, device="cpu")
    _check_results(card_recs, 2, d.num_views)
    check_card_vs_cpu(card_seen[0], cpu_seen[0], "predict B=2 uint8")

    # 6. Times: the forwards alone on batches already on the card, then
    # train() on the procedural uint8 stream, resumed, without evaluations.
    model = load_model(cfg, str(logdir), "cuda")
    batches = []
    for batch in make_dataset(d, train=False, seed=seed, num_epochs=1):
        v = batch["views"]
        pad = np.zeros((d.batch_size - len(v),) + v.shape[1:], v.dtype)
        batches.append(torch.from_numpy(np.concatenate([v, pad])).to(dev))

    def forwards():
        for x in batches:
            model(normalize_views(x))

    with torch.no_grad():
        eval_ms = cuda_ms(forwards, runs=10, warmup=2)
        busy_ms = sum(sum(v) for v in kernel_durations_us(
            forwards, calls=3).values()) / 3 / 1e3
    # No evaluation, and no checkpoint inside the last logging window.
    rcfg = cfg.replace(train=dataclasses.replace(
        cfg.train, eval_every=0, checkpoint_every=EVAL_TRAIN_STEPS))
    stem_conv.launches = group_and_fuse.launches = 0
    t0 = time.perf_counter()
    resumed, rmets = train(rcfg, num_steps=2 * EVAL_TRAIN_STEPS,
                           device="cuda")
    rwall = time.perf_counter() - t0
    resume_launches = counts()
    if (resumed.step != 2 * EVAL_TRAIN_STEPS or resume_launches != {
            "stem": EVAL_TRAIN_STEPS, "grouping": EVAL_TRAIN_STEPS}):
        raise AssertionError(f"resume without evaluations: step "
                             f"{resumed.step}, launches {resume_launches}")
    train_vps = EVAL_TRAIN_STEPS * d.batch_size * d.num_views / rwall
    with open(logdir / "metrics.jsonl") as f:
        last = [json.loads(line) for line in f][-1]
    steady_vps = last["shapes_per_sec"] * d.num_views
    in_vps = [views_per_eval / e[2] for e in in_training]
    log(f"eval of {PROC_SHAPES} shapes ({views_per_eval} views): "
        f"{eval_vps:.1f} views/s end to end ({eval_wall:.3f} s, checkpoint "
        f"load included; in training {', '.join(f'{v:.1f}' for v in in_vps)}"
        f"), {views_per_eval / eval_ms * 1e3:.1f} views/s on the device "
        f"({len(batches)} forwards of B={d.batch_size}, {eval_ms:.3f} ms "
        f"by CUDA events; device busy {busy_ms:.3f} ms, idle "
        f"{1 - busy_ms / eval_ms:.1%}); train() on the procedural uint8 "
        f"stream: "
        f"{EVAL_TRAIN_STEPS} resumed steps in {rwall:.2f} s, "
        f"{train_vps:.1f} views/s end to end (start-up included), "
        f"{steady_vps:.1f} views/s over its last {EVAL_EVERY} steps (the "
        f"loop's clock); last {rmets} [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    return dict(eval_launches=eval_launches,
                train_eval_launches=train_eval_launches,
                eval_views_per_s=eval_vps,
                eval_device_views_per_s=views_per_eval / eval_ms * 1e3,
                eval_busy_ms=busy_ms,
                train_views_per_s=train_vps,
                train_steady_views_per_s=steady_vps)


def check_train_drift(drift):
    """Print the card-vs-CPU train step readings (`train_step_drift`) and
    raise unless each is inside its bound."""
    log(f"B=2 train step, card (bf16) vs CPU (fp32): loss {drift['loss']:.6g}"
        f" vs {drift['loss_ref']:.6g} (rel {drift['loss_rel']:.3g}, bound "
        f"{TRAIN_LOSS_REL_TOL}); grad_norm {drift['grad_norm']:.6g} vs "
        f"{drift['grad_norm_ref']:.6g} (rel {drift['grad_norm_rel']:.3g}, "
        f"bound {TRAIN_GNORM_REL_TOL}); Logits gradient cosine "
        f"{drift['logits_grad_cosine']:.5f} (bound {TRAIN_LOGITS_COS_MIN}); "
        f"all gradients' cosine {drift['grad_cosine']:.4f} (held > 0); worst "
        f"layer's gradient-norm |ln ratio| {drift['layer_logratio']:.4f} "
        f"({drift['layer_worst']}, bound {TRAIN_LAYER_LOGRATIO_MAX}); "
        f"least gradient held {drift['layer_min_rel']:.3g} of the norm; left "
        f"out as rounding noise (< {drift['noise_max_rel']:.3g}): "
        f"{drift['noise']}")
    group_cos = drift["group_cosines"]
    log("  gradient cosine by group: " + ", ".join(
        f"{k} {v:.4f}" + (f" (bound {TRAIN_GROUP_COS_MIN[k]})"
                          if k in TRAIN_GROUP_COS_MIN else "")
        for k, v in group_cos.items()))
    if not (drift["loss_rel"] <= TRAIN_LOSS_REL_TOL
            and drift["grad_norm_rel"] <= TRAIN_GNORM_REL_TOL
            and drift["logits_grad_cosine"] >= TRAIN_LOGITS_COS_MIN
            and drift["grad_cosine"] > 0
            and drift["layer_logratio"] <= TRAIN_LAYER_LOGRATIO_MAX
            and all(group_cos[k] >= v
                    for k, v in TRAIN_GROUP_COS_MIN.items())):
        raise AssertionError("card and CPU train steps disagree")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # Fails here, before any output, outside a checkout of the repository.
    import gvcnn_tf_tpu_torch  # noqa: F401

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = phase_card()
    phase_build()
    stem = phase_stem(dev)
    grouping = phase_grouping(dev)
    launches = phase_slice(card)
    stem_bwd = phase_stem_backward(dev)
    grouping_bwd = phase_grouping_backward(dev)
    tr = phase_train(card, dev)
    ev = phase_eval(card, dev)
    kernels = [
        dict(name="stem_conv7x7s2_bf16", route="cuda",
             source="gvcnn_tf_tpu_torch/csrc/stem_conv.cu",
             replaces="gvcnn_tf_tpu/ops/pallas_stem.py:93",
             launches=launches["stem"],
             launches_per_forward=launches["stem"] / FORWARDS,
             train_launches=tr["launches"]["stem"],
             launches_per_step=tr["per_step"]["stem"],
             eval_launches=ev["eval_launches"]["stem"], **stem, **stem_bwd),
        dict(name="group_and_fuse_f32", route="cuda",
             source="gvcnn_tf_tpu_torch/csrc/grouping.cu",
             replaces="gvcnn_tf_tpu/ops/pallas_grouping.py:80",
             launches=launches["grouping"],
             launches_per_forward=launches["grouping"] / FORWARDS,
             train_launches=tr["launches"]["grouping"],
             launches_per_step=tr["per_step"]["grouping"],
             eval_launches=ev["eval_launches"]["grouping"],
             backward_library_ms=None, **grouping, **grouping_bwd),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
