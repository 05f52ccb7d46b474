"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure raises and the exit code is not 0:

1. The card (nvidia-smi name and power limit), torch and CUDA versions.
2. Build the CUDA kernels from gvcnn_tf_tpu_torch/csrc with nvcc.
3. The stem kernel against its plain PyTorch version, at the serving
   shapes and one H % 4 == 2 shape; kernel and plain times.
4. The grouping-head kernel against its plain version, both weight modes,
   M in {1, 8, 16}, V in {1, 8, 12}, scores on the j/M edges, empty groups;
   kernel and plain times.
5. The slice: the mn40_12view inference server (seeded weights, folded BN,
   full width, 12 views of 224x224, bf16) on an HTTP port; a B=1 uint8, a
   B=8 float and a B=11 request, with the kernels' launch counts over those
   requests; the card's logits and scores for a B=2 request against the
   same weights run in fp32 on the CPU through the plain versions; request
   latency at B=1 and B=8.

TF32 is turned off for the whole run (`torch.backends.cudnn.allow_tf32`,
`torch.backends.cuda.matmul.allow_tf32`), so fp32 comparisons on the card
are full fp32.  Times are CUDA-event medians of 30 runs after 5 warm-up
runs (kernels) or host-clock medians of 20 requests (serving).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a card, or outside a
checkout, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

WARMUP, RUNS, REQUESTS = 5, 30, 20
# (N, H, W, 3): the B=8 and B=1 serving shapes (N = B x 12 views), then
# one with H % 4 == 2.  The first is the one timed.
STEM_SHAPES = [(96, 224, 224, 3), (12, 224, 224, 3), (2, 30, 30, 3)]
STEM_TOL = dict(rtol=1e-2, atol=1e-2)      # bf16 out: one rounding apart
# Slice on the card (bf16 through ~60 conv layers) vs the CPU in fp32.
# Predicted from a bf16-vs-fp32 run on the CPU at 112x112: logits drift
# ~0.6% of max|logit|, scores ~3e-4.  The bounds leave 5x / 15x room.
LOGIT_REL_TOL = 3e-2
SCORE_ABS_TOL = 5e-3


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, runs=RUNS, warmup=WARMUP):
    """Median device time of fn() in ms, CUDA events around each run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip()
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


def phase_stem(dev):
    from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv, stem_conv_plain

    rs = np.random.RandomState(0)
    w = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.1).astype(np.float32))
    w = w.to(dev, torch.bfloat16)
    max_err, timed = 0.0, None
    for shape in STEM_SHAPES:
        x = torch.from_numpy(rs.uniform(-1, 1, shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        with torch.inference_mode():
            got = stem_conv(x, w)
            torch.cuda.synchronize()
            want = stem_conv_plain(x, w)
            torch.testing.assert_close(got.float(), want.float(), **STEM_TOL)
            err = (got.float() - want.float()).abs().max().item()
            ms = cuda_ms(lambda: stem_conv(x, w))
            plain_ms = cuda_ms(lambda: stem_conv_plain(x, w))
        max_err = max(max_err, err)
        log(f"stem {shape}: max|err| {err:.3g}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        timed = timed or (ms, plain_ms)
    return {"max_abs_err": max_err, "ms": timed[0], "plain_ms": timed[1]}


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

    s = torch.from_numpy(_clear_scores(rs, 8, 12, 8)).to(dev)
    d = torch.from_numpy(rs.randn(8, 12, 1024).astype(np.float32)).to(dev)
    with torch.inference_mode():
        ms = cuda_ms(lambda: group_and_fuse(s, d, 8))
        plain_ms = cuda_ms(lambda: group_and_fuse_plain(s, d, 8))
    log(f"grouping (8, 12, 1024, M=8): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


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
        log(f"launches over the B=1, 8, 11 requests: {launches}")
        # 1 + 1 + 2 chunks (11 = 8 + 3 padded to 8), one launch each.
        if launches != {"stem": 4, "grouping": 4}:
            raise AssertionError(f"expected 4 launches of each kernel, got "
                                 f"{launches}")

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
    kernels = [
        dict(name="stem_conv7x7s2_bf16", route="cuda",
             source="gvcnn_tf_tpu_torch/csrc/stem_conv.cu",
             replaces="gvcnn_tf_tpu/ops/pallas_stem.py:93",
             launches=launches["stem"], **stem),
        dict(name="group_and_fuse_f32", route="cuda",
             source="gvcnn_tf_tpu_torch/csrc/grouping.cu",
             replaces="gvcnn_tf_tpu/ops/pallas_grouping.py:80",
             launches=launches["grouping"], **grouping),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
