"""Batched HTTP inference server for GVCNN on PyTorch (counterpart of
`gvcnn_tf_tpu/serve.py`).

  GET  /healthz   -> 200 "ok"
  GET  /info      -> JSON model/config metadata
  GET  /stats     -> JSON request latency stats (nearest-rank p50/p99 ms)
  POST /predict   -> body: .npz with array 'views' shaped (N, V, H, W, 3)
                     (or (V, H, W, 3) for one shape), float in [-1, 1] or
                     raw uint8 in [0, 255]; response: JSON list of
                     {class_index, probability, view_scores}

The model stays resident on the device.  Requests run at the smallest batch
bucket that fits ({1, serve_batch_size} plus --serve_buckets), padded with
zeros; larger requests are chunked.  Device work runs on one thread that the
engine owns: PyTorch keeps cuDNN's execution plans per thread, and
ThreadingHTTPServer starts a thread per request, so running the forward on
the request's thread re-planned every conv (~250 ms per request, measured
on an H100 80GB HBM3 at 700 W, against ~12 ms on a warm thread).
On the card the backbone and the scoring FCN run in bf16 (config
`compute_dtype`), the stem and the grouping head through their CUDA kernels.

Weights: the newest of the port's own checkpoints under `--checkpoint_dir`
(`checkpoint.load_model`: the model alone, whatever optimizer wrote it),
seeded random weights (`--seed`), or JAX variables handed over as numpy
arrays through `bridge.py`.  The JAX package's Orbax checkpoints need JAX
to read: a directory of them is refused until the port has its Orbax
reader.

CLI:
    python -m gvcnn_tf_tpu_torch.serve --config mn40_12view --port 8390
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from gvcnn_tf_tpu_torch.bridge import jax_to_state_dict
from gvcnn_tf_tpu_torch.checkpoint import load_model
from gvcnn_tf_tpu_torch.configs import GVCNNConfig, add_flags, config_from_flags
from gvcnn_tf_tpu_torch.metrics import log
from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
from gvcnn_tf_tpu_torch.utils import (
    fold_batch_norm,
    normalize_views,
    resolve_device,
)


class InferenceEngine:
    """Resident model, fixed batch buckets, pad-and-mask semantics."""

    def __init__(
        self,
        config: GVCNNConfig,
        checkpoint_dir: Optional[str] = None,
        *,
        variables: Optional[Dict[str, Any]] = None,
        serve_batch_size: int = 8,
        fold_bn: bool = True,
        buckets: Optional[Sequence[int]] = None,
        device="cuda",
    ):
        if checkpoint_dir and variables is not None:
            raise ValueError("give checkpoint_dir or variables, not both")
        self.device = resolve_device(device)
        self.config = config
        if checkpoint_dir:                # folded on the CPU, in fp32
            model = load_model(config, checkpoint_dir, "cpu", fold_bn)
        else:
            model = build_model(config)
            if variables is not None:
                model.load_state_dict(jax_to_state_dict(variables))
            else:
                init_weights(model, config.train.seed)
            if fold_bn:
                fold_batch_norm(model)    # exact transform, in fp32
        model.cast_convs_()
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).eval()
        # The one thread that runs forwards (see the module docstring); it
        # also serializes device work.
        self._device_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="gvcnn-device")
        # Rolling per-request latency (seconds, shapes) for /stats, under
        # its own lock so a /stats poll never waits on an inference.
        self._latencies = collections.deque(maxlen=1024)
        self._stats_lock = threading.Lock()

        d = config.data
        self._input_shape = (serve_batch_size, d.num_views, d.height,
                             d.width, 3)
        # transfer_dtype "uint8" re-quantizes float requests to uint8;
        # otherwise float requests go to the device as float32.  uint8
        # requests always go as uint8 and are normalized on the device
        # (utils/images.py, the same float32 op sequence as the host's).
        self._uint8_wire = d.transfer_dtype == "uint8"
        self.buckets = sorted({int(b) for b in (buckets or [])}
                              | {1, serve_batch_size})
        if any(b < 1 for b in self.buckets):
            raise ValueError(f"buckets must be >= 1: {self.buckets}")
        self.batch = self.buckets[-1]  # chunk stride = largest bucket
        try:
            for nb in self.buckets:    # warm up (and build the kernels)
                self._forward(np.zeros((nb,) + self._input_shape[1:],
                                       np.uint8))
        except BaseException:
            self.close()
            raise
        log(f"engine ready on {self.device}: {config.name}, buckets "
            f"{self.buckets}, compute {config.compute_dtype}")

    def _forward(self, chunk: np.ndarray) -> Dict[str, np.ndarray]:
        """One chunk through the model on the device thread -> numpy
        logits, class index, probability and view scores."""
        return self._device_thread.submit(self._forward_here, chunk).result()

    def _forward_here(self, chunk: np.ndarray) -> Dict[str, np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        with torch.inference_mode():
            logits, ep = self.model(normalize_views(x))
            prob, pred = torch.softmax(logits.float(), -1).max(-1)
            out = {"logits": logits, "pred": pred, "prob": prob,
                   "scores": ep["view_discrimination_scores"]}
            return {k: v.cpu().numpy() for k, v in out.items()}

    def logits_and_scores(self, views: np.ndarray):
        """(N, V, H, W, 3) uint8 or float32 views, N <= the largest bucket
        -> (logits (N, K), scores (N, V)) float32 numpy."""
        out = self._forward(views)
        return out["logits"], out["scores"]

    def close(self):
        """Stop the device thread."""
        self._device_thread.shutdown(wait=True)

    def predict(self, views: np.ndarray):
        """views (N, V, H, W, 3) -> list of result dicts (chunked/padded).

        Accepts normalized float views in [-1, 1] or raw uint8 views in
        [0, 255].  uint8 views are normalized on the device; a float
        request to a uint8-wire engine is re-quantized (<= 1/255 rounding).
        """
        if views.ndim == 4:
            views = views[None]
        if views.shape[1:] != self._input_shape[1:]:
            raise ValueError(
                f"expected views shaped (N,) + {self._input_shape[1:]}, got "
                f"{views.shape}")
        if views.dtype != np.uint8:
            views = np.asarray(views, np.float32)
            if self._uint8_wire:
                views = np.clip((views + 1.0) * 127.5 + 0.5, 0.0,
                                255.0).astype(np.uint8)
        results = []
        t_start = time.perf_counter()
        for start in range(0, len(views), self.batch):
            chunk = views[start:start + self.batch]
            n = len(chunk)
            bucket = next(b for b in self.buckets if b >= n)
            if n < bucket:  # pad to the bucket's batch
                pad = np.zeros((bucket - n,) + chunk.shape[1:], chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            out = self._forward(chunk)
            for i in range(n):
                results.append({
                    "class_index": int(out["pred"][i]),
                    "probability": float(out["prob"][i]),
                    "view_scores": out["scores"][i].tolist(),
                })
        dt = time.perf_counter() - t_start
        with self._stats_lock:
            self._latencies.append((dt, len(views)))
        log(f"/predict shapes={len(views)} latency_ms={dt * 1e3:.2f}")
        return results

    def latency_stats(self) -> dict:
        """p50/p99 request latency over the last <=1024 requests."""
        with self._stats_lock:
            snapshot = list(self._latencies)
        lats = sorted(d for d, _ in snapshot)
        if not lats:
            return {"count": 0}
        shapes = sum(n for _, n in snapshot)

        def pct(p):
            # Nearest rank: smallest value with cumulative frequency >= p%.
            return lats[min(max(math.ceil(p / 100.0 * len(lats)) - 1, 0),
                            len(lats) - 1)]

        return {
            "count": len(lats),
            "shapes": shapes,
            "p50_ms": round(pct(50) * 1e3, 2),
            "p99_ms": round(pct(99) * 1e3, 2),
            "mean_ms": round(sum(lats) / len(lats) * 1e3, 2),
            "serve_batch_size": self.batch,
        }


def make_handler(engine: InferenceEngine):
    class Handler(BaseHTTPRequestHandler):
        # Headers and body go out in two writes; with Nagle's algorithm on,
        # the second waits for the client's delayed ACK.
        disable_nagle_algorithm = True

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            data = body if isinstance(body, bytes) else body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, "ok", "text/plain")
            elif self.path == "/info":
                d = engine.config.data
                self._send(200, json.dumps({
                    "model": engine.config.model,
                    "backbone": engine.config.backbone,
                    "num_classes": d.num_classes,
                    "num_views": d.num_views,
                    "input": [d.num_views, d.height, d.width, 3],
                    "serve_batch_size": engine.batch,
                    "device": str(engine.device),
                }))
            elif self.path == "/stats":
                self._send(200, json.dumps(engine.latency_stats()))
            else:
                self._send(404, json.dumps({"error": "not found"}))

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, json.dumps({"error": "not found"}))
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = self.rfile.read(length)
                with np.load(io.BytesIO(payload)) as z:
                    views = np.asarray(z["views"])
                # Keep raw uint8 payloads; anything else becomes float32.
                if views.dtype != np.uint8:
                    views = views.astype(np.float32)
                results = engine.predict(views)
                self._send(200, json.dumps(results))
            except KeyError:
                self._send(400, json.dumps(
                    {"error": "npz must contain an array named 'views'"}))
            except ValueError as e:
                self._send(400, json.dumps({"error": str(e)}))
            except Exception as e:  # malformed payloads etc.
                self._send(400, json.dumps(
                    {"error": f"bad request: {type(e).__name__}: {e}"}))

    return Handler


def serve(config, checkpoint_dir=None, *, variables=None, port=8390,
          serve_batch_size=8, block=True, fold_bn=True, buckets=None,
          device="cuda"):
    """Start the server; returns (httpd, thread, engine) when block=False."""
    engine = InferenceEngine(config, checkpoint_dir, variables=variables,
                             serve_batch_size=serve_batch_size,
                             fold_bn=fold_bn, buckets=buckets, device=device)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(engine))
    log(f"serving on :{httpd.server_address[1]}")
    if block:
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
            engine.close()
        return None
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t, engine


def main(argv=None):
    p = argparse.ArgumentParser(description="gvcnn_tf_tpu_torch inference "
                                            "server (PyTorch + CUDA)")
    add_flags(p)
    p.add_argument("--checkpoint_dir", default=None,
                   help="directory of the port's checkpoints (the newest is "
                        "served); default: seeded weights")
    p.add_argument("--port", type=int, default=8390)
    p.add_argument("--serve_batch_size", type=int, default=8)
    p.add_argument("--serve_buckets", default=None,
                   help="comma-separated batch buckets; a request runs at "
                        "the smallest bucket that fits "
                        "(default: 1,<serve_batch_size>)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises when no card "
                        "is present, it never falls back to the CPU")
    args = p.parse_args(argv)
    config = config_from_flags(args)
    try:
        serve(
            config,
            checkpoint_dir=args.checkpoint_dir,
            port=args.port,
            serve_batch_size=args.serve_batch_size,
            buckets=([int(x) for x in args.serve_buckets.split(",") if x]
                     if args.serve_buckets else None),
            device=args.device,
        )
    except (RuntimeError, NotImplementedError, FileNotFoundError) as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.serve: {e}") from e


if __name__ == "__main__":
    main()
