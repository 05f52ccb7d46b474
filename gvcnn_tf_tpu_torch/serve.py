"""Batched HTTP inference server for GVCNN on PyTorch (counterpart of
`gvcnn_tf_tpu/serve.py`).

  GET  /healthz   -> 200 "ok"
  GET  /info      -> JSON model/config metadata
  GET  /stats     -> JSON stats of the engine's recent requests: latency,
                     queue wait and forward (nearest-rank p50/p99 ms),
                     padded rows, each with the count it is taken over
  POST /predict   -> body: .npz with array 'views' shaped (N, V, H, W, 3)
                     (or (V, H, W, 3) for one shape), float in [-1, 1] or
                     raw uint8 in [0, 255]; response: JSON list of
                     {class_index, probability, view_scores}, without
                     view_scores for a model that has none (MVCNN, the
                     single-view classifier)

The model stays resident on the device.  Requests run at the smallest batch
bucket that fits ({1, serve_batch_size} plus --serve_buckets), padded with
zeros; larger requests are chunked.  Device work runs on one thread that the
engine owns: PyTorch keeps cuDNN's execution plans per thread, and
ThreadingHTTPServer starts a thread per request, so running the forward on
the request's thread re-planned every conv (~250 ms per request, measured
on an H100 80GB HBM3 at 700 W, against ~12 ms on a warm thread).
On a card each bucket's forward is a CUDA graph (`utils/graphs.py`, one
a bucket and request dtype, all in one memory pool), warmed up and captured
at start-up, as the JAX engine compiles one executable a bucket: a request
is copied into its bucket's static input and the graph replays.  A weight
loaded in place into `engine.model` changes what the graphs compute (they
pack the stem's weight and fold its BatchNorm at every replay).  On the
CPU the forward runs eagerly.
Each request is a `serve.request` span on its thread (`utils/profiling.py`)
and each of its chunks a `serve.queue` span (from the submit until the
device thread takes it) and a `serve.forward` span (the device thread's
copy in, replay and copy out), both the request's children; `/stats`
reads the engine's own records of them, the last `profiling.RING` of each
name in the process.
Every family and backbone of the configs is served (GVCNN, MVCNN, the
single-view classifier; V = 1 for it).  On the card the backbone and the
scoring FCN run in the config's `compute_dtype`, the Inception-v1 stem and
the grouping head through their CUDA kernels.

Weights: the newest checkpoint under `--checkpoint_dir`
(`checkpoint.load_model`: the model alone, whatever optimizer wrote it),
either one of the port's own or one of the JAX package's Orbax checkpoints
(read with tensorstore, without JAX: `checkpoint.read_orbax`), seeded
random weights (`--seed`), or JAX variables handed over as numpy arrays
through `bridge.py`.

CLI:
    python -m gvcnn_tf_tpu_torch.serve --config mn40_12view --port 8390
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gvcnn_tf_tpu_torch.bridge import jax_to_state_dict
from gvcnn_tf_tpu_torch.checkpoint import load_model
from gvcnn_tf_tpu_torch.configs import GVCNNConfig, add_flags, config_from_flags
from gvcnn_tf_tpu_torch.metrics import log
from gvcnn_tf_tpu_torch.models.gvcnn import build_model, init_weights
from gvcnn_tf_tpu_torch.utils import graphs, profiling
from gvcnn_tf_tpu_torch.utils import (
    fold_batch_norm,
    normalize_views,
    resolve_device,
)

# Tells the engines of one process apart in the span records.
_ENGINES = itertools.count()


def _outputs(model, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    logits, ep = model(normalize_views(x))
    prob, pred = torch.softmax(logits.float(), -1).max(-1)
    return {"logits": logits, "pred": pred, "prob": prob,
            "scores": ep.get("view_discrimination_scores")}


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
        # The `engine` attribute of this engine's request spans.
        self._tag = next(_ENGINES)

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
        # On a card, one CUDA graph a (bucket, request dtype), all in one
        # memory pool; each is warmed up and captured here.
        self._capture = graphs.capturable(self.device)
        self._pool = graphs.new_pool(self.device)
        self.graphs: Dict[Tuple[int, np.dtype], graphs.CapturedCall] = {}
        wire = [np.uint8] + ([] if self._uint8_wire else [np.float32])
        try:
            for nb in self.buckets:    # warm up (and build the kernels)
                for dt in wire:
                    zeros = np.zeros((nb,) + self._input_shape[1:], dt)
                    for _ in range(2 if self._capture else 1):
                        self._forward(zeros)
        except BaseException:
            self.close()
            raise
        log(f"engine ready on {self.device}: {config.name}, buckets "
            f"{self.buckets}, compute {config.compute_dtype}")

    def _forward(self, chunk: np.ndarray, request=None, padded: int = 0
                 ) -> Dict[str, np.ndarray]:
        """One chunk through the model on the device thread -> numpy
        logits, class index, probability and view scores.  Under a
        request's span (`request`, its id; None: set-up, untraced) the
        chunk's wait and forward are its children; `padded` of its rows
        are padding."""
        return self._device_thread.submit(
            self._forward_here, chunk, request, padded,
            profiling.now_ns()).result()

    def _graph(self, chunk: np.ndarray) -> graphs.CapturedCall:
        """The graph of the chunk's (bucket, dtype): its static input is
        written by each request and read by the model's forward.  The
        graph's functions hold the model and the buffer, not the engine or
        the graph, so a dropped graph is freed at once, with no cycle for
        the garbage collector to find first."""
        key = (len(chunk), chunk.dtype)
        g = self.graphs.get(key)
        if g is None:
            model = self.model
            static = torch.empty(chunk.shape, dtype=torch.from_numpy(
                chunk[:0]).dtype, device=self.device)
            g = self.graphs[key] = graphs.CapturedCall(
                f"the {self.config.name} forward at bucket {len(chunk)} "
                f"({chunk.dtype} requests)",
                lambda: _outputs(model, static), {"x": static},
                device=self.device, pool=self._pool,
                watch=lambda: graphs.model_tensors(model))
        return g

    def _forward_here(self, chunk: np.ndarray, request=None,
                      padded: int = 0, submitted: int = 0
                      ) -> Dict[str, np.ndarray]:
        if request is None:
            return self._forward_chunk(chunk)
        profiling.record("serve.queue", submitted, profiling.now_ns(),
                         parent=request, engine=self._tag)
        with profiling.span("serve.forward", parent=request,
                            engine=self._tag, rows=len(chunk),
                            padded=padded):
            return self._forward_chunk(chunk)

    def _forward_chunk(self, chunk: np.ndarray) -> Dict[str, np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(chunk))
        with torch.inference_mode():
            if self._capture:
                out = self._graph(chunk)(x=x)
            else:
                out = _outputs(self.model, x.to(self.device))
            return {k: None if v is None else v.cpu().numpy()
                    for k, v in out.items()}

    def logits_and_scores(self, views: np.ndarray):
        """(N, V, H, W, 3) uint8 or float32 views, N <= the largest bucket
        -> (logits (N, K), scores (N, V) or None) float32 numpy."""
        out = self._forward(views)
        return out["logits"], out["scores"]

    def close(self):
        """Stop the device thread and drop the graphs (and their pool)."""
        self._device_thread.shutdown(wait=True)
        self.graphs.clear()

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
        with profiling.span("serve.request", engine=self._tag,
                            rows=len(views)) as request:
            for start in range(0, len(views), self.batch):
                chunk = views[start:start + self.batch]
                n = len(chunk)
                bucket = next(b for b in self.buckets if b >= n)
                if n < bucket:  # pad to the bucket's batch
                    pad = np.zeros((bucket - n,) + chunk.shape[1:],
                                   chunk.dtype)
                    chunk = np.concatenate([chunk, pad])
                out = self._forward(chunk, request.id, bucket - n)
                for i in range(n):
                    rec = {"class_index": int(out["pred"][i]),
                           "probability": float(out["prob"][i])}
                    if out["scores"] is not None:
                        rec["view_scores"] = out["scores"][i].tolist()
                    results.append(rec)
        return results

    def latency_stats(self) -> dict:
        """Over this engine's last requests (the store's ring of
        `serve.request` records): the requests' count, shapes and
        latency (nearest-rank p50 and p99, mean), their chunks' queue wait
        and forward (p50, p99 and count) and the padding rows' share of the
        rows forwarded (with both counts)."""
        def mine(name):     # [(ms, attrs)] of this engine's records
            return [((end - start) / 1e6, attrs) for
                    _, _, start, end, _, _, _, attrs in profiling.records(name)
                    if attrs["engine"] == self._tag]

        requests = mine("serve.request")
        if not requests:
            return {"count": 0}
        forwards = mine("serve.forward")
        lats = sorted(ms for ms, _ in requests)
        out = {"count": len(lats),
               "shapes": sum(a["rows"] for _, a in requests),
               "p50_ms": round(_nearest_rank(lats, 50), 2),
               "p99_ms": round(_nearest_rank(lats, 99), 2),
               "mean_ms": round(sum(lats) / len(lats), 2),
               "serve_batch_size": self.batch}
        for key, recs in (("queue", mine("serve.queue")),
                          ("forward", forwards)):
            ms = sorted(ms for ms, _ in recs)
            out[f"{key}_count"] = len(ms)
            if ms:
                out[f"{key}_p50_ms"] = round(_nearest_rank(ms, 50), 2)
                out[f"{key}_p99_ms"] = round(_nearest_rank(ms, 99), 2)
        rows = sum(a["rows"] for _, a in forwards)
        padded = sum(a["padded"] for _, a in forwards)
        out.update(forward_rows=rows, padded_rows=padded,
                   padded_share=round(padded / rows, 4) if rows else 0.0)
        return out


def _nearest_rank(values, p):
    """The smallest of the sorted `values` whose cumulative frequency is at
    least p%."""
    return values[min(max(math.ceil(p / 100.0 * len(values)) - 1, 0),
                      len(values) - 1)]


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
                   help="directory of the port's or the JAX package's Orbax "
                        "checkpoints (the newest is "
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
    except (RuntimeError, NotImplementedError, FileNotFoundError,
            ImportError) as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.serve: {e}") from e


if __name__ == "__main__":
    main()
