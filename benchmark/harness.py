"""Runs one cell of `BENCHMARK.json` once and builds its result line.

Everything a cell needs is found by name: the cell's entry in
`BENCHMARK.json` names a configuration (`benchmark/configs/<config>.json`)
and a traffic mix (`benchmark/traffic/<mix>.json`), whose `kind` names the
driver that runs it (`benchmark/traffic/<kind>.py`); the limits of its
output check are `benchmark/limits/<cell>.json`; each per-layer metric is
read by `benchmark/metrics/<metric>.py`; the plain reference of the
configuration's backbone is `benchmark/reference/<backbone>.py`, whose
interface `benchmark/reference/__init__.py` states (a conv declares with
`ConvShape.bn` whether a BatchNorm follows it, `Net.conv_bn`, or it has a
bias and no BatchNorm, `Net.conv_bias`).  Adding a configuration
(with a backbone the reference lacks: its reference module too), a mix of
an existing kind, a cell or a per-layer metric adds files and edits none.

A driver's `run(ctx)` builds the program from the seed, warms up every
shape the cell uses (set-up ends with `ctx.setup_done()`), measures for
`ctx.seconds`, checks what the timed path produced against the plain
reference, and returns an outcome: {"e2e": {metric: value}, "attempted",
"failed", "checks": {name: value}, "records": what the per-layer readers
read, "memory_peak_bytes", "profile": `ProfiledWindow.read()` or None}.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from benchmark.tracing import Spans

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# Top-level module names that no process of the benchmark may hold.
BANNED = frozenset({"jax", "jaxlib", "flax", "optax", "orbax",
                    "gvcnn_tf_tpu"})


class Refused(RuntimeError):
    """The run cannot be made here (no card, a missing file, a banned
    module); it prints no result."""


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise Refused(f"no {what} named {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, section: str, cell: str):
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """The per-layer reader `benchmark/metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        raise Refused(f"no reader {path} for the per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What a traffic driver reads: the cell, its configuration and mix
    files, the run's arguments, the device and the benchmark's spans.
    `shrink` (tests on the CPU only) overrides sizes of the model section
    and of the mix."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    shrink: Optional[dict] = None
    spans: Spans = dataclasses.field(default_factory=Spans)
    setup_s: Optional[float] = None

    def __post_init__(self):
        shrink = self.shrink or {}
        self.model = {**self.config["model"], **shrink.get("model", {})}
        self.mix = {**self.traffic, **shrink.get("traffic", {})}

    def setup_done(self):
        """Set-up ends here: the weights, inputs and program are made and
        every shape the cell uses has run."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_s = time.perf_counter() - self.t_start

    def port_config(self, batch_size: Optional[int] = None,
                    transfer_dtype: Optional[str] = None):
        """The program's named configuration with the file's and the
        model section's sizes, checked against the file."""
        from gvcnn_tf_tpu_torch import get_config

        base = get_config(self.config["port_config"])
        m = self.model
        data = dataclasses.replace(
            base.data, num_views=m["num_views"], height=m["height"],
            width=m["width"], num_classes=m["num_classes"],
            batch_size=batch_size or base.data.batch_size,
            transfer_dtype=transfer_dtype or base.data.transfer_dtype)
        opt = self.config["optimizer"]
        train = dataclasses.replace(base.train, seed=self.train_seed)
        cfg = base.replace(data=data, train=train,
                           compute_dtype=m["compute_dtype"])
        want = {"backbone": m["backbone"], "model": m["family"],
                "num_group": m["num_group"],
                "raw_endpoint": m["raw_endpoint"],
                "final_endpoint": m["final_endpoint"],
                "dropout_keep_prob": m["dropout_keep_prob"],
                "score_squash": "softmax", "group_weight": "mean",
                "multi_view": True}
        have = {k: getattr(cfg, k) for k in want}
        want |= {f"train.{k}": v for k, v in opt.items()}
        have |= {f"train.{k}": getattr(cfg.train, k) for k in opt}
        if have != want:
            diff = {k: (have[k], want[k]) for k in want
                    if have[k] != want[k]}
            raise Refused(f"{self.config['port_config']} differs from its "
                          f"configuration file: {diff}")
        return cfg

    @property
    def train_seed(self) -> int:
        from benchmark.inputs import seed_of

        return seed_of(self.seed, "train") % (2 ** 62)


def check_card(chips: int):
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false: the benchmark "
                      "runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} card(s), "
                      f"{torch.cuda.device_count()} visible")


def _value(v: float) -> float:
    if not math.isfinite(v):
        raise ValueError(f"metric value {v}")
    return v


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            t_start: float, device: str = "cuda", shrink=None,
            root: Path = ROOT):
    """One run of `workload`: (the result line as a dict, the numbers
    compared as {name: (value, limit)}, every number the driver worked
    out).  `device` other than "cuda" and `shrink` are
    for the tests on the CPU."""
    bench = load_json(root / "BENCHMARK.json")
    cell = _named(bench["workloads"], workload, "workload")
    dev = torch.device(device)
    if dev.type == "cuda":
        check_card(cell["chips"])
        dev = torch.device("cuda", 0)
    try:
        config = load_json(HERE / "configs" / f"{cell['config']}.json")
        traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
        limits = load_json(HERE / "limits" / f"{workload}.json")
    except FileNotFoundError as e:
        raise Refused(f"{workload}: {e}") from e
    driver = importlib.import_module(f"benchmark.traffic.{traffic['kind']}")
    ctx = Context(cell=cell, config=config, traffic=traffic, seed=seed,
                  seconds=seconds, trace=trace, device=dev,
                  t_start=t_start, shrink=shrink)
    out = driver.run(ctx)
    if ctx.setup_s is None:
        raise RuntimeError(f"{traffic['kind']} never ended its set-up")

    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    metrics: Dict[str, dict] = {}
    if not trace:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in metrics_of(bench, "end_to_end", workload):
            metrics[m["name"]] = {"value": _value(values[m["name"]]),
                                  "unit": units[m["name"]]}
    else:
        records = dict(out["records"], profile=out.get("profile"),
                       peaks=_peaks(dev))
        for m in metrics_of(bench, "per_layer", workload):
            v = reader(m["name"]).read(records)
            if v is not None:
                metrics[m["name"]] = {"value": _value(v),
                                      "unit": units[m["name"]]}

    missing = sorted(set(limits) - set(out["checks"]))
    if missing:
        raise RuntimeError(f"{workload}: no reading for the limits "
                           f"{missing}")
    checks = {k: (float(out["checks"][k]), float(limits[k]["limit"]))
              for k in sorted(limits)}
    correct = (out["failed"] == 0
               and all(v <= lim for v, lim in checks.values()))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info}
    prof = out.get("profile")
    if trace and prof is not None:
        device_info["busy_s"] = prof["busy_s"]
        device_info["window_s"] = prof["window_s"]
        top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][1])
        result["breakdown"] = {
            "device_ops": [[n, s] for n, (_, s) in top[:10]],
            "idle_gaps": prof["gaps"][:10]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks, out["checks"]


def _peaks(dev):
    from benchmark.peaks import PEAKS

    if dev.type != "cuda":
        return None
    return PEAKS.get(torch.cuda.get_device_name(dev))
