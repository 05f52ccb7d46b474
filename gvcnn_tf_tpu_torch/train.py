"""Training on PyTorch and CUDA (counterpart of `gvcnn_tf_tpu/train.py`).

The step is plain functions on tensors: `train_step(state, batch, config)`
runs the model in train mode (batch-statistics BatchNorm with its EMA
update, dropout before `Logits`), backpropagates through both hand-written
kernels' autograd Functions, and applies an optimizer with optax's
semantics.  Loss: softmax cross-entropy (optional label smoothing) plus
slim's L2 term, 0.5 * weight_decay * sum(||kernel||^2) over every conv and
`Logits` weight, never a BatchNorm or a bias.  The L2 term's gradient,
weight_decay * w, is added to the kernels' gradients directly instead of
through autograd (the same sum, without ~250 small ops a step).

`train(config)` is the training loop: the synthetic or procedural stream
through a pinned, one-batch-ahead host-to-device prefetcher (uint8 views
are normalized on the device), a JSON metrics line every `log_every`
steps, a checkpoint (`checkpoint.py`) every `checkpoint_every` steps and at
the end, with `eval_every` the validation split scored every that many
steps (`eval.evaluate` on the training model, put back in train mode
after), a final save on SIGTERM, and resume from the latest checkpoint in
`train_logdir`.  A checkpoint also holds the data stream's
generator state, so a resumed run continues the stream where it stopped
(the JAX package restarts the stream from its seed), and the run's config
(`run_identity`): a run refuses to resume from a checkpoint whose config
differs in more than its length, cadence and directory.  Dropout masks
come from a `torch.Generator` on the model's device, reseeded from
(`train.seed`, step, microbatch) every step, so they need no saved state.

CLI (`--train_logdir` is required):
    python -m gvcnn_tf_tpu_torch.train --config mn40_12view \
        --how_many_training_steps 100 --train_logdir runs/mn40
        # on the card (--device cuda)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import signal
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gvcnn_tf_tpu_torch import metrics as metrics_lib
from gvcnn_tf_tpu_torch.checkpoint import Checkpointer
from gvcnn_tf_tpu_torch.configs import (
    GVCNNConfig,
    TrainConfig,
    add_flags,
    config_from_flags,
    resolve_transfer_dtype,
)
from gvcnn_tf_tpu_torch.data import (
    DevicePrefetcher,
    dataset_size,
    make_dataset,
)
from gvcnn_tf_tpu_torch.eval import evaluate
from gvcnn_tf_tpu_torch.models.gvcnn import (
    GVCNN,
    build_model,
    init_weights,
    to_device,
)
from gvcnn_tf_tpu_torch.utils import normalize_views, resolve_device

# ---------------------------------------------------------------------------
# Schedule and optimizer (optax's semantics)
# ---------------------------------------------------------------------------


def make_lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """step -> learning rate: optax's staircase `exponential_decay`, joined
    after a linear warmup from 0 when `warmup_steps` > 0.  The update at
    step t (counted from 0) uses lr(t), as optax reads its count before
    incrementing it."""

    def decay(count: int) -> float:
        if tc.lr_decay_steps <= 0 or count <= 0:
            return tc.learning_rate
        return tc.learning_rate * tc.lr_decay_rate ** math.floor(
            count / tc.lr_decay_steps)

    if tc.warmup_steps <= 0:
        return decay

    def schedule(count: int) -> float:
        if count < tc.warmup_steps:
            return tc.learning_rate * max(count, 0) / tc.warmup_steps
        return decay(count - tc.warmup_steps)

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all elements of all tensors (optax's
    `global_norm`), as a 0-d fp32 tensor on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """`make_optimizer` of the JAX package, on lists of fp32 tensors with
    `torch._foreach_*`:

      momentum  optax.sgd(lr, momentum): trace <- g + m * trace, then
                p <- p + (-lr(t)) * trace (momentum before the rate)
      sgd       p <- p + (-lr(t)) * g
      adam      optax.adam(lr): mu, nu EMAs (b1 0.9, b2 0.999), bias
                correction at t + 1, mu_hat / (sqrt(nu_hat) + 1e-8)
      clip      optax.clip_by_global_norm first, when grad_clip_norm > 0:
                g <- g if ||g|| < c else g / ||g|| * c

    `count` is optax's update count: lr(count) scales the update, and it
    is incremented after it.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Sequence[torch.Tensor], tc: TrainConfig):
        if tc.optimizer not in ("momentum", "sgd", "adam"):
            raise ValueError(f"unknown optimizer {tc.optimizer!r}")
        self.kind = tc.optimizer
        self.params = list(params)
        self.schedule = make_lr_schedule(tc)
        self.momentum = tc.momentum
        self.clip = tc.grad_clip_norm
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa
        self.slots: Dict[str, List[torch.Tensor]] = (
            {"trace": zeros()} if self.kind == "momentum"
            else {"mu": zeros(), "nu": zeros()} if self.kind == "adam"
            else {})

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]):
        grads = list(grads)
        if self.clip > 0:
            norm = global_norm(grads)
            scaled = torch._foreach_div(grads, norm)
            torch._foreach_mul_(scaled, self.clip)
            keep = norm < self.clip
            grads = [torch.where(keep, g, s) for g, s in zip(grads, scaled)]
        lr = self.schedule(self.count)
        if self.kind == "momentum":
            trace = self.slots["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            updates = torch._foreach_mul(trace, -lr)
        elif self.kind == "sgd":
            updates = torch._foreach_mul(grads, -lr)
        else:
            updates = self._adam(grads)
            torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(self.params, updates)
        self.count += 1

    def _adam(self, grads):
        mu, nu = self.slots["mu"], self.slots["nu"]
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, sq)
        t = self.count + 1
        # optax computes the corrections in fp32.
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        updates = torch._foreach_div(mu, bc1)
        torch._foreach_div_(updates, den)
        return updates

    def state_dict(self) -> dict:
        return {"kind": self.kind, "count": self.count,
                "slots": {k: [t.detach().cpu() for t in v]
                          for k, v in self.slots.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        if state["kind"] != self.kind:
            raise ValueError(f"checkpoint optimizer {state['kind']!r}, this "
                             f"run's {self.kind!r}")
        self.count = int(state["count"])
        for k, saved in state["slots"].items():
            for t, s in zip(self.slots[k], saved):
                t.copy_(s)


def kernel_params(named_params) -> List[torch.Tensor]:
    """The parameters slim's regularizer covers: those named `*.weight`
    (conv kernels and `Logits`; the port's BatchNorm has only a bias)."""
    return [p for name, p in named_params if name.endswith("weight")]


def l2_regularization(kernels: Sequence[torch.Tensor],
                      weight_decay: float) -> torch.Tensor:
    """slim's l2_regularizer: 0.5 * wd * sum(||kernel||^2), in fp32.  Its
    gradient, wd * kernel, is added by `train_step` directly."""
    if weight_decay <= 0 or not kernels:
        return torch.zeros((), dtype=torch.float32)
    return 0.5 * weight_decay * global_norm(kernels).square()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy in fp32; with label smoothing, against
    onehot * (1 - ls) + ls / num_classes, as the JAX step does."""
    return F.cross_entropy(logits.float(), labels.long(),
                           label_smoothing=label_smoothing)


# ---------------------------------------------------------------------------
# State and step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """The model (fp32 parameters and BatchNorm statistics, on the device,
    in train mode), its optimizer, the step count and the dropout
    generator."""

    step: int
    model: GVCNN
    optimizer: Optimizer
    generator: torch.Generator
    kernels: List[torch.Tensor]        # the parameters the L2 term covers

    def state_dict(self, data_state=None, config=None) -> dict:
        """Checkpoint payload (CPU tensors): step, model, optimizer, the
        data stream's generator state and the run's `run_identity`."""
        return {"step": self.step,
                "model": {k: v.detach().cpu()
                          for k, v in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(),
                "data": data_state,
                "config": config}

    def load_state_dict(self, payload: dict):
        """Restore from a payload; returns its data stream state."""
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])
        return payload.get("data")


def create_train_state(config: GVCNNConfig, device="cuda") -> TrainState:
    """Seeded model (`init_weights(train.seed)`) on the device in train
    mode (channels-last on a card), its optimizer, step 0."""
    dev = resolve_device(device)
    model = to_device(init_weights(build_model(config), config.train.seed),
                      dev)
    model.train()
    named = list(model.named_parameters())
    return TrainState(
        step=0, model=model,
        optimizer=Optimizer([p for _, p in named], config.train),
        generator=torch.Generator(device=dev),
        kernels=kernel_params(named))


def dropout_seed(seed: int, step: int, micro: int) -> int:
    """The dropout generator's seed for one microbatch of one step."""
    state = np.random.SeedSequence([seed, step, micro]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) | (int(state[1]) >> 1)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               config: GVCNNConfig) -> Dict[str, torch.Tensor]:
    """One optimizer step on `batch` {'views' (B, V, H, W, 3) float or
    uint8, 'label' (B,)}, in place on `state`.  Returns the metrics as
    0-d device tensors: loss (cross-entropy + L2), accuracy, grad_norm (the
    global norm before clipping).

    `accumulate_steps` = k: the batch is cut into k microbatches run one
    after another (BatchNorm statistics chained through them, as the JAX
    step's scan does), and their gradients averaged before one update."""
    tc = config.train
    model, opt = state.model, state.optimizer
    if not model.training:
        model.train()
    views = normalize_views(batch["views"])
    labels = batch["label"]
    k = max(tc.accumulate_steps, 1)
    b = views.shape[0]
    if b % k:
        raise ValueError(f"batch_size {b} not divisible by accumulate_steps "
                         f"{k}")
    for p in opt.params:
        p.grad = None
    use_dropout = config.dropout_keep_prob < 1.0
    losses, accs = [], []
    for i in range(k):
        v, lab = views[i * b // k:(i + 1) * b // k], labels[i * b // k:
                                                              (i + 1) * b // k]
        gen = None
        if use_dropout:
            gen = state.generator
            gen.manual_seed(dropout_seed(tc.seed, state.step, i))
        logits, _ = model(v, generator=gen)
        ce = cross_entropy(logits, lab, tc.label_smoothing)
        ce.backward()
        losses.append(ce.detach())
        accs.append((logits.detach().argmax(-1) == lab).float().mean())
    with torch.no_grad():
        grads = [p.grad for p in opt.params]
        if k > 1:
            torch._foreach_div_(grads, float(k))
        l2 = l2_regularization(state.kernels, tc.weight_decay).to(
            views.device)
        if tc.weight_decay > 0:
            torch._foreach_add_([p.grad for p in state.kernels],
                                state.kernels, alpha=tc.weight_decay)
        grad_norm = global_norm(grads)
        opt.step(grads)
    state.step += 1
    return {"loss": torch.stack(losses).mean() + l2,
            "accuracy": torch.stack(accs).mean(),
            "grad_norm": grad_norm}


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------


def _refuse_unported(config: GVCNNConfig, profile_steps):
    tc = config.train
    if tc.checkpoint_path:
        raise NotImplementedError(
            "--checkpoint_path: warm start from converted ImageNet weights "
            "is not ported yet (ROADMAP §1 item 14, warm start)")
    if config.bn_sync == "local" or (config.num_devices or 1) > 1:
        raise NotImplementedError(
            f"multi-GPU training (num_devices={config.num_devices}, "
            f"bn_sync={config.bn_sync!r}) is not ported yet (ROADMAP §1 "
            "item 10, multi-GPU data parallelism)")
    if profile_steps is not None:
        raise NotImplementedError(
            "profile_steps: the port profiles a train step with "
            "`gvcnn_tf_tpu_torch/tools/measure.py profile --train` (ROADMAP, "
            "'Not ported': tools/profile_step.py)")


# What a resumed run may change: its length, its logging, checkpoint and
# evaluation cadence, its directory and the prefetch depth.
_RESUMABLE = {"train": ("num_steps", "epochs", "steps_per_epoch", "log_every",
                        "checkpoint_every", "eval_every", "train_logdir"),
              "data": ("prefetch_to_device",)}


def run_identity(config: GVCNNConfig) -> Dict[str, object]:
    """The config as {dotted field: JSON value}, without the `_RESUMABLE`
    fields.  A checkpoint stores it, and only a run with the same identity
    resumes from it."""
    d = json.loads(json.dumps(dataclasses.asdict(config)))
    for part, keys in _RESUMABLE.items():
        for k in keys:
            d[part].pop(k)
    return {f"{k}.{kk}" if isinstance(v, dict) else k: vv
            for k, v in d.items()
            for kk, vv in (v.items() if isinstance(v, dict) else [(k, v)])}


def _check_resumable(saved: Optional[Dict[str, object]],
                     config: GVCNNConfig, logdir: str):
    """Raise unless the checkpoint's stored identity is this run's."""
    want = run_identity(config)
    if saved == want:
        return
    saved = saved or {}
    diff = sorted(k for k in set(want) | set(saved)
                  if saved.get(k) != want.get(k))
    raise ValueError(
        f"{logdir} holds the checkpoint of another run (its config differs "
        f"in {', '.join(diff)}); give this run its own --train_logdir")


def train(config: GVCNNConfig, *, num_steps: Optional[int] = None,
          dataset_iter=None, writer: Optional[metrics_lib.MetricWriter] = None,
          profile_steps: Optional[Tuple[int, int]] = None,
          device="cuda") -> Tuple[TrainState, Dict[str, float]]:
    """The training loop (the JAX package's `train` without its TPU and
    multi-host parts).  Returns (final TrainState, last metrics as floats).
    `dataset_iter` injects a host-batch iterator (tests)."""
    _refuse_unported(config, profile_steps)
    dev = resolve_device(device)
    tc = config.train
    num_steps = num_steps if num_steps is not None else tc.num_steps
    steps_per_epoch = tc.steps_per_epoch
    if steps_per_epoch <= 0:
        n = dataset_size(config.data)
        if n:
            steps_per_epoch = max(n // config.data.batch_size, 1)
    if tc.epochs > 0:
        if steps_per_epoch <= 0:
            raise ValueError(
                "epochs-denominated training needs steps_per_epoch (dataset "
                "size unknown); set TrainConfig.steps_per_epoch")
        num_steps = max(int(round(tc.epochs * steps_per_epoch)), 1)
    own_writer = writer is None
    if own_writer:
        writer = metrics_lib.MetricWriter(tc.train_logdir)

    state = create_train_state(config, dev)
    identity = run_identity(config)
    ckpt = Checkpointer(tc.train_logdir) if tc.checkpoint_every > 0 else None
    data_state = None
    if ckpt is not None and ckpt.latest_step() is not None:
        payload = ckpt.restore(map_location="cpu")
        _check_resumable(payload.get("config"), config, tc.train_logdir)
        data_state = state.load_state_dict(payload)
        metrics_lib.log(f"resumed from step {state.step}")
    if dataset_iter is None:
        dataset_iter = make_dataset(config.data, train=True, seed=tc.seed)
        if data_state is not None:
            dataset_iter.load_state_dict(data_state)
    prefetch = DevicePrefetcher(dataset_iter, dev,
                                resolve_transfer_dtype(config),
                                depth=config.data.prefetch_to_device)

    # SIGTERM (preemption) sets a flag: the loop finishes the step in
    # flight, saves and returns; the next launch resumes.  SIGINT keeps
    # KeyboardInterrupt.  Installed from the main thread only.
    preempted = threading.Event()
    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _on_term(signum, frame):
            preempted.set()
            metrics_lib.log(f"signal {signum} received: checkpoint-and-exit "
                            "after the current step")

        prev_handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM,
                                                      _on_term)

    schedule = make_lr_schedule(tc)
    timer = metrics_lib.StepTimer()
    mets: Dict[str, torch.Tensor] = {}
    start = state.step
    try:
        for step in range(start, num_steps):
            if preempted.is_set():
                metrics_lib.log(f"stopping at step {state.step} for "
                                "preemption; the next run resumes from the "
                                "saved checkpoint")
                break
            batch = next(prefetch, None)
            if batch is None:
                metrics_lib.log("dataset exhausted")
                break
            if step == start:
                lo, hi = (int(v) for v in torch.stack(
                    [batch["label"].min(), batch["label"].max()]).cpu())
                if lo < 0 or hi >= config.data.num_classes:
                    raise ValueError(
                        f"labels [{lo}, {hi}] out of range for num_classes="
                        f"{config.data.num_classes}")
            mets = train_step(state, batch, config)
            timer.tick()
            if (step + 1) % tc.log_every == 0 or step + 1 == num_steps:
                vals = {k: float(v) for k, v in mets.items()}
                vals["steps_per_sec"] = timer.rate()
                vals["shapes_per_sec"] = (timer.rate()
                                          * config.data.batch_size)
                vals["lr"] = schedule(step)
                if steps_per_epoch > 0:
                    vals["epoch"] = round((step + 1) / steps_per_epoch, 3)
                if dev.type == "cuda":
                    vals["mem_used_mb"] = round(
                        torch.cuda.memory_allocated(dev) / 1e6, 1)
                writer.scalars(step + 1, vals)
                timer.reset()
            if ckpt is not None and (step + 1) % tc.checkpoint_every == 0:
                ckpt.save(step + 1, state.state_dict(prefetch.data_state,
                                                     identity))
            if tc.eval_every > 0 and (step + 1) % tc.eval_every == 0:
                res = evaluate(config, state=state)
                writer.scalars(step + 1, {"val_accuracy": res["accuracy"],
                                          "val_count": res["count"]})
                metrics_lib.log(
                    f"step {step + 1} val accuracy {res['accuracy']:.4f} "
                    f"({res['correct']}/{res['count']})")
                timer.reset()       # the eval's time is not a step's
        if ckpt is not None and ckpt.latest_step() != state.step:
            ckpt.save(state.step, state.state_dict(prefetch.data_state,
                                                   identity))
        writer.flush()
        return state, {k: float(v) for k, v in mets.items()}
    finally:
        prefetch.close()
        for sig, prev in prev_handlers.items():
            signal.signal(sig, prev)
        if own_writer:
            writer.close()


def main(argv=None):
    p = argparse.ArgumentParser(description="gvcnn_tf_tpu_torch trainer "
                                            "(PyTorch + CUDA)")
    add_flags(p)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises when no card "
                        "is present, it never falls back to the CPU")
    args = p.parse_args(argv)
    if args.train_logdir is None:
        p.error("--train_logdir is required: a run resumes from the newest "
                "checkpoint in it, so each run names its own directory")
    config = config_from_flags(args)
    metrics_lib.log(f"training config {config.name}: {config}")
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.train: {e}") from e
    try:
        train(config, device=args.device)
    except NotImplementedError as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.train: {e}") from e


if __name__ == "__main__":
    main()
