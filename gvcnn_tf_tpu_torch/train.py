"""Training on PyTorch and CUDA (counterpart of `gvcnn_tf_tpu/train.py`).

The step is plain functions on tensors: `train_step(state, batch, config)`
runs the model in train mode (batch-statistics BatchNorm with its EMA
update, dropout before `Logits`), backpropagates through the hand-written
kernels' ops and their registered gradients, and applies an optimizer with
optax's semantics.  Loss: softmax cross-entropy (optional label smoothing)
plus slim's L2 term, 0.5 * weight_decay * sum(||kernel||^2) over every conv
and `Logits` weight, never a BatchNorm scale or a bias.  The L2 term's
gradient, weight_decay * w, is added to the kernels' gradients directly
instead of through autograd (the same sum, without ~250 small ops a step).

`train(config)` is the training loop: an optional warm start from
`checkpoint_path` (`checkpoint.warm_start_model`: an Orbax directory of the
JAX package, one of the port's training runs, or the slim importer's
output, without `checkpoint_exclude_scopes`), then the config's loader
(the synthetic or procedural stream, or a rendered tree through the native,
decoded or TFRecord loader, `data/pipeline.py`) through a pinned,
one-batch-ahead host-to-device prefetcher (uint8 views are normalized on
the device; the decoded loader's flip runs on the card; the procedural
train split may instead be staged on the card once and gathered in the
step, `device_resident`), an optional profiled window of steps
(`profile_steps`, a Chrome trace in `train_logdir`), a JSON metrics line
every `log_every` steps, a checkpoint (`checkpoint.py`) every
`checkpoint_every` steps and at the end, with `eval_every` the validation
split scored every that many steps (`eval.evaluate` on the training model,
put back in train mode after), a final save on SIGTERM, and resume from the
latest checkpoint in `train_logdir`.  A checkpoint also holds the data
stream's generator state, so a resumed run continues the stream where it
stopped (the JAX package restarts the stream from its seed; so do the
port's file loaders), and the run's
config (`run_identity`): a run refuses to resume from a checkpoint whose
config differs in more than its length, cadence and directory.  Dropout
masks come from a `torch.Generator` a microbatch on the model's device,
reseeded from (`train.seed`, step, microbatch) every step, so they need no
saved state.

The compiled step (the JAX package's `jax.jit(..., donate_argnums=0)`
step, compiled ahead of time for the batch's shape): on a card with one
rank, `train` runs `compile_train_step`, the step's device work captured
once as a CUDA graph (`utils/graphs.py`) and replayed every step after an
eager warm-up; the host reseeds the generators and writes the optimizer's
scalars before each replay.  On the CPU, and over several data-parallel
ranks, it runs `train_step` eagerly.  `train_step` stays the eager step
the analysis tools call: they attribute single ops, which a replay hides.

Data parallelism (the JAX package's `data` mesh and `bn_sync`, as one
process per card, `parallel/`): every rank holds a replica, trains on its
shard of the split and joins one all-reduce a step (`train_step`); rank 0
writes the metrics and checkpoints.  `--num_devices k` without a launcher
spawns k ranks on this host; under torchrun each process joins its world.

CLI (`--train_logdir` is required):
    python -m gvcnn_tf_tpu_torch.train --config mn40_12view \
        --how_many_training_steps 100 --train_logdir runs/mn40
        # on the card (--device cuda)
    python -m gvcnn_tf_tpu_torch.train --config mn40_12view \
        --checkpoint_path ckpts/imagenet_v1 --train_logdir runs/mn40_ft
        # warm start; --checkpoint_exclude_scopes Logits,GroupingModule
    python -m gvcnn_tf_tpu_torch.train --config mn40_12view_dp8 \
        --train_logdir runs/dp8      # 8 ranks, one per card (or torchrun)
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import signal
import sys
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from gvcnn_tf_tpu_torch import metrics as metrics_lib
from gvcnn_tf_tpu_torch.checkpoint import Checkpointer, warm_start_model
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
    ViewModel,
    build_model,
    init_weights,
    to_device,
)
from gvcnn_tf_tpu_torch.parallel import (
    World,
    check_num_devices,
    initialize_distributed,
    launch_env,
    shutdown,
    spawn,
)
from gvcnn_tf_tpu_torch.parallel import collectives
from gvcnn_tf_tpu_torch.models.backbones.layers import BatchNorm
from gvcnn_tf_tpu_torch.utils import graphs, profiling
from gvcnn_tf_tpu_torch.utils import (
    device_flip,
    normalize_views,
    profile_trace,
    resolve_device,
)

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

    `step(grads)` is three parts, which a CUDA graph of the train step
    takes apart (`compile_train_step`): `prepare()` writes the step's
    scalars, -lr(count) and Adam's fp32 bias corrections, into 0-d fp32
    tensors on the parameters' device (one `fill_` each); `apply(grads)`
    is the update on the device, which reads them there; `advance()`
    counts.  The update keeps the bits of the same update by Python
    floats: `_foreach_mul` by a 0-d fp32 tensor rounds the factor to fp32
    as by a scalar, and `_foreach_div` by a Python float divides on the CPU
    but multiplies by the divisor's fp32 reciprocal on a card (where a
    division by a 0-d tensor is IEEE's), so on a card the corrections are
    stored as their reciprocals and multiply.
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
        dev = self.params[0].device if self.params else None
        # -lr(count), then Adam's bias corrections 1 - b1^t, 1 - b2^t (on a
        # card their reciprocals).
        self.neg_lr, self.bc1, self.bc2 = (
            torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(3))
        self._reciprocal = dev is not None and dev.type == "cuda"

    def step(self, grads: Sequence[torch.Tensor]):
        self.prepare()
        self.apply(grads)
        self.advance()

    @torch.no_grad()
    def prepare(self):
        """Write this update's scalars (see the class docstring)."""
        self.neg_lr.fill_(-self.schedule(self.count))
        if self.kind == "adam":
            t = np.float32(self.count + 1)
            # optax computes the corrections in fp32.
            for out, b in ((self.bc1, self.B1), (self.bc2, self.B2)):
                bc = np.float32(1.0) - np.float32(b) ** t
                out.fill_(float(np.float32(1.0) / bc if self._reciprocal
                                else bc))

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor]):
        """The update, on the device, with the scalars `prepare` wrote."""
        grads = list(grads)
        if self.clip > 0:
            norm = global_norm(grads)
            scaled = torch._foreach_div(grads, norm)
            torch._foreach_mul_(scaled, self.clip)
            keep = norm < self.clip
            grads = [torch.where(keep, g, s) for g, s in zip(grads, scaled)]
        if self.kind == "momentum":
            trace = self.slots["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            updates = torch._foreach_mul(trace, self.neg_lr)
        elif self.kind == "sgd":
            updates = torch._foreach_mul(grads, self.neg_lr)
        else:
            updates = self._adam(grads)
            torch._foreach_mul_(updates, self.neg_lr)
        torch._foreach_add_(self.params, updates)

    def advance(self):
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
        div = torch._foreach_mul if self._reciprocal else torch._foreach_div
        den = div(nu, self.bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        updates = div(mu, self.bc1)
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
    (conv kernels, Inception-v2's depthwise and pointwise kernels too, and
    `Logits`), never a BatchNorm's `scale` or `bias`, as the JAX package's
    L2 covers the leaves named `kernel`."""
    return [p for name, p in named_params if name.endswith("weight")]


def l2_regularization(kernels: Sequence[torch.Tensor],
                      weight_decay: float, device=None) -> torch.Tensor:
    """slim's l2_regularizer: 0.5 * wd * sum(||kernel||^2), in fp32, on the
    kernels' device (with none, on `device`).  Its gradient, wd * kernel,
    is added by `train_step` directly."""
    if weight_decay <= 0 or not kernels:
        return torch.zeros((), dtype=torch.float32, device=(
            kernels[0].device if kernels else device))
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
    in train mode), its optimizer, the step count, the generators the step
    draws from (`generators[i]`: microbatch i's dropout mask;
    `flip_generator`: the on-card flip's mask) and the data-parallel world
    this replica belongs to."""

    step: int
    model: ViewModel
    optimizer: Optimizer
    generators: List[torch.Generator]
    flip_generator: torch.Generator
    kernels: List[torch.Tensor]        # the parameters the L2 term covers
    world: World = World()

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


def create_train_state(config: GVCNNConfig, device="cuda",
                       world: Optional[World] = None) -> TrainState:
    """Seeded model (`init_weights(train.seed)`) on the device in train
    mode (channels-last on a card), its optimizer, step 0.  With a `world`
    its device is the world's, every rank's replica starts from the same
    seed, and with more than one rank and `bn_sync="global"` every
    BatchNorm takes its statistics over all ranks."""
    world = world or World(device=resolve_device(device))
    dev = world.device
    with profiling.span("train.create_state"):
        model = to_device(init_weights(build_model(config),
                                       config.train.seed), dev)
        model.train()
        if world.size > 1 and config.bn_sync == "global":
            model.sync_batch_norm_(world.group)
        named = list(model.named_parameters())
        return TrainState(
            step=0, model=model,
            optimizer=Optimizer([p for _, p in named], config.train),
            generators=[torch.Generator(device=dev) for _ in
                        range(max(config.train.accumulate_steps, 1))],
            flip_generator=torch.Generator(device=dev),
            kernels=kernel_params(named), world=world)


def bn_statistics(model: ViewModel) -> List[torch.Tensor]:
    """Every BatchNorm's running mean and variance."""
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def dropout_seed(seed: int, step: int, micro: int,
                 rank: Optional[int] = None) -> int:
    """The dropout generator's seed for one microbatch of one step (and,
    with `bn_sync="local"` over several ranks, of one rank: the JAX step
    folds the device's index into its key there)."""
    entropy = [seed, step, micro] + ([] if rank is None else [rank])
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(state[0]) << 31) | (int(state[1]) >> 1)


def _local_bn(config: GVCNNConfig, world: World) -> bool:
    return config.bn_sync == "local" and world.size > 1


def _seed_flip(state: TrainState, config: GVCNNConfig):
    """The flip generator reseeded from (`train.seed`, step, "FLP")."""
    world = state.world
    entropy = [config.train.seed, state.step, 0x464C50] + (
        [world.rank] if _local_bn(config, world) else [])
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    state.flip_generator.manual_seed(
        (int(words[0]) << 31) | (int(words[1]) >> 1))


def _draw_flip(state: TrainState, config: GVCNNConfig,
               shape: Tuple[int, int]) -> torch.Tensor:
    world = state.world
    local_bn = _local_bn(config, world)
    b, v = shape
    ranks = world.size if world.size > 1 and not local_bn else 1
    gen = state.flip_generator
    mask = torch.rand((ranks * b, v), generator=gen, device=gen.device) < 0.5
    return mask[world.rank * b:(world.rank + 1) * b] if ranks > 1 else mask


def flip_mask(state: TrainState, config: GVCNNConfig,
              shape: Tuple[int, int]) -> torch.Tensor:
    """The on-card flip's Bernoulli(0.5) mask of one step, (B, V) bool on
    the model's device, drawn from the flip generator reseeded from
    (`train.seed`, step, "FLP").  Over several ranks it is cut from one
    mask of the global batch, or with `bn_sync="local"` drawn per rank, as
    the dropout masks are."""
    _seed_flip(state, config)
    return _draw_flip(state, config, shape)


def _microbatch_generators(state: TrainState, k: int):
    """Give `state` a dropout generator for each of k microbatches."""
    while len(state.generators) < k:
        state.generators.append(torch.Generator(
            device=state.flip_generator.device))


def seed_step(state: TrainState, config: GVCNNConfig):
    """The host's part of a step, before its device work: every
    microbatch's dropout generator reseeded from (`train.seed`, step,
    microbatch), the flip's from (`train.seed`, step, "FLP"), and the
    optimizer's scalars for this update written (`Optimizer.prepare`).
    Each microbatch has a generator of its own, so a CUDA graph of the
    step, which reads each registered generator's seed once a replay,
    draws what the eager step draws."""
    tc, world = config.train, state.world
    k = max(tc.accumulate_steps, 1)
    _microbatch_generators(state, k)
    if config.dropout_keep_prob < 1.0:
        rank = world.rank if _local_bn(config, world) else None
        for i in range(k):
            state.generators[i].manual_seed(
                dropout_seed(tc.seed, state.step, i, rank))
    _seed_flip(state, config)
    state.optimizer.prepare()


def finish_step(state: TrainState):
    """The host's part of a step after its device work: the counts."""
    state.optimizer.advance()
    state.step += 1


def _check_batch(batch: Dict[str, torch.Tensor], config: GVCNNConfig):
    k = max(config.train.accumulate_steps, 1)
    b = len(batch["idx"] if "idx" in batch else batch["views"])
    if b % k:
        raise ValueError(f"batch_size {b} not divisible by accumulate_steps "
                         f"{k}")


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               config: GVCNNConfig) -> Dict[str, torch.Tensor]:
    """One optimizer step on `batch` {'views' (B, V, H, W, 3) float or
    uint8 (V = 1 for the single-view classifier), 'label' (B,)}, in place
    on `state`.  Returns the metrics as
    0-d device tensors: loss (cross-entropy + L2), accuracy, grad_norm (the
    global norm before clipping).

    `accumulate_steps` = k: the batch is cut into k microbatches run one
    after another (BatchNorm statistics chained through them, as the JAX
    step's scan does), and their gradients averaged before one update.

    Data parallelism (`state.world` with a process group): `batch` is this
    rank's rows of the global batch and each rank backpropagates its own
    loss; then ONE all-reduce of one flat buffer averages the gradients,
    loss and accuracy over the ranks (and, with `bn_sync="local"`, every
    BatchNorm's running statistics), the JAX step's one `pmean`.  Every rank
    then applies the same update, so the replicas stay bitwise equal;
    grad_norm is the combined gradient's.

      bn_sync "global"  BatchNorm statistics over all ranks' rows
                        (`create_train_state` syncs the model), and one
                        dropout mask drawn for the global batch, of which
                        the rank keeps its rows: the single-process step on
                        the global batch.  With k > 1 the global microbatch
                        i is every rank's microbatch i in rank order, so
                        for the JAX step's layout (microbatch i = global
                        rows [i B/k, (i+1) B/k)) a rank's batch holds its
                        share of each microbatch in turn
                        (`parallel.rank_rows(..., microbatches=k)`).
      bn_sync "local"   each rank normalizes by its own rows' statistics
                        (the reference's towers) and draws its own dropout
                        mask (the rank folded into the seed); with k > 1
                        its contiguous rows are cut into microbatches.

    With one rank both modes are the single-process step.

    The decoded loader's on-card flip (the JAX step's `device_flip`): with
    `loader="decoded"`, `augment` and `device_flip`, each (shape, view) of
    a 5-D batch is mirrored along W with probability 0.5 (`flip_mask`),
    on the card, before normalization; the host streamed the batch
    verbatim.

    A batch of the card-resident split (`data/device_resident.py`) holds
    the whole staged split and this step's indices, 'idx': the step
    gathers its views and labels on the card first, as the JAX step does
    with `jnp.take`; the rest is the streaming step.

    The step is the host's `seed_step`, the device work `device_step` and
    the counts (`finish_step`); `compile_train_step` replays the device
    work as one CUDA graph.  This eager form stays the one the analysis
    tools call: they attribute individual ops, which a replay hides."""
    _check_batch(batch, config)
    seed_step(state, config)
    mets = device_step(state, batch, config)
    finish_step(state)
    return mets


def device_step(state: TrainState, batch: Dict[str, torch.Tensor],
                config: GVCNNConfig) -> Dict[str, torch.Tensor]:
    """The device work of `train_step`, after `seed_step` and before
    `finish_step`: what a CUDA graph of the step captures.  Every choice
    it makes on the host (the flip, dropout, the microbatches, remat's
    recompute, BatchNorm's EMA) depends on the config and the shapes
    alone."""
    tc = config.train
    model, opt, world = state.model, state.optimizer, state.world
    if not model.training:
        model.train()
    views, labels = batch["views"], batch["label"]
    if "idx" in batch:
        views = views.index_select(0, batch["idx"])
        labels = labels.index_select(0, batch["idx"])
    if (config.data.loader == "decoded" and config.data.augment
            and config.data.device_flip and views.ndim == 5):
        views = device_flip(views, _draw_flip(state, config,
                                              views.shape[:2]))
    views = normalize_views(views)
    k = max(tc.accumulate_steps, 1)
    b = views.shape[0]
    for p in opt.params:
        p.grad = None
    local_bn = _local_bn(config, world)
    use_dropout = config.dropout_keep_prob < 1.0
    losses, accs = [], []
    for i in range(k):
        v, lab = views[i * b // k:(i + 1) * b // k], labels[i * b // k:
                                                              (i + 1) * b // k]
        gen, rows = None, None
        if use_dropout:
            gen = state.generators[i]
            if world.size > 1 and not local_bn:
                rows = (world.rank * len(v), world.size * len(v))
        logits, _ = model(v, generator=gen, dropout_rows=rows)
        ce = cross_entropy(logits, lab, tc.label_smoothing)
        ce.backward()
        losses.append(ce.detach())
        accs.append((logits.detach().argmax(-1) == lab).float().mean())
    with torch.no_grad():
        grads = [p.grad for p in opt.params]
        if k > 1:
            torch._foreach_div_(grads, float(k))
        loss, acc = torch.stack(losses).mean(), torch.stack(accs).mean()
        if world.distributed:
            collectives.mean_across_ranks_(
                grads + [loss, acc]
                + (bn_statistics(model) if local_bn else []), world)
        l2 = l2_regularization(state.kernels, tc.weight_decay, views.device)
        if tc.weight_decay > 0:
            torch._foreach_add_([p.grad for p in state.kernels],
                                state.kernels, alpha=tc.weight_decay)
        grad_norm = global_norm(grads)
        opt.apply(grads)
    return {"loss": loss + l2, "accuracy": acc, "grad_norm": grad_norm}


class CompiledTrainStep:
    """`train_step` with its device work (`device_step`) captured as one
    CUDA graph and replayed, as the JAX package runs its jitted, donated
    step (`compile_train_step`).  Called as `train_step` is, on the state,
    config and batch shape it was made for; returns fresh metric tensors
    (the graph's own outputs are overwritten by the next replay).

    Per call: `seed_step` on the host (generators reseeded, the optimizer's
    scalars written), the batch copied into the graph's static buffers
    (a streamed batch's views and labels, on the current stream, which
    the prefetcher has made wait for its copy; a card-resident batch's
    indices only, its staged split being read where it lies), the replay,
    `finish_step`.  The first call runs the step eagerly (the warm-up,
    `utils/graphs.py`), the second captures and replays, every later one
    replays.  The gradients persist across replays in the graph's pool
    (`p.grad` holds them between steps); the parameters' and buffers'
    version counters move each replay.  On the CPU, and over several
    data-parallel ranks (whose all-reduce is not captured), the call is
    `train_step` itself.  Each call is a `train.step` span
    (`utils/profiling.py`), whose child `graph.launch` is the replay's
    launch alone: its self time is the call's host work."""

    METRICS = ("loss", "accuracy", "grad_norm")

    def __init__(self, state: TrainState, config: GVCNNConfig,
                 batch: Dict[str, torch.Tensor]):
        self.state, self.config = state, config
        dev = state.world.device
        self.graph = None
        if not graphs.capturable(dev) or state.world.size > 1:
            return
        k = max(config.train.accumulate_steps, 1)
        _microbatch_generators(state, k)
        self._resident = "idx" in batch
        self._fixed = fixed = (
            {"views": batch["views"], "label": batch["label"]}
            if self._resident else {})
        self._keys = ("idx",) if self._resident else ("views", "label")
        static = {k: torch.empty_like(batch[k]) for k in self._keys}
        views = batch["idx" if self._resident else "views"]

        # The graph's functions hold the state and the buffers, not this
        # object or the graph: a dropped step frees its graph at once.
        def step():
            return device_step(state, {**fixed, **static}, config)

        def watched():
            return (graphs.model_tensors(state.model) + list(fixed.values())
                    + [t for v in state.optimizer.slots.values() for t in v])

        self.graph = graphs.CapturedCall(
            f"the train step of {config.name} (batch {tuple(views.shape)}, "
            f"{k} microbatch(es))", step, static, device=dev,
            generators=state.generators[:k] + [state.flip_generator],
            watch=watched, mutates=lambda: graphs.model_tensors(state.model))

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 config: GVCNNConfig) -> Dict[str, torch.Tensor]:
        if state is not self.state or config != self.config:
            raise ValueError("a compiled train step runs the state and "
                             "config it was compiled for")
        with profiling.span("train.step"):
            if self.graph is None:
                return train_step(state, batch, config)
            _check_batch(batch, config)
            if any(batch[k] is not t for k, t in self._fixed.items()):
                raise ValueError("a compiled train step reads the "
                                 "card-resident split it was compiled with")
            seed_step(state, config)
            out = self.graph(**{k: batch[k] for k in self._keys})
            finish_step(state)
            return dict(zip(self.METRICS, torch.stack(
                [out[k] for k in self.METRICS]).unbind()))

    def close(self):
        """Drop the graph and its memory."""
        if self.graph is not None:
            self.graph.reset()


def compile_train_step(state: TrainState, config: GVCNNConfig,
                       batch: Dict[str, torch.Tensor]) -> CompiledTrainStep:
    """The train step of `state` and `config` at `batch`'s shapes as one
    CUDA graph on a card (`CompiledTrainStep`; `train_step` on the CPU):
    the JAX package's `jax.jit(make_train_step(...), donate_argnums=0)`
    compiled ahead of time for the batch's shape.  Every step the graph
    covers: any `accumulate_steps`, dropout, the on-card flip, the uint8,
    bf16 and fp32 wires, `remat_until` and `remat_backbone`, every family.
    A step over several data-parallel ranks stays eager."""
    return CompiledTrainStep(state, config, batch)


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------


# What a resumed run may change: its length, its logging, checkpoint and
# evaluation cadence, its directory, the prefetch depth and the transport
# (streamed or card-resident: the same batches).
_RESUMABLE = {"train": ("num_steps", "epochs", "steps_per_epoch", "log_every",
                        "checkpoint_every", "eval_every", "train_logdir"),
              "data": ("prefetch_to_device", "device_resident")}


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


def _stream_state(saved, world: World):
    """This rank's data stream state from a checkpoint's `data` entry (a
    list of every rank's with more than one rank), or None (the stream
    starts from its seed) when it was saved by a world of another size."""
    if world.size == 1 and not isinstance(saved, list):
        return saved
    if isinstance(saved, list) and len(saved) == world.size:
        return saved[world.rank]
    if saved is not None:
        metrics_lib.log(f"the checkpoint's data streams are of another world "
                        f"size; this world's {world.size} stream(s) start "
                        "from their seeds")
    return None


def _rank_data_config(config: GVCNNConfig, world: World):
    """This rank's data config: its local batch size (the global batch over
    the world's size), and the card-resident split turned off under several
    ranks or `bn_sync="local"`, as the JAX package turns it off under
    several devices, processes or local BatchNorm (its batch of the whole
    split and an index vector is one device's transport)."""
    d, w = config.data, world.size
    if d.batch_size % w:
        raise ValueError(f"global batch {d.batch_size} not divisible by "
                         f"{w} ranks")
    d = dataclasses.replace(d, batch_size=d.batch_size // w)
    if w > 1 or config.bn_sync == "local":
        d = dataclasses.replace(d, device_resident="off")
    return d


def _rank_stream(config: GVCNNConfig, world: World):
    """This rank's shard of the train split (`_rank_data_config`), staged
    on its device where `make_dataset` allows it."""
    return make_dataset(_rank_data_config(config, world), train=True,
                        seed=config.train.seed, shard_index=world.rank,
                        num_shards=world.size, device=world.device)


def _check_profile_steps(profile_steps):
    if profile_steps is None:
        return None
    start, stop = (int(s) for s in profile_steps)
    if start < 0 or stop <= start:
        raise ValueError(f"profile_steps {tuple(profile_steps)}: want "
                         "(start, stop) with 0 <= start < stop")
    return start, stop


def trace_name(profile_steps: Tuple[int, int], world: World) -> str:
    """The file name of a profiled window's Chrome trace in
    `train_logdir` (the rank in it when there are several)."""
    rank = f"_rank{world.rank}" if world.size > 1 else ""
    return f"trace_steps_{profile_steps[0]}_{profile_steps[1]}{rank}.json"


def train(config: GVCNNConfig, *, num_steps: Optional[int] = None,
          dataset_iter=None, writer: Optional[metrics_lib.MetricWriter] = None,
          profile_steps: Optional[Tuple[int, int]] = None,
          device="cuda", world: Optional[World] = None
          ) -> Tuple[TrainState, Dict[str, float]]:
    """The training loop (the JAX package's `train` without its TPU
    parts).  Returns (final TrainState, last metrics as floats).
    `dataset_iter` injects a host-batch iterator (tests; with several
    ranks, this rank's).

    Data parallelism: `world` (default: `initialize_distributed(device=)`,
    which reads a launcher's environment and is a no-op in a single process,
    and is left again at the end) is one rank of several.  `num_devices`
    must be its size (None: any).  Every rank streams its own shard of the
    split at the global batch over the world's size, runs the same step on
    its replica and takes part in the step's all-reduce; rank 0 alone writes
    the metrics and the checkpoints, which hold every rank's stream state
    (a resume at the same world size restarts every stream where it was).
    The ranks meet before the first step, agree every step on whether any
    of them got SIGTERM (so all stop after the same step), and
    `eval_every` scores the split over all ranks.

    `profile_steps=(start, stop)`: steps [start, stop) run under
    `torch.profiler` (`utils/profiling.profile_trace`: device activity on
    a card, which is synchronized at the window's edges), each in a
    `train_step {step}` span holding the program's own spans
    (`utils/profiling.py`: `train.step`, `graph.launch`, ...), and the
    window's Chrome trace is written to `train_logdir/trace_name(...)`.
    A run that resumes past `start` captures nothing."""
    profile_steps = _check_profile_steps(profile_steps)
    own_world = world is None
    if own_world:
        world = initialize_distributed(device=device)
    try:
        return _train(config, num_steps, dataset_iter, writer, world,
                      profile_steps)
    finally:
        if own_world:
            shutdown(world)


def _step_function(state: TrainState, config: GVCNNConfig, batch):
    """The loop's step, `compile_train_step`: one CUDA graph on a card with
    one rank, logged; the eager `train_step` elsewhere."""
    world = state.world
    if graphs.capturable(world.device) and world.size > 1:
        metrics_lib.log(f"train: the data-parallel step over {world.size} "
                        "ranks runs eagerly (capturing it with its NCCL "
                        "all-reduce is ROADMAP item 29)")
    elif graphs.capturable(world.device):
        metrics_lib.log(f"train: the step runs as one CUDA graph on "
                        f"{world.device} (eager warm-up, captured at the "
                        "next step, replayed after)")
    return compile_train_step(state, config, batch)


def _train(config, num_steps, dataset_iter, writer, world: World,
           profile_steps=None):
    check_num_devices(config.num_devices, world)
    dev = world.device
    tc = config.train
    num_steps = num_steps if num_steps is not None else tc.num_steps
    steps_per_epoch = tc.steps_per_epoch
    if steps_per_epoch <= 0:
        # A TFRecord count reads every frame header: only pay it when the
        # run is epoch-denominated.
        n = dataset_size(config.data, train=True, cheap_only=tc.epochs <= 0)
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
        writer = (metrics_lib.MetricWriter(tc.train_logdir) if world.is_main
                  else metrics_lib.NullWriter())

    state = create_train_state(config, dev, world)
    if tc.checkpoint_path:
        # Warm start (slim's assign_from_checkpoint_fn with
        # checkpoint_exclude_scopes): parameters and BatchNorm statistics
        # of the included scopes; the excluded ones (a pretrained head of
        # another size) are not read.  A checkpoint in train_logdir, read
        # next, wins over it, as in the JAX package.
        warm_start_model(state.model, tc.checkpoint_path,
                         tc.checkpoint_exclude_scopes)
        metrics_lib.log(f"warm-started from {tc.checkpoint_path}")
    identity = run_identity(config)
    ckpt = Checkpointer(tc.train_logdir) if tc.checkpoint_every > 0 else None
    data_state = saved_step = None
    if ckpt is not None and ckpt.latest_step() is not None:
        payload = ckpt.restore(map_location="cpu")
        _check_resumable(payload.get("config"), config, tc.train_logdir)
        data_state = _stream_state(state.load_state_dict(payload), world)
        saved_step = state.step
        metrics_lib.log(f"resumed from step {state.step}")
    if dataset_iter is None:
        dataset_iter = _rank_stream(config, world)
        if data_state is not None:
            dataset_iter.load_state_dict(data_state)
    prefetch = DevicePrefetcher(dataset_iter, dev,
                                resolve_transfer_dtype(config),
                                depth=config.data.prefetch_to_device)
    # The stream's state after the last batch a step has taken.
    trained = {"data": data_state}

    def save(step):
        data = trained["data"]
        if world.size > 1:              # collective: every rank calls it
            data = collectives.gather_objects(data, world)
        if world.is_main:
            ckpt.save(step, state.state_dict(data, identity))

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
    step_fn = train_step
    window = contextlib.ExitStack()     # holds the open profiled window
    tracing = False
    try:
        collectives.barrier(world)
        for step in range(start, num_steps):
            if profile_steps is not None and step == profile_steps[0]:
                trace = os.path.join(tc.train_logdir,
                                     trace_name(profile_steps, world))
                window.enter_context(profile_trace(*os.path.split(trace),
                                                   device=dev))
                tracing = True
            batch = next(prefetch, None)
            # 1: a rank was preempted, 2: a rank's stream ended; every rank
            # learns it, so all leave after the same step.
            stop = collectives.agree_max(
                1 if preempted.is_set() else 2 if batch is None else 0,
                world)
            if stop == 1:
                metrics_lib.log(f"stopping at step {state.step} for "
                                "preemption; the next run resumes from the "
                                "saved checkpoint")
                break
            if stop == 2:
                metrics_lib.log("dataset exhausted")
                break
            if step == start:
                # A resident batch's labels are the whole staged split's.
                lo, hi = (int(v) for v in torch.stack(
                    [batch["label"].min(), batch["label"].max()]).cpu())
                if lo < 0 or hi >= config.data.num_classes:
                    raise ValueError(
                        f"labels [{lo}, {hi}] out of range for num_classes="
                        f"{config.data.num_classes}")
                step_fn = _step_function(state, config, batch)
            with (record_function(f"train_step {step}") if tracing
                  else contextlib.nullcontext()):
                mets = step_fn(state, batch, config)
            if tracing and step + 1 == profile_steps[1]:
                window.close()
                tracing = False
                metrics_lib.log(f"profiler trace written to {trace}")
            trained["data"] = prefetch.data_state
            timer.tick()
            if world.is_main and ((step + 1) % tc.log_every == 0
                                  or step + 1 == num_steps):
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
                save(step + 1)
                saved_step = step + 1
            if tc.eval_every > 0 and (step + 1) % tc.eval_every == 0:
                res = evaluate(config, state=state, world=world)
                writer.scalars(step + 1, {"val_accuracy": res["accuracy"],
                                          "val_count": res["count"]})
                metrics_lib.log(
                    f"step {step + 1} val accuracy {res['accuracy']:.4f} "
                    f"({res['correct']}/{res['count']})")
                timer.reset()       # the eval's time is not a step's
        if tracing:                     # the run ended inside the window
            window.close()
            metrics_lib.log(f"profiler trace written to {trace}")
        if ckpt is not None and saved_step != state.step:
            save(state.step)
        # The next run of any rank reads what rank 0 has written.
        collectives.barrier(world)
        writer.flush()
        return state, {k: float(v) for k, v in mets.items()}
    finally:
        window.close()
        prefetch.close()
        if isinstance(step_fn, CompiledTrainStep):
            step_fn.close()
        for sig, prev in prev_handlers.items():
            signal.signal(sig, prev)
        if own_writer:
            writer.close()


def _parse(argv):
    p = argparse.ArgumentParser(description="gvcnn_tf_tpu_torch trainer "
                                            "(PyTorch + CUDA)")
    add_flags(p)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises when no card "
                        "is present, it never falls back to the CPU; with "
                        "several ranks 'cuda' is each rank's own card")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks, one per card (default: the "
                        "config's); k > 1 without a launcher spawns k ranks "
                        "on this host")
    args = p.parse_args(argv)
    if args.train_logdir is None:
        p.error("--train_logdir is required: a run resumes from the newest "
                "checkpoint in it, so each run names its own directory")
    config = config_from_flags(args)
    if args.num_devices is not None:
        config = config.replace(num_devices=args.num_devices)
    return args, config


def _run(args, config, init_method=None):
    """One rank of the CLI's run (a single process, a launcher's rank or a
    spawned one)."""
    try:
        world = initialize_distributed(device=args.device,
                                       init_method=init_method)
    except RuntimeError as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.train: {e}") from e
    try:
        train(config, device=args.device, world=world)
    except (NotImplementedError, FileNotFoundError, ImportError,
            ValueError) as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.train: {e}") from e
    finally:
        shutdown(world)


def _spawned_rank(init_method, argv):
    _run(*_parse(argv), init_method)


def main(argv=None):
    args, config = _parse(argv)
    metrics_lib.log(f"training config {config.name}: {config}")
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"gvcnn_tf_tpu_torch.train: {e}") from e
    k = config.num_devices or 1
    if k > 1 and launch_env() is None:
        # One command for a data-parallel config: its ranks on this host.
        metrics_lib.log(f"spawning {k} ranks on this host")
        spawn(_spawned_rank, k,
              args=(list(sys.argv[1:] if argv is None else argv),))
        return
    _run(args, config)


if __name__ == "__main__":
    main()
