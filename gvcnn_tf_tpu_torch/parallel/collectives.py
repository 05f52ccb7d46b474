"""The collectives of the data-parallel step (no file counterpart in the JAX
package: there XLA inserts them from the shardings).

Only `all_reduce` is used, the one collective gloo runs on CUDA tensors as
well as on CPU ones, so a world of ranks sharing one card over gloo runs
the same code as NCCL across cards.

- `sum_across_ranks`: an all-reduced sum that autograd differentiates (its
  backward all-reduces the incoming gradient): BatchNorm's global
  statistics (`bn_sync="global"`).
- `mean_across_ranks_`: the mean over ranks of a list of tensors, in place,
  as ONE all-reduce of one flat buffer: the step's combine (gradients,
  metrics and, with `bn_sync="local"`, the BatchNorm statistics), the
  counterpart of the JAX step's single `pmean`.
- On the host group (CPU tensors, gloo): `barrier`, `agree_max` (a code
  that every rank learns, so all stop after the same step),
  `gather_objects` (each rank's object, on every rank) and `sum_counts`.

Every call goes through `_all_reduce`, which logs it to each active
`CollectiveRecorder` (`tools/analyze_collectives.py`'s audit).
"""

from __future__ import annotations

import io
from typing import Any, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gvcnn_tf_tpu_torch.parallel.mesh import World

# The recorders in whose `with` block this process is (module state: the
# collectives are module functions, called deep inside BatchNorm and the
# step).
_RECORDERS: List["CollectiveRecorder"] = []


class CollectiveRecorder:
    """Context manager: each all-reduce made through this module inside the
    block is appended to `ops` as a dict: op ("all_reduce"), reduce_op
    ("sum", "max"), site (the function that made it), group ("device": the
    world's group; "host": the gloo host group), dtype, numel and bytes.
    An autograd backward's all-reduces are logged too, from whatever thread
    runs them."""

    def __init__(self):
        self.ops: List[dict] = []

    def __enter__(self) -> "CollectiveRecorder":
        _RECORDERS.append(self)
        return self

    def __exit__(self, *exc):
        _RECORDERS.remove(self)


def _all_reduce(t: torch.Tensor, group, site: str, on_host: bool,
                op=dist.ReduceOp.SUM):
    for rec in _RECORDERS:
        rec.ops.append(dict(
            op="all_reduce",
            reduce_op="max" if op == dist.ReduceOp.MAX else "sum",
            site=site, group="host" if on_host else "device",
            dtype=str(t.dtype).replace("torch.", ""), numel=t.numel(),
            bytes=t.numel() * t.element_size()))
    dist.all_reduce(t, op=op, group=group)


class _SumAcrossRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        _all_reduce(out, group, "sum_across_ranks", False)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        _all_reduce(grad, ctx.group, "sum_across_ranks.backward", False)
        return grad, None


def sum_across_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the ranks of `group`, on every rank; its
    gradient is the sum of the ranks' incoming gradients.  With each rank
    backpropagating its own loss, that is the gradient of the sum of the
    ranks' losses, so the gradient mean that follows gives the global
    batch's gradient once."""
    return _SumAcrossRanks.apply(t, group)


@torch.no_grad()
def mean_across_ranks_(tensors: Sequence[torch.Tensor], world: World):
    """In place: every tensor (one dtype, on the world's device) becomes
    its mean over the ranks, through one all-reduce of one flat buffer."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat, world.group, "mean_across_ranks_", False)
    flat.div_(world.size)
    views, at = [], 0
    for t in tensors:
        views.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    torch._foreach_copy_(tensors, views)


def barrier(world: World):
    """All ranks meet here (host side)."""
    if world.distributed:
        _all_reduce(torch.zeros(1), world.host_group, "barrier", True)


def agree_max(code: int, world: World) -> int:
    """The largest of the ranks' `code`s, the same answer on every rank."""
    if not world.distributed:
        return code
    t = torch.tensor([code], dtype=torch.int64)
    _all_reduce(t, world.host_group, "agree_max", True, dist.ReduceOp.MAX)
    return int(t.item())


def sum_counts(counts: np.ndarray, world: World) -> np.ndarray:
    """The int64 array `counts` summed over the ranks."""
    if not world.distributed:
        return counts
    t = torch.from_numpy(np.ascontiguousarray(counts, np.int64))
    _all_reduce(t, world.host_group, "sum_counts", True)
    return t.numpy()


def gather_objects(obj: Any, world: World) -> List[Any]:
    """[rank 0's obj, rank 1's, ...] on every rank: each object is
    serialized with `torch.save` (tensors, numbers, strings, containers)
    into its own slot of one zeroed byte buffer, and one all-reduced sum
    fills every slot."""
    if not world.distributed:
        return [obj]
    buf = io.BytesIO()
    torch.save(obj, buf)
    mine = torch.frombuffer(bytearray(buf.getvalue()), dtype=torch.uint8)
    sizes = torch.zeros(world.size, dtype=torch.int64)
    sizes[world.rank] = mine.numel()
    _all_reduce(sizes, world.host_group, "gather_objects", True)
    width = int(sizes.max())
    slots = torch.zeros(world.size, width, dtype=torch.uint8)
    slots[world.rank, :mine.numel()] = mine
    _all_reduce(slots, world.host_group, "gather_objects", True)
    return [torch.load(io.BytesIO(slots[r, :int(sizes[r])].numpy()
                                  .tobytes()), weights_only=True)
            for r in range(world.size)]
