"""Collectives over a mesh axis group, and the autograd operators of tensor
parallelism and of batch-global statistics.

Every cross-rank exchange of the port goes through the functions here, over
an :class:`~trlx_tpu_torch.parallel.mesh.AxisGroup` (a size-1 group makes
each of them a no-op, so one-rank code runs unchanged).

Gloo takes host tensors; where ranks share a card over gloo, a CUDA tensor
is staged through host memory by :func:`_stage` (the one place that does
it, for the blocking collectives and the asynchronous ones alike): copied
to the host, exchanged, copied back. :func:`staged` counts those
collectives and their bytes. The compute stays on the card.

The autograd operators follow Megatron's convention: the activations after a
model-axis reduction are the same on every rank of the group, and each rank
computes the same loss from them, so a replicated tensor's gradient is the
same on every rank and is not summed again.

- :func:`copy_to_group` (``f``): forward identity, backward all-reduce — a
  replicated activation entering rank-local work (column-parallel input);
- :func:`reduce_from_group` (``g``): forward all-reduce, backward identity —
  partial sums becoming replicated (row-parallel output), and the batch
  sums of global statistics (:func:`batch_sum`);
- :func:`gather_from_group`: forward all-gather, backward the local slice
  (local slices becoming replicated: vocab-parallel logits);
- :func:`gather_reduce_scatter`: forward all-gather, backward
  reduce-scatter (local slices each rank then uses differently).
"""

import contextlib
import threading
from typing import Callable, Dict

import torch

_STAGED = {"calls": 0, "bytes": 0}
_CALLS = {"calls": 0}
_LOCK = threading.Lock()


def staged() -> Dict[str, int]:
    """Collectives (and bytes each way) staged through host memory so far."""
    with _LOCK:
        return dict(_STAGED)


def collective_calls() -> int:
    """Collectives issued over groups of size > 1 so far."""
    with _LOCK:
        return _CALLS["calls"]


def reset_counts() -> None:
    with _LOCK:
        _STAGED.update(calls=0, bytes=0)
        _CALLS["calls"] = 0


def _dist():
    import torch.distributed as dist

    return dist


def _stage(x: torch.Tensor, group, out_factor: int = 1):
    """The gloo branch's staging: ``(t, back)`` where ``t`` is what the
    collective runs on (a host copy of a CUDA tensor under gloo, else ``x``
    itself) and ``back(result)`` returns a result to ``x``'s device.
    Counts the collective, and a staged one with its bytes (``x`` out and
    ``out_factor`` times ``x`` back)."""
    staged_now = x.device.type == "cuda" and _dist().get_backend(group.pg) == "gloo"
    with _LOCK:
        _CALLS["calls"] += 1
        if staged_now:
            _STAGED["calls"] += 1
            _STAGED["bytes"] += (1 + out_factor) * x.numel() * x.element_size()
    if not staged_now:
        return x, lambda r: r
    # gloo takes host tensors: ranks sharing a card stage through host memory,
    # counted above (no path with one rank or NCCL reaches this line)
    return x.detach().to("cpu", copy=True), lambda r: r.to(x.device)  # graftcheck: noqa[TX002]


def _run(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, group, out_factor: int = 1) -> torch.Tensor:
    """``fn(t)`` on ``x``, staged through the host when gloo meets a CUDA tensor."""
    t, back = _stage(x, group, out_factor)
    return back(fn(t))


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of ``x`` over the group (a new tensor; ``x`` is left as it was)."""
    if group is None or group.size == 1:
        return x
    dist = _dist()
    red = getattr(dist.ReduceOp, _OPS[op])

    def fn(t):
        t = t.clone() if t is x else t
        dist.all_reduce(t, op=red, group=group.pg)
        return t

    return _run(fn, x.contiguous(), group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's slices of ``x`` concatenated along ``dim`` in group order."""
    if group is None or group.size == 1:
        return x
    dist = _dist()

    def fn(t):
        parts = [torch.empty_like(t) for _ in range(group.size)]
        dist.all_gather(parts, t, group=group.pg)
        return torch.cat(parts, dim=dim)

    return _run(fn, x.contiguous(), group, group.size)


def local_slice(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim``."""
    if group is None or group.size == 1:
        return x
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.index * n, n)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` of the group's sum of ``x``. NCCL
    runs a reduce-scatter; gloo the all-reduce and the slice."""
    if group is None or group.size == 1:
        return x
    dist = _dist()
    if dist.get_backend(group.pg) == "nccl":
        with _LOCK:
            _CALLS["calls"] += 1
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // group.size,) + tuple(moved.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, moved, group=group.pg)
        return out.movedim(0, dim)
    return local_slice(all_reduce(x, group), group, dim).contiguous()


def all_gather_async(x: torch.Tensor, group, dim: int = 0) -> Callable[[], torch.Tensor]:
    """Start :func:`all_gather`; the returned callable waits for it (NCCL:
    the current stream waits on the collective's event) and returns the
    concatenation."""
    dist = _dist()
    t, back = _stage(x.contiguous(), group, group.size)
    parts = [torch.empty_like(t) for _ in range(group.size)]
    work = dist.all_gather(parts, t, group=group.pg, async_op=True)

    def wait():
        work.wait()
        return back(torch.cat(parts, dim=dim))

    return wait


def reduce_scatter_async(x: torch.Tensor, group, dim: int = 0) -> Callable[[], torch.Tensor]:
    """Start :func:`reduce_scatter`; the returned callable waits and returns
    this rank's slice of the sum."""
    dist = _dist()
    if dist.get_backend(group.pg) == "nccl":
        with _LOCK:
            _CALLS["calls"] += 1
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // group.size,) + tuple(moved.shape[1:]), dtype=x.dtype, device=x.device)
        work = dist.reduce_scatter_tensor(out, moved, group=group.pg, async_op=True)

        def wait_nccl():
            work.wait()
            return out.movedim(0, dim)

        return wait_nccl
    t, back = _stage(x.detach(), group)
    if t.data_ptr() == x.data_ptr():
        t = t.clone()
    work = dist.all_reduce(t, group=group.pg, async_op=True)

    def wait():
        work.wait()
        return back(local_slice(t, group, dim).contiguous())

    return wait


def broadcast_object(obj, group, src_index: int = 0):
    """A picklable object from group member ``src_index`` to every member
    (through host memory on either backend)."""
    if group is None or group.size == 1:
        return obj
    dist = _dist()
    src = dist.get_global_rank(group.pg, src_index) if group.pg is not dist.group.WORLD else src_index
    box = [obj]
    with _LOCK:
        _CALLS["calls"] += 1
    device = None
    if dist.get_backend(group.pg) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    dist.broadcast_object_list(box, src=src, group=group.pg, device=device)
    return box[0]


def barrier(group) -> None:
    if group is None or group.size == 1:
        return
    # an all-reduce of a one-element host tensor: works on gloo and stays
    # off the card's streams on NCCL alike
    all_reduce(torch.zeros(1, device=_barrier_device(group)), group)


def _barrier_device(group):
    if _dist().get_backend(group.pg) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# -- autograd operators --------------------------------------------------------


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.group, ctx.dim).contiguous(), None, None


class _GatherReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


def _active(group) -> bool:
    return group is not None and group.size > 1


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group) if _active(group) else x


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group) if _active(group) else x


def gather_from_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _GatherFromGroup.apply(x, group, dim % x.dim()) if _active(group) else x


def gather_reduce_scatter(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _GatherReduceScatter.apply(x, group, dim % x.dim()) if _active(group) else x


# -- batch-global statistics ---------------------------------------------------

_BATCH = threading.local()


@contextlib.contextmanager
def batch_group(group):
    """Make the statistics of the losses (:func:`batch_sum`, ``masked_mean``,
    ``whiten``, ...) global over ``group``'s ranks for the enclosed code, as
    the JAX step's statistics are over the global microbatch. None (or a
    size-1 group) keeps them local."""
    prev = getattr(_BATCH, "group", None)
    _BATCH.group = group if _active(group) else None
    try:
        yield
    finally:
        _BATCH.group = prev


def current_batch_group():
    return getattr(_BATCH, "group", None)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a per-rank partial sum) summed over the active batch group;
    the backward passes each rank its own share (:func:`reduce_from_group`)."""
    return reduce_from_group(x, current_batch_group())


def batch_max(x: torch.Tensor) -> torch.Tensor:
    group = current_batch_group()
    return x if group is None else all_reduce(x.detach(), group, "max")


def batch_min(x: torch.Tensor) -> torch.Tensor:
    group = current_batch_group()
    return x if group is None else all_reduce(x.detach(), group, "min")


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``x`` over the active batch group."""
    if current_batch_group() is None:
        return torch.mean(x)
    return batch_sum(x.sum()) / batch_count(x.numel())


def batch_count(n) -> float:
    """A per-rank element count summed over the active batch group (host int)."""
    group = current_batch_group()
    if group is None:
        return n
    return n * group.size
