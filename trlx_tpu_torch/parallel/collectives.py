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
  reduce-scatter (local slices each rank then uses differently);
- :func:`scatter_to_group`: forward the local slice, backward all-gather
  (a replicated activation entering rank-local rows: Megatron-SP's scatter);
- :func:`reduce_scatter_to_group`: forward reduce-scatter, backward
  all-gather (row-parallel partial sums onto sequence-sharded rows).

Point-to-point traffic (the pipe axis, the ring's rotation) goes through
:func:`exchange`: NCCL's ``batch_isend_irecv`` on the tensors, gloo on host
copies (pinned on a card) when the tensors live on CUDA, counted by
:func:`staged` like the collectives. :func:`sequence_counts` counts the
sequence-parallel scatters and the ring rotations, so a run can show that
the sequence path ran.

Every entry point counts what it issues in :func:`collective_table`, keyed
``<kind>:<axes>`` as the reference's collective census
(``trlx_tpu/analysis/ir/lowering.py::parse_collectives``) keys the compiled
program's: ``all-reduce``, ``all-gather``, ``reduce-scatter`` (NCCL's, or
gloo's all-reduce and slice: the same exchange to the caller),
``all-to-all``, ``collective-permute`` (:func:`exchange`), and kinds the
reference has no name for: ``broadcast``, ``barrier``, ``object``
(:func:`broadcast_object`). ``<axes>`` is the group's
:attr:`~trlx_tpu_torch.parallel.mesh.AxisGroup.label`. Each key holds a
``count`` and the ``bytes`` of the outputs on this rank (the reference's
per-device output bytes; a received object's pickle is not measured: 0).
"""

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

_STAGED = {"calls": 0, "bytes": 0}
_CALLS = {"calls": 0}
_TABLE: Dict[str, Dict[str, int]] = {}
#: callables told ``fn(n)`` of ``n`` blocking copies between host and card a
#: staged collective is about to make, on the thread that makes them (the
#: census counts them as host round-trips where its modes cannot see them)
_TRANSFER_LISTENERS: List[Callable[[int], None]] = []
_SEQ = {"scatters": 0, "rotations": 0}
_LOCK = threading.Lock()


def staged() -> Dict[str, int]:
    """Collectives (and bytes each way) staged through host memory so far."""
    with _LOCK:
        return dict(_STAGED)


def collective_calls() -> int:
    """Collectives issued over groups of size > 1 so far."""
    with _LOCK:
        return _CALLS["calls"]


def collective_table() -> Dict[str, Dict[str, int]]:
    """``{"<kind>:<axes>": {"count", "bytes"}}`` of the collectives issued
    so far (see the module docstring)."""
    with _LOCK:
        return {k: dict(v) for k, v in sorted(_TABLE.items())}


def _count(kind: str, group, nbytes: int, staged_bytes: Optional[int] = None) -> None:
    """One collective of ``kind`` over ``group`` with ``nbytes`` of output
    on this rank; ``staged_bytes`` (each way) when it went through host memory."""
    key = f"{kind}:{group.label or '+'.join(group.axes)}"
    with _LOCK:
        _CALLS["calls"] += 1
        slot = _TABLE.setdefault(key, {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += int(nbytes)
        if staged_bytes is not None:
            _STAGED["calls"] += 1
            _STAGED["bytes"] += int(staged_bytes)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def add_transfer_listener(fn: Callable[[int], None]) -> None:
    with _LOCK:
        _TRANSFER_LISTENERS.append(fn)


def remove_transfer_listener(fn: Callable[[int], None]) -> None:
    with _LOCK:
        _TRANSFER_LISTENERS.remove(fn)


def _transfers(n: int) -> None:
    with _LOCK:
        listeners = list(_TRANSFER_LISTENERS)
    for fn in listeners:
        fn(n)


def sequence_counts() -> Dict[str, int]:
    """Sequence-parallel scatters (:func:`count_scatter`) and ring
    rotations (:func:`count_rotation`) so far."""
    with _LOCK:
        return dict(_SEQ)


def count_scatter() -> None:
    with _LOCK:
        _SEQ["scatters"] += 1


def count_rotation() -> None:
    with _LOCK:
        _SEQ["rotations"] += 1


def reset_counts() -> None:
    with _LOCK:
        _STAGED.update(calls=0, bytes=0)
        _CALLS["calls"] = 0
        _TABLE.clear()
        _SEQ.update(scatters=0, rotations=0)


def _dist():
    import torch.distributed as dist

    return dist


def _stage(x: torch.Tensor, group, kind: str, out_bytes: int, out_factor: int = 1):
    """The gloo branch's staging: ``(t, back)`` where ``t`` is what the
    collective runs on (a host copy of a CUDA tensor under gloo, else ``x``
    itself) and ``back(result)`` returns a result to ``x``'s device.
    Counts the collective (``kind``, ``out_bytes`` of output), and a staged
    one with its bytes (``x`` out and ``out_factor`` times ``x`` back)."""
    staged_now = x.device.type == "cuda" and _dist().get_backend(group.pg) == "gloo"
    _count(kind, group, out_bytes, (1 + out_factor) * _nbytes(x) if staged_now else None)
    if not staged_now:
        return x, lambda r: r

    def back(r):
        _transfers(1)
        return r.to(x.device)  # graftcheck: noqa[TX002] the staged result back to the card

    _transfers(1)
    # gloo takes host tensors: ranks sharing a card stage through host memory,
    # counted above (no path with one rank or NCCL reaches this line)
    return x.detach().to("cpu", copy=True), back  # graftcheck: noqa[TX002]


def _run(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, group, kind: str, out_bytes: int,
         out_factor: int = 1) -> torch.Tensor:
    """``fn(t)`` on ``x``, staged through the host when gloo meets a CUDA tensor."""
    t, back = _stage(x, group, kind, out_bytes, out_factor)
    return back(fn(t))


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of ``x`` over the group (a new tensor; ``x`` is left as it was)."""
    return _all_reduce(x, group, op, "all-reduce", None)


def _all_reduce(x: torch.Tensor, group, op: str, kind: str, out_bytes) -> torch.Tensor:
    """:func:`all_reduce`, counted as ``kind`` with ``out_bytes`` (None:
    ``x``'s bytes)."""
    if group is None or group.size == 1:
        return x
    dist = _dist()
    red = getattr(dist.ReduceOp, _OPS[op])

    def fn(t):
        t = t.clone() if t is x else t
        dist.all_reduce(t, op=red, group=group.pg)
        return t

    return _run(fn, x.contiguous(), group, kind, _nbytes(x) if out_bytes is None else out_bytes)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's slices of ``x`` concatenated along ``dim`` in group order."""
    if group is None or group.size == 1:
        return x
    dist = _dist()

    def fn(t):
        parts = [torch.empty_like(t) for _ in range(group.size)]
        dist.all_gather(parts, t, group=group.pg)
        return torch.cat(parts, dim=dim)

    return _run(fn, x.contiguous(), group, "all-gather", group.size * _nbytes(x), group.size)


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
        _count("reduce-scatter", group, _nbytes(x) // group.size)
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // group.size,) + tuple(moved.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, moved, group=group.pg)
        return out.movedim(0, dim)
    return local_slice(_all_reduce(x, group, "sum", "reduce-scatter", _nbytes(x) // group.size), group,
                       dim).contiguous()


def all_gather_async(x: torch.Tensor, group, dim: int = 0) -> Callable[[], torch.Tensor]:
    """Start :func:`all_gather`; the returned callable waits for it (NCCL:
    the current stream waits on the collective's event) and returns the
    concatenation."""
    dist = _dist()
    t, back = _stage(x.contiguous(), group, "all-gather", group.size * _nbytes(x), group.size)
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
        _count("reduce-scatter", group, _nbytes(x) // group.size)
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // group.size,) + tuple(moved.shape[1:]), dtype=x.dtype, device=x.device)
        work = dist.reduce_scatter_tensor(out, moved, group=group.pg, async_op=True)

        def wait_nccl():
            work.wait()
            return out.movedim(0, dim)

        return wait_nccl
    t, back = _stage(x.detach(), group, "reduce-scatter", _nbytes(x) // group.size)
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
    _count("object", group, 0)
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
    _all_reduce(torch.zeros(1, device=_barrier_device(group)), group, "sum", "barrier", None)


def broadcast(x: torch.Tensor, group, src_index: int) -> torch.Tensor:
    """Group member ``src_index``'s ``x`` on every member (a new tensor on
    the others; ``x`` gives the shape and dtype there)."""
    if group is None or group.size == 1:
        return x
    dist = _dist()
    src = dist.get_global_rank(group.pg, src_index) if group.pg is not dist.group.WORLD else src_index

    def fn(t):
        t = t.clone() if t is x else t
        dist.broadcast(t, src=src, group=group.pg)
        return t

    return _run(fn, x.contiguous(), group, "broadcast", _nbytes(x))


def all_to_all(x: torch.Tensor, group, split_dim: int, cat_dim: int) -> torch.Tensor:
    """``x`` cut into ``group.size`` equal chunks along ``split_dim``, chunk
    ``j`` sent to member ``j``, the received chunks concatenated along
    ``cat_dim`` in member order."""
    if group is None or group.size == 1:
        return x
    dist = _dist()
    n = group.size

    def fn(t):
        # one flat exchange (gloo has all_to_all_single, not the list form)
        send = torch.stack(t.chunk(n, dim=split_dim)).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group.pg)
        return torch.cat(recv.unbind(0), dim=cat_dim)

    return _run(fn, x.contiguous(), group, "all-to-all", _nbytes(x))


def all_to_all_flat(x: torch.Tensor, group, send_counts: Sequence[int], recv_counts: Sequence[int]) -> torch.Tensor:
    """1-D ``x`` cut into consecutive pieces of ``send_counts`` elements,
    piece ``j`` sent to member ``j``; the pieces received (``recv_counts``
    elements from each member) concatenated in member order."""
    if group is None or group.size == 1:
        return x
    dist = _dist()

    def fn(t):
        recv = t.new_empty(int(sum(recv_counts)))
        dist.all_to_all_single(recv, t, output_split_sizes=list(recv_counts), input_split_sizes=list(send_counts),
                               group=group.pg)
        return recv

    return _run(fn, x.contiguous(), group, "all-to-all", int(sum(recv_counts)) * x.element_size())


def global_rank(group, index: int) -> int:
    """The world rank of group member ``index``."""
    dist = _dist()
    return dist.get_global_rank(group.pg, index) if group.pg is not dist.group.WORLD else index


def exchange(sends, recvs, group) -> list:
    """Point-to-point traffic over ``group``'s process group:
    ``sends`` = [(tensor, world rank)], ``recvs`` = [(like, world rank)]
    (``like`` a tensor whose shape, dtype and device the message takes),
    posted together and waited on. Returns the received tensors. On gloo
    a CUDA message goes through a host copy (pinned), counted by
    :func:`staged`; NCCL takes the tensors as they are."""
    dist = _dist()
    if not sends and not recvs:
        return []
    cuda = any(t.device.type == "cuda" for t, _ in list(sends) + list(recvs))
    staged_now = cuda and dist.get_backend(group.pg) == "gloo"
    nbytes = sum(_nbytes(t) for t, _ in list(sends) + list(recvs))
    _count("collective-permute", group, sum(_nbytes(like) for like, _ in recvs), nbytes if staged_now else None)
    if staged_now:
        # gloo kills the sender on send / recv of CUDA tensors: host copies
        # (no path with one rank or NCCL reaches this line)
        _transfers(len(sends))
        out_sends = [(_pinned(t).copy_(t), r) for t, r in sends]  # graftcheck: noqa[TX002] gloo takes host tensors
        bufs = [_pinned(like) for like, _ in recvs]
    else:
        out_sends = [(t.contiguous(), r) for t, r in sends]
        bufs = [torch.empty(like.shape, dtype=like.dtype, device=like.device) for like, _ in recvs]
    ops = [dist.P2POp(dist.isend, t, r, group.pg) for t, r in out_sends]
    ops += [dist.P2POp(dist.irecv, b, r, group.pg) for b, (_, r) in zip(bufs, recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged_now:
        _transfers(len(recvs))
        # the received host copies back to the card
        return [b.to(like.device) for b, (like, _) in zip(bufs, recvs)]  # graftcheck: noqa[TX002]
    return bufs


def _pinned(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, device="cpu", pin_memory=True)


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


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return local_slice(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _ReduceScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.group, ctx.dims = group, (split_dim, cat_dim)
        return all_to_all(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return all_to_all(g.contiguous(), ctx.group, cat_dim, split_dim), None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


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


def scatter_to_group(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return _ScatterToGroup.apply(x, group, dim % x.dim()) if _active(group) else x


def reduce_scatter_to_group(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return _ReduceScatterToGroup.apply(x, group, dim % x.dim()) if _active(group) else x


def all_to_all_op(x: torch.Tensor, group, split_dim: int, cat_dim: int) -> torch.Tensor:
    """:func:`all_to_all` with its inverse as the backward (heads <-> sequence relayouts)."""
    if not _active(group):
        return x
    return _AllToAll.apply(x, group, split_dim % x.dim(), cat_dim % x.dim())


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Forward identity, backward the gradient times ``scale``."""
    return _ScaleGrad.apply(x, scale) if scale != 1.0 else x


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
