"""The per-step census: what one step of a hot entrypoint asks of the device.

On any device, a :class:`Census` (a ``TorchDispatchMode`` under a
``TorchFunctionMode``) records per step:

- ``ops``: aten ops dispatched (forward and backward);
- ``heavy_f32``: heavy ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``linear``...) with an f32/f64 operand inside a step that computes in
  bf16 (every registered one) — the reference's IR001;
- ``round_trips``: host round-trips (the reference's IR004): reads of a
  device tensor on the host (``_local_scalar_dense`` under ``.item()``,
  ``bool()``, ``int()``, ``float()``; ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.to("cpu")``), blocking copies of host data to the device
  (``torch.tensor(data, device=...)``, ``.to(device)`` of a host tensor),
  and ops whose output shape depends on device data (``nonzero``,
  boolean-mask indexing, ``unique``...). On the card each of these is one
  synchronizing runtime call; on the CPU, where every tensor is a host
  tensor, the census tracks which tensors came from host data to tell them
  apart. The modes see the thread that entered the census only: a
  collective staged through host memory on another thread (the autograd
  engine runs a CUDA backward's hooks on its device thread, where the
  overlapped FSDP step starts its reduce-scatters) reports its copies
  itself (``collectives.add_transfer_listener``);
- ``shapes``: the (op, input shapes and dtypes) signatures the step
  dispatched. A CUDA-graph capture of the warmup replays only what the
  warmup dispatched, so steady state must bring no signature the warmup
  lacked — the reference's zero-recompile promise (``analysis/rt``).

On every device, :func:`measure` adds per step the collectives the step
issued, ``{"<kind>:<axes>": {"count", "bytes"}}`` as
:func:`~trlx_tpu_torch.parallel.collectives.collective_table` counts them
(the reference's IR005; ``{}`` on one device), the collectives ``staged``
through host memory (calls and bytes), and, for an entry that names its
optimizer, ``state_bytes``: the bytes of the optimizer state this rank
holds after the steps (a count of its tensors, not a measurement).

On the card, :func:`measure` adds per step the kernel launches and the
synchronizing runtime calls (which must equal ``round_trips``) the step
made, counted exactly from CUPTI's callback API
(:mod:`~trlx_tpu_torch.analysis.census.api_counter`), the hand-written
kernels' launches (``ops/_kernels.py::LAUNCHES``) and the peak allocated
bytes above the step's start (the reference's IR006).
"""

import contextlib
import gc
import threading
import weakref
from typing import Any, Dict, List, Optional, Set, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

HEAVY_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "linear", "addbmm", "addmv", "mv", "matmul"})
#: ops whose output shape (or value returned to Python) depends on device data
SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select", "_unique2", "unique_dim",
                      "unique_consecutive", "bincount", "equal", "repeat_interleave"})
_INDEX_OPS = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})
_WIDE = (torch.float32, torch.float64)


def _device_of(args, kwargs) -> Optional[torch.device]:
    """The target device of a ``.to(...)`` / ``.cuda()`` call, else None."""
    cand = kwargs.get("device")
    if cand is None:
        for a in args[1:]:
            if isinstance(a, (str, torch.device)):
                cand = a
                break
            if isinstance(a, torch.Tensor):
                cand = a.device
                break
    if cand is None:
        return None
    try:
        return torch.device(cand)
    except (RuntimeError, TypeError):
        return None


class _Step:
    def __init__(self):
        self.ops = 0
        self.heavy_f32 = 0
        self.round_trips = 0
        self.shapes: Set[Tuple] = set()


class Census:
    """Context manager recording one step (see the module docstring) on
    ``device``. Every registered step computes in bf16, so any heavy op
    with an f32/f64 operand is counted."""

    def __init__(self, device):
        self.dev_type = torch.device(device).type
        self._host: Dict[int, Any] = {}  # CPU census: tensors that hold host data
        self.step = _Step()
        census = self

        class _Dispatch(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                census._on_op(func, args, kwargs, out)
                return out

        class _Functions(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                census._on_function(func, args, kwargs, out)
                return out

        self._modes = (_Functions(), _Dispatch())

    # -- device / host ---------------------------------------------------------

    def _is_host(self, t: torch.Tensor) -> bool:
        if self.dev_type != "cpu":
            return t.device.type == "cpu"
        ref = self._host.get(id(t))
        return ref is not None and ref() is t

    def _is_device(self, t) -> bool:
        return isinstance(t, torch.Tensor) and t.device.type == self.dev_type and not self._is_host(t)

    def _unmark_host(self, out) -> None:
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._host.pop(id(t), None)

    def _mark_host(self, out) -> None:
        if self.dev_type != "cpu":
            return
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and id(t) not in self._host:
                key = id(t)
                self._host[key] = weakref.ref(t, lambda _, k=key: self._host.pop(k, None))

    # -- hooks -----------------------------------------------------------------

    def _on_op(self, func, args, kwargs, out) -> None:
        step = self.step
        name = func.overloadpacket.__name__
        tensors = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        step.ops += 1
        step.shapes.add((str(func), tuple((tuple(t.shape), str(t.dtype)) for t in tensors)))
        if name in HEAVY_OPS and any(t.dtype in _WIDE for t in tensors):
            step.heavy_f32 += 1
        on_device = any(self._is_device(t) for t in tensors)
        if name in SYNC_OPS and on_device:
            if name != "repeat_interleave" or kwargs.get("output_size") is None:
                step.round_trips += 1
        elif name in _INDEX_OPS and any(
                t.dtype in (torch.bool, torch.uint8) and self._is_device(t) for t in tree_leaves(args[1:2])
                if isinstance(t, torch.Tensor)):
            step.round_trips += 1  # boolean-mask indexing: a nonzero inside
        if self.dev_type == "cpu" and (name == "lift_fresh" or (tensors and all(self._is_host(t) for t in tensors))):
            self._mark_host(out)  # data from numpy / Python is host data, and stays so through host ops

    def _on_function(self, func, args, kwargs, out) -> None:
        step = self.step
        name = getattr(func, "__name__", "")
        src = args[0] if args else None
        if name in ("tolist", "numpy") and self._is_device(src):
            step.round_trips += 1
        elif name == "cpu" and self._is_device(src):
            step.round_trips += 1
            self._mark_host(out)
        elif name in ("to", "cuda") and isinstance(src, torch.Tensor):
            target = torch.device("cuda") if name == "cuda" else _device_of(args, kwargs)
            if target is None:
                return
            if target.type == "cpu" and self._is_device(src) and self.dev_type != "cpu":
                step.round_trips += 1
                self._mark_host(out)
            elif target.type == "cpu" and self.dev_type == "cpu" and self._is_device(src) and (
                    kwargs.get("device") == "cpu" or "cpu" in [a for a in args[1:] if isinstance(a, str)]):
                step.round_trips += 1  # an explicit .to("cpu") of device data
                self._mark_host(out)
            elif target.type == self.dev_type and self._is_host(src):
                if not kwargs.get("non_blocking", False):
                    step.round_trips += 1  # a blocking copy of host data to the device
                self._unmark_host(out)
        elif name in ("tensor", "as_tensor", "asarray"):
            data, dev = src, kwargs.get("device")
            # the literal "cpu" asks for host memory (torch.optim's step counters); a
            # device object is the caller's placement, on the card the card
            to_device = dev is not None and dev != "cpu" and torch.device(dev).type == self.dev_type
            if isinstance(data, torch.Tensor):
                if to_device and self._is_host(data):
                    step.round_trips += 1
                    self._unmark_host(out)
            elif to_device:
                step.round_trips += 1  # host data copied to the device
                self._unmark_host(out)
            else:
                self._mark_host(out)
        elif name == "from_numpy":
            self._mark_host(out)
        elif name == "copy_" and len(args) >= 2 and isinstance(args[1], torch.Tensor):
            if self._is_device(args[0]) != self._is_device(args[1]) and not kwargs.get("non_blocking", False):
                step.round_trips += 1

    def __enter__(self):
        from trlx_tpu_torch.parallel import collectives

        self.step = _Step()
        self._others = _OtherThreads()
        collectives.add_transfer_listener(self._others)
        for mode in self._modes:
            mode.__enter__()
        return self

    def __exit__(self, *exc):
        from trlx_tpu_torch.parallel import collectives

        for mode in reversed(self._modes):
            mode.__exit__(*exc)
        collectives.remove_transfer_listener(self._others)
        self.step.round_trips += self._others.count()
        return False


class _OtherThreads:
    """The blocking copies staged collectives report (``fn(n)``) from
    threads other than the one that made this counter."""

    def __init__(self):
        self.owner = threading.get_ident()
        self._lock = threading.Lock()
        self._n = 0

    def __call__(self, n: int) -> None:
        if threading.get_ident() != self.owner:
            with self._lock:
                self._n += n

    def count(self) -> int:
        with self._lock:
            return self._n


def _same(values: List[Any]) -> Any:
    """The one value of a list whose entries must agree, else the list."""
    return values[0] if all(v == values[0] for v in values) else list(values)


def _table_delta(before: Dict[str, Dict[str, int]], after: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """The collectives issued between two :func:`collective_table` reads."""
    zero = {"count": 0, "bytes": 0}
    return {k: {f: after[k][f] - before.get(k, zero)[f] for f in zero} for k in after
            if after[k]["count"] != before.get(k, zero)["count"]}


def optimizer_state_bytes(optimizer) -> int:
    """The bytes of every tensor in ``optimizer.state`` (this rank's)."""
    return sum(v.numel() * v.element_size() for state in optimizer.state.values() for v in state.values()
               if torch.is_tensor(v))


def measure(entry, device) -> Dict[str, Any]:
    """The census of one built :class:`~trlx_tpu_torch.analysis.census.entrypoints.Entry`:
    its warmup variants, then its steady ones, each recorded; on the card
    each steady step's CUDA API calls are counted as well."""
    from trlx_tpu_torch.analysis.census import api_counter
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.parallel import collectives as coll

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    census = Census(dev)
    warm_shapes: Set[Tuple] = set()
    for k in entry.warmup:
        with census:
            entry.step(k)
        warm_shapes |= census.step.shapes
    if cuda:
        torch.cuda.synchronize(dev)
    steady: List[_Step] = []
    peaks, launches, api, colls, staged = [], [], [], [], []
    for k in entry.steady:
        gc.collect()  # garbage of earlier steps (autograd cycles) freed now, not inside the step
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        before, table, stage = _kernels.launches(), coll.collective_table(), coll.staged()
        with census, (api_counter.counting() if cuda else contextlib.nullcontext({})) as calls:
            entry.step(k)
        colls.append(_table_delta(table, coll.collective_table()))
        staged.append({f: n - stage[f] for f, n in coll.staged().items()})
        if cuda:
            torch.cuda.synchronize(dev)
            peaks.append(torch.cuda.max_memory_allocated(dev) - base)
            api.append(calls)
        after = _kernels.launches()
        launches.append({n: after[n] - before[n] for n in after if after[n] != before[n]})
        steady.append(census.step)
    new_shapes = set().union(*(s.shapes for s in steady)) - warm_shapes
    out: Dict[str, Any] = {
        "ops": _same([s.ops for s in steady]),
        "heavy_f32": _same([s.heavy_f32 for s in steady]),
        "round_trips": _same([s.round_trips for s in steady]),
        "warmup_shapes": len(warm_shapes),
        "steady_new_shapes": len(new_shapes),
        "collectives": _same(colls),
        "staged": _same(staged),
    }
    if entry.optimizer is not None:
        out["state_bytes"] = optimizer_state_bytes(entry.optimizer)
    if cuda:
        out["kernel_launches"] = _same(launches)
        out["peak_bytes"] = max(peaks)
        for field in ("launches", "syncs", "memcpys", "graph_launches", "launch_apis", "runtime_launches"):
            out[field] = _same([c[field] for c in api])
    return out
