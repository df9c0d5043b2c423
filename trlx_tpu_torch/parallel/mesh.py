"""The device mesh over ``torch.distributed`` ranks (counterpart of
``trlx_tpu/parallel/mesh.py``) and the island carve.

The JAX package runs one SPMD program over a ``jax.sharding.Mesh`` with
axes ``("data", "fsdp", "pipe", "model")``; the port runs one process per
mesh position. Rank ``r`` sits at the row-major coordinates of ``r`` over
the four axis sizes, so the batch shard a rank holds (its index over
``("data", "fsdp")``, data major) is the one the JAX ``put_batch`` places
on the device with the same coordinates. :class:`Mesh` keeps one process
group per axis set the collectives need.

- ``data``: pure data parallelism (gradients summed over the axis);
- ``fsdp``: parameters and optimizer state sharded (ZeRO), gathered before
  use, gradients reduce-scattered;
- ``model``: tensor parallelism (column / row parallel layers, Megatron),
  and the sequence dimension over the same ranks (``mesh.sequence_shard``,
  ring attention);
- ``pipe``: pipeline stages (a stacked trunk's layers split in ``pipe``
  contiguous blocks, the GPipe schedule of
  :func:`~trlx_tpu_torch.parallel.pipeline.pipeline_apply`).

Launch contract, as the JAX package's: ``TRLX_NUM_PROCESSES``,
``TRLX_COORDINATOR`` (``host:port``, the ``tcp://`` rendezvous) and
``TRLX_PROCESS_ID``. A rank's device is ``cuda:<rank % device_count>``;
the backend is NCCL when every rank has a card of its own, gloo on the CPU
and when ranks share a card.
"""

import datetime
import os
import socket
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, PIPE_AXIS, MODEL_AXIS)
# batch dims are sharded over both data axes (data + fsdp act as one data axis for inputs)
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)
#: the axis sets a process group is built for (every rank builds them all, in this order)
GROUP_AXES = ((DATA_AXIS,), (FSDP_AXIS,), (MODEL_AXIS,), (PIPE_AXIS,), BATCH_AXES, MESH_AXES)

#: seconds a rank waits for the rendezvous and for each collective
DEFAULT_TIMEOUT_S = 600.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def choose_backend(world_size: int, device=None) -> str:
    """``nccl`` when the ranks run on CUDA and each has a card of its own
    (``world_size <= device_count``), else ``gloo`` (the CPU, or ranks that
    share a card: NCCL refuses two ranks on one device)."""
    dev = torch.device(device) if device is not None else None
    on_cuda = torch.cuda.is_available() and (dev is None or dev.type == "cuda")
    if on_cuda and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int) -> torch.device:
    """``cuda:<rank % device_count>``."""
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(coordinator_address: Optional[str] = None, device=None) -> None:
    """Join the process group the ``TRLX_*`` environment describes
    (``TRLX_NUM_PROCESSES`` + ``TRLX_COORDINATOR`` + ``TRLX_PROCESS_ID``).
    A no-op when none of them is set or the group already exists. ``device``
    is the device the caller will run on (``"cpu"`` takes gloo).

    A rank that cannot reach the coordinator raises after
    ``TRLX_DIST_TIMEOUT_S`` seconds (default 600), naming the address."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    num_processes = os.environ.get("TRLX_NUM_PROCESSES")
    coordinator_address = coordinator_address or os.environ.get("TRLX_COORDINATOR")
    if not (coordinator_address or num_processes):
        return
    world = int(num_processes) if num_processes else 1
    rank = int(os.environ.get("TRLX_PROCESS_ID", "0"))
    if not coordinator_address:
        if world > 1:
            raise ValueError("TRLX_NUM_PROCESSES > 1 needs TRLX_COORDINATOR (host:port)")
        coordinator_address = f"127.0.0.1:{_free_port()}"
    if not 0 <= rank < world:
        raise ValueError(f"TRLX_PROCESS_ID={rank} outside [0, {world})")
    backend = choose_backend(world, device)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(rank))
    timeout = float(os.environ.get("TRLX_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S))
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout),
        )
    except Exception as e:
        raise RuntimeError(
            f"rank {rank}/{world} could not join the process group at coordinator "
            f"{coordinator_address} ({backend}) within {timeout:.0f}s: {e}"
        ) from e
    logger.info(f"torch.distributed initialized: rank {rank}/{world}, backend {backend}, "
                f"coordinator {coordinator_address}", ranks=[-1])


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def backend_name() -> Optional[str]:
    import torch.distributed as dist

    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


class AxisGroup(NamedTuple):
    """The process group of one axis set as seen from this rank: ``pg``
    (None when the set has size 1: every collective over it is a no-op),
    its ``size``, this rank's ``index`` in it (row-major over the set) and
    its ``label``: the set's axes of size > 1 joined with ``+`` in
    :data:`MESH_AXES` order, as the reference's collective census names a
    replica group (``data+fsdp`` for the world of ``data=2 x fsdp=2``)."""

    pg: object
    size: int
    index: int
    axes: Tuple[str, ...]
    label: str = ""

    def __deepcopy__(self, memo):
        # a process group is not copied: a copied module (the bf16 rollout
        # copy) shares its layers' groups
        return self


class Mesh:
    """``data × fsdp × pipe × model`` over the world's ranks, or over the
    world ranks ``ranks`` (an island: mesh position ``i`` is world rank
    ``ranks[i]``).

    ``shape`` maps each axis to its size, ``rank`` is this process's mesh
    position and ``coords`` its coordinates (``member`` False, ``rank``
    None and no coordinates for a process outside ``ranks``); :meth:`group`
    gives the :class:`AxisGroup` of an axis set."""

    def __init__(self, sizes: Sequence[int], rank: Optional[int] = 0, device=None,
                 ranks: Optional[Sequence[int]] = None):
        self.shape: Dict[str, int] = dict(zip(MESH_AXES, (int(s) for s in sizes)))
        self.size = int(np.prod(sizes))
        self.ranks = tuple(range(self.size)) if ranks is None else tuple(int(r) for r in ranks)
        self.member = rank is not None
        self.rank = int(rank) if self.member else None
        self.coords: Dict[str, int] = (
            dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(rank, tuple(sizes))))) if self.member else {})
        self.device = device
        self._groups: Dict[Tuple[str, ...], AxisGroup] = {}

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (``("data", "fsdp")``:
        its batch shard)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def ranks_with(self, fixed: Dict[str, int]) -> Sequence[int]:
        """Every rank whose coordinates equal ``fixed`` on its axes, in rank order."""
        sizes = [self.shape[a] for a in MESH_AXES]
        out = []
        for r in range(self.size):
            c = dict(zip(MESH_AXES, np.unravel_index(r, sizes)))
            if all(c[a] == v for a, v in fixed.items()):
                out.append(r)
        return out

    def build_groups(self) -> None:
        """Create the process groups of :data:`GROUP_AXES` (a collective
        call: every rank of the world, member or not, builds every group in
        the same order)."""
        import torch.distributed as dist

        whole_world = self.ranks == tuple(range(process_count()))
        for axes in GROUP_AXES:
            size = self.axis_size(axes)
            others = [a for a in MESH_AXES if a not in axes]
            mine = None
            if size > 1:
                # one group per setting of the other axes, all built everywhere
                for fixed in np.ndindex(*[self.shape[a] for a in others]):
                    members = self.ranks_with(dict(zip(others, fixed)))
                    world = [self.ranks[m] for m in members]
                    pg = dist.group.WORLD if size == self.size and whole_world else dist.new_group(world)
                    if self.rank in members:
                        mine = pg
            label = "+".join(a for a in MESH_AXES if a in axes and self.shape[a] > 1)
            self._groups[axes] = AxisGroup(mine, size, self.axis_index(axes) if self.member else 0, axes, label)

    def group(self, axes) -> AxisGroup:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes not in self._groups:
            raise KeyError(f"no process group over {axes}: built for {list(self._groups)}")
        return self._groups[axes]

    @property
    def pipe_group(self) -> AxisGroup:
        return self.group(PIPE_AXIS)

    @property
    def stage(self) -> int:
        """This rank's pipeline stage (its ``pipe`` coordinate)."""
        return self.coords[PIPE_AXIS]

    def stage_rank(self, stage: int) -> int:
        """The world rank of pipeline stage ``stage`` at this rank's other
        coordinates (the previous and next stages' ranks: ``stage -+ 1``)."""
        return self.ranks_with({**{a: self.coords[a] for a in MESH_AXES if a != PIPE_AXIS}, PIPE_AXIS: stage})[0]

    @property
    def batch_group(self) -> AxisGroup:
        return self.group(BATCH_AXES)

    @property
    def world_group(self) -> AxisGroup:
        return self.group(MESH_AXES)


def make_mesh(data: int = -1, fsdp: int = 1, model: int = 1, pipe: int = 1, world_size: Optional[int] = None,
              rank: Optional[int] = None, device=None, build_groups: bool = True,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The ``data × fsdp × pipe × model`` mesh over ``world_size`` ranks
    (default: the process group's), or over the world ranks ``ranks`` (an
    island; this process's position is its index there, and a process
    outside it is no member). At most one axis may be -1, inferred from the
    rank count; the product must equal it (the JAX function's checks, with
    ranks for devices)."""
    if ranks is not None:
        ranks = [int(r) for r in ranks]
        n = len(ranks)
        me = process_index() if rank is None else int(rank)
        rank = ranks.index(me) if me in ranks else None
    else:
        n = process_count() if world_size is None else int(world_size)
        rank = process_index() if rank is None else int(rank)
    sizes = [data, fsdp, pipe, model]
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    if len(unknown) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {sizes}")
    if unknown:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known != 0:
            raise ValueError(f"Device count {n} not divisible by fixed axes {sizes}")
        sizes[unknown[0]] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"Mesh {sizes} does not match device count {n}")
    mesh = Mesh(sizes, rank, device, ranks)
    if build_groups:
        if n > 1:
            mesh.build_groups()
        else:
            mesh._groups = {axes: AxisGroup(None, 1, 0, axes) for axes in GROUP_AXES}
    logger.info(f"Mesh: data={sizes[0]} fsdp={sizes[1]} pipe={sizes[2]} model={sizes[3]} over {n} ranks")
    return mesh


def mesh_from_config(mesh_config, device=None) -> Mesh:
    """The mesh of a :class:`~trlx_tpu_torch.data.configs.MeshConfig` over the process group."""
    return make_mesh(data=mesh_config.data, fsdp=mesh_config.fsdp, model=mesh_config.model,
                     pipe=mesh_config.pipe, device=device)


def batch_spec(extra_dims: int = 0) -> Tuple:
    """The partition of a batch-leading array: dim 0 over the combined data
    axes (replicated over ``pipe`` and ``model``)."""
    return (BATCH_AXES,) + (None,) * extra_dims


def dp_size(mesh: Mesh) -> int:
    """Total data-parallel degree (data × fsdp)."""
    return mesh.shape[DATA_AXIS] * mesh.shape[FSDP_AXIS]


def local_rows(mesh: Mesh, n: int) -> Optional[slice]:
    """The rows of an ``n``-row global batch this rank holds, or None when
    ``n`` does not split over the data axes (the batch is then replicated)."""
    dp = dp_size(mesh)
    if n % dp:
        return None
    m = n // dp
    c = mesh.axis_index(BATCH_AXES)
    return slice(c * m, (c + 1) * m)


def batch_rows(batch) -> int:
    """The row count of a batch: a dataclass (its first field) or a dict."""
    import dataclasses

    first = getattr(batch, dataclasses.fields(batch)[0].name) if dataclasses.is_dataclass(batch) else next(
        iter(batch.values()))
    return len(first)


def put_batch(mesh: Mesh, batch):
    """This rank's rows of a host-global batch (every rank holds the whole
    batch, from identical data loading): a leaf whose leading dim splits
    over ``data × fsdp`` keeps its shard, others stay whole (replicated),
    as the JAX function places them. ``batch`` is an array or a dict of
    arrays."""

    def put(x):
        if np.ndim(x) == 0:
            return x
        sl = local_rows(mesh, len(x))
        return x if sl is None else x[sl]

    if isinstance(batch, dict):
        return type(batch)({k: put(v) for k, v in batch.items()})
    return put(batch)


class IslandPlacement(NamedTuple):
    """Device carve for the Sebulba split: which devices host the generation
    island (serving engine) and which host the learner island (PPO train
    step). ``shared`` marks the single-device degenerate case where both
    islands are thread-level tenants of one device."""

    gen: Tuple
    learn: Tuple
    shared: bool


def carve_islands(gen_devices: int = 1, devices: Optional[Sequence] = None) -> IslandPlacement:
    """Carve the flat device list into disjoint generation and learner islands.

    ``devices`` defaults to every CUDA device (``cuda:0`` ..
    ``cuda:<device_count() - 1>``). The generation island takes the *last*
    ``gen_devices`` devices and the learner keeps the lowest-index prefix, so
    the learner's devices lay out as a smaller single-island run's would.
    With a single device both islands share it (thread-level islands, the
    CPU-test and single-card topology); with more, the carve is strictly
    disjoint.
    """
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    g = int(gen_devices)
    if g < 1:
        raise ValueError(f"gen_devices must be >= 1, got {g}")
    if n == 0:
        raise ValueError("carve_islands needs at least one device; pass devices=[...] without CUDA")
    if n == 1:
        return IslandPlacement((devices[0],), (devices[0],), True)
    if g >= n:
        raise ValueError(
            f"gen_devices={g} leaves no learner devices out of {n}: the carve "
            f"needs at least one device per island"
        )
    return IslandPlacement(tuple(devices[n - g:]), tuple(devices[:n - g]), False)


def _island_rank(member) -> int:
    """A carve member as a world rank: a rank, or a card (``cuda:i`` is
    rank ``i``'s device when each rank has its own card)."""
    return int(member.index) if isinstance(member, torch.device) else int(member)


def island_meshes(placement: IslandPlacement, data: int = -1, fsdp: int = 1, model: int = 1, pipe: int = 1,
                  rank: Optional[int] = None, build_groups: bool = True) -> Tuple[Mesh, Mesh]:
    """``(gen_mesh, learn_mesh)`` over a carve from :func:`carve_islands`
    (the JAX function's layout, with ranks for devices): the generation
    mesh is pure ``data`` over the generation island's ranks, the learner
    mesh the requested ``data × fsdp × pipe × model`` over the learner
    island's. Each mesh's process groups hold its own ranks only; every
    rank of the world calls this (the groups are built collectively), and
    is a member of one mesh (of both when the carve is ``shared``)."""
    gen = [_island_rank(d) for d in placement.gen]
    learn = [_island_rank(d) for d in placement.learn]
    gen_mesh = make_mesh(data=len(gen), fsdp=1, model=1, pipe=1, ranks=gen, rank=rank, build_groups=build_groups)
    learn_mesh = make_mesh(data=data, fsdp=fsdp, model=model, pipe=pipe, ranks=learn, rank=rank,
                           build_groups=build_groups)
    return gen_mesh, learn_mesh
