"""ZeRO parameter storage over the ``fsdp`` axis, and the overlapped FSDP
train step ``train.learner_overlap`` (counterpart of
``trlx_tpu/parallel/fsdp.py``).

:class:`ShardedParams` holds the parameters of a trainer's modules the way
the JAX rules place them: a leaf whose spec names ``fsdp`` keeps only this
rank's shard (``master``, what the optimizer updates), and the module's
parameter is empty between uses; :meth:`ShardedParams.gathered` all-gathers
every such leaf for a forward and frees them after. Leaves sharded over
``model`` are already this rank's slice (:func:`~trlx_tpu_torch.parallel.
sharding.apply_mesh`), and so are a stacked trunk's leaves over ``pipe``
(this stage's layers); the fsdp shard is cut from that block on the dim
the rule names, so the gathers and reduce-scatters work per stage. The
gradient of a full leaf reaches its master through
:meth:`ShardedParams.reduce_grads`: reduce-scatter over ``fsdp``,
all-reduce over ``data``; nothing is summed over ``pipe`` (each stage's
layers are its own, and the leaves whole over ``pipe`` get the same whole
gradient on every stage: :mod:`~trlx_tpu_torch.parallel.pipeline`).

The overlapped step (:func:`make_overlapped_grad_accum_step`) is the
reference's explicit schedule:

- each unit's leaves (a block, an embedding, a head) are all-gathered one
  unit ahead of the forward that needs them, asynchronously (on NCCL's own
  stream; the forward waits on the work's event), and re-gathered per
  microbatch;
- each sharded leaf's gradient is reduce-scattered as the backward reaches
  it (a post-accumulate hook), into a shard-sized accumulation carry;
- the optimizer (AdamW, or 8-bit AdamW with blocks inside the local shard)
  updates the local shard only, after the shard-aware global-norm clip.

As in the reference, the overlapped step's batch statistics are local to
each rank's microbatch (``fsdp.py:38-43`` there): the loss runs with no
batch group, and microbatch ``k`` of rank ``r`` is the ``k``-th slice of
``r``'s shard of the batch.
"""

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.parallel import collectives as coll
from trlx_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    DATA_AXIS,
    FSDP_AXIS,
    MESH_AXES,
    MODEL_AXIS,
    PIPE_AXIS,
    Mesh,
    batch_rows,
)
from trlx_tpu_torch.parallel.sharding import PartitionSpec, make_param_specs, spec_dim


def can_overlap(mesh: Mesh) -> bool:
    """Whether the overlapped step applies: the reference's shard_map body
    computes the whole model per device, so ``model`` and ``pipe`` must be 1."""
    return mesh.shape.get(MODEL_AXIS, 1) == 1 and mesh.shape.get(PIPE_AXIS, 1) == 1


def fsdp_shard_dim(spec: PartitionSpec) -> int:
    """Dim of ``spec`` sharded over ``fsdp``, or -1 (replicated over fsdp)."""
    return spec_dim(spec, FSDP_AXIS)


def overlap_batch_divisible(mesh: Mesh, batch_size: int, num_mb: int) -> bool:
    """Whether ``batch_size`` splits evenly into per-rank microbatches."""
    dp = int(np.prod([mesh.shape.get(a, 1) for a in BATCH_AXES]))
    return batch_size % (dp * num_mb) == 0


@dataclass
class Leaf:
    """One parameter under the mesh: its module parameter, its spec (over
    the full shape), its fsdp shard dim (-1: whole on every fsdp rank) and
    ``master`` (the tensor the optimizer updates: the shard, or the
    parameter itself); ``full_shape`` is the parameter's shape when
    gathered (this rank's slice over ``model``)."""

    name: str
    param: torch.nn.Parameter
    spec: PartitionSpec
    fsdp_dim: int
    master: torch.nn.Parameter
    full_shape: Tuple[int, ...]

    @property
    def sharded(self) -> bool:
        return self.fsdp_dim >= 0


@dataclass
class OverlapSpecs:
    """What the overlapped step knows of the layouts: per-parameter specs
    and fsdp shard dims, and the specs of the optimizer state (moments take
    their parameter's; 8-bit blocks shard over ``fsdp`` when their parameter
    does; scalars replicate)."""

    param_specs: Dict[str, PartitionSpec]
    shard_dims: Dict[str, int]
    state_specs: Dict[str, PartitionSpec]


def make_overlap_specs(params: Mapping[str, Any], mesh: Mesh, state_keys=("exp_avg", "exp_avg_sq"),
                       rules=None) -> OverlapSpecs:
    """:class:`OverlapSpecs` of a ``{name: tensor or shape}`` parameter map;
    the state paths are ``<key>/<param path>`` for moments and
    ``<param path>/<key>`` for quantized blocks, as
    :func:`~trlx_tpu_torch.parallel.sharding.make_state_shardings` reads them."""
    from trlx_tpu_torch.parallel.sharding import QUANT_LEAVES, flax_path

    specs = make_param_specs(params, mesh, rules)
    shard_dims = {n: fsdp_shard_dim(s) for n, s in specs.items()}
    state = {}
    for name, spec in specs.items():
        blocks = PartitionSpec(FSDP_AXIS) if shard_dims[name] >= 0 else PartitionSpec()
        for key in state_keys:
            if key in QUANT_LEAVES:
                state[f"{flax_path(name)}/{key}"] = blocks
            else:
                state[f"{key}/{flax_path(name)}"] = spec
    return OverlapSpecs(specs, shard_dims, state)


class ShardedParams:
    """The ZeRO storage of ``modules`` (``{prefix: module}``, parameters
    named ``<prefix>.<name>``) over ``mesh`` by ``specs`` (full shapes).
    Every rank starts from identical full (or model-sliced) parameters."""

    def __init__(self, modules: Mapping[str, torch.nn.Module], specs: Mapping[str, PartitionSpec], mesh: Mesh):
        self.mesh = mesh
        self.fsdp = mesh.group(FSDP_AXIS)
        self.data = mesh.group(DATA_AXIS)
        self.batch = mesh.batch_group
        self.leaves: List[Leaf] = []
        self.by_param: Dict[int, Leaf] = {}
        self._depth = 0
        for prefix, module in modules.items():
            for name, p in module.named_parameters():
                full = f"{prefix}.{name}" if prefix else name
                spec = specs[full]
                fdim = fsdp_shard_dim(spec) if self.fsdp.size > 1 else -1
                full_shape = tuple(p.shape)
                if fdim >= 0:
                    shard = coll.local_slice(p.data, self.fsdp, fdim).clone()
                    master = torch.nn.Parameter(shard, requires_grad=p.requires_grad)
                    p.data = p.data.new_empty(0)
                else:
                    master = p
                leaf = Leaf(full, p, spec, fdim, master, full_shape)
                self.leaves.append(leaf)
                self.by_param[id(p)] = leaf

    # -- gather / release -----------------------------------------------------

    def gather(self) -> None:
        for leaf in self.leaves:
            if leaf.sharded and leaf.param.numel() == 0:
                leaf.param.data = coll.all_gather(leaf.master.data, self.fsdp, leaf.fsdp_dim)

    def release(self) -> None:
        for leaf in self.leaves:
            if leaf.sharded:
                leaf.param.data = leaf.param.data.new_empty(0)
                leaf.param.grad = None

    @contextlib.contextmanager
    def gathered(self):
        """Every fsdp-sharded leaf whole for the enclosed code (nestable);
        freed when the outermost context exits."""
        if self._depth == 0:
            self.gather()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            if self._depth == 0:
                self.release()

    # -- gradients --------------------------------------------------------------

    def reduce_grads(self, scale: float = 1.0) -> None:
        """Move each trained leaf's full gradient (the sum of this rank's
        microbatch gradients) to its master, summed over the batch ranks and
        times ``scale``: sharded leaves reduce-scatter over ``fsdp`` then
        all-reduce over ``data``, the others all-reduce over ``data × fsdp``."""
        for leaf in self.leaves:
            if not leaf.master.requires_grad:
                continue
            g = leaf.param.grad
            if g is None:  # a trained leaf the loss does not reach steps with a zero gradient
                g = torch.zeros(leaf.full_shape, dtype=leaf.master.dtype, device=leaf.master.device)
            if leaf.sharded:
                g = coll.all_reduce(coll.reduce_scatter(g, self.fsdp, leaf.fsdp_dim), self.data)
                leaf.param.grad = None
            else:
                g = coll.all_reduce(g, self.batch)
            leaf.master.grad = g * scale if scale != 1.0 else g

    # -- full state <-> shards ---------------------------------------------------

    def full_tensor(self, leaf: Leaf, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor of a leaf-shaped local block (gathered over
        ``fsdp``, then ``model`` and ``pipe``): a collective."""
        out = local
        if leaf.sharded:
            out = coll.all_gather(out, self.fsdp, leaf.fsdp_dim)
        for axis in (MODEL_AXIS, PIPE_AXIS):
            d = spec_dim(leaf.spec, axis)
            if d >= 0:
                out = coll.all_gather(out, self.mesh.group(axis), d)
        return out

    def local_block(self, leaf: Leaf, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full tensor (the master's shape)."""
        from trlx_tpu_torch.parallel.sharding import shard_tensor

        return shard_tensor(full, leaf.spec, self.mesh, split_axes(leaf))

    def full_state(self) -> Dict[str, torch.Tensor]:
        """``{name: full tensor}`` of every leaf (a collective)."""
        return {leaf.name: self.full_tensor(leaf, leaf.master.data) for leaf in self.leaves}

    @torch.no_grad()
    def load_full_state(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copy this rank's blocks of full tensors into the masters."""
        for leaf in self.leaves:
            if leaf.name in state:
                leaf.master.data.copy_(self.local_block(leaf, state[leaf.name].to(leaf.master.device)))


def split_axes(leaf: Leaf) -> List[str]:
    """The axes a leaf's master is split over: ``model`` and ``pipe`` where
    its spec names them, ``fsdp`` where it is sharded."""
    axes = [a for a in (MODEL_AXIS, PIPE_AXIS) if spec_dim(leaf.spec, a) >= 0]
    return axes + ([FSDP_AXIS] if leaf.sharded else [])


def global_norm_sharded(leaves: List[Leaf], grads: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """``optax.global_norm`` over gradients held as shards: a leaf's squares
    count on the ranks whose coordinates are 0 on every axis the leaf is
    not split over (each element once), then one sum over the world."""
    dev = grads[0].device if grads else torch.device("cpu")
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for leaf, g in zip(leaves, grads):
        split = set(split_axes(leaf))
        if all(mesh.coords[a] == 0 for a in MESH_AXES if a not in split):
            total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(coll.all_reduce(total, mesh.world_group))


def _clip_by_global_norm_sharded(leaves: Optional[List[Leaf]], grads: List[torch.Tensor], mesh: Mesh,
                                 max_norm: float) -> torch.Tensor:
    """The reference's shard-aware clip: ``scale = 1`` below ``max_norm``,
    else ``max_norm / (norm + 1e-16)``, applied in place; returns the norm
    (over whole gradients when ``leaves`` is None: one rank)."""
    if leaves is None:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    else:
        norm = global_norm_sharded(leaves, grads, mesh)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / (norm + 1e-16))
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class _Prefetcher:
    """Per-unit all-gathers one unit ahead of the forward: forward
    pre-hooks on each unit wait for its leaves and start the next unit's
    gathers (async work; staged through the host on gloo with CUDA)."""

    def __init__(self, shards: ShardedParams, units: List[Tuple[torch.nn.Module, List[Leaf]]]):
        self.shards, self.units = shards, units
        self.pending: Dict[int, List] = {}
        self.handles = []

    def _start(self, i: int) -> None:
        if i >= len(self.units) or i in self.pending:
            return
        works = []
        for leaf in self.units[i][1]:
            if leaf.sharded and leaf.param.numel() == 0:
                works.append((leaf, coll.all_gather_async(leaf.master.data, self.shards.fsdp, leaf.fsdp_dim)))
        self.pending[i] = works

    def _finish(self, i: int) -> None:
        self._start(i)
        for leaf, work in self.pending.pop(i, []):
            if leaf.param.numel() == 0:
                leaf.param.data = work()

    def __enter__(self):
        for i, (module, _) in enumerate(self.units):
            def hook(mod, args, _i=i):
                self._finish(_i)
                self._start(_i + 1)
            self.handles.append(module.register_forward_pre_hook(hook))
        self._start(0)
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []
        for i in list(self.pending):
            self._finish(i)
        return False


def _units(module: torch.nn.Module, shards: ShardedParams) -> List[Tuple[torch.nn.Module, List[Leaf]]]:
    """The gather units in forward order: each transformer block with every
    leaf under it, and each other module with the leaves it owns directly."""
    from trlx_tpu_torch.models.transformer import Block

    units, claimed = [], set()
    for _, sub in module.named_modules():
        leaves = []
        for p in sub.parameters(recurse=isinstance(sub, Block)):
            leaf = shards.by_param.get(id(p))
            if leaf is not None and id(p) not in claimed:
                claimed.add(id(p))
                leaves.append(leaf)
        if leaves:
            units.append((sub, leaves))
    return units


def make_overlapped_grad_accum_step(trainer, loss_fn: Callable, num_mb: int) -> Callable:
    """The overlapped step for ``trainer`` (its ``model``, ``shards``,
    ``optimizer``, ``scheduler``, ``mesh``, ``trainable_params``):
    ``step(batch) -> stats``. The batch is the global one; this rank takes
    its shard, splits it into ``num_mb`` microbatches, and runs each with
    local statistics (the reference's shard_map semantics)."""
    mesh: Mesh = trainer.mesh
    shards: Optional[ShardedParams] = trainer.shards
    dp = mesh.axis_size(BATCH_AXES)
    batch_group = mesh.batch_group
    units = _units(trainer.model, shards) if shards is not None else []
    leaves = [shards.by_param[id(p)] for p in trainer._leaf_params] if shards is not None else None
    max_grad_norm = trainer.max_grad_norm

    def step(batch) -> Dict[str, float]:
        trainer._rollout_model = None
        B = batch_rows(batch)
        if not overlap_batch_divisible(mesh, B, num_mb):
            raise ValueError(f"learner_overlap: batch of {B} does not split into {dp} ranks x {num_mb} microbatches")
        local = batch.split(dp)[batch_group.index] if dp > 1 else batch
        params = trainer.trainable_params
        carry = [torch.zeros_like(p) for p in params]
        slot = {id(p): i for i, p in enumerate(params)}
        sharded = [False] * len(params)
        if shards is not None:
            for leaf in shards.leaves:
                if id(leaf.master) in slot:
                    sharded[slot[id(leaf.master)]] = leaf.sharded
        per_mb = []
        for mb in local.split(num_mb):
            pending = []
            hooks = []
            if shards is not None:
                for leaf in shards.leaves:
                    if leaf.sharded and leaf.master.requires_grad:
                        def on_grad(p, _leaf=leaf):
                            pending.append((_leaf, coll.reduce_scatter_async(p.grad, shards.fsdp, _leaf.fsdp_dim)))
                            p.grad = None
                        hooks.append(leaf.param.register_post_accumulate_grad_hook(on_grad))
            try:
                with (_Prefetcher(shards, units) if shards is not None else contextlib.nullcontext()):
                    loss, stats = loss_fn(mb)
                loss.backward()
            finally:
                for h in hooks:
                    h.remove()
            for leaf, wait in pending:
                carry[slot[id(leaf.master)]].add_(wait())
            for i, p in enumerate(params):
                if not sharded[i] and p.grad is not None:
                    carry[i].add_(p.grad)
                    p.grad = None
            if shards is not None:
                shards.release()
            per_mb.append({k: torch.as_tensor(v, dtype=torch.float32, device=trainer.device).detach()
                           for k, v in stats.items()})
        # sharded leaves: the fsdp members were summed by the reduce-scatter;
        # the others saw a distinct batch shard on each member
        grads = [coll.all_reduce(carry[i], shards.data if sharded[i] else batch_group) / (num_mb * dp)
                 for i in range(len(params))]
        if max_grad_norm:
            _clip_by_global_norm_sharded(leaves, grads, mesh, max_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        keys = list(per_mb[0])
        means = torch.stack([torch.stack([s[k] for s in per_mb]).mean() for k in keys])
        means = coll.all_reduce(means, batch_group) / dp
        lr = trainer.scheduler.get_last_lr()[0]
        trainer.optimizer.step()
        trainer.scheduler.step()
        trainer.optimizer.zero_grad(set_to_none=True)
        out = dict(zip(keys, means.tolist()))
        out["learning_rate_group_0"] = float(lr)
        return out

    return step
