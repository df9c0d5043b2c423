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
from trlx_tpu_torch.parallel.sharding import PartitionSpec, make_param_specs, shard_tensor, spec_dim


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
    #: the host copy of an offloaded leaf (:meth:`ShardedParams.offload`)
    host: Optional[torch.Tensor] = None

    @property
    def sharded(self) -> bool:
        return self.fsdp_dim >= 0

    @property
    def offloaded(self) -> bool:
        """Held on the host only (not uploaded)."""
        return (self.host is not None and self.master.device == self.host.device
                and self.master.data_ptr() == self.host.data_ptr())


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
            if leaf.sharded and leaf.param.numel() == 0 and not leaf.offloaded:
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

    # -- host offload -------------------------------------------------------------

    def offload(self, prefix: str, pin: bool) -> int:
        """Hold the leaves named ``<prefix>.*`` (frozen ones: the offloaded
        reference) in host memory as this rank's blocks, pinned when
        ``pin``, and free their device copies; returns the host bytes."""
        for leaf in self._under(prefix):
            if leaf.host is None:
                src = leaf.master.data
                leaf.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=pin).copy_(src)
        self.release_upload(prefix)
        return sum(leaf.host.numel() * leaf.host.element_size() for leaf in self._under(prefix))

    def upload(self, prefix: str, device) -> None:
        """Copy the offloaded leaves under ``prefix`` to ``device`` (inside
        :meth:`gathered`, their fsdp shards are gathered at once)."""
        for leaf in self._under(prefix):
            if leaf.offloaded:
                leaf.master.data = leaf.host.to(device, non_blocking=True)
                if leaf.sharded and self._depth > 0:
                    leaf.param.data = coll.all_gather(leaf.master.data, self.fsdp, leaf.fsdp_dim)

    def release_upload(self, prefix: str) -> None:
        """Drop the device copies of the offloaded leaves under ``prefix``."""
        for leaf in self._under(prefix):
            leaf.master.data = leaf.host
            if leaf.sharded:
                leaf.param.data = leaf.param.data.new_empty(0)

    def _under(self, prefix: str) -> List[Leaf]:
        return [leaf for leaf in self.leaves if leaf.name.startswith(prefix + ".")]

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

    def full_state(self, names=None) -> Dict[str, torch.Tensor]:
        """``{name: full tensor}`` of every leaf, or of those in ``names``
        (a collective)."""
        return {leaf.name: self.full_tensor(leaf, leaf.master.data) for leaf in self.leaves
                if names is None or leaf.name in names}

    @torch.no_grad()
    def load_full_state(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copy this rank's blocks of full tensors into the masters (and the
        host copies of offloaded leaves)."""
        for leaf in self.leaves:
            if leaf.name in state:
                block = self.local_block(leaf, state[leaf.name])
                leaf.master.data.copy_(block.to(leaf.master.device))
                if leaf.host is not None and not leaf.offloaded:
                    leaf.host.copy_(block.to(leaf.host.device))


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


class _FlatRanges:
    """Where the whole leaf's flat ranges lie in its fsdp shards, for a leaf
    sharded over ``fsdp`` on dim ``d`` whose 8-bit blocks split over
    ``fsdp``: member ``q`` owns whole-leaf elements ``[lo_q, hi_q)``, and
    member ``r`` holds the fsdp shard ``T_r`` (the leaf narrowed on ``d``,
    whole over the other axes). Viewing the leaf as ``[outer, D * inner]``,
    ``T_r`` is the column window ``[r c, (r + 1) c)`` (``c = D / f *
    inner``), and an element's whole index grows with its place in
    ``T_r``'s flat order, so the elements of ``T_r`` that fall in ``[lo_q,
    hi_q)`` are one run of ``T_r``'s flat order: ``counts[r][q]`` long, and
    the runs of ``r`` for ``q = 0, 1, ...`` follow each other. Moving a
    shard to its ranges is then one all-to-all of ``T_r`` as it lies."""

    def __init__(self, shape: Tuple[int, ...], d: int, ranges: List[Tuple[int, int]]):
        f = len(ranges)
        inner = int(np.prod(shape[d + 1:]))
        self.row, self.c, self.f, self.ranges = shape[d] * inner, shape[d] // f * inner, f, ranges

        def before(r, x):  # elements of T_r whose whole index is below x
            return (x // self.row) * self.c + min(max(x % self.row - r * self.c, 0), self.c)

        self.counts = [[before(r, hi) - before(r, lo) for lo, hi in ranges] for r in range(f)]
        #: the first of T_r's elements in member q's range, counted from the first row q's range touches
        self.offsets = [[before(r, lo) - (lo // self.row) * self.c for lo, _ in ranges] for r in range(f)]
        #: each range is its member's shard, in the same order: no exchange
        self.aligned = all(self.counts[r][q] == 0 for r in range(f) for q in range(f) if q != r)

    def _rows(self, q: int) -> Tuple[int, int, int]:
        lo, hi = self.ranges[q]
        first = lo // self.row
        return first, (hi - 1) // self.row - first + 1, lo - first * self.row

    def to_range(self, shard: torch.Tensor, group) -> torch.Tensor:
        """This member's range of the whole leaf from the members' shards
        (``shard``: this member's ``T``)."""
        q = group.index
        flat = shard.reshape(-1)
        if self.aligned:
            return flat
        got = coll.all_to_all_flat(flat, group, self.counts[q], [self.counts[r][q] for r in range(self.f)])
        _, nrows, start = self._rows(q)
        rows = flat.new_empty(nrows, self.row)
        window = flat.new_empty(nrows * self.c)
        for r, piece in enumerate(got.split([self.counts[r][q] for r in range(self.f)])):
            window[self.offsets[r][q]:self.offsets[r][q] + piece.numel()] = piece
            rows[:, r * self.c:(r + 1) * self.c] = window.view(nrows, self.c)
        lo, hi = self.ranges[q]
        return rows.view(-1)[start:start + hi - lo]

    def to_shard(self, rng: torch.Tensor, group, shape) -> torch.Tensor:
        """The inverse of :meth:`to_range`: this member's shard (``shape``)
        from every member's range."""
        q = group.index
        if self.aligned:
            return rng.reshape(shape)
        _, nrows, start = self._rows(q)
        rows = rng.new_empty(nrows, self.row)
        rows.view(-1)[start:start + rng.numel()] = rng
        pieces = [rows[:, r * self.c:(r + 1) * self.c].reshape(-1)[self.offsets[r][q]:self.offsets[r][q]
                                                                  + self.counts[r][q]] for r in range(self.f)]
        back = coll.all_to_all_flat(torch.cat(pieces), group, [self.counts[r][q] for r in range(self.f)],
                                    self.counts[q])
        return back.reshape(shape)


class _BlockLayout:
    """A leaf held as blocks, as :class:`~trlx_tpu_torch.utils.optim.
    Adafactor` reads it: ``shape`` is the whole leaf's, and :meth:`sum`
    completes a partial sum of this rank's block over the ranks that hold
    the leaf's other blocks along ``dim`` (along every dim when None)."""

    def __init__(self, leaf: Leaf, mesh: Mesh):
        self.shape = full_shape(leaf, mesh)
        self.groups = {}
        for axis in split_axes(leaf):
            d = leaf.fsdp_dim if axis == FSDP_AXIS else spec_dim(leaf.spec, axis)
            self.groups.setdefault(d, []).append(mesh.group(axis))

    def sum(self, x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        groups = [g for d, gs in self.groups.items() for g in gs] if dim is None else self.groups.get(dim, [])
        for g in groups:
            x = coll.all_reduce(x, g)
        return x


class WholeLeafOptimizer:
    """An optimizer whose update of a leaf reads the whole leaf (8-bit
    Adam(W)'s blocks of :data:`~trlx_tpu_torch.ops.quantized_adam.BLOCK`
    elements of the flattened leaf, Adafactor's factoring by the leaf's
    shape, its row / column means and its RMS clips and scales) run over
    leaves held as blocks (fsdp shards, ``model`` / ``pipe`` slices), with
    the numbers of the unsharded formula, as the JAX package's GSPMD step
    computes them. ``make(params, **kwargs)`` builds the inner optimizer
    (``optimizer``, which the schedule drives).

    - ``blockwise`` (8-bit): the inner optimizer runs over one proxy per
      leaf, this rank's contiguous range of the whole leaf's blocks. The
      block dim shards over ``fsdp`` where the block count divides it (the
      JAX state rule, :func:`~trlx_tpu_torch.parallel.sharding.
      make_state_shardings`), else every rank holds every block. A step
      gathers the gradient and the parameter over ``model`` / ``pipe``
      (where the leaf is split there), moves them from the fsdp shards to
      the ranges with one all-to-all over ``fsdp`` each (:class:`_FlatRanges`:
      a rank sends only the elements of its shard that lie in another's
      range; nothing where the ranges are the shards), steps, and moves the
      updated ranges back. Leaves that are not fsdp-sharded take their range
      locally; where the blocks do not split, every rank gathers the whole
      leaf. The proxies hold data only inside a step;
    - otherwise (Adafactor): the inner optimizer runs over the masters,
      told each sharded leaf's :class:`_BlockLayout`: it factors by the
      whole shape, and its row / column means and its sums of squares are
      partial sums all-reduced over the axes the leaf is split on. Its state
      is this rank's block of the whole-leaf state."""

    def __init__(self, make: Callable, leaves: List[Leaf], shards: "ShardedParams", blockwise: bool, **kwargs):
        from trlx_tpu_torch.ops.quantized_adam import BLOCK

        self.leaves, self.shards, self.blockwise = leaves, shards, blockwise
        mesh, f = shards.mesh, shards.fsdp.size
        self.ranges, self.block_sharded, self.flat = [], [], []
        if not blockwise:
            self.proxies = [leaf.master for leaf in leaves]
            self.optimizer = make(self.proxies, **kwargs)
            self.optimizer.layouts = {leaf.master: _BlockLayout(leaf, mesh) for leaf in leaves if split_axes(leaf)}
            self.block_sharded = [False] * len(leaves)
            return
        self.proxies = []
        for leaf in leaves:
            shape = full_shape(leaf, mesh)
            n = int(np.prod(shape))
            nb = -(-n // BLOCK)
            split = f > 1 and nb % f == 0
            bounds = [(i * (nb // f) * BLOCK, min((i + 1) * (nb // f) * BLOCK, n)) for i in range(f)] if split \
                else [(0, n)]
            own = bounds[shards.fsdp.index] if split else bounds[0]
            self.ranges.append(own + ((nb // f if split else nb) * BLOCK,))
            self.block_sharded.append(split)
            # the exchange where the fsdp dim is the leaf's own (not shared with model or pipe)
            fdim = leaf.fsdp_dim
            alone = fdim >= 0 and all(spec_dim(leaf.spec, a) != fdim for a in (MODEL_AXIS, PIPE_AXIS))
            self.flat.append(_FlatRanges(shape, fdim, bounds) if split and alone else None)
            # the proxies hold data only inside a step
            self.proxies.append(torch.nn.Parameter(leaf.master.new_empty(0), requires_grad=False))
        self.optimizer = make(self.proxies, **kwargs)

    def _over_model(self, leaf: Leaf, x: torch.Tensor) -> torch.Tensor:
        """``x`` (the master's shape) gathered over ``model`` and ``pipe``."""
        for axis in (MODEL_AXIS, PIPE_AXIS):
            d = spec_dim(leaf.spec, axis)
            if d >= 0:
                x = coll.all_gather(x, self.shards.mesh.group(axis), d)
        return x

    @torch.no_grad()
    def step(self) -> None:
        if not self.blockwise:
            self.optimizer.step()
            return
        sh = self.shards
        for leaf, proxy, rng, flat in zip(self.leaves, self.proxies, self.ranges, self.flat):
            g = leaf.master.grad if leaf.master.grad is not None else torch.zeros_like(leaf.master)
            if flat is not None:
                proxy.data = flat.to_range(self._over_model(leaf, leaf.master.data), sh.fsdp).clone()
                proxy.grad = flat.to_range(self._over_model(leaf, g), sh.fsdp).clone()
                continue
            if leaf.sharded:
                full_g, full_p = sh.full_tensor(leaf, g), sh.full_tensor(leaf, leaf.master.data)
            else:
                full_g, full_p = self._over_model(leaf, g), self._over_model(leaf, leaf.master.data)
            proxy.data = full_p.reshape(-1)[rng[0]:rng[1]].clone()
            proxy.grad = full_g.reshape(-1)[rng[0]:rng[1]].clone()
        self.optimizer.step()
        model_axes = [MODEL_AXIS, PIPE_AXIS]
        for leaf, proxy, rng, split, flat in zip(self.leaves, self.proxies, self.ranges, self.block_sharded,
                                                 self.flat):
            shape = full_shape(leaf, sh.mesh)
            if flat is not None:
                fshape = list(shape)
                fshape[leaf.fsdp_dim] //= sh.fsdp.size
                new = flat.to_shard(proxy.data, sh.fsdp, fshape)
                new = shard_tensor(new, leaf.spec, sh.mesh, model_axes)
            else:
                whole = proxy.data
                if split:
                    whole = coll.all_gather(torch.nn.functional.pad(whole, (0, rng[2] - whole.numel())), sh.fsdp, 0)
                new = sh.local_block(leaf, whole[:int(np.prod(shape))].reshape(shape))
            leaf.master.data.copy_(new)
            proxy.grad = leaf.master.grad = None
            proxy.data = proxy.data.new_empty(0)

    def _state_leaf(self, index: int, key: str) -> Optional[Leaf]:
        """The layout of Adafactor's state ``key`` of leaf ``index`` as a
        :class:`Leaf` (its spec without the dim a factored moment
        reduces), or None where the state is not laid out as its leaf."""
        from trlx_tpu_torch.utils.optim import factored_dims

        leaf = self.leaves[index]
        if self.blockwise or not split_axes(leaf):
            return None
        if key in ("v_row", "v_col"):
            group = self.optimizer.param_groups[0]
            d1, d0 = factored_dims(full_shape(leaf, self.shards.mesh), group["factored"],
                                   group["min_dim_size_to_factor"])
            drop = d0 if key == "v_row" else d1
            spec = PartitionSpec(*[e for i, e in enumerate(leaf.spec) if i != drop])
            fdim = fsdp_shard_dim(spec) if leaf.sharded else -1
            return Leaf(leaf.name, leaf.param, spec, fdim, leaf.master, ())
        return leaf

    def gather_state(self, index: int, key: str, v):
        """A state tensor of leaf ``index`` as one rank holds it whole (the
        checkpoint payload): 8-bit blocks concatenated over ``fsdp`` when
        split, Adafactor's blocks gathered as their leaf's."""
        if not torch.is_tensor(v) or not v.dim():
            return v
        if self.blockwise:
            return coll.all_gather(v, self.shards.fsdp, 0) if self.block_sharded[index] else v
        layout = self._state_leaf(index, key)
        return self.shards.full_tensor(layout, v) if layout is not None else v

    def scatter_state(self, index: int, key: str, v):
        """The inverse of :meth:`gather_state` (a checkpoint load)."""
        if not torch.is_tensor(v) or not v.dim():
            return v
        if self.blockwise:
            return coll.local_slice(v, self.shards.fsdp, 0).clone() if self.block_sharded[index] else v
        layout = self._state_leaf(index, key)
        return self.shards.local_block(layout, v).clone() if layout is not None else v


def full_shape(leaf: Leaf, mesh: Mesh) -> Tuple[int, ...]:
    """The whole shape of a leaf whose master is its block."""
    shape = list(leaf.master.shape)
    for axis in split_axes(leaf):
        shape[spec_dim(leaf.spec, axis)] *= mesh.shape[axis]
    return tuple(shape)


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
