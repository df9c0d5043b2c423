"""Parameter sharding: regex partition rules over ``/``-joined parameter
paths (counterpart of ``trlx_tpu/parallel/sharding.py``).

The rules are the JAX package's, matched against the port's ``state_dict``
names with ``.`` read as ``/`` (the port keeps the flax names and the flax
``kernel [in, out]`` layout, so each spec names the same dims). A spec is a
tuple with one entry per dim: None, an axis name, or a tuple of them.
``fsdp`` shards the largest matmul dim, ``model`` the feature dims of the
column / row parallel layers; :func:`_clip_spec` drops an axis that does not
divide its dim (gpt2's 50,257-row embedding stays whole over ``model``).

:func:`shard_tensor` cuts a rank's block out of a full tensor by its spec,
and :func:`apply_mesh` turns a module's ``model``- and ``pipe``-sharded
leaves into the rank's blocks (a stacked trunk keeps its stage's layers),
switches its layers to their column / row parallel forwards and gives its
trunks their pipeline stage (:mod:`trlx_tpu_torch.models.transformer`).

The sequence dimension (Megatron-SP, ``mesh.sequence_shard``):
:func:`constrain_seq` scatters an activation's sequence dim over ``model``
(this rank keeps ``T / model`` rows; the backward all-gathers) and
:func:`constrain_gathered` gathers it back before the heads (the backward
keeps the local rows). Both keep the JAX functions' no-op conditions: no
group (no mesh, or ``model == 1``), ``T % model != 0``, or a batch that
does not divide the batch axes (:func:`replicated_batch`: the trainer
keeps such a batch whole on every rank). Inside
:func:`sequence_parallel` the layers know their residual stream is
sharded: column-parallel layers gather ``T`` in front, row-parallel layers
reduce-scatter over ``T`` instead of all-reducing.
"""

import contextlib
import re
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from trlx_tpu_torch.parallel.mesh import BATCH_AXES, FSDP_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh


class PartitionSpec(tuple):
    """One entry per leading dim: None, an axis name or a tuple of axis
    names (``jax.sharding.PartitionSpec``'s shape)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


# A rule: (path regex, PartitionSpec). First match wins.
Rule = Tuple[str, PartitionSpec]


def default_lm_rules() -> List[Rule]:
    """The JAX package's partition rules for the LM, its heads and T5:
    column-parallel q/k/v/up/gate, row-parallel o/down, embeddings on vocab
    over ``model``, ``fsdp`` on the other matmul dim, value / Q heads column
    -> row over ``model``, norms and biases of row-parallel layers
    replicated; the stacked-layer rules first (their ``pipe`` entry is
    dropped on a mesh whose pipe axis is 1)."""
    stacked = [
        (r".*layers_scan.*(q_proj|k_proj|v_proj|up_proj|gate_proj)/kernel$",
         PartitionSpec(PIPE_AXIS, FSDP_AXIS, MODEL_AXIS)),
        (r".*layers_scan.*(q_proj|k_proj|v_proj|up_proj|gate_proj)/bias$",
         PartitionSpec(PIPE_AXIS, MODEL_AXIS)),
        (r".*layers_scan.*(o_proj|down_proj)/kernel$",
         PartitionSpec(PIPE_AXIS, MODEL_AXIS, FSDP_AXIS)),
        (r".*layers_scan.*", PartitionSpec(PIPE_AXIS)),
    ]
    return stacked + [
        (r".*embed_tokens/embedding$", PartitionSpec(MODEL_AXIS, FSDP_AXIS)),
        (r".*embed_positions/embedding$", PartitionSpec(None, FSDP_AXIS)),
        (r".*(q_proj|k_proj|v_proj)/kernel$", PartitionSpec(FSDP_AXIS, MODEL_AXIS)),
        (r".*(q_proj|k_proj|v_proj)/bias$", PartitionSpec(MODEL_AXIS)),
        (r".*o_proj/kernel$", PartitionSpec(MODEL_AXIS, FSDP_AXIS)),
        (r".*(up_proj|gate_proj)/kernel$", PartitionSpec(FSDP_AXIS, MODEL_AXIS)),
        (r".*(up_proj|gate_proj)/bias$", PartitionSpec(MODEL_AXIS)),
        (r".*down_proj/kernel$", PartitionSpec(MODEL_AXIS, FSDP_AXIS)),
        (r".*lm_head/kernel$", PartitionSpec(FSDP_AXIS, MODEL_AXIS)),
        (r".*shared/embedding$", PartitionSpec(MODEL_AXIS, FSDP_AXIS)),
        (r".*/(q|k|v)/kernel$", PartitionSpec(FSDP_AXIS, MODEL_AXIS)),
        (r".*/o/kernel$", PartitionSpec(MODEL_AXIS, FSDP_AXIS)),
        (r".*/(wi|wi_0|wi_1)/kernel$", PartitionSpec(FSDP_AXIS, MODEL_AXIS)),
        (r".*/wo/kernel$", PartitionSpec(MODEL_AXIS, FSDP_AXIS)),
        (r".*(value_head|q_head|target_q_head|v_head).*fc_in/kernel$",
         PartitionSpec(None, MODEL_AXIS)),
        (r".*(value_head|q_head|target_q_head|v_head).*fc_in/bias$",
         PartitionSpec(MODEL_AXIS)),
        (r".*(value_head|q_head|target_q_head|v_head).*fc_out/kernel$",
         PartitionSpec(MODEL_AXIS, None)),
        (r".*", PartitionSpec()),
    ]


def flax_path(name: str) -> str:
    """A ``state_dict`` name as the flax path the rules match (``.`` -> ``/``)."""
    return name.replace(".", "/")


def spec_for_path(path: str, rules: Sequence[Rule]) -> PartitionSpec:
    for pattern, spec in rules:
        if re.match(pattern, path):
            return spec
    return PartitionSpec()


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _clip_spec(spec: PartitionSpec, shape: Tuple[int, ...], mesh: Mesh) -> PartitionSpec:
    """Drop named axes that don't divide the corresponding dim, exceed the
    rank, or name an axis the mesh doesn't have."""
    out = []
    for i, entry in enumerate(list(spec)[: len(shape)]):
        axes = _entry_axes(entry)
        if not axes or any(a not in mesh.shape for a in axes):
            out.append(None)
            continue
        size = int(np.prod([mesh.shape[a] for a in axes]))
        out.append(entry if shape[i] % size == 0 else None)
    return PartitionSpec(*out)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def make_param_specs(params: Mapping[str, Any], mesh: Mesh, rules: Optional[Sequence[Rule]] = None
                     ) -> Dict[str, PartitionSpec]:
    """``{name: PartitionSpec}`` for a ``state_dict`` (or ``{name: shape}``),
    with the dims that don't divide dropped."""
    rules = rules if rules is not None else default_lm_rules()
    return {name: _clip_spec(spec_for_path(flax_path(name), rules), _shape(x), mesh)
            for name, x in params.items()}


#: optimizer-state leaves holding blockwise-quantized moments
QUANT_LEAVES = ("m_q", "v_q", "m_scale", "v_scale")


def make_state_shardings(state: Mapping[str, Any], mesh: Mesh, rules: Optional[Sequence[Rule]] = None
                         ) -> Dict[str, PartitionSpec]:
    """Specs for an optimizer state given as ``{path: tensor or shape}``,
    ``path`` ``/``-joined: a moment leaf's path ends with its parameter's
    path (``exp_avg/transformer/layers_0/attn/q_proj/kernel``) and takes its
    layout; quantized blocks (``.../kernel/m_q``) shard their block dim over
    ``fsdp``; scalars replicate (the JAX function's rules)."""
    rules = list(rules) if rules is not None else default_lm_rules()
    rules = [(r".*/(m_q|v_q|m_scale|v_scale)$", PartitionSpec(FSDP_AXIS))] + rules
    return {path: _clip_spec(spec_for_path(path, rules), _shape(x), mesh) for path, x in state.items()}


def batch_divisible(mesh: Mesh, batch_size: int) -> bool:
    """Whether a leading batch dim can shard evenly over the combined data axes."""
    return batch_size % int(np.prod([mesh.shape.get(a, 1) for a in BATCH_AXES])) == 0


_SEQ = threading.local()


@contextlib.contextmanager
def replicated_batch(on: bool = True):
    """Mark the enclosed forwards' batch as kept whole on every rank (it
    does not divide the batch axes): sequence sharding and ring attention
    then fall through, as the JAX functions do for such a batch."""
    prev = getattr(_SEQ, "replicated", False)
    _SEQ.replicated = bool(on)
    try:
        yield
    finally:
        _SEQ.replicated = prev


@contextlib.contextmanager
def sequence_parallel(group):
    """The enclosed layers run on sequence-sharded rows over ``group``
    (None: not sharded)."""
    prev = getattr(_SEQ, "group", None)
    _SEQ.group = group
    try:
        yield
    finally:
        _SEQ.group = prev


def seq_parallel_group():
    """The group the residual stream is sequence-sharded over, or None."""
    return getattr(_SEQ, "group", None)


def seq_state():
    """This thread's sequence state (group, replicated), for code that runs
    a forward again elsewhere (a remat recompute on the autograd thread)."""
    return getattr(_SEQ, "group", None), getattr(_SEQ, "replicated", False)


@contextlib.contextmanager
def restore_seq_state(state):
    group, replicated = state
    with replicated_batch(replicated), sequence_parallel(group):
        yield


def seq_shardable(group, length: int) -> bool:
    """Whether a sequence of ``length`` shards over ``group``: the JAX
    functions' conditions (a group of size > 1, the length divides it, the
    batch divides the batch axes)."""
    return (group is not None and group.size > 1 and length % group.size == 0
            and not getattr(_SEQ, "replicated", False))


def constrain_gathered(x: torch.Tensor, group, seq_dim: int = 1) -> torch.Tensor:
    """Gather a sequence-sharded activation's ``seq_dim`` back over
    ``group`` before the heads (Megatron's
    ``gather_from_sequence_parallel_region``); the backward keeps this
    rank's rows. The caller gathers only what :func:`constrain_seq` scattered."""
    from trlx_tpu_torch.parallel.collectives import gather_from_group

    return gather_from_group(x, group, seq_dim)


def constrain_seq(x: torch.Tensor, group, seq_dim: int = 1) -> torch.Tensor:
    """Megatron-SP's scatter: this rank's ``T / group.size`` rows of a
    replicated activation (the backward all-gathers), counted by
    ``collectives.sequence_counts()``. A no-op where
    :func:`seq_shardable` says no."""
    from trlx_tpu_torch.parallel.collectives import count_scatter, scatter_to_group

    if not seq_shardable(group, x.shape[seq_dim]):
        return x
    count_scatter()
    return scatter_to_group(x, group, seq_dim)


def spec_dim(spec: PartitionSpec, axis: str) -> int:
    """The dim of ``spec`` sharded over ``axis``, or -1."""
    for i, entry in enumerate(spec):
        if axis in _entry_axes(entry):
            return i
    return -1


def shard_tensor(full: torch.Tensor, spec: PartitionSpec, mesh: Mesh, axes: Sequence[str] = None) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (over ``axes``, default
    every axis the spec names): a narrow per sharded dim, by the rank's
    coordinates."""
    out = full
    for i, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if axes is not None and a not in axes:
                continue
            n = out.shape[i] // mesh.shape[a]
            out = out.narrow(i, mesh.coords[a] * n, n)
    return out


def apply_mesh(module: torch.nn.Module, mesh: Mesh, rules: Optional[Sequence[Rule]] = None
               ) -> Dict[str, PartitionSpec]:
    """Tensor parallelism over ``model`` and pipeline stages over ``pipe``
    on a module holding full parameters (identical on every rank): each
    ``model``- or ``pipe``-sharded leaf becomes this rank's block (a
    ``layers_scan`` leaf keeps layers ``[s L / p, (s + 1) L / p)`` on stage
    ``s``; every other leaf stays whole over ``pipe``), the layers read
    their modes from the specs
    (:func:`trlx_tpu_torch.models.transformer.set_tensor_parallel`) and the
    trunks their stage (:func:`~trlx_tpu_torch.models.transformer.set_pipeline`).
    Returns the module's specs over the full shapes."""
    from trlx_tpu_torch.models.transformer import set_pipeline, set_tensor_parallel

    specs = make_param_specs(dict(module.named_parameters()), mesh, rules)
    axes = tuple(a for a in (MODEL_AXIS, PIPE_AXIS) if mesh.shape[a] > 1)
    if not axes:
        return specs
    if mesh.shape[MODEL_AXIS] > 1:
        set_tensor_parallel(module, specs, mesh.group(MODEL_AXIS))
    if mesh.shape[PIPE_AXIS] > 1:
        set_pipeline(module, mesh)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if any(spec_dim(specs[name], a) >= 0 for a in axes):
                p.data = shard_tensor(p.data, specs[name], mesh, axes).clone()
    return specs
