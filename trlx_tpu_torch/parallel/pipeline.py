"""Pipeline parallelism over the mesh's ``pipe`` axis, and the stacked layer
layout's host helpers (counterpart of ``trlx_tpu/parallel/pipeline.py``).

A stacked :class:`~trlx_tpu_torch.models.transformer.TransformerLM`
(``scan_layers``, or ``pipeline_stages > 1``) keeps every block parameter
as one ``[L, ...]`` tensor under ``layers_scan.<block path>``; HF checkpoints
and the listed layout name them ``layers_{i}.<block path>``.
:func:`stack_layer_params` and :func:`unstack_layer_params` convert a flat
trunk ``state_dict`` between the two (loading an HF checkpoint into a
stacked model, and exporting one).

With no pipe axis ``pipeline_stages > 1`` is simply the stacked layout and
``pipeline_microbatches`` is ignored, as in the JAX package. On a mesh
whose ``pipe`` axis is ``p > 1`` each rank holds its stage's ``L / p``
layers (:func:`~trlx_tpu_torch.parallel.sharding.apply_mesh`) and a
cache-free forward runs :func:`pipeline_apply`, the GPipe schedule: the
batch splits into :func:`pick_microbatches` microbatches, stage 0 takes
microbatch ``t`` from the embedding, each stage runs its layers and sends
the activation to the next stage, and the last stage's output is broadcast
over the pipe group so that every stage holds the final activation (the
reference's ``psum``). Unlike the reference's SPMD scan, a stage runs only
its real ticks: no warm-up or drain work is computed and thrown away.

The backward is autograd through the point-to-point functions here, in
the mirrored order. Every stage computes the same loss from the broadcast
activation (as the reference's stages do), so, in Megatron's convention,
the trunk takes the last stage's cotangent once (the broadcast's backward
sends nothing), and the leaves kept whole over ``pipe`` (embeddings, final
norm, heads) get the same whole gradient on every stage: the embedding's
cotangent is broadcast from stage 0 (:class:`_PipeInput`), so no gradient
is summed over ``pipe``. A scalar token threads through every
point-to-point call of a forward, so the backward posts them in exactly the
reverse order on every stage.

A cached forward (decode) runs :func:`pipeline_decode`: each stage its
layers over its slice of the stacked cache, the hidden state sent on, the
last stage's broadcast; parameters and cache never leave their stage.
"""

import re
from typing import Dict, Mapping, NamedTuple, Optional

import torch

from trlx_tpu_torch.parallel import collectives as coll
from trlx_tpu_torch.parallel.mesh import PIPE_AXIS
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

_LAYER = re.compile(r"layers_(\d+)\.(.+)")
STACK_PREFIX = "layers_scan."


def stack_layer_params(state: Mapping[str, torch.Tensor], num_layers: int) -> Dict[str, torch.Tensor]:
    """A listed trunk ``state_dict`` (``layers_0.*`` .. ``layers_{L-1}.*``)
    in the stacked layout: each block path once under ``layers_scan.``, its
    L tensors stacked on a new leading dim (copies). Other entries pass
    through. Raises when a layer lacks a path another layer has."""
    out: Dict[str, torch.Tensor] = {}
    per_path: Dict[str, Dict[int, torch.Tensor]] = {}
    for name, value in state.items():
        m = _LAYER.fullmatch(name)
        if m is None:
            out[name] = value
        else:
            per_path.setdefault(m.group(2), {})[int(m.group(1))] = value
    for path, layers in per_path.items():
        if sorted(layers) != list(range(num_layers)):
            raise ValueError(f"{path}: layers {sorted(layers)}, expected 0..{num_layers - 1}")
        out[STACK_PREFIX + path] = torch.stack([layers[i] for i in range(num_layers)])
    return out


def unstack_layer_params(state: Mapping[str, torch.Tensor], num_layers: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_layer_params` (HF export): each
    ``layers_scan.<path>`` ``[L, ...]`` becomes ``layers_{i}.<path>`` for
    every i (views of the stack)."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in state.items():
        if not name.startswith(STACK_PREFIX):
            out[name] = value
            continue
        if value.shape[0] != num_layers:
            raise ValueError(f"{name}: leading dim {value.shape[0]} != num_layers {num_layers}")
        path = name[len(STACK_PREFIX):]
        for i, layer in enumerate(value.unbind(0)):
            out[f"layers_{i}.{path}"] = layer
    return out


def is_stacked(state: Mapping[str, torch.Tensor]) -> bool:
    """Whether a trunk ``state_dict`` holds the stacked layout."""
    return any(name.startswith(STACK_PREFIX) for name in state)


def pick_microbatches(batch: int, requested: int) -> int:
    """Largest microbatch count <= requested that divides the batch."""
    m = max(1, min(requested, batch))
    while batch % m:
        m -= 1
    return m


class PipeStage(NamedTuple):
    """A trunk's place on the pipe axis: the pipe ``group``, this rank's
    ``stage`` of ``stages``, and the world ranks of the previous and next
    stages (None at the ends)."""

    group: object
    stage: int
    stages: int
    prev: Optional[int]
    next: Optional[int]

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def __deepcopy__(self, memo):
        return self  # a process group is not copied


def stage_of(mesh) -> PipeStage:
    s, p = mesh.stage, mesh.shape[PIPE_AXIS]
    return PipeStage(mesh.pipe_group, s, p, mesh.stage_rank(s - 1) if s > 0 else None,
                     mesh.stage_rank(s + 1) if s < p - 1 else None)


def _like(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _send(h: torch.Tensor, dst: int, pipe: PipeStage) -> None:
    coll.exchange([(h, dst)], [], pipe.group)


def _recv(shape, dtype, device, src: int, pipe: PipeStage) -> torch.Tensor:
    return coll.exchange([], [(_like(shape, dtype, device), src)], pipe.group)[0]


class _PipeInput(torch.autograd.Function):
    """Forward: the embedding output as it is, and the first token. Backward:
    stage 0's cotangent (the only stage whose layers read it) broadcast to
    every stage, so each stage's whole-over-pipe embedding gets it."""

    @staticmethod
    def forward(ctx, x, tok, pipe):
        ctx.pipe = pipe
        return x.view_as(x), tok.detach().clone()

    @staticmethod
    def backward(ctx, g_x, g_tok):
        return coll.broadcast(g_x.contiguous(), ctx.pipe.group, 0), None, None


class _RecvPrev(torch.autograd.Function):
    """Forward: the previous stage's activation. Backward: its cotangent sent back."""

    @staticmethod
    def forward(ctx, tok, shape, dtype, pipe):
        ctx.pipe = pipe
        h = _recv(shape, dtype, tok.device, pipe.prev, pipe)
        return h, tok.detach().clone()

    @staticmethod
    def backward(ctx, g_h, g_tok):
        _send(g_h.contiguous(), ctx.pipe.prev, ctx.pipe)
        return g_tok, None, None, None


class _SendNext(torch.autograd.Function):
    """Forward: the activation sent to the next stage. Backward: its
    cotangent received from there."""

    @staticmethod
    def forward(ctx, h, tok, pipe):
        ctx.pipe, ctx.meta = pipe, (h.shape, h.dtype, h.device)
        _send(h.contiguous(), pipe.next, pipe)
        return tok.detach().clone()

    @staticmethod
    def backward(ctx, g_tok):
        shape, dtype, device = ctx.meta
        return _recv(shape, dtype, device, ctx.pipe.next, ctx.pipe), g_tok, None


class _PipeOutput(torch.autograd.Function):
    """Forward: the last stage's output broadcast over the pipe group.
    Backward: the last stage keeps its own cotangent (every stage computed
    the same loss from it: one cotangent reaches the trunk, not ``stages``
    of them); the token's gradient starts the others' backward."""

    @staticmethod
    def forward(ctx, out, tok, pipe):
        ctx.pipe = pipe
        return coll.broadcast(out.contiguous(), pipe.group, pipe.stages - 1)

    @staticmethod
    def backward(ctx, g_y):
        g_tok = torch.zeros((), dtype=g_y.dtype, device=g_y.device)
        return (g_y if ctx.pipe.last else None), g_tok, None


def pipeline_apply(config, block, x: torch.Tensor, mask_bias: torch.Tensor, positions: torch.Tensor,
                   kv_valid: Optional[torch.Tensor], pipe: PipeStage) -> torch.Tensor:
    """The GPipe schedule of a stacked trunk over the pipe axis: ``block``
    is the :class:`~trlx_tpu_torch.models.transformer.StackedBlock` holding
    this stage's layers, ``x`` [B, T, H] the embedding output (the same on
    every stage). Returns the final residual-stream activation [B, T, H] on
    every stage. Each layer runs under the config's ``remat`` policy."""
    from trlx_tpu_torch.models.transformer import run_block

    c = config
    stages = pipe.stages
    B = x.shape[0]
    num_mb = pick_microbatches(B, c.pipeline_microbatches)
    if num_mb != c.pipeline_microbatches:
        logger.warning(
            f"batch {B} does not divide into pipeline_microbatches="
            f"{c.pipeline_microbatches}; running {num_mb} microbatches "
            f"(bubble fraction {(stages - 1) / (num_mb + stages - 1):.2f})"
        )
    if c.pipeline_stages != stages:
        raise ValueError(
            f"pipeline_stages={c.pipeline_stages} does not match the mesh's "
            f"pipe axis size {stages}"
        )
    layers = block.layer_params()
    grad = torch.is_grad_enabled()
    tok = None
    if grad:
        tok = torch.zeros((), dtype=torch.float32, device=x.device, requires_grad=True)
        x, tok = _PipeInput.apply(x, tok, pipe)
    n = B // num_mb
    shared_mask = mask_bias.shape[0] == 1
    outs = []
    for j in range(num_mb):
        rows = slice(j * n, (j + 1) * n)
        shape = (n,) + tuple(x.shape[1:])
        if pipe.stage == 0:
            h = x[rows]
        elif grad:
            h, tok = _RecvPrev.apply(tok, shape, x.dtype, pipe)
        else:
            h = _recv(shape, x.dtype, x.device, pipe.prev, pipe)
        mask_j = mask_bias if shared_mask else mask_bias[rows]
        kv_j = None if kv_valid is None else kv_valid[rows]
        for params in layers:
            h, _ = run_block(block, h, mask_j, positions[rows], None, kv_j, params=params)
        if pipe.last:
            outs.append(h)
        elif grad:
            tok = _SendNext.apply(h, tok, pipe)
        else:
            _send(h.contiguous(), pipe.next, pipe)
    out = torch.cat(outs) if pipe.last else x.new_empty(x.shape)
    if grad:
        return _PipeOutput.apply(out, tok, pipe)
    return coll.broadcast(out, pipe.group, stages - 1)


def pipeline_decode(block, x: torch.Tensor, mask_bias, positions, layer_cache, kv_valid,
                    pipe: PipeStage) -> torch.Tensor:
    """A cached forward of a stacked trunk over the pipe axis, stage by
    stage: this stage's layers over its slice of the stacked cache
    (``layer_cache(i)`` for its i-th layer, written in place), the hidden
    state received from the previous stage and sent to the next; the last
    stage's output broadcast to every stage. No gradient."""
    from trlx_tpu_torch.models.transformer import run_block

    h = x if pipe.stage == 0 else _recv(x.shape, x.dtype, x.device, pipe.prev, pipe)
    for i, params in enumerate(block.layer_params()):
        h, _ = run_block(block, h, mask_bias, positions, layer_cache(i), kv_valid, params=params)
    if not pipe.last:
        _send(h.contiguous(), pipe.next, pipe)
    out = h if pipe.last else x.new_empty(h.shape)
    return coll.broadcast(out.contiguous(), pipe.group, pipe.stages - 1)
