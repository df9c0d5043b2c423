"""Generic causal decoder LM in PyTorch, the counterpart of
``trlx_tpu/models/transformer.py``.

One configurable module covers gpt2, gpt-neox/pythia, gpt-j, opt and llama:
positional scheme (learned / rotary neox or gptj style), norm type
(LayerNorm / RMSNorm), activation, GLU mlp, parallel residual, biases, GQA
and tied embeddings are config switches. Parameter names follow the flax
tree (``layers_{i}.attn.q_proj.kernel`` etc., dense kernels ``[in, out]``),
so a JAX parameter tree loads by name (:mod:`trlx_tpu_torch.models.convert`).

Numerics follow the flax module: matrix products run in ``compute_dtype``
against the parameters cast per call, norms reduce in f32 with flax's
one-pass variance, the plain attention path adds a ``-1e9`` mask bias and
takes the softmax in f32. With ``attention_impl="flash"`` every multi-token
forward (prefill, the scoring passes, the training loss) attends through
the flash kernel, and the training backward through its dK/dV and dQ
kernels; single-token paged steps use the paged decode kernel, multi-token
paged appends (speculative verify, chunked prefill) the paged verify
kernel, and single-token steps over the contiguous cache the plain path
(as the JAX package's einsum).

KV caches are preallocated tensors updated in place (JAX threads them
functionally): the contiguous prefill cache ``{"k", "v"[, scales], "index"}``
with per-layer ``[B, Hkv, S, D]`` buffers, and the paged block pools from
:meth:`TransformerLM.init_paged_cache`.

The hydra reference branch reads the activation entering a layer
(``branch_layer`` of :meth:`TransformerLM.forward`) and runs the top layers,
the final norm and the head from it (:meth:`TransformerLM.forward_from`,
through the flash kernel with ``attention_impl="flash"``).

ALiBi (bloom) adds its bias to the mask bias of every plain-path forward
(:func:`make_attn_bias`, and the cached forward's slot bias); the flash
kernel takes no additive bias, so an ALiBi model never enters it (the JAX
package's routing), and the paged cache refuses ALiBi.

peft, as the JAX package's:

- LoRA (``lora_r > 0``): every :class:`Dense` named in ``lora_targets``
  carries ``lora_a [in, r]`` (normal(1/r)) and ``lora_b [r, out]`` (zeros)
  and adds ``(x A) B * alpha / r``; :func:`merge_lora_state` folds them into
  the kernels for export.
- Prefix tuning (``peft_type="prefix"``): per-layer ``prefix_k`` /
  ``prefix_v [nv, Hkv, D]`` prepended to whatever a layer attends over,
  never cached, without rotary and under a zero bias. It keeps the layer on
  the plain path (the flash kernel's causal index has no room for them), an
  int8 cache on its dequant-on-read path, and the paged cache refuses it.
- Prompt tuning (``peft_type="prompt"``): ``prompt_embeddings [nv, hidden]``
  prepended inside :meth:`TransformerLM.forward`, real positions shifted by
  ``nv``, masks extended and the outputs sliced back to the caller's T; it
  stays on the flash kernel. Cached forwards are prefill from slot 0 or
  single-token steps; :meth:`TransformerLM.init_cache` adds ``nv`` slots.

Inside :func:`disable_adapters` every module runs as its base model on the
same parameters (adapters, prefixes and virtual tokens ignored): the PPO
trainer's peft KL reference, with no second copy of the trunk.

``remat`` (``full``, ``per_layer``, ``nothing_saveable``, ``dots_saveable``)
recomputes each block in the backward of a cache-free forward that builds a
graph (:func:`run_block`): the first three keep only the block's inputs,
``dots_saveable`` also keeps the matrix products' outputs. The flash forward
is not a matrix product, so it runs again in the backward under every
policy, as the ``pallas_call`` does under XLA's ``dots_saveable``.

Stacked layouts (``scan_layers``, or ``pipeline_stages > 1`` with no pipe
axis: the JAX package's ``layers_scan``) keep every block parameter as one
``[L, ...]`` tensor under ``layers_scan.<block path>`` (:class:`StackedBlock`),
so a JAX ``layers_scan`` tree loads name for name. Each forward takes the
per-layer views with one ``unbind(0)`` per stacked parameter (its backward is
one ``stack``; ``p[l]`` per layer would make ``select``'s backward write a
zero-filled ``[L, ...]`` tensor per layer) and runs the one :class:`Block`'s
code over each layer's views under ``run_block``'s remat policy. The dense
cache is one ``[L, B, Hkv, S, D]`` tensor per leaf and the paged pools one
``[L, NB, BS, Hkv, D]`` per leaf: each layer reads and writes ``leaf[l]`` in
place, a view, so a stacked step launches what a listed one does. As in the
JAX package, ``paged_decode``, hydra branch capture and ``forward_from``
refuse a stacked model. On a mesh whose ``pipe`` axis is > 1
(:func:`set_pipeline`) each rank holds its stage's layers: a cache-free
forward runs the GPipe schedule and a cached one runs stage by stage
(:mod:`trlx_tpu_torch.parallel.pipeline`).

Tensor parallelism over a mesh's ``model`` axis (:func:`set_tensor_parallel`,
applied by :func:`trlx_tpu_torch.parallel.sharding.apply_tensor_parallel`):
``Dense`` layers run column- or row-parallel by the dim the partition rules
shard, attention runs this rank's heads (through the flash kernels, on plain
local tensors) and reads the key / value heads they need, and a vocab-split
embedding looks up and projects its rows, the logits gathered whole. A
stacked trunk splits the same way, each layer's views holding this rank's
heads and MLP slice.

The sequence dimension over the same ``model`` ranks, cache-free forwards
only (decode never shards the sequence):

- ``sequence_sharding`` (Megatron-SP): the embedding output is scattered
  over ``T`` (:func:`~trlx_tpu_torch.parallel.sharding.constrain_seq`) and
  the residual stream stays sharded through every block; attention and the
  MLP all-gather ``T`` in front of their column-parallel layers (the
  backward reduce-scatters) and their row-parallel layers reduce-scatter
  over ``T`` instead of all-reducing; the stream is gathered before the
  heads. The flash kernels see the whole ``T`` and this rank's heads. A
  hydra capture and the value branch's input are sharded likewise.
- ``attention_impl="ring"``: under the reference's conditions (no cache, a
  key mask, not ALiBi, not prefix tuning, ``model > 1``, ``T`` and the batch
  dividing) attention runs :func:`~trlx_tpu_torch.ops.ring_attention.ring_attention`
  on ``T / model`` rows of every head (q/k/v moved from this rank's heads to
  its sequence shard and back by an all-to-all); otherwise it takes the
  plain path, never the flash kernel, as the reference's routing does.
"""

import contextlib
import functools
import math
import threading
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from trlx_tpu_torch.ops.attention import flash_attention
from trlx_tpu_torch.ops.ring_attention import ring_attention
from trlx_tpu_torch.parallel.collectives import (
    all_to_all_op,
    copy_to_group,
    gather_from_group,
    gather_reduce_scatter,
    reduce_from_group,
    reduce_scatter_to_group,
    scale_grad,
    scatter_to_group,
)
from trlx_tpu_torch.parallel.mesh import MODEL_AXIS, PIPE_AXIS
from trlx_tpu_torch.parallel.sharding import (
    constrain_gathered,
    constrain_seq,
    restore_seq_state,
    seq_parallel_group,
    seq_shardable,
    seq_state,
    sequence_parallel,
)
from trlx_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_pool_layout,
    paged_verify_attention,
    paged_write_rows,
    write_paged_kv,
    write_paged_kv_multi,
)

KVCache = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    """Architecture hyperparameters (the JAX config's fields and defaults;
    dtypes are torch dtypes). Presets in :mod:`trlx_tpu_torch.models.presets`."""

    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # GQA; None = num_heads
    head_dim: Optional[int] = None  # None = hidden_size // num_heads
    intermediate_size: Optional[int] = None  # None = 4*hidden
    max_position_embeddings: int = 1024

    pos_embedding: str = "learned"  # "learned" | "rotary" | "alibi" | "none"
    rope_style: str = "neox"  # "neox" (rotate-half) | "gptj" (interleaved)
    rotary_pct: float = 1.0
    rope_theta: float = 10000.0
    pos_offset: int = 0  # OPT uses a +2 offset into its learned table

    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    norm_eps: float = 1e-5
    activation: str = "gelu_new"  # "gelu_new" | "gelu" | "relu" | "silu"
    glu: bool = False
    parallel_residual: bool = False
    shared_parallel_ln: bool = False
    attn_bias: bool = True
    mlp_bias: bool = True
    embed_ln: bool = False
    head_bias: bool = False
    tie_word_embeddings: bool = True
    final_norm: bool = True

    initializer_range: float = 0.02
    # residual-out projections (o_proj/down_proj) init at
    # initializer_range / sqrt(2*num_layers), as the JAX config
    depth_scaled_init: bool = True
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "none"  # "none" | "full" | "per_layer" | "nothing_saveable" | "dots_saveable"
    attention_impl: str = "xla"  # "xla" (plain) | "flash" (kernel) | "ring" (sequence-parallel)
    kv_cache_quant: bool = False
    paged_attention_impl: str = "auto"  # "auto" | "pallas" (both: kernel) | "xla" (plain)
    pipeline_stages: int = 1
    pipeline_microbatches: int = 4
    scan_layers: bool = False

    @property
    def stacked(self) -> bool:
        return self.pipeline_stages > 1 or self.scan_layers

    sequence_sharding: bool = False

    lora_r: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("q_proj", "v_proj")
    peft_type: str = "none"
    num_virtual_tokens: int = 0

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dim_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def ffn_dim(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    def residual_init_std(self) -> float:
        if self.depth_scaled_init:
            return self.initializer_range / math.sqrt(2 * self.num_layers)
        return self.initializer_range

    def replace(self, **kw) -> "TransformerConfig":
        return replace(self, **kw)


REMAT_POLICIES = ("none", "full", "per_layer", "nothing_saveable", "dots_saveable")


def check_supported(c: TransformerConfig) -> None:
    """The JAX module's checks of a pipelined stack and of the options."""
    if c.pipeline_stages > 1:
        if c.num_layers % c.pipeline_stages != 0:
            raise ValueError(
                f"num_layers={c.num_layers} not divisible by pipeline_stages={c.pipeline_stages}")
        if c.attention_impl == "ring":
            raise ValueError(
                "pipeline_stages > 1 cannot nest ring attention's shard_map; "
                "use attention_impl='xla' or 'flash'"
            )
        if c.sequence_sharding:
            raise ValueError(
                "pipeline_stages > 1 does not apply sequence-sharding "
                "constraints inside the pipelined stack; set "
                "sequence_sharding=False (the trainer does this automatically "
                "when mesh.pipe > 1)"
            )
    if c.attention_impl not in ("xla", "flash", "ring"):
        raise ValueError(f"unknown attention_impl {c.attention_impl!r}")
    if c.remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {c.remat!r} (one of {REMAT_POLICIES})")
    if c.peft_type not in ("none", "prefix", "prompt"):
        raise ValueError(f"unknown peft_type {c.peft_type!r}")


_ADAPTERS = threading.local()


def adapters_enabled() -> bool:
    """False inside :func:`disable_adapters` (on this thread)."""
    return not getattr(_ADAPTERS, "off", False)


@contextlib.contextmanager
def disable_adapters():
    """Run every module as its base model on the same parameters: LoRA
    adds nothing, no prefix is prepended and no virtual token embedded (the
    JAX package's module built with ``lora_r=0, peft_type="none"`` over the
    same tree). Per thread, so a forward on another thread is unaffected."""
    prev = getattr(_ADAPTERS, "off", False)
    _ADAPTERS.off = True
    try:
        yield
    finally:
        _ADAPTERS.off = prev


def _virtual_tokens(c: "TransformerConfig", kind: str) -> int:
    """``num_virtual_tokens`` when ``peft_type`` is ``kind`` and adapters are on."""
    return c.num_virtual_tokens if c.peft_type == kind and adapters_enabled() else 0


_DOT_OPS = (
    torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_saveable``: keep the matrix products' outputs, recompute the rest
    (the flash kernel's output buffer among them: nothing K1 writes into is
    a saved tensor)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def run_block(block: nn.Module, x, mask_bias, positions, cache=None, kv_valid=None, params=None):
    """``block(x, ...)`` under its config's ``remat`` policy (the JAX
    package's ``nn.remat(Block, policy=remat_policy(...))``): a cache-free
    forward that builds a graph keeps only the block's inputs (``full``,
    ``per_layer``, ``nothing_saveable``) or also the matrix products
    (``dots_saveable``), and recomputes the rest in the backward. Cached
    and no-grad forwards run the block as it is. ``params`` (one layer's
    views of a :class:`StackedBlock`) runs the block's code over them."""
    fn = block if params is None else functools.partial(_call_layer, block, params)
    policy = block.config.remat
    if policy == "none" or cache is not None or not torch.is_grad_enabled():
        return fn(x, mask_bias, positions, cache, kv_valid)
    kw = {}
    if policy == "dots_saveable":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    # the recompute runs in the backward, on the autograd thread: it takes
    # this forward's sequence state with it
    return checkpoint(functools.partial(_with_seq_state, seq_state(), fn), x, mask_bias, positions, None, kv_valid,
                      use_reentrant=False, **kw)


def _with_seq_state(state, fn, *args):
    with restore_seq_state(state):
        return fn(*args)


# functional_call swaps a module's parameters for the call: one stacked
# layer runs at a time, whatever thread calls it (a remat recompute runs on
# the autograd thread)
_LAYER_CALL = threading.RLock()


def _call_layer(block: nn.Module, params: Dict[str, torch.Tensor], *args):
    with _LAYER_CALL:
        return torch.func.functional_call(block, params, args)


def _act(name: str):
    return {
        "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "relu": F.relu,
        "silu": F.silu,
    }[name]


def make_causal_bias(
    attention_mask: Optional[torch.Tensor], B: int, T: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions, additive causal+padding mask bias [B,1,T,T]) for a cache-free forward."""
    if attention_mask is not None:
        positions = (torch.cumsum(attention_mask, dim=1) - 1).clamp(min=0).to(torch.int32)
    else:
        positions = torch.arange(T, dtype=torch.int32, device=device)[None, :].expand(B, T)
    causal = torch.ones((T, T), dtype=torch.bool, device=device).tril()[None, None]
    if attention_mask is not None:
        causal = causal & attention_mask[:, None, None, :].bool()
    return positions, _bias_from_mask(causal)


def _bias_from_mask(mask: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, torch.full_like(zero, -1e9))


def make_attn_bias(
    config: TransformerConfig, attention_mask: Optional[torch.Tensor], B: int, T: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions, additive mask bias with ALiBi folded in when the config
    says ``pos_embedding="alibi"``) for a cache-free forward: every
    cache-free call site takes its bias from here, so none can miss ALiBi."""
    positions, bias = make_causal_bias(attention_mask, B, T, device)
    if config.pos_embedding == "alibi":
        bias = bias + alibi_bias(config, attention_mask, B, T, device)
    return positions, bias


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes, f32 (HF ``build_alibi_tensor``'s algorithm:
    powers of 2^-(8/closest) for the largest power of two ``closest`` <=
    ``num_heads``, then every other power of the next base for the rest)."""
    closest = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** i for i in range(1, closest + 1)]
    if closest != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        num_rem = min(closest, num_heads - closest)
        slopes += [extra_base ** i for i in range(1, 1 + 2 * num_rem, 2)]
    return torch.tensor(slopes, dtype=torch.float32)


def alibi_bias(
    config: TransformerConfig, attention_mask: Optional[torch.Tensor], B: int, S: int, device
) -> torch.Tensor:
    """[B, H, 1, S] additive ALiBi bias over key slots: slope times the key's
    position, where positions count the valid tokens (a left-padded row
    starts at 0 on its first real token). Softmax ignores the relative
    form's ``-slope * q_pos`` term, constant along a query's row."""
    if attention_mask is not None:
        m = attention_mask.float()
        key_pos = (torch.cumsum(m, dim=1) - 1).clamp(min=0) * m
    else:
        key_pos = torch.arange(S, dtype=torch.float32, device=device)[None, :].expand(B, S)
    slopes = alibi_slopes(config.num_heads).to(key_pos.device)
    return slopes[None, :, None, None] * key_pos[:, None, None, :]


def make_rotary(config: TransformerConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, T, rot_dim/2] for the given positions."""
    rot_dim = int(config.dim_per_head * config.rotary_pct)
    rot_dim -= rot_dim % 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=positions.device) / rot_dim
    inv_freq = 1.0 / (config.rope_theta ** exponent)
    freqs = positions[..., None].float() * inv_freq
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, style: str) -> torch.Tensor:
    """Rotate queries/keys. x: [B, T, H, D]; cos/sin [B, T, rot/2]."""
    rot_dim = cos.shape[-1] * 2
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    if style == "gptj":
        x1 = x_rot[..., 0::2]
        x2 = x_rot[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    else:
        half = rot_dim // 2
        x1 = x_rot[..., :half]
        x2 = x_rot[..., half:]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        rotated = torch.cat([r1, r2], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over the trailing (head) dim:
    x [..., D] -> (int8 values [..., D], f32 scales [..., 1]). Bit-exact with
    the JAX scheme: f32 amax, ``max(amax, 1e-8) / 127``, round half to even
    (``torch.round`` and ``jnp.round`` agree), clip to +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=1e-8) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def write_kv_cache(cache: Dict[str, torch.Tensor], kT: torch.Tensor, vT: torch.Tensor, idx: int):
    """Write [B,H,T,D] rows at slot ``idx`` IN PLACE (the buffers are
    preallocated; JAX's dynamic_update_slice returns a new array instead).
    Quantizes when the cache carries scale planes. Returns ``cache``."""
    T = kT.shape[2]
    if "k_scale" in cache:
        kq, ks = quantize_kv_rows(kT)
        vq, vs = quantize_kv_rows(vT)
        cache["k"][:, :, idx:idx + T] = kq
        cache["v"][:, :, idx:idx + T] = vq
        cache["k_scale"][:, :, idx:idx + T] = ks
        cache["v_scale"][:, :, idx:idx + T] = vs
    else:
        cache["k"][:, :, idx:idx + T] = kT.to(cache["k"].dtype)
        cache["v"][:, :, idx:idx + T] = vT.to(cache["v"].dtype)
    return cache


def read_kv_cache(cache: Dict[str, torch.Tensor], compute_dtype):
    """(kh, vh) to attend over; int8 caches dequantize on read (values times
    the f32 scale at full precision, then cast)."""
    if "k_scale" in cache:
        return (
            (cache["k"].float() * cache["k_scale"]).to(compute_dtype),
            (cache["v"].float() * cache["v_scale"]).to(compute_dtype),
        )
    return cache["k"], cache["v"]


def kv_cache_layout(shape: Tuple[int, ...], dtype, quant: bool) -> Dict[str, Tuple]:
    """Per-layer cache buffers as {key: (shape, dtype)} — int8 values + one f32
    scale per row when ``quant``."""
    if quant:
        return {
            "k": (shape, torch.int8), "v": (shape, torch.int8),
            "k_scale": (tuple(shape[:-1]) + (1,), torch.float32),
            "v_scale": (tuple(shape[:-1]) + (1,), torch.float32),
        }
    return {"k": (shape, dtype), "v": (shape, dtype)}


class Dense(nn.Module):
    """flax ``Dense`` layout: ``kernel [in, out]`` and ``bias [out]``,
    computed as ``x @ kernel`` in ``dtype`` with the parameters cast per call
    (a no-op for parameters already in ``dtype``). With ``lora_r > 0`` the
    JAX ``LoraDense``: ``lora_a [in, r]`` and ``lora_b [r, out]`` add ``(x A)
    B * lora_alpha / lora_r``, unless adapters are disabled.

    Under tensor parallelism (:func:`set_tensor_parallel`) ``tp`` is
    ``"column"`` (this rank's output features; the input enters through
    ``copy_to_group``), ``"row"`` (this rank's input features; the partial
    product is all-reduced before the bias) or ``"column_gather"`` (a
    column-parallel head whose output slices are gathered whole). Inside
    :func:`~trlx_tpu_torch.parallel.sharding.sequence_parallel` a column
    layer's input is the gathered ``T`` (:func:`_sp_gather`, whose backward
    sums the ranks' partial gradients) and a row layer reduce-scatters its
    partial product over ``T``."""

    tp: Optional[str] = None
    tp_group = None

    def __init__(self, in_features: int, features: int, use_bias: bool, dtype, param_dtype, init_std: float,
                 lora_r: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.dtype = dtype
        self.init_std = init_std
        self.lora_r, self.lora_alpha = lora_r, lora_alpha
        self.kernel = nn.Parameter(torch.empty(in_features, features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype)) if use_bias else None
        if lora_r > 0:
            self.lora_a = nn.Parameter(torch.empty(in_features, lora_r, dtype=param_dtype))
            self.lora_b = nn.Parameter(torch.zeros(lora_r, features, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        sp = seq_parallel_group() if self.tp is not None else None
        if self.tp is not None and self.tp != "row" and sp is None:
            x = copy_to_group(x, self.tp_group)
        y = x @ self.kernel.to(self.dtype)
        if self.tp == "row":
            if self.lora_r > 0 and adapters_enabled():
                y = y + self._lora(x)  # this rank's partial product, summed with the kernel's
            y = reduce_from_group(y, self.tp_group) if sp is None else reduce_scatter_to_group(y, sp, 1)
        if self.bias is not None:
            bias = self.bias
            if self.tp == "row" and sp is not None:
                bias = copy_to_group(bias, sp)  # added to this rank's rows: its gradient sums the ranks'
            y = y + bias.to(self.dtype)
        if self.tp != "row" and self.lora_r > 0 and adapters_enabled():
            y = y + self._lora(x)
        if self.tp == "column_gather":
            y = gather_from_group(y, self.tp_group, -1)
        return y


    def _lora(self, x: torch.Tensor) -> torch.Tensor:
        """``(x A) B * alpha / r`` on this rank's features: under tensor
        parallelism the adapters stay whole (replicated leaves), a column
        layer takes ``B``'s columns of its output slice and a row layer
        ``A``'s rows of its input slice (its partial product joins the
        kernel's before the all-reduce); their gradients sum over ``model``."""
        a, b = self.lora_a, self.lora_b
        if self.tp is not None:
            a, b = copy_to_group(a, self.tp_group), copy_to_group(b, self.tp_group)
            if self.tp == "row":
                n = self.kernel.shape[0]
                a = a.narrow(0, self.tp_group.index * n, n)
            else:
                n = self.kernel.shape[1]
                b = b.narrow(1, self.tp_group.index * n, n)
        return (x @ a.to(self.dtype)) @ b.to(self.dtype) * (self.lora_alpha / self.lora_r)


def merge_lora_state(state: Mapping[str, torch.Tensor], lora_alpha: float, lora_r: int) -> Dict[str, torch.Tensor]:
    """Fold every adapter into its kernel (``W + A B * alpha / r``, in f32)
    and drop the ``lora_a`` / ``lora_b`` entries: the JAX package's
    ``merge_lora_params`` on a ``state_dict`` (peft's ``merge_and_unload``),
    for the HF export."""
    out = {}
    for name, value in state.items():
        if name.endswith((".lora_a", ".lora_b")):
            continue
        if name.endswith(".kernel") and name[:-len("kernel")] + "lora_a" in state:
            base = name[:-len("kernel")]
            a, b = state[base + "lora_a"].float(), state[base + "lora_b"].float()
            value = (value.float() + (a @ b) * (lora_alpha / lora_r)).to(value.dtype)
        out[name] = value
    return out


class Norm(nn.Module):
    """flax LayerNorm / RMSNorm: statistics in f32 with the one-pass variance
    ``E[x^2] - E[x]^2`` (clipped at 0), ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, output in ``dtype``. On sequence-sharded rows the
    parameters' gradients are summed over the ranks (Megatron-SP's
    all-reduce of the sequence-parallel gradients)."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        c = config
        self.rms = c.norm == "rmsnorm"
        self.eps = c.norm_eps
        self.dtype = c.compute_dtype
        self.scale = nn.Parameter(torch.ones(c.hidden_size, dtype=c.param_dtype))
        self.bias = None if self.rms else nn.Parameter(torch.zeros(c.hidden_size, dtype=c.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        if self.rms:
            var, y = mean2, xf
        else:
            mean = xf.mean(dim=-1, keepdim=True)
            var = (mean2 - mean * mean).clamp(min=0.0)
            y = xf - mean
        sp = seq_parallel_group()
        scale, bias = self.scale, self.bias
        if sp is not None:
            scale = copy_to_group(scale, sp)
            bias = None if bias is None else copy_to_group(bias, sp)
        y = y * (torch.rsqrt(var + self.eps) * scale.float())
        if bias is not None:
            y = y + bias.float()
        return y.to(self.dtype)


class Embed(nn.Module):
    """flax ``Embed`` layout: ``embedding [num, features]``, looked up then
    cast to ``dtype``. Vocab-parallel (``tp_group`` set): this rank holds
    rows ``[tp_vocab_start, tp_vocab_start + rows)``, looks up the ids that
    fall there (zeros elsewhere) and the group sums the lookups."""

    tp_group = None
    tp_vocab_start = 0

    def __init__(self, num: int, features: int, dtype, param_dtype, init_std: float = 0.02):
        super().__init__()
        self.dtype = dtype
        self.init_std = init_std
        self.embedding = nn.Parameter(torch.empty(num, features, dtype=param_dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp_group is None:
            return F.embedding(ids.long(), self.embedding).to(self.dtype)
        local = ids.long() - self.tp_vocab_start
        inside = (local >= 0) & (local < self.embedding.shape[0])
        rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)), self.embedding)
        return reduce_from_group(rows * inside[..., None].to(rows.dtype), self.tp_group).to(self.dtype)

    def attend(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """Logits of the tied head, ``x @ embedding.T`` (gathered whole over
        the vocab-parallel group)."""
        if self.tp_group is None:
            return x @ self.embedding.to(dtype).T
        logits = copy_to_group(x, self.tp_group) @ self.embedding.to(dtype).T
        return gather_from_group(logits, self.tp_group, -1)


class Attention(nn.Module):
    """Under tensor parallelism ``config`` holds this rank's head counts;
    ``tp_heads`` is its slice of the global heads (for a per-head score
    bias), and ``tp_kv = (mode, index, group)`` rebuilds the key / value
    heads its query heads read when they are not its own slice: ``mode``
    ``"gather"`` (model-sharded k/v features gathered whole) or ``"copy"``
    (replicated k/v), then ``index`` picks the heads. ``seq_group`` is the
    ``model`` group ring attention runs over."""

    tp_heads: Optional[slice] = None
    tp_kv = None
    tp_group = None
    seq_group = None

    def __init__(self, config: TransformerConfig):
        super().__init__()
        c = self.config = config
        dense = lambda name, i, o, bias, std=c.initializer_range: Dense(
            i, o, bias, c.compute_dtype, c.param_dtype, std,
            lora_r=c.lora_r if name in c.lora_targets else 0, lora_alpha=c.lora_alpha,
        )
        qd, kd = c.num_heads * c.dim_per_head, c.kv_heads * c.dim_per_head
        self.q_proj = dense("q_proj", c.hidden_size, qd, c.attn_bias)
        self.k_proj = dense("k_proj", c.hidden_size, kd, c.attn_bias)
        self.v_proj = dense("v_proj", c.hidden_size, kd, c.attn_bias)
        self.o_proj = dense("o_proj", qd, c.hidden_size, c.attn_bias, c.residual_init_std())
        if c.peft_type == "prefix" and c.num_virtual_tokens > 0:
            # prefix tuning: learned per-layer K/V, never cached (parity: peft
            # PREFIX_TUNING past_key_values)
            shape = (c.num_virtual_tokens, c.kv_heads, c.dim_per_head)
            self.prefix_k = nn.Parameter(torch.empty(shape, dtype=c.param_dtype))
            self.prefix_v = nn.Parameter(torch.empty(shape, dtype=c.param_dtype))

    def forward(
        self,
        x: torch.Tensor,
        mask_bias: Optional[torch.Tensor],
        positions: torch.Tensor,
        cache: Optional[Dict[str, Any]] = None,
        kv_valid: Optional[torch.Tensor] = None,
    ):
        """x: [B,T,Hid]; mask_bias additive [B,1,T,S]. ``cache`` is this layer's
        contiguous cache (``index`` = write slot) or paged cache
        (``block_tables`` present). A non-None
        ``kv_valid`` [B,T] with T > 1 marks a cache-free forward or a
        prefill from slot 0: with ``attention_impl="flash"`` it attends
        through the flash kernel over this forward's own k/v."""
        c = self.config
        sp = seq_parallel_group()
        x = _sp_gather(x, sp)
        B, T, _ = x.shape
        scale = 1.0 / math.sqrt(c.dim_per_head)
        n_prefix = _virtual_tokens(c, "prefix")
        # the reference's ring conditions: otherwise the plain path below
        ring = (c.attention_impl == "ring" and cache is None and kv_valid is not None
                and c.pos_embedding != "alibi" and c.peft_type != "prefix" and seq_shardable(self.seq_group, T))
        q = self.q_proj(_sp_in(self.q_proj, x, sp)).reshape(B, T, c.num_heads, c.dim_per_head)
        kf, vf = (proj(_sp_in(proj, x, sp)) for proj in (self.k_proj, self.v_proj))
        if self.tp_kv is None:
            k = kf.reshape(B, T, c.kv_heads, c.dim_per_head)
            v = vf.reshape(B, T, c.kv_heads, c.dim_per_head)
        else:
            # ring attention reads every key / value head of its shard
            k, v = (self._tp_kv_heads(f, index=not ring) for f in (kf, vf))
        if self.tp_heads is not None and mask_bias is not None and mask_bias.shape[1] > 1:
            mask_bias = mask_bias[:, self.tp_heads]
        if c.pos_embedding == "rotary":
            cos, sin = make_rotary(c, positions)
            q = apply_rotary(q, cos, sin, c.rope_style)
            k = apply_rotary(k, cos, sin, c.rope_style)

        if cache is not None and "block_tables" in cache:
            # no mask bias reaches the paged kernels: a position-dependent
            # score bias (ALiBi) and scale-less prepended rows (prefix tuning)
            # do not fit them, as in the JAX package
            if c.pos_embedding == "alibi" or n_prefix:
                raise ValueError("paged decode does not support alibi or prefix tuning")
            # paged step (serving engine). T == 1 is decode: the new row
            # lands at position context_lens, then attention runs over
            # context_lens + 1 tokens gathered through the block table.
            # T > 1 is the speculative-verify / chunked-prefill append: token
            # j lands at context_lens + j and attends over context_lens + j + 1
            # tokens (the verify kernel takes the PRE-append lens)
            kw = dict(k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                      scale=scale, impl=c.paged_attention_impl)
            if T == 1:
                write_paged_kv(cache, k[:, 0], v[:, 0])
                out = paged_decode_attention(
                    q[:, 0].contiguous(), cache["k"], cache["v"],
                    cache["block_tables"], cache["context_lens"] + 1, **kw,
                )
            else:
                write_paged_kv_multi(cache, k, v)
                out = paged_verify_attention(
                    q.contiguous(), cache["k"], cache["v"],
                    cache["block_tables"], cache["context_lens"], **kw,
                )
            out = out.reshape(B, T, c.num_heads * c.dim_per_head).to(c.compute_dtype)
            return self.o_proj(out), cache

        if ring:
            return self._ring(q, k, v, kv_valid, scale, sp), cache

        if cache is not None:
            write_kv_cache(cache, k.transpose(1, 2), v.transpose(1, 2), cache["index"])

        # the kernel takes no additive bias: ALiBi attends on the plain path;
        # prefix keys break its causal index math
        use_flash = (c.attention_impl == "flash" and kv_valid is not None and T > 1
                     and c.pos_embedding != "alibi" and not n_prefix)
        k_row_scale = v_row_scale = None
        if use_flash:
            out = flash_attention(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), kv_valid.to(torch.int32).contiguous(),
                True, scale,
            )
            out = out.transpose(1, 2).to(c.compute_dtype)
        else:
            if cache is not None:
                # attend over the cache (prefill on the plain path)
                if "k_scale" in cache and not n_prefix:
                    # int8 cache: bare dtype convert; the per-row scales fold
                    # into the scores (k) and the softmax weights (v)
                    kh = cache["k"].to(c.compute_dtype)
                    vh = cache["v"].to(c.compute_dtype)
                    k_row_scale = cache["k_scale"]  # [B, Hkv, S, 1] f32
                    v_row_scale = cache["v_scale"]
                else:
                    kh, vh = read_kv_cache(cache, c.compute_dtype)
            else:
                kh = k.transpose(1, 2)
                vh = v.transpose(1, 2)
            if n_prefix:
                # visible to every query (zero bias), no positions, no rotary;
                # prefixed rows carry no int8 scale, so the cache dequantized above
                shape = (B, c.kv_heads, n_prefix, c.dim_per_head)
                pk, pv = (self._local_prefix(p) for p in (self.prefix_k, self.prefix_v))
                kh = torch.cat([pk.to(kh.dtype).transpose(0, 1)[None].expand(shape), kh], dim=2)
                vh = torch.cat([pv.to(vh.dtype).transpose(0, 1)[None].expand(shape), vh], dim=2)
                mask_bias = torch.cat([mask_bias.new_zeros(mask_bias.shape[:-1] + (n_prefix,)), mask_bias], dim=-1)
            # a cache in another dtype (a bf16 cache under f32 compute):
            # both products run in the promoted dtype, as JAX's einsum does
            dt = q.dtype if kh.dtype == q.dtype else torch.promote_types(q.dtype, kh.dtype)
            q, kh, vh = q.to(dt), kh.to(dt), vh.to(dt)
            if c.kv_heads != c.num_heads:
                rep = c.num_heads // c.kv_heads
                qg = q.reshape(B, T, c.kv_heads, rep, c.dim_per_head)
                scores = torch.einsum("btkrd,bksd->bkrts", qg, kh).float() * scale
                if k_row_scale is not None:
                    scores = scores * k_row_scale[..., 0][:, :, None, None, :]
                bias = (
                    mask_bias[:, :, None]
                    if mask_bias.shape[1] == 1
                    else mask_bias.reshape(B, c.kv_heads, rep, *mask_bias.shape[2:])
                )
                probs = torch.softmax(scores + bias, dim=-1)
                if v_row_scale is not None:
                    probs = probs * v_row_scale[..., 0][:, :, None, None, :]
                probs = probs.to(c.compute_dtype).to(dt)
                out = torch.einsum("bkrts,bksd->btkrd", probs, vh)
            else:
                scores = torch.einsum("bthd,bhsd->bhts", q, kh).float() * scale
                if k_row_scale is not None:
                    scores = scores * k_row_scale[..., 0][:, :, None, :]
                probs = torch.softmax(scores + mask_bias, dim=-1)
                if v_row_scale is not None:
                    probs = probs * v_row_scale[..., 0][:, :, None, :]
                probs = probs.to(c.compute_dtype).to(dt)
                out = torch.einsum("bhts,bhsd->bthd", probs, vh)
        out = out.reshape(B, T, c.num_heads * c.dim_per_head)
        return _sp_out(self.o_proj, self.o_proj(out), sp), cache

    def _ring(self, q, k, v, kv_valid, scale, sp):
        """Ring attention over ``seq_group``: q/k/v [B, T, heads, D] to
        every head of this rank's ``T / n`` rows (an all-to-all from this
        rank's heads, a slice of whole heads), the ring, and back."""
        c, g = self.config, self.seq_group
        B, T = q.shape[:2]
        q_local = self.tp_heads is not None
        kv_local = q_local and self.tp_kv is None

        def to_seq(t, local):
            # [B, T, h, D] -> [B, heads, T/n, D]
            t = all_to_all_op(t, g, 1, 2) if local else scatter_to_group(t, g, 1)
            return t.transpose(1, 2)

        n = T // g.size
        valid = kv_valid.to(torch.int32).narrow(1, g.index * n, n)
        out = ring_attention(to_seq(q, q_local), to_seq(k, kv_local), to_seq(v, kv_local), g, True, scale, valid)
        out = out.transpose(1, 2)
        out = all_to_all_op(out, g, 2, 1) if q_local else gather_from_group(out, g, 1)
        out = out.reshape(B, T, c.num_heads * c.dim_per_head).to(c.compute_dtype)
        return _sp_out(self.o_proj, self.o_proj(out), sp)

    def _local_prefix(self, prefix: torch.Tensor) -> torch.Tensor:
        """The prefix-tuning keys or values ``[nv, Hkv, D]`` of the key /
        value heads this rank's query heads read (whole when the query heads
        are): the prefix is a replicated leaf, and its gradient sums over
        ``model`` where each rank reads a part of it."""
        if self.tp_heads is None:
            return prefix
        prefix = copy_to_group(prefix, self.tp_group)
        if self.tp_kv is None:
            n = self.config.kv_heads
            return prefix.narrow(1, self.tp_group.index * n, n)
        heads = self.tp_kv[1]
        return prefix if heads is None else prefix.index_select(1, heads.to(prefix.device))

    def _tp_kv_heads(self, kv: torch.Tensor, index: bool = True) -> torch.Tensor:
        """[B, T, features] of a k or v projection -> the [B, T, heads, D]
        this rank's query heads read (every head with ``index=False``)."""
        mode, heads, group = self.tp_kv
        B, T, _ = kv.shape
        if not index:
            # every rank reads every head (of its rows): whole gradients, nothing summed
            kv = gather_from_group(kv, group, -1) if mode == "gather" else kv
            return kv.reshape(B, T, -1, self.config.dim_per_head)
        kv = gather_reduce_scatter(kv, group, -1) if mode == "gather" else copy_to_group(kv, group)
        kv = kv.reshape(B, T, -1, self.config.dim_per_head)
        return kv if heads is None else kv.index_select(2, heads.to(kv.device))


def _sp_gather(x: torch.Tensor, sp) -> torch.Tensor:
    """Inside sequence parallelism: the whole ``T`` of a sequence-sharded
    activation for the layers that consume it (the backward reduce-scatters
    their gradients back to this rank's rows)."""
    return x if sp is None else gather_reduce_scatter(x, sp, 1)


def _sp_in(dense: "Dense", x: torch.Tensor, sp) -> torch.Tensor:
    """A replicated layer's share of the gathered input's gradient: its
    gradient is whole on every rank, and the gather's reduce-scatter sums
    the ranks."""
    return x if sp is None or dense.tp is not None else scale_grad(x, 1.0 / sp.size)


def _sp_out(dense: "Dense", y: torch.Tensor, sp) -> torch.Tensor:
    """Back to this rank's rows after a layer whose output is whole (a row
    layer reduce-scatters by itself)."""
    return y if sp is None or dense.tp == "row" else scatter_to_group(y, sp, 1)


class MLP(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        c = self.config = config
        dense = lambda name, i, o, std=c.initializer_range: Dense(
            i, o, c.mlp_bias, c.compute_dtype, c.param_dtype, std,
            lora_r=c.lora_r if name in c.lora_targets else 0, lora_alpha=c.lora_alpha,
        )
        if c.glu:
            self.gate_proj = dense("gate_proj", c.hidden_size, c.ffn_dim)
        self.up_proj = dense("up_proj", c.hidden_size, c.ffn_dim)
        self.down_proj = dense("down_proj", c.ffn_dim, c.hidden_size, c.residual_init_std())
        self.act = _act(c.activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sp = seq_parallel_group()
        x = _sp_gather(x, sp)
        if self.config.glu:
            h = self.act(self.gate_proj(_sp_in(self.gate_proj, x, sp))) * self.up_proj(_sp_in(self.up_proj, x, sp))
        else:
            h = self.act(self.up_proj(_sp_in(self.up_proj, x, sp)))
        return _sp_out(self.down_proj, self.down_proj(h), sp)


class Block(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        c = self.config = config
        self.ln_1 = Norm(c)
        if not (c.parallel_residual and c.shared_parallel_ln):
            self.ln_2 = Norm(c)
        self.attn = Attention(c)
        self.mlp = MLP(c)

    def forward(self, x, mask_bias, positions, cache=None, kv_valid=None):
        c = self.config
        if c.parallel_residual:
            h1 = self.ln_1(x)
            h2 = h1 if c.shared_parallel_ln else self.ln_2(x)
            attn_out, cache = self.attn(h1, mask_bias, positions, cache, kv_valid)
            return x + attn_out + self.mlp(h2), cache
        attn_out, cache = self.attn(self.ln_1(x), mask_bias, positions, cache, kv_valid)
        x = x + attn_out
        x = x + self.mlp(self.ln_2(x))
        return x, cache


class StackedBlock(Block):
    """The stacked layout's ``layers_scan``: one :class:`Block` whose every
    parameter carries a leading ``[num_layers]`` dim (flax's ``nn.scan``
    with ``variable_axes={"params": 0}``), so its ``state_dict`` names are
    ``layers_scan.<block path>``. Never called as a module: a forward takes
    :meth:`layer_params` once and runs each layer through
    :func:`run_block` with its views."""

    def __init__(self, config: TransformerConfig):
        super().__init__(config)
        L = config.num_layers
        for module in self.modules():
            for name, p in list(module.named_parameters(recurse=False)):
                setattr(module, name, nn.Parameter(p.detach().new_empty((L,) + tuple(p.shape))))

    def layer_params(self) -> List[Dict[str, torch.Tensor]]:
        """Per layer, ``{name: view}``: one ``unbind(0)`` per parameter
        (under the lock: another thread's layer call swaps them)."""
        with _LAYER_CALL:
            names, stacks = zip(*self.named_parameters())
        return [dict(zip(names, views)) for views in zip(*(p.unbind(0) for p in stacks))]


#: the JAX module's messages for what a stacked layout refuses
STACKED_CAPTURE_ERROR = (
    "stacked/pipelined models do not support hydra branch capture "
    "(per-layer activations are internal to the stage scan); use a "
    "separate reference model (num_layers_unfrozen=-1) and "
    "num_value_layers_unfrozen=0"
)
STACKED_BRANCH_ERROR = (
    "hydra branch forwards need per-layer params; stacked models "
    "use a separate reference model (num_layers_unfrozen=-1)"
)


def forward_from(model: nn.Module, hidden, attention_mask, positions, start_layer: int) -> torch.Tensor:
    """``layers_{start_layer}`` .. ``layers_{L-1}`` of ``model`` (a
    :class:`TransformerLM`, or the hydra branch that holds only those
    layers), then its final norm and head, from the activation ``hidden``.
    With ``attention_impl="flash"`` every layer attends through the flash
    kernel under the key mask ``attention_mask``."""
    if model.config.stacked:
        raise NotImplementedError(STACKED_BRANCH_ERROR)
    sp = capture_seq_group(model, hidden, attention_mask)
    B, T = hidden.shape[0], hidden.shape[1] * (sp.size if sp is not None else 1)
    default_positions, mask_bias = make_attn_bias(model.config, attention_mask, B, T, hidden.device)
    if positions is None:
        positions = default_positions
    x = hidden
    with sequence_parallel(sp):
        for i in range(start_layer, model.config.num_layers):
            x, _ = run_block(getattr(model, f"layers_{i}"), x, mask_bias, positions, None, attention_mask)
    if sp is not None:
        x = constrain_gathered(x, sp)
    logits, _ = model._final(x)
    return logits


def capture_seq_group(model: nn.Module, hidden: torch.Tensor, attention_mask: Optional[torch.Tensor]):
    """The group a captured activation is sequence-sharded over (a hydra
    capture, the value branch's input, under ``sequence_sharding``), or
    None: its rows are ``T / model`` of the key mask's ``T``."""
    group = getattr(model, "seq_group", None)
    if not model.config.sequence_sharding or group is None or attention_mask is None:
        return None
    T = attention_mask.shape[1]
    return group if hidden.shape[1] * group.size == T and seq_shardable(group, T) else None


def _model_dim(spec) -> int:
    for i, entry in enumerate(spec):
        if entry == MODEL_AXIS or (isinstance(entry, tuple) and MODEL_AXIS in entry):
            return i
    return -1


def set_tensor_parallel(module: nn.Module, specs: Mapping[str, Any], group) -> None:
    """Switch every layer of ``module`` to its tensor-parallel forward over
    ``group`` (the ``model`` axis) from the parameter ``specs`` (full
    shapes): Dense layers column / row parallel by the dim their kernel
    shards over ``model``, attention to this rank's heads, a vocab-sharded
    embedding to the vocab-parallel lookup and tied head. The caller then
    slices the parameters (:func:`trlx_tpu_torch.parallel.sharding.apply_mesh`).
    A stacked trunk's leaves carry the layer dim first: its specs name the
    same dims one further on. Every module with a ``seq_group`` takes the
    group (sequence sharding and ring attention run over it). Raises for
    query heads that do not divide the axis."""
    m, r = group.size, group.index
    names = dict(module.named_modules())
    for pre, sub in names.items():
        key = f"{pre}." if pre else ""
        # a stacked leaf's spec leads with its layer dim
        off = 1 if "layers_scan" in pre.split(".") else 0
        if hasattr(type(sub), "seq_group"):
            sub.seq_group = group
        if isinstance(sub, Dense):
            dim = _model_dim(specs[key + "kernel"])
            if dim >= 0:
                sub.tp, sub.tp_group = ("row" if dim == off else "column"), group
                if pre.endswith("lm_head"):
                    sub.tp = "column_gather"
        elif isinstance(sub, Embed) and _model_dim(specs[key + "embedding"]) == 0:
            sub.tp_group = group
            sub.tp_vocab_start = r * (sub.embedding.shape[0] // m)
        if isinstance(sub, Attention):
            _tp_attention(sub, specs, key, group, off)
        elif hasattr(sub, "set_tensor_parallel"):
            sub.set_tensor_parallel(specs, key, group)
    kv = {a.config.kv_heads for a in module.modules() if isinstance(a, Attention)}
    for sub in module.modules():
        if isinstance(sub, TransformerLM) and kv:
            sub.tp_kv_heads = max(kv)


def _tp_attention(attn: Attention, specs, key: str, group, off: int = 0) -> None:
    c = attn.config
    m, r = group.size, group.index
    H, Hkv, D = c.num_heads, c.kv_heads, c.dim_per_head
    q_sharded = _model_dim(specs[key + "q_proj.kernel"]) == 1 + off
    kv_sharded = _model_dim(specs[key + "k_proj.kernel"]) == 1 + off
    if not q_sharded:
        # the query heads stay whole on every rank: so must the keys
        if kv_sharded:
            attn.tp_kv = ("gather", None, group)
        return
    if H % m:
        raise NotImplementedError(f"{H} query heads over model={m}: heads must divide the model axis")
    Hl = H // m
    attn.tp_heads, attn.tp_group = slice(r * Hl, (r + 1) * Hl), group
    g = H // Hkv
    if kv_sharded and Hkv % m == 0:
        kv_local = Hkv // m  # aligned: this rank's k/v heads are its query heads' groups
    else:
        heads = list(range(r * Hl, (r + 1) * Hl))
        if Hl % g == 0:
            index = sorted({h // g for h in heads})
        elif g % Hl == 0:
            index = [heads[0] // g]
        else:
            index = [h // g for h in heads]  # one k/v row per query head
        attn.tp_kv = ("gather" if kv_sharded else "copy", torch.tensor(index, dtype=torch.long), group)
        kv_local = len(index)
    attn.config = c.replace(num_heads=Hl, num_kv_heads=kv_local, head_dim=D)


def set_pipeline(module: nn.Module, mesh) -> None:
    """Give every :class:`TransformerLM` in ``module`` its place on the
    mesh's ``pipe`` axis (> 1): a stacked trunk with ``pipeline_stages``
    equal to the axis (each rank keeps ``num_layers / pipe`` layers: the
    caller slices them). Raises for a trunk that cannot split: a listed or
    otherwise staged trunk, or layers the axis does not divide."""
    from trlx_tpu_torch.parallel.pipeline import stage_of

    stages = mesh.shape[PIPE_AXIS]
    for sub in module.modules():
        if not isinstance(sub, TransformerLM):
            continue
        c = sub.config
        if c.pipeline_stages != stages:
            raise ValueError(
                f"pipeline_stages={c.pipeline_stages} does not match the mesh's "
                f"pipe axis size {stages}"
            )
        if c.num_layers % stages:
            raise ValueError(f"num_layers={c.num_layers} not divisible by pipeline_stages={stages}")
        sub.pipe = stage_of(mesh)


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights for every submodule of ``model`` from ``seed`` (a
    ``torch.Generator`` on the parameters' device): normal(initializer_range)
    embeddings and dense kernels, residual-out kernels at
    ``residual_init_std``, zero biases, unit norm scales, LoRA ``lora_a``
    normal(1/r) and ``lora_b`` zeros, normal(initializer_range) prefixes and
    prompt embeddings — the JAX module's initializers, not its bits."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, Dense):
            module.kernel.normal_(0.0, module.init_std, generator=gen)
            if module.bias is not None:
                module.bias.zero_()
            if module.lora_r > 0:
                module.lora_a.normal_(0.0, 1.0 / module.lora_r, generator=gen)
                module.lora_b.zero_()
        elif isinstance(module, Attention) and hasattr(module, "prefix_k"):
            module.prefix_k.normal_(0.0, module.config.initializer_range, generator=gen)
            module.prefix_v.normal_(0.0, module.config.initializer_range, generator=gen)
        elif isinstance(module, TransformerLM) and hasattr(module, "prompt_embeddings"):
            module.prompt_embeddings.normal_(0.0, module.config.initializer_range, generator=gen)
        elif isinstance(module, Embed):
            module.embedding.normal_(0.0, module.init_std, generator=gen)
        elif isinstance(module, Norm):
            module.scale.fill_(1.0)
            if module.bias is not None:
                module.bias.zero_()
    return model


class TransformerLM(nn.Module):
    """Decoder-only LM. ``forward`` returns (logits, final_hidden,
    branch activation, cache) as the JAX module's ``__call__`` does.
    ``tp_kv_heads`` is the rank's key / value head count under tensor
    parallelism (its cache's width), ``seq_group`` the ``model`` group the
    sequence shards over, ``pipe`` the trunk's
    :class:`~trlx_tpu_torch.parallel.pipeline.PipeStage` on a pipe axis."""

    tp_kv_heads: Optional[int] = None
    seq_group = None
    pipe = None

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        check_supported(config)
        c = self.config = config
        self.embed_tokens = Embed(
            c.vocab_size, c.hidden_size, c.compute_dtype, c.param_dtype, c.initializer_range
        )
        if c.embed_ln:
            self.embed_layernorm = Norm(c)
        if c.peft_type == "prompt" and c.num_virtual_tokens > 0:
            # prompt tuning: learned virtual-token embeddings prepended to the
            # input (parity: peft PROMPT_TUNING)
            self.prompt_embeddings = nn.Parameter(
                torch.empty(c.num_virtual_tokens, c.hidden_size, dtype=c.param_dtype))
        if c.pos_embedding == "learned":
            self.embed_positions = Embed(
                c.max_position_embeddings + c.pos_offset, c.hidden_size,
                c.compute_dtype, c.param_dtype, c.initializer_range,
            )
        if c.stacked:
            self.layers_scan = StackedBlock(c)
        else:
            # flax names the listed layers layers_0 .. layers_{L-1}
            for i in range(c.num_layers):
                setattr(self, f"layers_{i}", Block(c))
        if c.final_norm:
            self.ln_f = Norm(c)
        if not c.tie_word_embeddings:
            self.lm_head = Dense(
                c.hidden_size, c.vocab_size, c.head_bias, c.compute_dtype,
                c.param_dtype, c.initializer_range,
            )
        if device is not None:
            self.to(device)

    @property
    def layers(self) -> List[Block]:
        """The listed layers (none in a stacked layout: :meth:`_run_layers`)."""
        if self.config.stacked:
            return []
        return [getattr(self, f"layers_{i}") for i in range(self.config.num_layers)]

    def _run_layers(self, x, mask_bias, positions, layer_cache, kv_valid, capture_set=(), captures=None):
        """Every layer in turn; ``layer_cache(i)`` gives layer i's cache
        (None for a cache-free forward). A stacked layout runs the one block
        over each layer's parameter views and cache views (leaves written in
        place), listed layers each their own block."""
        if self.config.stacked:
            if capture_set:
                raise NotImplementedError(STACKED_CAPTURE_ERROR)
            block = self.layers_scan
            if self.pipe is not None:
                from trlx_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_decode

                if layer_cache(0) is None:
                    return pipeline_apply(self.config, block, x, mask_bias, positions, kv_valid, self.pipe)
                return pipeline_decode(block, x, mask_bias, positions, layer_cache, kv_valid, self.pipe)
            for i, params in enumerate(block.layer_params()):
                x, _ = run_block(block, x, mask_bias, positions, layer_cache(i), kv_valid, params=params)
            return x
        for i, layer in enumerate(self.layers):
            if i in capture_set:
                captures[i] = x
            x, _ = run_block(layer, x, mask_bias, positions, layer_cache(i), kv_valid)
        return x

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.embedding.device

    @property
    def local_layers(self) -> int:
        """The layers this rank holds (its stage's on a pipe axis)."""
        return self.config.num_layers // (self.pipe.stages if self.pipe is not None else 1)

    def init_params(self, seed: int = 0) -> "TransformerLM":
        """Random weights from ``seed`` (:func:`init_params`)."""
        return init_params(self, seed)

    def _final(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, post-norm hidden)."""
        c = self.config
        if c.final_norm:
            x = self.ln_f(x)
        if c.tie_word_embeddings:
            logits = self.embed_tokens.attend(x, c.compute_dtype)
        else:
            logits = self.lm_head(x)
        return logits, x

    def embed(self, input_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = self.embed_tokens(input_ids)
        if self.config.pos_embedding == "learned":
            x = x + self.embed_positions(positions + self.config.pos_offset)
        if self.config.embed_ln:
            x = self.embed_layernorm(x)
        return x

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        last_only: bool = False,
        branch_layer=None,
    ):
        """input_ids [B,T]; attention_mask [B,T] (1 = real token; with a cache
        it covers the cache length [B,S]). Returns (logits [B,T,V], hidden
        [B,T,Hid] post-norm, None, cache or None) — the cache is updated in
        place and its ``index`` advanced by T. ``last_only`` runs the final
        norm and head on the last position only (logits [B,1,V]): the
        serving prefill samples from that position alone.

        The cache-free multi-token forward trains: gradients flow through
        every layer, and with ``attention_impl="flash"`` through the flash
        kernels' backward. ``branch_layer`` captures the activation entering
        a layer for the hydra branches: an int returns that layer's input in
        the third slot, a tuple a dict of them by layer."""
        c = self.config
        B, T = input_ids.shape
        dev = input_ids.device
        # prompt tuning prepends nv virtual rows here; the caller's contract
        # (T-length outputs, T- or S-length masks) holds: masks are extended
        # and the outputs sliced. Virtual rows take slots and positions
        # 0..nv-1; real positions shift by +nv.
        nv = _virtual_tokens(c, "prompt")
        nv_rows = 0  # virtual rows in this forward's activations
        if cache is not None:
            S = cache["k"][0].shape[2]
            idx = int(cache["index"])
            prompt_prefill = nv > 0 and idx == 0
            if nv > 0 and not (prompt_prefill or T == 1):
                raise ValueError(
                    "prompt-tuning cached forwards support only prefill-from-zero or single-token decode steps")
            ext_mask = attention_mask
            if nv and attention_mask is not None:
                ext_mask = torch.cat([attention_mask.new_ones((B, nv)), attention_mask], dim=1)
            if positions is None:
                # decode positions from the cache index already count the
                # virtual slots: shift only at prefill
                positions = idx + torch.arange(T, dtype=torch.int32, device=dev)[None, :].expand(B, T)
                if prompt_prefill:
                    positions = positions + nv
            elif nv:
                positions = positions + nv
            nv_rows = nv if prompt_prefill else 0
            T_eff = T + nv_rows
            # causal structure over cache *slots* (left padding repeats
            # position values under the pad mask; slot order is temporal)
            kv_slot = torch.arange(S, device=dev)[None, None, None, :]
            q_slot = (idx + torch.arange(T_eff, device=dev))[None, None, :, None]
            causal = kv_slot <= q_slot
            if ext_mask is not None:
                causal = causal & ext_mask[:, None, None, :].bool()
            mask_bias = _bias_from_mask(causal)
            if c.pos_embedding == "alibi":
                mask_bias = mask_bias + alibi_bias(c, ext_mask, B, S, dev)
            x = self.embed(input_ids, positions)
            layer_positions = positions
            if nv_rows:
                virt = torch.arange(nv, dtype=torch.int32, device=dev)[None, :].expand(B, nv)
                layer_positions = torch.cat([virt, positions], dim=1)
                x = torch.cat([self.prompt_embeddings.to(x.dtype)[None].expand(B, nv, c.hidden_size), x], dim=1)
            # prefill from slot 0: the flash path may attend over this
            # forward's k/v alone (every later cache slot is still empty)
            kv_valid = ext_mask[:, :T_eff] if T_eff > 1 and ext_mask is not None and idx == 0 else None
        elif nv:
            nv_rows = nv
            mask_in = attention_mask if attention_mask is not None else torch.ones(
                (B, T), dtype=torch.int32, device=dev)
            ext_mask = torch.cat([mask_in.new_ones((B, nv)), mask_in], dim=1)
            default_positions, mask_bias = make_attn_bias(c, ext_mask, B, T + nv, dev)
            positions = default_positions[:, nv:] if positions is None else positions + nv
            layer_positions = torch.cat([default_positions[:, :nv], positions], dim=1)
            pe = self.prompt_embeddings.to(c.compute_dtype)[None].expand(B, nv, c.hidden_size)
            x = torch.cat([pe, self.embed(input_ids, positions)], dim=1)
            kv_valid = ext_mask
        else:
            default_positions, mask_bias = make_attn_bias(c, attention_mask, B, T, dev)
            if positions is None:
                positions = default_positions
            x = self.embed(input_ids, positions)
            layer_positions = positions
            kv_valid = attention_mask
        capture_set = ()
        if branch_layer is not None:
            capture_set = branch_layer if isinstance(branch_layer, tuple) else (branch_layer,)
        captures = {}

        def layer_cache(i):
            if cache is None:
                return None
            # a list entry, or a view of the stacked [L, ...] leaf
            out = {key: cache[key][i] for key in cache if key != "index"}
            out["index"] = cache["index"]
            return out

        # Megatron-SP (cache-free forwards): the stream stays sharded over T
        # through every block and is gathered before the heads
        sp = None
        if c.sequence_sharding and cache is None:
            sharded = constrain_seq(x, self.seq_group)
            sp, x = (self.seq_group if sharded is not x else None), sharded
        with sequence_parallel(sp):
            x = self._run_layers(x, mask_bias, layer_positions, layer_cache, kv_valid, capture_set, captures)
        if sp is not None:
            x = constrain_gathered(x, sp)
        if last_only:
            x = x[:, -1:]
        elif nv_rows:
            x = x[:, nv_rows:]  # drop the virtual rows: outputs are [B, T, ...]
        logits, hidden = self._final(x)
        if cache is not None:
            cache["index"] = int(cache["index"]) + T + nv_rows
        if isinstance(branch_layer, tuple):
            branch_out = captures
        else:
            branch_out = None if branch_layer is None else captures.get(branch_layer)
        return logits, hidden, branch_out, cache

    def forward_from(self, hidden, attention_mask, positions, start_layer: int):
        """Run ``layers[start_layer:]``, the final norm and the head from a
        branch activation ``hidden`` [B, T, Hid]: the hydra frozen-branch
        forward (reference ``forward_hydra``). ``attention_mask`` is the
        key mask of the flash path, as in a cache-free forward. Returns
        logits [B, T, V]."""
        return forward_from(self, hidden, attention_mask, positions, start_layer)

    def _layer_buffers(self, layout: Dict[str, Tuple]) -> Dict[str, Any]:
        """Zeros per ``{key: (shape, dtype)}``: one ``[L, *shape]`` tensor a
        key in a stacked layout, else a list of L tensors."""
        L, dev = self.local_layers, self.device
        if self.config.stacked:
            return {key: torch.zeros((L,) + tuple(shp), dtype=dt, device=dev) for key, (shp, dt) in layout.items()}
        return {key: [torch.zeros(shp, dtype=dt, device=dev) for _ in range(L)] for key, (shp, dt) in layout.items()}

    def init_cache(self, batch_size: int, max_length: int, dtype=None) -> KVCache:
        """Contiguous cache buffers on the model's device (zeros): per layer
        ``[B, Hkv, S, D]``, or one ``[L, B, Hkv, S, D]`` a leaf in a stacked
        layout; prompt tuning's virtual rows take ``num_virtual_tokens``
        more slots."""
        c = self.config
        if c.peft_type == "prompt":
            max_length += c.num_virtual_tokens
        shape = (batch_size, self.tp_kv_heads or c.kv_heads, max_length, c.dim_per_head)
        out = self._layer_buffers(kv_cache_layout(shape, dtype or c.compute_dtype, c.kv_cache_quant))
        out["index"] = 0
        return out

    def init_paged_cache(
        self, num_blocks: int, block_size: int, max_blocks_per_seq: int,
        batch_size: int, dtype=None,
    ) -> KVCache:
        """Block-pool cache for the serving engine: per-layer k/v pools
        ``[num_blocks, block_size, Hkv, D]`` (int8 + f32 row scales under
        ``kv_cache_quant``; one ``[L, ...]`` pool a leaf in a stacked layout,
        which only :meth:`paged_verify` walks) plus shared ``block_tables``
        ``[B, max_blocks_per_seq]`` and ``context_lens`` ``[B]``, int32.
        Block 0 is the allocator's reserved null block; fresh tables point
        at it."""
        c = self.config
        out = self._layer_buffers(paged_pool_layout(
            num_blocks, block_size, c.kv_heads, c.dim_per_head,
            dtype or c.compute_dtype, c.kv_cache_quant,
        ))
        out["block_tables"] = torch.zeros((batch_size, max_blocks_per_seq), dtype=torch.int32, device=self.device)
        out["context_lens"] = torch.zeros((batch_size,), dtype=torch.int32, device=self.device)
        return out

    def paged_decode(self, input_ids: torch.Tensor, cache: KVCache):
        """One decode step against the paged block-pool cache: ``input_ids``
        [B, 1]. Writes each slot's new K/V row into the pools in place and
        returns (logits [B, 1, V], hidden [B, 1, Hid], cache with
        ``context_lens`` replaced by lens + 1). Idle slots (len 0 with a null
        table row) still produce finite output, which the engine discards."""
        if self.config.stacked:
            raise NotImplementedError("paged decode: per-layer list layout only")
        B, T = input_ids.shape
        if T != 1:
            raise ValueError("paged_decode is a single-token step")
        lens = cache["context_lens"]
        positions = lens[:, None].to(torch.int32)  # incoming token's position
        x = self._paged_layers(input_ids, positions, cache)
        logits, hidden = self._final(x)
        new_cache = dict(cache)
        new_cache["context_lens"] = lens + 1
        return logits, hidden, new_cache

    def paged_verify(self, input_ids: torch.Tensor, cache: KVCache):
        """Multi-token paged step (speculative verify / chunked prefill):
        ``input_ids`` [B, Q]; token j is written through the block table at
        position ``context_lens + j`` and attends causally over every earlier
        position plus itself. Returns (logits [B, Q, V], hidden [B, Q, Hid],
        cache with ``context_lens`` UNCHANGED): the caller decides how far
        the frontier advances (speculative accept count, chunk length). KV
        rows written past the accepted frontier stay invisible to the
        attention mask and are rewritten before they can become valid. In a
        stacked layout each layer writes its rows into ``pool[l]`` in place,
        the tables and lens shared by every layer."""
        lens = cache["context_lens"]
        Q = input_ids.shape[1]
        positions = lens[:, None].to(torch.int32) + torch.arange(Q, dtype=torch.int32, device=lens.device)[None, :]
        x = self._paged_layers(input_ids, positions, cache)
        logits, hidden = self._final(x)
        return logits, hidden, dict(cache)

    def _paged_layers(self, input_ids: torch.Tensor, positions: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """Embed and run every layer against the paged cache (pools written
        in place). Learned positions past the table (an idle slot's frontier
        grows every round; draft positions reach ``max_seq_len + spec_k - 1``)
        are clamped into it for the lookup: the JAX package's ``jnp.take``
        gives NaN rows there instead of an index error. Such rows are never
        delivered, and NaN-free garbage keeps every masked read exact."""
        c = self.config
        emb_positions = positions
        if c.pos_embedding == "learned":
            emb_positions = positions.clamp(max=c.max_position_embeddings - 1)
        x = self.embed(input_ids, emb_positions)
        pool_keys = [k for k in cache if k not in ("block_tables", "context_lens")]
        shared = {"block_tables": cache["block_tables"], "context_lens": cache["context_lens"]}
        if input_ids.shape[1] > 1:  # every layer appends to the same rows
            shared["write_rows"] = paged_write_rows(
                cache["block_tables"], cache["context_lens"], input_ids.shape[1], cache["k"][0].shape[1])

        def layer_cache(i):
            return {**{key: cache[key][i] for key in pool_keys}, **shared}

        return self._run_layers(x, None, positions, layer_cache, None)
