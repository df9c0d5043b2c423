"""T5-style encoder-decoder LM in PyTorch, the counterpart of
``trlx_tpu/models/t5.py``: RMS-style layer norm (no mean subtraction, no
bias), a relative position bias computed by the first self-attention layer
of each stack and shared by the rest, ReLU or gated-GeLU FFN, no biases,
and tied embeddings with the decoder output scaled by ``d_model ** -0.5``.

Parameter names follow the flax tree (``shared.embedding``,
``encoder_blocks_{i}.attn.q.kernel``, ``decoder_blocks_{i}.cross_attn.k.kernel``,
``decoder_ln.scale``; dense kernels ``[in, out]``), so a JAX parameter tree
loads by name (:mod:`trlx_tpu_torch.models.convert`). Numerics follow the
flax module: projections in ``compute_dtype`` against parameters cast per
call, scores without the 1/sqrt(d) scale (T5 folds it into the init), the
position and mask biases added in f32, softmax in f32.

The decoder's self-attention cache is the contiguous per-layer layout of
:class:`~trlx_tpu_torch.models.transformer.TransformerLM`, updated in place
(int8 with f32 row scales under ``kv_cache_quant``, dequantized on read);
cross-attention K/V are computed once from the encoder states
(:meth:`T5LM.precompute_cross_kv`). No Pallas kernel backs the JAX module:
every attention here is the plain einsum path, on the card too.

The decoder-top hydra branch (:class:`T5Branch`) holds copies of the top
decoder blocks, the final decoder norm and the head, and runs them from the
activation :meth:`T5LM.forward_with_branch` captured.

LoRA (``lora_r > 0``) adds adapters to the projections named in
``lora_targets`` (``q``, ``k``, ``v``, ``o``, ``wi``, ``wi_0``, ``wi_1``,
``wo``; ``("q", "v")`` by default, as HF peft's for T5), through the same
:class:`~trlx_tpu_torch.models.transformer.Dense` as the causal model, and
:func:`~trlx_tpu_torch.models.transformer.disable_adapters` turns them off.
"""

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.models.transformer import (
    Dense,
    Embed,
    init_params,
    kv_cache_layout,
    read_kv_cache,
    write_kv_cache,
)
from trlx_tpu_torch.parallel.collectives import copy_to_group
from trlx_tpu_torch.parallel.mesh import MODEL_AXIS
from trlx_tpu_torch.parallel.sharding import spec_dim


@dataclass(frozen=True)
class T5Config:
    """The JAX config's fields and defaults (t5-small widths); dtypes are
    torch dtypes."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6  # encoder layers
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # "relu" | "gated-gelu"
    tie_word_embeddings: bool = True
    initializer_factor: float = 1.0
    decoder_start_token_id: int = 0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    lora_r: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("q", "v")
    kv_cache_quant: bool = False

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated")

    def replace(self, **kw) -> "T5Config":
        return replace(self, **kw)


#: the HF ``T5Config`` defaults of every field :func:`from_hf_t5_config`
#: reads (``config.json`` leaves out fields at their class default)
HF_T5_DEFAULTS: Dict[str, Any] = dict(
    vocab_size=32128, d_model=512, d_kv=64, d_ff=2048, num_layers=6, num_decoder_layers=None, num_heads=8,
    relative_attention_num_buckets=32, relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
    feed_forward_proj="relu", tie_word_embeddings=True, decoder_start_token_id=None,
)


def from_hf_t5_config(hf_config: Dict[str, Any], overrides: Optional[Dict[str, Any]] = None) -> T5Config:
    """An HF T5 ``config.json`` dict as :class:`T5Config` (a missing key reads
    as the HF class default; ``num_decoder_layers`` defaults to
    ``num_layers``)."""
    h = {**HF_T5_DEFAULTS, **hf_config}
    config = T5Config(
        vocab_size=h["vocab_size"], d_model=h["d_model"], d_kv=h["d_kv"], d_ff=h["d_ff"],
        num_layers=h["num_layers"], num_decoder_layers=h["num_decoder_layers"] or h["num_layers"],
        num_heads=h["num_heads"], relative_attention_num_buckets=h["relative_attention_num_buckets"],
        relative_attention_max_distance=h["relative_attention_max_distance"],
        layer_norm_epsilon=h["layer_norm_epsilon"],
        feed_forward_proj="gated-gelu" if "gated" in h["feed_forward_proj"] else "relu",
        tie_word_embeddings=h["tie_word_embeddings"], decoder_start_token_id=h["decoder_start_token_id"] or 0,
    )
    if overrides:
        config = config.replace(**overrides)
    return config


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's relative position bucketing (HF's math), the JAX function's f32
    log included: int32 buckets."""
    ret = torch.zeros_like(relative_position, dtype=torch.int32)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """Additive f32 bias: 0 where ``mask`` holds, -1e9 elsewhere."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, torch.full_like(zero, -1e9))


class T5LayerNorm(nn.Module):
    """RMS norm: ``x * rsqrt(mean(x**2) + eps)`` in f32, times the scale,
    cast to the compute dtype."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.eps = config.layer_norm_epsilon
        self.dtype = config.compute_dtype
        self.scale = nn.Parameter(torch.ones(config.d_model, dtype=config.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale.float()).to(self.dtype)


def _dense(c: T5Config, name: str, i: int, o: int, std: float) -> Dense:
    """A bias-free projection; LoRA adapters when ``name`` is a target."""
    return Dense(i, o, False, c.compute_dtype, c.param_dtype, std,
                 lora_r=c.lora_r if name in c.lora_targets else 0, lora_alpha=c.lora_alpha)


class T5Attention(nn.Module):
    """Under tensor parallelism (:meth:`set_tensor_parallel`) ``config``
    holds this rank's head count, ``tp_heads`` its slice of the global
    heads: q / k / v column-parallel, ``o`` row-parallel, and the relative
    bias (a replicated leaf) read at this rank's head columns, its gradient
    summed over ``model``."""

    tp_heads: Optional[slice] = None
    tp_group = None

    def __init__(self, config: T5Config, has_relative_bias: bool = False, bidirectional: bool = True):
        super().__init__()
        c = self.config = config
        self.bidirectional = bidirectional
        inner, std = c.num_heads * c.d_kv, c.initializer_factor * c.d_model ** -0.5
        self.q = _dense(c, "q", c.d_model, inner, std)
        self.k = _dense(c, "k", c.d_model, inner, std)
        self.v = _dense(c, "v", c.d_model, inner, std)
        self.o = _dense(c, "o", inner, c.d_model, std)
        if has_relative_bias:
            self.relative_attention_bias = Embed(
                c.relative_attention_num_buckets, c.num_heads, c.compute_dtype, c.param_dtype, std
            )

    def compute_bias(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        """[1, H, Tq, Tk] position bias in the compute dtype."""
        c = self.config
        buckets = relative_position_bucket(
            k_pos[None, :] - q_pos[:, None], self.bidirectional, c.relative_attention_num_buckets,
            c.relative_attention_max_distance,
        )
        emb = self.relative_attention_bias
        if self.tp_heads is None:
            return emb(buckets).permute(2, 0, 1)[None]
        table = copy_to_group(emb.embedding, self.tp_group)[:, self.tp_heads]
        return F.embedding(buckets.long(), table).to(emb.dtype).permute(2, 0, 1)[None]

    def set_tensor_parallel(self, specs, key: str, group) -> None:
        """This rank's heads when the rules shard q over ``model``
        (:func:`~trlx_tpu_torch.models.transformer.set_tensor_parallel`)."""
        if spec_dim(specs[key + "q.kernel"], MODEL_AXIS) != 1:
            return
        H, m = self.config.num_heads, group.size
        if H % m:
            raise NotImplementedError(f"{H} T5 heads over model={m}: heads must divide the model axis")
        Hl = H // m
        self.tp_heads, self.tp_group = slice(group.index * Hl, (group.index + 1) * Hl), group
        self.config = self.config.replace(num_heads=Hl)

    def heads(self, proj: Dense, src: torch.Tensor) -> torch.Tensor:
        """``proj(src)`` as [B, H, S, D], the cache layout."""
        B, S, _ = src.shape
        return proj(src).reshape(B, S, self.config.num_heads, self.config.d_kv).transpose(1, 2)

    def forward(self, x, kv=None, mask_bias=None, position_bias=None, cache=None, kv_static=None):
        """x [B, T, D]; ``kv`` the encoder states (cross-attention);
        ``cache`` this layer's self-attention cache (written in place at
        ``index``); ``kv_static`` precomputed cross-attention (k, v)."""
        c = self.config
        B, T, _ = x.shape
        q = self.q(x).reshape(B, T, c.num_heads, c.d_kv)
        if kv_static is not None:
            kh, vh = kv_static
        else:
            src = x if kv is None else kv
            kh, vh = self.heads(self.k, src), self.heads(self.v, src)
            if cache is not None:
                write_kv_cache(cache, kh, vh, cache["index"])
                kh, vh = read_kv_cache(cache, c.compute_dtype)
        scores = torch.einsum("bthd,bhsd->bhts", q, kh).float()
        if position_bias is not None:
            scores = scores + position_bias.float()
        if mask_bias is not None:
            scores = scores + mask_bias
        probs = torch.softmax(scores, dim=-1).to(c.compute_dtype)
        out = torch.einsum("bhts,bhsd->bthd", probs, vh).reshape(B, T, c.num_heads * c.d_kv)
        return self.o(out)


class T5FFN(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        c = self.config = config
        std = c.initializer_factor * c.d_model ** -0.5
        if c.is_gated:
            self.wi_0 = _dense(c, "wi_0", c.d_model, c.d_ff, std)
            self.wi_1 = _dense(c, "wi_1", c.d_model, c.d_ff, std)
        else:
            self.wi = _dense(c, "wi", c.d_model, c.d_ff, std)
        self.wo = _dense(c, "wo", c.d_ff, c.d_model, std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.is_gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = torch.relu(self.wi(x))
        return self.wo(h)


class T5EncoderBlock(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.ln_1 = T5LayerNorm(config)
        self.attn = T5Attention(config, has_relative_bias, bidirectional=True)
        self.ln_2 = T5LayerNorm(config)
        self.mlp = T5FFN(config)

    def forward(self, x, mask_bias, position_bias):
        x = x + self.attn(self.ln_1(x), None, mask_bias, position_bias)
        return x + self.mlp(self.ln_2(x))


class T5DecoderBlock(nn.Module):
    def __init__(self, config: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.ln_1 = T5LayerNorm(config)
        self.self_attn = T5Attention(config, has_relative_bias, bidirectional=False)
        self.ln_cross = T5LayerNorm(config)
        self.cross_attn = T5Attention(config, False, bidirectional=True)
        self.ln_2 = T5LayerNorm(config)
        self.mlp = T5FFN(config)

    def forward(self, x, self_mask_bias, position_bias, enc_states, cross_mask_bias, cache=None, cross_kv=None):
        x = x + self.self_attn(self.ln_1(x), None, self_mask_bias, position_bias, cache)
        kv = None if cross_kv is not None else enc_states
        x = x + self.cross_attn(self.ln_cross(x), kv, cross_mask_bias, None, None, cross_kv)
        return x + self.mlp(self.ln_2(x))

    def cross_kv(self, enc_states: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention K/V from the encoder states, [B, H, S, D]."""
        return self.cross_attn.heads(self.cross_attn.k, enc_states), self.cross_attn.heads(self.cross_attn.v,
                                                                                            enc_states)


def self_bias_nocache(T: int, decoder_attention_mask: Optional[torch.Tensor], device) -> torch.Tensor:
    """Cache-free causal self-attention bias [*, 1, T, T]."""
    causal = torch.ones((T, T), dtype=torch.bool, device=device).tril()[None, None]
    if decoder_attention_mask is not None:
        causal = causal & decoder_attention_mask[:, None, None, :].bool()
    return _mask_bias(causal)


def cross_bias(encoder_attention_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if encoder_attention_mask is None:
        return None
    return _mask_bias(encoder_attention_mask[:, None, None, :].bool())


def _head(model: nn.Module, hidden: torch.Tensor) -> torch.Tensor:
    """The output head of ``model`` (a :class:`T5LM` or a :class:`T5Branch`):
    the tied embedding after scaling by ``d_model ** -0.5``, or ``lm_head``."""
    c = model.config
    if c.tie_word_embeddings:
        return model.shared.attend(hidden * c.d_model ** -0.5, c.compute_dtype)
    return model.lm_head(hidden)


def forward_branch(model: nn.Module, branch_hidden, enc_states, encoder_attention_mask, decoder_attention_mask,
                   position_bias, start_layer: int) -> torch.Tensor:
    """Decoder blocks ``start_layer`` and up, the final decoder norm and the
    head of ``model`` (a :class:`T5LM` or the frozen :class:`T5Branch`) from
    a captured activation: the reference's ``T5Branch``. The encoder states
    and the relative bias come from the live model."""
    T = branch_hidden.shape[1]
    self_mask_bias = self_bias_nocache(T, decoder_attention_mask, branch_hidden.device)
    cross_mask_bias = cross_bias(encoder_attention_mask)
    x = branch_hidden
    for i in range(start_layer, model.config.num_decoder_layers):
        x = getattr(model, f"decoder_blocks_{i}")(x, self_mask_bias, position_bias, enc_states, cross_mask_bias)
    return _head(model, model.decoder_ln(x))


class T5LM(nn.Module):
    """Encoder-decoder LM: :meth:`encode`, :meth:`decode` (with a cache),
    and ``forward`` (the full seq2seq forward: logits, decoder hidden,
    encoder states)."""

    def __init__(self, config: T5Config):
        super().__init__()
        c = self.config = config
        self.shared = Embed(c.vocab_size, c.d_model, c.compute_dtype, c.param_dtype, c.initializer_factor)
        for i in range(c.num_layers):
            setattr(self, f"encoder_blocks_{i}", T5EncoderBlock(c, has_relative_bias=i == 0))
        self.encoder_ln = T5LayerNorm(c)
        for i in range(c.num_decoder_layers):
            setattr(self, f"decoder_blocks_{i}", T5DecoderBlock(c, has_relative_bias=i == 0))
        self.decoder_ln = T5LayerNorm(c)
        if not c.tie_word_embeddings:
            self.lm_head = Dense(c.d_model, c.vocab_size, False, c.compute_dtype, c.param_dtype,
                                 c.initializer_factor)

    @property
    def encoder_blocks(self) -> List[T5EncoderBlock]:
        return [getattr(self, f"encoder_blocks_{i}") for i in range(self.config.num_layers)]

    @property
    def decoder_blocks(self) -> List[T5DecoderBlock]:
        return [getattr(self, f"decoder_blocks_{i}") for i in range(self.config.num_decoder_layers)]

    @property
    def device(self) -> torch.device:
        return self.shared.embedding.device

    def init_params(self, seed: int = 0) -> "T5LM":
        """Random weights from ``seed`` (the JAX module's initializers)."""
        return init_params(self, seed)

    def encode(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        S = input_ids.shape[1]
        x = self.shared(input_ids)
        mask_bias = cross_bias(attention_mask)
        pos = torch.arange(S, device=input_ids.device)
        position_bias = self.encoder_blocks_0.attn.compute_bias(pos, pos)
        for block in self.encoder_blocks:
            x = block(x, mask_bias, position_bias)
        return self.encoder_ln(x)

    def _decoder_stack(self, x, self_mask_bias, position_bias, enc_states, cross_mask_bias, cache, cross_kvs,
                       branch_layer=None):
        branch_hidden = None
        for i, block in enumerate(self.decoder_blocks):
            if i == branch_layer:
                branch_hidden = x
            layer_cache = None
            if cache is not None:
                layer_cache = {key: cache[key][i] for key in cache if key != "index"}
                layer_cache["index"] = cache["index"]
            ckv = None if cross_kvs is None else (cross_kvs[0][i], cross_kvs[1][i])
            x = block(x, self_mask_bias, position_bias, enc_states, cross_mask_bias, layer_cache, ckv)
        return self.decoder_ln(x), branch_hidden

    def decode(self, decoder_input_ids, enc_states, encoder_attention_mask=None, decoder_attention_mask=None,
               positions=None, cache=None, cross_kvs=None):
        """(logits, hidden, cache). With ``cache`` T may be 1: the rows land
        at slot ``cache["index"]`` (advanced by T here), ``positions`` give
        the decoder positions of the relative bias (default: the slots), and
        ``decoder_attention_mask`` covers every cache slot."""
        B, T = decoder_input_ids.shape
        dev = decoder_input_ids.device
        x = self.shared(decoder_input_ids)
        rel = self.decoder_blocks_0.self_attn
        if cache is not None:
            S = cache["k"][0].shape[2]
            idx = int(cache["index"])
            if positions is None:
                positions = idx + torch.arange(T, device=dev)
            elif positions.ndim > 1:
                positions = positions.reshape(-1)[:T]
            kv_slot = torch.arange(S, device=dev)[None, None, None, :]
            q_slot = (idx + torch.arange(T, device=dev))[None, None, :, None]
            causal = kv_slot <= q_slot
            if decoder_attention_mask is not None:
                causal = causal & decoder_attention_mask[:, None, None, :].bool()
            self_mask_bias = _mask_bias(causal)
            position_bias = rel.compute_bias(positions, torch.arange(S, device=dev))
        else:
            self_mask_bias = self_bias_nocache(T, decoder_attention_mask, dev)
            pos = torch.arange(T, device=dev)
            position_bias = rel.compute_bias(pos, pos)
        hidden, _ = self._decoder_stack(x, self_mask_bias, position_bias, enc_states,
                                        cross_bias(encoder_attention_mask), cache, cross_kvs)
        if cache is not None:
            cache["index"] = int(cache["index"]) + T
        return _head(self, hidden), hidden, cache

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None, decoder_attention_mask=None):
        """(logits, decoder hidden, encoder states)."""
        enc = self.encode(input_ids, attention_mask)
        logits, hidden, _ = self.decode(decoder_input_ids, enc, attention_mask, decoder_attention_mask)
        return logits, hidden, enc

    def forward_with_branch(self, input_ids, attention_mask, decoder_input_ids, decoder_attention_mask,
                            branch_layer: int):
        """The full forward that also captures the hydra branch point:
        (logits, hidden, encoder states, the input of decoder block
        ``branch_layer``, the decoder's relative bias)."""
        enc = self.encode(input_ids, attention_mask)
        T = decoder_input_ids.shape[1]
        x = self.shared(decoder_input_ids)
        pos = torch.arange(T, device=decoder_input_ids.device)
        position_bias = self.decoder_blocks_0.self_attn.compute_bias(pos, pos)
        hidden, branch_hidden = self._decoder_stack(
            x, self_bias_nocache(T, decoder_attention_mask, x.device), position_bias, enc,
            cross_bias(attention_mask), None, None, branch_layer=branch_layer,
        )
        return _head(self, hidden), hidden, enc, branch_hidden, position_bias

    def precompute_cross_kv(self, enc_states: torch.Tensor):
        """Per-layer lists (ks, vs) of cross-attention K/V."""
        kvs = [block.cross_kv(enc_states) for block in self.decoder_blocks]
        return [k for k, _ in kvs], [v for _, v in kvs]

    def init_cache(self, batch_size: int, max_length: int, dtype=None) -> Dict[str, Any]:
        """Per-layer decoder self-attention buffers (zeros) on the model's
        device, ``index`` 0."""
        c = self.config
        # this rank's heads under tensor parallelism
        shape = (batch_size, self.decoder_blocks_0.self_attn.config.num_heads, max_length, c.d_kv)
        per_layer = kv_cache_layout(shape, dtype or c.compute_dtype, c.kv_cache_quant)
        out: Dict[str, Any] = {
            key: [torch.zeros(shp, dtype=dt, device=self.device) for _ in range(c.num_decoder_layers)]
            for key, (shp, dt) in per_layer.items()
        }
        out["index"] = 0
        return out


class T5Branch(nn.Module):
    """The frozen decoder-top hydra reference: ``decoder_blocks_{start}`` ..
    ``decoder_blocks_{L-1}``, ``decoder_ln`` and the head (``shared`` when
    tied, else ``lm_head``) under the :class:`T5LM` names. It holds its own
    tensors: load it from
    :func:`trlx_tpu_torch.models.policy.t5_branch_param_subtree`."""

    def __init__(self, config: T5Config, start_layer: int):
        super().__init__()
        c = self.config = config
        self.start_layer = start_layer
        for i in range(start_layer, c.num_decoder_layers):
            setattr(self, f"decoder_blocks_{i}", T5DecoderBlock(c, has_relative_bias=i == 0))
        self.decoder_ln = T5LayerNorm(c)
        if c.tie_word_embeddings:
            self.shared = Embed(c.vocab_size, c.d_model, c.compute_dtype, c.param_dtype, c.initializer_factor)
        else:
            self.lm_head = Dense(c.d_model, c.vocab_size, False, c.compute_dtype, c.param_dtype,
                                 c.initializer_factor)

    def forward_branch(self, branch_hidden, enc_states, encoder_attention_mask, decoder_attention_mask,
                       position_bias, start_layer: int) -> torch.Tensor:
        if start_layer != self.start_layer:
            raise ValueError(f"this branch starts at decoder block {self.start_layer}, not {start_layer}")
        return forward_branch(self, branch_hidden, enc_states, encoder_attention_mask, decoder_attention_mask,
                              position_bias, start_layer)
