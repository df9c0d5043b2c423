"""Policy, value and reference model composition for PPO and ILQL
(counterpart of ``trlx_tpu/models/policy.py``):

- :class:`CausalLMWithValueHead`: trunk + value head, with an optional
  trainable value *branch* of top layers (``num_value_layers > 0``) fed from
  the trunk activation ``num_value_layers`` from the top.
- The hydra reference branch: :func:`branch_param_subtree` copies the top
  layers, the final norm and the head (or the tied embedding) of the trunk
  into a :class:`ModelBranch`, and :meth:`CausalLMWithValueHead.forward_branch`
  runs it from the activation ``forward(..., branch_layer=start)`` captured.
- :class:`CausalLMWithILQLHeads`: trunk + ILQL heads read at gathered
  state / action positions.
- The seq2seq (T5) counterparts: :class:`Seq2SeqLMWithValueHead` (a value
  MLP over the decoder's hidden states; its decoder-top hydra reference is
  :class:`~trlx_tpu_torch.models.t5.T5Branch`, loaded from
  :func:`t5_branch_param_subtree`) and :class:`Seq2SeqLMWithILQLHeads`.
"""

from typing import Dict, Optional

import torch
from torch import nn

from trlx_tpu_torch.methods.ilql import batched_index_select
from trlx_tpu_torch.models.heads import ILQLHeads, MLPHead, ValueHead
from trlx_tpu_torch.models.t5 import T5Config, T5LM
from trlx_tpu_torch.models.transformer import (
    STACKED_CAPTURE_ERROR,
    Block,
    Dense,
    Embed,
    KVCache,
    Norm,
    TransformerConfig,
    TransformerLM,
    capture_seq_group,
    forward_from,
    init_params,
    make_attn_bias,
)
from trlx_tpu_torch.parallel.sharding import constrain_gathered, sequence_parallel


class ModelBranch(nn.Module):
    """The hydra frozen reference branch: ``layers_{start_layer}`` ..
    ``layers_{L-1}``, the final norm and the output head (``lm_head``, or
    ``embed_tokens`` when the embedding is tied) of a :class:`TransformerLM`,
    under the trunk's parameter names. It holds its own tensors: load it from
    :func:`branch_param_subtree`, never from views of the trained trunk."""

    #: the ``model`` group a sequence-sharded capture is split over
    seq_group = None

    def __init__(self, config: TransformerConfig, start_layer: int):
        super().__init__()
        c = self.config = config
        self.start_layer = start_layer
        for i in range(start_layer, c.num_layers):
            setattr(self, f"layers_{i}", Block(c))
        if c.final_norm:
            self.ln_f = Norm(c)
        if c.tie_word_embeddings:
            self.embed_tokens = Embed(
                c.vocab_size, c.hidden_size, c.compute_dtype, c.param_dtype, c.initializer_range
            )
        else:
            self.lm_head = Dense(
                c.hidden_size, c.vocab_size, c.head_bias, c.compute_dtype, c.param_dtype, c.initializer_range
            )

    _final = TransformerLM._final

    def forward_from(self, hidden, attention_mask, positions, start_layer: int):
        """:meth:`TransformerLM.forward_from` over the branch's own layers."""
        if start_layer != self.start_layer:
            raise ValueError(f"this branch starts at layer {self.start_layer}, not {start_layer}")
        return forward_from(self, hidden, attention_mask, positions, start_layer)


class CausalLMWithValueHead(nn.Module):
    """Trunk LM + scalar value head. Parameter names follow the flax tree:
    ``transformer.*``, ``v_head.value_head.{fc_in,fc_out}.*`` and, with a
    value branch, ``value_blocks_{i}.*`` and ``value_ln.*``.
    ``branch_layer`` (when set in a call) returns the activation entering
    that layer, for the hydra reference branch. Under ``sequence_sharding``
    the value branch runs on the trunk's sequence-sharded capture and
    gathers before ``value_ln``."""

    #: the ``model`` group a sequence-sharded capture is split over
    seq_group = None

    def __init__(self, config: TransformerConfig, num_value_layers: int = 0):
        super().__init__()
        if num_value_layers > config.num_layers:
            raise ValueError(
                f"num_value_layers_unfrozen={num_value_layers} exceeds num_layers={config.num_layers}"
            )
        if num_value_layers > 0 and config.stacked:
            # the JAX module raises this at init, its first forward: the
            # value branch reads a mid-stack activation
            raise NotImplementedError(STACKED_CAPTURE_ERROR)
        self.config = config
        self.num_value_layers = num_value_layers
        self.transformer = TransformerLM(config)
        self.v_head = ValueHead(config)
        for i in range(num_value_layers):
            setattr(self, f"value_blocks_{i}", Block(config))
        if num_value_layers > 0:
            self.value_ln = Norm(config)

    @property
    def device(self) -> torch.device:
        return self.transformer.device

    def init_params(self, seed: int = 0) -> "CausalLMWithValueHead":
        """Random weights from ``seed`` (trunk, heads and value branch)."""
        return init_params(self, seed)

    def _value_branch(self, hidden, attention_mask, positions):
        sp = capture_seq_group(self, hidden, attention_mask)
        B, T = hidden.shape[0], hidden.shape[1] * (sp.size if sp is not None else 1)
        default_positions, mask_bias = make_attn_bias(self.config, attention_mask, B, T, hidden.device)
        if positions is None:
            positions = default_positions
        x = hidden
        with sequence_parallel(sp):
            for i in range(self.num_value_layers):
                x, _ = getattr(self, f"value_blocks_{i}")(x, mask_bias, positions, None, attention_mask)
        if sp is not None:
            x = constrain_gathered(x, sp)
        return self.v_head(self.value_ln(x))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        branch_layer: Optional[int] = None,
    ):
        """(logits [B,T,V], values [B,T] f32, branch activation or None, cache)."""
        if self.num_value_layers > 0:
            if cache is not None:
                # the trained value fn is value_ln(value_blocks(...)); v_head on the
                # trunk hidden would silently return meaningless numbers
                raise NotImplementedError(
                    "value-branch models do not support cached decode value reads; "
                    "use lm_only for generation"
                )
            value_start = self.config.num_layers - self.num_value_layers
            capture = sorted({value_start, *(() if branch_layer is None else (branch_layer,))})
            logits, _, captures, new_cache = self.transformer(
                input_ids, attention_mask, positions, cache, branch_layer=tuple(capture)
            )
            values = self._value_branch(captures[value_start], attention_mask, positions)
            branch_hidden = None if branch_layer is None else captures[branch_layer]
            return logits, values, branch_hidden, new_cache
        logits, hidden, branch_hidden, new_cache = self.transformer(
            input_ids, attention_mask, positions, cache, branch_layer=branch_layer
        )
        values = self.v_head(hidden)
        return logits, values, branch_hidden, new_cache

    def lm_only(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
    ):
        """Forward without the value head (generation decode steps)."""
        logits, _, _, new_cache = self.transformer(input_ids, attention_mask, positions, cache)
        return logits, new_cache

    def forward_branch(
        self,
        hidden: torch.Tensor,
        attention_mask: Optional[torch.Tensor],
        positions: Optional[torch.Tensor],
        start_layer: int,
        branch: Optional[ModelBranch] = None,
    ) -> torch.Tensor:
        """Hydra branch forward: ``layers[start_layer:]`` + head from a
        captured activation. ``branch`` is the frozen :class:`ModelBranch`
        (the JAX method applied with the frozen param subtree); without it
        the policy's own trunk runs."""
        model = self.transformer if branch is None else branch
        return model.forward_from(hidden, attention_mask, positions, start_layer)

    def init_cache(self, batch_size: int, max_length: int) -> KVCache:
        return self.transformer.init_cache(batch_size, max_length)


class CausalLMWithILQLHeads(nn.Module):
    """Trunk LM + ILQL {V, Q, target-Q} heads. Parameter names follow the
    flax tree: ``transformer.*`` and ``ilql_heads.*``."""

    def __init__(self, config: TransformerConfig, two_qs: bool = True):
        super().__init__()
        self.config = config
        self.transformer = TransformerLM(config)
        self.ilql_heads = ILQLHeads(config, two_qs=two_qs)

    @property
    def device(self) -> torch.device:
        return self.transformer.device

    def init_params(self, seed: int = 0) -> "CausalLMWithILQLHeads":
        """Random weights from ``seed`` (trunk and heads)."""
        return init_params(self, seed)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        actions_ixs: Optional[torch.Tensor] = None,
        states_ixs: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
    ):
        """(logits [B,T,V], qs, target_qs, vs, cache): the heads read the
        final hidden state at ``states_ixs`` (V) and ``actions_ixs`` (Q), or
        at every position when no indices are given."""
        logits, hidden, _, new_cache = self.transformer(input_ids, attention_mask, positions, cache)
        if states_ixs is not None:
            states_hs = batched_index_select(hidden, states_ixs)
            actions_hs = batched_index_select(hidden, actions_ixs)
        else:
            states_hs = actions_hs = hidden
        qs, target_qs, vs = self.ilql_heads(states_hs, actions_hs)
        return logits, qs, target_qs, vs, new_cache

    def heads_only(self, hidden: torch.Tensor):
        """The ILQL heads on trunk hidden states [B, T, H] (the advantage-shaped
        decode's processor)."""
        return self.ilql_heads(hidden, hidden)


def init_value_branch_from_trunk(
    state: Dict[str, torch.Tensor], config: TransformerConfig, num_value_layers: int
) -> Dict[str, torch.Tensor]:
    """A :class:`CausalLMWithValueHead` ``state_dict`` whose value branch
    starts as copies of the top ``num_value_layers`` trunk layers and the
    final norm, so the value function starts from trunk features, not from
    random weights. The copies share no storage with the trunk."""
    out = dict(state)
    start = config.num_layers - num_value_layers
    for i in range(num_value_layers):
        src = f"transformer.layers_{start + i}."
        for name, value in state.items():
            if name.startswith(src):
                out[f"value_blocks_{i}." + name[len(src):]] = value.detach().clone()
    if config.final_norm:
        for name, value in state.items():
            if name.startswith("transformer.ln_f."):
                out["value_ln." + name[len("transformer.ln_f."):]] = value.detach().clone()
    return out


def branch_param_subtree(
    trunk_state: Dict[str, torch.Tensor], start_layer: int, config: TransformerConfig
) -> Dict[str, torch.Tensor]:
    """The frozen reference branch's tensors from a :class:`TransformerLM`
    ``state_dict``: the layers from ``start_layer`` up, the final norm and the
    output head (or the tied embedding), as detached copies: a
    :class:`ModelBranch` loads them."""
    keep = [f"layers_{i}." for i in range(start_layer, config.num_layers)]
    if config.final_norm:
        keep.append("ln_f.")
    keep.append("embed_tokens." if config.tie_word_embeddings else "lm_head.")
    return {
        name: value.detach().clone()
        for name, value in trunk_state.items()
        if any(name.startswith(prefix) for prefix in keep)
    }


def t5_branch_param_subtree(
    t5_state: Dict[str, torch.Tensor], start_layer: int, config: T5Config
) -> Dict[str, torch.Tensor]:
    """The frozen decoder-top branch's tensors from a :class:`T5LM`
    ``state_dict``: decoder blocks from ``start_layer`` up, the final decoder
    norm and the head (the tied ``shared`` embedding or ``lm_head``), as
    detached copies that a :class:`~trlx_tpu_torch.models.t5.T5Branch`
    loads."""
    keep = [f"decoder_blocks_{i}." for i in range(start_layer, config.num_decoder_layers)]
    keep += ["decoder_ln.", "shared." if config.tie_word_embeddings else "lm_head."]
    return {
        name: value.detach().clone()
        for name, value in t5_state.items()
        if any(name.startswith(prefix) for prefix in keep)
    }


def _t5_head_cfg(t5_config: T5Config) -> TransformerConfig:
    """The head modules read ``hidden_size``, the vocabulary and the dtypes:
    a :class:`TransformerConfig` with the T5 config's."""
    return TransformerConfig(
        vocab_size=t5_config.vocab_size, hidden_size=t5_config.d_model,
        param_dtype=t5_config.param_dtype, compute_dtype=t5_config.compute_dtype,
    )


class Seq2SeqLMWithValueHead(nn.Module):
    """T5 + a scalar value MLP over the decoder hidden states. Parameter
    names follow the flax tree: ``t5.*`` and ``v_head_mlp.{fc_in,fc_out}.*``.
    Generation runs ``self.t5`` directly (``MeshRLTrainer.seq2seq_gen_fns``)."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.t5 = T5LM(config)
        self.v_head_mlp = MLPHead(_t5_head_cfg(config), out_dim=1)

    @property
    def device(self) -> torch.device:
        return self.t5.device

    def init_params(self, seed: int = 0) -> "Seq2SeqLMWithValueHead":
        return init_params(self, seed)

    def forward(self, input_ids, attention_mask, decoder_input_ids, decoder_attention_mask=None):
        """(logits, values [B, T] f32, encoder states)."""
        logits, hidden, enc = self.t5(input_ids, attention_mask, decoder_input_ids, decoder_attention_mask)
        return logits, self.v_head_mlp(hidden)[..., 0], enc

    def forward_with_branch(self, input_ids, attention_mask, decoder_input_ids, decoder_attention_mask,
                            branch_layer: int):
        """(logits, values, encoder states, branch activation, relative
        bias): the scoring forward beside the decoder-top hydra reference."""
        logits, hidden, enc, branch_hidden, position_bias = self.t5.forward_with_branch(
            input_ids, attention_mask, decoder_input_ids, decoder_attention_mask, branch_layer
        )
        return logits, self.v_head_mlp(hidden)[..., 0], enc, branch_hidden, position_bias


class Seq2SeqLMWithILQLHeads(nn.Module):
    """T5 + ILQL {V, Q, target-Q} heads over the decoder hidden states.
    Parameter names follow the flax tree: ``t5.*`` and ``ilql_heads.*``."""

    def __init__(self, config: T5Config, two_qs: bool = True):
        super().__init__()
        self.config = config
        self.t5 = T5LM(config)
        self.ilql_heads = ILQLHeads(_t5_head_cfg(config), two_qs=two_qs)

    @property
    def device(self) -> torch.device:
        return self.t5.device

    def init_params(self, seed: int = 0) -> "Seq2SeqLMWithILQLHeads":
        return init_params(self, seed)

    def forward(self, input_ids, attention_mask, decoder_input_ids, decoder_attention_mask=None,
                actions_ixs=None, states_ixs=None):
        """(logits, qs, target_qs, vs): the heads read the decoder hidden
        states at ``states_ixs`` (V) and ``actions_ixs`` (Q), or at every
        position."""
        logits, hidden, _ = self.t5(input_ids, attention_mask, decoder_input_ids, decoder_attention_mask)
        if states_ixs is not None:
            states_hs = batched_index_select(hidden, states_ixs)
            actions_hs = batched_index_select(hidden, actions_ixs)
        else:
            states_hs = actions_hs = hidden
        qs, target_qs, vs = self.ilql_heads(states_hs, actions_hs)
        return logits, qs, target_qs, vs

    def heads_only(self, hidden: torch.Tensor):
        """The ILQL heads on decoder hidden states (the advantage-shaped
        decode's processor)."""
        return self.ilql_heads(hidden, hidden)
