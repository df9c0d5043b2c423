"""Policy/value model composition for PPO (counterpart of
``trlx_tpu/models/policy.py``: ``CausalLMWithValueHead`` with the value
head on the trunk's final hidden state). The separate value branch
(``num_value_layers > 0``), the hydra reference branch and the ILQL and
seq2seq models come with later slices.
"""

from typing import Optional

import torch
from torch import nn

from trlx_tpu_torch.models.heads import ValueHead
from trlx_tpu_torch.models.transformer import KVCache, TransformerConfig, TransformerLM, init_params


class CausalLMWithValueHead(nn.Module):
    """Trunk LM + scalar value head. Parameter names follow the flax tree:
    ``transformer.*`` and ``v_head.value_head.{fc_in,fc_out}.*``."""

    def __init__(self, config: TransformerConfig, num_value_layers: int = 0):
        super().__init__()
        if num_value_layers > config.num_layers:
            raise ValueError(
                f"num_value_layers_unfrozen={num_value_layers} exceeds num_layers={config.num_layers}"
            )
        if num_value_layers > 0:
            raise NotImplementedError(
                "trlx_tpu_torch does not port the value branch (num_value_layers_unfrozen > 0) "
                "yet: hydra slice"
            )
        self.config = config
        self.num_value_layers = num_value_layers
        self.transformer = TransformerLM(config)
        self.v_head = ValueHead(config)

    @property
    def device(self) -> torch.device:
        return self.transformer.device

    def init_params(self, seed: int = 0) -> "CausalLMWithValueHead":
        """Random weights from ``seed`` (trunk and head)."""
        return init_params(self, seed)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        branch_layer: Optional[int] = None,
    ):
        """(logits [B,T,V], values [B,T] f32, None, cache)."""
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

    def init_cache(self, batch_size: int, max_length: int) -> KVCache:
        return self.transformer.init_cache(batch_size, max_length)
