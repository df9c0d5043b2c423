"""Value head modules (counterpart of ``trlx_tpu/models/heads.py``: the MLP
head and the scalar value head; the ILQL heads come with the ILQL slice).
Parameter names follow the flax tree (``fc_in`` / ``fc_out``, kernels
``[in, out]``)."""

import torch
from torch import nn

from trlx_tpu_torch.models.transformer import Dense, TransformerConfig


class MLPHead(nn.Module):
    """Two-layer head: hidden -> 2*hidden -> ReLU -> out. ``fc_in`` runs in
    the compute dtype; ``fc_out`` runs in f32, as the JAX head."""

    def __init__(self, config: TransformerConfig, out_dim: int = 1):
        super().__init__()
        c = self.config = config
        self.fc_in = Dense(
            c.hidden_size, 2 * c.hidden_size, True, c.compute_dtype, c.param_dtype, c.initializer_range
        )
        self.fc_out = Dense(
            2 * c.hidden_size, out_dim, True, torch.float32, c.param_dtype, c.initializer_range
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.fc_in(x.to(self.config.compute_dtype)))
        return self.fc_out(h)


class ValueHead(nn.Module):
    """Scalar value head returning [B, T] float32 values."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.value_head = MLPHead(config, out_dim=1)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.value_head(hidden)[..., 0]
