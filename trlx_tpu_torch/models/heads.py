"""Value and ILQL head modules (counterpart of ``trlx_tpu/models/heads.py``):
the MLP head, the scalar value head, and the ILQL heads (a V head, one or
two Q heads over the vocabulary and their Polyak-synced target copies).
Parameter names follow the flax tree (``fc_in`` / ``fc_out``, kernels
``[in, out]``; ``q_heads_{i}``, ``target_q_heads_{i}``, ``v_head``). The
target heads train only through :func:`sync_target_q_heads`: trainers leave
them out of the optimizer."""

from typing import Optional

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


class QHead(nn.Module):
    """Q head over the full vocabulary: [B, T, H] -> [B, T, V]."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.q_head = MLPHead(config, out_dim=config.vocab_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.q_head(hidden)


class ILQLHeads(nn.Module):
    """V head + (1 or 2) Q heads + their target Q heads.

    ``forward(states_hs, actions_hs)`` -> (qs, target_qs, vs): qs and
    target_qs are tuples of [B, A, V] at the action positions (the target
    heads without a gradient), vs is [B, S, 1] at the state positions."""

    def __init__(self, config: TransformerConfig, two_qs: bool = True):
        super().__init__()
        self.n_qs = 2 if two_qs else 1
        for i in range(self.n_qs):
            setattr(self, f"q_heads_{i}", MLPHead(config, out_dim=config.vocab_size))
            setattr(self, f"target_q_heads_{i}", MLPHead(config, out_dim=config.vocab_size))
        self.v_head = MLPHead(config, out_dim=1)

    @property
    def q_heads(self):
        return [getattr(self, f"q_heads_{i}") for i in range(self.n_qs)]

    @property
    def target_q_heads(self):
        return [getattr(self, f"target_q_heads_{i}") for i in range(self.n_qs)]

    def forward(self, states_hs: torch.Tensor, actions_hs: Optional[torch.Tensor] = None):
        if actions_hs is None:
            actions_hs = states_hs
        qs = tuple(q(actions_hs) for q in self.q_heads)
        with torch.no_grad():
            target_qs = tuple(q(actions_hs) for q in self.target_q_heads)
        vs = self.v_head(states_hs)
        return qs, target_qs, vs


@torch.no_grad()
def sync_target_q_heads(heads: ILQLHeads, alpha: float) -> ILQLHeads:
    """Polyak-average the Q heads into the target Q heads in place:
    ``target = alpha * q + (1 - alpha) * target``."""
    for q, target in zip(heads.q_heads, heads.target_q_heads):
        for pq, pt in zip(q.parameters(), target.parameters()):
            pt.copy_(alpha * pq + (1.0 - alpha) * pt)
    return heads
