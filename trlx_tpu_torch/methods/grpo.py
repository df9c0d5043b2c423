"""GRPO method: critic-free group-relative policy optimization (counterpart
of ``trlx_tpu/methods/grpo.py``).

GRPO (Group Relative Policy Optimization, Shao et al. 2024, DeepSeekMath)
replaces PPO's learned value baseline with a *group* baseline: for each
prompt, sample a group of G completions, score them, and normalize each
score against the group's own mean and standard deviation:

    A_i = (r_i - mean(r_group)) / (std(r_group) + eps)

No value loss and no GAE bootstrap: the surrogate is PPO's clipped policy
term driven by the group-relative advantage spread over response tokens as
discounted returns-to-go, plus the per-token KL-to-reference shaping the
PPO path already assembles in ``_score_and_store``. Microbatching, the
optimizer step and the staleness importance weights are inherited from
:class:`PPOConfig` / ``PPOTrainer`` unchanged.

Two exact properties the tests pin:

- a constant-reward group normalizes to *exactly* zero advantage (the
  centered residual is identically 0 before the std division);
- for identical inputs, ``GRPOConfig.loss`` equals the ``policy_loss``
  component of ``PPOConfig.loss``.

The JAX package's AOT audit entry point (``grpo_train_step``, graftcheck)
has no counterpart here.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.analysis.census.entrypoints import Entry, register_entrypoint
from trlx_tpu_torch.data.method_configs import register_method
from trlx_tpu_torch.methods.ppo import PPOConfig, gae_advantages_and_returns
from trlx_tpu_torch.rollout.staleness import staleness_importance_weights
from trlx_tpu_torch.parallel.collectives import batch_max, batch_mean, batch_sum
from trlx_tpu_torch.utils.modeling import masked_mean

#: guard for the group-std division — centered residuals of a constant
#: group are exactly zero, so eps only sets the scale of near-ties
GROUP_EPS = 1e-6


@register_method
@dataclass
class GRPOConfig(PPOConfig):
    """GRPO hyperparameters: :class:`PPOConfig` minus the critic.

    :param group_size: completions sampled per prompt; scores normalize
        within each group. ``num_rollouts`` and ``chunk_size`` must both be
        multiples of ``group_size`` so groups never straddle a scoring
        chunk.
    :param whiten_advantages: re-whiten the per-token advantages over the
        batch after the group normalization (off by default: the group
        baseline *is* the normalization).

    Inherited value-function fields (``vf_coef``, ``cliprange_value``,
    ``num_value_layers_unfrozen``) are inert: the loss has no value term.
    """

    name: str = "GRPOConfig"
    group_size: int = 4
    whiten_advantages: bool = False
    # groups need diverse completions — greedy decode makes every group
    # member identical and every advantage zero
    gen_kwargs: Dict[str, Any] = field(default_factory=lambda: dict(max_new_tokens=16, do_sample=True))

    def __post_init__(self):
        if self.group_size < 2:
            raise ValueError(
                f"group_size must be >= 2 (a singleton group has zero "
                f"advantage by construction), got {self.group_size}"
            )
        if self.num_rollouts % self.group_size != 0:
            raise ValueError(
                f"num_rollouts ({self.num_rollouts}) must be a multiple of group_size ({self.group_size})"
            )
        if self.chunk_size % self.group_size != 0:
            raise ValueError(
                f"chunk_size ({self.chunk_size}) must be a multiple of "
                f"group_size ({self.group_size}) — groups must not straddle scoring chunks"
            )

    # ------------------------------------------------------------ group math

    def group_normalize(self, scores: np.ndarray) -> np.ndarray:
        """Host-side group-relative normalization of a flat score vector.

        ``scores`` is [B] with B a multiple of ``group_size`` and group
        members adjacent. Returns [B] advantages; a constant group yields
        exact zeros."""
        scores = np.asarray(scores, dtype=np.float32)
        if scores.ndim != 1 or scores.size % self.group_size != 0:
            raise ValueError(
                f"scores must be flat with size a multiple of group_size="
                f"{self.group_size}, got shape {scores.shape}"
            )
        grouped = scores.reshape(-1, self.group_size)
        centered = grouped - grouped.mean(axis=1, keepdims=True)
        std = np.sqrt((centered ** 2).mean(axis=1, keepdims=True))
        return (centered / (std + GROUP_EPS)).reshape(-1)

    def get_advantages_and_returns(self, values, rewards, mask, use_whitening: bool = True):
        """Critic-free advantages: discounted returns-to-go of the per-token
        rewards, computed as GAE with a zero value baseline and ``lam=1``.
        Returns zero "returns" (no gradient), which the loss ignores."""
        zeros = torch.zeros_like(rewards)
        advantages, _ = gae_advantages_and_returns(
            zeros, rewards, mask, self.gamma, 1.0,
            use_whitening=use_whitening and self.whiten_advantages,
        )
        return advantages, zeros

    # ------------------------------------------------------------------ loss

    def loss(
        self,
        logprobs: torch.Tensor,
        values: torch.Tensor,
        old_logprobs: torch.Tensor,
        old_values: torch.Tensor,
        advantages: torch.Tensor,
        returns: torch.Tensor,
        mask: torch.Tensor,
        staleness: Optional[torch.Tensor] = None,
        is_ratio_clip: Optional[float] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """PPO's clipped policy surrogate with NO value term.

        Same signature as :meth:`PPOConfig.loss`; ``values`` /
        ``old_values`` / ``returns`` are accepted and ignored. Stats mirror
        PPO's key layout (``losses/value_loss`` is a constant 0) plus a
        ``group`` block: the advantage spread driving the update and
        ``policy_delta`` = mean |ratio - 1|."""
        f32 = torch.float32
        mask = mask.to(logprobs.dtype)
        n = torch.clamp(batch_sum(mask.sum(dtype=f32)), min=1.0)

        log_ratio = (logprobs - old_logprobs) * mask
        ratio = torch.exp(log_ratio)
        # k3 estimator of approximate KL: mean(exp(-lr) - 1 + lr)
        approx_kl = batch_sum(torch.sum((torch.exp(-log_ratio) - 1.0 + log_ratio) * mask, dtype=f32)) / n

        is_weights = None
        if staleness is not None and is_ratio_clip is not None:
            is_weights = staleness_importance_weights(log_ratio, staleness, is_ratio_clip)
            advantages = advantages * is_weights

        pg_loss1 = -advantages * ratio
        pg_loss2 = -advantages * torch.clamp(ratio, 1.0 - self.cliprange, 1.0 + self.cliprange)
        pg_loss = batch_sum(torch.sum(torch.maximum(pg_loss1, pg_loss2) * mask, dtype=f32)) / n
        pg_clipfrac = batch_sum(torch.sum((pg_loss2 > pg_loss1).to(mask.dtype) * mask, dtype=f32)) / n

        loss = pg_loss

        adv_mean = masked_mean(advantages, mask)
        adv_std = torch.sqrt(masked_mean((advantages - adv_mean) ** 2, mask))
        policy_delta = batch_sum(torch.sum(torch.abs(ratio - 1.0) * mask, dtype=f32)) / n

        stats = dict(
            losses=dict(
                total_loss=loss, policy_loss=pg_loss, value_loss=torch.zeros((), dtype=f32, device=logprobs.device)
            ),
            policy=dict(approx_kl=approx_kl, clipfrac=pg_clipfrac),
            group=dict(adv_mean=adv_mean, adv_std=adv_std, policy_delta=policy_delta),
            ratio=batch_sum(torch.sum(ratio * mask, dtype=f32)) / n,
            padding_percentage=1.0 - n / mask.numel(),
        )
        if is_weights is not None:
            stats["staleness"] = dict(
                mean=batch_mean(staleness.to(f32)),
                max=batch_max(torch.max(staleness)),
                is_weight_mean=batch_sum(torch.sum(is_weights * mask, dtype=f32)) / n,
            )
        return loss, stats


# -- the census (python -m trlx_tpu_torch.analysis.census) ---------------------


@register_entrypoint(
    "grpo_train_step",
    roots=(
        "trlx_tpu_torch.trainer.grpo_trainer.GRPOTrainer.train_step",
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer.train_step",
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer.loss_fn",
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.make_grad_accum_step",
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.clip_grads",
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.global_grad_norm",
        "trlx_tpu_torch.data.ppo_types.PPORLBatch.*",
        "trlx_tpu_torch.methods.grpo.GRPOConfig.loss",
        "trlx_tpu_torch.models.policy.CausalLMWithValueHead.*",
        "trlx_tpu_torch.models.transformer.*",
        "trlx_tpu_torch.ops.attention.*",
        "trlx_tpu_torch.utils.modeling.logprobs_of_labels",
        "trlx_tpu_torch.utils.modeling.masked_mean",
    ),
    readback={
        # the step's stats, one transfer (one site per health-guard branch)
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.make_grad_accum_step.step": 2,
        # the overlapped FSDP step's stats, one transfer
        "trlx_tpu_torch.parallel.fsdp.make_overlapped_grad_accum_step.step": 1,
    },
)
def build_grpo_train_step(device, size, shared):
    """One GRPO optimizer step on a collated learner batch
    (``GRPOTrainer.train_step``; the reference's ``grpo_train_step``,
    ``trlx_tpu/methods/grpo.py:223``)."""
    from trlx_tpu_torch.analysis.census import fixtures

    tr = fixtures.trainer("grpo", device, size, shared)
    batches = fixtures.ppo_batches(size, tr)
    return Entry(step=lambda k: tr.train_step(batches[k]), optimizer=tr.optimizer)
