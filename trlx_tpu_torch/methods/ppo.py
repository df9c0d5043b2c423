"""PPO method: hyperparameters, KL controllers, GAE, and the clipped surrogate
loss (counterpart of ``trlx_tpu/methods/ppo.py``): the same fields and
defaults, the same GAE, the same loss and stats tree with the same f32
accumulations.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from trlx_tpu_torch.analysis.census.entrypoints import Entry, register_entrypoint
from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.parallel.collectives import batch_count, batch_max, batch_mean, batch_min, batch_sum
from trlx_tpu_torch.rollout.staleness import staleness_importance_weights
from trlx_tpu_torch.utils.modeling import masked_mean, whiten


class AdaptiveKLController:
    """Adaptive KL coefficient per https://arxiv.org/abs/1909.08593 §2.2."""

    def __init__(self, init_kl_coef: float, target: float, horizon: int):
        self.value = init_kl_coef
        self.target = target
        self.horizon = horizon

    def update(self, current: float, n_steps: int):
        proportional_error = min(0.2, max(-0.2, float(current) / self.target - 1))
        self.value *= 1 + proportional_error * n_steps / self.horizon


class FixedKLController:
    """Constant KL coefficient."""

    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current: float, n_steps: int):
        pass


@torch.no_grad()
def gae_advantages_and_returns(
    values: torch.Tensor,
    rewards: torch.Tensor,
    mask: torch.Tensor,
    gamma: float,
    lam: float,
    use_whitening: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized Advantage Estimation over the response window.

    values/rewards/mask are [B, T] over response tokens (mask 1 on real
    response tokens). A reverse loop over time (the JAX package's reverse
    ``lax.scan``); positions past a sample's response end contribute
    nothing: bootstrap values and deltas are masked by the next position's
    mask. No gradient flows through the result."""
    mask = mask.to(values.dtype)
    values = values * mask
    rewards = rewards * mask
    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], dim=1)
    next_mask = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1)
    deltas = rewards + gamma * next_values * next_mask - values
    carry = torch.zeros_like(deltas[:, 0])
    adv = torch.empty_like(deltas)
    for t in range(deltas.shape[1] - 1, -1, -1):
        carry = deltas[:, t] + gamma * lam * next_mask[:, t] * carry
        adv[:, t] = carry
    advantages = adv * mask
    returns = advantages + values
    if use_whitening:
        advantages = whiten(advantages, mask=mask) * mask
    return advantages, returns


@register_method
@dataclass
class PPOConfig(MethodConfig):
    """PPO hyperparameters (the JAX package's fields and defaults).

    :param num_rollouts: rollouts collected per experience phase.
    :param chunk_size: prompts per generation batch during rollout.
    :param ppo_epochs: optimization epochs per experience batch.
    :param init_kl_coef / target / horizon: KL controller (adaptive if target set).
    :param gamma / lam: GAE discounting.
    :param cliprange / cliprange_value / vf_coef: clipped-loss coefficients.
    :param scale_reward: None | "ref" | "running" reward scaling.
    :param cliprange_reward: clip scores to ±value before KL assembly.
    :param gen_kwargs / gen_experience_kwargs: generation settings (eval / rollout).
    :param num_value_layers_unfrozen: depth of the separate value branch (0 = head only).
    :param overlap_reward_scoring: score chunk i while chunk i+1 generates.
    :param decode_batch_size: prompts per generation batch (default chunk_size).
    """

    name: str = "PPOConfig"
    ppo_epochs: int = 4
    num_rollouts: int = 128
    chunk_size: int = 128
    init_kl_coef: float = 0.05
    target: Optional[float] = 6.0
    horizon: int = 10000
    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    vf_coef: float = 1.0
    scale_reward: Optional[str] = "ignored"
    ref_mean: Optional[float] = None
    ref_std: Optional[float] = None
    cliprange_reward: float = 10.0
    gen_kwargs: Dict[str, Any] = field(default_factory=lambda: dict(max_new_tokens=16))
    gen_experience_kwargs: Optional[Dict[str, Any]] = None
    num_value_layers_unfrozen: int = 0
    overlap_reward_scoring: bool = False
    decode_batch_size: Optional[int] = None

    def kl_controller(self):
        if self.target is not None:
            return AdaptiveKLController(self.init_kl_coef, self.target, self.horizon)
        return FixedKLController(self.init_kl_coef)

    def get_advantages_and_returns(self, values, rewards, mask, use_whitening: bool = True):
        return gae_advantages_and_returns(values, rewards, mask, self.gamma, self.lam, use_whitening)

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
        """Clipped PPO policy + value loss with the JAX package's stats dict.
        All inputs are [B, T_resp] and masked; every sum accumulates in f32.

        With ``staleness`` ([B] policy-version lag from the async rollout
        engine) and ``is_ratio_clip`` both set, the policy term of stale
        samples is reweighted by clipped per-token importance weights
        against the behavior-policy ``old_logprobs``. The weights are
        exactly 1.0 at staleness 0, so on-policy losses equal the vanilla
        path's bit for bit."""
        f32 = torch.float32
        mask = mask.to(values.dtype)
        n = torch.clamp(batch_sum(mask.sum(dtype=f32)), min=1.0)

        values_clipped = torch.clamp(
            values, old_values - self.cliprange_value, old_values + self.cliprange_value
        )
        vf_loss1 = (values - returns) ** 2
        vf_loss2 = (values_clipped - returns) ** 2
        vf_loss = 0.5 * batch_sum(torch.sum(torch.maximum(vf_loss1, vf_loss2) * mask, dtype=f32)) / n
        vf_clipfrac = batch_sum(torch.sum((vf_loss2 > vf_loss1).to(mask.dtype) * mask, dtype=f32)) / n

        log_ratio = (logprobs - old_logprobs) * mask
        ratio = torch.exp(log_ratio)
        # k3 estimator of approximate KL: mean(exp(-lr) - 1 + lr)
        approx_kl = batch_sum(torch.sum((torch.exp(-log_ratio) - 1.0 + log_ratio) * mask, dtype=f32)) / n

        is_weights = None
        if staleness is not None and is_ratio_clip is not None:
            # reweight the surrogate's advantages (w > 0 commutes with the
            # clipped max below); the weights are detached, a fixed
            # per-token correction, not a second policy-gradient path
            is_weights = staleness_importance_weights(log_ratio, staleness, is_ratio_clip)
            advantages = advantages * is_weights

        pg_loss1 = -advantages * ratio
        pg_loss2 = -advantages * torch.clamp(ratio, 1.0 - self.cliprange, 1.0 + self.cliprange)
        pg_loss = batch_sum(torch.sum(torch.maximum(pg_loss1, pg_loss2) * mask, dtype=f32)) / n
        pg_clipfrac = batch_sum(torch.sum((pg_loss2 > pg_loss1).to(mask.dtype) * mask, dtype=f32)) / n

        loss = pg_loss + self.vf_coef * vf_loss

        # filled on the device: torch.tensor(inf, device=...) would copy a host scalar and wait for it
        inf = values.new_full((), float("inf"))
        values_mean = masked_mean(values, mask)
        returns_mean = masked_mean(returns, mask)
        stats = dict(
            losses=dict(total_loss=loss, policy_loss=pg_loss, value_loss=vf_loss),
            values=dict(
                get_tensor_stats=dict(
                    mean=values_mean,
                    min=batch_min(torch.min(torch.where(mask > 0, values, inf))),
                    max=batch_max(torch.max(torch.where(mask > 0, values, -inf))),
                    std=torch.sqrt(masked_mean((values - values_mean) ** 2, mask)),
                ),
                values_error=batch_sum(torch.sum(((values - returns) * mask) ** 2, dtype=f32)) / n,
                clipfrac=vf_clipfrac,
            ),
            old_values=dict(mean=masked_mean(old_values, mask)),
            returns=dict(
                mean=returns_mean,
                std=torch.sqrt(masked_mean((returns - returns_mean) ** 2, mask)),
            ),
            policy=dict(approx_kl=approx_kl, clipfrac=pg_clipfrac),
            ratio=batch_sum(torch.sum(ratio * mask, dtype=f32)) / n,
            padding_percentage=1.0 - n / batch_count(mask.numel()),
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
    "ppo_train_step",
    roots=(
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer.train_step",
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer.loss_fn",
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.make_grad_accum_step",
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.clip_grads",
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.global_grad_norm",
        "trlx_tpu_torch.data.ppo_types.PPORLBatch.*",
        "trlx_tpu_torch.methods.ppo.*",
        "trlx_tpu_torch.models.policy.CausalLMWithValueHead.*",
        "trlx_tpu_torch.models.transformer.*",
        "trlx_tpu_torch.ops.attention.*",
        "trlx_tpu_torch.utils.modeling.logprobs_of_labels",
        "trlx_tpu_torch.utils.modeling.masked_mean",
        "trlx_tpu_torch.utils.modeling.masked_var",
        "trlx_tpu_torch.utils.modeling.whiten",
    ),
    readback={
        # the step's stats reach the host in one transfer (one site per health-guard branch)
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.make_grad_accum_step.step": 2,
        # the overlapped FSDP step's stats, one transfer
        "trlx_tpu_torch.parallel.fsdp.make_overlapped_grad_accum_step.step": 1,
    },
)
def build_ppo_train_step(device, size, shared):
    """One PPO optimizer step on a collated learner batch, as the training
    loop takes it (the reference's ``ppo_train_step``,
    ``trlx_tpu/methods/ppo.py:244``): ``PPOTrainer.train_step`` — the
    host-to-device copy, the microbatch forward and backward, the clip and
    the AdamW update, the stats to the host."""
    from trlx_tpu_torch.analysis.census import fixtures

    tr = fixtures.trainer("ppo", device, size, shared)
    batches = fixtures.ppo_batches(size, tr.tokenizer.pad_token_id)
    return Entry(step=lambda k: tr.train_step(batches[k]))
