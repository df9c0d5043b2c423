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
        # the census comparator's stats (a def of this module), one transfer
        "trlx_tpu_torch.methods.ppo.build_ppo_train_step_unsharded_opt.step": 1,
    },
)
def build_ppo_train_step(device, size, shared):
    """One PPO optimizer step on a collated learner batch, as the training
    loop takes it (the reference's ``ppo_train_step``,
    ``trlx_tpu/methods/ppo.py:244``): ``PPOTrainer.train_step`` — the
    host-to-device copy, the microbatch forward and backward, the clip and
    the AdamW update, the stats to the host.

    Seed ``allgather`` (on a mesh): the policy's logits are gathered whole
    over the batch ranks in every forward of the step, each rank keeping
    its own rows."""
    from trlx_tpu_torch.analysis.census import fixtures, seeds
    from trlx_tpu_torch.parallel import collectives as coll

    tr = fixtures.trainer("ppo", device, size, shared)
    batches = fixtures.ppo_batches(size, tr)

    def gather_logits(module, args, out):
        group = tr.mesh.batch_group
        whole = coll.gather_from_group(out[0], group, dim=0)
        return (coll.local_slice(whole, group, 0),) + tuple(out[1:])

    def step(k):
        if seeds.active() != "allgather":
            return tr.train_step(batches[k])
        hook = tr.model.register_forward_hook(gather_logits)
        try:
            return tr.train_step(batches[k])
        finally:
            hook.remove()

    return Entry(step=step, optimizer=tr.optimizer)


#: the reference's mesh of its two overlap audit entries (``trlx_tpu/methods/ppo.py:400, 488``)
DATA2_FSDP2 = {"data": 2, "fsdp": 2, "pipe": 1, "model": 1}


@register_entrypoint(
    "ppo_train_step_overlap",
    mesh=DATA2_FSDP2,
    roots=(
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer.train_step",
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer.loss_fn",
        "trlx_tpu_torch.parallel.fsdp.make_overlapped_grad_accum_step",
        "trlx_tpu_torch.parallel.fsdp._Prefetcher.*",
        "trlx_tpu_torch.parallel.fsdp.global_norm_sharded",
        "trlx_tpu_torch.parallel.fsdp._clip_by_global_norm_sharded",
        "trlx_tpu_torch.parallel.collectives.*",
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
        # the overlapped FSDP step's stats, one transfer
        "trlx_tpu_torch.parallel.fsdp.make_overlapped_grad_accum_step.step": 1,
        # the comparator's stats, one transfer
        "trlx_tpu_torch.methods.ppo.build_ppo_train_step_unsharded_opt.step": 1,
    },
)
def build_ppo_train_step_overlap(device, size, shared):
    """One learner step of ``train.learner_overlap`` on ``data=2 x fsdp=2``
    (the reference's ``ppo_train_step_overlap``, ``trlx_tpu/methods/
    ppo.py:400``): :func:`~trlx_tpu_torch.parallel.fsdp.make_overlapped_grad_accum_step`
    through ``PPOTrainer.train_step``, each leaf gathered over ``fsdp`` a
    unit ahead of its forward, its gradient reduce-scattered over ``fsdp``
    as the backward reaches it, AdamW over this rank's shard.

    Seed ``allreduce_under_fsdp``: the reduce-scatter becomes a full-gradient
    all-reduce over ``fsdp`` and a local slice."""
    from unittest import mock

    from trlx_tpu_torch.analysis.census import fixtures, seeds
    from trlx_tpu_torch.parallel import collectives as coll

    tr = fixtures.trainer("ppo", device, size, shared, overlap=True)
    batches = fixtures.ppo_batches(size, tr)

    def all_reduce_then_slice(x, group, dim=0):
        total = coll.all_reduce(x, group)
        return lambda: coll.local_slice(total, group, dim).contiguous()

    def step(k):
        if seeds.active() != "allreduce_under_fsdp":
            return tr.train_step(batches[k])
        with mock.patch.object(coll, "reduce_scatter_async", all_reduce_then_slice):
            return tr.train_step(batches[k])

    return Entry(step=step, optimizer=tr.optimizer)


@register_entrypoint(
    "ppo_train_step_unsharded_opt",
    mesh=DATA2_FSDP2,
    roots=(
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer.train_step",
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer.loss_fn",
        "trlx_tpu_torch.parallel.fsdp.ShardedParams.*",
        "trlx_tpu_torch.parallel.fsdp._clip_by_global_norm_sharded",
        "trlx_tpu_torch.parallel.collectives.*",
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
        # the comparator's stats, one transfer
        "trlx_tpu_torch.methods.ppo.build_ppo_train_step_unsharded_opt.step": 1,
    },
)
def build_ppo_train_step_unsharded_opt(device, size, shared):
    """The memory comparator of :func:`build_ppo_train_step_overlap` (the
    reference's ``ppo_train_step_unsharded_opt``, ``trlx_tpu/methods/
    ppo.py:488``): the plain mesh step on the same mesh with AdamW's state
    whole on every rank. The leaves are gathered over ``fsdp`` for the
    microbatches, each whole gradient is all-reduced over ``data+fsdp``,
    every rank steps the whole leaves (AdamW over whole-leaf proxies) and
    keeps its shard of the result. Built here from the port's pieces: no
    trainer runs it (the step takes the batch to the device as
    ``train_step`` does, then runs in its place)."""
    from trlx_tpu_torch.analysis.census import fixtures
    from trlx_tpu_torch.parallel import collectives as coll
    from trlx_tpu_torch.parallel import mesh as mesh_lib
    from trlx_tpu_torch.parallel.fsdp import _clip_by_global_norm_sharded
    from trlx_tpu_torch.utils import get_optimizer_class, make_lr_scheduler

    # the overlap entry's trainer holds the modules and their shards; its
    # learner_overlap setting selects a step this entry does not run
    tr = fixtures.trainer("ppo", device, size, shared, overlap=True)
    batches = fixtures.ppo_batches(size, tr)
    mesh, num_mb = tr.mesh, tr.num_mb
    dp, group = mesh.axis_size(mesh_lib.BATCH_AXES), mesh.batch_group
    leaves = [tr.shards.by_param[id(p)] for p in tr._leaf_params]
    whole = [torch.nn.Parameter(leaf.master.new_empty(0), requires_grad=False) for leaf in leaves]
    kwargs = dict(tr.config.optimizer.kwargs)
    kwargs.pop("lr", None)
    kwargs.pop("max_grad_norm", None)
    optimizer = get_optimizer_class(tr.config.optimizer.name)(whole, learning_rate=1.0, **kwargs)
    scheduler = make_lr_scheduler(optimizer, tr.lr_schedule)

    def step(batch) -> Dict[str, float]:
        tr._rollout_model = None
        per_mb = []
        with tr.params_gathered():
            for mb in batch.split(num_mb):
                with coll.batch_group(group):
                    loss, stats = tr.loss_fn(mb.split(dp)[mesh.axis_index(mesh_lib.BATCH_AXES)])
                loss.backward()
                per_mb.append({k: torch.as_tensor(v, dtype=torch.float32, device=tr.device).detach()
                               for k, v in stats.items()})
            for leaf, proxy in zip(leaves, whole):
                g = leaf.param.grad if leaf.param.grad is not None else torch.zeros_like(leaf.param)
                proxy.data, proxy.grad = leaf.param.data, coll.all_reduce(g, group) / num_mb
                leaf.param.grad = None
        if tr.max_grad_norm:
            _clip_by_global_norm_sharded(None, [p.grad for p in whole], mesh, tr.max_grad_norm)
        keys = list(per_mb[0])
        means = torch.stack([torch.stack([s[k] for s in per_mb]).mean() for k in keys])
        lr = scheduler.get_last_lr()[0]
        optimizer.step()
        scheduler.step()
        with torch.no_grad():
            for leaf, proxy in zip(leaves, whole):
                if leaf.sharded:
                    leaf.master.copy_(coll.local_slice(proxy.data, tr.shards.fsdp, leaf.fsdp_dim))
                proxy.data, proxy.grad = proxy.data.new_empty(0), None
        out = dict(zip(keys, means.tolist()))
        out["learning_rate_group_0"] = float(lr)
        return out

    return Entry(step=lambda k: step(batches[k].to(tr.device)), optimizer=optimizer)
