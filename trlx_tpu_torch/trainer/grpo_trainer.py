"""GRPO trainer: group-relative PPO without a critic, online-fed or
self-fed (counterpart of ``trlx_tpu/trainer/grpo_trainer.py``).

One subclass away from :class:`~trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer`.
GRPO changes three things and inherits everything else (microbatching, the
optimizer step, async rollouts, the serving engine, checkpoints):

1. **Group generation** — each drawn prompt is repeated ``group_size``
   times adjacently in the decode batch, so every scoring chunk holds whole
   groups. A decode batch of B prompts becomes B/G unique prompts × G
   repeats, never B×G sequences.
2. **Group scoring** — scalar rewards are normalized against their own
   group's mean/std (``GRPOConfig.group_normalize``) before the inherited
   ``_score_and_store`` assembles KL-penalized per-token rewards; the
   critic-free ``GRPOConfig.get_advantages_and_returns`` turns them into
   returns-to-go advantages inside the loss.
3. **Online experience** — with ``train.online.enabled`` the experience
   phase first drains labeled groups from an
   :class:`~trlx_tpu_torch.online.buffer.OnlineExperienceBuffer` (fed by a
   :class:`~trlx_tpu_torch.online.collector.PreferenceCollector`), scoring
   the stored completions through the same forward pass as self-generated
   rollouts; self-generation tops up any shortfall.

The behavior logprobs of online groups are recomputed under the *current*
policy at consumption time, so the PPO ratio starts at 1 and the group
advantage drives the first step; version lag is bounded by the buffer's
staleness admission.

The value head stays in the model and runs in every forward, though the
loss never reads it: it changes no number (its gradient is zero, and the
optimizer step decays it as optax does), where the JAX package's ``jit``
removes it as dead code.

Gauges: ``online/group_adv_std`` (mean within-group std of normalized
advantages), ``online/raw_score_std``, ``online/policy_delta`` (mean
|ratio-1| from the loss), plus the buffer / collector families.
"""

from typing import Dict, List

import numpy as np

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.ppo_types import PPORLElement
from trlx_tpu_torch.methods.grpo import GRPOConfig
from trlx_tpu_torch.online.buffer import OnlineExperienceBuffer
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)


@register_trainer
class GRPOTrainer(PPOTrainer):
    def __init__(self, config: TRLConfig, **kwargs):
        super().__init__(config, **kwargs)
        if not isinstance(config.method, GRPOConfig):
            raise ValueError("GRPOTrainer requires method=GRPOConfig")
        self.method: GRPOConfig = config.method
        g = self.method.group_size
        dbs = self.method.decode_batch_size
        if dbs is not None and dbs % g != 0:
            raise ValueError(
                f"decode_batch_size ({dbs}) must be a multiple of group_size ({g}) "
                f"— groups must not straddle decode batches"
            )
        gen = self.method.gen_experience_kwargs or self.method.gen_kwargs
        if not gen.get("do_sample", False):
            logger.warning(
                "GRPO with greedy decoding: all group members will be identical and every "
                "group advantage zero — set do_sample=True in gen_kwargs"
            )

        # online experience (train.online): the buffer is built here so
        # collectors can attach before learning starts; attach_online swaps
        # in an externally fed buffer
        online = config.train.online
        self._online_cfg = online if online.enabled else None
        self._online_buffer = None
        if self._online_cfg is not None:
            if self._online_cfg.group_size != g:
                raise ValueError(
                    f"train.online.group_size ({self._online_cfg.group_size}) must match method.group_size ({g})"
                )
            self._online_buffer = OnlineExperienceBuffer(
                capacity=self._online_cfg.buffer_capacity, max_staleness=self._online_cfg.max_staleness
            )

    # ----------------------------------------------------------- online feed

    @property
    def online_buffer(self):
        return self._online_buffer

    def attach_online(self, buffer) -> None:
        """Install an externally fed experience buffer (the collector's).
        Requires ``train.online.enabled``: with it off the trainer stays the
        self-generating GRPO path."""
        if self._online_cfg is None:
            raise ValueError("attach_online requires train.online.enabled=True")
        self._online_buffer = buffer

    # ------------------------------------------------------ group generation

    def add_prompt_pipeline(self, pipeline):
        """Attach the prompt pipeline, regrouped: each decode batch keeps its
        size but holds B/G unique prompts repeated G times adjacently."""
        super().add_prompt_pipeline(pipeline)
        g = self.method.group_size
        base = self.prompt_iterator

        def grouped(stream):
            for batch in stream:
                keep = max(1, len(batch["input_ids"]) // g)
                yield {k: [v[i] for i in range(keep) for _ in range(g)] for k, v in batch.items()}

        self.prompt_iterator = grouped(base)

    # --------------------------------------------------------- group scoring

    def _score_and_store(self, chunk, scores, ppo_rl_elements, accumulated_kl, all_scores_log, policy=None):
        """Group-normalize scalar scores, then defer to the inherited
        assembly. Dense (per-token) rewards collapse to their sum first: the
        group baseline is defined over sequence-level scores."""
        if np.ndim(scores[0]) > 0:
            scores = np.asarray([np.asarray(s, np.float32).sum() for s in scores], np.float32)
        else:
            scores = np.asarray(scores, np.float32).reshape(-1)
        g = self.method.group_size
        gauges.set("online/raw_score_std", float(scores.reshape(-1, g).std(axis=1).mean()))
        normalized = self.method.group_normalize(scores)
        gauges.set("online/group_adv_std", float(normalized.reshape(-1, g).std(axis=1).mean()))
        super()._score_and_store(chunk, normalized, ppo_rl_elements, accumulated_kl, all_scores_log, policy=policy)

    # ------------------------------------------------------ online experience

    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0):
        """Experience phase: drain harvested groups first (online), then top
        up by self-generation. With online off (or an empty buffer) this is
        the inherited path."""
        buffer = self._online_buffer
        if buffer is None or len(buffer) == 0:
            return super().make_experience(num_rollouts, iter_count)

        g = self.method.group_size
        elements: List[PPORLElement] = []
        accumulated_kl: List[float] = []
        all_scores_log: List[float] = []
        self._phase_time = {"generate": 0.0, "reward": 0.0, "score": 0.0}
        self.clock.tick()
        groups = buffer.drain(max(1, num_rollouts // g), learner_version=self._policy_version)
        logger.info(
            f"Consuming {len(groups)} harvested groups ({len(groups) * g}/{num_rollouts} rollouts) "
            f"from the online buffer"
        )
        for group in groups:
            if any(len(c) == 0 for c in group.completions):
                continue  # an empty completion has no last token to score
            chunk = ([list(group.prompt)] * group.group_size, [list(c) for c in group.completions])
            n0 = len(elements)
            # one group per scoring call keeps the version stamp exact even
            # when the quarantine screen drops elements mid-chunk
            self._score_and_store(chunk, group.scores, elements, accumulated_kl, all_scores_log)
            for e in elements[n0:]:
                e.policy_version = group.policy_version
        gauges.set("online/groups_consumed", float(len(groups)))

        # top up the shortfall by self-generation (traffic ran short)
        if len(elements) < num_rollouts and self.reward_fn is None:
            logger.warning(
                f"online buffer supplied {len(elements)}/{num_rollouts} rollouts and no reward_fn is "
                f"attached to top up: training on the short batch"
            )
        else:
            # reward_fn runs under the ``reward`` span (PPOTrainer._timed_reward_fn)
            while len(elements) < num_rollouts:
                self._collect_chunks(elements, accumulated_kl, all_scores_log)

        self.mean_kl = float(np.mean(accumulated_kl)) if accumulated_kl else 0.0
        self.rollout_stats = self._rollout_stats(all_scores_log, **{"time/rollout_time": self.clock.tick()})
        if self.log_rollouts:
            self.store.export_history(location=self.rollout_logging_dir, tokenizer=self.tokenizer)
        self.push_to_store(elements[:num_rollouts])
        self._release_ref()

    # ------------------------------------------------------------- reporting

    def train_step(self, batch) -> Dict[str, float]:
        out = super().train_step(batch)
        if "group/policy_delta" in out:
            gauges.set("online/policy_delta", out["group/policy_delta"])
        if self._online_buffer is not None:
            out.update(gauges.snapshot("online/"))
        return out
