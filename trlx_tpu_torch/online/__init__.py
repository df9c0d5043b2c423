"""Online learning subsystem: harvest labeled experience from live traffic
(counterpart of ``trlx_tpu/online``).

The pieces of the closed loop:

- :class:`~trlx_tpu_torch.online.buffer.OnlineExperienceBuffer` /
  :class:`~trlx_tpu_torch.online.buffer.LabeledGroup` — bounded, version-tagged
  storage of scored completion groups;
- :class:`~trlx_tpu_torch.online.collector.PreferenceCollector` — exactly-once
  harvest of completion groups from serving terminal requests, scored
  by reward_fn, pairwise preference judging, or environment returns;
- :class:`~trlx_tpu_torch.online.environment.Environment` — the multi-turn
  observe → generate → act → reward interface, with
  :class:`~trlx_tpu_torch.online.environment.SyntheticEnvironment` as the seeded
  test world.

The consumer is ``GRPOTrainer`` (``trainer/grpo_trainer.py``): served
groups are exactly the group-relative advantage's input shape.
"""

from trlx_tpu_torch.online.buffer import LabeledGroup, OnlineExperienceBuffer
from trlx_tpu_torch.online.collector import PreferenceCollector
from trlx_tpu_torch.online.environment import (
    Environment,
    SyntheticEnvironment,
    environment_reward_fn,
    run_environment_rollout,
)

__all__ = [
    "Environment",
    "LabeledGroup",
    "OnlineExperienceBuffer",
    "PreferenceCollector",
    "SyntheticEnvironment",
    "environment_reward_fn",
    "run_environment_rollout",
]
