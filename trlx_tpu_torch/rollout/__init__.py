"""Async rollouts: experience generation decoupled from PPO learning
(counterpart of ``trlx_tpu/rollout``).

Experience generation runs as a continuously-running *producer* thread,
decoupled from the learner through a bounded queue, with explicit
off-policy staleness control:

- :mod:`trlx_tpu_torch.rollout.queue` — bounded thread-safe experience
  queue with backpressure, high/low watermark hysteresis, and
  drain-on-shutdown.
- :mod:`trlx_tpu_torch.rollout.publisher` — versioned parameter snapshots
  (monotonic policy version; copies of the trained state) so the producer
  samples with version *v* while the learner optimizes toward *v+1*.
- :mod:`trlx_tpu_torch.rollout.staleness` — staleness accounting, the
  ``max_staleness`` admission cap, and the clipped per-token
  importance-weight correction applied inside the PPO loss.
- :mod:`trlx_tpu_torch.rollout.engine` — the producer loop around the
  trainer's generate / score pipeline, tagging every element with the
  policy version it was sampled from.
- :mod:`trlx_tpu_torch.rollout.supervisor` — restarts a crashed or wedged
  producer with backoff under a budget (``train.self_healing``).

Enabled via ``TrainConfig.async_rollouts``; the synchronous path stays the
default and ``max_staleness=0`` falls back to it exactly. Not ported yet:
the island split and chunked broadcast (``train.islands``), raising naming
its slice.
"""

from trlx_tpu_torch.rollout.engine import PRODUCER_HEARTBEAT, AsyncRolloutEngine, length_bucketed
from trlx_tpu_torch.rollout.publisher import ParameterPublisher
from trlx_tpu_torch.rollout.queue import ExperienceQueue, QueueClosed
from trlx_tpu_torch.rollout.staleness import StalenessAccountant, staleness_importance_weights
from trlx_tpu_torch.rollout.supervisor import ProducerRestartBudgetExceeded, ProducerSupervisor

__all__ = [
    "AsyncRolloutEngine",
    "ExperienceQueue",
    "PRODUCER_HEARTBEAT",
    "ParameterPublisher",
    "ProducerRestartBudgetExceeded",
    "ProducerSupervisor",
    "QueueClosed",
    "StalenessAccountant",
    "length_bucketed",
    "staleness_importance_weights",
]
