"""Staleness accounting and importance-weight correction for async PPO
(counterpart of ``trlx_tpu/rollout/staleness.py``).

Staleness of an experience element is ``learner_version - policy_version``:
how many parameter publishes happened between sampling it and training on
it. Two mechanisms keep async PPO honest:

- **Admission cap** (:class:`StalenessAccountant`): elements staler than
  ``max_staleness`` are dropped at consumption time rather than trained on.
  ``max_staleness=0`` means fully on-policy: the trainer runs the
  synchronous path instead of the producer.
- **Clipped importance weights** (:func:`staleness_importance_weights`): for
  admitted-but-stale samples, the PPO policy-gradient term is reweighted by
  a per-token clipped IS ratio of the current policy against the behavior
  policy whose logprobs are stored in ``PPORLBatch.logprobs``. At staleness
  0 the weight is exactly 1.0 (a ``where`` on the staleness), so the
  corrected loss equals the vanilla loss bit for bit on on-policy data.
"""

import threading
from typing import Any, List, Sequence, Tuple

import torch


def staleness_importance_weights(
    log_ratio: torch.Tensor, staleness: torch.Tensor, clip_ratio: float
) -> torch.Tensor:
    """Per-token clipped IS weights, exactly 1.0 where staleness == 0.

    :param log_ratio: [B, T] masked log(pi_current / pi_behavior) over
        response tokens.
    :param staleness: [B] (or [B, T]) integer policy-version lag per sample.
    :param clip_ratio: weights are clipped to ``[1/clip_ratio, clip_ratio]``.
    """
    if clip_ratio < 1.0:
        raise ValueError(f"clip_ratio must be >= 1.0, got {clip_ratio}")
    # a fixed reweighting of the surrogate, not a new gradient path
    w = torch.clamp(torch.exp(log_ratio), 1.0 / clip_ratio, clip_ratio).detach()
    stale = staleness > 0
    if stale.ndim == log_ratio.ndim - 1:
        stale = stale[:, None]
    return torch.where(stale, w, torch.ones_like(w))


class StalenessAccountant:
    """Admission control + running staleness statistics (thread-safe).

    ``admit`` filters a freshly popped batch of elements against the cap and
    records the observed staleness distribution; ``stats`` exposes the
    gauges the trainer exports.
    """

    def __init__(self, max_staleness: int):
        if max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
        self.max_staleness = int(max_staleness)
        self._lock = threading.Lock()
        self._admitted = 0
        self._dropped = 0
        self._staleness_sum = 0
        self._staleness_max = 0
        self._last_mean = 0.0
        self._last_max = 0

    @staticmethod
    def element_staleness(element: Any, learner_version: int) -> int:
        version = int(getattr(element, "policy_version", 0) or 0)
        return max(0, int(learner_version) - version)

    def admit(self, elements: Sequence[Any], learner_version: int) -> Tuple[List[Any], int]:
        """Split ``elements`` into (admitted, n_dropped) under the cap."""
        fresh: List[Any] = []
        staleness_values: List[int] = []
        dropped = 0
        for e in elements:
            s = self.element_staleness(e, learner_version)
            if s > self.max_staleness:
                dropped += 1
                continue
            fresh.append(e)
            staleness_values.append(s)
        with self._lock:
            self._dropped += dropped
            self._admitted += len(fresh)
            if staleness_values:
                self._staleness_sum += sum(staleness_values)
                self._last_max = max(staleness_values)
                self._staleness_max = max(self._staleness_max, self._last_max)
                self._last_mean = sum(staleness_values) / len(staleness_values)
        return fresh, dropped

    def stats(self) -> dict:
        with self._lock:
            return {
                "admitted": self._admitted,
                "dropped_stale": self._dropped,
                "staleness_mean": self._staleness_sum / self._admitted if self._admitted else 0.0,
                "staleness_last_mean": self._last_mean,
                "staleness_last_max": self._last_max,
                "staleness_max": self._staleness_max,
            }
