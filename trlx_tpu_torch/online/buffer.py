"""Bounded online experience buffer: labeled completion groups with version
tags (counterpart of ``trlx_tpu/online/buffer.py``).

The collector (``online/collector.py``) produces :class:`LabeledGroup`\\ s —
one prompt, G scored completions, stamped with the serving policy version
that generated them — and the GRPO trainer drains them on each experience
refill. The buffer sits between two clocks (served traffic arrives at
serving rate, the learner consumes at training rate), so it is *bounded*:
past ``capacity`` the oldest group is evicted, because in an online loop
old experience is the cheapest thing to lose. Staleness is enforced at
drain time through the same
:class:`~trlx_tpu_torch.rollout.staleness.StalenessAccountant` the async
PPO path uses — a ``LabeledGroup`` carries
``policy_version`` exactly like a ``PPORLElement`` does, so the admission
cap and its gauges need no new machinery.

Gauges: ``online/buffer_depth``, ``online/buffer_evicted``,
``online/dropped_stale``.
"""

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from trlx_tpu_torch.rollout.staleness import StalenessAccountant
from trlx_tpu_torch.utils.metrics import gauges


@dataclass
class LabeledGroup:
    """One scored completion group: GRPO's unit of experience.

    ``completions`` are token-id lists (ragged — padding happens at scoring
    time in the trainer); ``scores`` aligns with them. ``policy_version`` is
    the serving version that generated the group (staleness admission keys
    on it); ``uids`` keeps the originating request uids for exactly-once
    audits."""

    prompt: List[int]
    completions: List[List[int]]
    scores: np.ndarray
    policy_version: int = 0
    uids: Tuple[int, ...] = ()
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.scores = np.asarray(self.scores, dtype=np.float32)
        if len(self.completions) != self.scores.size:
            raise ValueError(
                f"scores ({self.scores.size}) must align with completions "
                f"({len(self.completions)})"
            )

    @property
    def group_size(self) -> int:
        return len(self.completions)


class OnlineExperienceBuffer:
    """Thread-safe bounded FIFO of :class:`LabeledGroup`\\ s.

    ``put`` runs wherever the collector runs (possibly a serving thread);
    ``drain`` runs on the learner thread — one lock covers the deque, held
    only for the queue ops themselves.
    """

    def __init__(self, capacity: int = 256, max_staleness: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._groups: deque = deque()
        self._lock = threading.Lock()
        self._evicted = 0
        self.accountant = (
            StalenessAccountant(max_staleness) if max_staleness is not None else None
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._groups)

    def put(self, group: LabeledGroup) -> None:
        with self._lock:
            self._groups.append(group)
            while len(self._groups) > self.capacity:
                self._groups.popleft()
                self._evicted += 1
            depth, evicted = len(self._groups), self._evicted
        gauges.set("online/buffer_depth", float(depth))
        gauges.set("online/buffer_evicted", float(evicted))

    def drain(
        self, max_groups: int, learner_version: int = 0
    ) -> List[LabeledGroup]:
        """Pop up to ``max_groups`` oldest groups, drop the ones staler than
        the admission cap (when a cap is configured), return the admitted
        rest. Dropped groups are gone — re-admitting ever-staler experience
        later would only get worse."""
        popped: List[LabeledGroup] = []
        with self._lock:
            while self._groups and len(popped) < max_groups:
                popped.append(self._groups.popleft())
            depth = len(self._groups)
        gauges.set("online/buffer_depth", float(depth))
        if self.accountant is None:
            return popped
        fresh, _ = self.accountant.admit(popped, learner_version)
        gauges.set(
            "online/dropped_stale", float(self.accountant.stats()["dropped_stale"])
        )
        return fresh

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = {"depth": float(len(self._groups)), "evicted": float(self._evicted)}
        if self.accountant is not None:
            out.update(
                {k: float(v) for k, v in self.accountant.stats().items()}
            )
        return out
