"""Versioned parameter snapshots for the async rollout producer (counterpart
of ``trlx_tpu/rollout/publisher.py``).

The learner's ``optimizer.step()`` changes the live parameters in place, so
the producer must never read them: the publisher takes a copy at publish
time (by default ``{k: v.detach().clone()}`` of the trained state) and
pairs it with a monotonic policy version. The producer
generates with version *v* while the learner optimizes toward *v+1*, and
every experience element is tagged with the version it was sampled from.

On one CUDA stream the snapshot's clone is queued before the producer can
read the snapshot's reference (this lock orders the two), so stream order
makes the read safe without events.
"""

import threading
from typing import Any, Callable, Optional, Tuple


def _default_copy(state):
    """Detached copy of a ``state_dict``-like ``{name: tensor}`` mapping."""
    return {k: v.detach().clone() for k, v in state.items()}


class ParameterPublisher:
    """Single-writer (learner) / single-reader (producer) snapshot mailbox.

    ``publish`` replaces the snapshot and bumps the version; ``latest``
    hands back the newest ``(version, params)``. Versions are monotonic
    from 0.
    """

    def __init__(self, copy_fn: Optional[Callable[[Any], Any]] = None):
        self._copy = copy_fn or _default_copy
        self._lock = threading.Lock()
        self._version = -1
        self._snapshot: Any = None

    def publish(self, params: Any) -> int:
        """Snapshot ``params`` (the copy happens outside the lock) and return
        the new, strictly increasing version."""
        snapshot = self._copy(params)
        with self._lock:
            self._version += 1
            self._snapshot = snapshot
            return self._version

    def latest(self) -> Tuple[int, Any]:
        """Newest ``(version, params)``; raises if nothing was published yet."""
        with self._lock:
            if self._version < 0:
                raise RuntimeError("ParameterPublisher.latest() before first publish()")
            return self._version, self._snapshot

    @property
    def version(self) -> int:
        with self._lock:
            return self._version
