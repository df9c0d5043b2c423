"""Deterministic re-ordering of out-of-order rollout completions
(counterpart of ``trlx_tpu/rollout/reorder.py``, a copy).

The continuous-batching engine finishes sequences in whatever order decode
lengths dictate, and the stream-overlap reward pool finishes scoring in
whatever order the workers race to.  The replay store, however, must see
elements in submission order so that overlap-on runs append identical
contents in identical order to the serial path (and so repeated runs are
byte-stable regardless of thread timing).

:class:`ReorderBuffer` is the TCP-reassembly-style seam: producers ``add``
items under their original submission index, possibly out of order, and the
consumer drains the contiguous ready prefix with ``pop_ready``.  A ``None``
item is a tombstone — it advances the cursor without emitting anything, so a
quarantine-dropped element can never stall the sequences behind it.
"""

import threading
from typing import Any, Dict, List, Optional

__all__ = ["ReorderBuffer"]


class ReorderBuffer:
    """Reassemble indexed completions into submission order."""

    def __init__(self, start: int = 0) -> None:
        self._lock = threading.Lock()
        self._next = start
        self._slots: Dict[int, Optional[Any]] = {}

    def add(self, index: int, item: Optional[Any]) -> None:
        """Record ``item`` for submission ``index``; ``None`` is a tombstone."""
        with self._lock:
            if index < self._next or index in self._slots:
                raise ValueError(f"duplicate completion for index {index}")
            self._slots[index] = item

    def pop_ready(self) -> List[Any]:
        """Drain the contiguous prefix, skipping tombstones."""
        out: List[Any] = []
        with self._lock:
            while self._next in self._slots:
                item = self._slots.pop(self._next)
                self._next += 1
                if item is not None:
                    out.append(item)
        return out

    @property
    def pending(self) -> int:
        """Completions received but blocked behind a missing earlier index."""
        with self._lock:
            return len(self._slots)

    @property
    def next_index(self) -> int:
        with self._lock:
            return self._next
