"""Bounded thread-safe experience queue with backpressure and watermarks (a
copy of ``trlx_tpu/rollout/queue.py``).

One producer (the rollout engine thread) pushes lists of experience
elements; one consumer (the learner, on the main thread) pops fixed counts.
Three properties are each load-bearing:

- **Hard bound**: the queue never holds more than ``capacity`` elements, so
  a fast producer cannot run unboundedly ahead of the learner.
- **Watermark hysteresis**: once depth reaches ``high_watermark`` the
  producer is gated until the learner drains it back to ``low_watermark``,
  so production happens in runs that keep the generator's batches full.
- **Drain-on-shutdown**: ``close()`` wakes every waiter; pending ``put``
  calls raise :class:`QueueClosed`, while ``get`` returns whatever is left
  (then empty lists), so the learner can consume the tail before teardown.
"""

import threading
import time
from collections import deque
from typing import Any, Iterable, List, Optional


class QueueClosed(RuntimeError):
    """Raised by :meth:`ExperienceQueue.put` after :meth:`ExperienceQueue.close`."""


class ExperienceQueue:
    """Bounded FIFO of experience elements shared between one producer thread
    and one consumer thread (see module docstring for semantics)."""

    def __init__(
        self,
        capacity: int,
        high_watermark: Optional[int] = None,
        low_watermark: Optional[int] = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.high_watermark = self.capacity if high_watermark is None else int(high_watermark)
        self.low_watermark = (
            self.high_watermark // 2 if low_watermark is None else int(low_watermark)
        )
        if not 0 <= self.low_watermark <= self.high_watermark <= self.capacity:
            raise ValueError(
                f"need 0 <= low_watermark <= high_watermark <= capacity, got "
                f"low={self.low_watermark} high={self.high_watermark} cap={self.capacity}"
            )
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._gated = False
        self._peak_depth = 0
        self._total_put = 0
        self._total_got = 0

    # ---------------------------------------------------------------- producer

    def put(self, items: Iterable[Any], timeout: Optional[float] = None) -> bool:
        """Append ``items`` atomically. Blocks while the queue is gated (above
        the high watermark and not yet drained to the low watermark) or while
        the batch would exceed ``capacity``. Returns False on timeout; raises
        :class:`QueueClosed` if the queue is (or becomes) closed."""
        items = list(items)
        if len(items) > self.capacity:
            raise ValueError(
                f"batch of {len(items)} exceeds queue capacity {self.capacity}"
            )
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._closed:
                    raise QueueClosed("experience queue is closed")
                if not self._gated and len(self._items) + len(items) <= self.capacity:
                    break
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            self._items.extend(items)
            self._total_put += len(items)
            self._peak_depth = max(self._peak_depth, len(self._items))
            if len(self._items) >= self.high_watermark:
                self._gated = True
            self._cond.notify_all()
            return True

    # ---------------------------------------------------------------- consumer

    def get(self, n: int, timeout: Optional[float] = None) -> List[Any]:
        """Pop up to ``n`` elements (FIFO), blocking until at least one is
        available. Never blocks on *fullness* of the request — the consumer
        must accept partial batches, or a high watermark below the consumer's
        demand would deadlock a gated producer against a waiting consumer.
        After :meth:`close`, returns whatever remains (eventually ``[]``).
        On timeout returns ``[]`` without consuming."""
        if n < 1:
            return []
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._items and not self._closed:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return []
                self._cond.wait(remaining)
            k = min(n, len(self._items))
            out = [self._items.popleft() for _ in range(k)]
            self._total_got += k
            if self._gated and len(self._items) <= self.low_watermark:
                self._gated = False
            self._cond.notify_all()
            return out

    # ---------------------------------------------------------------- lifecycle

    def close(self):
        """Stop accepting puts and wake every waiter (idempotent)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # ------------------------------------------------------------------- state

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    @property
    def gated(self) -> bool:
        with self._cond:
            return self._gated

    def qsize(self) -> int:
        with self._cond:
            return len(self._items)

    def stats(self) -> dict:
        """Counters for the rollout gauges (peak depth proves the bound held)."""
        with self._cond:
            return {
                "depth": len(self._items),
                "peak_depth": self._peak_depth,
                "capacity": self.capacity,
                "total_put": self._total_put,
                "total_got": self._total_got,
                "gated": float(self._gated),
            }
