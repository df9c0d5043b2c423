"""Interval accounting for stream-overlapped PPO (counterpart of
``trlx_tpu/obs/overlap.py``, a copy with :attr:`OverlapWindow.work_s` added).

:class:`OverlapWindow` measures how much reward/score/learn work genuinely
overlapped with serving decode.  The naive approach — compare wall-clock of
the decode loop against wall-clock of the scoring work — cannot distinguish
real overlap from serial consumption that merely *stretches* the decode loop
(blocking inside the completion callback inflates the decode window, so the
serialized work would still appear "inside" it).  Instead we record the actual
busy intervals:

- ``note_decode(t0, t1)`` — one engine ``step()`` call.  Consecutive steps
  merge into a single busy interval; a blocking gap (e.g. the seeded
  ``TRLX_OVERLAP_SEED_REGRESSION=serialize`` mode waiting on a reward future
  between steps) splits the busy set, so serialized work falls *between*
  decode intervals and scores zero overlap.
- ``note_work(t0, t1)`` — one unit of reward / score-dispatch / learn-staging
  work, from any thread.

``overlapped_s`` is the summed intersection of work intervals with the merged
decode intervals.  With multiple reward workers the sum can exceed
``decode_busy_s`` (two workers overlapping the same decode second count
twice); the fraction is deliberately left unclamped — values above 1.0 mean
the pool hid more than one serial second per decode second.
"""

import threading
from typing import List, Tuple

__all__ = ["OverlapWindow"]

# Gaps shorter than this between consecutive decode steps are bridged: the
# host turnaround between two engine.step() calls in a free-running stream
# loop is microseconds, while a deliberate block on a reward future is
# milliseconds at minimum.  Bridging keeps the interval list small without
# hiding serialization stalls.
_MERGE_EPS_S = 5e-4


class OverlapWindow:
    """Thread-safe busy-interval ledger for one streaming window."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._decode: List[List[float]] = []  # merged [start, end], sorted
        self._work: List[Tuple[float, float]] = []

    def note_decode(self, start: float, end: float) -> None:
        if end <= start:
            return
        with self._lock:
            if self._decode and start <= self._decode[-1][1] + _MERGE_EPS_S:
                last = self._decode[-1]
                last[1] = max(last[1], end)
            else:
                self._decode.append([start, end])

    def note_work(self, start: float, end: float) -> None:
        if end <= start:
            return
        with self._lock:
            self._work.append((start, end))

    @property
    def decode_busy_s(self) -> float:
        with self._lock:
            return sum(e - s for s, e in self._decode)

    @property
    def work_s(self) -> float:
        """Summed work seconds (``work_s - overlapped_s`` is the bubble: work
        that did not overlap decode)."""
        with self._lock:
            return sum(e - s for s, e in self._work)

    @property
    def overlapped_s(self) -> float:
        with self._lock:
            decode = [tuple(iv) for iv in self._decode]
            work = sorted(self._work)
        total = 0.0
        di = 0
        for ws, we in work:
            # Work intervals are processed in sorted order, but each may span
            # several decode intervals; rewind is never needed because decode
            # intervals are disjoint and sorted.
            while di < len(decode) and decode[di][1] <= ws:
                di += 1
            j = di
            while j < len(decode) and decode[j][0] < we:
                total += min(we, decode[j][1]) - max(ws, decode[j][0])
                j += 1
        return total

    @property
    def fraction(self) -> float:
        busy = self.decode_busy_s
        if busy <= 0.0:
            return 0.0
        return self.overlapped_s / busy
