"""Per-island idle-bubble accounting for the Sebulba disaggregated split
(counterpart of ``trlx_tpu/obs/islands.py``).

The whole point of carving generation and learning onto separate islands is
that *neither* side ever waits on the other — the target is an idle-bubble
fraction under 0.1 on both. Like
:class:`~trlx_tpu_torch.obs.overlap.OverlapWindow`, wall-clock ratios alone cannot
prove that: a decode loop stalled behind a blocking weight broadcast still
"runs" for the whole window. :class:`IslandLedger` therefore records the
actual busy intervals of one island (engine rounds on the generation island;
train steps + publishes on the learner island) and reports

    ``idle_fraction = 1 - merged_busy_s / window_wall_s``

over an explicitly opened measurement window. Consecutive intervals closer
than the merge epsilon are bridged (host turnaround between back-to-back
rounds is microseconds), so only genuine stalls — a gated round, an empty
queue — surface as idle.
"""

import threading
import time
from typing import Dict, List, Optional

__all__ = ["IslandLedger"]

# same bridging rationale as obs/overlap.py: free-running round turnaround is
# microseconds, a real stall (blocked gate, empty queue) is milliseconds
_MERGE_EPS_S = 5e-4


class IslandLedger:
    """Thread-safe busy-interval ledger for one island's idle-bubble proof."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._busy: List[List[float]] = []  # merged [start, end], sorted
        self._window_start: Optional[float] = None

    def open_window(self, start: Optional[float] = None) -> float:
        """Start (or restart) the measurement window; drops prior intervals
        so warmup/compile time never pollutes the measured fraction."""
        t0 = time.monotonic() if start is None else float(start)
        with self._lock:
            self._busy = []
            self._window_start = t0
        return t0

    def note_busy(self, start: float, end: float) -> None:
        """Record one unit of island work (an engine round, a train step, a
        publish). Out-of-window and empty intervals are ignored."""
        if end <= start:
            return
        with self._lock:
            if self._window_start is None:
                return
            start = max(start, self._window_start)
            if end <= start:
                return
            if self._busy and start <= self._busy[-1][1] + _MERGE_EPS_S:
                last = self._busy[-1]
                last[1] = max(last[1], end)
            else:
                self._busy.append([start, end])

    def busy_s(self, until: Optional[float] = None) -> float:
        t1 = time.monotonic() if until is None else float(until)
        with self._lock:
            return sum(min(e, t1) - s for s, e in self._busy if s < t1)

    def wall_s(self, until: Optional[float] = None) -> float:
        t1 = time.monotonic() if until is None else float(until)
        with self._lock:
            if self._window_start is None:
                return 0.0
            return max(0.0, t1 - self._window_start)

    def idle_fraction(self, until: Optional[float] = None) -> float:
        """1 - busy/wall over the open window (0.0 before a window opens or
        for a zero-length window)."""
        t1 = time.monotonic() if until is None else float(until)
        wall = self.wall_s(t1)
        if wall <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.busy_s(t1) / wall)

    def snapshot(self, until: Optional[float] = None) -> Dict[str, float]:
        t1 = time.monotonic() if until is None else float(until)
        return {
            f"{self.name}_busy_s": self.busy_s(t1),
            f"{self.name}_wall_s": self.wall_s(t1),
            f"{self.name}_idle_frac": self.idle_fraction(t1),
        }
