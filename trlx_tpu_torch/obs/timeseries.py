"""SeriesStore: fixed-retention gauge time series with windowed reductions
(counterpart of ``trlx_tpu/obs/timeseries.py``, a copy).

The GaugeRegistry answers "what is the value NOW"; control loops and SLO
alerting need "what has it been DOING". The store samples the registry (or
accepts direct appends) into per-key rings of ``(t, value)`` points with a
hard retention cap, and reduces any key over its newest-N window — min /
max / mean / nearest-rank percentiles — without ever holding an unbounded
history. The clock is injected (``clock=``), so a test can drive it.

The :class:`~trlx_tpu_torch.obs.runtime.Observability` facade samples every
gauge once per step and hands the series to the exporters
(:mod:`trlx_tpu_torch.obs.export`: JSONL dump + Prometheus text
exposition).

Thread-safety matches the registry: one lock, held only for the ring
bookkeeping; reductions copy the window out before reducing.
"""

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from trlx_tpu_torch.utils.metrics import GaugeRegistry, gauges, nearest_rank


class SeriesStore:
    """Bounded per-key time series over gauge samples (see module docstring)."""

    def __init__(
        self,
        capacity: int = 512,
        registry: Optional[GaugeRegistry] = None,
        clock=time.monotonic,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.registry = registry if registry is not None else gauges
        self.clock = clock
        self._lock = threading.Lock()
        self._series: Dict[str, deque] = {}
        self._samples = 0

    # -------------------------------------------------------------- writing

    def append(self, key: str, value: float, t: Optional[float] = None) -> None:
        """Append one point to ``key``'s ring directly (no registry read)."""
        if t is None:
            t = self.clock()
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                ring = self._series[key] = deque(maxlen=self.capacity)
            ring.append((float(t), float(value)))

    def sample(self, prefix: str = "", t: Optional[float] = None) -> int:
        """Sample every registry gauge under ``prefix`` into its ring at one
        shared timestamp; returns the number of keys sampled."""
        snap = self.registry.snapshot(prefix)
        if t is None:
            t = self.clock()
        with self._lock:
            for key, value in snap.items():
                ring = self._series.get(key)
                if ring is None:
                    ring = self._series[key] = deque(maxlen=self.capacity)
                ring.append((float(t), float(value)))
            self._samples += 1
        return len(snap)

    def clear(self, prefix: str = "") -> None:
        with self._lock:
            if not prefix:
                self._series.clear()
                return
            for key in [k for k in self._series if k.startswith(prefix)]:
                del self._series[key]

    # -------------------------------------------------------------- reading

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._series if k.startswith(prefix))

    def series(self, key: str) -> List[Tuple[float, float]]:
        """Full retained ``(t, value)`` history for one key, oldest first."""
        with self._lock:
            ring = self._series.get(key)
            return list(ring) if ring else []

    def window(self, key: str, n: Optional[int] = None) -> List[float]:
        """Newest-``n`` values for ``key`` (all retained points when None)."""
        with self._lock:
            ring = self._series.get(key)
            if not ring:
                return []
            points = list(ring)
        if n is not None and n > 0:
            points = points[-n:]
        return [v for _, v in points]

    def last(self, key: str, default: float = 0.0) -> float:
        with self._lock:
            ring = self._series.get(key)
            return ring[-1][1] if ring else default

    def stats(self, key: str, window: Optional[int] = None) -> Dict[str, float]:
        """Windowed reduction: n/last/min/max/mean plus nearest-rank
        p50/p95/p99 over the newest-``window`` points. Empty dict when the
        key has never been sampled."""
        xs = self.window(key, window)
        if not xs:
            return {}
        ordered = sorted(xs)
        return {
            "n": float(len(xs)),
            "last": xs[-1],
            "min": ordered[0],
            "max": ordered[-1],
            "mean": sum(xs) / len(xs),
            "p50": nearest_rank(ordered, 0.50),
            "p95": nearest_rank(ordered, 0.95),
            "p99": nearest_rank(ordered, 0.99),
        }

    def reduce(
        self, key: str, fn: str = "mean", window: Optional[int] = None,
        default: float = 0.0,
    ) -> float:
        """One windowed scalar: ``fn`` in {mean,min,max,last,sum}."""
        xs = self.window(key, window)
        if not xs:
            return default
        if fn == "mean":
            return sum(xs) / len(xs)
        if fn == "min":
            return min(xs)
        if fn == "max":
            return max(xs)
        if fn == "last":
            return xs[-1]
        if fn == "sum":
            return sum(xs)
        raise ValueError(f"unknown reduction {fn!r}")

    @property
    def sample_rounds(self) -> int:
        with self._lock:
            return self._samples
