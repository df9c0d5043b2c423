"""Process-local runtime gauges and the repo-wide percentile definition.

Runtime gauges (:class:`GaugeRegistry` / the module-level :data:`gauges`) are
thread-safe named floats that subsystems set from worker threads — the
serving engine exports ``serving/*`` through them. Besides plain
``set``/``inc`` gauges, the registry keeps **streaming histograms**:
``observe(name, value)`` appends to a bounded per-name window,
``hist_stats(name)`` reduces it to p50/p95/max/mean/count and
``hist_snapshot(prefix)`` flattens every histogram under a prefix into
``<name>_p50`` / ``_p95`` / ``_max`` stats (how ``time/step_p95`` reaches the
trackers). ``clear(prefix=...)`` drops a subsystem's gauges when it shuts
down.

Copied from ``trlx_tpu/utils/metrics.py`` (the port imports nothing of the
JAX package); the ROUGE scorers there belong to a later slice.
"""

import math
import threading
from collections import deque
from typing import Dict, Sequence


def nearest_rank(sorted_values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample: the smallest
    member such that at least ``q`` of the sample is <= it, i.e. index
    ``ceil(q*n) - 1``. Every percentile in the package routes through this
    one definition."""
    n = len(sorted_values)
    if n == 0:
        return 0.0
    return sorted_values[min(n - 1, max(0, math.ceil(q * n) - 1))]


class GaugeRegistry:
    """Thread-safe named float gauges + streaming histograms (see module
    docstring)."""

    def __init__(self, hist_window: int = 512):
        self._lock = threading.Lock()
        self._values: Dict[str, float] = {}
        self._hists: Dict[str, deque] = {}
        self._hist_counts: Dict[str, int] = {}
        self.hist_window = int(hist_window)

    def set(self, name: str, value: float):
        with self._lock:
            self._values[name] = float(value)

    def inc(self, name: str, delta: float = 1.0):
        with self._lock:
            self._values[name] = self._values.get(name, 0.0) + float(delta)

    def get(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._values.get(name, default)

    def observe(self, name: str, value: float):
        """Append ``value`` to the bounded streaming histogram ``name``."""
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = deque(maxlen=self.hist_window)
            hist.append(float(value))
            self._hist_counts[name] = self._hist_counts.get(name, 0) + 1

    def hist_stats(self, name: str) -> Dict[str, float]:
        """p50/p95/max/mean/count over the histogram's current window (count is
        lifetime observations, not window size). Empty dict if never observed."""
        with self._lock:
            hist = self._hists.get(name)
            if not hist:
                return {}
            values = sorted(hist)
            count = self._hist_counts[name]
        n = len(values)
        return {
            "p50": nearest_rank(values, 0.50),
            "p95": nearest_rank(values, 0.95),
            "max": values[-1],
            "mean": sum(values) / n,
            "count": float(count),
        }

    def hist_snapshot(self, prefix: str = "") -> Dict[str, float]:
        """Flattened ``{name_p50: v, name_p95: v, name_max: v}`` for every
        histogram under ``prefix`` — merged into per-step tracker stats."""
        with self._lock:
            names = [k for k in self._hists if k.startswith(prefix)]
        out: Dict[str, float] = {}
        for name in names:
            stats = self.hist_stats(name)
            for key in ("p50", "p95", "max"):
                if key in stats:
                    out[f"{name}_{key}"] = stats[key]
        return out

    def snapshot(self, prefix: str = "") -> Dict[str, float]:
        """Copy of the current gauges (optionally filtered by name prefix)."""
        with self._lock:
            return {k: v for k, v in self._values.items() if k.startswith(prefix)}

    def clear(self, prefix: str = ""):
        """Drop gauges and histograms under ``prefix`` ("" clears everything)."""
        with self._lock:
            if not prefix:
                self._values.clear()
                self._hists.clear()
                self._hist_counts.clear()
                return
            for store in (self._values, self._hists, self._hist_counts):
                for k in [k for k in store if k.startswith(prefix)]:
                    del store[k]


#: Process-global registry; subsystems set, consumers snapshot.
gauges = GaugeRegistry()
