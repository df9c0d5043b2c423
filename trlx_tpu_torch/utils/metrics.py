"""Process-local runtime gauges, the repo-wide percentile definition and ROUGE.

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

Text-overlap metrics (ROUGE, :func:`rouge`, :func:`rouge_scores`,
:func:`rouge_per_sample`): the summarize_rlhf example's quality numbers,
from scratch with rouge_score's default tokenization (lowercase, runs of
``[a-z0-9]``) and no stemming: ROUGE-N F-measure on n-gram multiset overlap
and ROUGE-L F-measure on the longest common subsequence.

Copied from ``trlx_tpu/utils/metrics.py`` (the port imports nothing of the
JAX package).
"""

import math
import re
import threading
from collections import Counter, deque
from typing import Dict, List, Sequence


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


_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


def _f_measure(p: float, r: float) -> float:
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


def _rouge_n(pred: List[str], ref: List[str], n: int) -> float:
    pred_ngrams = Counter(tuple(pred[i:i + n]) for i in range(len(pred) - n + 1))
    ref_ngrams = Counter(tuple(ref[i:i + n]) for i in range(len(ref) - n + 1))
    if not pred_ngrams or not ref_ngrams:
        return 0.0
    overlap = sum((pred_ngrams & ref_ngrams).values())
    return _f_measure(overlap / max(1, sum(pred_ngrams.values())), overlap / max(1, sum(ref_ngrams.values())))


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    # one-row DP; O(len(a)*len(b)) time, O(len(b)) space: summaries are short
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def _rouge_l(pred: List[str], ref: List[str]) -> float:
    if not pred or not ref:
        return 0.0
    lcs = _lcs_len(pred, ref)
    return _f_measure(lcs / len(pred), lcs / len(ref))


def rouge(pred: str, ref: str) -> Dict[str, float]:
    """ROUGE-1/2/L F-measures for one (prediction, reference) pair."""
    p, r = _tokenize(pred), _tokenize(ref)
    return {"rouge1": _rouge_n(p, r, 1), "rouge2": _rouge_n(p, r, 2), "rougeL": _rouge_l(p, r)}


def rouge_scores(predictions: Sequence[str], references: Sequence[str]) -> Dict[str, float]:
    """Corpus ROUGE: per-pair F-measures averaged (what ``evaluate``'s rouge
    returns), plus ``rouge_avg``, the mean over 1/2/L (the summarize_rlhf
    README's "Average")."""
    if len(predictions) != len(references):
        raise ValueError(f"{len(predictions)} predictions for {len(references)} references")
    if not predictions:
        return {"rouge1": 0.0, "rouge2": 0.0, "rougeL": 0.0, "rouge_avg": 0.0}
    totals = Counter()
    for pred, ref in zip(predictions, references):
        totals.update(rouge(pred, ref))
    n = len(predictions)
    out = {k: totals[k] / n for k in ("rouge1", "rouge2", "rougeL")}
    out["rouge_avg"] = (out["rouge1"] + out["rouge2"] + out["rougeL"]) / 3
    return out


def rouge_per_sample(predictions: Sequence[str], references: Sequence[str]) -> Dict[str, List[float]]:
    """Per-sample ROUGE lists, shaped for a trainer ``metric_fn`` (each
    metric becomes a table column and a mean stat)."""
    rows = [rouge(p, r) for p, r in zip(predictions, references)]
    out: Dict[str, List[float]] = {k: [row[k] for row in rows] for k in ("rouge1", "rouge2", "rougeL")}
    out["rouge_avg"] = [(a + b + c) / 3 for a, b, c in zip(out["rouge1"], out["rouge2"], out["rougeL"])]
    return out
