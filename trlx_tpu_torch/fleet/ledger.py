"""FleetLedger: fleet-wide SLO accounting across engine replicas (counterpart
of ``trlx_tpu/fleet/ledger.py``).

Each replica already exports its own gauges under
``serving/replica/<seat>/``, but per-tenant SLO questions — "what p99 does
the pro class actually see?", "how many free-tier requests were shed?" —
are *fleet-level*: a tenant's traffic spreads over replicas, so per-replica
latency windows understate the tail and per-replica shed counts fragment
the story. The ledger is the single aggregation point: the router feeds it
every routing decision and every terminal request, and it reduces them to
the ``fleet/*`` gauge namespace (docs/observability.md):

- ``fleet/replicas``, ``fleet/pending_depth``, ``fleet/restarts`` — size
  and churn;
- ``fleet/affinity_hit_rate`` vs ``fleet/random_hit_rate`` — what the
  prefix-affinity router delivers vs what uniform-random routing would
  have (the soak's "affinity beats random" gate reads exactly these);
- ``fleet/sticky_hit_rate``, ``fleet/reroutes``, ``fleet/replica_kills``,
  ``fleet/autoscale/up``, ``fleet/autoscale/drain`` — routing and
  lifecycle churn;
- ``fleet/shed`` / ``fleet/expired`` / ``fleet/finished`` and per-class /
  per-tenant breakdowns ``fleet/class/<c>/*``, ``fleet/tenant/<t>/*``
  including nearest-rank p99 latency over a bounded window;
- ``fleet/alert/fast_burn`` / ``fleet/alert/slow_burn`` /
  ``fleet/alert/firing`` — SLO error-budget burn rates over a fast and a
  slow window of terminal outcomes (multi-window burn-rate alerting: the
  fast window catches an outage quickly, the slow window keeps a brief
  blip from paging). Burn rate is ``windowed_bad_fraction / error_budget``
  where the budget is ``1 - slo_target``; the alert fires only when BOTH
  windows exceed ``burn_threshold``.

Thread-safety: ``note_route`` runs on producer threads (inside the router's
``submit``), ``record`` on the driving thread — one lock covers all counters
and windows, held only for the bookkeeping itself.
"""

import threading
from collections import deque
from typing import Dict, Optional

from trlx_tpu_torch.obs.timeseries import SeriesStore
from trlx_tpu_torch.serving.scheduler import (
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_STOP,
    Request,
)
from trlx_tpu_torch.utils.metrics import gauges, nearest_rank

#: finish reasons that count as a successful generation (latency sample)
_SUCCESS = (FINISH_EOS, FINISH_STOP, FINISH_LENGTH)
#: bounded latency window per class/tenant — gauges are operational, not
#: an unbounded history (matches the engine's per-tenant window size)
_WINDOW = 512

#: series key holding the per-terminal bad-outcome indicator (1.0 = SLO miss)
SLO_BAD_KEY = "fleet/slo/bad"


def _nearest_rank_p99(window) -> float:
    xs = sorted(window)
    return nearest_rank(xs, 0.99) if xs else 0.0


class FleetLedger:
    def __init__(
        self,
        slo_target: float = 0.99,
        fast_window: int = 32,
        slow_window: int = 256,
        burn_threshold: float = 2.0,
        series: Optional[SeriesStore] = None,
    ):
        if not 0.0 < slo_target < 1.0:
            raise ValueError(f"slo_target must be in (0, 1), got {slo_target}")
        if fast_window < 1 or slow_window < fast_window:
            raise ValueError(
                "need 1 <= fast_window <= slow_window, got "
                f"fast={fast_window} slow={slow_window}"
            )
        self.slo_target = float(slo_target)
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.burn_threshold = float(burn_threshold)
        # series retention must cover the slow window or slow burn silently
        # degrades into a faster one
        self.series = (
            series if series is not None else SeriesStore(capacity=slow_window)
        )
        self._lock = threading.Lock()
        self._routed = 0
        self._affinity_hits = 0
        self._sticky_hits = 0
        self._random_hit_weight = 0.0
        self._reroutes = 0
        self._replica_kills = 0
        self._scale_ups = 0
        self._decommissions = 0
        self._finished = 0
        self._outcomes: Dict[str, int] = {}
        self._class_lat: Dict[int, deque] = {}
        self._tenant_lat: Dict[str, deque] = {}
        self._class_outcomes: Dict[int, Dict[str, int]] = {}
        self._tenant_outcomes: Dict[str, Dict[str, int]] = {}

    # ------------------------------------------------------------- recording

    def note_route(
        self, *, affinity_hit: bool, sticky_hit: bool, random_hit_weight: float
    ) -> None:
        """One routing decision: whether the chosen replica held a warm
        prefix, whether it matched the tenant's recent seats, and the
        probability a uniform-random choice would have hit a warm prefix
        (the baseline the affinity gate compares against)."""
        with self._lock:
            self._routed += 1
            self._affinity_hits += 1 if affinity_hit else 0
            self._sticky_hits += 1 if sticky_hit else 0
            self._random_hit_weight += float(random_hit_weight)

    def note_kill(self, rerouted: int) -> None:
        with self._lock:
            self._replica_kills += 1
            self._reroutes += int(rerouted)

    def note_scale_up(self) -> None:
        with self._lock:
            self._scale_ups += 1

    def note_decommission(self) -> None:
        with self._lock:
            self._decommissions += 1

    def record(self, req: Request) -> None:
        """One terminal request (called exactly once per uid — the router's
        delivered-set dedup is the caller's contract)."""
        with self._lock:
            self._finished += 1
            reason = req.finish_reason or "unknown"
            self._outcomes[reason] = self._outcomes.get(reason, 0) + 1
            c = self._class_outcomes.setdefault(req.slo_class, {})
            c[reason] = c.get(reason, 0) + 1
            t = self._tenant_outcomes.setdefault(req.tenant_id, {})
            t[reason] = t.get(reason, 0) + 1
            if reason in _SUCCESS and req.latency_s is not None:
                self._class_lat.setdefault(
                    req.slo_class, deque(maxlen=_WINDOW)
                ).append(req.latency_s)
                self._tenant_lat.setdefault(
                    req.tenant_id, deque(maxlen=_WINDOW)
                ).append(req.latency_s)
        # outside the ledger lock: the store has its own (lock order stays flat)
        self.series.append(SLO_BAD_KEY, 0.0 if reason in _SUCCESS else 1.0)  # graftcheck: noqa[CC001] — SeriesStore is internally locked; appending outside the ledger lock keeps the lock order flat

    # --------------------------------------------------------------- reading

    def summary(self) -> Dict[str, float]:
        with self._lock:
            routed = max(1, self._routed)
            return {
                "fleet_routed": float(self._routed),
                "fleet_affinity_hit_rate": self._affinity_hits / routed,
                "fleet_sticky_hit_rate": self._sticky_hits / routed,
                "fleet_random_hit_rate": self._random_hit_weight / routed,
                "fleet_reroutes": float(self._reroutes),
                "fleet_replica_kills": float(self._replica_kills),
                "fleet_scale_ups": float(self._scale_ups),
                "fleet_decommissions": float(self._decommissions),
                "fleet_finished": float(self._finished),
            }

    def p99_by_class(self) -> Dict[int, float]:
        with self._lock:
            return {c: _nearest_rank_p99(w) for c, w in self._class_lat.items()}

    def burn_rates(self) -> Dict[str, float]:
        """Fast/slow-window SLO burn rates from the terminal-outcome series.

        ``burn = windowed_bad_fraction / (1 - slo_target)`` — burn 1.0 means
        the error budget is being spent exactly at the sustainable rate;
        ``firing`` is 1.0 only when BOTH windows exceed ``burn_threshold``
        (the classic multi-window guard against paging on a blip)."""
        budget = 1.0 - self.slo_target
        fast = self.series.reduce(SLO_BAD_KEY, "mean", self.fast_window) / budget
        slow = self.series.reduce(SLO_BAD_KEY, "mean", self.slow_window) / budget
        firing = (
            fast > self.burn_threshold and slow > self.burn_threshold
        )
        return {
            "fast_burn": fast,
            "slow_burn": slow,
            "firing": 1.0 if firing else 0.0,
        }

    def export_gauges(
        self, *, replicas: int, pending_depth: int, restarts: int
    ) -> None:
        s = self.summary()
        gauges.set("fleet/replicas", float(replicas))
        gauges.set("fleet/pending_depth", float(pending_depth))
        gauges.set("fleet/restarts", float(restarts))
        gauges.set("fleet/routed", s["fleet_routed"])
        gauges.set("fleet/affinity_hit_rate", s["fleet_affinity_hit_rate"])
        gauges.set("fleet/sticky_hit_rate", s["fleet_sticky_hit_rate"])
        gauges.set("fleet/random_hit_rate", s["fleet_random_hit_rate"])
        gauges.set("fleet/reroutes", s["fleet_reroutes"])
        gauges.set("fleet/replica_kills", s["fleet_replica_kills"])
        gauges.set("fleet/autoscale/up", s["fleet_scale_ups"])
        gauges.set("fleet/autoscale/drain", s["fleet_decommissions"])
        gauges.set("fleet/finished", s["fleet_finished"])
        with self._lock:
            outcomes = dict(self._outcomes)
            class_lat = {c: list(w) for c, w in self._class_lat.items()}
            tenant_lat = {t: list(w) for t, w in self._tenant_lat.items()}
            class_out = {c: dict(o) for c, o in self._class_outcomes.items()}
            tenant_out = {t: dict(o) for t, o in self._tenant_outcomes.items()}
        for key in ("shed", "deadline", "preempted"):
            gauges.set(f"fleet/{key}", float(outcomes.get(key, 0)))
        burn = self.burn_rates()
        gauges.set("fleet/alert/fast_burn", burn["fast_burn"])
        gauges.set("fleet/alert/slow_burn", burn["slow_burn"])
        gauges.set("fleet/alert/firing", burn["firing"])
        for cls, window in class_lat.items():
            gauges.set(f"fleet/class/{cls}/p99_latency_s", _nearest_rank_p99(window))
        for tid, window in tenant_lat.items():
            gauges.set(f"fleet/tenant/{tid}/p99_latency_s", _nearest_rank_p99(window))
        for cls, counts in class_out.items():
            for key in ("shed", "deadline"):
                gauges.set(f"fleet/class/{cls}/{key}", float(counts.get(key, 0)))
        for tid, counts in tenant_out.items():
            for key in ("shed", "deadline"):
                gauges.set(f"fleet/tenant/{tid}/{key}", float(counts.get(key, 0)))

    def close(self) -> None:
        """Retire the fleet's observability surface (prefix-aware clear)."""
        gauges.clear(prefix="fleet/")
