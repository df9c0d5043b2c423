"""FlightRecorder: per-uid request lifecycle journaling and latency
decomposition (counterpart of ``trlx_tpu/obs/flight.py``, a copy).

A request served by the continuous-batching engine passes through admission
waves, chunked prefill, speculative decode rounds, quota preemptions,
shedding, supervised restarts and cross-replica adoption — and the per-step
span aggregates cannot say WHERE one request's latency went. The recorder
answers that: every lifecycle transition is journaled as a timestamped event
against the request's uid, and an online state machine folds the event
stream into a per-phase latency decomposition whose phases sum to the
request's wall latency *by construction* (each inter-event interval is
attributed to exactly one phase).

Event vocabulary (the instrumentation sites are the scheduler/engine/router
seams themselves, so the journal cannot drift from reality):

``submit, admit, prefill_chunk, decode_round, spec_accept, preempt, shed,
expire, re_route, adopt, finish, reward_dispatch, reward_done, store``

``finish`` / ``shed`` / ``expire`` are the terminal events — exactly one per
flight is the accounting invariant the flight tests enforce. Phases:

- ``queue_wait`` — submit → first admission (plus any pending re-wait);
- ``prefill`` — admission → first decode round (chunked prefill included);
- ``decode`` — decode rounds up to the terminal event;
- ``preempt_replay`` — preemption/re-route → the replay's first decode
  round (the blocks died; everything until decoding resumes is replay tax);
- ``reward`` — reward_dispatch → reward_done (trainer stream-overlap seam);
- ``store_wait`` — terminal/reward_done → the consumer storing the result.

**One clock.** Every instrumentation site passes the owning scheduler's
clock reading, so flight arithmetic agrees exactly with
``Request.latency_s`` — including under the scenario harnesses' virtual
clock and across replicas re-seated on a shared clock.

**Bounded memory.** Active flights are bounded by real in-flight work;
completed flights land in a fixed-size ring, and per-(tenant, class)
reservoirs (newest-N) feed the percentile gauges. Ring eviction drops the
uid index entry, so the recorder never grows with traffic volume.

**Restart/kill continuity.** Flight context rides the scheduler's
``export_state``/``adopt_state`` seam: a replica kill shows up as a
``re_route`` event *inside the same flight* (followed by ``adopt`` on the
survivor), never as a new flight — the chaos soak asserts this continuity.

**Off by default.** ``record()`` short-circuits on one attribute read when
disabled, and no site computes anything before that check — the
observability-off engine stays byte-identical (the existing parity tests
are the proof).

In this package the scheduler, the engine, the client, the online
collector, the serving supervisor (``re_route`` on a restart), the fleet
router (``re_route`` on a replica kill, with the adopting seat) and the
trainer's stream-overlap path (``reward_dispatch`` / ``reward_done`` /
``store``) journal.

Seeded regression: ``TRLX_FLIGHT_SEED_REGRESSION=drop_terminal`` makes the
recorder silently drop terminal events — the exactly-once accounting check
must fail under it.
"""

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from trlx_tpu_torch.utils.metrics import gauges, nearest_rank

#: every event the instrumentation sites may journal
FLIGHT_EVENTS = (
    "submit", "admit", "prefill_chunk", "decode_round", "spec_accept",
    "preempt", "shed", "expire", "re_route", "adopt", "finish",
    "reward_dispatch", "reward_done", "store",
)
#: exactly one of these per flight (the accounting invariant)
TERMINAL_EVENTS = ("finish", "shed", "expire")
#: the latency decomposition; phases sum to wall latency by construction
FLIGHT_PHASES = (
    "queue_wait", "prefill", "decode", "preempt_replay", "reward",
    "store_wait",
)
#: phases that make up the engine-side wall latency (submit → terminal);
#: reward/store_wait accrue after the terminal event
ENGINE_PHASES = ("queue_wait", "prefill", "decode", "preempt_replay")

_SEED_ENV = "TRLX_FLIGHT_SEED_REGRESSION"
_SEED_MODES = ("drop_terminal",)


class Flight:
    """One request's journaled lifecycle (see module docstring)."""

    __slots__ = (
        "uid", "tenant_id", "slo_class", "t0", "t_last", "state", "phases",
        "counts", "segments", "terminal_events", "terminal_reason",
        "t_terminal", "seats", "closed",
    )

    def __init__(self, uid: int, t: float, tenant_id: str, slo_class: int):
        self.uid = uid
        self.tenant_id = tenant_id
        self.slo_class = slo_class
        self.t0 = t
        self.t_last = t
        self.state = "queue_wait"
        self.phases: Dict[str, float] = {p: 0.0 for p in FLIGHT_PHASES}
        self.counts: Dict[str, int] = {"submit": 1}
        # coalesced (phase, t0, t1) timeline for the Chrome-trace lane;
        # bounded — a preemption storm cannot grow it without limit
        self.segments: List[List[Any]] = []
        self.terminal_events = 0
        self.terminal_reason: Optional[str] = None
        self.t_terminal: Optional[float] = None
        self.seats: List[Any] = []
        self.closed = False

    @property
    def done(self) -> bool:
        return self.terminal_events > 0

    @property
    def engine_wall_s(self) -> Optional[float]:
        """submit → terminal wall time (what ``Request.latency_s`` reports)."""
        return None if self.t_terminal is None else self.t_terminal - self.t0

    def engine_phase_sum(self) -> float:
        return sum(self.phases[p] for p in ENGINE_PHASES)

    def to_snapshot(self) -> Dict[str, Any]:
        """Serializable context for the export_state/adopt_state seam."""
        return {
            "uid": self.uid,
            "tenant_id": self.tenant_id,
            "slo_class": self.slo_class,
            "t0": self.t0,
            "t_last": self.t_last,
            "state": self.state,
            "phases": dict(self.phases),
            "counts": dict(self.counts),
            "segments": [list(s) for s in self.segments],
            "seats": list(self.seats),
        }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "Flight":
        fl = cls(snap["uid"], snap["t0"], snap["tenant_id"], snap["slo_class"])
        fl.t_last = snap["t_last"]
        fl.state = snap["state"]
        fl.phases.update(snap["phases"])
        fl.counts = dict(snap["counts"])
        fl.segments = [list(s) for s in snap["segments"]]
        fl.seats = list(snap["seats"])
        return fl


class FlightRecorder:
    """Process-global request-flight journal (see module docstring).

    Thread-safe: submits arrive from producer threads while the engine
    thread journals rounds; one lock covers the flight tables, held only
    for the bookkeeping itself.
    """

    def __init__(
        self,
        enabled: bool = False,
        ring: int = 2048,
        reservoir: int = 256,
        max_segments: int = 256,
    ):
        self.enabled = enabled
        self._lock = threading.Lock()
        self.clock = time.monotonic
        self.max_segments = int(max_segments)
        self._flights: Dict[int, Flight] = {}
        self._ring: deque = deque(maxlen=int(ring))
        self._reservoirs: Dict[Tuple[str, int], deque] = {}
        self._reservoir_size = int(reservoir)
        self._dropped_segments = 0

    def configure(
        self,
        enabled: bool,
        ring: Optional[int] = None,
        reservoir: Optional[int] = None,
        max_segments: Optional[int] = None,
    ) -> None:
        """Reconfigure in place (the global recorder outlives any one run)."""
        with self._lock:
            self.enabled = enabled
            if ring is not None:
                self._ring = deque(self._ring, maxlen=int(ring))
            if reservoir is not None:
                self._reservoir_size = int(reservoir)
            if max_segments is not None:
                self.max_segments = int(max_segments)

    def reset(self) -> None:
        """Drop all flights (tests / a fresh run)."""
        with self._lock:
            self._flights.clear()
            self._ring.clear()
            self._reservoirs.clear()
            self._dropped_segments = 0

    # --------------------------------------------------------------- journal

    @staticmethod
    def _seed_regression() -> Optional[str]:
        mode = os.environ.get(_SEED_ENV)
        if mode and mode not in _SEED_MODES:
            raise ValueError(
                f"{_SEED_ENV}={mode!r} is not a known seeded regression "
                f"(expected one of {_SEED_MODES})"
            )
        return mode or None

    def _advance(self, fl: Flight, t: float) -> None:
        """Close the current segment: attribute the interval since the last
        event to the current phase. Caller holds the lock (the record and
        adopt paths; a helper only for readability)."""
        dt = t - fl.t_last
        if dt > 0:
            fl.phases[fl.state] += dt
            if fl.segments and fl.segments[-1][0] == fl.state:
                fl.segments[-1][2] = t  # coalesce same-phase intervals
            elif len(fl.segments) < self.max_segments:
                fl.segments.append([fl.state, fl.t_last, t])
            else:
                self._dropped_segments += 1
        fl.t_last = t

    def _complete(self, fl: Flight) -> None:
        """Move a terminal flight into the ring + reservoirs; ring eviction
        retires the uid index entry (bounded memory). Caller holds the lock."""
        if self._ring.maxlen and len(self._ring) == self._ring.maxlen:
            evicted = self._ring[0]
            self._flights.pop(evicted.uid, None)
        self._ring.append(fl)
        res = self._reservoirs.setdefault(
            (fl.tenant_id, fl.slo_class), deque(maxlen=self._reservoir_size)
        )
        res.append(fl)

    def record(self, uid: int, event: str, t: Optional[float] = None, **meta) -> None:
        """Journal one lifecycle event. ``t`` is the owning scheduler's clock
        reading — every site passes it so all flights share one clock."""
        # lock-free read: the same one-attribute fast path as SpanTracer.span
        if not self.enabled:
            return
        if t is None:
            t = self.clock()
        terminal = event in TERMINAL_EVENTS
        if terminal and self._seed_regression() == "drop_terminal":
            return  # seeded CI regression: the exactly-once test must fail
        with self._lock:
            fl = self._flights.get(uid)
            created = fl is None
            if created:
                # first sighting: usually the submit; otherwise the journal
                # begins mid-flight (recorder enabled mid-run, or the uid was
                # ring-evicted) — partial truth beats dropping the event
                fl = Flight(
                    uid, t, meta.get("tenant_id", "-"),
                    int(meta.get("slo_class", 0)),
                )
                if event != "submit":
                    fl.counts = {}
                self._flights[uid] = fl
            else:
                self._advance(fl, t)
            if "seat" in meta and (not fl.seats or fl.seats[-1] != meta["seat"]):
                fl.seats.append(meta["seat"])
            if created and event == "submit":
                return  # Flight.__init__ already counted it
            fl.counts[event] = fl.counts.get(event, 0) + 1
            if terminal:
                fl.terminal_events += 1
                if fl.terminal_events == 1:
                    fl.terminal_reason = meta.get("reason", event)
                    fl.t_terminal = t
                    # post-terminal tail: waiting to be collected/stored
                    # unless a reward dispatch claims the interval
                    fl.state = "store_wait"
                    self._complete(fl)
                return
            if event == "admit":
                # a replayed admission (post-preempt/re-route) is replay tax,
                # not first-time prefill
                if fl.state != "preempt_replay":
                    fl.state = "prefill"
            elif event in ("decode_round", "spec_accept"):
                fl.state = "decode"
            elif event == "preempt":
                fl.state = "preempt_replay"
            elif event == "re_route":
                # pending requests keep waiting in the survivor's queue;
                # admitted ones lost their device state and must replay
                if fl.state not in ("queue_wait",):
                    fl.state = "preempt_replay"
            elif event == "reward_dispatch":
                fl.state = "reward"
            elif event == "reward_done":
                fl.state = "store_wait"
            elif event == "store":
                fl.closed = True
            # prefill_chunk / adopt / submit: stay in the current phase

    # ------------------------------------------------- export/adopt (replay)

    def export_flights(self, uids: Sequence[int]) -> Dict[int, Dict[str, Any]]:
        """Serialize flight context for the uids a dying engine exports —
        rides ``InflightScheduler.export_state`` so adoption elsewhere (or a
        supervised restart) continues the SAME flight."""
        if not self.enabled:
            return {}
        with self._lock:
            return {
                uid: self._flights[uid].to_snapshot()
                for uid in uids
                if uid in self._flights
            }

    def adopt_flights(
        self, snaps: Dict[int, Dict[str, Any]], t: Optional[float] = None,
        seat: Any = None,
    ) -> None:
        """Install exported flight context on the adopting engine and journal
        an ``adopt`` event per uid. In-process the flight usually still
        exists (the recorder is process-global) — the snapshot only fills
        gaps, it never forks a second flight for the same uid."""
        if not self.enabled:
            return
        if t is None:
            t = self.clock()
        with self._lock:
            for uid, snap in snaps.items():
                if uid not in self._flights:
                    self._flights[uid] = Flight.from_snapshot(snap)
        for uid in snaps:
            kw = {"seat": seat} if seat is not None else {}
            self.record(uid, "adopt", t=t, **kw)

    # --------------------------------------------------------------- reading

    def get(self, uid: int) -> Optional[Flight]:
        with self._lock:
            return self._flights.get(uid)

    def completed(self) -> List[Flight]:
        """Flights that reached a terminal event (ring order, oldest first)."""
        with self._lock:
            return list(self._ring)

    def active_count(self) -> int:
        with self._lock:
            return sum(1 for fl in self._flights.values() if not fl.done)

    def phase_percentiles(
        self, qs: Sequence[float] = (0.5, 0.95, 0.99)
    ) -> Dict[str, float]:
        """Nearest-rank percentiles per phase over the completed ring —
        the flat dict bench legs report (``queue_wait_p99`` etc.)."""
        with self._lock:
            flights = list(self._ring)
        out: Dict[str, float] = {}
        for phase in FLIGHT_PHASES:
            xs = sorted(fl.phases[phase] for fl in flights)
            for q in qs:
                out[f"{phase}_p{int(q * 100)}"] = (
                    nearest_rank(xs, q) if xs else 0.0
                )
        return out

    def export_gauges(self, prefix: str = "obs/flight/") -> None:
        """Reduce the reservoirs to per-tenant/per-class phase percentile
        gauges plus fleet-wide totals, all under ``prefix``."""
        if not self.enabled:
            return
        with self._lock:
            reservoirs = {k: list(v) for k, v in self._reservoirs.items()}
            completed = len(self._ring)
            active = sum(1 for fl in self._flights.values() if not fl.done)
            terminal_counts: Dict[str, int] = {}
            reroutes = 0
            for fl in self._ring:
                reason = fl.terminal_reason or "unknown"
                terminal_counts[reason] = terminal_counts.get(reason, 0) + 1
                reroutes += fl.counts.get("re_route", 0)
        gauges.set(prefix + "completed", float(completed))
        gauges.set(prefix + "active", float(active))
        gauges.set(prefix + "reroutes", float(reroutes))
        for reason, n in terminal_counts.items():
            gauges.set(f"{prefix}terminal/{reason}", float(n))
        by_class: Dict[int, Dict[str, List[float]]] = {}
        for (tid, cls), flights in reservoirs.items():
            for phase in FLIGHT_PHASES:
                xs = sorted(fl.phases[phase] for fl in flights)
                if not xs:
                    continue
                by_class.setdefault(cls, {}).setdefault(phase, []).extend(xs)
                for q, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    gauges.set(
                        f"{prefix}tenant/{tid}/class/{cls}/{phase}_{tag}",
                        nearest_rank(xs, q),
                    )
        for cls, phases in by_class.items():
            for phase, xs in phases.items():
                xs.sort()
                for q, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    gauges.set(
                        f"{prefix}class/{cls}/{phase}_{tag}",
                        nearest_rank(xs, q),
                    )

    def clear_gauges(self, prefix: str = "obs/flight/") -> None:
        gauges.clear(prefix=prefix)

    # ----------------------------------------------------------- trace merge

    def trace_events(self, epoch: Optional[float] = None) -> List[Dict[str, Any]]:
        """Chrome-trace async events: one lane per uid (``cat: "flight"``,
        nested phase segments), mergeable into the SpanTracer's event stream
        so a request reads as one lane in Perfetto. ``epoch`` maps the
        recorder's clock onto the tracer's timestamp origin."""
        with self._lock:
            flights = list(self._ring) + [
                fl for fl in self._flights.values() if not fl.done
            ]
            seen = set()
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        for fl in flights:
            if fl.uid in seen:
                continue
            seen.add(fl.uid)
            t0 = fl.t0 - (epoch if epoch is not None else fl.t0)
            base = {"pid": pid, "tid": 0, "cat": "flight", "id": fl.uid}
            args = {
                "tenant": fl.tenant_id,
                "slo_class": fl.slo_class,
                "reason": fl.terminal_reason,
                "seats": list(fl.seats),
            }
            end = fl.t_last - fl.t0
            events.append(
                {**base, "name": f"flight uid={fl.uid}", "ph": "b",
                 "ts": t0 * 1e6, "args": args}
            )
            for phase, s0, s1 in fl.segments:
                events.append(
                    {**base, "name": phase, "ph": "b",
                     "ts": (t0 + (s0 - fl.t0)) * 1e6}
                )
                events.append(
                    {**base, "name": phase, "ph": "e",
                     "ts": (t0 + (s1 - fl.t0)) * 1e6}
                )
            events.append(
                {**base, "name": f"flight uid={fl.uid}", "ph": "e",
                 "ts": (t0 + end) * 1e6}
            )
        return events


#: Process-global recorder; scheduler/engine/router/trainer sites journal,
#: the Observability runtime configures/exports (mirrors `gauges`/`tracer`).
flight = FlightRecorder()
