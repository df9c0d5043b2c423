"""FleetRouter: one logical serving surface over N supervised engine replicas
(counterpart of ``trlx_tpu/fleet/router.py``).

Every serving feature of one engine (paged KV, spec decode, tenancy,
resilience, overlap) drives exactly one
:class:`~trlx_tpu_torch.serving.engine.ServingEngine`.
Podracer-style fleets get pod-scale throughput from many independent replicas
behind a dispatcher; this module is that dispatcher (docs/serving.md "Fleet
serving"):

- **Prefix-cache-aware + tenant-affinity routing.** A new request is scored
  against every active replica: warm prefix blocks for the prompt's
  token-chain hash (``allocator.cached_prefix_blocks`` — the replica that
  already holds the prefix prefills almost nothing), where the tenant's
  recent traffic landed (KV reuse and per-tenant batching compound on the
  same replica), minus current load (live slots + pending depth). Highest
  score wins; with the weights zeroed this degenerates to pure
  least-loaded. The seeded CI regression
  ``TRLX_FLEET_SEED_REGRESSION=blind_router`` forces exactly that
  degeneration in memory so a test can prove the affinity-hit-rate check
  fails without real affinity.
- **Consistent re-route with exactly-once terminal accounting.** A replica
  that exhausts its supervised restart budget — or is hard-killed by the
  ``fleet-replica-kill`` chaos site — dies; its host-side request state
  (:meth:`InflightScheduler.export_state`) is adopted by the least-loaded
  survivor, exactly the supervisor's own replay seam but *across* replicas.
  Uids never collide (each replica's scheduler is seated in a disjoint uid
  block, :data:`UID_STRIDE` apart) and never change on re-route, so
  client-held uids stay valid and every uid still reaches exactly one
  terminal state.
- **Graceful decommission.** :meth:`begin_decommission` puts a replica in
  drain (reject new routes, let queued + live work finish); the fleet keeps
  stepping it until it empties, then retires it — the
  :class:`~trlx_tpu_torch.fleet.autoscaler.FleetAutoscaler` scale-down path.

The router is a drop-in for the engine from
:class:`~trlx_tpu_torch.serving.client.GenerationClient`'s point of view
(``submit``/``cancel``/``step``/``run``/``drain``/``scheduler``/``summary``/
``pad_token_id``); a fleet of one replica is byte-identical to the bare
engine (same uids, same rng fold sequence, same outputs — the parity test's
contract).

Thread-safety matches the engine's: ``submit``/``cancel`` may come from
producer threads; ``step``/``run``/``drain`` and the autoscaler's
add/decommission calls are single-driver. The router lock guards only the
routing tables (handle list, uid→replica map, affinity counters) and is
never held across an engine round or a replica build.
"""

import os
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from trlx_tpu_torch.fleet.ledger import _SUCCESS, FleetLedger
from trlx_tpu_torch.obs.flight import flight
from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.serving.engine import ServingEngine
from trlx_tpu_torch.serving.scheduler import Request
from trlx_tpu_torch.serving.supervisor import ServingRestartBudgetExceeded, ServingSupervisor
from trlx_tpu_torch.serving.tenancy import DEFAULT_TENANT
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

#: uid block size per replica seat: each replica's scheduler counts uids from
#: ``seat * UID_STRIDE``, so uids from different replicas can never collide
#: (2^40 requests per replica before overlap — effectively never) and seat 0
#: counts from 0, which is what keeps a one-replica fleet uid-identical to
#: the bare engine.
UID_STRIDE = 1 << 40

# replica lifecycle states
ACTIVE = "active"       # routing candidate, stepped every round
DRAINING = "draining"   # no new routes; stepped until its work finishes
DEAD = "dead"           # killed or fully drained; never stepped again


class ReplicaHandle:
    """One replica: a seat number (monotonic, never reused — it namespaces
    the uid block and the ``serving/replica/<seat>/`` gauges), the
    supervisor wrapping its engine generations, and its lifecycle state."""

    def __init__(self, seat: int, supervisor: ServingSupervisor):
        self.seat = seat
        self.supervisor = supervisor
        self.state = ACTIVE
        # set when a kill exports this replica's state into a survivor:
        # adopt_state folds the outcome counters in there, so fleet-wide
        # counter sums must skip this handle or double-count
        self.counters_adopted = False

    @property
    def scheduler(self):
        return self.supervisor.scheduler

    @property
    def load(self) -> float:
        """Normalized queue pressure: (live slots + pending) per slot."""
        sched = self.supervisor.scheduler
        return (sched.live_slots + sched.pending_depth) / max(
            1, self.supervisor.num_slots
        )

    def __repr__(self):
        return f"ReplicaHandle(seat={self.seat}, state={self.state})"


class _FleetScheduler:
    """The ``engine.scheduler`` facade :class:`GenerationClient` drives:
    uid-keyed lookups forward to the owning replica's scheduler, finished
    collection sweeps every live replica with router-level exactly-once
    dedup. Read-only composition — all mutation goes through the router."""

    def __init__(self, router: "FleetRouter"):
        self._router = router

    @property
    def has_work(self) -> bool:
        return any(
            h.scheduler.has_work for h in self._router._live_handles()
        )

    @property
    def pending_depth(self) -> int:
        return sum(
            h.scheduler.pending_depth for h in self._router._live_handles()
        )

    def get_request(self, uid: int) -> Optional[Request]:
        h = self._router._handle_of(uid)
        return None if h is None else h.scheduler.get_request(uid)

    def pop_request(self, uid: int) -> Optional[Request]:
        return self._router._pop_request(uid)

    def pop_finished(self) -> Dict[int, Request]:
        return self._router._pop_finished()

    def outcome_counts(self) -> Dict[str, int]:
        totals: Dict[str, int] = {"shed": 0, "expired": 0, "preempted": 0}
        for h in self._router._all_handles():
            if h.counters_adopted:
                continue  # already folded into a survivor by adopt_state
            for key, n in h.scheduler.outcome_counts().items():
                totals[key] = totals.get(key, 0) + n
        return totals


class FleetRouter:
    """Prefix-affinity router + lifecycle manager over N supervised replicas
    (module docstring).

    :param engine_factory: ``engine_factory(seat) -> ServingEngine`` builds
        one replica's engine. The router re-namespaces whatever it returns
        (``gauge_prefix = serving/replica/<seat>/``, ``replica_id = seat``)
        and seats its uid counter at ``seat * UID_STRIDE`` — the factory
        varies per-replica inputs it cares about (e.g. the sampling seed)
        off the seat argument.
    :param num_replicas: replicas built up front (the autoscaler may add or
        drain more later, between ``min_replicas`` and its own cap).
    :param prefix_weight: score weight per warm prefix block the candidate
        already caches for the prompt.
    :param tenant_weight: score weight per recent request of the same tenant
        routed to the candidate (the stickiness term).
    :param load_weight: score penalty per unit of normalized load
        (live slots + pending, per slot) — the least-loaded fallback: with
        no warm prefix and no tenant history anywhere, the emptiest replica
        wins.
    :param tenant_window: how many recent routing decisions per tenant feed
        the stickiness term.
    """

    def __init__(
        self,
        engine_factory: Callable[[int], ServingEngine],
        num_replicas: int,
        *,
        prefix_weight: float = 1.0,
        tenant_weight: float = 0.25,
        load_weight: float = 2.0,
        tenant_window: int = 32,
        max_restarts: int = 3,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 10.0,
        wedge_timeout_s: Optional[float] = 60.0,
        diagnostics_dir: str = "diagnostics",
        learn_tenants: Optional[Sequence[str]] = None,
    ):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        seed_reg = os.environ.get("TRLX_FLEET_SEED_REGRESSION", "")
        if seed_reg not in ("", "blind_router"):
            raise ValueError(
                f"TRLX_FLEET_SEED_REGRESSION={seed_reg!r}: only "
                f"'blind_router' is defined"
            )
        self._seed_regression = seed_reg
        self._factory = engine_factory
        # learn-eligibility tagging (docs/online.md): every successfully
        # finished request is stamped learn-eligible at sweep time; a
        # learn_tenants allow-list narrows harvesting to opted-in tenants
        self._learn_tenants = (
            None if learn_tenants is None else frozenset(map(str, learn_tenants))
        )
        self.prefix_weight = float(prefix_weight)
        self.tenant_weight = float(tenant_weight)
        self.load_weight = float(load_weight)
        self.tenant_window = int(tenant_window)
        self._sup_kwargs = dict(
            max_restarts=max_restarts,
            backoff_base_s=backoff_base_s,
            backoff_max_s=backoff_max_s,
            wedge_timeout_s=wedge_timeout_s,
            diagnostics_dir=diagnostics_dir,
        )
        self.ledger = FleetLedger()
        # routing tables: handle list + uid ownership + per-tenant recent
        # seats. submit() runs on producer threads while step() re-routes on
        # the driving thread — one lock covers them all, held only for table
        # reads/writes (never across an engine round or a replica build).
        self._lock = threading.Lock()
        self._handles: List[ReplicaHandle] = []
        self._retired: List[ReplicaHandle] = []
        self._uid_seat: Dict[int, ReplicaHandle] = {}
        self._tenant_recent: Dict[str, deque] = {}
        self._finished: Dict[int, Request] = {}
        self._delivered: set = set()
        self._next_seat = 0
        self._params = None
        self._params_set = False
        self.scheduler = _FleetScheduler(self)
        for _ in range(int(num_replicas)):
            self.add_replica()

    # -------------------------------------------------------------- lifecycle

    def _prep_engine(self, engine: ServingEngine, seat: int) -> ServingEngine:
        """Namespace a freshly built engine into its replica seat. Runs for
        the initial build AND every supervised restart (the supervisor's
        factory closes over this), so a successor engine keeps its seat's
        gauge prefix, replica id and uid block."""
        engine.gauge_prefix = f"serving/replica/{seat}/"
        engine.replica_id = seat
        engine.scheduler.seat_uid_base(seat * UID_STRIDE)
        with self._lock:
            params, params_set = self._params, self._params_set
        if params_set:
            engine.set_params(params)
        return engine

    def add_replica(self) -> ReplicaHandle:
        """Build and activate one replica at the next seat (autoscaler
        scale-up; also the constructor's initial build). Seats are never
        reused: a replica added after a drain gets a fresh uid block and a
        fresh gauge namespace."""
        with self._lock:
            seat = self._next_seat
            self._next_seat += 1
        sup = ServingSupervisor(
            lambda: self._prep_engine(self._factory(seat), seat),
            heartbeat=f"serving-engine-r{seat}",
            **self._sup_kwargs,
        )
        handle = ReplicaHandle(seat, sup)
        with self._lock:
            self._handles.append(handle)
        logger.info(f"fleet: replica seat {seat} active")
        return handle

    def begin_decommission(self, handle: ReplicaHandle) -> None:
        """Gracefully drain one replica (autoscaler scale-down): no new
        routes land on it, queued requests are NOT shed (they finish where
        they were accepted), and :meth:`step` retires it once its scheduler
        empties."""
        with self._lock:
            if handle.state != ACTIVE:
                return
            handle.state = DRAINING
        handle.supervisor.begin_drain(shed_pending=False)
        self.ledger.note_decommission()
        logger.info(f"fleet: replica seat {handle.seat} draining")

    def _retire(self, handle: ReplicaHandle) -> None:
        """Take a drained/dead replica out of the fleet: sweep its last
        finished requests, unregister its watchdog escalation, clear its
        gauge namespace, and drop its trunk and KV pools (the handle stays
        for the fleet's counters; its device memory must not)."""
        self._sweep(handle)
        handle.supervisor.close()
        engine = handle.supervisor.engine
        engine.close()  # prefix-aware gauge clear
        engine.release_device_state()
        with self._lock:
            handle.state = DEAD
            if handle in self._handles:
                self._handles.remove(handle)
            self._retired.append(handle)

    def _kill_replica(self, handle: ReplicaHandle, reason: str) -> None:
        """Hard replica death (restart budget exhausted, or chaos
        ``fleet-replica-kill``): export the dead scheduler's host-side
        request state and re-route it onto the least-loaded surviving
        replica via the same adopt/replay seam a supervised restart uses.
        Uids are preserved (the survivor's counter is already seated past
        every adopted uid) — exactly-once terminal accounting holds. With
        no survivor the failure propagates: a dead fleet must fail closed,
        not strand accepted requests."""
        with self._lock:
            survivors = [
                h for h in self._handles if h is not handle and h.state == ACTIVE
            ]
        if not survivors:
            raise ServingRestartBudgetExceeded(
                f"fleet: replica seat {handle.seat} died with no surviving "
                f"active replica to adopt its requests ({reason})"
            )
        self._sweep(handle)  # finished-but-uncollected must not be replayed
        state = handle.supervisor.engine.scheduler.export_state()
        target = min(survivors, key=lambda h: (h.load, h.seat))
        logger.warning(
            f"fleet: replica seat {handle.seat} died ({reason}); re-routing "
            f"{len(state['replay'])} requests to seat {target.seat}"
        )
        if flight.enabled:
            # a replica kill is a re-route INSIDE the same flight: the uid's
            # journal keeps accumulating across seats, so the preempt_replay
            # phase absorbs the adoption tax instead of the flight forking
            t_kill = target.supervisor.engine.scheduler.clock()
            for req in state["replay"]:
                flight.record(
                    req.uid, "re_route", t=t_kill,
                    seat=target.seat, reason=reason,
                )
        target.supervisor.engine.adopt(state)
        handle.counters_adopted = True
        self._retire(handle)
        with self._lock:
            # ownership follows the requests: every uid the dead replica
            # held now answers on the survivor
            for uid, h in list(self._uid_seat.items()):
                if h is handle:
                    self._uid_seat[uid] = target
        self.ledger.note_kill(rerouted=len(state["replay"]))

    # ---------------------------------------------------------------- routing

    def _live_handles(self) -> List[ReplicaHandle]:
        with self._lock:
            return [h for h in self._handles if h.state != DEAD]

    def _active_handles(self) -> List[ReplicaHandle]:
        with self._lock:
            return [h for h in self._handles if h.state == ACTIVE]

    def _all_handles(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self._handles) + list(self._retired)

    def _handle_of(self, uid: int) -> Optional[ReplicaHandle]:
        with self._lock:
            return self._uid_seat.get(uid)

    def replica_of(self, uid: int) -> Optional[int]:
        """Seat serving ``uid`` (error attribution for typed client errors)."""
        h = self._handle_of(uid)
        return None if h is None else h.seat

    def _score(
        self, handle: ReplicaHandle, prompt: Sequence[int], tenant_id: str
    ) -> float:
        warm = handle.supervisor.engine.allocator.cached_prefix_blocks(prompt)
        with self._lock:
            recent = self._tenant_recent.get(tenant_id)
            sticky = sum(1 for s in recent if s == handle.seat) if recent else 0
        if self._seed_regression == "blind_router":
            # seeded CI regression: pure least-loaded, affinity ignored —
            # the affinity-hit-rate gate must FAIL under this
            return -self.load_weight * handle.load
        return (
            self.prefix_weight * warm
            + self.tenant_weight * sticky
            - self.load_weight * handle.load
        )

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        stop_sequences: Sequence[Sequence[int]] = (),
        deadline_s: Optional[float] = None,
        tenant_id: Optional[str] = None,
    ) -> int:
        """Route one request: score every active replica, submit to the
        best. The ``fleet-route`` chaos site deliberately mis-routes to the
        WORST-scoring replica — routing quality is a performance property,
        never a correctness one, and the soak proves mis-routed requests
        still finish exactly once."""
        candidates = self._active_handles()
        if not candidates:
            raise ServingRestartBudgetExceeded(
                "fleet: no active replica to route to"
            )
        tid = DEFAULT_TENANT if tenant_id is None else str(tenant_id)
        prompt = list(map(int, prompt))
        scored = sorted(
            ((self._score(h, prompt, tid), -h.load, -h.seat, h) for h in candidates),
            key=lambda s: (s[0], s[1], s[2]),
            reverse=True,
        )
        chosen = scored[-1][3] if chaos.should_fail("fleet-route") else scored[0][3]
        uid = chosen.supervisor.submit(
            prompt, max_new_tokens, stop_sequences=stop_sequences,
            deadline_s=deadline_s, tenant_id=tenant_id,
        )
        warm_chosen = chosen.supervisor.engine.allocator.cached_prefix_blocks(prompt)
        warm_anywhere = sum(
            1 for h in candidates
            if h.supervisor.engine.allocator.cached_prefix_blocks(prompt) > 0
        )
        with self._lock:
            self._uid_seat[uid] = chosen
            recent = self._tenant_recent.setdefault(
                tid, deque(maxlen=self.tenant_window)
            )
            sticky_hit = chosen.seat in recent
            recent.append(chosen.seat)
        self.ledger.note_route(
            affinity_hit=warm_chosen > 0,
            sticky_hit=sticky_hit,
            # what uniform-random routing would have hit: the fraction of
            # candidates holding any warm prefix for this prompt — the
            # baseline fleet_affinity_hit_rate must beat
            random_hit_weight=warm_anywhere / len(candidates),
        )
        return uid

    def cancel(self, uid: int) -> bool:
        h = self._handle_of(uid)
        return False if h is None else h.supervisor.cancel(uid)

    # ----------------------------------------------------------------- driver

    def _sweep(self, handle: ReplicaHandle) -> None:
        """Collect one replica's newly finished requests into the fleet
        buffer, exactly once per uid (a request re-routed after a kill can
        only ever surface from one scheduler, but the delivered set keeps
        that a checked invariant rather than an assumed one)."""
        finished = handle.scheduler.pop_finished()
        if not finished:
            return
        fresh: List[Request] = []
        with self._lock:
            for uid, req in finished.items():
                if uid in self._delivered:
                    continue
                self._delivered.add(uid)
                self._finished[uid] = req
                fresh.append(req)
        for req in fresh:
            # stamp learn-eligibility for the online collector (exactly once
            # per uid — this loop is already dedup-guarded above): successful
            # finishes from opted-in tenants may become GRPO training data
            req.learn_eligible = bool(
                req.finish_reason in _SUCCESS
                and req.generated
                and (
                    self._learn_tenants is None
                    or req.tenant_id in self._learn_tenants
                )
            )
            self.ledger.record(req)

    def _pop_finished(self) -> Dict[int, Request]:
        for h in self._live_handles():
            self._sweep(h)
        with self._lock:
            out, self._finished = self._finished, {}
        return out

    def _pop_request(self, uid: int) -> Optional[Request]:
        h = self._handle_of(uid)
        with self._lock:
            self._uid_seat.pop(uid, None)
        return None if h is None else h.scheduler.pop_request(uid)

    def step(self) -> List[Request]:
        """One fleet round: every live replica steps once (active AND
        draining — a draining replica still owes its queued work), dead ones
        are re-routed, fully drained ones retire. Returns the requests that
        reached a terminal state this round, fleet-wide."""
        if chaos.should_fail("fleet-replica-kill"):
            actives = self._active_handles()
            if len(actives) > 1:
                victim = max(actives, key=lambda h: (h.load, h.seat))
                self._kill_replica(victim, "chaos: fleet-replica-kill")
        finished: List[Request] = []
        for handle in self._live_handles():
            try:
                finished.extend(handle.supervisor.step())
            except ServingRestartBudgetExceeded as e:
                self._kill_replica(handle, f"restart budget exhausted: {e}")
                continue
            if handle.state == DRAINING and not handle.scheduler.has_work:
                self._retire(handle)
                logger.info(f"fleet: replica seat {handle.seat} drained and retired")
        return finished

    def run(self, uids: Optional[Sequence[int]] = None) -> Dict[int, Request]:
        """Drive fleet rounds until the given uids (or all work) complete —
        the fleet mirror of :meth:`ServingEngine.run`."""
        want = set(uids) if uids is not None else None
        done: Dict[int, Request] = dict(self._pop_finished())
        while True:
            if want is not None:
                if want <= set(done):
                    break
                if not self.scheduler.has_work:
                    raise RuntimeError(
                        f"fleet drained with requests unaccounted: {want - set(done)}"
                    )
            elif not self.scheduler.has_work:
                break
            self.step()
            done.update(self._pop_finished())
            self.export_gauges()
        return done

    def begin_drain(self, shed_pending: bool = True) -> None:
        for h in self._active_handles():
            with self._lock:
                h.state = DRAINING
            h.supervisor.begin_drain(shed_pending=shed_pending)

    def drain(self) -> Dict[int, Request]:
        """Fleet-wide graceful shutdown: drain every replica, step until all
        work is accounted, retire everything."""
        self.begin_drain()
        done: Dict[int, Request] = dict(self._pop_finished())
        while self.scheduler.has_work:
            self.step()
            done.update(self._pop_finished())
        for h in self._live_handles():
            self._retire(h)
        return done

    def close(self) -> None:
        """Retire every replica (watchdog escalations unregistered, per-
        replica gauge namespaces cleared) and the fleet's own ``fleet/*``
        gauges."""
        for h in self._live_handles():
            self._retire(h)
        self.ledger.close()

    # ------------------------------------------------- engine-compat surface

    @property
    def pad_token_id(self) -> int:
        return self._any_handle().supervisor.pad_token_id

    @property
    def tenants(self):
        return self._any_handle().supervisor.tenants

    @property
    def num_blocks(self) -> int:
        """Total KV pool across live replicas (capacity logging)."""
        return sum(h.supervisor.num_blocks for h in self._live_handles())

    @property
    def num_replicas(self) -> int:
        return len(self._active_handles())

    @property
    def serving_version(self) -> int:
        return self._any_handle().supervisor.serving_version

    def _any_handle(self) -> ReplicaHandle:
        with self._lock:
            handles = self._handles or self._retired
            if not handles:
                raise RuntimeError("fleet has no replicas")
            return handles[0]

    def set_params(self, params) -> None:
        """Swap the parameter snapshot on every live replica — remembered so
        replicas added later (autoscale-up, supervised restart) come up with
        the same weights."""
        with self._lock:
            self._params = params
            self._params_set = True
        for h in self._live_handles():
            h.supervisor.set_params(params)

    def note_overlap(self, decode_busy_s: float, overlapped_s: float) -> None:
        self._any_handle().supervisor.note_overlap(decode_busy_s, overlapped_s)

    def summary(self) -> Dict[str, float]:
        """Fleet-aggregate of the per-replica summaries: additive counters
        sum, rate-like keys average over live replicas, plus the fleet's own
        routing/lifecycle counters."""
        live = self._live_handles()
        sums: Dict[str, float] = {}
        for h in live:
            for key, v in h.supervisor.summary().items():
                sums[key] = sums.get(key, 0.0) + float(v)
        for key in (
            "accepted_tok_per_round", "spec_accept_rate", "overlap_fraction",
            "mean_slot_occupancy", "prefix_cache_hit_rate",
        ):
            if key in sums and live:
                sums[key] /= len(live)
        sums.update(self.ledger.summary())
        sums["replicas"] = float(len(self._active_handles()))
        return sums

    def export_gauges(self) -> None:
        """Per-replica gauges under each seat's own namespace, then the
        fleet-level ``fleet/*`` aggregation."""
        live = self._live_handles()
        for h in live:
            h.supervisor.export_gauges()
        restarts = sum(h.supervisor.restarts for h in live + self._all_retired())
        self.ledger.export_gauges(
            replicas=len(self._active_handles()),
            pending_depth=self.scheduler.pending_depth,
            restarts=restarts,
        )

    def _all_retired(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self._retired)


def fleet_factory(
    engine_factory: Callable[[int], ServingEngine],
    fleet_config: Any,
    **supervisor_kwargs,
) -> FleetRouter:
    """Build a :class:`FleetRouter` from a ``train.serving_fleet`` config
    (:class:`~trlx_tpu_torch.data.configs.ServingFleetConfig`) — the trainer's
    wiring seam, kept here so the config module never imports the fleet."""
    return FleetRouter(
        engine_factory,
        fleet_config.num_replicas,
        prefix_weight=fleet_config.prefix_weight,
        tenant_weight=fleet_config.tenant_weight,
        load_weight=fleet_config.load_weight,
        tenant_window=fleet_config.tenant_window,
        **supervisor_kwargs,
    )
