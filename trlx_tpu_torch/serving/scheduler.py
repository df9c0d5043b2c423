"""In-flight batching scheduler: requests, decode slots, finish detection.

The engine's device step always runs the full ``num_slots`` batch; this
module decides *what occupies each slot*. A slot frees the moment its
sequence finishes (eos, stop-sequence, max-new-tokens, or cancel) and the
next pending request is admitted into it on the following admission round —
continuous batching, as opposed to the one-shot ``generate`` path that pads
every sequence to the longest straggler in its batch.

Admission is capacity-gated by the :class:`PagedBlockAllocator`: a request is
only placed when its worst-case block reservation (prompt + max_new) fits,
so a live sequence can never hit an allocation failure mid-flight. Pending
requests are sorted by prompt length at each round so one admission wave
prefills in a few tight buckets instead of one ragged batch.

With a :class:`~trlx_tpu_torch.serving.policy.ServingResiliencePolicy` installed
the scheduler also runs the request-level fault-tolerance passes
(docs/serving.md "Fault tolerance"): pending/live deadline expiry
(``deadline`` outcome), watermark load shedding (``shed``), optimistic
admission with KV-pressure preemption re-queueing, and the export/adopt
replay seam the :class:`~trlx_tpu_torch.serving.supervisor.ServingSupervisor`
uses to move accepted requests onto a rebuilt engine. Without a policy every
pass is a no-op and behavior is byte-identical to the original engine.

Every lifecycle transition (submit, admit, finish / shed / expire,
preempt) is journaled in the request-flight recorder
(:mod:`trlx_tpu_torch.obs.flight`) on this scheduler's clock; each site
checks ``flight.enabled`` first, so with observability off it costs one
attribute read, and the flight context rides ``export_state`` /
``adopt_state``.
"""

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from trlx_tpu_torch.obs.flight import flight
from trlx_tpu_torch.serving.allocator import PagedBlockAllocator, SeqBlocks
from trlx_tpu_torch.serving.policy import ServingResiliencePolicy
from trlx_tpu_torch.serving.tenancy import DEFAULT_TENANT, TenantRegistry

FINISH_EOS = "eos"
FINISH_STOP = "stop_sequence"
FINISH_LENGTH = "length"
FINISH_CANCELLED = "cancelled"
# fault-tolerance terminal states (docs/serving.md "Fault tolerance"): a
# request past its TTL/deadline, and one shed under admission pressure or
# drain. Both are accountable — they land in `finished` like any other end.
FINISH_DEADLINE = "deadline"
FINISH_SHED = "shed"


def _terminal_flight_event(reason: str) -> str:
    """Map a finish reason onto the flight vocabulary's terminal event:
    ``shed`` and ``expire`` are their own events (they are policy outcomes
    an operator alerts on), everything else is a ``finish``."""
    if reason == FINISH_SHED:
        return "shed"
    if reason == FINISH_DEADLINE:
        return "expire"
    return "finish"


@dataclass
class Request:
    """One generation request. ``prompt`` is token ids (no padding)."""

    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()
    # wall-clock accounting (scheduler clock, monotonic seconds): deadline_s
    # is a TTL from submit; None = no deadline for this request
    submitted_at: float = 0.0
    deadline_s: Optional[float] = None
    finished_at: Optional[float] = None
    # tenancy (docs/serving.md "Multi-tenancy and SLO classes"): every
    # request runs under a tenant; higher slo_class = admitted first, shed
    # last. Untagged traffic carries the defaults and behaves exactly as in
    # the tenant-blind engine.
    tenant_id: str = DEFAULT_TENANT
    slo_class: int = 0
    # -- filled in by the scheduler/engine --
    generated: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    seq_blocks: Optional[SeqBlocks] = None
    slot: Optional[int] = None
    preemptions: int = 0
    # admission rounds this request was passed over while slots were free —
    # feeds the age-priority bonus that breaks shortest-prompt-first starvation
    admit_waits: int = 0
    # chunked prefill progress: prompt tokens already written to the paged
    # cache for the CURRENT placement (device-local — reset to 0 whenever the
    # blocks are lost: preemption or supervised replay)
    prefilled: int = 0

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def prefill_ids(self) -> List[int]:
        """Tokens to prefill on (re-)admission: the prompt plus everything
        generated so far — a preempted or replayed request re-enters the
        cache from host-side state, losing nothing."""
        return self.prompt + self.generated

    @property
    def remaining_tokens(self) -> int:
        """Decode budget left (the preemption victim metric)."""
        return self.max_new_tokens - len(self.generated)

    def past_deadline(self, now: float) -> bool:
        return self.deadline_s is not None and now - self.submitted_at > self.deadline_s

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.finished_at is None else self.finished_at - self.submitted_at


class InflightScheduler:
    def __init__(
        self,
        num_slots: int,
        allocator: PagedBlockAllocator,
        policy: Optional[ServingResiliencePolicy] = None,
        clock=time.monotonic,
        age_priority_after: int = 4,
        age_priority_bonus: int = 64,
        tenants: Optional[TenantRegistry] = None,
    ):
        self.num_slots = num_slots
        self.allocator = allocator
        # fault-tolerance policy (deadlines / shedding / optimistic
        # admission); None = worst-case admission with no deadlines or shedding
        self.policy = policy
        # tenancy registry (SLO classes / quotas / per-class TTLs); None =
        # tenant-blind scheduling, byte-identical to the pre-tenancy engine
        self.tenants = tenants
        self.clock = clock
        # anti-starvation: after `age_priority_after` passed-over admission
        # rounds, a pending request's effective sort length shrinks by
        # `age_priority_bonus` tokens per additional round — long prompts
        # eventually outrank any sustained stream of fresh short prompts
        # (bonus * waits grows without bound, prompt lengths don't)
        self.age_priority_after = age_priority_after
        self.age_priority_bonus = age_priority_bonus
        self._uid = itertools.count()
        self._lock = threading.Lock()
        self._pending: List[Request] = []
        self._cancelled: set = set()
        self.slots: List[Optional[Request]] = [None] * num_slots
        self.finished: Dict[int, Request] = {}
        # uid -> Request for every request ever submitted (stream/cancel
        # lookups); entries are dropped when the consumer collects them
        self.requests: Dict[int, Request] = {}
        # occupancy accounting for the obs gauge: live slots integrated over steps
        self.steps = 0
        self.occupied_slot_steps = 0
        # fault-tolerance outcome counters (written under _lock or on the
        # engine thread; exported through engine gauges)
        self.shed_count = 0
        self.expired_count = 0
        self.preempted_count = 0
        # per-tenant / per-SLO-class outcome breakdowns (same write sites as
        # the global counters, same lock; exported as serving/tenant/* and
        # serving/class/* gauges and carried across supervised restarts)
        self.tenant_counts: Dict[str, Dict[str, int]] = {}
        self.class_counts: Dict[int, Dict[str, int]] = {}
        # highest uid ever issued + 1: a successor scheduler (supervised
        # restart) resumes the counter here so client-held uids stay unique
        self.uid_hwm = 0

    # -- request intake (thread-safe: rollout producers submit from their own
    # threads while the engine loop drains) --------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        eos_token_id: Optional[int] = None,
        stop_sequences: Sequence[Sequence[int]] = (),
        deadline_s: Optional[float] = None,
        tenant_id: Optional[str] = None,
    ) -> int:
        # deadline precedence: explicit per-request TTL > tenant TTL > class
        # TTL > policy TTL (the first two live in the registry's ttl_for)
        tid, slo_class = DEFAULT_TENANT, 0
        if self.tenants is not None:
            spec = self.tenants.resolve(tenant_id)
            tid, slo_class = spec.tenant_id, spec.slo_class
            if deadline_s is None:
                deadline_s = self.tenants.ttl_for(spec)
        elif tenant_id is not None:
            tid = str(tenant_id)
        if deadline_s is None and self.policy is not None:
            deadline_s = self.policy.request_ttl_s
        with self._lock:
            # the uid draw stays under the lock: adopt_state() re-seats the
            # counter on a supervised restart, and a submit racing that swap
            # must not draw from the retired counter
            req = Request(
                uid=next(self._uid),
                prompt=list(map(int, prompt)),
                max_new_tokens=int(max_new_tokens),
                eos_token_id=eos_token_id,
                stop_sequences=tuple(tuple(map(int, s)) for s in stop_sequences if len(s)),
                submitted_at=self.clock(),
                deadline_s=deadline_s,
                tenant_id=tid,
                slo_class=slo_class,
            )
            self._pending.append(req)
            self.requests[req.uid] = req
            self.uid_hwm = max(self.uid_hwm, req.uid + 1)
        if flight.enabled:
            flight.record(req.uid, "submit", t=req.submitted_at, tenant_id=tid, slo_class=slo_class)
        return req.uid

    def cancel(self, uid: int) -> bool:
        """Cancel a pending or in-flight request. In-flight sequences are
        reaped (blocks freed) on the next admission round."""
        with self._lock:
            for i, req in enumerate(self._pending):
                if req.uid == uid:
                    self._pending.pop(i)
                    req.finish_reason = FINISH_CANCELLED
                    req.finished_at = self.clock()
                    self.finished[uid] = req
                    if flight.enabled:
                        flight.record(uid, "finish", t=req.finished_at, reason=FINISH_CANCELLED)
                    return True
            self._cancelled.add(uid)
        # racy-but-benign read of engine-thread state: a request placed
        # concurrently is still reaped next round via _cancelled
        return any(r is not None and r.uid == uid for r in self.slots)  # graftcheck: noqa[CC001]

    @property
    def has_work(self) -> bool:
        with self._lock:
            pending = bool(self._pending)
        return pending or any(r is not None for r in self.slots)

    @property
    def live_slots(self) -> int:
        return sum(r is not None for r in self.slots)

    def pop_finished(self) -> Dict[int, Request]:
        # locked against a producer-thread cancel() landing a pending request
        # in `finished` between the read and the reset
        with self._lock:
            out, self.finished = self.finished, {}
        return out

    def get_request(self, uid: int) -> Optional[Request]:
        """Locked lookup in the uid index (producers mutate it in submit)."""
        with self._lock:
            return self.requests.get(uid)

    def pop_request(self, uid: int) -> Optional[Request]:
        """Drop a request from the uid index once the consumer has collected
        it — locked against producer-side ``submit()`` writing the same map
        (client-side ``dict.pop`` on the bare attribute raced it)."""
        with self._lock:
            return self.requests.pop(uid, None)

    @property
    def pending_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- engine-side rounds --------------------------------------------------

    def _finish(self, slot: int, reason: str) -> Request:
        req = self.slots[slot]
        self.slots[slot] = None
        req.finish_reason = reason
        req.finished_at = self.clock()
        if req.seq_blocks is not None:
            self.allocator.free(req.seq_blocks)
            req.seq_blocks = None
        req.slot = None
        with self._lock:  # `finished` is also written by producer-side cancel()
            self.finished[req.uid] = req
        if flight.enabled:
            flight.record(req.uid, _terminal_flight_event(reason), t=req.finished_at, reason=reason)
        return req

    def _count_outcome(self, req: Request, key: str) -> None:
        """Bump the per-tenant and per-class breakdown for one fault outcome
        (shed/expired/preempted). Caller holds ``_lock``."""
        t = self.tenant_counts.setdefault(req.tenant_id, {})  # graftcheck: noqa[TH001] — every call site holds _lock
        t[key] = t.get(key, 0) + 1
        c = self.class_counts.setdefault(req.slo_class, {})  # graftcheck: noqa[TH001] — every call site holds _lock
        c[key] = c.get(key, 0) + 1

    # -- fault-tolerance rounds (no-ops without a policy) --------------------

    def expire_and_shed_pending(self) -> List[Request]:
        """One admission-side policy pass: expire pending requests past their
        deadline or ``max_pending_age_s``, then shed the oldest pending
        requests while the queue is over its high watermark (down to the low
        watermark). Every outcome is accountable — terminated requests land
        in ``finished`` exactly like eos/length ends. Returns them."""
        policy = self.policy
        if policy is None:
            return []
        now = self.clock()
        out: List[Request] = []
        with self._lock:
            kept: List[Request] = []
            for req in self._pending:
                age = now - req.submitted_at
                expired = req.past_deadline(now) or (
                    policy.max_pending_age_s is not None
                    and age > policy.max_pending_age_s
                )
                if expired:
                    req.finish_reason = FINISH_DEADLINE
                    req.finished_at = now
                    self.finished[req.uid] = req
                    self.expired_count += 1
                    self._count_outcome(req, "expired")
                    if flight.enabled:
                        flight.record(req.uid, "expire", t=now, reason=FINISH_DEADLINE)
                    out.append(req)
                else:
                    kept.append(req)
            self._pending = kept
            trigger = policy.shed_trigger
            if trigger and len(self._pending) > trigger:
                # strictly class-ordered: the lowest SLO class sheds first,
                # oldest-first within a class (they have waited longest and
                # are closest to expiring anyway). With every request in one
                # class this degenerates to the tenant-blind oldest-first
                # order. Preserve submit order among the survivors.
                by_age = sorted(
                    self._pending, key=lambda r: (r.slo_class, r.submitted_at)
                )
                to_shed = set(
                    id(r) for r in by_age[: len(self._pending) - policy.shed_target]
                )
                kept = []
                for req in self._pending:
                    if id(req) in to_shed:
                        req.finish_reason = FINISH_SHED
                        req.finished_at = now
                        self.finished[req.uid] = req
                        self.shed_count += 1
                        self._count_outcome(req, "shed")
                        if flight.enabled:
                            flight.record(req.uid, "shed", t=now, reason=FINISH_SHED)
                        out.append(req)
                    else:
                        kept.append(req)
                self._pending = kept
        return out

    def shed_all_pending(self) -> List[Request]:
        """Drain mode: terminate every pending request with the accountable
        ``shed`` outcome (they were accepted; silently dropping them would
        strand their clients). Live slots are untouched — drain lets them
        finish."""
        now = self.clock()
        with self._lock:
            pending, self._pending = self._pending, []
            for req in pending:
                req.finish_reason = FINISH_SHED
                req.finished_at = now
                self.finished[req.uid] = req
                self.shed_count += 1
                self._count_outcome(req, "shed")
                if flight.enabled:
                    flight.record(req.uid, "shed", t=now, reason=FINISH_SHED)
        return pending

    def expire_live(self) -> List[Tuple[int, Request]]:
        """Finish live sequences past their deadline (reason ``deadline``).
        Returns ``(freed slot, request)`` pairs — the engine zeroes the slots'
        device state and counts the requests as finished this round."""
        if self.policy is None:
            return []
        now = self.clock()
        freed = []
        for slot, req in enumerate(self.slots):
            if req is not None and req.past_deadline(now):
                freed.append((slot, self._finish(slot, FINISH_DEADLINE)))
        if freed:
            with self._lock:  # counters are read by gauge/bench threads
                self.expired_count += len(freed)
                for _, req in freed:
                    self._count_outcome(req, "expired")
        return freed

    def preempt(self, slot: int) -> Request:
        """Evict a live sequence under KV-block pressure: free its blocks,
        keep its host-side state (prompt + generated-so-far), and re-queue it
        at the *front* of the pending queue for re-prefill — it already waited
        once and holds partial output, so it outranks fresh arrivals. The
        request stays non-terminal; nothing is lost."""
        req = self.slots[slot]
        assert req is not None, f"preempting empty slot {slot}"
        self.slots[slot] = None
        if req.seq_blocks is not None:
            self.allocator.free(req.seq_blocks)
            req.seq_blocks = None
        req.slot = None
        req.preemptions += 1
        req.prefilled = 0  # blocks are gone; a re-admission re-prefills fully
        with self._lock:
            self.preempted_count += 1
            self._count_outcome(req, "preempted")
            self._pending.insert(0, req)
        if flight.enabled:
            flight.record(req.uid, "preempt", t=self.clock())
        return req

    def reap_cancelled(self) -> List[int]:
        """Free slots whose requests were cancelled mid-flight. Returns the
        freed slot indices (the engine zeroes their device state)."""
        freed = []
        with self._lock:
            cancelled, self._cancelled = self._cancelled, set()
        for slot, req in enumerate(self.slots):
            if req is not None and req.uid in cancelled:
                self._finish(slot, FINISH_CANCELLED)
                freed.append(slot)
        return freed

    def admissions(self) -> List[Tuple[int, Request]]:
        """Fill free slots from the pending queue, shortest prompts first
        (so each admission wave prefills in tight length buckets). Returns
        ``(slot, request)`` placements; the engine runs the prefills and
        block-table updates. Requests that don't fit block capacity stay
        pending."""
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free:
            return []
        # snapshot the pending queue under the lock, then place outside it:
        # allocation and slot assignment are engine-thread state and must not
        # sit in the producer-facing critical section
        with self._lock:
            pending, self._pending = self._pending, []
        # sort on the actual prefill length (prompt + replayed generation for
        # a preempted request) so waves bucket tightly; stable sort keeps a
        # re-queued preemption ahead of fresh arrivals of the same length.
        # Repeatedly passed-over requests get an age bonus that shrinks their
        # effective length, so a long prompt cannot be starved forever by a
        # sustained stream of short ones (admit_waits only accrues on rounds
        # with free slots — full occupancy is not starvation)
        reg = self.tenants
        if reg is None:
            pending.sort(
                key=lambda r: len(r.prefill_ids)
                - max(0, r.admit_waits - self.age_priority_after)
                * self.age_priority_bonus
            )
        else:
            # SLO-class priority admission: higher classes place first; the
            # within-class order is the tenant-blind key minus a prefix-cache
            # affinity discount (cached leading blocks cost nothing to
            # prefill, and admitting shared-prefix requests together keeps
            # their hit rate before the LRU churns the blocks out). Aging
            # still forbids absolute starvation: after enough passed-over
            # rounds the *effective class* itself rises, so a low-class
            # request eventually outranks any sustained high-class stream.
            bs = self.allocator.block_size

            def _key(r: Request):
                bonus_rounds = max(0, r.admit_waits - self.age_priority_after)
                if not reg.aging_enabled(r.slo_class):
                    bonus_rounds = 0
                eff_class = r.slo_class + bonus_rounds // reg.aging_class_boost_rounds
                prefill = r.prefill_ids
                eff_len = (
                    len(prefill)
                    - self.allocator.cached_prefix_blocks(prefill) * bs
                    - bonus_rounds * self.age_priority_bonus
                )
                return (-eff_class, eff_len)

            pending.sort(key=_key)
        optimistic = self.policy is not None and self.policy.preemption
        placements: List[Tuple[int, Request]] = []
        kept: List[Request] = []
        for req in pending:
            if not free:
                kept.append(req)
                continue
            prefill = req.prefill_ids
            # optimistic mode reserves only the prefill plus the next decode
            # write; growth is paid per round via allocator.extend, with the
            # engine's preemption path absorbing pressure. Default mode keeps
            # the worst-case reservation (mid-flight pressure impossible)
            reserve = (
                len(prefill) + 1 if optimistic
                else len(req.prompt) + req.max_new_tokens
            )
            if reg is not None:
                quota = reg.quota(req.tenant_id)
                if quota and (
                    self.allocator.owner_usage(req.tenant_id)
                    + self.allocator.blocks_needed(reserve)
                    > quota
                ):
                    # placing this request would push its tenant over quota;
                    # it waits for the tenant's own live sequences to finish
                    # (slots stay available to other tenants)
                    kept.append(req)
                    continue
            seq = self.allocator.allocate(
                prefill, reserve, owner=req.tenant_id if reg is not None else None
            )
            if seq is None:
                kept.append(req)  # capacity-blocked; retry next round
                continue
            req.seq_blocks = seq
            req.prefilled = 0
            req.admit_waits = 0
            slot = free.pop(0)
            req.slot = slot
            self.slots[slot] = req
            placements.append((slot, req))
        if kept:
            for req in kept:
                req.admit_waits += 1
            with self._lock:  # ahead of anything submitted while we placed
                self._pending = kept + self._pending
        if placements and flight.enabled:
            t_admit = self.clock()
            for _, req in placements:
                flight.record(req.uid, "admit", t=t_admit)
        return placements

    def on_token(self, slot: int, token: int) -> Optional[Request]:
        """Record one decoded token for a live slot; returns the request when
        this token finished it (the token IS kept — eos/stop trimming is the
        consumer's contract, matching ``ops/generation.generate``)."""
        req = self.slots[slot]
        if req is None:
            return None
        req.generated.append(int(token))
        if req.eos_token_id is not None and token == req.eos_token_id:
            return self._finish(slot, FINISH_EOS)
        for stop in req.stop_sequences:
            if len(req.generated) >= len(stop) and tuple(req.generated[-len(stop):]) == stop:
                return self._finish(slot, FINISH_STOP)
        if len(req.generated) >= req.max_new_tokens:
            return self._finish(slot, FINISH_LENGTH)
        return None

    def on_tokens(
        self, slot: int, tokens: Sequence[int]
    ) -> Tuple[Optional[Request], int]:
        """Record a speculative round's accepted tokens in order, stopping at
        the first one that finishes the request (tokens past a finish are
        never emitted — exactly what step-at-a-time decode would have done).
        Returns ``(finished request or None, tokens actually consumed)`` —
        the consumed count is what throughput accounting may claim."""
        consumed = 0
        for token in tokens:
            done = self.on_token(slot, token)
            consumed += 1
            if done is not None:
                return done, consumed
        return None, consumed

    # -- supervised replay ---------------------------------------------------

    def export_state(self) -> Dict[str, object]:
        """Snapshot every piece of host-side request state a successor engine
        needs (supervisor restart): live requests fold back into the replay
        queue — their device blocks died with the old engine, but the prompt
        and generated-so-far live here, so re-prefill loses nothing. Called
        on the engine-driving thread after the step loop has raised, so the
        slot array is quiescent."""
        live = [r for r in self.slots if r is not None]
        for req in live:
            # blocks belong to the dead allocator; drop the handles so the
            # successor re-allocates from its own pool (and any chunked
            # prefill progress died with the device state)
            req.seq_blocks = None
            req.slot = None
            req.prefilled = 0
        with self._lock:
            pending = list(self._pending)
            state = {
                "replay": live + pending,
                "finished": dict(self.finished),
                "requests": dict(self.requests),
                "cancelled": set(self._cancelled),
                "uid_hwm": self.uid_hwm,
                "counters": (
                    self.shed_count, self.expired_count, self.preempted_count,
                    self.steps, self.occupied_slot_steps,
                ),
                "tenant_counts": {t: dict(c) for t, c in self.tenant_counts.items()},
                "class_counts": {k: dict(c) for k, c in self.class_counts.items()},
            }
        # flight context rides the replay seam: a successor (supervised
        # restart or cross-replica adoption) continues the SAME flight
        state["flights"] = flight.export_flights([r.uid for r in state["replay"]]) if flight.enabled else {}
        return state

    def adopt_state(self, state: Dict[str, object]) -> None:
        """Install a predecessor's exported state (see :meth:`export_state`):
        replayed requests enter the pending queue ahead of anything already
        submitted to this engine, uid continuity is preserved (a client-held
        uid must never be reissued), and outcome counters stay cumulative
        across engine generations."""
        with self._lock:
            # resume from the max of both watermarks: a successor that was
            # already seated at a fleet uid base (seat_uid_base) — or that
            # adopted another replica's state before this one — must never
            # rewind below its own high-water mark
            start = max(self.uid_hwm, state["uid_hwm"])
            self._uid = itertools.count(start)
            self.uid_hwm = start
            self.requests.update(state["requests"])
            self.finished.update(state["finished"])
            self._cancelled |= state["cancelled"]
            self._pending = list(state["replay"]) + self._pending
            shed, expired, preempted, steps, occupied = state["counters"]
            self.shed_count += shed
            self.expired_count += expired
            self.preempted_count += preempted
            self.steps += steps
            self.occupied_slot_steps += occupied
            # tenant attribution survives restarts (absent in pre-tenancy
            # snapshots — .get keeps old exports adoptable)
            for tid, counts in state.get("tenant_counts", {}).items():
                t = self.tenant_counts.setdefault(tid, {})
                for key, n in counts.items():
                    t[key] = t.get(key, 0) + n
            for cls, counts in state.get("class_counts", {}).items():
                c = self.class_counts.setdefault(cls, {})
                for key, n in counts.items():
                    c[key] = c.get(key, 0) + n
        if flight.enabled:
            # continue the predecessor's flights here; every replayed uid
            # gets an `adopt` event on this scheduler's clock
            snaps = state.get("flights", {})
            t_adopt = self.clock()
            flight.adopt_flights(snaps, t=t_adopt)
            for req in state["replay"]:
                if req.uid not in snaps:
                    flight.record(req.uid, "adopt", t=t_adopt)

    def seat_uid_base(self, base: int) -> None:
        """Seat the uid counter at (at least) ``base``. The fleet router
        gives each replica a disjoint uid block so requests routed to
        different engines can never collide — and a request re-routed onto a
        survivor after a replica death keeps its original uid (adopt_state's
        max() respects an already-seated base). Idempotent: seating below
        the current watermark is a no-op."""
        with self._lock:
            start = max(self.uid_hwm, int(base))
            self._uid = itertools.count(start)
            self.uid_hwm = start

    def note_step(self) -> None:
        # locked: the occupancy gauge (bench/obs threads) reads these counters
        # while the engine loop advances them
        live = self.live_slots
        with self._lock:
            self.steps += 1
            self.occupied_slot_steps += live

    @property
    def mean_slot_occupancy(self) -> float:
        with self._lock:
            steps, occupied = self.steps, self.occupied_slot_steps
        return occupied / max(1, steps) / max(1, self.num_slots)

    def outcome_counts(self) -> Dict[str, int]:
        """Fault-tolerance outcome counters (locked snapshot for gauges)."""
        with self._lock:
            return {
                "shed": self.shed_count,
                "expired": self.expired_count,
                "preempted": self.preempted_count,
            }

    def tenant_outcome_counts(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant outcome breakdown (locked snapshot for gauges)."""
        with self._lock:
            return {t: dict(c) for t, c in self.tenant_counts.items()}

    def class_outcome_counts(self) -> Dict[int, Dict[str, int]]:
        """Per-SLO-class outcome breakdown (locked snapshot for gauges)."""
        with self._lock:
            return {k: dict(c) for k, c in self.class_counts.items()}
