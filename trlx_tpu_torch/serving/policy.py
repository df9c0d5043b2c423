"""Serving fault-tolerance policy and the typed request/engine outcomes.

The bare engine had exactly one failure mode: hold on and hope. A request whose
worst-case reservation exceeded the whole pool pended forever, a stalled
engine spun its clients forever, and nothing bounded how long an accepted
request could wait. This module is the vocabulary of the fault-tolerance
layer (docs/serving.md, "Fault tolerance"):

- :class:`ServingResiliencePolicy` — the engine-facing knobs for per-request
  deadlines/TTLs, bounded pending queue with shed watermarks, and
  KV-pressure preemption (optimistic admission). ``None`` — the default —
  keeps the engine byte-identical to the bare engine; the trainer builds a
  policy from ``train.serving_resilience``.
- Typed errors so every terminal outcome is *accountable*: a shed or expired
  request surfaces as an exception at the stream/submit seam, never as a
  silent drop or an infinite spin.

The policy object is plain data; all enforcement lives in the scheduler
(expiry/shedding), the engine (capacity extension + preemption), and the
:class:`~trlx_tpu_torch.serving.supervisor.ServingSupervisor` (restart + replay).
"""

from dataclasses import dataclass
from typing import Optional


class _TenantTagged:
    """Mixin carrying tenant attribution on typed serving errors: callers in
    a multi-tenant deployment attribute failures (which tenant's request was
    shed/expired, at what SLO class) straight off the exception instead of
    re-looking the request up. Both fields are None on the default-tenant
    path — constructing with a bare message stays source-compatible.

    ``replica_id`` identifies which fleet replica raised (None outside a
    fleet): fleet-level retry logic distinguishes engine-fatal outcomes
    (re-route the request away from that replica) from request-fatal ones
    (the request itself is shed/expired — retrying elsewhere won't help)."""

    def __init__(
        self,
        *args,
        tenant_id: Optional[str] = None,
        slo_class: Optional[int] = None,
        replica_id: Optional[int] = None,
        uid: Optional[int] = None,
    ):
        super().__init__(*args)
        self.tenant_id = tenant_id
        self.slo_class = slo_class
        self.replica_id = replica_id
        self.uid = uid


class RequestTooLarge(_TenantTagged, ValueError):
    """The request's worst-case block need exceeds the whole pool — or its
    tenant's KV-block quota: it could never be admitted and would previously
    pend (and spin its client) forever. Raised at ``submit`` — reject early,
    loudly."""


class RequestShedError(_TenantTagged, RuntimeError):
    """The request was shed under admission pressure (bounded pending queue
    over its high watermark, or engine drain). Accountable: the request holds
    ``finish_reason == "shed"`` and whatever tokens were decoded before the
    shed; raised by ``GenerationClient.stream`` after yielding them."""


class RequestExpiredError(_TenantTagged, RuntimeError):
    """The request passed its wall-clock deadline (TTL) or its
    max-pending-age while queued. ``finish_reason == "deadline"``."""


class EngineDrainingError(_TenantTagged, RuntimeError):
    """``submit`` was called on a draining/drained engine — graceful shutdown
    rejects new work instead of accepting requests it will never run."""


class EngineStoppedError(_TenantTagged, RuntimeError):
    """The engine stopped making progress for a live stream: it drained with
    the request unaccounted, or a supervised restart budget was exhausted.
    Raised by ``GenerationClient.stream`` instead of spinning forever."""


class EngineWedgedError(_TenantTagged, RuntimeError):
    """The engine's decode loop wedged (no decode-round heartbeat) and was
    aborted — by the watchdog escalation or the supervisor's per-round wedge
    timer. The supervisor treats this like a crash: rebuild and replay."""


@dataclass
class ServingResiliencePolicy:
    """Request-level fault-tolerance knobs for the serving engine.

    :param request_ttl_s: default wall-clock deadline per request, measured
        from ``submit``. A request past its deadline — pending *or* live —
        finishes with reason ``"deadline"`` at the next round. ``None`` =
        no default TTL (per-request ``deadline_s`` still honored).
    :param max_pending_age_s: requests may wait at most this long in the
        pending queue before expiring to ``"deadline"`` (admission-side TTL,
        independent of the total-deadline clock). ``None`` = unbounded wait.
    :param max_pending: bound on the pending queue. ``0`` = unbounded (no
        shedding). When pending exceeds ``high_watermark * max_pending``,
        the *oldest* pending requests are shed (reason ``"shed"``) until the
        queue is back at ``low_watermark * max_pending`` — oldest first
        because they have waited longest and are most likely to expire
        anyway; shedding them frees the queue for fresh traffic.
    :param high_watermark: shed trigger, as a fraction of ``max_pending``.
    :param low_watermark: shed target, as a fraction of ``max_pending``.
    :param preemption: admit optimistically (blocks allocated as sequences
        grow, not worst-case up front) and preempt the
        longest-remaining live sequence when the pool cannot serve a live
        sequence's next block. A preempted sequence is re-queued and later
        re-prefilled from host-side state (prompt + generated-so-far); no
        tokens are lost. ``False`` keeps the worst-case reservation, under
        which mid-flight pressure is impossible by construction.
    """

    request_ttl_s: Optional[float] = None
    max_pending_age_s: Optional[float] = None
    max_pending: int = 0
    high_watermark: float = 1.0
    low_watermark: float = 0.5
    preemption: bool = True

    def __post_init__(self):
        if not (0.0 < self.low_watermark <= self.high_watermark <= 1.0):
            raise ValueError(
                f"watermarks must satisfy 0 < low <= high <= 1, got "
                f"low={self.low_watermark} high={self.high_watermark}"
            )
        if self.max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {self.max_pending}")

    @property
    def shed_trigger(self) -> int:
        """Pending depth that triggers a shed pass (0 = never)."""
        return int(self.high_watermark * self.max_pending) if self.max_pending else 0

    @property
    def shed_target(self) -> int:
        """Pending depth a shed pass reduces the queue to."""
        return int(self.low_watermark * self.max_pending)
