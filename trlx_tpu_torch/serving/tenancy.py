"""Multi-tenant serving: tenant identity, SLO classes, quotas, fair shares.

The fault-tolerance layer made every request outcome accountable, but
it is tenant-blind: one global queue, oldest-first shedding, longest-remaining
preemption. Under sustained traffic that means one abusive workload (a flood
of cheap requests, or a few block-hungry ones) starves everyone else's SLOs —
exactly the failure mode a production serving stack must not have. This
module is the *vocabulary* of the tenancy layer (docs/serving.md
"Multi-tenancy and SLO classes"):

- :class:`TenantSpec` — one tenant's identity, SLO class, KV-block quota and
  TTL override. Plain data.
- :class:`TenantRegistry` — thread-safe tenant lookup with auto-registration
  (unknown tenants get the defaults), per-class default TTLs, and the aging
  policy that keeps class priority from becoming absolute starvation.
- :func:`select_victim` — fair-share preemption: over-share tenants are
  preempted before anyone else, pure function so the ordering guarantee is
  property-testable without building an engine.
- :func:`jain_fairness` — Jain's index over per-tenant throughput, the
  scenario harness's fairness scalar.

Enforcement lives where the existing policy passes live: the scheduler
(class-ordered shedding, class-priority admission with aging, quota-gated
placement), the engine (quota-bounded KV growth, fair-share victim
selection), and the allocator (owner-tagged block census). With no registry
installed every one of those paths is byte-identical to the tenant-blind
engine — the default-tenant contract.

SLO classes are plain ints: **higher is more important** (admitted first,
shed last). Quotas are hard caps on concurrently-held KV blocks; a block
shared through the prefix cache counts against *every* holder's quota (the
conservative census — sharing never lets a tenant exceed its cap by racing
the refcount).
"""

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

#: tenant id every untagged request runs under (the byte-identical path)
DEFAULT_TENANT = "default"


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's serving contract.

    :param tenant_id: opaque identity; requests carry it end to end.
    :param slo_class: integer priority class, higher = more important
        (admitted first, shed last). Classes are shared across tenants.
    :param kv_block_quota: hard cap on KV blocks this tenant's live
        sequences may hold at once; 0 = unlimited. A request whose
        worst-case need exceeds the quota is rejected at submit
        (:class:`~trlx_tpu_torch.serving.policy.RequestTooLarge`).
    :param request_ttl_s: per-tenant default deadline, overriding the
        class TTL and the policy TTL; None = inherit.
    """

    tenant_id: str
    slo_class: int = 0
    kv_block_quota: int = 0
    request_ttl_s: Optional[float] = None


class TenantRegistry:
    """Thread-safe tenant directory + the SLO-class aging policy.

    ``resolve`` auto-registers unknown tenants with the defaults so traffic
    generators and clients never have to pre-declare; ``register`` pins a
    tenant to an explicit class/quota/TTL. Resolution runs on producer
    threads (inside ``submit``) while the engine thread reads class bounds —
    everything mutable sits under one lock.

    Aging: class priority must not be absolute starvation. After
    ``age_priority_after`` passed-over admission rounds (the scheduler's
    existing knob) a pending request's *effective class* rises by one per
    ``aging_class_boost_rounds`` further rounds, so any request eventually
    outranks a sustained stream of higher-class arrivals. The seeded CI
    regression ``TRLX_TENANT_SEED_REGRESSION=starve_low_class`` disables
    aging for the lowest registered class in memory — the fairness suite
    must fail under it, proving the starvation gate bites.
    """

    def __init__(
        self,
        default_slo_class: int = 0,
        default_kv_block_quota: int = 0,
        aging_class_boost_rounds: int = 8,
        class_ttl_s: Optional[Mapping[int, float]] = None,
    ):
        if aging_class_boost_rounds < 1:
            raise ValueError(
                f"aging_class_boost_rounds must be >= 1, got {aging_class_boost_rounds}"
            )
        self.default_slo_class = int(default_slo_class)
        self.default_kv_block_quota = int(default_kv_block_quota)
        self.aging_class_boost_rounds = int(aging_class_boost_rounds)
        self.class_ttl_s: Dict[int, float] = {
            int(c): float(t) for c, t in (class_ttl_s or {}).items()
        }
        seed_reg = os.environ.get("TRLX_TENANT_SEED_REGRESSION", "")
        if seed_reg not in ("", "starve_low_class"):
            raise ValueError(
                f"TRLX_TENANT_SEED_REGRESSION={seed_reg!r}: only "
                f"'starve_low_class' is defined"
            )
        self._seed_regression = seed_reg
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantSpec] = {}
        self.resolve(DEFAULT_TENANT)

    def register(
        self,
        tenant_id: str,
        slo_class: Optional[int] = None,
        kv_block_quota: Optional[int] = None,
        request_ttl_s: Optional[float] = None,
    ) -> TenantSpec:
        """Pin a tenant's contract (re-registering replaces it)."""
        spec = TenantSpec(
            tenant_id=str(tenant_id),
            slo_class=self.default_slo_class if slo_class is None else int(slo_class),
            kv_block_quota=(
                self.default_kv_block_quota
                if kv_block_quota is None else int(kv_block_quota)
            ),
            request_ttl_s=None if request_ttl_s is None else float(request_ttl_s),
        )
        if spec.kv_block_quota < 0:
            raise ValueError(f"kv_block_quota must be >= 0, got {spec.kv_block_quota}")
        with self._lock:
            self._tenants[spec.tenant_id] = spec
        return spec

    def resolve(self, tenant_id: Optional[str]) -> TenantSpec:
        """Look up a tenant, auto-registering unknown ids with the defaults
        (``None`` resolves to the default tenant)."""
        tid = DEFAULT_TENANT if tenant_id is None else str(tenant_id)
        with self._lock:
            spec = self._tenants.get(tid)
            if spec is None:
                spec = TenantSpec(
                    tenant_id=tid,
                    slo_class=self.default_slo_class,
                    kv_block_quota=self.default_kv_block_quota,
                )
                self._tenants[tid] = spec
        return spec

    def quota(self, tenant_id: str) -> int:
        return self.resolve(tenant_id).kv_block_quota

    def ttl_for(self, spec: TenantSpec) -> Optional[float]:
        """Deadline default for a tenant: its own TTL, else its class TTL,
        else None (the scheduler then falls back to the policy TTL) —
        explicit per-request ``deadline_s`` always wins before this."""
        if spec.request_ttl_s is not None:
            return spec.request_ttl_s
        return self.class_ttl_s.get(spec.slo_class)

    @property
    def min_class(self) -> int:
        """Lowest SLO class across registered tenants (the first to shed)."""
        with self._lock:
            return min((s.slo_class for s in self._tenants.values()), default=0)

    def aging_enabled(self, slo_class: int) -> bool:
        """Whether passed-over requests of this class accrue the
        anti-starvation bonus. Always true except under the seeded
        ``starve_low_class`` regression, which switches it off for the lowest
        class so CI can prove the fairness suite catches real starvation."""
        if self._seed_regression == "starve_low_class":
            return slo_class != self.min_class
        return True

    def tenant_ids(self) -> List[str]:
        with self._lock:
            return list(self._tenants)


def select_victim(
    candidates: Sequence[Tuple[int, object]],
    usage: Mapping[str, int],
    shares: Mapping[str, int],
) -> Optional[int]:
    """Fair-share preemption victim over ``(slot, request)`` candidates.

    Tenants holding more KV blocks than their share (their hard quota, or
    the pool's fair split when unquota'd — the caller computes ``shares``)
    are preempted first; only when no candidate belongs to an over-share
    tenant does selection fall back to the tenant-blind longest-remaining
    rule. Within either pool the victim is the request with the most decode
    budget left (it holds blocks longest and re-prefills the fewest finished
    tokens per block freed), ties broken toward the lowest slot — the same
    deterministic order the tenant-blind engine used.

    Pure function: the ordering guarantee ("never an under-share tenant
    while an over-share victim exists") is property-tested directly.
    """
    if not candidates:
        return None
    over = [
        (slot, req)
        for slot, req in candidates
        if usage.get(req.tenant_id, 0) > shares.get(req.tenant_id, 1 << 60)
    ]
    pool = over if over else list(candidates)
    best, best_remaining = None, -1
    for slot, req in pool:
        if req.remaining_tokens > best_remaining:
            best, best_remaining = slot, req.remaining_tokens
    return best


def jain_fairness(values: Sequence[float]) -> float:
    """Jain's fairness index over per-tenant throughput: 1.0 = perfectly
    even, 1/n = one tenant took everything. Empty/zero input reads 1.0 (an
    idle system is trivially fair)."""
    xs = [float(v) for v in values]
    if not xs:
        return 1.0
    s = sum(xs)
    ss = sum(x * x for x in xs)
    if ss == 0.0:
        return 1.0
    return (s * s) / (len(xs) * ss)
