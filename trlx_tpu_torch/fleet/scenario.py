"""Fleet-level chaos scenario harness (counterpart of
``trlx_tpu/fleet/scenario.py``).

:func:`trlx_tpu_torch.serving.scenario.run_scenario` proves the single-engine
composition (tenancy × resilience × chaos); this module lifts the same
deterministic drive to a fleet: N replicas behind the
:class:`~trlx_tpu_torch.fleet.router.FleetRouter`, the gauge-driven
:class:`~trlx_tpu_torch.fleet.autoscaler.FleetAutoscaler` in the loop, and the
fleet chaos sites (``fleet-route`` mis-routing, ``fleet-replica-kill`` hard
deaths with cross-replica re-route) armed alongside the per-engine ones.
The invariants checked are the single-engine ones, fleet-wide:

- **exactly-once accounting** — every accepted uid reaches exactly one
  terminal state, across replica kills, cross-replica re-routes, supervised
  restarts and autoscale drains;
- **quota isolation** — per-round, per-replica: no tenant's live block usage
  exceeds its quota on ANY replica (quotas bound each engine's pool);
- **SLO ordering** — per-class p99 is aggregated across replicas through
  the :class:`~trlx_tpu_torch.fleet.ledger.FleetLedger`, and higher classes must
  still order below lower ones fleet-wide;
- **affinity beats random** — the router's warm-prefix hit rate must exceed
  what uniform-random replica choice would have scored on the same traffic
  (the seeded ``blind_router`` regression makes this gate fail, proving it
  bites).

The run finishes with an idle tail (``idle_tail_rounds``) so the
autoscaler's scale-down path triggers inside the scenario — the acceptance
soak requires at least one graceful drain mid-run, not just kills.
"""

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from trlx_tpu_torch.fleet.autoscaler import FleetAutoscaler
from trlx_tpu_torch.fleet.router import FleetRouter
from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.serving.engine import ServingEngine
from trlx_tpu_torch.serving.policy import RequestTooLarge
from trlx_tpu_torch.serving.scenario import (
    SUCCESS_REASONS,
    ScenarioReport,
    TenantTraffic,
    _build_arrivals,
    _nearest_rank_p99,
)
from trlx_tpu_torch.serving.tenancy import TenantRegistry, jain_fairness
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)


@dataclass
class FleetScenarioReport(ScenarioReport):
    """:class:`ScenarioReport` plus the fleet-level facts the soak asserts."""

    affinity_hit_rate: float = 0.0
    random_hit_rate: float = 0.0
    sticky_hit_rate: float = 0.0
    replica_kills: int = 0
    reroutes: int = 0
    autoscale_events: List[Tuple[int, str]] = field(default_factory=list)
    replicas_final: int = 0
    replicas_peak: int = 0


def _check_fleet_census(router: FleetRouter, registry: TenantRegistry) -> int:
    """Allocator invariants + per-tenant quota census on every live replica.
    Returns the number of quota violations found (the bar is zero)."""
    violations = 0
    for handle in router._live_handles():
        engine = handle.supervisor.engine
        engine.allocator.check_invariants()
        for tid, used in engine.allocator.owner_census().items():
            if tid is None:
                continue
            quota = registry.quota(tid)
            if quota and used > quota:
                violations += 1
                logger.warning(
                    f"replica seat {handle.seat}: tenant {tid!r} at {used} "
                    f"blocks exceeds quota {quota}"
                )
    return violations


def run_fleet_scenario(
    engine_factory: Callable[[int], ServingEngine],
    registry: TenantRegistry,
    traffic: Sequence[TenantTraffic],
    *,
    num_replicas: int = 3,
    chaos_spec: Optional[str] = None,
    dt_s: float = 0.05,
    max_rounds: int = 800,
    seed: int = 0,
    max_restarts: int = 8,
    wedge_timeout_s: float = 0.25,
    backoff_base_s: float = 0.01,
    diagnostics_dir: str = "diagnostics",
    prefix_weight: float = 1.0,
    tenant_weight: float = 0.25,
    load_weight: float = 2.0,
    autoscale: bool = True,
    min_replicas: int = 1,
    max_replicas: Optional[int] = None,
    scale_up_pending_per_slot: float = 1.0,
    scale_down_occupancy: float = 0.25,
    breach_rounds: int = 3,
    cooldown_rounds: int = 6,
    idle_tail_rounds: int = 24,
) -> FleetScenarioReport:
    """Drive one deterministic fleet chaos scenario to completion.

    ``engine_factory(seat)`` builds one replica's engine with the scenario's
    registry installed (``tenants=registry``); vary the sampling seed off
    ``seat`` for replica-independent streams. The harness re-seats every
    engine generation's scheduler clock on the shared virtual clock, so
    deadline arithmetic stays deterministic across replicas, restarts and
    re-routes."""
    report = FleetScenarioReport()
    t = [0.0]

    def clocked_factory(seat: int) -> ServingEngine:
        eng = engine_factory(seat)
        assert eng.tenants is registry, (
            "engine_factory must install the scenario's TenantRegistry"
        )
        eng.scheduler.clock = lambda: t[0]
        return eng

    router = FleetRouter(
        clocked_factory,
        num_replicas,
        prefix_weight=prefix_weight,
        tenant_weight=tenant_weight,
        load_weight=load_weight,
        max_restarts=max_restarts,
        backoff_base_s=backoff_base_s,
        wedge_timeout_s=wedge_timeout_s,
        diagnostics_dir=diagnostics_dir,
    )
    scaler = (
        FleetAutoscaler(
            router,
            min_replicas=min_replicas,
            max_replicas=(
                num_replicas + 1 if max_replicas is None else max_replicas
            ),
            scale_up_pending_per_slot=scale_up_pending_per_slot,
            scale_down_occupancy=scale_down_occupancy,
            breach_rounds=breach_rounds,
            cooldown_rounds=cooldown_rounds,
        )
        if autoscale else None
    )
    arrivals = _build_arrivals(traffic, seed)
    accepted: set = set()
    if chaos_spec:
        chaos.configure(chaos_spec)
    try:
        i = 0
        rnd = 0
        idle_tail = 0
        while True:
            while i < len(arrivals) and arrivals[i][0] <= rnd:
                _, tid, prompt, max_new = arrivals[i]
                i += 1
                report.submitted += 1
                try:
                    uid = router.submit(prompt, max_new, tenant_id=tid)
                    accepted.add(uid)
                except RequestTooLarge:
                    report.rejected += 1
            t[0] += dt_s
            router.step()
            router.export_gauges()
            if scaler is not None:
                scaler.observe()
            for uid, req in router.scheduler.pop_finished().items():
                assert uid not in report.terminal, (
                    f"uid {uid} reached a second terminal state "
                    f"({report.terminal[uid]} then {req.finish_reason})"
                )
                report.terminal[uid] = req.finish_reason
                report.requests[uid] = req
            report.quota_violations += _check_fleet_census(router, registry)
            report.replicas_peak = max(
                report.replicas_peak, router.num_replicas
            )
            rnd += 1
            done = i >= len(arrivals) and accepted <= set(report.terminal)
            if done:
                # idle tail: keep ticking the control loop so the autoscaler
                # can observe idleness and trigger its graceful drain while
                # the scenario is still watching invariants
                idle_tail += 1
                if idle_tail >= idle_tail_rounds:
                    break
            else:
                idle_tail = 0
            if rnd >= max_rounds:
                break
        if not (accepted <= set(report.terminal)):
            for uid, req in router.drain().items():
                if uid in accepted and uid not in report.terminal:
                    report.terminal[uid] = req.finish_reason
                    report.requests[uid] = req
    finally:
        if chaos_spec:
            chaos.configure(None)
    report.rounds = rnd
    missing = accepted - set(report.terminal)
    assert not missing, f"requests never reached a terminal state: {missing}"
    report.quota_violations += _check_fleet_census(router, registry)

    for uid in accepted:
        req = report.requests[uid]
        report.delivered_by_tenant[req.tenant_id] = (
            report.delivered_by_tenant.get(req.tenant_id, 0) + len(req.generated)
        )
        if report.terminal[uid] in SUCCESS_REASONS and req.latency_s is not None:
            report.latencies_by_class.setdefault(req.slo_class, []).append(
                req.latency_s
            )
        if report.terminal[uid] == "shed":
            report.shed_by_class[req.slo_class] = (
                report.shed_by_class.get(req.slo_class, 0) + 1
            )
    report.p99_by_class = {
        c: _nearest_rank_p99(xs) for c, xs in report.latencies_by_class.items()
    }
    report.fairness_jain = jain_fairness(list(report.delivered_by_tenant.values()))
    report.outcome_counts = router.scheduler.outcome_counts()
    router.export_gauges()
    s = router.summary()
    report.affinity_hit_rate = s["fleet_affinity_hit_rate"]
    report.random_hit_rate = s["fleet_random_hit_rate"]
    report.sticky_hit_rate = s["fleet_sticky_hit_rate"]
    report.replica_kills = int(s["fleet_replica_kills"])
    report.reroutes = int(s["fleet_reroutes"])
    report.restarts = int(gauges.get("fleet/restarts"))
    report.replicas_final = router.num_replicas
    if scaler is not None:
        report.autoscale_events = list(scaler.events)
    # final gauge snapshot BEFORE the prefix-aware clears retire the
    # namespaces (fleet/* and every serving/replica/<seat>/*)
    report.gauges = dict(gauges.snapshot(prefix="fleet/"))
    report.gauges.update(gauges.snapshot(prefix="serving/"))
    router.close()
    return report
