"""Multi-tenant sustained-traffic scenario harness (counterpart of
``trlx_tpu/serving/scenario.py``).

The resilience and tenancy layers each have unit-level guarantees, but production robustness is
a *composition* property — N tenants with different prompt shapes, arrival
rates and SLO classes hammering one engine while every chaos site fires and
the supervisor restarts it. This module drives exactly that, deterministically
(seeded per-tenant traffic, virtual clock), and reduces the run to the
invariants that matter:

- **exactly-once accounting** — every submitted uid reaches exactly one
  terminal state (eos/stop/length/deadline/shed/cancelled), across any
  number of supervised restarts;
- **quota isolation** — no tenant's live KV-block usage ever exceeds its
  quota, at any round (``quota_violations`` must be 0);
- **SLO ordering** — higher classes see p99 latency no worse than lower
  classes (:meth:`ScenarioReport.p99_ordering_ok`);
- **census integrity** — the allocator's block + owner census balances after
  every restart and at the end.

Usage (``tests/test_torch_serving_tenants.py``, ``chip_smoke.py`` phase
``production_serving``)::

    registry = TenantRegistry()
    registry.register("free", slo_class=0, kv_block_quota=6)
    registry.register("pro", slo_class=1)
    report = run_scenario(
        engine_factory, registry,
        [TenantTraffic("free", num_requests=24, arrivals_per_round=2.0,
                       prompt_len=(4, 10), max_new=(4, 8), vocab=37),
         TenantTraffic("pro", num_requests=16, arrivals_per_round=1.0,
                       prompt_len=(6, 12), max_new=(4, 8), vocab=37,
                       shared_prefix=4)],
        chaos_spec="serving-prefill:1,serving-decode:1,serving-alloc:2,serving-wedge:1",
    )
    assert report.quota_violations == 0 and report.p99_ordering_ok()

``engine_factory`` must build a fresh :class:`ServingEngine` with the
registry installed (``tenants=registry``); the harness wraps it in a
:class:`ServingSupervisor` and re-seats its virtual clock on every engine
generation, so deadlines stay deterministic across restarts.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.serving.engine import ServingEngine
from trlx_tpu_torch.serving.policy import RequestTooLarge
from trlx_tpu_torch.serving.scheduler import FINISH_EOS, FINISH_LENGTH, FINISH_STOP, Request
from trlx_tpu_torch.serving.supervisor import ServingSupervisor
from trlx_tpu_torch.serving.tenancy import TenantRegistry, jain_fairness
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges, nearest_rank

logger = logging.get_logger(__name__)

#: finish reasons that count as a successful generation (latency sample)
SUCCESS_REASONS = (FINISH_EOS, FINISH_STOP, FINISH_LENGTH)


@dataclass
class TenantTraffic:
    """One tenant's deterministic traffic pattern.

    ``arrivals_per_round`` sets the arrival rate (request ``i`` arrives at
    round ``start_round + floor(i / arrivals_per_round)``; fractional rates
    spread arrivals out). ``shared_prefix`` > 0 prepends that many fixed
    (per-tenant) tokens to every prompt, exercising the prefix cache and the
    scheduler's tenant-affinity discount. All randomness is drawn from a
    generator seeded by (scenario seed, tenant index) — same seed, same
    traffic, byte for byte.
    """

    tenant_id: str
    num_requests: int
    arrivals_per_round: float
    prompt_len: Tuple[int, int]  # inclusive [lo, hi] of the random tail
    max_new: Tuple[int, int]  # inclusive [lo, hi]
    vocab: int
    shared_prefix: int = 0
    start_round: int = 0


@dataclass
class ScenarioReport:
    """What one scenario run actually did, reduced to checkable facts."""

    submitted: int = 0
    rejected: int = 0  # RequestTooLarge at submit (never entered the queue)
    rounds: int = 0
    restarts: int = 0
    # uid -> finish_reason, exactly one entry per accepted request
    terminal: Dict[int, str] = field(default_factory=dict)
    # uid -> Request for post-hoc inspection (latency, tenant, tokens)
    requests: Dict[int, Request] = field(default_factory=dict)
    # rounds where some tenant's live block usage exceeded its quota (must
    # stay empty: the bar is zero violations, ever)
    quota_violations: int = 0
    latencies_by_class: Dict[int, List[float]] = field(default_factory=dict)
    p99_by_class: Dict[int, float] = field(default_factory=dict)
    delivered_by_tenant: Dict[str, int] = field(default_factory=dict)
    shed_by_class: Dict[int, int] = field(default_factory=dict)
    fairness_jain: float = 1.0
    # serving/* gauge values at the end of the run, snapshotted before the
    # engine's prefix-aware clear
    gauges: Dict[str, float] = field(default_factory=dict)
    outcome_counts: Dict[str, int] = field(default_factory=dict)

    def p99_ordering_ok(self) -> bool:
        """Higher SLO classes must see p99 latency no worse than lower ones
        (weak ordering — equal is fine; classes with no successful finishes
        are skipped)."""
        classes = sorted(self.p99_by_class)
        for lo, hi in zip(classes, classes[1:]):
            if self.p99_by_class[hi] > self.p99_by_class[lo]:
                return False
        return True


def _nearest_rank_p99(xs: Sequence[float]) -> float:
    s = sorted(xs)
    return nearest_rank(s, 0.99) if s else 0.0


def _build_arrivals(
    traffic: Sequence[TenantTraffic], seed: int
) -> List[Tuple[int, str, List[int], int]]:
    """Materialize every (round, tenant, prompt, max_new) arrival up front —
    the whole run is decided before the first chaotic event, so a failure
    reproduces from the seed alone."""
    arrivals: List[Tuple[int, str, List[int], int]] = []
    for ti, tt in enumerate(traffic):
        rng = np.random.default_rng([seed, ti])
        prefix = (
            rng.integers(0, tt.vocab, size=tt.shared_prefix).tolist()
            if tt.shared_prefix else []
        )
        for i in range(tt.num_requests):
            rnd = tt.start_round + int(i / tt.arrivals_per_round)
            tail_len = int(rng.integers(tt.prompt_len[0], tt.prompt_len[1] + 1))
            prompt = prefix + rng.integers(0, tt.vocab, size=tail_len).tolist()
            max_new = int(rng.integers(tt.max_new[0], tt.max_new[1] + 1))
            arrivals.append((rnd, tt.tenant_id, prompt, max_new))
    # stable order: by round, then original construction order — producers
    # interleave deterministically
    arrivals.sort(key=lambda a: a[0])
    return arrivals


def _check_census(engine: ServingEngine, registry: TenantRegistry) -> None:
    """Allocator block + owner census must balance (raises on drift)."""
    engine.allocator.check_invariants()
    census = engine.allocator.owner_census()
    for tid, used in census.items():
        if tid is None:
            continue
        quota = registry.quota(tid)
        assert not quota or used <= quota, (
            f"tenant {tid!r} holds {used} blocks over quota {quota}"
        )


def run_scenario(
    engine_factory: Callable[[], ServingEngine],
    registry: TenantRegistry,
    traffic: Sequence[TenantTraffic],
    *,
    chaos_spec: Optional[str] = None,
    dt_s: float = 0.05,
    max_rounds: int = 800,
    seed: int = 0,
    max_restarts: int = 8,
    wedge_timeout_s: float = 0.25,
    backoff_base_s: float = 0.01,
    diagnostics_dir: str = "diagnostics",
) -> ScenarioReport:
    """Drive one deterministic multi-tenant chaos scenario to completion.

    Builds a :class:`ServingSupervisor` over ``engine_factory``, submits the
    seeded traffic round by round under a virtual clock (``dt_s`` per round),
    and steps the engine until every accepted request reaches a terminal
    state (draining at ``max_rounds`` if traffic outlives the cap). Verifies
    as it goes: exactly-once terminal accounting, per-round quota census,
    allocator invariants on every supervised restart. The returned
    :class:`ScenarioReport` carries the aggregate assertions the caller
    checks (p99 ordering, zero quota violations, fairness)."""
    report = ScenarioReport()
    t = [0.0]

    def clocked_factory() -> ServingEngine:
        eng = engine_factory()
        assert eng.tenants is registry, (
            "engine_factory must install the scenario's TenantRegistry"
        )
        # virtual clock on every generation: supervised restarts must keep
        # deadline arithmetic deterministic
        eng.scheduler.clock = lambda: t[0]
        return eng

    sup = ServingSupervisor(
        clocked_factory,
        max_restarts=max_restarts,
        backoff_base_s=backoff_base_s,
        wedge_timeout_s=wedge_timeout_s,
        diagnostics_dir=diagnostics_dir,
    )
    arrivals = _build_arrivals(traffic, seed)
    accepted: set = set()
    last_engine = sup.engine
    if chaos_spec:
        chaos.configure(chaos_spec)
    try:
        i = 0
        rnd = 0
        while True:
            # submit everything due this round (producers would be threads in
            # production; the harness stays single-threaded for determinism)
            while i < len(arrivals) and arrivals[i][0] <= rnd:
                _, tid, prompt, max_new = arrivals[i]
                i += 1
                report.submitted += 1
                try:
                    uid = sup.submit(prompt, max_new, tenant_id=tid)
                    accepted.add(uid)
                except RequestTooLarge:
                    report.rejected += 1
            t[0] += dt_s
            sup.step()
            engine = sup.engine
            if engine is not last_engine:
                # supervised restart happened: the successor's census must
                # balance before it serves another round
                report.restarts += 1
                last_engine = engine
                _check_census(engine, registry)
            for uid, req in sup.scheduler.pop_finished().items():
                assert uid not in report.terminal, (
                    f"uid {uid} reached a second terminal state "
                    f"({report.terminal[uid]} then {req.finish_reason})"
                )
                report.terminal[uid] = req.finish_reason
                report.requests[uid] = req
            # per-round quota census: the bar is zero violations, ever
            for tid, used in engine.allocator.owner_census().items():
                if tid is None:
                    continue
                quota = registry.quota(tid)
                if quota and used > quota:
                    report.quota_violations += 1
                    logger.warning(
                        f"round {rnd}: tenant {tid!r} at {used} blocks "
                        f"exceeds quota {quota}"
                    )
            rnd += 1
            done = accepted <= set(report.terminal)
            if (i >= len(arrivals) and done) or rnd >= max_rounds:
                break
        if not (accepted <= set(report.terminal)):
            # traffic outlived the round cap: drain accounts for the rest
            # (shed pending, finish live) — exactly-once still holds
            for uid, req in sup.drain().items():
                if uid in accepted and uid not in report.terminal:
                    report.terminal[uid] = req.finish_reason
                    report.requests[uid] = req
    finally:
        if chaos_spec:
            chaos.configure(None)
    report.rounds = rnd
    missing = accepted - set(report.terminal)
    assert not missing, f"requests never reached a terminal state: {missing}"
    _check_census(sup.engine, registry)

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
    report.outcome_counts = sup.scheduler.outcome_counts()
    sup.export_gauges()
    report.gauges = dict(gauges.snapshot(prefix="serving/"))
    sup.close()
    sup.engine.close()  # prefix-aware gauge clear: serving/* retired
    return report
