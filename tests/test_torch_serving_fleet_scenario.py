"""Port parity for the fleet scenario harness: trlx_tpu_torch's
``run_fleet_scenario`` against trlx_tpu's, the three scenario cases of
tests/test_serving_fleet.py on the tiny f32 gpt2 of that file and the same
traffic: prefix affinity against the uniform-random baseline (and
``TRLX_FLEET_SEED_REGRESSION=blind_router`` failing that check in both
packages), the chaos soak (3 replicas, 4 tenants in 2 classes, a replica
kill, an in-replica crash, mis-routes, the autoscaler through an idle
tail) and a clean run. The reports' facts (p99 on the scenario's virtual
clock), every uid's tokens and the ``fleet/*`` gauges are equal. The
packages' classes and the cleanup come from
tests/test_torch_serving_fleet.py."""

import pytest

from tests.test_torch_serving_fleet import (  # noqa: F401  (weights and _cleanup are fixtures)
    _both,
    _cleanup,
    _report_facts,
    weights,
)
from trlx_tpu_torch.serving.scheduler import FINISH_LENGTH

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("regression", [None, "blind_router"])
def test_fleet_affinity_hit_rate_beats_random_as_jax(weights, tmp_path, monkeypatch, regression):
    """Shared-prefix traffic through the scenario harness: affinity beats the
    uniform-random baseline in both packages, and under ``blind_router`` the
    check fails in both."""
    if regression:
        monkeypatch.setenv("TRLX_FLEET_SEED_REGRESSION", regression)

    def scenario(pkg):
        reg = pkg.Registry()
        reg.register("alpha", slo_class=0)
        reg.register("beta", slo_class=0)
        traffic = [pkg.Traffic(t, num_requests=8, arrivals_per_round=0.5, prompt_len=(2, 4), max_new=(3, 5),
                               vocab=37, shared_prefix=8) for t in ("alpha", "beta")]
        report = pkg.scenario(lambda seat: pkg.engine(seed=seat, prefix_caching=True, tenants=reg, track=False),
                              reg, traffic, num_replicas=3, autoscale=False, dt_s=0.05, max_rounds=300)
        return _report_facts(report), {u: list(r.generated) for u, r in report.requests.items()}

    want, got = _both(weights, tmp_path, scenario)
    assert got == want
    facts = got[0]
    assert facts["replica_kills"] == 0 and facts["restarts"] == 0
    if regression is None:
        assert facts["affinity_hit_rate"] > facts["random_hit_rate"]
        assert facts["affinity_hit_rate"] > 0.5
    else:
        assert not facts["affinity_hit_rate"] > facts["random_hit_rate"], facts


def _soak(pkg, chaos_spec, **kw):
    reg = pkg.Registry(class_ttl_s={0: 8.0, 1: 16.0})
    reg.register("free1", slo_class=0, kv_block_quota=6)
    reg.register("free2", slo_class=0, kv_block_quota=6)
    reg.register("pro1", slo_class=1)
    reg.register("pro2", slo_class=1)
    policy = pkg.Policy(max_pending=16, high_watermark=1.0, low_watermark=0.5, preemption=True)
    T = pkg.Traffic
    traffic = [
        T("free1", num_requests=12, arrivals_per_round=2.0, prompt_len=(4, 10), max_new=(4, 8), vocab=37),
        T("free2", num_requests=12, arrivals_per_round=2.0, prompt_len=(4, 10), max_new=(4, 8), vocab=37),
        T("pro1", num_requests=6, arrivals_per_round=0.5, prompt_len=(4, 10), max_new=(4, 8), vocab=37,
          shared_prefix=4),
        T("pro2", num_requests=6, arrivals_per_round=0.5, prompt_len=(6, 12), max_new=(4, 8), vocab=37,
          shared_prefix=4),
    ]

    def factory(seat):
        return pkg.engine(num_slots=3, num_blocks=20, seed=seat, policy=policy, prefix_caching=True, tenants=reg,
                          track=False)

    report = pkg.scenario(factory, reg, traffic, num_replicas=3, chaos_spec=chaos_spec, dt_s=0.05,
                          max_rounds=400, seed=0, wedge_timeout_s=0.25, **kw)
    return (report, pkg.gauges.snapshot(prefix="serving/"), pkg.gauges.snapshot(prefix="fleet/"))


def test_fleet_chaos_soak_exactly_once_and_slo_as_jax(weights, tmp_path):
    """The acceptance soak in both packages: 3 replicas, 4 tenants in 2 SLO
    classes, a replica kill, an in-replica crash restart and mis-routes, the
    autoscaler live through an idle tail. The reports' facts, tokens and
    fleet gauges are equal; the port's report passes the JAX file's checks."""

    def scenario(pkg):
        report, after_serving, after_fleet = _soak(
            pkg, "fleet-replica-kill:1,fleet-route:2,serving-decode:1", autoscale=True, min_replicas=1,
            max_replicas=4, scale_down_occupancy=0.3, breach_rounds=3, cooldown_rounds=4, idle_tail_rounds=30)
        return report, after_serving, after_fleet

    (want, _, _), (got, after_serving, after_fleet) = _both(weights, tmp_path, scenario)
    assert _report_facts(got) == _report_facts(want)
    assert {u: list(r.generated) for u, r in got.requests.items()} == {
        u: list(r.generated) for u, r in want.requests.items()}
    assert {k: v for k, v in got.gauges.items() if k.startswith("fleet/")} == {
        k: v for k, v in want.gauges.items() if k.startswith("fleet/")}
    assert got.submitted == 36 and got.rejected == 0 and len(got.terminal) == 36
    assert got.replica_kills >= 1 and got.reroutes >= 1 and got.restarts >= 1
    assert "drain" in [a for _, a in got.autoscale_events]
    assert got.quota_violations == 0 and got.p99_ordering_ok()
    assert got.affinity_hit_rate > got.random_hit_rate
    assert got.replicas_peak >= 3 and got.replicas_final < 3 and 0.0 < got.fairness_jain <= 1.0
    assert got.gauges["fleet/replica_kills"] == float(got.replica_kills)
    assert got.gauges["fleet/finished"] == 36.0
    assert after_serving == {} == after_fleet


def test_fleet_scenario_without_chaos_is_clean_as_jax(weights, tmp_path):
    def scenario(pkg):
        reg = pkg.Registry()
        reg.register("a", slo_class=0)
        reg.register("b", slo_class=1)
        traffic = [pkg.Traffic(t, num_requests=5, arrivals_per_round=1.0, prompt_len=(4, 8), max_new=(4, 6),
                               vocab=37) for t in ("a", "b")]
        report = pkg.scenario(lambda seat: pkg.engine(seed=seat, tenants=reg, track=False), reg, traffic,
                              num_replicas=2, autoscale=False, dt_s=0.05, max_rounds=200)
        return _report_facts(report)

    want, got = _both(weights, tmp_path, scenario)
    assert got == want
    assert got["restarts"] == 0 and got["replica_kills"] == 0 and got["quota_violations"] == 0
    assert sorted(got["terminal"].values()) == [FINISH_LENGTH] * 10
    assert got["replicas_final"] == 2 and got["autoscale_events"] == [] and got["fairness_jain"] > 0.9
