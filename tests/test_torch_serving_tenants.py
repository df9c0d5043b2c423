"""Port parity for multi-tenant serving (the engine-side cases of
tests/test_serving_tenants.py): on the tiny f32 config of that file, the
port's ``ServingEngine`` with a ``TenantRegistry`` against trlx_tpu's on the
same weights and traffic — the quota gate at submit, quota preemption kept
inside its tenant, typed errors from ``stream`` / ``generate_batch`` tagged
with the tenant, the default path equal to the tenant-blind engine, the
``serving/tenant/*`` and ``serving/class/*`` gauges (exported, cleared on
close), export/adopt of the tenant counters, and ``run_scenario`` with and
without all four serving chaos sites, whose reports' facts (terminal
reasons, shed by class, p99 by class on the virtual clock, tokens delivered
by tenant, Jain fairness, outcome counts, restarts) equal trlx_tpu's."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu.models.transformer import TransformerLM as JaxLM
from trlx_tpu.resilience.chaos import chaos as jax_chaos
from trlx_tpu.serving import GenerationClient as JaxClient
from trlx_tpu.serving import RequestExpiredError as JaxExpired
from trlx_tpu.serving import RequestShedError as JaxShed
from trlx_tpu.serving import RequestTooLarge as JaxTooLarge
from trlx_tpu.serving import ServingEngine as JaxEngine
from trlx_tpu.serving import ServingResiliencePolicy as JaxPolicy
from trlx_tpu.serving import TenantRegistry as JaxRegistry
from trlx_tpu.serving import TenantTraffic as JaxTraffic
from trlx_tpu.serving import run_scenario as jax_run_scenario
from trlx_tpu.utils.metrics import gauges as jax_gauges
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.serving import (
    GenerationClient,
    InflightScheduler,
    PagedBlockAllocator,
    RequestExpiredError,
    RequestShedError,
    RequestTooLarge,
    ServingEngine,
    ServingResiliencePolicy,
    TenantRegistry,
    TenantTraffic,
    run_scenario,
)
from trlx_tpu_torch.serving.scheduler import FINISH_LENGTH
from trlx_tpu_torch.utils.metrics import gauges

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=64)
CHAOS = "serving-prefill:1,serving-decode:1,serving-alloc:2,serving-wedge:1"
#: the facts of a ScenarioReport held equal across the two packages
REPORT_FACTS = ("submitted", "rejected", "rounds", "restarts", "terminal", "quota_violations", "p99_by_class",
                "delivered_by_tenant", "shed_by_class", "fairness_jain", "outcome_counts")


@pytest.fixture(scope="module")
def weights():
    jcfg = JAX_PRESETS["gpt2"].replace(**TINY, compute_dtype=jnp.float32)
    params = JaxLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    tcfg = PRESETS["gpt2"].replace(**TINY, compute_dtype=torch.float32)
    return jcfg, params, tcfg, params_from_jax(params, tcfg)


_OPEN = []


@pytest.fixture(autouse=True)
def _cleanup():
    """Disarm both packages' chaos and close every engine a test made
    (trlx_tpu's gauges are process-global; later test files check them)."""
    yield
    jax_chaos.configure(None)
    chaos.configure(None)
    while _OPEN:
        _OPEN.pop().close()


class Pkg:
    """One package's serving classes over the shared weights."""

    def __init__(self, name, weights):
        self.name = name
        self.jax = name == "jax"
        jcfg, params, tcfg, state = weights
        self._jcfg, self._params, self._tcfg, self._state = jcfg, params, tcfg, state
        self.Registry = JaxRegistry if self.jax else TenantRegistry
        self.Policy = JaxPolicy if self.jax else ServingResiliencePolicy
        self.Client = JaxClient if self.jax else GenerationClient
        self.Traffic = JaxTraffic if self.jax else TenantTraffic
        self.run_scenario = jax_run_scenario if self.jax else run_scenario
        self.TooLarge = JaxTooLarge if self.jax else RequestTooLarge
        self.Shed = JaxShed if self.jax else RequestShedError
        self.Expired = JaxExpired if self.jax else RequestExpiredError
        self.gauges = jax_gauges if self.jax else gauges

    def engine(self, *, num_slots=3, num_blocks=0, policy=None, tenants=None, seed=0, prefix_caching=False,
               track=True):
        kw = dict(num_slots=num_slots, max_seq_len=32, block_size=4, num_blocks=num_blocks, eos_token_id=None,
                  pad_token_id=0, gen_kwargs=dict(do_sample=False), seed=seed, policy=policy,
                  prefix_caching=prefix_caching, tenants=tenants)
        if self.jax:
            eng = JaxEngine(JaxLM(self._jcfg), self._params, **kw)
        else:
            eng = ServingEngine(TransformerLM(self._tcfg), self._state, device="cpu", **kw)
        if track:
            _OPEN.append(eng)
        return eng


def _both(weights, scenario):
    return scenario(Pkg("jax", weights)), scenario(Pkg("port", weights))


def _outcome(done, uids):
    return [(list(done[u].generated), done[u].finish_reason) for u in uids]


def test_submit_quota_gate_matches_jax(weights):
    def scenario(pkg):
        reg = pkg.Registry()
        reg.register("tiny", kv_block_quota=1)
        eng = pkg.engine(tenants=reg)
        with pytest.raises(pkg.TooLarge) as err:
            eng.submit([1] * 4, 8, tenant_id="tiny")  # worst 12 tokens = 3 blocks
        fits = eng.submit([1] * 2, 2, tenant_id="tiny")
        other = eng.submit([1] * 4, 8, tenant_id="other")  # no quota: the pool's guard only
        done = eng.run([fits, other])
        return (err.value.tenant_id, err.value.slo_class, "capped at 1" in str(err.value),
                _outcome(done, [fits, other]))

    want, got = _both(weights, scenario)
    assert got == want and got[:3] == ("tiny", 0, True)


def test_quota_preemption_stays_within_tenant_as_jax(weights):
    def scenario(pkg):
        reg = pkg.Registry()
        reg.register("a", kv_block_quota=4)
        reg.register("b")
        eng = pkg.engine(tenants=reg, policy=pkg.Policy(preemption=True), num_slots=3, num_blocks=40)
        uids = [eng.submit([1] * 4, 12, tenant_id="a"), eng.submit([2] * 4, 12, tenant_id="a"),
                eng.submit([3] * 4, 8, tenant_id="b")]
        done, peak = {}, 0
        for _ in range(200):
            eng.step()
            peak = max(peak, eng.allocator.owner_usage("a"))
            done.update(eng.scheduler.pop_finished())
            if set(uids) <= set(done):
                break
        eng.allocator.check_invariants()
        return _outcome(done, uids), eng.scheduler.tenant_outcome_counts(), peak

    want, got = _both(weights, scenario)
    assert got == want
    _, counts, peak = got
    assert peak <= 4 and counts["a"]["preempted"] >= 1 and counts.get("b", {}).get("preempted", 0) == 0


def test_typed_errors_carry_tenant_tags_as_jax(weights):
    def scenario(pkg):
        reg = pkg.Registry(class_ttl_s={1: 1.0})
        reg.register("pro", slo_class=1)
        eng = pkg.engine(tenants=reg, policy=pkg.Policy())
        t = [0.0]
        eng.scheduler.clock = lambda: t[0]
        client = pkg.Client(eng)
        uid = client.submit([1, 2, 3], 8, tenant_id="pro")
        ttl = eng.scheduler.get_request(uid).deadline_s
        t[0] = 5.0  # past the class TTL before any round
        with pytest.raises(pkg.Expired) as expired:
            list(client.stream(uid))
        uid2 = client.submit([4, 5], 8, tenant_id="pro")
        eng.begin_drain()
        with pytest.raises(pkg.Shed) as shed:
            list(client.stream(uid2))
        # generate_batch with a tenant raises instead of returning a cut row
        reg2 = pkg.Registry()
        reg2.register("exp", request_ttl_s=2.0)
        eng2 = pkg.engine(tenants=reg2, policy=pkg.Policy())
        ticks = itertools.count()
        eng2.scheduler.clock = lambda: float(next(ticks))  # each clock read ages 1 s
        with pytest.raises(pkg.Expired) as batch_err:
            pkg.Client(eng2).generate_batch([np.array([1, 2, 3])], 8, tenant_id="exp")
        return [ttl] + [(e.value.tenant_id, e.value.slo_class, e.value.uid, type(e.value).__name__)
                        for e in (expired, shed, batch_err)]

    want, got = _both(weights, scenario)
    assert got == want
    assert got[0] == 1.0 and got[1][:2] == got[2][:2] == ("pro", 1) and got[3][:2] == ("exp", 0)
    assert [g[3] for g in got[1:]] == ["RequestExpiredError", "RequestShedError", "RequestExpiredError"]


def test_default_path_equals_tenant_blind_engine_and_jax(weights):
    prompts = [[1, 2, 3, 4], [5, 6], [7, 8, 9, 10, 11, 2]]

    def scenario(pkg):
        outs = []
        for tenants in (None, pkg.Registry()):
            eng = pkg.engine(tenants=tenants, seed=3)
            uids = [eng.submit(p, 6) for p in prompts]
            outs.append(_outcome(eng.run(uids), uids))
        return outs

    want, got = _both(weights, scenario)
    assert got == want and got[0] == got[1]


def test_tenant_gauges_exported_and_cleared_on_close_as_jax(weights):
    def scenario(pkg):
        reg = pkg.Registry(class_ttl_s={0: 50.0})
        reg.register("g1", slo_class=0)
        reg.register("g2", slo_class=1)
        eng = pkg.engine(tenants=reg, track=False)
        t = [0.0]

        def clock():  # each clock read ages 10 ms: latencies are deterministic
            t[0] += 0.01
            return t[0]

        eng.scheduler.clock = clock
        uids = [eng.submit([1, 2, 3], 4, tenant_id="g1"), eng.submit([4, 5], 4, tenant_id="g2")]
        eng.run(uids)
        eng.export_gauges()
        snap = {k: v for k, v in pkg.gauges.snapshot(prefix="serving/").items()
                if k.startswith(("serving/tenant/", "serving/class/"))}
        eng.close()
        return snap, pkg.gauges.snapshot(prefix="serving/")

    want, got = _both(weights, scenario)
    snap, after = got
    assert sorted(snap) == sorted(want[0])
    for k, v in want[0].items():
        assert snap[k] == pytest.approx(v, abs=1e-9), k
    assert snap["serving/tenant/g1/shed"] == 0.0 and "serving/class/1/p99_latency_s" in snap
    assert after == want[1] == {}


def test_export_adopt_carries_tenant_counters_as_the_scheduler_copy():
    """The scheduler is a copy; what the engine's restart path relies on:
    tenant and class counters survive export_state / adopt_state."""
    reg = TenantRegistry()
    reg.register("lo", slo_class=0)
    policy = ServingResiliencePolicy()

    def scheduler():
        return InflightScheduler(0, PagedBlockAllocator(64, 4, prefix_caching=False), policy=policy, tenants=reg)

    s1 = scheduler()
    s1.submit([1] * 4, 4, tenant_id="lo")
    s1.shed_all_pending()
    state = s1.export_state()
    s2 = scheduler()
    s2.submit([2] * 4, 4, tenant_id="lo")
    s2.shed_all_pending()
    s2.adopt_state(state)
    assert s2.tenant_outcome_counts()["lo"]["shed"] == 2 and s2.class_outcome_counts()[0]["shed"] == 2
    state.pop("tenant_counts"), state.pop("class_counts")
    s2.adopt_state(state)
    assert s2.shed_count == 3 and s2.tenant_outcome_counts()["lo"]["shed"] == 2


def _scenario_report(pkg, chaos_spec, tmp_path):
    reg = pkg.Registry(class_ttl_s={0: 8.0, 1: 16.0})
    reg.register("free1", slo_class=0, kv_block_quota=6)
    reg.register("free2", slo_class=0, kv_block_quota=6)
    reg.register("pro1", slo_class=1)
    reg.register("pro2", slo_class=1)
    policy = pkg.Policy(max_pending=8, high_watermark=0.75, low_watermark=0.5, preemption=True)
    T = pkg.Traffic
    traffic = [
        T("free1", num_requests=12, arrivals_per_round=2.0, prompt_len=(4, 10), max_new=(4, 8), vocab=37),
        T("free2", num_requests=12, arrivals_per_round=2.0, prompt_len=(4, 10), max_new=(4, 8), vocab=37),
        T("pro1", num_requests=6, arrivals_per_round=0.5, prompt_len=(4, 10), max_new=(4, 8), vocab=37,
          shared_prefix=4),
        T("pro2", num_requests=6, arrivals_per_round=0.5, prompt_len=(6, 12), max_new=(4, 8), vocab=37),
    ]

    def factory():
        return pkg.engine(num_slots=3, num_blocks=20, policy=policy, tenants=reg, prefix_caching=True,
                          track=False)

    return pkg.run_scenario(factory, reg, traffic, chaos_spec=chaos_spec, dt_s=0.05, max_rounds=400, seed=0,
                            wedge_timeout_s=0.25, diagnostics_dir=str(tmp_path / pkg.name))


@pytest.mark.parametrize("chaos_spec", [CHAOS, None], ids=["chaos", "no_chaos"])
def test_run_scenario_report_matches_jax(weights, tmp_path, chaos_spec):
    want, got = _both(weights, lambda pkg: _scenario_report(pkg, chaos_spec, tmp_path))
    for fact in REPORT_FACTS:
        assert getattr(got, fact) == getattr(want, fact), fact
    for uid, req in got.requests.items():
        assert list(req.generated) == list(want.requests[uid].generated), uid
    assert got.submitted == 36 and got.quota_violations == 0
    assert got.p99_ordering_ok() == want.p99_ordering_ok()
    assert 0.0 < got.fairness_jain <= 1.0
    for key in ("shed", "expired", "preempted"):
        assert got.gauges[f"serving/{key}"] == float(got.outcome_counts[key])
        assert sum(v for k, v in got.gauges.items()
                   if k.startswith("serving/tenant/") and k.endswith(f"/{key}")) == got.gauges[f"serving/{key}"]
    if chaos_spec:
        # the reference's acceptance scenario: the SLO order holds under chaos
        assert got.p99_ordering_ok(), got.p99_by_class
        assert got.restarts >= 1 and got.gauges["serving/restarts"] >= got.restarts
    else:
        assert got.restarts == 0
    # the run's gauges were cleared by the final engine's close
    assert gauges.snapshot(prefix="serving/") == {} == jax_gauges.snapshot(prefix="serving/")


def test_light_scenario_is_clean_as_jax(weights):
    def scenario(pkg):
        reg = pkg.Registry()
        reg.register("a", slo_class=0)
        reg.register("b", slo_class=1)
        traffic = [pkg.Traffic(t, num_requests=5, arrivals_per_round=1.0, prompt_len=(4, 8), max_new=(4, 6),
                               vocab=37) for t in ("a", "b")]
        return pkg.run_scenario(lambda: pkg.engine(tenants=reg, track=False), reg, traffic, dt_s=0.05,
                                max_rounds=200)

    want, got = _both(weights, scenario)
    for fact in REPORT_FACTS:
        assert getattr(got, fact) == getattr(want, fact), fact
    assert got.restarts == 0 and sorted(got.terminal.values()) == [FINISH_LENGTH] * 10
    assert got.fairness_jain > 0.9
