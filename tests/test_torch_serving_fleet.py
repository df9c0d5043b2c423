"""Port parity for serving across engines: trlx_tpu_torch's ``fleet`` package
(``FleetRouter``, ``FleetAutoscaler``, ``FleetLedger``,
``run_fleet_scenario``) against trlx_tpu's, one case for each case of
tests/test_serving_fleet.py, both routers over the tiny f32 gpt2 of that
file (2 layers, hidden 16, greedy; the port's weights carried over with
``params_from_jax``) and the same traffic. Compared exactly: the seat of
every uid, uids, tokens and terminal reasons, ``ledger.summary()`` and
``burn_rates()``, the ``fleet/*`` gauges (latency gauges on the wall clock
excepted), autoscale events, kill re-route counts, the ``replica_id`` of
typed errors, the ``run_fleet_scenario`` report's facts (p99 on the
scenario's virtual clock), and ``TRLX_FLEET_SEED_REGRESSION=blind_router``
failing the affinity-beats-random check in both packages. A fleet of one
is ``==`` the bare engine. The ``run_fleet_scenario`` cases (affinity
against random, the chaos soak, the clean run) are
tests/test_torch_serving_fleet_scenario.py; the trainer with a fleet is
tests/test_torch_trainer_fleet.py.

Each test closes every router and engine it builds (both packages' gauge
registries are process-global) and disarms both packages' chaos.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import trlx_tpu.fleet as jfleet
import trlx_tpu_torch.fleet as tfleet
from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu.models.transformer import TransformerLM as JaxLM
from trlx_tpu.resilience.chaos import chaos as jax_chaos
from trlx_tpu.serving import EngineDrainingError as JaxDraining
from trlx_tpu.serving import GenerationClient as JaxClient
from trlx_tpu.serving import RequestShedError as JaxShed
from trlx_tpu.serving import ServingEngine as JaxEngine
from trlx_tpu.serving import ServingResiliencePolicy as JaxPolicy
from trlx_tpu.serving import ServingRestartBudgetExceeded as JaxBudget
from trlx_tpu.serving import TenantRegistry as JaxRegistry
from trlx_tpu.serving import TenantTraffic as JaxTraffic
from trlx_tpu.utils.metrics import gauges as jax_gauges
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.serving import (
    EngineDrainingError,
    GenerationClient,
    RequestShedError,
    ServingEngine,
    ServingResiliencePolicy,
    ServingRestartBudgetExceeded,
    TenantRegistry,
    TenantTraffic,
)
from trlx_tpu_torch.serving.scheduler import FINISH_LENGTH
from trlx_tpu_torch.utils.metrics import gauges

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=64)
#: the facts of a FleetScenarioReport held equal across the two packages
REPORT_FACTS = ("submitted", "rejected", "rounds", "restarts", "terminal", "quota_violations", "p99_by_class",
                "delivered_by_tenant", "shed_by_class", "fairness_jain", "outcome_counts", "affinity_hit_rate",
                "random_hit_rate", "sticky_hit_rate", "replica_kills", "reroutes", "autoscale_events",
                "replicas_final", "replicas_peak")


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


#: the gauge namespaces a serving or fleet test writes in either package
_NAMESPACES = ("serving/", "fleet/")


def _clear_gauges():
    for registry in (jax_gauges, gauges):
        for prefix in _NAMESPACES:
            registry.clear(prefix=prefix)


@pytest.fixture(autouse=True)
def _cleanup(monkeypatch):
    """Disarm both packages' chaos and close every router and engine a test
    made. The gauge registries are process-global: each test starts from
    empty ``serving/`` and ``fleet/`` namespaces (other test files on the
    same worker may have left gauges there) and leaves them empty."""
    monkeypatch.delenv("TRLX_FLEET_SEED_REGRESSION", raising=False)
    _clear_gauges()
    yield
    jax_chaos.configure(None)
    chaos.configure(None)
    while _OPEN:
        _OPEN.pop().close()
    _clear_gauges()


class Pkg:
    """One package's serving and fleet classes over the shared weights."""

    def __init__(self, name, weights, tmp_path):
        self.name = name
        self.jax = name == "jax"
        self._jcfg, self._params, self._tcfg, self._state = weights
        self.diag = str(tmp_path / name)
        self.fleet = jfleet if self.jax else tfleet
        self.Registry = JaxRegistry if self.jax else TenantRegistry
        self.Policy = JaxPolicy if self.jax else ServingResiliencePolicy
        self.Client = JaxClient if self.jax else GenerationClient
        self.Traffic = JaxTraffic if self.jax else TenantTraffic
        self.Budget = JaxBudget if self.jax else ServingRestartBudgetExceeded
        self.Draining = JaxDraining if self.jax else EngineDrainingError
        self.Shed = JaxShed if self.jax else RequestShedError
        self.chaos = jax_chaos if self.jax else chaos
        self.gauges = jax_gauges if self.jax else gauges

    def engine(self, *, num_slots=3, num_blocks=0, policy=None, seed=0, prefix_caching=False, tenants=None,
               replica_id=None, track=True):
        kw = dict(num_slots=num_slots, max_seq_len=32, block_size=4, num_blocks=num_blocks, eos_token_id=None,
                  pad_token_id=0, gen_kwargs=dict(do_sample=False), seed=seed, policy=policy,
                  prefix_caching=prefix_caching, tenants=tenants, replica_id=replica_id)
        if self.jax:
            eng = JaxEngine(JaxLM(self._jcfg), self._params, **kw)
        else:
            eng = ServingEngine(TransformerLM(self._tcfg), self._state, device="cpu", **kw)
        if track:
            _OPEN.append(eng)
        return eng

    def router(self, num_replicas, *, factory=None, **kw):
        """FleetRouter with the JAX file's test knobs (no wedge timer, fast
        backoff, diagnostics under tmp)."""
        if factory is None:
            def factory(seat):
                return self.engine(track=False)
        kw.setdefault("wedge_timeout_s", None)
        kw.setdefault("backoff_base_s", 0.01)
        kw.setdefault("diagnostics_dir", self.diag)
        router = self.fleet.FleetRouter(factory, num_replicas, **kw)
        _OPEN.append(router)
        return router

    def scenario(self, factory, registry, traffic, **kw):
        return self.fleet.run_fleet_scenario(factory, registry, traffic, diagnostics_dir=self.diag, **kw)


def _both(weights, tmp_path, scenario):
    """The same scenario through trlx_tpu, then through the port."""
    return scenario(Pkg("jax", weights, tmp_path)), scenario(Pkg("port", weights, tmp_path))


def _outcome(done, uids):
    return [(list(done[u].generated), done[u].finish_reason) for u in uids]


def _no_wall_clock(snapshot):
    """A gauge snapshot without the latency gauges (wall-clock seconds)."""
    return {k: v for k, v in snapshot.items() if "latency" not in k}


def _report_facts(report):
    return {f: getattr(report, f) for f in REPORT_FACTS}


# ------------------------------------------------------- seating/namespacing


def test_uid_blocks_and_gauge_namespaces_per_seat_as_jax(weights, tmp_path):
    def scenario(pkg):
        router = pkg.router(2)
        handles = router._active_handles()
        seats = [(h.seat, h.supervisor.engine.gauge_prefix, h.supervisor.engine.replica_id,
                  h.supervisor.engine.scheduler.uid_hwm) for h in handles]
        u0 = router.submit([1, 2, 3], 3)
        u1 = router.submit([4, 5, 6], 3)
        done = router.run([u0, u1])
        router.export_gauges()
        per_seat = [bool(pkg.gauges.snapshot(prefix=f"serving/replica/{s}/")) for s in (0, 1)]
        fleet = _no_wall_clock(pkg.gauges.snapshot(prefix="fleet/"))
        facts = (seats, [u0, u1], [router.replica_of(u0), router.replica_of(u1)], _outcome(done, [u0, u1]),
                 per_seat, fleet, router.ledger.summary(), router.ledger.burn_rates())
        router.close()
        return facts, pkg.gauges.snapshot(prefix="serving/"), pkg.gauges.snapshot(prefix="fleet/")

    want, got = _both(weights, tmp_path, scenario)
    assert got == want
    (seats, (u0, u1), replicas, _, per_seat, fleet, _, _), after_serving, after_fleet = got
    S = tfleet.UID_STRIDE
    assert seats == [(0, "serving/replica/0/", 0, 0), (1, "serving/replica/1/", 1, S)]
    assert 0 <= u0 < S <= u1 < 2 * S and replicas == [0, 1] and per_seat == [True, True]
    assert fleet["fleet/replicas"] == 2.0 and fleet["fleet/routed"] == 2.0 and fleet["fleet/finished"] == 2.0
    assert after_serving == {} == after_fleet


def test_bare_engine_keeps_default_gauge_prefix_as_jax(weights, tmp_path):
    def scenario(pkg):
        eng = pkg.engine(track=False)
        prefix, replica = eng.gauge_prefix, eng.replica_id
        uid = eng.submit([1, 2], 3)
        eng.run([uid])
        eng.export_gauges()
        snap = pkg.gauges.snapshot(prefix="serving/")
        eng.close()
        return prefix, replica, sorted(snap), pkg.gauges.snapshot(prefix="serving/")

    want, got = _both(weights, tmp_path, scenario)
    prefix, replica, keys, after = got
    assert (prefix, replica, after) == (want[0], want[1], want[3]) == ("serving/", None, {})
    assert keys and "serving/live_slots" in keys and not any(k.startswith("serving/replica/") for k in keys)
    assert set(keys) >= set(want[2]) - {"serving/request_latency_s"}


# ----------------------------------------------------------------- affinity


@pytest.mark.parametrize("regression", [None, "blind_router"])
def test_fleet_affinity_warm_prefix_beats_least_loaded_as_jax(weights, tmp_path, monkeypatch, regression):
    """The warm prefix wins over a less-loaded seat in both packages; under
    ``blind_router`` both degenerate to least-loaded (the probe moves)."""
    if regression:
        monkeypatch.setenv("TRLX_FLEET_SEED_REGRESSION", regression)

    def scenario(pkg):
        router = pkg.router(2, factory=lambda seat: pkg.engine(num_slots=2, prefix_caching=True, track=False))
        warm = [1, 2, 3, 4, 5, 6, 7, 8]  # 2 full blocks at block size 4
        u0 = router.submit(warm, 3, tenant_id="a")
        router.run([u0])
        cached = router._active_handles()[0].supervisor.engine.allocator.cached_prefix_blocks(warm)
        filler = router.submit([9, 10], 3, tenant_id="b")
        probe = router.submit(warm, 3, tenant_id="c")
        seats = [router.replica_of(u) for u in (u0, filler, probe)]
        done = router.run([filler, probe])
        return seats, cached, _outcome(done, [filler, probe]), router.ledger.summary()

    want, got = _both(weights, tmp_path, scenario)
    assert got == want
    seats, cached, _, summary = got
    assert cached >= 2
    if regression is None:
        assert seats == [0, 0, 0], "warm-prefix affinity lost to least-loaded routing"
        assert summary["fleet_affinity_hit_rate"] == pytest.approx(1 / 3)
    else:
        assert seats[2] == 1  # the blind router sends the probe to the emptier seat


def test_fleet_affinity_tenant_stickiness_as_jax(weights, tmp_path):
    def scenario(pkg):
        router = pkg.router(2, factory=lambda seat: pkg.engine(num_slots=2, track=False), tenant_weight=2.0,
                            load_weight=0.5)
        uids = [router.submit([1, 2, 3], 3, tenant_id="t"), router.submit([7, 8, 9], 3, tenant_id="t"),
                router.submit([4, 5, 6], 3, tenant_id="u")]
        seats = [router.replica_of(u) for u in uids]
        done = router.run(uids)
        return seats, _outcome(done, uids), router.ledger.summary()

    want, got = _both(weights, tmp_path, scenario)
    assert got == want
    assert got[0] == [0, 0, 1] and got[2]["fleet_sticky_hit_rate"] == pytest.approx(1 / 3)


def test_fleet_seed_regression_env_validated_as_jax(weights, tmp_path, monkeypatch):
    monkeypatch.setenv("TRLX_FLEET_SEED_REGRESSION", "bogus")
    for pkg in (Pkg("jax", weights, tmp_path), Pkg("port", weights, tmp_path)):
        with pytest.raises(ValueError, match="TRLX_FLEET_SEED_REGRESSION"):
            pkg.router(1)


def test_one_tenant_stickiness_outweighs_load_as_jax(weights, tmp_path):
    """The default weights on a one-tenant batch (a trainer's rollouts): the
    stickiness term (0.25 per recent route to a seat) grows faster than the
    load penalty (2.0 per ``num_slots`` requests) once ``num_slots`` > 8, so
    every request lands on seat 0 in both packages; ``tenant_weight=0``
    spreads them by load."""

    def scenario(pkg):
        out = []
        for tenant_weight in (0.25, 0.0):
            router = pkg.router(2, factory=lambda seat: pkg.engine(num_slots=16, track=False),
                                tenant_weight=tenant_weight)
            uids = [router.submit([i + 1, i + 2], 1) for i in range(16)]
            out.append([router.replica_of(u) for u in uids])
            router.run(uids)
            router.close()
        return out

    want, got = _both(weights, tmp_path, scenario)
    assert got == want
    assert got[0] == [0] * 16 and sorted(got[1]) == [0] * 8 + [1] * 8


# --------------------------------------------------------------- autoscaler


def test_autoscaler_hysteresis_no_flap_as_jax(weights, tmp_path):
    """Oscillating load never scales; a sustained breach scales once, the
    cooldown blocks reversal, sustained idleness drains the newest seat."""

    def scenario(pkg):
        router = pkg.router(1, factory=lambda seat: pkg.engine(num_slots=2, track=False))
        scaler = pkg.fleet.FleetAutoscaler(router, min_replicas=1, max_replicas=2, scale_up_pending_per_slot=1.0,
                                           scale_down_occupancy=0.5, breach_rounds=3, cooldown_rounds=4)
        trace = []

        def observe():
            router.export_gauges()
            scaler.observe()
            trace.append((router.num_replicas, [e[1] for e in scaler.events]))

        for _ in range(3):
            uids = [router.submit([i + 1, i + 2], 2) for i in range(6)]
            observe()
            observe()
            router.run(uids)
            observe()
        uids = [router.submit([i + 1, i + 2], 2) for i in range(6)]
        for _ in range(5):
            observe()
        router.run(uids)
        for _ in range(8):
            observe()
        draining = [h.seat for h in router._live_handles() if h.state == pkg.fleet.DRAINING]
        router.step()
        return trace, list(scaler.events), draining, router.num_replicas, [h.seat for h in router._active_handles()]

    want, got = _both(weights, tmp_path, scenario)
    assert got == want
    trace, events, draining, replicas, active = got
    assert trace[8] == (1, []) and trace[11] == (2, ["up"]) and trace[13] == (2, ["up"])
    assert [e[1] for e in events] == ["up", "drain"] and draining == [1]
    assert replicas == 1 and active == [0]


def test_autoscaler_validates_bounds_as_jax(weights, tmp_path):
    for pkg in (Pkg("jax", weights, tmp_path), Pkg("port", weights, tmp_path)):
        router = pkg.router(1)
        with pytest.raises(ValueError, match="min_replicas"):
            pkg.fleet.FleetAutoscaler(router, min_replicas=3, max_replicas=2)
        with pytest.raises(ValueError, match="breach_rounds"):
            pkg.fleet.FleetAutoscaler(router, breach_rounds=0)
        with pytest.raises(ValueError, match="window_rounds"):
            pkg.fleet.FleetAutoscaler(router, window_rounds=0)


# ------------------------------------------------------------ kill/re-route


def test_replica_kill_reroutes_and_finishes_exactly_once_as_jax(weights, tmp_path):
    def scenario(pkg):
        router = pkg.router(2, factory=lambda seat: pkg.engine(num_slots=2, track=False))
        uids = [router.submit([i + 1, i + 2, i + 3], 4) for i in range(6)]
        seats = [router.replica_of(u) for u in uids]
        router.step()
        pkg.chaos.configure("fleet-replica-kill:1")
        done = router.run(uids)
        survivor = [h.seat for h in router._active_handles()]
        return (seats, _outcome(done, uids), router.ledger.summary(), survivor,
                [router.replica_of(u) for u in uids], pkg.chaos.stats().get("fleet-replica-kill"))

    want, got = _both(weights, tmp_path, scenario)
    assert got == want
    seats, outcome, summary, survivor, owners, fired = got
    assert set(seats) == {0, 1} and all(r == FINISH_LENGTH for _, r in outcome)
    assert summary["fleet_replica_kills"] == 1 and summary["fleet_reroutes"] >= 1
    assert len(survivor) == 1 and owners == survivor * len(owners) and fired == 1


def test_replica_kill_releases_the_dead_replicas_device_state(weights, tmp_path):
    """Port only: a killed or drained replica drops its trunk and KV pools
    (on the card, its device memory), the survivor keeps its own."""
    pkg = Pkg("port", weights, tmp_path)
    router = pkg.router(2, factory=lambda seat: pkg.engine(num_slots=2, track=False))
    engines = [h.supervisor.engine for h in router._active_handles()]
    uids = [router.submit([i + 1, i + 2, i + 3], 4) for i in range(4)]
    router.step()
    chaos.configure("fleet-replica-kill:1")
    router.run(uids)
    dead = [e for e in engines if e.trunk is None]
    assert len(dead) == 1 and dead[0].cache is None
    router.close()
    assert all(e.trunk is None and e.cache is None for e in engines)


def test_fleet_fails_closed_with_no_active_replica_as_jax(weights, tmp_path):
    for pkg in (Pkg("jax", weights, tmp_path), Pkg("port", weights, tmp_path)):
        router = pkg.router(1)
        router.close()
        with pytest.raises(pkg.Budget, match="no active replica"):
            router.submit([1, 2], 2)


# ----------------------------------------------------- replica-tagged errors


def test_typed_errors_carry_replica_id_as_jax(weights, tmp_path):
    def scenario(pkg):
        eng = pkg.engine(replica_id=7)
        eng.begin_drain()
        with pytest.raises(pkg.Draining) as drained:
            eng.submit([1, 2], 2)
        router = pkg.router(2, factory=lambda seat: pkg.engine(num_slots=2, policy=pkg.Policy(), track=False))
        client = pkg.Client(router)
        uid = client.submit([1, 2, 3], 4)
        seat = router.replica_of(uid)
        router.begin_drain(shed_pending=True)
        with pytest.raises(pkg.Shed) as shed:
            list(client.stream(uid))
        return drained.value.replica_id, seat, shed.value.replica_id, shed.value.tenant_id, shed.value.uid

    want, got = _both(weights, tmp_path, scenario)
    assert got == want
    assert got[0] == 7 and got[2] == got[1] and got[3] is not None


# --------------------------------------------------------------- N=1 parity


def test_fleet_of_one_matches_bare_engine_and_jax(weights, tmp_path):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 37, size=n).tolist() for n in (4, 6, 5, 8)]

    def scenario(pkg):
        bare = pkg.engine(num_slots=3)
        uids_b = [bare.submit(p, 6) for p in prompts]
        done_b = bare.run(uids_b)
        router = pkg.router(1, factory=lambda seat: pkg.engine(num_slots=3, track=False))
        uids_f = [router.submit(p, 6) for p in prompts]
        done_f = router.run(uids_f)
        return (uids_b, _outcome(done_b, uids_b)), (uids_f, _outcome(done_f, uids_f))

    want, got = _both(weights, tmp_path, scenario)
    assert got == want
    assert got[0] == got[1]  # uids, tokens and finish reasons: the fleet of one IS the bare engine


# ------------------------------------------------------------------- config


def test_train_config_parses_serving_fleet_block_as_jax():
    from trlx_tpu.data.configs import ServingFleetConfig as JaxFleetConfig
    from trlx_tpu.data.configs import TrainConfig as JaxTrainConfig
    from trlx_tpu_torch.data.configs import ServingFleetConfig, TrainConfig

    block = dict(enabled=True, num_replicas=3, prefix_weight=2.0, autoscale=True, min_replicas=2, max_replicas=5,
                 breach_rounds=4)
    base = dict(total_steps=1, batch_size=1, checkpoint_dir="/tmp/x")
    for Train, Fleet in ((JaxTrainConfig, JaxFleetConfig), (TrainConfig, ServingFleetConfig)):
        svf = Train.from_dict(dict(base, serving_fleet=block)).serving_fleet
        assert isinstance(svf, Fleet)
        assert svf.enabled and svf.num_replicas == 3 and svf.prefix_weight == 2.0
        assert svf.autoscale and svf.min_replicas == 2 and svf.max_replicas == 5
        assert Train.from_dict(dict(base)).serving_fleet.enabled is False
        with pytest.raises(ValueError, match="num_replicas"):
            Fleet(num_replicas=0)
        with pytest.raises(ValueError, match="min_replicas"):
            Fleet(min_replicas=4, max_replicas=2)
    assert vars(TrainConfig.from_dict(dict(base, serving_fleet=block)).serving_fleet) == vars(
        JaxTrainConfig.from_dict(dict(base, serving_fleet=block)).serving_fleet)
