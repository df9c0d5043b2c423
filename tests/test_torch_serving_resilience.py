"""Port parity for the serving resilience layer (the counterpart of
tests/test_serving_resilience.py): on the tiny f32 config of that file, the
port's ``ServingEngine`` with a ``ServingResiliencePolicy`` and the port's
``ServingSupervisor`` run the same traffic as trlx_tpu's on the same
weights, and each case holds the generated tokens and the terminal reasons
identical and the outcome counters and restarts equal to the JAX package's:
expiry (pending and live) and watermark shedding, KV-pressure preemption
(whose output also equals the unpressured engine's), the policy without
faults (equal to the plain engine), drain (plain and through a restart),
a supervised restart replaying every request, an exhausted restart budget
with its diagnostics bundle, a seeded wedge giving exactly one restart, and
the 64-request chaos soak with all four serving chaos sites armed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu.models.transformer import TransformerLM as JaxLM
from trlx_tpu.resilience.chaos import chaos as jax_chaos
from trlx_tpu.serving import ServingEngine as JaxEngine
from trlx_tpu.serving import ServingResiliencePolicy as JaxPolicy
from trlx_tpu.serving import ServingRestartBudgetExceeded as JaxBudgetExceeded
from trlx_tpu.serving import ServingSupervisor as JaxSupervisor
from trlx_tpu.utils.metrics import gauges as jax_gauges
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.serving import (
    EngineDrainingError,
    ServingEngine,
    ServingResiliencePolicy,
    ServingRestartBudgetExceeded,
    ServingSupervisor,
)
from trlx_tpu_torch.serving.scheduler import FINISH_DEADLINE, FINISH_LENGTH, FINISH_SHED
from trlx_tpu_torch.utils.metrics import gauges

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=64)


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
    """Disarm both packages' chaos and close every engine and supervisor a
    test made: trlx_tpu's gauges are process-global, and later test files
    in the same worker assert that ``serving/*`` is clear."""
    yield
    jax_chaos.configure(None)
    chaos.configure(None)
    while _OPEN:
        obj = _OPEN.pop()
        obj.close()
        if hasattr(obj, "restart_history"):  # a supervisor: close its engine too
            obj.engine.close()


class Pkg:
    """One package's engine, policy and supervisor over the shared weights."""

    def __init__(self, name, weights):
        self.name = name
        jcfg, params, tcfg, state = weights
        self.jax = name == "jax"
        self.chaos = jax_chaos if self.jax else chaos
        self.gauges = jax_gauges if self.jax else gauges
        self.Policy = JaxPolicy if self.jax else ServingResiliencePolicy
        self.BudgetExceeded = JaxBudgetExceeded if self.jax else ServingRestartBudgetExceeded
        self._jcfg, self._params, self._tcfg, self._state = jcfg, params, tcfg, state

    def engine(self, *, num_slots=3, num_blocks=0, policy=None, max_seq_len=32, seed=0, prefix_caching=False):
        kw = dict(num_slots=num_slots, max_seq_len=max_seq_len, block_size=4, num_blocks=num_blocks,
                  eos_token_id=None, pad_token_id=0, gen_kwargs=dict(do_sample=False), seed=seed,
                  policy=policy, prefix_caching=prefix_caching)
        if self.jax:
            eng = JaxEngine(JaxLM(self._jcfg), self._params, **kw)
        else:
            eng = ServingEngine(TransformerLM(self._tcfg), self._state, device="cpu", **kw)
        _OPEN.append(eng)
        return eng

    def supervisor(self, factory, **kw):
        sup = (JaxSupervisor if self.jax else ServingSupervisor)(factory, **kw)
        _OPEN.append(sup)
        return sup


def _both(weights, scenario):
    """``scenario(pkg)`` on trlx_tpu, then on the port: their results."""
    return scenario(Pkg("jax", weights)), scenario(Pkg("port", weights))


def _outcome(done, uids):
    return [(list(done[u].generated), done[u].finish_reason) for u in uids]


def test_expiry_and_watermark_shedding_match_jax(weights):
    def scenario(pkg):
        # a live request past its TTL mid-decode: deadline, partial output,
        # its blocks freed
        eng = pkg.engine(num_slots=2, policy=pkg.Policy(request_ttl_s=50.0, preemption=False))
        t = [0.0]
        eng.scheduler.clock = lambda: t[0]
        live = eng.submit([1, 2, 3], 20)
        first = eng.step()
        t[0] = 60.0
        second = eng.step()
        assert first == [] and [r.uid for r in second] == [live]
        assert eng.allocator.blocks_in_use == 0
        eng.allocator.check_invariants()
        # a pending request past its deadline and watermark shedding: 1 slot,
        # max_pending 4 (trigger 4, target 2)
        eng2 = pkg.engine(num_slots=1, policy=pkg.Policy(max_pending=4, high_watermark=1.0, low_watermark=0.5))
        t2 = [0.0]
        eng2.scheduler.clock = lambda: t2[0]
        uids = [eng2.submit([i + 1, i + 2], 3) for i in range(6)]
        late = eng2.submit([9, 9], 3, deadline_s=0.5)
        t2[0] = 1.0
        done = eng2.run(uids + [late])
        return (_outcome({live: second[0]}, [live]), _outcome(done, uids + [late]),
                eng.scheduler.outcome_counts(), eng2.scheduler.outcome_counts())

    want, got = _both(weights, scenario)
    assert got == want
    live, rest, counts_live, counts = got
    assert live[0][1] == FINISH_DEADLINE and len(live[0][0]) >= 1
    reasons = [r for _, r in rest]
    assert reasons.count(FINISH_SHED) > 0 and reasons[-1] in (FINISH_DEADLINE, FINISH_SHED)
    assert counts_live["expired"] == 1 and counts["shed"] == reasons.count(FINISH_SHED)


def test_preemption_output_matches_unpressured_and_jax(weights):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 37, size=n).tolist() for n in (6, 7, 8)]

    def scenario(pkg):
        # 7 usable blocks for three sequences growing to 16-18 tokens
        tight = pkg.engine(num_slots=3, num_blocks=8, policy=pkg.Policy(preemption=True))
        uids = [tight.submit(p, 10) for p in prompts]
        done = tight.run(uids)
        assert tight.scheduler.preempted_count > 0
        assert tight.allocator.blocks_in_use == 0
        tight.allocator.check_invariants()
        roomy = pkg.engine(num_slots=3)
        uids_r = [roomy.submit(p, 10) for p in prompts]
        done_r = roomy.run(uids_r)
        return (_outcome(done, uids), [done[u].preemptions for u in uids], tight.scheduler.outcome_counts(),
                _outcome(done_r, uids_r))

    want, got = _both(weights, scenario)
    assert got == want
    tight, preemptions, _, roomy = got
    assert tight == roomy and any(preemptions)


def test_policy_without_faults_matches_plain_engine(weights):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 37, size=n).tolist() for n in (4, 6, 5, 8)]

    def scenario(pkg):
        plain = pkg.engine(num_slots=3)
        uids = [plain.submit(p, 6) for p in prompts]
        done_p = plain.run(uids)
        pol = pkg.Policy(request_ttl_s=3600.0, max_pending=64, preemption=True)
        sup = pkg.supervisor(lambda: pkg.engine(num_slots=3, policy=pol), max_restarts=2, backoff_base_s=0.01,
                             wedge_timeout_s=None)
        uids_s = [sup.submit(p, 6) for p in prompts]
        done_s = sup.run(uids_s)
        return _outcome(done_p, uids), _outcome(done_s, uids_s), sup.restarts

    want, got = _both(weights, scenario)
    assert got == want
    plain, supervised, restarts = got
    assert plain == supervised and restarts == 0


def test_drain_matches_jax(weights, tmp_path):
    def scenario(pkg):
        eng = pkg.engine(num_slots=2, policy=pkg.Policy())
        uids = [eng.submit([i + 1, i + 2], 6) for i in range(4)]
        eng.step()  # two live, two pending
        done = eng.drain()
        with pytest.raises(Exception) as err:
            eng.submit([1], 2)
        assert eng.allocator.blocks_in_use == 0
        eng.allocator.check_invariants()
        # a crash mid-drain: the replayed live requests finish, not shed again
        sup = pkg.supervisor(lambda: pkg.engine(num_slots=2, policy=pkg.Policy()), max_restarts=3,
                             backoff_base_s=0.01, wedge_timeout_s=None, diagnostics_dir=str(tmp_path / pkg.name))
        uids_s = [sup.submit([i + 1, i + 2], 6) for i in range(3)]
        sup.step()
        pkg.chaos.configure("serving-decode:1")
        done_s = sup.drain()
        pkg.chaos.configure(None)
        with pytest.raises(Exception) as err_s:
            sup.submit([1], 2)
        return (_outcome(done, uids), type(err.value).__name__, _outcome(done_s, uids_s), sup.restarts,
                type(err_s.value).__name__)

    want, got = _both(weights, scenario)
    assert got == want
    plain, err, supervised, restarts, err_s = got
    assert sorted(r for _, r in plain) == [FINISH_LENGTH, FINISH_LENGTH, FINISH_SHED, FINISH_SHED]
    assert sorted(r for _, r in supervised) == [FINISH_LENGTH, FINISH_LENGTH, FINISH_SHED]
    assert restarts == 1 and err == err_s == EngineDrainingError.__name__


def test_supervised_restart_replays_requests_losing_nothing(weights, tmp_path):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 37, size=n).tolist() for n in (5, 6, 7, 4)]

    def scenario(pkg):
        clean = pkg.engine(num_slots=2)
        uids_c = [clean.submit(p, 6) for p in prompts]
        done_c = clean.run(uids_c)
        sup = pkg.supervisor(lambda: pkg.engine(num_slots=2, policy=pkg.Policy()), max_restarts=3,
                             backoff_base_s=0.01, wedge_timeout_s=None, diagnostics_dir=str(tmp_path / pkg.name))
        uids = [sup.submit(p, 6) for p in prompts]
        sup.step()  # at least one token decoded, so the replay carries state
        pkg.chaos.configure("serving-decode:1")
        done = sup.run(uids)
        pkg.chaos.configure(None)
        fresh = sup.submit([1, 2], 2)
        return (_outcome(done_c, uids_c), _outcome(done, uids), sup.restarts, fresh > max(uids),
                pkg.gauges.get("serving/restarts"))

    want, got = _both(weights, scenario)
    assert got == want
    clean, replayed, restarts, fresh_uid, gauge = got
    assert replayed == clean and restarts == 1 and fresh_uid and gauge == 1.0


def test_budget_exhaustion_fails_closed_with_bundle(weights, tmp_path):
    def scenario(pkg):
        diag = tmp_path / pkg.name
        sup = pkg.supervisor(lambda: pkg.engine(num_slots=2, policy=pkg.Policy()), max_restarts=1,
                             backoff_base_s=0.001, wedge_timeout_s=None, diagnostics_dir=str(diag))
        sup.submit([1, 2, 3], 4)
        pkg.chaos.configure("serving-prefill:99")  # a permanent outage
        with pytest.raises(pkg.BudgetExceeded, match="diagnostics bundle") as err:
            sup.run()
        pkg.chaos.configure(None)
        bundles = sorted(p.name.split("-")[0] for p in diag.iterdir())
        return sup.restarts, bundles, str(diag) in str(err.value)

    want, got = _both(weights, scenario)
    assert got == want
    restarts, bundles, named = got
    assert restarts == 2 and bundles == ["serving"] and named


def test_seeded_wedge_exactly_one_restart(weights, tmp_path):
    def scenario(pkg):
        pkg.chaos.configure("serving-wedge:1")
        sup = pkg.supervisor(lambda: pkg.engine(num_slots=2, policy=pkg.Policy()), max_restarts=3,
                             backoff_base_s=0.01, wedge_timeout_s=0.2, diagnostics_dir=str(tmp_path / pkg.name))
        uids = [sup.submit([i + 1, i + 2, i + 3], 5) for i in range(4)]
        done = sup.run(uids)
        injected = pkg.chaos.stats().get("serving-wedge")
        pkg.chaos.configure(None)
        return _outcome(done, uids), sup.restarts, injected

    want, got = _both(weights, scenario)
    assert got == want
    outcome, restarts, injected = got
    assert restarts == 1 and injected == 1 and all(r == FINISH_LENGTH for _, r in outcome)


def test_chaos_soak_every_request_accounted_as_jax(weights, tmp_path):
    """All four serving chaos sites over a 64-request stream with deadlines,
    a bounded pending queue and a tight pool: every uid ends in exactly one
    terminal state, the pool stays sane across restarts, and the tokens,
    reasons, outcome counts and restarts equal trlx_tpu's."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 37, size=int(rng.integers(3, 9))).tolist() for _ in range(64)]
    budgets = [int(rng.integers(3, 8)) for _ in range(64)]

    def scenario(pkg):
        pol = pkg.Policy(request_ttl_s=300.0, max_pending=16, high_watermark=1.0, low_watermark=0.5,
                         preemption=True)
        sup = pkg.supervisor(lambda: pkg.engine(num_slots=4, num_blocks=12, policy=pol), max_restarts=8,
                             backoff_base_s=0.01, wedge_timeout_s=0.5, diagnostics_dir=str(tmp_path / pkg.name))
        pkg.chaos.configure("serving-prefill:1,serving-decode:1,serving-alloc:2,serving-wedge:1")
        uids, terminal = [], {}
        feed = iter(zip(prompts, budgets))
        seen = 0
        for _ in range(600):
            for _ in range(8):  # 8 arrivals a round
                nxt = next(feed, None)
                if nxt is not None:
                    uids.append(sup.submit(*nxt))
            sup.step()
            if sup.restarts != seen:
                seen = sup.restarts
                sup.allocator.check_invariants()
            for uid, req in sup.scheduler.pop_finished().items():
                assert uid not in terminal, f"uid {uid} finished twice"
                terminal[uid] = req
            if len(uids) == 64 and not sup.scheduler.has_work:
                break
        pkg.chaos.configure(None)
        assert set(terminal) == set(uids)
        assert sup.allocator.blocks_in_use == 0
        sup.allocator.check_invariants()
        sup.export_gauges()
        counts = sup.scheduler.outcome_counts()
        assert {k: pkg.gauges.get(f"serving/{k}") for k in ("shed", "expired", "preempted")} == {
            k: float(counts[k]) for k in ("shed", "expired", "preempted")}
        return _outcome(terminal, uids), counts, sup.restarts, pkg.gauges.get("serving/restarts")

    want, got = _both(weights, scenario)
    assert got == want
    outcome, counts, restarts, gauge = got
    assert restarts >= 3 and gauge == float(restarts)
    assert counts["shed"] == sum(1 for _, r in outcome if r == FINISH_SHED) > 0


def test_idle_slot_past_the_table_reach_writes_nothing_visible():
    """An idle slot's length grows every step; a slot left idle past the
    table's reach (a preemption-starved slot) must not break the decode
    write. trlx_tpu's gather / scatter drop that write; the port writes the
    null block, so every real block equals trlx_tpu's."""
    from trlx_tpu.ops.paged_attention import write_paged_kv as jax_write
    from trlx_tpu_torch.ops.paged_attention import write_paged_kv

    rng = np.random.default_rng(0)
    NB, BS, Hkv, D, MB = 6, 4, 2, 8, 2
    pools = {k: rng.standard_normal((NB, BS, Hkv, D)).astype(np.float32) for k in ("k", "v")}
    tables = np.array([[1, 2], [3, 0], [0, 0]], np.int32)
    lens = np.array([5, 2, MB * BS + 3], np.int32)  # live, live, idle past the reach
    k_new, v_new = (rng.standard_normal((3, Hkv, D)).astype(np.float32) for _ in range(2))
    want = jax_write({**{k: jnp.asarray(v) for k, v in pools.items()}, "block_tables": jnp.asarray(tables),
                      "context_lens": jnp.asarray(lens)}, jnp.asarray(k_new), jnp.asarray(v_new))
    got = write_paged_kv({**{k: torch.from_numpy(v.copy()) for k, v in pools.items()},
                          "block_tables": torch.from_numpy(tables), "context_lens": torch.from_numpy(lens)},
                         torch.from_numpy(k_new), torch.from_numpy(v_new))
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].numpy()[1:], np.asarray(want[key])[1:])
        assert not np.array_equal(got[key].numpy()[1:], pools[key][1:])  # the live writes landed
