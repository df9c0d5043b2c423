"""Port parity for self-healing: trlx_tpu_torch's health guard, experience
quarantine, chaos poison sites, rollout-engine seam and producer supervisor
held against trlx_tpu's on the same inputs (stats sequences, elements,
chaos specs), and the trainers: the port's and the JAX ``PPOTrainer`` on
the CPU with ``train.self_healing`` and ``nan-loss:1`` give the same
``health/update_applied`` sequence, the port leaves parameters and AdamW
state ``torch.equal`` across the skipped step, neither package advances the
learning rate over it, and stats stay within the trainer-parity limits
(experience 1e-4, stats 1e-3 relative). Then the port's own rollback, halt,
chaos soak and disabled-is-inert runs."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

import trlx_tpu.resilience.health as jhealth
import trlx_tpu.resilience.quarantine as jquar
import trlx_tpu.rollout as jrollout
import trlx_tpu_torch
import trlx_tpu_torch.resilience.health as phealth
import trlx_tpu_torch.resilience.quarantine as pquar
import trlx_tpu_torch.rollout as prollout
from trlx_tpu.data.configs import SelfHealingConfig as JaxSelfHealingConfig
from trlx_tpu.data.ppo_types import PPORLElement as JaxElement
from trlx_tpu.obs import watchdog as jax_watchdog
from trlx_tpu.resilience.chaos import chaos as jax_chaos
from trlx_tpu.utils.metrics import gauges as jax_gauges
from trlx_tpu_torch.data.configs import SelfHealingConfig
from trlx_tpu_torch.data.ppo_types import PPORLElement
from trlx_tpu_torch.models.convert import policy_params_from_jax
from trlx_tpu_torch.obs import watchdog
from trlx_tpu_torch.obs.watchdog import StallWatchdog
from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.utils.metrics import gauges

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]
ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    """Chaos disarmed, resilience gauges cleared and no watchdog installed,
    in both packages, before and after every test (all process-global)."""
    monkeypatch.delenv("TRLX_CHAOS", raising=False)

    def clean():
        for c, g in ((chaos, gauges), (jax_chaos, jax_gauges)):
            c.configure(None)
            g.clear("resilience/")
        watchdog.install(None)
        jax_watchdog.install(None)

    clean()
    yield
    clean()


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


# ------------------------------------------------- elements and quarantine


def _fields(i, **over):
    f = dict(query_tensor=np.array([i, i + 1], np.int32), response_tensor=np.array([i + 2, i + 3], np.int32),
             logprobs=np.array([-0.5, -0.25], np.float32), values=np.array([0.1, 0.2], np.float32),
             rewards=np.array([1.0, 0.0], np.float32))
    f.update(over)
    return f


ELEMENTS = {
    "clean": {},
    "nan logprobs": dict(logprobs=np.array([np.nan, 0.0], np.float32)),
    "inf values": dict(values=np.array([0.0, np.inf], np.float32)),
    "-inf rewards": dict(rewards=np.array([-np.inf, 0.0], np.float32)),
    "empty response": dict(response_tensor=np.zeros((0,), np.int32), logprobs=np.zeros((0,), np.float32),
                           values=np.zeros((0,), np.float32), rewards=np.zeros((0,), np.float32)),
    "nan everywhere": dict(logprobs=np.array([np.nan] * 2, np.float32), values=np.array([np.nan] * 2, np.float32)),
    "f64 huge but finite": dict(rewards=np.array([1e300, 0.0], np.float64)),
}


@pytest.mark.parametrize("case", list(ELEMENTS), ids=list(ELEMENTS))
def test_validate_element_matches_jax(case):
    f = _fields(3, **ELEMENTS[case])
    assert pquar.validate_element(PPORLElement(**f)) == jquar.validate_element(JaxElement(**f))


def test_quarantine_filter_writes_sidecar_and_gauge(tmp_path):
    quar = pquar.ExperienceQuarantine(str(tmp_path / "quar"))
    good = [PPORLElement(**_fields(i)) for i in range(3)]
    bad = PPORLElement(**_fields(9, logprobs=np.array([np.nan, 0.0], np.float32)))
    assert quar.filter(good + [bad], context="iter=7") == good
    assert quar.count == 1 and gauges.get("resilience/quarantined") == 1.0
    with open(quar.path) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1
    assert records[0]["reason"] == "non-finite logprobs" and records[0]["context"] == "iter=7"
    assert records[0]["response_tokens"] == [11, 12]
    assert quar.filter([bad], context="iter=8") == [] and quar.count == 2


def test_chaos_corrupt_elements_first_only_as_jax():
    elements = [PPORLElement(**_fields(i)) for i in range(3)]
    jelements = [JaxElement(**_fields(i)) for i in range(3)]
    assert pquar.chaos_corrupt_elements(elements) is elements  # unarmed: free
    chaos.configure("bad-element:1")
    jax_chaos.configure("bad-element:1")
    out, jout = pquar.chaos_corrupt_elements(elements), jquar.chaos_corrupt_elements(jelements)
    assert [pquar.validate_element(e) for e in out] == [jquar.validate_element(e) for e in jout]
    assert out[1:] == elements[1:] and np.isnan(out[0].logprobs).all()
    assert pquar.chaos_corrupt_elements(elements) is elements  # budget spent


def test_chaos_poison_batch_nans_floats_only():
    from trlx_tpu_torch.data.ppo_types import PPORLBatch

    batch = PPORLBatch(
        query_tensors=np.ones((2, 3), np.int32), response_tensors=torch.ones(2, 2, dtype=torch.int64),
        logprobs=np.zeros((2, 2), np.float32), values=torch.zeros(2, 2), rewards=torch.zeros(2, 2, dtype=torch.float64),
        attention_mask=np.ones((2, 3), np.int32), response_mask=np.ones((2, 2), np.int32),
        policy_version=np.zeros(2, np.int32),
    )
    assert phealth.chaos_poison_batch(batch) is batch  # unarmed: free
    chaos.configure("nan-loss:2")
    out = phealth.chaos_poison_batch(batch)
    assert np.isnan(out.logprobs).all() and torch.isnan(out.values).all() and torch.isnan(out.rewards).all()
    assert out.rewards.dtype == torch.float64 and out.values.device == batch.values.device
    assert np.array_equal(out.query_tensors, batch.query_tensors)
    assert torch.equal(out.response_tensors, batch.response_tensors)
    assert not np.isnan(batch.logprobs).any()  # the input is not modified
    nested = phealth.chaos_poison_batch({"x": [torch.ones(1)], "n": np.arange(2)})
    assert nested["x"][0].isnan().all() and np.array_equal(nested["n"], np.arange(2))
    assert phealth.chaos_poison_batch(batch) is batch  # budget spent
    assert chaos.stats() == {"nan-loss": 2}


# ------------------------------------------------------------ health guard


def _healthy(grad_norm=1.0, kl=0.1):
    return {"loss": 0.5, "health/update_applied": 1.0, "health/grad_norm": grad_norm, "policy/sqrt_kl": kl}


SKIPPED = {"loss": float("nan"), "health/update_applied": 0.0, "health/grad_norm": float("nan")}
SPIKE = {"loss": 0.5, "health/update_applied": 0.0, "health/grad_norm": 50.0, "policy/sqrt_kl": 0.1}

GUARD_CASES = {
    "warm-up then median": (dict(min_window=3, anomaly_window=8),
                            [_healthy(1.0), _healthy(1.2), _healthy(1.1), _healthy(1.05)]),
    "kl spike": (dict(min_window=2, kl_spike_factor=2.0), [_healthy(kl=0.1)] * 3 + [_healthy(kl=10.0)]),
    "zero baseline": (dict(min_window=2), [_healthy(0.0, 0.0)] * 4 + [_healthy(0.5, 0.3)]),
    "ladder": (dict(min_window=2, rollback_after=2, max_rollbacks=1),
               [_healthy(), _healthy(), SKIPPED, _healthy(), SKIPPED, SKIPPED, SKIPPED, SPIKE]),
    "window slides": (dict(min_window=2, anomaly_window=3),
                      [_healthy(g) for g in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0)] + [SPIKE, _healthy(2.0)]),
    "rollback each": (dict(rollback_after=1, max_rollbacks=3), [SKIPPED, _healthy(), SKIPPED, SKIPPED]),
}


@pytest.mark.parametrize("case", list(GUARD_CASES), ids=list(GUARD_CASES))
def test_health_guard_matches_jax(tmp_path, case):
    """The same stats sequence gives the same actions, grad_norm_cap values,
    budget answers and report(); a rollback is taken whenever asked while
    budget is left, as the trainer does."""
    over, seq = GUARD_CASES[case]
    guards = {
        "jax": jhealth.TrainingHealthGuard(JaxSelfHealingConfig(enabled=True, **over), str(tmp_path / "j")),
        "port": phealth.TrainingHealthGuard(SelfHealingConfig(enabled=True, **over), str(tmp_path / "p")),
    }
    trace = {}
    for who, guard in guards.items():
        out = []
        for step, stats in enumerate(seq):
            cap = guard.grad_norm_cap()
            action = guard.observe(stats, step)
            budget = guard.rollback_budget_left()
            if action == "rollback" and budget:
                guard.on_rollback(step, restored=True)
            out.append((cap, action, budget, guard.consecutive_anomalies, guard._kl_cap()))
        trace[who] = (out, guard.report(), [a["step"] for a in guard.anomalies])
    assert trace["port"] == trace["jax"]


def test_guard_halt_writes_a_bundle(tmp_path):
    guard = phealth.TrainingHealthGuard(SelfHealingConfig(enabled=True, rollback_after=1, max_rollbacks=0),
                                        str(tmp_path / "diag"))
    assert guard.observe(SKIPPED, 1) == "rollback" and not guard.rollback_budget_left()
    with pytest.raises(phealth.TrainingHealthError, match="diagnostics bundle") as ei:
        guard.halt(1, "rollback budget exhausted")
    bundle = str(ei.value).rsplit("diagnostics bundle: ", 1)[1]
    with open(os.path.join(bundle, "bundle.json")) as f:
        payload = json.load(f)
    assert payload["kind"] == "health-halt" and payload["halt_step"] == 1 and len(payload["anomalies"]) == 1
    with open(os.path.join(bundle, "stacks.txt")) as f:
        assert "MainThread" in f.read()


# -------------------------------------------------------- engine and supervisor


def _element(i, version=0):
    return PPORLElement(**_fields(i), policy_version=version)


def _jax_element(i, version=0):
    return JaxElement(**_fields(i), policy_version=version)


def _supervised(pkg, produce_for, tmp_path, make, **kw):
    """A supervisor of package ``pkg`` over engine generations sharing one
    queue, publisher and accountant."""
    pub = pkg.ParameterPublisher(copy_fn=dict)
    pub.publish({"step": 0})
    queue = pkg.ExperienceQueue(16)
    accountant = pkg.StalenessAccountant(max_staleness=8)
    generation = {"n": 0}

    def factory():
        fn = produce_for(generation["n"], make)
        generation["n"] += 1
        return pkg.AsyncRolloutEngine(fn, pub, queue, accountant, close_queue_on_death=False)

    kw.setdefault("backoff_base_s", 0.01)
    kw.setdefault("backoff_max_s", 0.05)
    kw.setdefault("diagnostics_dir", str(tmp_path / "diag"))
    return pkg.ProducerSupervisor(factory, **kw), queue


def _steady(generation, make):
    return lambda params, version: [make(generation)]


@pytest.mark.parametrize("spec,wedge_timeout_s", [("rollout-producer:1", None), ("producer-wedge:1", 0.3),
                                                   ("rollout-producer:1,producer-wedge:1", 0.3)])
def test_supervisor_restarts_match_jax(tmp_path, spec, wedge_timeout_s):
    """The same chaos spec gives the same restart count in both packages'
    supervisors; the port's drain ledger balances and no producer thread is
    left after stop()."""
    restarts = {}
    for who, pkg, monkey, make in (("jax", jrollout, jax_chaos, _jax_element), ("port", prollout, chaos, _element)):
        monkey.configure(spec)
        sup, queue = _supervised(pkg, _steady, tmp_path / who, make, wedge_timeout_s=wedge_timeout_s)
        sup.start()
        try:
            got = sup.collect(4, learner_version=0, timeout=30.0)
        finally:
            stats = sup.stop(timeout=10.0)
        assert len(got) == 4 and queue.closed
        restarts[who] = (sup.restarts, stats["producer_restarts"], [h["reason"].split(":")[0]
                                                                    for h in sup.restart_history])
        assert stats["produced"] == stats["consumed"] + stats["dropped_stale"] + stats["leftover"] + \
            stats["dropped_shutdown"], (who, stats)
        monkey.configure(None)
    assert restarts["port"] == restarts["jax"]
    assert restarts["port"][0] == spec.count(":")
    deadline = time.monotonic() + 5.0
    while any(t.name == "rollout-producer" and t.is_alive() for t in threading.enumerate()):
        assert time.monotonic() < deadline, "a producer thread outlived stop()"
        time.sleep(0.01)


def test_supervisor_restart_budget_fails_closed(tmp_path):
    def crash_for(generation, make):
        def crash(params, version):
            raise RuntimeError("permanent failure")
        return crash

    sup, _ = _supervised(prollout, crash_for, tmp_path, _element, max_restarts=2, wedge_timeout_s=None)
    sup.start()
    try:
        with pytest.raises(prollout.ProducerRestartBudgetExceeded, match="diagnostics bundle") as ei:
            sup.collect(1, learner_version=0, timeout=30.0)
    finally:
        sup.stop(timeout=10.0)
    assert sup.restarts == 3 and gauges.get("resilience/restarts") == 3.0
    bundle = str(ei.value).rsplit("diagnostics bundle: ", 1)[1]
    with open(os.path.join(bundle, "bundle.json")) as f:
        payload = json.load(f)
    assert payload["kind"] == "producer-restart-budget" and payload["max_restarts"] == 2
    assert len(payload["restart_history"]) == 2 and os.path.isfile(os.path.join(bundle, "stacks.txt"))


def test_producer_wedge_site_parks_silently_until_abandoned():
    chaos.configure("producer-wedge:1")
    pub = prollout.ParameterPublisher(copy_fn=dict)
    pub.publish({})
    queue = prollout.ExperienceQueue(4)
    engine = prollout.AsyncRolloutEngine(lambda p, v: [_element(0)], pub, queue,
                                         prollout.StalenessAccountant(8), close_queue_on_death=False)
    engine.start()
    with pytest.raises(TimeoutError):
        engine.collect(1, learner_version=0, timeout=0.3)
    assert engine.running  # alive and silent: the failure no exception models
    engine.abandon()
    assert not engine.join(5.0) and not engine.running
    assert not queue.closed  # the shared queue stays open for a successor


def test_unsupervised_engine_closes_the_queue_on_death():
    chaos.configure("rollout-producer:1")
    pub = prollout.ParameterPublisher(copy_fn=dict)
    pub.publish({})
    queue = prollout.ExperienceQueue(4)
    engine = prollout.AsyncRolloutEngine(lambda p, v: [_element(0)], pub, queue, prollout.StalenessAccountant(8))
    engine.start()
    with pytest.raises(RuntimeError, match="producer died"):
        engine.collect(1, learner_version=0, timeout=10.0)
    assert queue.closed
    with pytest.raises(RuntimeError):
        engine.stop(timeout=5.0)


def test_watchdog_escalation_fires_once_per_episode():
    calls = []
    wd = StallWatchdog(timeout_s=0.05, poll_s=100.0)  # polled by hand, no thread
    wd.escalate("prod", lambda name, age: calls.append(name))
    wd.beat("prod")
    late = time.monotonic() + 1.0
    wd.check(now=late)
    wd.check(now=late)  # the same episode fires once
    assert calls == ["prod"]
    wd.beat("prod")
    wd.check(now=time.monotonic() + 1.0)
    assert calls == ["prod", "prod"]
    wd.escalate("prod", lambda name, age: 1 / 0)  # a raising hook must not kill the check
    wd.beat("prod")
    wd.check(now=time.monotonic() + 1.0)
    wd.escalate("prod", None)
    wd.beat("prod")
    wd.check(now=time.monotonic() + 1.0)
    assert calls == ["prod", "prod"] and wd.stall_count == 4


def test_supervisor_restarts_on_watchdog_escalation(tmp_path):
    """Stale producer heartbeat -> the installed watchdog's escalation ->
    a supervisor restart, with the wedge timer off."""
    chaos.configure("producer-wedge:1")
    impl = StallWatchdog(timeout_s=0.2, poll_s=0.05)
    watchdog.install(impl)
    impl.start()
    sup, _ = _supervised(prollout, _steady, tmp_path, _element, wedge_timeout_s=None)
    sup.start()
    try:
        assert len(sup.collect(2, learner_version=0, timeout=30.0)) == 2
        assert sup.restarts == 1 and "watchdog escalation" in sup.restart_history[0]["reason"]
    finally:
        sup.stop(timeout=10.0)
        watchdog.install(None)


# ------------------------------------------------------ trainers: the step


def _config_dict(tmp_path, **train):
    d = dict(
        method=dict(
            name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05,
            target=6.0, horizon=1000, gen_kwargs=dict(max_new_tokens=5, do_sample=False),
        ),
        train=dict(
            seq_length=16, epochs=20, total_steps=4, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False,
            self_healing=dict(enabled=True),
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=-1,
            model_overrides=dict(vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
                                 intermediate_size=64, max_position_embeddings=64, attention_impl="flash"),
        ),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4,
                                                  max_grad_norm=1.0)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )
    d["train"].update(train)
    return d


@pytest.fixture
def single_device_mesh(monkeypatch):
    """Pin JAX trainer meshes to the first of conftest's 8 virtual CPU devices."""
    from trlx_tpu.parallel import mesh as mesh_lib

    real = mesh_lib.make_mesh
    monkeypatch.setattr(
        mesh_lib, "mesh_from_config",
        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]),
    )


def _attach(trainer, pipeline_cls):
    trainer.add_prompt_pipeline(pipeline_cls(PROMPTS, 11, trainer.tokenizer))
    trainer.add_eval_pipeline(pipeline_cls(PROMPTS[:4], 11, trainer.tokenizer))


def _record_and_poison_step3(trainer, monkey, snapshot=None):
    """Record every step's stats and each phase's elements; arm
    ``nan-loss:1`` in ``monkey`` once step 2 is done, so step 3 (with AdamW
    state behind it) is the poisoned one. ``snapshot(trainer)`` runs before
    and after every step."""
    rec = {"steps": [], "phases": [], "around": []}
    step, push = trainer.train_step, trainer.push_to_store

    def train_step(batch):
        before = snapshot(trainer) if snapshot else None
        out = step(batch)
        rec["steps"].append(dict(out))
        if snapshot:
            rec["around"].append((before, snapshot(trainer)))
        if len(rec["steps"]) == 2:
            monkey.configure("nan-loss:1")
        return out

    def push_to_store(data):
        rec["phases"].append(list(data))
        return push(data)

    trainer.train_step, trainer.push_to_store = train_step, push_to_store
    return rec


def _port_state(trainer):
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()} for i, s in trainer.optimizer.state_dict()["state"].items()},
            trainer.scheduler.last_epoch)


def test_skipped_step_matches_jax(tmp_path, single_device_mesh):
    """Both trainers with self_healing, one batch poisoned (step 3): the
    same ``health/update_applied`` sequence (1, 1, 0, 1); the port's
    parameters, AdamW state and schedule unchanged across step 3, and the
    learning rate of step 4 that of step 3 in both packages; every other
    stat within the trainer-parity limits (NaN where the JAX step reports
    NaN)."""
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    jt = jax_get_trainer("PPOTrainer")(config=JaxConfig.from_dict(_config_dict(tmp_path / "jax")),
                                       reward_fn=reward_fn)
    _attach(jt, JaxPipeline)
    pt = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path / "port")),
                                   reward_fn=reward_fn, device="cpu")
    _attach(pt, PromptPipeline)
    pt.model.load_state_dict(policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)),
                                                    pt.model_config))
    pt.ref_model.load_state_dict(pt.model.transformer.state_dict())

    jrec = _record_and_poison_step3(jt, jax_chaos)
    prec = _record_and_poison_step3(pt, chaos, snapshot=_port_state)
    jt.learn()
    pt.learn()

    applied = [[s["health/update_applied"] for s in r["steps"]] for r in (jrec, prec)]
    assert applied[0] == applied[1] == [1.0, 1.0, 0.0, 1.0]
    assert pt.self_healing_summary == jt.self_healing_summary == {
        "producer_restarts": 0, "skipped_updates": 1, "rollbacks": 0, "anomalies": 1, "quarantined": 0}
    (p_before, o_before, e_before), (p_after, o_after, e_after) = prec["around"][2]
    assert all(torch.equal(p_before[k], p_after[k]) for k in p_before)
    assert o_before and all(torch.equal(o_before[i][k], o_after[i][k]) for i in o_before for k in o_before[i])
    assert e_before == e_after
    for rec in (jrec, prec):
        lrs = [s["learning_rate_group_0"] for s in rec["steps"]]
        assert lrs[3] == lrs[2] != lrs[1]
    for jphase, pphase in zip(jrec["phases"], prec["phases"]):
        for je, pe in zip(jphase, pphase):
            np.testing.assert_array_equal(np.asarray(pe.response_tensor), np.asarray(je.response_tensor))
            for field in ("logprobs", "values", "rewards"):
                np.testing.assert_allclose(getattr(pe, field), np.asarray(getattr(je, field)), **ELEMENT_TOL)
    for i, (js, ps) in enumerate(zip(jrec["steps"], prec["steps"])):
        compared = [k for k in js if k.split("/")[0] in (
            "losses", "values", "policy", "ratio", "learning_rate_group_0", "health")]
        assert len(compared) >= 10
        for key in compared:
            np.testing.assert_allclose(ps[key], float(js[key]), err_msg=f"step {i + 1} {key}", equal_nan=True,
                                       **STAT_TOL)


def test_disabled_self_healing_leaves_the_step_as_it_was(tmp_path):
    """self_healing present but off (every other knob changed) trains the
    same bits as the default config, reports no health stats and builds no
    guard or quarantine."""
    import trlx_tpu_torch.data.configs as configs

    runs = []
    for sh in (None, dict(enabled=False, rollback_after=1, max_rollbacks=0, min_window=1,
                          grad_norm_spike_factor=1.0, wedge_timeout_s=0.1)):
        d = _config_dict(tmp_path / str(len(runs)))
        del d["train"]["self_healing"]
        if sh is not None:
            d["train"]["self_healing"] = sh
        cfg = configs.TRLConfig.from_dict(d)
        assert not cfg.train.self_healing.enabled
        runs.append(trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=PROMPTS[:4],
                                         config=cfg, device="cpu"))
    a, b = runs
    assert b.health is None and b._quarantine is None and b.self_healing_summary is None
    assert gauges.snapshot("resilience/") == {}
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k


# ------------------------------------------------ trainers: the ladder e2e


def _train(tmp_path, **overrides):
    from trlx_tpu_torch.data.configs import TRLConfig

    cfg = TRLConfig.update(TRLConfig.from_dict(_config_dict(tmp_path)), overrides)
    return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=PROMPTS[:4], config=cfg,
                                device="cpu")


@pytest.mark.parametrize("async_writer", [False, True], ids=["sync_save", "async_writer"])
def test_rollback_restores_the_last_committed_checkpoint(tmp_path, monkeypatch, async_writer):
    """nan-loss:4 with rollback_after 2 and a checkpoint every step (the JAX
    test's case): steps 1 and 2 skipped -> rollback #1 to checkpoint 1; the
    retried step 2 and step 3 skipped -> rollback #2 to checkpoint 2; the
    budget of 4 is spent and the run reaches step 4 with finite
    parameters, as the JAX test counts it; with the async writer the
    rollback waits for the in-flight commit and restores it."""
    monkeypatch.setenv("TRLX_CHAOS", "nan-loss:4")
    trainer = _train(tmp_path, **{"train.checkpoint_interval": 1,
                                  "train.self_healing": dict(enabled=True, rollback_after=2, max_rollbacks=3),
                                  "train.resilience": dict(enabled=async_writer, preemption_handling=False)})
    assert trainer.iter_count == 4
    assert trainer.self_healing_summary == {"producer_restarts": 0, "skipped_updates": 4, "rollbacks": 2,
                                            "anomalies": 4, "quarantined": 0}
    assert all(torch.isfinite(v).all() for v in trainer.model.state_dict().values())


def test_halt_fails_closed_with_a_diagnostics_bundle(tmp_path, monkeypatch):
    monkeypatch.setenv("TRLX_CHAOS", "nan-loss:12")
    with pytest.raises(phealth.TrainingHealthError, match="diagnostics bundle") as ei:
        _train(tmp_path, **{"train.self_healing": dict(enabled=True, rollback_after=1, max_rollbacks=1)})
    bundle = str(ei.value).rsplit("diagnostics bundle: ", 1)[1]
    assert bundle.startswith(os.path.join(str(tmp_path / "ckpts"), "diagnostics"))
    with open(os.path.join(bundle, "bundle.json")) as f:
        payload = json.load(f)
    assert payload["kind"] == "health-halt" and payload["rollbacks"] == 1 and payload["anomalies"]
    assert payload["chaos_injected"]["nan-loss"] >= 2 and os.path.isfile(os.path.join(bundle, "stacks.txt"))


def test_bad_element_is_quarantined(tmp_path, monkeypatch):
    monkeypatch.setenv("TRLX_CHAOS", "bad-element:1")
    trainer = _train(tmp_path, **{"train.total_steps": 2})
    path = os.path.join(str(tmp_path / "ckpts"), "quarantine", "quarantine.jsonl")
    with open(path) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1 and records[0]["reason"] == "non-finite logprobs"
    assert trainer.self_healing_summary["quarantined"] == 1


def test_chaos_soak_async_end_to_end(tmp_path, monkeypatch):
    """The JAX package's acceptance soak on the port: producer deaths
    (rollout-producer and a reward fault, each killing one generation),
    poisoned batches and corrupted elements in one async run, which must
    finish with every recovery counted as the JAX test counts it."""
    monkeypatch.setenv("TRLX_CHAOS", "rollout-producer:2,nan-loss:2,bad-element:3,reward:1")
    trainer = _train(tmp_path, **{
        "method.gen_kwargs": dict(max_new_tokens=5, do_sample=True, top_k=0, top_p=1.0),
        "method.num_rollouts": 4, "method.chunk_size": 4,
        "train.self_healing": dict(enabled=True, max_producer_restarts=8, restart_backoff_base_s=0.01,
                                   restart_backoff_max_s=0.05, wedge_timeout_s=None),
        "train.async_rollouts": dict(enabled=True, max_staleness=4, queue_capacity=32)})
    assert trainer.iter_count == 4
    assert trainer.self_healing_summary == {"producer_restarts": 3, "skipped_updates": 2, "rollbacks": 0,
                                            "anomalies": 2, "quarantined": 3}
    assert chaos.stats() == {"rollout-producer": 2, "nan-loss": 2, "bad-element": 3, "reward": 1}
    s = trainer.rollout_engine_summary
    assert s["producer_restarts"] == 3
    assert s["produced"] == s["consumed"] + s["dropped_stale"] + s["leftover"] + s["dropped_shutdown"]
    assert not any(t.name == "rollout-producer" and t.is_alive() for t in threading.enumerate())


def test_wedged_producer_is_restarted_by_the_wedge_timer(tmp_path, monkeypatch):
    monkeypatch.setenv("TRLX_CHAOS", "producer-wedge:1")
    trainer = _train(tmp_path, **{
        "train.total_steps": 2,
        "train.self_healing": dict(enabled=True, restart_backoff_base_s=0.01, wedge_timeout_s=3.0),
        "train.async_rollouts": dict(enabled=True, max_staleness=4)})
    # >= 1: a produce call slower than the timer on a loaded host also reads as a wedge
    assert trainer.iter_count == 2 and trainer.self_healing_summary["producer_restarts"] >= 1
    assert chaos.stats() == {"producer-wedge": 1}
    assert not any(t.name == "rollout-producer" and t.is_alive() for t in threading.enumerate())


def test_post_rollback_restore_republishes_and_replays_the_prompt_stream(tmp_path):
    """A mid-run restore: the prompt stream continues from the checkpoint's
    position, as the uninterrupted stream does, and the store is emptied;
    under async rollouts the restored weights are published as a new
    snapshot (so the producer, and a serving engine it rolls out through,
    installs them)."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    for rollouts in ("sync", "async"):
        cfg = TRLConfig.update(TRLConfig.from_dict(_config_dict(tmp_path / rollouts)), {
            "train.async_rollouts": dict(enabled=rollouts == "async", max_staleness=4)})
        trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")
        _attach(trainer, PromptPipeline)
        try:
            trainer.prepare_learning()
            drawn = trainer._prompt_batches_drawn
            trainer.save(str(tmp_path / rollouts / "ck"))
            saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            version = trainer._policy_version
            trainer.train_step(next(iter(trainer.create_train_dataloader())))
            trainer.post_backward_callback()
            if rollouts == "sync":
                # the stream after the checkpoint
                expect = [[list(p) for p in next(trainer.prompt_iterator)["input_ids"]] for _ in range(2)]
            trainer.load(str(tmp_path / rollouts / "ck"))
            trainer._post_rollback_restore()
            assert all(torch.equal(v, saved[k]) for k, v in trainer.model.state_dict().items())
            assert len(trainer.store) == 0  # experience of the bad policy dropped
            if rollouts == "sync":
                assert trainer._prompt_batches_drawn == drawn
                assert [[list(p) for p in next(trainer.prompt_iterator)["input_ids"]] for _ in range(2)] == expect
                continue
            assert trainer._policy_version > version
            latest_version, snapshot = trainer._engine.publisher.latest()
            assert latest_version == trainer._policy_version
            assert all(torch.equal(snapshot[k], v) for k, v in saved.items())
            assert not any(snapshot[k] is v for k, v in trainer.model.state_dict().items())  # a copy
        finally:
            trainer.on_learn_end()
            trainer.resilience.close()


def test_grpo_quarantine_drops_mid_chunk(tmp_path, monkeypatch):
    """GRPO scores whole groups, then the inherited assembly screens them:
    ``bad-element:1`` drops one element of a group into the quarantine
    file, the phase tops up to ``num_rollouts`` and the run trains."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer

    monkeypatch.setenv("TRLX_CHAOS", "bad-element:1")
    d = _config_dict(tmp_path, total_steps=2, trainer="GRPOTrainer")
    d["method"].update(name="GRPOConfig", group_size=2,
                       gen_kwargs=dict(max_new_tokens=5, do_sample=True, top_k=0, top_p=1.0))
    pushed = []
    push = GRPOTrainer.push_to_store
    monkeypatch.setattr(GRPOTrainer, "push_to_store", lambda self, data: (pushed.append(len(data)), push(self, data)))
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=PROMPTS[:4],
                                   config=TRLConfig.from_dict(d), device="cpu")
    assert isinstance(trainer, GRPOTrainer) and trainer.iter_count == 2
    with open(os.path.join(str(tmp_path / "ckpts"), "quarantine", "quarantine.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1 and records[0]["reason"] == "non-finite logprobs"
    assert pushed and all(n == 8 for n in pushed)  # topped up to num_rollouts
    assert trainer.self_healing_summary["quarantined"] == 1
