"""Port parity for async rollouts: trlx_tpu_torch's ``rollout`` package
(queue, publisher, staleness accountant and importance weights, the
producer engine, ``length_bucketed``) case by case as
``tests/test_async_rollout.py`` runs trlx_tpu's, with the weights and the
prompt reordering held against the JAX functions on the same inputs; the
PPO loss bit-identical at zero staleness; the config round trip; two
threads loading a kernel library at once; and a tiny async PPO
``train(device="cpu")`` end to end (no thread left, the drain ledger
balanced), beside the overlapped reward scoring equal to the serial path.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from trlx_tpu_torch.data.ppo_types import PPORLElement
from trlx_tpu_torch.rollout import (
    AsyncRolloutEngine,
    ExperienceQueue,
    ParameterPublisher,
    QueueClosed,
    StalenessAccountant,
    length_bucketed,
    staleness_importance_weights,
)

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]


def make_element(i: int, version: int = 0) -> PPORLElement:
    return PPORLElement(
        query_tensor=np.array([i, i + 1], np.int32), response_tensor=np.array([i + 2], np.int32),
        logprobs=np.array([-0.5], np.float32), values=np.array([0.1], np.float32),
        rewards=np.array([1.0], np.float32), policy_version=version,
    )


# ------------------------------------------------------------------ queue


def test_queue_fifo_and_counters():
    q = ExperienceQueue(capacity=8)
    q.put(["a", "b", "c"])
    assert q.get(2) == ["a", "b"]
    assert q.get(5, timeout=0.05) == ["c"]
    s = q.stats()
    assert s["total_put"] == 3 and s["total_got"] == 3 and s["depth"] == 0 and s["peak_depth"] == 3


def test_queue_capacity_bound_blocks_put():
    q = ExperienceQueue(capacity=4)
    assert q.put([1, 2, 3, 4])
    assert q.put([5], timeout=0.05) is False
    with pytest.raises(ValueError):
        q.put(list(range(5)))
    done = threading.Event()
    t = threading.Thread(target=lambda: (q.put([5]), done.set()), daemon=True)
    t.start()
    assert not done.wait(0.05)
    q.get(4)
    assert done.wait(2.0)
    t.join(2.0)
    assert q.stats()["peak_depth"] <= q.capacity


def test_queue_watermark_hysteresis():
    q = ExperienceQueue(capacity=8, high_watermark=4, low_watermark=2)
    q.put([1, 2, 3])
    assert not q.gated
    q.put([4])
    assert q.gated and q.put([9], timeout=0.05) is False
    q.get(1)
    assert q.gated
    q.get(1)
    assert not q.gated and q.put([9], timeout=0.5)


def test_queue_watermark_validation():
    for kw in (dict(capacity=0), dict(capacity=4, high_watermark=2, low_watermark=3),
               dict(capacity=4, high_watermark=8)):
        with pytest.raises(ValueError):
            ExperienceQueue(**kw)


def test_queue_close_drains_then_empties():
    q = ExperienceQueue(capacity=8)
    q.put([1, 2, 3])
    q.close()
    with pytest.raises(QueueClosed):
        q.put([4])
    assert q.get(2) == [1, 2] and q.get(2) == [3] and q.get(2) == []
    q.close()


def test_queue_close_wakes_blocked_waiters():
    q, q2 = ExperienceQueue(capacity=1), ExperienceQueue(capacity=1)
    q.put([1])
    results = {}

    def blocked_put():
        try:
            q.put([2])
        except QueueClosed:
            results["put"] = "closed"

    def blocked_get():
        results["got"] = q2.get(1)

    threads = [threading.Thread(target=f, daemon=True) for f in (blocked_put, blocked_get)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    q.close()
    q2.close()
    for t in threads:
        t.join(2.0)
    assert results == {"put": "closed", "got": []}


# -------------------------------------------------------------- publisher


def test_publisher_versions_monotonic_from_zero():
    pub = ParameterPublisher()
    with pytest.raises(RuntimeError):
        pub.latest()
    assert pub.version == -1
    params = {"w": torch.ones(3)}
    assert [pub.publish(params) for _ in range(3)] == [0, 1, 2]
    v, snap = pub.latest()
    assert v == 2 and torch.equal(snap["w"], torch.ones(3))


@pytest.mark.parametrize("requires_grad", [True, False])
def test_publisher_snapshot_isolated_from_source(requires_grad):
    pub = ParameterPublisher()
    w = torch.zeros(3, requires_grad=requires_grad)
    pub.publish({"w": w})
    with torch.no_grad():
        w += 7.0  # the learner keeps changing its live parameters in place
    _, snap = pub.latest()
    assert torch.equal(snap["w"], torch.zeros(3)) and not snap["w"].requires_grad


def test_publisher_custom_copy_fn():
    calls = []
    pub = ParameterPublisher(copy_fn=lambda tree: calls.append(1) or dict(tree))
    pub.publish({"w": 1})
    assert calls == [1]


# -------------------------------------------------------------- staleness


def test_staleness_accountant_caps_and_counts():
    acc = StalenessAccountant(max_staleness=1)
    fresh, dropped = acc.admit([make_element(i, version=v) for i, v in enumerate([5, 4, 3, 0])], learner_version=5)
    assert len(fresh) == 2 and dropped == 2 and [int(e.policy_version) for e in fresh] == [5, 4]
    s = acc.stats()
    assert s["admitted"] == 2 and s["dropped_stale"] == 2 and s["staleness_mean"] == pytest.approx(0.5)
    assert s["staleness_max"] == 1 and s["staleness_last_max"] == 1


def test_staleness_accountant_matches_jax():
    from trlx_tpu.rollout import StalenessAccountant as JaxAccountant

    rng = np.random.default_rng(0)
    versions = rng.integers(0, 6, size=40).tolist()
    t, j = StalenessAccountant(2), JaxAccountant(2)
    for lv, chunk in ((5, versions[:20]), (7, versions[20:])):
        els = [SimpleNamespace(policy_version=v) for v in chunk]
        tf, td = t.admit(els, lv)
        jf, jd = j.admit(els, lv)
        assert tf == jf and td == jd
    assert t.stats() == j.stats()


def test_staleness_accountant_validation_and_missing_version():
    with pytest.raises(ValueError):
        StalenessAccountant(max_staleness=-1)
    assert StalenessAccountant.element_staleness(SimpleNamespace(), 3) == 3
    assert StalenessAccountant.element_staleness(SimpleNamespace(policy_version=None), 3) == 3
    assert StalenessAccountant.element_staleness(SimpleNamespace(policy_version=9), 3) == 0


def test_importance_weights_identity_at_zero_staleness():
    log_ratio = torch.from_numpy(np.random.default_rng(0).normal(scale=0.7, size=(4, 5)).astype(np.float32))
    w = staleness_importance_weights(log_ratio, torch.zeros(4, dtype=torch.int32), 2.0)
    assert torch.equal(w, torch.ones(4, 5))  # exact, not approx


@pytest.mark.parametrize("shape", ["per_row", "per_token"])
def test_importance_weights_match_jax(shape):
    import jax.numpy as jnp

    from trlx_tpu.rollout import staleness_importance_weights as jax_weights

    rng = np.random.default_rng(1)
    log_ratio = rng.normal(scale=1.5, size=(6, 5)).astype(np.float32)
    staleness = rng.integers(0, 3, size=(6,) if shape == "per_row" else (6, 5)).astype(np.int32)
    lr = torch.from_numpy(log_ratio).requires_grad_(True)
    w = staleness_importance_weights(lr, torch.from_numpy(staleness), 2.0)
    jw = np.asarray(jax_weights(jnp.asarray(log_ratio), jnp.asarray(staleness), 2.0))
    np.testing.assert_allclose(w.detach().numpy(), jw, rtol=1e-6, atol=1e-6)
    assert not w.requires_grad  # a fixed reweighting, no gradient path
    fresh = (staleness == 0) if shape == "per_token" else (staleness == 0)[:, None].repeat(5, 1)
    assert np.all(w.detach().numpy()[fresh] == 1.0)
    with pytest.raises(ValueError):
        staleness_importance_weights(lr, torch.from_numpy(staleness), 0.5)


def test_ppo_loss_bitwise_identical_at_zero_staleness():
    from trlx_tpu_torch.methods.ppo import PPOConfig

    rng = np.random.default_rng(1)
    B, T = 4, 6

    def arr(scale=1.0):
        return torch.from_numpy((rng.normal(size=(B, T)) * scale).astype(np.float32))

    mask = torch.from_numpy(rng.integers(0, 2, size=(B, T)).astype(np.float32))
    kwargs = dict(logprobs=arr(0.5), values=arr(), old_logprobs=arr(0.5), old_values=arr(),
                  advantages=arr(), returns=arr(), mask=mask)
    method = PPOConfig()
    loss_vanilla, stats_vanilla = method.loss(**kwargs)
    loss_zero, stats_zero = method.loss(staleness=torch.zeros(B, dtype=torch.int32), is_ratio_clip=2.0, **kwargs)
    assert loss_vanilla.numpy().tobytes() == loss_zero.numpy().tobytes()
    assert stats_vanilla["losses"]["policy_loss"].numpy().tobytes() == \
        stats_zero["losses"]["policy_loss"].numpy().tobytes()
    assert "staleness" not in stats_vanilla and "staleness" in stats_zero
    loss_stale, stats_stale = method.loss(staleness=torch.ones(B, dtype=torch.int32), is_ratio_clip=2.0, **kwargs)
    assert float(loss_stale) != float(loss_vanilla) and float(stats_stale["staleness"]["mean"]) == 1.0


# --------------------------------------------------------- length buckets


@pytest.mark.parametrize("lookahead", [0, 1, 3, 4])
def test_length_bucketed_matches_jax(lookahead):
    from trlx_tpu.rollout.engine import length_bucketed as jax_length_bucketed

    rng = np.random.default_rng(2)
    batches = [{"input_ids": [list(range(int(n))) for n in rng.integers(1, 20, size=4)],
                "meta": [f"b{b}r{r}" for r in range(4)]} for b in range(10)]
    ours = list(length_bucketed(iter(batches), lookahead))
    theirs = list(jax_length_bucketed(iter(batches), lookahead))
    assert ours == theirs and len(ours) == 10
    if lookahead > 1:  # each window sorted by length, the same prompts drawn
        window = [len(p) for b in ours[:lookahead] for p in b["input_ids"]]
        assert window == sorted(window)


# ----------------------------------------------------------------- engine


def build_engine(produce_fn, capacity=16, max_staleness=8, **queue_kwargs):
    pub = ParameterPublisher(copy_fn=dict)
    pub.publish({"step": 0})
    q = ExperienceQueue(capacity, **queue_kwargs)
    acc = StalenessAccountant(max_staleness)
    return AsyncRolloutEngine(produce_fn, pub, q, acc), pub, q, acc


def test_engine_produces_tags_and_observes_staleness():
    counter = {"n": 0}

    def produce(params, version):
        counter["n"] += 1
        return [make_element(counter["n"])]

    engine, pub, q, acc = build_engine(produce, capacity=8, high_watermark=4)
    engine.start()
    try:
        first = engine.collect(2, learner_version=0, timeout=10.0)
        assert len(first) == 2 and all(int(e.policy_version) == 0 for e in first)
        deadline = time.monotonic() + 10.0
        while q.qsize() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert q.qsize() >= 2
        pub.publish({"step": 1})
        learner_version = pub.publish({"step": 2})
        batch = engine.collect(4, learner_version=learner_version, timeout=10.0)
        assert max(StalenessAccountant.element_staleness(e, learner_version) for e in batch) > 0
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            e = engine.collect(1, learner_version=learner_version, timeout=10.0)[0]
            if int(e.policy_version) == learner_version:
                break
        else:
            pytest.fail("producer never picked up the published snapshot")
    finally:
        summary = engine.stop(timeout=10.0)
    assert not engine.running and q.closed
    assert summary["peak_queue_depth"] <= q.capacity
    assert summary["produced"] == (summary["consumed"] + summary["dropped_stale"] + summary["leftover"]
                                   + summary["dropped_shutdown"])
    assert 0.0 <= summary["overlap_fraction"] <= 1.0


def test_engine_collect_drops_stale_and_refills():
    engine, pub, q, acc = build_engine(lambda params, version: [make_element(0)], max_staleness=1)
    engine.start()
    try:
        for _ in range(3):
            learner_version = pub.publish({})
        batch = engine.collect(2, learner_version=learner_version, timeout=15.0)
        assert len(batch) == 2
        assert all(StalenessAccountant.element_staleness(e, learner_version) <= 1 for e in batch)
    finally:
        engine.stop(timeout=10.0)


def test_engine_producer_crash_surfaces_in_collect_and_stop():
    def produce(params, version):
        raise RuntimeError("synthetic producer failure")

    engine, pub, q, acc = build_engine(produce)
    engine.start()
    with pytest.raises(RuntimeError, match="producer died"):
        engine.collect(1, learner_version=0, timeout=10.0)
    with pytest.raises(RuntimeError, match="producer died"):
        engine.stop(timeout=10.0)
    assert not engine.running and q.closed


def test_engine_holds_pause_lock_during_produce():
    observed = {}

    def produce(params, version):
        observed["locked"] = engine._pause_lock.locked()
        return [make_element(0)]

    engine, pub, q, acc = build_engine(produce)
    engine.start()
    try:
        engine.collect(1, learner_version=0, timeout=10.0)
        assert observed["locked"] is True
    finally:
        engine.stop(timeout=10.0)
    with engine.paused():
        pass


def test_engine_collect_timeout():
    never = threading.Event()

    def produce(params, version):
        never.wait(30.0)
        return []

    engine, pub, q, acc = build_engine(produce)
    engine.start()
    try:
        with pytest.raises(TimeoutError):
            engine.collect(1, learner_version=0, timeout=0.3)
    finally:
        never.set()
        engine.stop(timeout=10.0)


# ----------------------------------------------------------------- config


def test_async_rollout_config_roundtrip_and_dotted_update():
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    config = default_ppo_config()
    assert config.train.async_rollouts.enabled is False
    d = config.to_dict()
    assert d["train"]["async_rollouts"]["max_staleness"] == 1
    assert TRLConfig.from_dict(d).to_dict() == d
    new = TRLConfig.update(d, {"train.async_rollouts.enabled": True, "train.async_rollouts.max_staleness": 3})
    assert new.train.async_rollouts.enabled is True and new.train.async_rollouts.max_staleness == 3
    with pytest.raises(ValueError):
        TRLConfig.update(d, {"train.async_rollouts.bogus_knob": 1})


def test_rollout_storage_concurrent_push():
    from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage

    store = PPORolloutStorage(pad_token_id=0)

    def pusher(t):
        for i in range(50):
            store.push([make_element(t * 50 + i)])

    threads = [threading.Thread(target=pusher, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert len(store) == 400
    store.clear_history()
    assert len(store) == 0


# ------------------------------------------------- kernels from two threads


def test_first_kernel_load_from_two_threads_builds_and_loads_once(monkeypatch, tmp_path):
    """The learner and the producer may make a kernel's first launch at
    once: ``_kernels.library`` builds and loads each source exactly once
    under its lock, and both threads get the same library. (CPU side: the
    build and the loader are stand-ins; nothing is compiled.)"""
    from trlx_tpu_torch.ops import _kernels

    builds, loads = [], []

    def slow_build(names):
        builds.append(list(names))
        time.sleep(0.2)  # wide window for a racing second caller
        return {}

    class FakeLib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            return SimpleNamespace(argtypes=None, restype=None)

    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setattr(_kernels, "_bound", set())
    monkeypatch.setattr(_kernels, "build", slow_build)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", FakeLib)
    barrier, got = threading.Barrier(2), []

    def first_launch(name):
        barrier.wait()
        got.append(_kernels.library(name))

    threads = [threading.Thread(target=first_launch, args=(n,)) for n in ("flash_bwd_dkv", "flash_bwd_dq")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 2 and got[0] is got[1]
    assert _kernels._bound == {"flash_bwd_dkv", "flash_bwd_dq"}


def test_launch_counter_is_exact_under_two_threads(monkeypatch):
    from trlx_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "LAUNCHES", {name: 0 for name in _kernels.KERNELS})

    def hammer():
        for _ in range(20000):
            _kernels.count_launch("flash_fwd")

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert _kernels.launches()["flash_fwd"] == 80000


# ------------------------------------------------------------- end to end


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def _config(tmp_path, **over):
    from trlx_tpu_torch.data.configs import TRLConfig

    d = dict(
        method=dict(name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.01, target=None,
                    gen_kwargs=dict(max_new_tokens=6, do_sample=True, top_k=0, top_p=1.0)),
        train=dict(seq_length=16, epochs=100, total_steps=6, batch_size=4, minibatch_size=2,
                   checkpoint_interval=100, eval_interval=3, checkpoint_dir=str(tmp_path / "ckpts"),
                   pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False),
        model=dict(model_path="gpt2", num_layers_unfrozen=-1,
                   model_overrides=dict(vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
                                        intermediate_size=64, max_position_embeddings=64, attention_impl="flash")),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=8, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )
    return TRLConfig.update(TRLConfig.from_dict(d), over)


def test_async_ppo_train_end_to_end(tmp_path):
    """A tiny async PPO run through ``train(device="cpu")``: experience is
    consumed with observed staleness (the IS branch runs), evaluate pauses
    the producer, the producer never touches the learner's model, no
    producer thread outlives learn(), and the drain ledger balances."""
    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    cfg = _config(tmp_path, **{"train.async_rollouts.enabled": True, "train.async_rollouts.max_staleness": 2,
                               "train.async_rollouts.queue_capacity": 32})
    steps, original = [], PPOTrainer.train_step
    t0 = time.perf_counter()
    try:
        PPOTrainer.train_step = lambda self, b: steps.append(original(self, b)) or steps[-1]
        trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=PROMPTS[:2], config=cfg,
                                       device="cpu")
    finally:
        PPOTrainer.train_step = original
    assert time.perf_counter() - t0 < 30.0
    assert trainer.iter_count == 6 and trainer._engine is None
    assert not any(t.name == "rollout-producer" and t.is_alive() for t in threading.enumerate())
    s = trainer.rollout_engine_summary
    assert s["produced"] == s["consumed"] + s["dropped_stale"] + s["leftover"] + s["dropped_shutdown"]
    assert s["consumed"] >= 8 * 2
    assert trainer._producer_model is not trainer.model
    assert all("staleness/is_weight_mean" in out for out in steps)
    assert max(out["rollout/batch_staleness_max"] for out in steps) >= 1
    assert all(np.isfinite(out["losses/total_loss"]) for out in steps)


@pytest.mark.parametrize("max_staleness", [0, 2])
def test_async_engine_starts_only_above_zero_staleness(tmp_path, max_staleness):
    """max_staleness=0 is the synchronous path itself (no producer);
    above it, prepare_learning publishes version 0 and fills the store."""
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = _config(tmp_path, **{"train.async_rollouts.enabled": True,
                               "train.async_rollouts.max_staleness": max_staleness})
    trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")
    trainer.add_prompt_pipeline(PromptPipeline(PROMPTS, 10, trainer.tokenizer))
    try:
        trainer.prepare_learning()
        assert len(trainer.store) == 8
        assert (trainer._engine is not None) == (max_staleness > 0)
    finally:
        trainer.on_learn_end()
    assert not any(t.name == "rollout-producer" and t.is_alive() for t in threading.enumerate())


def test_overlap_reward_scoring_equals_the_serial_path(tmp_path):
    """method.overlap_reward_scoring (reward_fn on a worker thread while the
    next chunk generates) stores the same experience as the serial path:
    greedy rollouts, the same weights."""
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    stores = []
    for overlap in (False, True):
        cfg = _config(tmp_path / str(overlap), **{
            "method.overlap_reward_scoring": overlap, "method.chunk_size": 2, "method.decode_batch_size": 4,
            "method.gen_kwargs": dict(max_new_tokens=6, do_sample=False)})
        trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")
        trainer.add_prompt_pipeline(PromptPipeline(PROMPTS, 10, trainer.tokenizer))
        trainer.make_experience(8, 0)
        stores.append(list(trainer.store.history))
    assert len(stores[0]) == len(stores[1]) == 8
    for a, b in zip(*stores):
        for field in ("query_tensor", "response_tensor", "logprobs", "values", "rewards"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_async_ppo_through_the_serving_engine(tmp_path):
    """Async rollouts with ``train.serving``: the producer thread alone
    drives the engine, installs each new snapshot once (the prefix cache
    flushes with it), and the engine holds no KV block after learn()."""
    import trlx_tpu_torch
    from trlx_tpu_torch.serving import ServingEngine

    cfg = _config(tmp_path, **{"train.async_rollouts.enabled": True, "train.async_rollouts.max_staleness": 2,
                               "train.serving": dict(enabled=True, block_size=4), "train.total_steps": 4})
    installs, blocks, set_params = [], [], ServingEngine.set_params
    close = ServingEngine.close

    def recording_set_params(self, params):
        # the first tensor names the snapshot (the publisher clones new
        # tensors per version) and stays alive in the list, so identities
        # cannot be reused the way the id of a freed mapping can
        installs.append((threading.current_thread().name, next(iter(params.values()))))
        return set_params(self, params)

    def recording_close(self):
        blocks.append(self.allocator.blocks_in_use)
        return close(self)

    ServingEngine.set_params, ServingEngine.close = recording_set_params, recording_close
    try:
        trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=PROMPTS[:2], config=cfg,
                                       device="cpu")
    finally:
        ServingEngine.set_params, ServingEngine.close = set_params, close
    assert trainer.iter_count == 4 and blocks == [0]
    assert installs and all(name == "rollout-producer" for name, _ in installs)
    assert len({id(first) for _, first in installs}) == len(installs)  # each snapshot installed once
    s = trainer.rollout_engine_summary
    assert s["produced"] == s["consumed"] + s["dropped_stale"] + s["leftover"] + s["dropped_shutdown"]
