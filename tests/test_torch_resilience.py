"""Port parity for the resilience subsystem: trlx_tpu_torch.resilience held
against trlx_tpu.resilience on the same inputs (chaos specs, checkpoint
directory trees, retry schedules under a seeded rng and a fake clock), the
port's commit protocol and async writer (a host snapshot, never a live
tensor: the alias trap), preemption with a real SIGTERM, and exact resume
of a tiny PPO run on the CPU (``preempt-step`` and a real SIGTERM, then
auto-resume: parameters ``torch.equal`` and stats equal to the
uninterrupted run's)."""

import json
import logging as _logging
import os
import random
import shutil
import signal
import threading
import time

import numpy as np
import pytest
import torch

import trlx_tpu.resilience as jres
import trlx_tpu_torch
import trlx_tpu_torch.resilience as pres
from trlx_tpu.utils.metrics import gauges as jax_gauges
from trlx_tpu_torch.resilience import chaos
from trlx_tpu_torch.resilience.checkpoint import COMMITTED_SENTINEL, PAYLOAD_FILE, STATE_FILE
from trlx_tpu_torch.utils.metrics import gauges

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    """Chaos disarmed and resilience gauges cleared in both packages before
    and after every test (both are process-global)."""
    monkeypatch.delenv("TRLX_CHAOS", raising=False)
    for c, g in ((chaos, gauges), (jres.chaos, jax_gauges)):
        c.configure(None)
        g.clear("resilience/")
    yield
    for c, g in ((chaos, gauges), (jres.chaos, jax_gauges)):
        c.configure(None)
        g.clear("resilience/")


# ------------------------------------------------------------------ chaos


CHAOS_SPECS = [
    "reward:2",
    "reward:1,reward:2,nan-loss:1",
    "checkpoint:1, bad-element:3 ,producer-wedge",
    "rollout-producer:2,hf-load:1,preempt-step:3",
    "serving-prefill:1,serving-decode:2,serving-alloc:1,serving-wedge:1,broadcast-chunk:1,"
    "fleet-route:2,fleet-replica-kill:1",
    "",
]


@pytest.mark.parametrize("spec", CHAOS_SPECS, ids=[s or "empty" for s in CHAOS_SPECS])
def test_chaos_specs_match_jax(spec):
    """The same spec arms the same budgets: every site's should_fail
    sequence, preempt_due over steps 0..5 and stats() are equal."""
    from trlx_tpu.resilience.chaos import _COUNT_SITES as jax_sites
    from trlx_tpu_torch.resilience.chaos import _COUNT_SITES as port_sites

    assert port_sites == jax_sites
    j, p = jres.ChaosMonkey(spec), pres.ChaosMonkey(spec)
    assert j.armed == p.armed
    for site in port_sites:
        assert [j.should_fail(site) for _ in range(4)] == [p.should_fail(site) for _ in range(4)], site
    assert [j.preempt_due(s) for s in range(6)] == [p.preempt_due(s) for s in range(6)]
    assert j.stats() == p.stats()


@pytest.mark.parametrize("spec", ["bogus:1", "reward:x"])
def test_chaos_rejects_bad_specs_as_jax(spec):
    for monkey in (jres.ChaosMonkey, pres.ChaosMonkey):
        with pytest.raises(ValueError, match="chaos spec token"):
            monkey(spec)


def test_chaos_reload_from_env(monkeypatch):
    monkeypatch.setenv("TRLX_CHAOS", "reward:1")
    chaos.reload_from_env()
    assert chaos.armed
    with pytest.raises(pres.ChaosInjectedError, match="'reward'"):
        chaos.fail_if_armed("reward")
    chaos.fail_if_armed("reward")  # budget spent: clean
    assert chaos.stats() == {"reward": 1}


# ------------------------------------------------- checkpoint directories


TREES = {
    # name -> committed?; "x.tmp" names are directories left by a crash
    "numeric": {"checkpoint_9": True, "checkpoint_10": True, "checkpoint_2": True},
    "torn_newest": {"checkpoint_1": True, "checkpoint_2": True, "checkpoint_3": False, "checkpoint_4.tmp": False},
    "all_torn": {"checkpoint_1": False, "checkpoint_2.tmp": False},
    "protected": {"checkpoint_01": True, "checkpoint_02": True, "checkpoint_03": True, "checkpoint_04": True,
                  "best_checkpoint": True, "hf_model": True, "checkpoint_05": False, "checkpoint_06.tmp": False,
                  "checkpoint_x": True, "other": True},
    "empty": {},
}


def _plant(root, tree):
    os.makedirs(root, exist_ok=True)
    for name, committed in tree.items():
        os.makedirs(os.path.join(root, name))
        if committed:
            open(os.path.join(root, name, COMMITTED_SENTINEL), "w").close()


@pytest.mark.parametrize("tree", list(TREES), ids=list(TREES))
@pytest.mark.parametrize("keep_last", [0, 1, 2])
def test_checkpoint_trees_match_jax(tmp_path, tree, keep_last):
    """The same tree of committed, torn and ``.tmp`` names gives the same
    newest committed checkpoint, the same listing and the same retention
    survivors in both packages."""
    roots = {}
    for who in ("jax", "port"):
        roots[who] = str(tmp_path / who)
        _plant(roots[who], TREES[tree])
    name = lambda p: None if p is None else os.path.basename(p)  # noqa: E731
    assert name(pres.find_latest_committed(roots["port"])) == name(jres.find_latest_committed(roots["jax"]))
    assert [(s, name(p)) for s, p in pres.list_checkpoints(roots["port"])] == [
        (s, name(p)) for s, p in jres.resume.list_checkpoints(roots["jax"])]
    protected = list(pres.PROTECTED_CHECKPOINTS)
    assert protected == list(jres.PROTECTED_CHECKPOINTS)
    dp = sorted(map(name, pres.gc_checkpoints(roots["port"], keep_last, protected)))
    dj = sorted(map(name, jres.gc_checkpoints(roots["jax"], keep_last, protected)))
    assert dp == dj
    assert sorted(os.listdir(roots["port"])) == sorted(os.listdir(roots["jax"]))


def test_find_latest_committed_missing_dir(tmp_path):
    assert pres.find_latest_committed(str(tmp_path / "nope")) is None
    assert pres.gc_checkpoints(str(tmp_path / "nope"), 2) == []


@pytest.mark.parametrize("name", ["checkpoint_7", "checkpoint_007", "checkpoint_7.tmp", "checkpoint_x",
                                  "best_checkpoint", "checkpoint_"])
def test_checkpoint_step_matches_jax(name):
    assert pres.checkpoint_step(name) == jres.checkpoint_step(name)


def test_write_checkpoint_commits_atomically(tmp_path):
    path = str(tmp_path / "checkpoint_1")
    pres.write_checkpoint(path, {"params": {"w": torch.arange(3.0)}}, {"iter_count": 1})
    assert pres.is_committed(path)
    assert sorted(os.listdir(path)) == sorted([COMMITTED_SENTINEL, PAYLOAD_FILE, STATE_FILE])
    assert torch.equal(torch.load(os.path.join(path, PAYLOAD_FILE))["params"]["w"], torch.arange(3.0))
    with open(os.path.join(path, STATE_FILE)) as f:
        assert json.load(f) == {"iter_count": 1}
    assert not os.path.exists(path + ".tmp")


def test_write_checkpoint_failure_leaves_no_torn_final_dir(tmp_path):
    chaos.configure("checkpoint:1")
    path = str(tmp_path / "checkpoint_1")
    with pytest.raises(pres.ChaosInjectedError):
        pres.write_checkpoint(path, {"params": {}}, {"iter_count": 1})
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")
    pres.write_checkpoint(path, {"params": {}}, {"iter_count": 1})  # budget spent
    assert pres.is_committed(path)


def test_write_json_atomic_replaces_whole_file(tmp_path):
    path = str(tmp_path / "s.json")
    pres.write_json_atomic(path, {"a": 1})
    pres.write_json_atomic(path, {"b": [1, 2]})
    with open(path) as f:
        assert json.load(f) == {"b": [1, 2]}
    assert os.listdir(tmp_path) == ["s.json"]


# ------------------------------------------------------------------ retry


def _retry_schedule(retry_call, policy, failures, deadline_clock_step=0.0):
    """Run ``retry_call`` over a function failing ``failures`` times under a
    seeded rng and a fake clock; return (delays slept, result or error)."""
    sleeps, clock = [], {"t": 0.0}

    def sleep(d):
        sleeps.append(d)
        clock["t"] += d

    def now():
        clock["t"] += deadline_clock_step
        return clock["t"]

    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= failures:
            raise OSError(f"transient {calls['n']}")
        return "ok"

    try:
        out = retry_call(flaky, policy=policy, name="flaky", sleep=sleep, clock=now, rng=random.Random(7))
    except Exception as e:  # the typed error is the result under test
        out = (type(e).__name__, str(e))
    return sleeps, out, calls["n"]


@pytest.mark.parametrize("failures,kw", [
    (2, {}),
    (5, dict(max_retries=3)),
    (6, dict(max_retries=10, base_delay_s=1.0, max_delay_s=3.0, jitter=0.25)),
    (6, dict(max_retries=10, base_delay_s=1.0, deadline_s=5.0)),
    (3, dict(jitter=0.0, base_delay_s=0.2)),
])
def test_retry_schedules_match_jax(failures, kw):
    """A seeded rng and a fake clock give the same delays, attempts and
    deadline error in both packages."""
    j = _retry_schedule(jres.retry_call, jres.RetryPolicy(**kw), failures, deadline_clock_step=0.1)
    p = _retry_schedule(pres.retry_call, pres.RetryPolicy(**kw), failures, deadline_clock_step=0.1)
    assert p == j
    if "deadline_s" in kw:
        assert p[1][0] == "RetryDeadlineExceeded"
        assert gauges.get("resilience/retry_deadline_exceeded") == 1.0


def test_retry_giveup_is_not_retried():
    policy = pres.RetryPolicy(giveup_on=(FileNotFoundError,))
    calls = []

    def missing():
        calls.append(1)
        raise FileNotFoundError("no")

    with pytest.raises(FileNotFoundError):
        pres.retry_call(missing, policy=policy, sleep=lambda d: None)
    assert len(calls) == 1
    wrapped = pres.with_retries(lambda: 3, policy=policy)
    assert wrapped() == 3


def test_hf_load_retries_chaos_fault(tmp_path):
    """The port's HF checkpoint read recovers from an injected transient
    fault (the ``hf-load`` site inside the retried body)."""
    from trlx_tpu_torch.models import hf_loading
    from trlx_tpu_torch.models.transformer import TransformerLM

    cfg = hf_loading.get_preset("gpt2", dict(vocab_size=16, hidden_size=32, num_layers=1, num_heads=2,
                                             intermediate_size=64, max_position_embeddings=32))
    model = TransformerLM(cfg)
    model.init_params(0)
    out = str(tmp_path / "hf")
    hf_loading.save_pretrained_hf(out, "gpt2", model.state_dict(), cfg)
    os.environ["TRLX_HF_LOAD_RETRY_DELAY"] = "0.01"
    try:
        chaos.configure("hf-load:1")
        config, state, model_type = hf_loading.load_pretrained(out)
    finally:
        del os.environ["TRLX_HF_LOAD_RETRY_DELAY"]
    assert model_type == "gpt2" and state is not None
    assert chaos.stats() == {"hf-load": 1} and gauges.get("resilience/retries") == 1.0
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v.float()), k


# -------------------------------------------------------------- RNG state


def test_rng_key_roundtrip():
    g = torch.Generator().manual_seed(11)
    g.manual_seed(11)
    torch.rand(3, generator=g)
    words = pres.resume.pack_rng_key(g)
    assert json.loads(json.dumps(words)) == words
    expect = torch.rand(5, generator=g)
    h = pres.resume.unpack_rng_key(words, torch.Generator().manual_seed(0))
    assert torch.equal(torch.rand(5, generator=h), expect)
    rng = np.random.default_rng(3)
    rng.random(2)
    state = json.loads(json.dumps(pres.resume.pack_np_rng(rng)))
    expect_np = rng.random(4)
    other = np.random.default_rng(0)
    pres.resume.restore_np_rng(other, state)
    np.testing.assert_array_equal(other.random(4), expect_np)


# ---------------------------------------------------------- async writer


def test_async_writer_commits_in_background_and_applies_retention(tmp_path):
    writer = pres.AsyncCheckpointWriter(keep_last=2)
    for step in range(1, 5):
        path = str(tmp_path / f"checkpoint_{step}")
        writer.save(path, {"params": {"w": torch.full((2,), float(step))}}, {"iter_count": step})
    writer.wait()
    assert writer.last_committed == str(tmp_path / "checkpoint_4")
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_3", "checkpoint_4"]
    assert gauges.get("resilience/ckpt_committed") == 4.0 and gauges.get("resilience/ckpt_inflight") == 0.0
    writer.close()


def test_async_writer_surfaces_background_errors(tmp_path):
    chaos.configure("checkpoint:1")
    writer = pres.AsyncCheckpointWriter()
    writer.save(str(tmp_path / "checkpoint_1"), {"params": {}}, {})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.wait()
    writer.save(str(tmp_path / "checkpoint_2"), {"params": {}}, {}, block=True)
    assert pres.is_committed(str(tmp_path / "checkpoint_2"))
    assert not os.path.exists(str(tmp_path / "checkpoint_1"))


def test_host_snapshot_copies_every_tensor():
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    live = {"params": model.state_dict(), "optimizer": opt.state_dict()}
    snap, ready = pres.host_snapshot(live)
    assert ready is None  # CPU tensors: the copy is complete on return
    live_ptrs = {t.data_ptr() for t in model.state_dict().values()} | {
        t.data_ptr() for s in opt.state.values() for t in s.values()}
    snap_tensors = list(snap["params"].values()) + [
        t for s in snap["optimizer"]["state"].values() for t in s.values()]
    assert snap_tensors and not {t.data_ptr() for t in snap_tensors} & live_ptrs
    assert snap["optimizer"]["param_groups"] == live["optimizer"]["param_groups"]


def _ppo_config_dict(tmp_path, **train):
    """The tiny config of tests/test_torch_trainer.py (2 layers, hidden 32,
    char tokenizer, f32): greedy eval, sampled rollouts, an adaptive KL
    controller; 2 optimizer steps per experience phase."""
    d = dict(
        method=dict(
            name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05,
            target=6.0, horizon=1000, gen_kwargs=dict(max_new_tokens=5, do_sample=False),
            gen_experience_kwargs=dict(max_new_tokens=5, do_sample=True, top_k=0, top_p=1.0),
        ),
        train=dict(
            seq_length=16, epochs=20, total_steps=4, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=1, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False,
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


def _ppo_trainer(tmp_path, **train):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.from_dict(_ppo_config_dict(tmp_path, **train))
    trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")
    trainer.add_prompt_pipeline(PromptPipeline(PROMPTS, 11, trainer.tokenizer))
    return trainer


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def test_async_writer_never_sees_live_tensors(tmp_path, monkeypatch):
    """The alias trap: an async save, then an optimizer step while the
    commit is held back, then a load gives the tensors of the save, not the
    stepped ones. A writer handed the ``state_dict()`` references would
    serialize the stepped tensors and fail here."""
    from trlx_tpu_torch.resilience import checkpoint as ckpt_mod

    trainer = _ppo_trainer(tmp_path, **{"resilience": dict(enabled=True, preemption_handling=False)})
    try:
        trainer.prepare_learning()
        batches = list(trainer.create_train_dataloader())
        trainer.train_step(batches[0])  # AdamW state exists now
        saved = {"params": {k: v.clone() for k, v in trainer.model.state_dict().items()},
                 "state": {i: {k: v.clone() for k, v in s.items()}
                           for i, s in trainer.optimizer.state_dict()["state"].items()}}
        release = threading.Event()
        real = ckpt_mod.write_checkpoint

        def held(path, payload, state):
            release.wait(30.0)
            return real(path, payload, state)

        monkeypatch.setattr(ckpt_mod, "write_checkpoint", held)
        path = str(tmp_path / "ckpts" / "checkpoint_1")
        trainer._save_checkpoint(path)
        assert trainer.resilience.writer.in_flight
        trainer.train_step(batches[1])  # in-place updates while the commit waits
        moved = [k for k, v in trainer.model.state_dict().items() if not torch.equal(v, saved["params"][k])]
        assert moved
        release.set()
        trainer.resilience.writer.wait()
        trainer.load(path)
        for k, v in trainer.model.state_dict().items():
            assert torch.equal(v, saved["params"][k]), k
        for i, s in trainer.optimizer.state_dict()["state"].items():
            for k, v in s.items():
                assert torch.equal(v, saved["state"][i][k]), (i, k)
    finally:
        trainer.resilience.close()


# ----------------------------------------------------------- preemption


def test_preemption_simulate_and_grace_window():
    handler = pres.PreemptionHandler(grace_period_s=5.0)
    assert not handler.preempted and handler.grace_remaining_s is None
    handler.simulate("test")
    assert handler.preempted and handler.reason == "test"
    assert 0.0 < handler.grace_remaining_s <= 5.0
    handler.simulate("second call is a no-op")
    assert handler.reason == "test"


def test_preemption_real_sigterm_then_handler_released():
    handler = pres.PreemptionHandler(grace_period_s=5.0, signals=(signal.SIGTERM,))
    prev = signal.getsignal(signal.SIGTERM)
    try:
        assert handler.install()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not handler.preempted and time.monotonic() < deadline:
            time.sleep(0.01)
        assert handler.preempted and "SIGTERM" in handler.reason
        # the first signal released the trap: a second one terminates
        assert signal.getsignal(signal.SIGTERM) == prev
        assert gauges.get("resilience/preemptions") == 1.0
    finally:
        handler.uninstall()
        signal.signal(signal.SIGTERM, prev)


def test_resilience_runtime_converts_chaos_preempt(monkeypatch):
    from trlx_tpu_torch.data.configs import ResilienceConfig

    monkeypatch.setenv("TRLX_CHAOS", "preempt-step:3")
    res = pres.Resilience(ResilienceConfig(enabled=True, async_checkpointing=False))
    try:
        assert res.writer is None and res.auto_resume
        assert not res.should_stop(2)
        assert res.should_stop(3) and res.should_stop(4)  # latched
    finally:
        res.close()
    off = pres.Resilience(ResilienceConfig())
    assert off.writer is None and off.preemption is None and not off.should_stop(10)
    assert off.wrap_reward_fn(None) is None


def test_multiprocess_keeps_the_synchronous_path():
    from trlx_tpu_torch.data.configs import ResilienceConfig

    res = pres.Resilience(ResilienceConfig(enabled=True, preemption_handling=False), multiprocess=True)
    assert res.writer is None
    res.close()


# -------------------------------------------------- trainer: save / load


def test_sync_save_commits_with_resilience_off(tmp_path):
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, eval_prompts=PROMPTS[:4], device="cpu",
                                   config=_config(tmp_path, **{"train.total_steps": 2,
                                                               "train.checkpoint_interval": 2}))
    path = os.path.join(trainer.config.train.checkpoint_dir, "checkpoint_2")
    assert pres.is_committed(path) and trainer.resilience.writer is None
    with open(os.path.join(path, STATE_FILE)) as f:
        state = json.load(f)
    assert state["iter_count"] == 2 and state["prompt_batches_drawn"] == 2
    assert len(state["rng_key"]) == len(trainer.generator.get_state())
    assert not [n for n in os.listdir(trainer.config.train.checkpoint_dir) if n.endswith(".tmp")]
    trainer.save(path)  # a re-save in place ends committed again
    assert pres.is_committed(path)


def _config(tmp_path, **overrides):
    from trlx_tpu_torch.data.configs import TRLConfig

    return TRLConfig.update(TRLConfig.from_dict(_ppo_config_dict(tmp_path)), overrides)


def test_load_warns_on_uncommitted_and_restores_rng(tmp_path):
    a = _ppo_trainer(tmp_path / "a")
    a.prepare_learning()
    a.iter_count = 3
    path = str(tmp_path / "ck")
    a.save(path)
    os.remove(os.path.join(path, COMMITTED_SENTINEL))
    b = _ppo_trainer(tmp_path / "b")
    records = []

    class _Capture(_logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    lib_logger = _logging.getLogger("trlx_tpu_torch")
    handler = _Capture(level=_logging.WARNING)
    lib_logger.addHandler(handler)
    try:
        b.load(path)
    finally:
        lib_logger.removeHandler(handler)
    assert any(COMMITTED_SENTINEL in m for m in records)
    assert b.iter_count == 3
    assert torch.equal(b.generator.get_state(), a.generator.get_state())
    assert b.np_rng.bit_generator.state == a.np_rng.bit_generator.state


def test_missing_resume_path_raises(tmp_path):
    cfg = _config(tmp_path, **{"train.resume_from_checkpoint": str(tmp_path / "nope")})
    with pytest.raises(FileNotFoundError, match="resume_from_checkpoint"):
        trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS, config=cfg, device="cpu")


# ------------------------------------------- exact resume (the headline)


STAT_SKIP = ("time/",)


def _run(tmp_path, record, **overrides):
    """One trlx_tpu_torch.train run; ``record`` collects (iter, stats)."""
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    step = PPOTrainer.train_step

    def train_step(self, batch):
        out = step(self, batch)
        record.append({k: v for k, v in out.items() if not k.startswith(STAT_SKIP)})
        return out

    PPOTrainer.train_step = train_step
    try:
        return trlx_tpu_torch.train(reward_fn=overrides.pop("reward", reward_fn), prompts=PROMPTS,
                                    eval_prompts=PROMPTS[:4], config=_config(tmp_path, **overrides), device="cpu")
    finally:
        PPOTrainer.train_step = step


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    record = []
    trainer = _run(tmp_path_factory.mktemp("whole"), record)
    return trainer, record


RESILIENT = {"train.resilience": dict(enabled=True, grace_period_s=60.0)}


def _assert_resumed_equal(whole, resumed, resumed_record, from_step):
    trainer, record = whole
    assert resumed.iter_count == trainer.iter_count == 4
    assert resumed_record == record[from_step:]
    for (k, a), b in zip(trainer.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = trainer.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert resumed.kl_ctl.value == trainer.kl_ctl.value


def test_preempt_step_then_auto_resume_is_exact(tmp_path, monkeypatch, uninterrupted):
    """chaos ``preempt-step:2``: a committed emergency checkpoint at step 2
    (through the async writer), then a fresh trainer auto-resumes and
    finishes to step 4 with parameters, AdamW state and step stats equal to
    the uninterrupted run's; a newer torn decoy is skipped."""
    monkeypatch.setenv("TRLX_CHAOS", "preempt-step:2")
    first = _run(tmp_path, [], **RESILIENT)
    assert first.iter_count == 2 and first.emergency_checkpoint_s is not None
    ckpt_dir = first.config.train.checkpoint_dir
    assert pres.is_committed(os.path.join(ckpt_dir, "checkpoint_2"))
    os.makedirs(os.path.join(ckpt_dir, "checkpoint_3"))  # torn decoy: no sentinel, no payload
    monkeypatch.delenv("TRLX_CHAOS")
    record = []
    resumed = _run(tmp_path, record, **RESILIENT)
    _assert_resumed_equal(uninterrupted, resumed, record, 2)


def test_real_sigterm_then_auto_resume_is_exact(tmp_path, uninterrupted):
    """A real SIGTERM from the reward_fn during the eval after step 1 (so
    the flag is polled after step 2, the end of an experience epoch): the
    run writes a committed emergency checkpoint at step 2 and returns, and a
    fresh trainer resumes exactly."""
    calls = {"n": 0}

    def signalling_reward(samples, **kw):
        calls["n"] += 1
        if calls["n"] == 4:  # eval@0, two rollout chunks, then the eval after step 1
            from trlx_tpu_torch.resilience.preemption import PreemptionHandler

            handler = signal.getsignal(signal.SIGTERM)
            # never kill the test process: only signal a trapped SIGTERM
            assert getattr(handler, "__self__", None).__class__ is PreemptionHandler
            os.kill(os.getpid(), signal.SIGTERM)
        return reward_fn(samples)

    prev = signal.getsignal(signal.SIGTERM)
    first = _run(tmp_path, [], reward=signalling_reward, **RESILIENT)
    assert signal.getsignal(signal.SIGTERM) == prev
    assert first.iter_count == 2 and "SIGTERM" in first.resilience.preemption.reason
    assert pres.is_committed(os.path.join(first.config.train.checkpoint_dir, "checkpoint_2"))
    record = []
    resumed = _run(tmp_path, record, **RESILIENT)
    _assert_resumed_equal(uninterrupted, resumed, record, 2)


def test_auto_resume_at_the_end_trains_zero_steps(tmp_path):
    record = []
    _run(tmp_path, record, **{"train.total_steps": 2, **RESILIENT})
    again = []
    trainer = _run(tmp_path, again, **{"train.total_steps": 2, **RESILIENT})
    assert trainer.iter_count == 2 and len(record) == 2 and again == []


def test_chaos_reward_failure_retried_under_resilience(tmp_path, monkeypatch):
    monkeypatch.setenv("TRLX_CHAOS", "reward:2")
    res = dict(enabled=True, retry_base_delay_s=0.01, retry_max_delay_s=0.02, preemption_handling=False)
    record = []
    trainer = _run(tmp_path, record, **{"train.total_steps": 2, "train.resilience": res})
    assert trainer.iter_count == 2 and chaos.stats() == {"reward": 2}
    assert gauges.get("resilience/retries") == 2.0


def test_chaos_reward_failure_aborts_without_resilience(tmp_path, monkeypatch):
    monkeypatch.setenv("TRLX_CHAOS", "reward:1")
    with pytest.raises(pres.ChaosInjectedError):
        _run(tmp_path, [], **{"train.total_steps": 1})


def test_keep_last_bounds_the_disk(tmp_path):
    record = []
    res = dict(enabled=True, keep_last=2, preemption_handling=False)
    trainer = _run(tmp_path, record, **{"train.checkpoint_interval": 1, "train.resilience": res})
    names = sorted(n for n in os.listdir(trainer.config.train.checkpoint_dir) if n.startswith("checkpoint_"))
    assert names == ["checkpoint_3", "checkpoint_4"]
    shutil.rmtree(trainer.config.train.checkpoint_dir)
