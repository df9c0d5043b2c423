"""Port parity for stream-overlapped PPO (``train.serving.stream_overlap``;
the counterpart of tests/test_serving_overlap.py): ``ReorderBuffer`` and
``OverlapWindow`` against trlx_tpu's on the same operations, the
response-length ladder and its guard against trlx_tpu's, then on the tiny
PPO config of that file (2 layers, hidden 32, char tokenizer, greedy, f32):
overlap off byte-identical to the serial serving store; overlap on with the
same store dump and the same raw scores as the JAX streamed trainer on the
same weights (experience within 1e-4, the trainer-parity limit); two
seeded reward delays giving the same store; exactly one reward call per
rollout through a supervised engine restart and a wedged reward
(``serving-decode:1,producer-wedge:1``); the staged learner batch consumed
by ``train_step`` and a mismatch falling back; and
``TRLX_OVERLAP_SEED_REGRESSION=serialize`` collapsing the overlap
fraction."""

import random
import threading
import time

import numpy as np
import pytest

import jax

from trlx_tpu_torch.models.convert import policy_params_from_jax

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c"]
ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)


def count_a(samples, **kw):
    return [float(s.count("a")) for s in samples]


def _config_dict(tmp_path, serving=None, serving_resilience=None, **method_over):
    method = dict(name="PPOConfig", num_rollouts=4, chunk_size=2, ppo_epochs=1, init_kl_coef=0.01, target=None,
                  gen_kwargs=dict(max_new_tokens=4, do_sample=False))
    method.update(method_over)
    return dict(
        method=method,
        train=dict(
            seq_length=32, epochs=1, total_steps=1, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False,
            serving=serving or {}, serving_resilience=serving_resilience or {},
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=-1,
            model_overrides=dict(vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
                                 intermediate_size=64, max_position_embeddings=64),
        ),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=100, eta_min=1e-3)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )


def _serving(**kw):
    return {**dict(enabled=True, num_slots=3, block_size=4), **kw}


@pytest.fixture
def single_device_mesh(monkeypatch):
    """Pin JAX trainer meshes to the first of conftest's 8 virtual CPU devices."""
    from trlx_tpu.parallel import mesh as mesh_lib

    real = mesh_lib.make_mesh
    monkeypatch.setattr(
        mesh_lib, "mesh_from_config",
        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]),
    )


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    from trlx_tpu_torch.resilience.chaos import chaos

    chaos.configure(None)


_TRAINERS = []


@pytest.fixture(autouse=True)
def _close_engines():
    """learn()'s teardown for every trainer a test built: the engines close
    and their gauges clear (trlx_tpu's registry is process-global)."""
    yield
    while _TRAINERS:
        t = _TRAINERS.pop()
        if hasattr(t, "on_learn_end"):
            engine = t._serving_engine
            t.on_learn_end()
            if engine is not None and hasattr(engine, "restart_history"):  # a JAX supervisor
                engine.close()
                engine.engine.close()
            elif engine is not None and not hasattr(t, "device"):
                engine.close()


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """The JAX trainer's initial policy weights, carried into every port trainer."""
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.parallel import mesh as mesh_lib
    from trlx_tpu.utils.loading import get_trainer

    real = mesh_lib.make_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh_lib, "mesh_from_config",
                   lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]))
        jt = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path_factory.mktemp("w"))),
                                       reward_fn=count_a)
    return jax.tree.map(np.asarray, jax.device_get(jt.params))


def _jax_trainer(tmp_path, reward_fn=count_a, prompts=PROMPTS, **cfg):
    import trlx_tpu.methods  # noqa: F401
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu.utils.loading import get_trainer

    t = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path, **cfg)), reward_fn=reward_fn)
    t.add_prompt_pipeline(PromptPipeline(prompts, 12, t.tokenizer))
    t._resolve_serving()
    _TRAINERS.append(t)
    return t


def _port_trainer(tmp_path, jax_params, reward_fn=count_a, prompts=PROMPTS, **cfg):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    t = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path, **cfg)), reward_fn=reward_fn,
                                  device="cpu")
    t.model.load_state_dict(policy_params_from_jax(jax_params, t.model_config))
    t.ref_model.load_state_dict(t.model.transformer.state_dict())
    t.add_prompt_pipeline(PromptPipeline(prompts, 12, t.tokenizer))
    t._resolve_serving()
    t.num_mb = 2
    _TRAINERS.append(t)
    return t


def _store_dump(trainer):
    return [(np.asarray(e.query_tensor).tolist(), np.asarray(e.response_tensor).tolist())
            for e in trainer.store.history]


def _assert_same_experience(got, want, tol=ELEMENT_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.query_tensor), np.asarray(w.query_tensor))
        np.testing.assert_array_equal(np.asarray(g.response_tensor), np.asarray(w.response_tensor))
        for field in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(getattr(g, field), np.asarray(getattr(w, field)), err_msg=field, **tol)


# ------------------------------------------------------- host-side pieces


def _reorder_trace(ReorderBuffer):
    rb = ReorderBuffer()
    trace = []
    rb.add(2, "c")
    rb.add(0, "a")
    trace.append((rb.pop_ready(), rb.pending, rb.next_index))
    rb.add(1, "b")
    rb.add(4, None)  # a tombstone
    trace.append((rb.pop_ready(), rb.pending, rb.next_index))
    rb.add(3, "d")
    trace.append((rb.pop_ready(), rb.pending, rb.next_index))
    for index in (3, 5, 5):  # behind the cursor, new, duplicate
        try:
            rb.add(index, "x")
            trace.append(("added", index))
        except ValueError:
            trace.append(("rejected", index))
    return trace


def test_reorder_buffer_matches_jax():
    from trlx_tpu.rollout import ReorderBuffer as JaxReorderBuffer
    from trlx_tpu_torch.rollout import ReorderBuffer

    got = _reorder_trace(ReorderBuffer)
    assert got == _reorder_trace(JaxReorderBuffer)
    assert got[:3] == [(["a"], 1, 1), (["b", "c"], 1, 3), (["d"], 0, 5)]
    assert got[3:] == [("rejected", 3), ("added", 5), ("rejected", 5)]


def test_overlap_window_matches_jax_on_seeded_intervals():
    from trlx_tpu.obs.overlap import OverlapWindow as JaxWindow
    from trlx_tpu_torch.obs import OverlapWindow

    rng = np.random.default_rng(0)
    for _ in range(50):
        a, b = OverlapWindow(), JaxWindow()
        t = 0.0
        for _ in range(int(rng.integers(0, 12))):
            t += float(rng.choice([0.0, 1e-4, rng.random()]))
            d = float(rng.random())
            a.note_decode(t, t + d)
            b.note_decode(t, t + d)
            t += d
        for _ in range(int(rng.integers(0, 12))):
            s = float(rng.random() * (t + 1))
            e = s + float(rng.random())
            a.note_work(s, e)
            b.note_work(s, e)
        assert (a.decode_busy_s, a.overlapped_s, a.fraction) == (b.decode_busy_s, b.overlapped_s, b.fraction)
    w = OverlapWindow()
    w.note_decode(0.0, 1.0)
    w.note_decode(1.0001, 2.0)  # a sub-epsilon gap merges
    w.note_decode(3.0, 4.0)
    w.note_work(0.5, 1.5)
    w.note_work(2.2, 2.8)  # in the gap
    w.note_work(3.5, 5.0)
    assert w.decode_busy_s == pytest.approx(3.0, abs=1e-6)
    assert w.overlapped_s == pytest.approx(1.5, abs=1e-6) and w.fraction == pytest.approx(0.5, abs=1e-6)


def test_r_bucket_ladder_and_guard_match_jax():
    from types import SimpleNamespace

    from trlx_tpu.trainer import ppo_trainer as jax_ppo
    from trlx_tpu_torch.trainer import ppo_trainer as port_ppo

    assert port_ppo._STREAM_MAX_R_BUCKETS == jax_ppo._STREAM_MAX_R_BUCKETS == 4
    for max_new in (1, 4, 7, 12, 64, 100, 128, 1000):
        ladder = port_ppo.overlap_r_buckets(max_new)
        assert ladder == jax_ppo.PPOTrainer._overlap_r_buckets(SimpleNamespace(_serving_max_new=max_new))
        assert len(ladder) <= 4 and ladder[-1] >= max_new + 1
        for r in range(1, max_new + 2):
            assert port_ppo.quantize_stream_response(r, ladder) == jax_ppo.quantize_stream_response(r, ladder)
    port_fam, jax_fam = {}, {}
    for r in (8, 16, 32, 64):
        port_ppo.check_stream_bucket_family(port_fam, 4, 8, r)
        jax_ppo.check_stream_bucket_family(jax_fam, 4, 8, r)
    assert port_fam == jax_fam == {(4, 8): {8, 16, 32, 64}}
    with pytest.raises(AssertionError, match="bucket family"):
        port_ppo.check_stream_bucket_family(port_fam, 4, 8, 128)
    port_ppo.check_stream_bucket_family(port_fam, 2, 8, 128)  # another (B, P) family


# ---------------------------------------------------------- trainer parity


def test_overlap_off_is_byte_identical_to_serial(tmp_path, jax_weights):
    serial = _port_trainer(tmp_path / "serial", jax_weights, serving=_serving())
    serial.make_experience(4, 0)
    off = _port_trainer(tmp_path / "off", jax_weights, serving=_serving(stream_overlap=False))
    off.make_experience(4, 0)
    assert _store_dump(off) == _store_dump(serial)
    for a, b in zip(serial.store.history, off.store.history):
        for field in ("logprobs", "values", "rewards"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), field
    assert off._serving_engine.summary()["overlap_windows"] == 0.0


def test_overlap_on_matches_jax_streamed_trainer(tmp_path, jax_weights, single_device_mesh):
    calls = {"jax": [], "port": []}

    def recording(key):
        def reward_fn(samples, **kw):
            out = count_a(samples)
            calls[key].extend(zip(samples, out))
            return out

        return reward_fn

    jt = _jax_trainer(tmp_path / "jax", reward_fn=recording("jax"), serving=_serving(stream_overlap=True))
    jt.make_experience(4, 0)
    pt = _port_trainer(tmp_path / "port", jax_weights, reward_fn=recording("port"),
                       serving=_serving(stream_overlap=True))
    pt.make_experience(4, 0)
    assert _store_dump(pt) == _store_dump(jt)
    _assert_same_experience(list(pt.store.history), list(jt.store.history))
    assert sorted(calls["port"]) == sorted(calls["jax"]) and len(calls["port"]) == 4
    for key in ("rollout_scores/mean", "rollout_scores/std", "rollout_scores/running_mean"):
        assert pt.rollout_stats[key] == pytest.approx(jt.rollout_stats[key], rel=1e-6), key
    assert pt.mean_kl == pytest.approx(jt.mean_kl, rel=1e-4, abs=1e-6)
    summary = pt._serving_engine.summary()
    assert summary["overlap_windows"] == jt._serving_engine.summary()["overlap_windows"] == 1.0
    assert summary["blocks_in_use"] == 0.0
    from trlx_tpu_torch.trainer.ppo_trainer import overlap_r_buckets

    # every scoring shape came off the ladder
    assert pt._score_fn_families and all(
        rs <= set(overlap_r_buckets(4)) for rs in pt._score_fn_families.values())


def test_seeded_reward_delays_give_the_serial_store(tmp_path, jax_weights):
    ref = _port_trainer(tmp_path / "ref", jax_weights, serving=_serving())
    ref.make_experience(4, 0)

    def delayed(seed):
        rng = random.Random(seed)

        def reward_fn(samples, **kw):
            time.sleep(rng.random() * 0.02)  # shuffles the workers' completion order
            return count_a(samples)

        return reward_fn

    for run, seed in enumerate((7, 1234)):
        t = _port_trainer(tmp_path / f"stream{run}", jax_weights, reward_fn=delayed(seed),
                          serving=_serving(stream_overlap=True))
        t.make_experience(4, 0)
        assert _store_dump(t) == _store_dump(ref)
        assert t._serving_engine.summary()["overlap_windows"] == 1.0
        assert t._serving_engine.allocator.blocks_in_use == 0


def test_exactly_once_under_chaos(tmp_path, jax_weights):
    from trlx_tpu_torch.resilience.chaos import chaos
    from trlx_tpu_torch.serving import ServingSupervisor

    ref = _port_trainer(tmp_path / "ref", jax_weights, serving=_serving())
    ref.make_experience(4, 0)
    calls, lock = [], threading.Lock()

    def counting(samples, **kw):
        with lock:
            calls.extend(samples)
        return count_a(samples)

    t = _port_trainer(tmp_path / "chaos", jax_weights, reward_fn=counting, serving=_serving(stream_overlap=True),
                      serving_resilience=dict(enabled=True, max_restarts=8))
    assert isinstance(t._serving_engine, ServingSupervisor)
    chaos.configure("serving-decode:1,producer-wedge:1")
    t.make_experience(4, 0)
    assert chaos.stats() == {"serving-decode": 1, "producer-wedge": 1}
    chaos.configure(None)
    assert _store_dump(t) == _store_dump(ref)  # the replayed greedy decode loses nothing
    assert len(calls) == len(set(calls)) == 4
    assert t._serving_engine.restarts >= 1


def test_staged_learn_batch_is_consumed(tmp_path, jax_weights):
    t = _port_trainer(tmp_path, jax_weights, serving=_serving(stream_overlap=True))
    t.make_experience(4, 0)
    # num_rollouts 4, batch 4: exactly one staged learner batch
    assert len(t._staged_learn) == 1
    staged = t._staged_learn[0][1]
    popped = []
    pop = t._pop_staged_learn
    t._pop_staged_learn = lambda batch: popped.append(pop(batch)) or popped[-1]
    stats = t.train_step(next(iter(t.create_train_dataloader())))
    assert popped == [staged] and t._staged_learn == []
    assert np.isfinite(stats["losses/total_loss"])


def test_staged_learn_mismatch_falls_back():
    from trlx_tpu.trainer.mesh_trainer import MeshRLTrainer as JaxTrainer
    from trlx_tpu_torch.data.ppo_types import PPORLBatch
    from trlx_tpu_torch.trainer.mesh_trainer import MeshRLTrainer

    def seam(cls):
        class Seam:
            _clear_staged_learn = cls._clear_staged_learn
            _stage_learn_batch = cls._stage_learn_batch
            _host_batches_equal = staticmethod(cls._host_batches_equal)
            _pop_staged_learn = cls._pop_staged_learn

        return Seam()

    def trace(s, host, same, other, fewer):
        out = []
        s._stage_learn_batch(host, "DEVICE")
        out.append(s._pop_staged_learn(same))
        out.append(list(s._staged_learn))
        s._stage_learn_batch(host, "DEVICE")
        out.append(s._pop_staged_learn(other))
        out.append(list(s._staged_learn))
        s._stage_learn_batch(host, "DEVICE")
        out.append(s._pop_staged_learn(fewer))
        return out

    host = {"x": np.arange(4), "y": np.ones((2, 2))}
    args = (host, {"x": np.arange(4), "y": np.ones((2, 2))}, {"x": np.arange(4), "y": np.zeros((2, 2))},
            {"x": np.arange(4)})
    want = trace(seam(JaxTrainer), *args)
    assert trace(seam(MeshRLTrainer), *args) == want == ["DEVICE", [], None, [], None]
    # the port's batches are dataclasses of arrays (None fields allowed)
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    batch = PPORLBatch(a, a, a * 1.0, a * 1.0, a * 1.0, a, a)
    s = seam(MeshRLTrainer)
    s._stage_learn_batch(batch, "DEVICE")
    assert s._pop_staged_learn(PPORLBatch(a.copy(), a, a * 1.0, a * 1.0, a * 1.0, a, a)) == "DEVICE"
    s._stage_learn_batch(batch, "DEVICE")
    assert s._pop_staged_learn(batch.replace(staleness=np.zeros(2, np.int32))) is None


def _overlap_rig(tmp_path, jax_weights):
    """2 slots over 8 prompts stagger completions into waves, and each wave's
    rewards (30 ms a sample) overlap the next wave's decode."""
    def reward_fn(samples, **kw):
        time.sleep(0.03 * len(samples))
        return count_a(samples)

    return _port_trainer(
        tmp_path, jax_weights, reward_fn=reward_fn,
        prompts=["ab", "cd ef", "gh", "a b c", "ba", "fe dc", "hg", "c b a"],
        serving=_serving(stream_overlap=True, num_slots=2, overlap_microbucket=2, overlap_reward_workers=2),
        num_rollouts=8, chunk_size=8, gen_kwargs=dict(max_new_tokens=12, do_sample=False),
    )


def _fraction_delta(before, after):
    return (after["overlap_overlapped_s"] - before["overlap_overlapped_s"]) / max(
        1e-9, after["overlap_decode_s"] - before["overlap_decode_s"])


def test_serialize_collapses_the_overlap_fraction(tmp_path, jax_weights, monkeypatch):
    t = _overlap_rig(tmp_path, jax_weights)
    t.make_experience(8, 0)
    streamed = dict(t.last_overlap)
    monkeypatch.setenv("TRLX_OVERLAP_SEED_REGRESSION", "serialize")
    before = t._serving_engine.summary()
    t.make_experience(8, 1)
    serial = _fraction_delta(before, t._serving_engine.summary())
    assert serial == pytest.approx(t.last_overlap["fraction"], rel=1e-6)
    assert serial < 0.5 and serial < streamed["fraction"], (serial, streamed)
