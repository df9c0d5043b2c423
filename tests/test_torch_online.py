"""Port parity for the online loop: trlx_tpu_torch's ``online`` package
(buffer, collector, environment) against trlx_tpu's, case by case as
``tests/test_online.py`` runs them, the same requests and episodes fed to
both packages' objects: bounded eviction and the staleness-gated drain,
exactly-once harvesting and the ``double_harvest`` seeded regression,
grouping and scoring, pairwise win rates, environment groups, the
reward-fn adapter, ``SyntheticEnvironment`` prompts per seed. Added: a
harvest from the port's CPU ``ServingEngine`` against the JAX engine's on
the same weights (greedy), and the port's ``GRPOTrainer`` draining the same
``LabeledGroup``s as the JAX ``GRPOTrainer`` (experience within 1e-4).
The JAX test file's fleet cases (replica kill, learn-tenant gating, the
soak) need the fleet router, which the port does not bring yet.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import trlx_tpu.online as jon
import trlx_tpu_torch.online as ton
from trlx_tpu.serving.scheduler import Request as JRequest
from trlx_tpu_torch.serving.scheduler import FINISH_EOS, FINISH_SHED, Request

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)


def _req(uid, prompt, generated, finish=FINISH_EOS, learn_eligible=None, cls=Request):
    r = cls(uid=uid, prompt=list(prompt), max_new_tokens=8)
    r.generated = list(generated)
    r.finish_reason = finish
    if learn_eligible is not None:
        r.learn_eligible = learn_eligible  # a fleet router's stamp
    return r


def _both_req(*a, **kw):
    return _req(*a, **kw), _req(*a, **{**kw, "cls": JRequest})


def _len_reward(prompt, completions):
    return [float(len(c)) for c in completions]


def _groups(groups):
    """Comparable view of drained LabeledGroups."""
    return [(list(g.prompt), [list(c) for c in g.completions], np.asarray(g.scores).tolist(),
             int(g.policy_version), tuple(g.uids)) for g in groups]


# -------------------------------------------------------------- config block


def test_train_online_block_parses_and_defaults_off():
    from trlx_tpu_torch.data.configs import OnlineConfig, TrainConfig, TRLConfig
    from trlx_tpu_torch.data.default_configs import default_grpo_config

    assert TrainConfig(seq_length=8, epochs=1, total_steps=1, batch_size=1).online.enabled is False
    d = default_grpo_config().to_dict()
    assert d["train"]["online"]["enabled"] is False
    d["train"]["online"] = dict(enabled=True, group_size=4, buffer_capacity=32, max_staleness=2,
                                label_type="preference")
    restored = TRLConfig.from_dict(d)
    assert isinstance(restored.train.online, OnlineConfig) and restored.train.online.buffer_capacity == 32
    with pytest.raises(ValueError, match="label_type"):
        OnlineConfig(label_type="bogus")
    with pytest.raises(ValueError, match="group_size"):
        OnlineConfig(group_size=1)


# ------------------------------------------------------------------- buffer


def test_buffer_bounded_eviction_matches_jax():
    out = []
    for pkg in (jon, ton):
        buf = pkg.OnlineExperienceBuffer(capacity=2)
        for i in range(3):
            buf.put(pkg.LabeledGroup([i], [[1], [2]], np.zeros(2)))
        out.append((len(buf), buf.stats(), _groups(buf.drain(10)), len(buf)))
    assert out[0] == out[1]
    assert out[1][0] == 2 and out[1][1]["evicted"] == 1.0
    assert [g[0] for g in out[1][2]] == [[1], [2]] and out[1][3] == 0


def test_buffer_staleness_gated_drain_matches_jax():
    out = []
    for pkg in (jon, ton):
        buf = pkg.OnlineExperienceBuffer(capacity=8, max_staleness=1)
        buf.put(pkg.LabeledGroup([1], [[1], [2]], np.zeros(2), policy_version=5))
        buf.put(pkg.LabeledGroup([2], [[1], [2]], np.zeros(2), policy_version=0))
        buf.put(pkg.LabeledGroup([3], [[1], [2]], np.zeros(2), policy_version=4))
        out.append((_groups(buf.drain(10, learner_version=5)), buf.stats()))
    assert out[0] == out[1]
    assert [g[0] for g in out[1][0]] == [[1], [3]] and out[1][1]["dropped_stale"] == 1.0


# ---------------------------------------------------------------- collector


def test_collector_exactly_once_per_uid_matches_jax():
    tcol = ton.PreferenceCollector(ton.OnlineExperienceBuffer(), group_size=2, reward_fn=_len_reward)
    jcol = jon.PreferenceCollector(jon.OnlineExperienceBuffer(), group_size=2, reward_fn=_len_reward)
    treq, jreq = _both_req(7, [1, 2], [3, 4])
    assert [tcol.observe(treq), tcol.observe(treq)] == [jcol.observe(jreq), jcol.observe(jreq)] == [True, False]
    assert tcol.stats() == jcol.stats()
    assert tcol.stats()["labels_harvested"] == 1.0 and tcol.stats()["duplicates_dropped"] == 1.0


def test_collector_groups_by_prompt_and_scores_matches_jax():
    results = []
    for pkg, cls in ((jon, JRequest), (ton, Request)):
        buf = pkg.OnlineExperienceBuffer()
        col = pkg.PreferenceCollector(buf, group_size=2, reward_fn=_len_reward)
        banked = [col.observe(_req(1, [5, 6], [10], cls=cls), policy_version=3), len(buf),
                  col.observe(_req(2, [5, 6], [11, 12, 13], cls=cls), policy_version=4), len(buf)]
        groups = _groups(buf.drain(1))
        ineligible = [
            col.observe(_req(3, [5, 6], [9], finish="shed", cls=cls)),
            col.observe(_req(4, [5, 6], [], cls=cls)),
            col.observe(_req(5, [5, 6], [9], learn_eligible=False, cls=cls)),
        ]
        partial = [col.observe(_req(6, [5, 6], [9], cls=cls)), col.flush(), col.stats()]
        results.append((banked, groups, ineligible, partial))
    assert results[0] == results[1]
    banked, groups, ineligible, partial = results[1]
    assert banked == [True, 0, True, 1]
    assert groups == [([5, 6], [[10], [11, 12, 13]], [1.0, 3.0], 4, (1, 2))]  # the newest version
    assert ineligible == [False, False, False] and FINISH_SHED == "shed"
    assert partial[:2] == [True, 1] and partial[2]["pending_completions"] == 0.0


def test_harvest_of_a_dict_matches_jax():
    stream = [(u, [u % 3, 1], [u, u + 1, 2][: 1 + u % 3]) for u in range(12)]
    out = []
    for pkg, cls in ((jon, JRequest), (ton, Request)):
        buf = pkg.OnlineExperienceBuffer()
        col = pkg.PreferenceCollector(buf, group_size=2, reward_fn=_len_reward)
        delivered = {u: _req(u, p, g, cls=cls) for u, p, g in stream}
        out.append((col.harvest(delivered, policy_version=2), col.harvest(delivered, policy_version=2),
                    col.stats(), _groups(buf.drain(100))))
    assert out[0] == out[1]
    n, again, stats, groups = out[1]
    assert (n, again, stats["duplicates_dropped"]) == (12, 0, 12.0)
    assert sorted(u for g in groups for u in g[4]) == list(range(12))  # each uid exactly once


def test_pairwise_preference_win_rates_match_jax():
    def judge(prompt, a, b):
        return 1.0 if len(a) > len(b) else (0.5 if len(a) == len(b) else 0.0)

    out = []
    for pkg, cls in ((jon, JRequest), (ton, Request)):
        buf = pkg.OnlineExperienceBuffer()
        col = pkg.PreferenceCollector(buf, group_size=4, preference_fn=judge)
        for uid, gen in ((1, [9]), (2, [9, 9, 9]), (3, [9, 9]), (4, [9, 9])):
            col.observe(_req(uid, [1], gen, cls=cls))
        out.append(_groups(buf.drain(1)))
    assert out[0] == out[1]
    np.testing.assert_allclose(out[1][0][2], [0.0, 1.0, 0.5, 0.5])
    bare = ton.PreferenceCollector(ton.OnlineExperienceBuffer(), group_size=2)
    with pytest.raises(ValueError, match="reward_fn or a preference_fn"):
        bare.observe(_req(1, [1], [2]))
        bare.observe(_req(2, [1], [2]))


def test_seed_regression_double_harvest(monkeypatch):
    monkeypatch.setenv("TRLX_ONLINE_SEED_REGRESSION", "bogus_mode")
    with pytest.raises(ValueError, match="not a known seeded regression"):
        ton.PreferenceCollector(ton.OnlineExperienceBuffer(), group_size=2, reward_fn=_len_reward)
    # double_harvest disables the dedup: exactly-once MUST break, in both packages alike
    monkeypatch.setenv("TRLX_ONLINE_SEED_REGRESSION", "double_harvest")
    tcol = ton.PreferenceCollector(ton.OnlineExperienceBuffer(), group_size=2, reward_fn=_len_reward)
    jcol = jon.PreferenceCollector(jon.OnlineExperienceBuffer(), group_size=2, reward_fn=_len_reward)
    treq, jreq = _both_req(7, [1, 2], [3, 4])
    assert [tcol.observe(treq), tcol.observe(treq)] == [jcol.observe(jreq), jcol.observe(jreq)] == [True, True]
    assert tcol.stats() == jcol.stats() and tcol.stats()["duplicates_dropped"] == 0.0


# -------------------------------------------------------------- environment


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_synthetic_environment_prompts_equal_per_seed(seed):
    kw = dict(vocab_size=16, prompt_len=5, target_token=2, max_turns=2, seed=seed)
    jenv, tenv = jon.SyntheticEnvironment(**kw), ton.SyntheticEnvironment(**kw)
    for episode in range(4):
        assert tenv.reset() == jenv.reset()
        assert tenv.step([2, 3]) == jenv.step([2, 3])
    assert tenv.reset(seed=seed + 99) == jenv.reset(seed=seed + 99)
    with pytest.raises(ValueError, match="outside vocab"):
        ton.SyntheticEnvironment(vocab_size=4, target_token=4)


def test_collect_environment_groups_match_jax():
    out = []
    for pkg in (jon, ton):
        env = pkg.SyntheticEnvironment(vocab_size=16, prompt_len=3, target_token=2, max_turns=2, seed=0)
        buf = pkg.OnlineExperienceBuffer()
        col = pkg.PreferenceCollector(buf, group_size=2)  # returns ARE the labels
        calls = []

        def generate_fn(transcript):
            calls.append(list(transcript))
            return [2, 2, 3] if len(calls) % 2 else [4, 5, 6]

        banked = col.collect_environment(env, generate_fn, episodes=2, max_turns=2, seed=11, policy_version=3)
        out.append((banked, _groups(buf.drain(10)), calls, col.stats()))
    assert out[0] == out[1]
    banked, groups, calls, _ = out[1]
    assert banked == 2 and len(groups) == 2 and groups[0][0] != groups[1][0]
    assert calls[0][:3] == groups[0][0] and groups[0][3] == 3


def test_run_environment_rollout_matches_jax():
    out = []
    for pkg in (jon, ton):
        env = pkg.SyntheticEnvironment(vocab_size=12, prompt_len=4, target_token=5, max_turns=3, seed=4)
        out.append(pkg.run_environment_rollout(env, lambda t: [5, len(t) % 12, 5], max_turns=3, seed=9))
    assert out[0] == out[1]
    assert len(out[1][1]) == 9 and out[1][2] == pytest.approx(3 * 2 / 3)


def test_environment_reward_fn_adapter_matches_jax():
    class Tok:
        def encode(self, s):
            return [int(t) for t in s.split()]

    kwargs = dict(samples=None, prompts=["1 2", "3", "2"], outputs=["2 2 3", "4", "2"], tokenizer=Tok())
    scores = [pkg.environment_reward_fn(pkg.SyntheticEnvironment(vocab_size=16, target_token=2))(**kwargs)
              for pkg in (jon, ton)]
    assert scores[0] == scores[1]
    np.testing.assert_allclose(scores[1], [2 / 3, 0.0, 1.0])
    with pytest.raises(ValueError, match="tokenizer"):
        ton.environment_reward_fn(ton.SyntheticEnvironment())(samples=None, prompts=["1"], outputs=["2"])


# --------------------------------------------------------- engine harvest


def test_harvest_from_the_port_engine_matches_the_jax_engine():
    """Grouped traffic (3 prompts x 2) through the port's CPU ServingEngine
    and the JAX engine on the same weights (greedy): the collector harvests
    from ``engine.scheduler.pop_finished()`` exactly once, into the same
    groups; no KV block is left in use."""
    from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
    from trlx_tpu.models.transformer import TransformerLM as JaxLM
    from trlx_tpu.serving import ServingEngine as JaxEngine
    from trlx_tpu_torch.models.convert import params_from_jax
    from trlx_tpu_torch.models.presets import PRESETS
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.serving import ServingEngine

    tiny = dict(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=64)
    jcfg = JAX_PRESETS["gpt2"].replace(**tiny, compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, JaxLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))["params"])
    tcfg = PRESETS["gpt2"].replace(**tiny, compute_dtype=torch.float32)
    kw = dict(num_slots=3, max_seq_len=32, block_size=4, eos_token_id=None, pad_token_id=0,
              gen_kwargs=dict(do_sample=False), seed=0)
    engines = [JaxEngine(JaxLM(jcfg), params, **kw),
               ServingEngine(TransformerLM(tcfg), params_from_jax(params, tcfg), device="cpu", **kw)]
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
    out = []
    try:
        for eng, pkg in zip(engines, (jon, ton)):
            buf = pkg.OnlineExperienceBuffer()
            col = pkg.PreferenceCollector(buf, group_size=2, reward_fn=lambda p, cs: [float(sum(c)) for c in cs])
            uids = [eng.submit(list(p), 4) for p in prompts for _ in range(2)]
            got = 0
            while eng.scheduler.has_work:
                eng.step()
                got += col.harvest(eng, policy_version=0)
            got += col.harvest(eng, policy_version=0)
            out.append((got, _groups(buf.drain(10)), col.stats(), eng.allocator.blocks_in_use, uids))
    finally:
        for eng in engines:
            eng.close()
    assert out[0] == out[1]
    got, groups, stats, blocks, uids = out[1]
    assert got == 6 and len(groups) == 3 and blocks == 0 and stats["duplicates_dropped"] == 0.0
    assert sorted(u for g in groups for u in g[4]) == sorted(uids)
    assert all(len(c) == 4 for g in groups for c in g[1])


# ------------------------------------------------------------ trainer drain


def _config_dict(tmp_path, online=True):
    return dict(
        method=dict(
            name="GRPOConfig", num_rollouts=8, chunk_size=4, group_size=2, ppo_epochs=1, init_kl_coef=0.05,
            target=None, gen_kwargs=dict(max_new_tokens=5, do_sample=True),
        ),
        train=dict(
            seq_length=16, epochs=1, total_steps=2, batch_size=4, minibatch_size=2, checkpoint_interval=100,
            eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"), pipeline="PromptPipeline",
            trainer="GRPOTrainer", tracker=None, seed=2, save_best=False,
            online=dict(enabled=online, group_size=2, buffer_capacity=16, max_staleness=2),
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=-1,
            model_overrides=dict(vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
                                 intermediate_size=64, max_position_embeddings=64, attention_impl="flash"),
        ),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )


def _port_trainer(tmp_path, online=True):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    return get_trainer("GRPOTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path, online)), device="cpu")


def test_online_switch_and_attach(tmp_path):
    """train.online off keeps the trainer bufferless and refuses an attached
    buffer; on, the trainer builds one, and a group-size mismatch raises."""
    off = _port_trainer(tmp_path / "off", online=False)
    assert off.online_buffer is None
    with pytest.raises(ValueError, match="train.online.enabled"):
        off.attach_online(ton.OnlineExperienceBuffer())
    on = _port_trainer(tmp_path / "on")
    assert isinstance(on.online_buffer, ton.OnlineExperienceBuffer) and on.online_buffer.capacity == 16
    external = ton.OnlineExperienceBuffer(capacity=4)
    on.attach_online(external)
    assert on.online_buffer is external
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    bad = _config_dict(tmp_path / "bad")
    bad["train"]["online"]["group_size"] = 4
    with pytest.raises(ValueError, match="must match method.group_size"):
        get_trainer("GRPOTrainer")(config=TRLConfig.from_dict(bad), device="cpu")


def test_grpo_trainer_drains_the_same_groups_as_jax(tmp_path, monkeypatch):
    """Four harvested groups (ragged completions, versions 0 and 1) in each
    package's buffer; both GRPOTrainers drain them in one experience phase
    from the same weights: identical tokens, versions stamped per group,
    experience within 1e-4, and the online gauges in the step stats."""
    import trlx_tpu.methods  # noqa: F401
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.parallel import mesh as mesh_lib
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer
    from trlx_tpu_torch.models.convert import policy_params_from_jax

    real = mesh_lib.make_mesh
    monkeypatch.setattr(mesh_lib, "mesh_from_config",
                        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]))
    # the JAX GRPOTrainer stamps each drained group's version with
    # ``e.policy_version = ...`` on a frozen flax PPORLElement, which raises
    # FrozenInstanceError; its scoring path builds elements through this
    # module-level name, so the test hands it a mutable record of the same
    # fields (the JAX package itself stays as it is)
    import trlx_tpu.trainer.ppo_trainer as jax_ppo_trainer
    from trlx_tpu_torch.data.ppo_types import PPORLElement as MutableElement

    monkeypatch.setattr(jax_ppo_trainer, "PPORLElement", MutableElement)
    jt = jax_get_trainer("GRPOTrainer")(config=JaxConfig.from_dict(_config_dict(tmp_path / "jax")))
    pt = _port_trainer(tmp_path / "port")
    pt.model.load_state_dict(policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)),
                                                    pt.model_config))
    pt.ref_model.load_state_dict(pt.model.transformer.state_dict())
    rng = np.random.default_rng(5)
    groups = []
    for g in range(4):
        prompt = rng.integers(3, 12, size=int(rng.integers(2, 6))).tolist()
        comps = [rng.integers(3, 12, size=int(rng.integers(1, 6))).tolist() for _ in range(2)]
        groups.append((prompt, comps, rng.normal(size=2).astype(np.float32), g % 2))
    for tr, pkg in ((jt, jon), (pt, ton)):
        for prompt, comps, scores, version in groups:
            tr.online_buffer.put(pkg.LabeledGroup(prompt, comps, scores, policy_version=version))
        tr._policy_version = 1
        tr.make_experience(8, 0)
    jh, ph = jt.store.history, pt.store.history
    assert len(ph) == len(jh) == 8
    for je, pe in zip(jh, ph):
        np.testing.assert_array_equal(np.asarray(pe.query_tensor), np.asarray(je.query_tensor))
        np.testing.assert_array_equal(np.asarray(pe.response_tensor), np.asarray(je.response_tensor))
        assert int(pe.policy_version) == int(je.policy_version)
        for field in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(getattr(pe, field), np.asarray(getattr(je, field)), err_msg=field,
                                       **ELEMENT_TOL)
    assert [int(e.policy_version) for e in ph] == [0, 0, 1, 1, 0, 0, 1, 1]
    assert len(pt.online_buffer) == 0
    pt.num_mb = 2
    out = pt.train_step(next(iter(pt.create_train_dataloader())))
    assert out["online/groups_consumed"] == 4.0 and out["online/group_adv_std"] > 0
    assert out["online/policy_delta"] == out["group/policy_delta"]
