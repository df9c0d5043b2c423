"""Port parity for the PPO training path: trlx_tpu_torch's ``PPOTrainer``
against trlx_tpu's on the tiny config of the JAX serving tests (2 layers,
hidden 32, char tokenizer, greedy rollouts, f32, flash attention — the JAX
kernels in interpret mode, the port's plain versions), from the same initial
parameters, carried across with ``policy_params_from_jax``. Two experience
phases and three optimizer steps (two microbatches each). Checked: every
rollout element (tokens identical; logprobs, values and rewards within
1e-4), every step's stats (rtol 1e-3, atol 1e-5), and the final eval
reward (identical). Also: the default device is the card, every unported
config block raises naming its slice, the blocks ported since build, and
the port's checkpoint round trip.
"""

import numpy as np
import pytest
import torch

import jax

from trlx_tpu_torch.models.convert import policy_params_from_jax

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]
ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_TOL = dict(rtol=1e-3, atol=1e-5)


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def _config_dict(tmp_path):
    return dict(
        method=dict(
            name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05,
            target=6.0, horizon=1000, gen_kwargs=dict(max_new_tokens=5, do_sample=False),
        ),
        train=dict(
            seq_length=16, epochs=2, total_steps=3, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False,
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=-1,
            model_overrides=dict(
                vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=64, attention_impl="flash",
            ),
        ),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4,
                                                  max_grad_norm=1.0)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )


@pytest.fixture
def single_device_mesh(monkeypatch):
    """Pin JAX trainer meshes to the first of conftest's 8 virtual CPU devices."""
    from trlx_tpu.parallel import mesh as mesh_lib

    real = mesh_lib.make_mesh
    monkeypatch.setattr(
        mesh_lib, "mesh_from_config",
        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]),
    )


def _record(trainer):
    """Capture raw per-step stats and each experience phase's elements."""
    rec = {"steps": [], "phases": []}
    step, push = trainer.train_step, trainer.push_to_store

    def train_step(batch):
        out = step(batch)
        rec["steps"].append(dict(out))
        return out

    def push_to_store(data):
        rec["phases"].append(list(data))
        return push(data)

    trainer.train_step, trainer.push_to_store = train_step, push_to_store
    return rec


def _attach_pipelines(trainer, pipeline_cls, cfg):
    max_prompt = cfg.train.seq_length - cfg.method.gen_kwargs["max_new_tokens"]
    trainer.add_prompt_pipeline(pipeline_cls(PROMPTS, max_prompt, trainer.tokenizer))
    trainer.add_eval_pipeline(pipeline_cls(PROMPTS[:4], max_prompt, trainer.tokenizer))


def _port_trainer(tmp_path, device="cpu", **overrides):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.update(TRLConfig.from_dict(_config_dict(tmp_path)), overrides)
    trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device=device)
    _attach_pipelines(trainer, PromptPipeline, cfg)
    return trainer


def test_ppo_trainer_matches_jax(tmp_path, single_device_mesh):
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer

    jcfg = JaxConfig.from_dict(_config_dict(tmp_path / "jax"))
    jt = jax_get_trainer("PPOTrainer")(config=jcfg, reward_fn=reward_fn)
    _attach_pipelines(jt, JaxPipeline, jcfg)

    pt = _port_trainer(tmp_path / "port")
    state = policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)), pt.model_config)
    pt.model.load_state_dict(state)
    pt.ref_model.load_state_dict(pt.model.transformer.state_dict())

    jrec, prec = _record(jt), _record(pt)
    jres, pres = jt.learn(), pt.learn()

    assert len(prec["phases"]) == len(jrec["phases"]) == 2
    for jphase, pphase in zip(jrec["phases"], prec["phases"]):
        assert len(pphase) == len(jphase) == 8
        for je, pe in zip(jphase, pphase):
            np.testing.assert_array_equal(np.asarray(pe.query_tensor), np.asarray(je.query_tensor))
            np.testing.assert_array_equal(np.asarray(pe.response_tensor), np.asarray(je.response_tensor))
            for field in ("logprobs", "values", "rewards"):
                np.testing.assert_allclose(
                    getattr(pe, field), np.asarray(getattr(je, field)), err_msg=field, **ELEMENT_TOL
                )

    assert len(prec["steps"]) == len(jrec["steps"]) == 3
    for i, (js, ps) in enumerate(zip(jrec["steps"], prec["steps"])):
        compared = [k for k in js if k.split("/")[0] in (
            "losses", "values", "old_values", "returns", "policy", "ratio", "padding_percentage",
            "learning_rate_group_0", "rollout_scores", "kl_ctl_value")]
        assert len(compared) >= 20
        for key in compared:
            np.testing.assert_allclose(ps[key], js[key], err_msg=f"step {i + 1} {key}", **STAT_TOL)
    assert pres["reward/mean"] == jres["reward/mean"]
    assert pt.kl_ctl.value == pytest.approx(jt.kl_ctl.value, rel=1e-6)


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for a host without one")
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig

    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port_trainer(tmp_path, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trlx_tpu_torch.train(reward_fn=reward_fn, prompts=PROMPTS,
                             config=TRLConfig.from_dict(_config_dict(tmp_path)))


#: (key, value, what a one-rank trainer does): the pipe axis and the
#: sequence dimension are ported, so they raise what the JAX trainer raises
#: on one device (a two-stage mesh), or build (sequence sharding over a
#: model axis of 1 shards nothing)
UNPORTED = [
    ("mesh.pipe", 2, (ValueError, "does not match device count 1")),
    ("mesh.sequence_shard", True, None),
    ("tokenizer.tokenizer_path", "gpt2", (NotImplementedError, "HF-hub slice")),
]


@pytest.mark.parametrize("key,value,expect", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_unported_config_blocks_raise_naming_their_slice(tmp_path, key, value, expect):
    overrides = {key: value}
    if key.startswith("train.serving."):  # a knob of an enabled engine
        overrides["train.serving.enabled"] = True
    if expect is None:
        trainer = _port_trainer(tmp_path, **overrides)
        assert trainer.model_config.sequence_sharding is True
        return
    with pytest.raises(expect[0], match=expect[1]):
        _port_trainer(tmp_path, **overrides)


PORTED = [
    ("train.async_rollouts.enabled", True),
    ("train.async_rollouts.length_bucket_lookahead", 4),
    ("train.online.enabled", True),
    ("method.overlap_reward_scoring", True),
    ("train.resilience.enabled", True),
    ("train.self_healing.enabled", True),
    ("train.observability.enabled", True),
    ("train.profile_dir", "prof"),
    ("train.tracker", "wandb"),
    ("train.serving.stream_overlap", True),
    ("train.serving_resilience.enabled", True),
    ("train.serving_tenancy.enabled", True),
    ("train.serving_fleet.enabled", True),
    ("train.islands.enabled", True),
    ("model.model_arch_type", "seq2seq"),
    ("train.rollout_param_dtype", "bfloat16"),
    ("mesh.remat", "full"),
    ("model.peft_config", {"r": 4}),
    ("model.offload_ref", True),
    ("optimizer.name", "adamw_8bit_bnb"),
    ("train.learner_overlap.enabled", True),
]


@pytest.mark.parametrize("key,value", PORTED, ids=[p[0] for p in PORTED])
def test_ported_config_blocks_build(tmp_path, key, value):
    """The blocks that raised until the async / online slice, the
    resilience slice, the observability slice, the production-serving
    slice, the serving-fleet slice and the seq2seq slice build the CPU
    trainer (``train.online`` with the GRPO method it belongs to; ``wandb``,
    not installed, falls back to the jsonl tracker; the serving blocks with
    ``train.serving`` on, the fleet resolving its replicas; seq2seq with a
    tiny T5)."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    d = _config_dict(tmp_path)
    if key == "train.online.enabled":
        d["method"].update(name="GRPOConfig", group_size=2)
        d["train"].update(trainer="GRPOTrainer", online=dict(group_size=2))
    if key == "model.model_arch_type":
        d["model"]["model_overrides"] = dict(vocab_size=len(ALPHABET) + 3, d_model=32, d_kv=8, d_ff=64,
                                             num_layers=2, num_decoder_layers=2, num_heads=4)
    over = {key: value}
    if key.startswith("train.serving"):
        over["train.serving.enabled"] = True
    cfg = TRLConfig.update(TRLConfig.from_dict(d), over)
    trainer = get_trainer(cfg.train.trainer)(config=cfg, reward_fn=reward_fn, device="cpu")
    if key == "model.model_arch_type":
        from trlx_tpu_torch.models.policy import Seq2SeqLMWithValueHead

        assert trainer.is_seq2seq and isinstance(trainer.model, Seq2SeqLMWithValueHead)
    if key == "train.online.enabled":
        assert trainer.online_buffer is not None
    if key == "train.async_rollouts.length_bucket_lookahead":
        from trlx_tpu_torch.pipeline import PromptPipeline

        _attach_pipelines(trainer, PromptPipeline, cfg)
        batches = [next(trainer.prompt_iterator) for _ in range(4)]
        lengths = [len(p) for b in batches for p in b["input_ids"]]
        assert lengths == sorted(lengths)  # one window of 4 batches, sorted by length
    if key == "train.resilience.enabled":
        assert trainer.resilience.writer is not None and trainer.resilience.preemption is not None
    if key == "train.self_healing.enabled":
        assert trainer.health is not None and trainer._quarantine is not None
    if key == "train.observability.enabled":
        assert trainer.obs.enabled and trainer.obs.series is not None
    if key == "train.profile_dir":
        assert trainer.config.train.profile_dir == "prof" and not trainer.obs.enabled
    if key == "train.tracker":
        from trlx_tpu_torch.utils.trackers import JsonlTracker

        assert isinstance(trainer.tracker, JsonlTracker)
        trainer.tracker.finish()
    if key == "train.serving_fleet.enabled":
        from trlx_tpu_torch.fleet import FleetRouter

        trainer._resolve_serving()
        assert isinstance(trainer._serving_engine, FleetRouter)
        assert trainer._serving_engine.num_replicas == cfg.train.serving_fleet.num_replicas
        trainer.on_learn_end()  # retires every replica
    if key == "train.islands.enabled":
        assert trainer.config.train.islands.enabled and trainer._island is None  # wired by the async start
    if key == "train.rollout_param_dtype":
        assert trainer.rollout_dtype == torch.bfloat16 and trainer.generation_model() is not trainer.model
    if key == "mesh.remat":
        assert trainer.model_config.remat == "full"
    if key == "model.peft_config":
        assert trainer.peft_base_ref and trainer.ref_model is None and trainer.model_config.lora_r == 4
    if key == "model.offload_ref":
        assert trainer.ref_model is None and trainer._ref_host is not None
    if key == "optimizer.name":
        from trlx_tpu_torch.ops.quantized_adam import AdamW8bit

        assert isinstance(trainer.optimizer, AdamW8bit)
    trainer.resilience.close()  # releases the signal handlers learn() would release
    trainer.obs.close()  # and what the obs layer holds


def test_unported_training_rows_raise_naming_their_slice(tmp_path):
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.method_configs import get_method
    from trlx_tpu_torch.methods.grpo import GRPOConfig
    from trlx_tpu_torch.online import SyntheticEnvironment
    from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer
    from trlx_tpu_torch.utils.loading import get_trainer

    # the GRPO rows resolve since the GRPO / online slice
    d = _config_dict(tmp_path)
    d["method"].update(name="GRPOConfig", group_size=2)
    d["train"].update(trainer="GRPOTrainer", total_steps=1)
    cfg = TRLConfig.from_dict(d)
    assert isinstance(cfg.method, GRPOConfig) and get_method("GRPOConfig") is GRPOConfig
    assert get_trainer("GRPOTrainer") is GRPOTrainer
    env = SyntheticEnvironment(vocab_size=len(ALPHABET) + 3, prompt_len=3, target_token=3)
    assert isinstance(trlx_tpu_torch.train(environment=env, prompts=PROMPTS, config=cfg, device="cpu"), GRPOTrainer)
    # the native store loads since it was ported (it raised naming its slice before): the trunk is the store's
    from trlx_tpu_torch.checkpointing import convert_hf_to_native, restore_native

    native = convert_hf_to_native("gpt2", str(tmp_path / "native"), allow_random=True,
                                  overrides=_config_dict(tmp_path)["model"]["model_overrides"])
    trainer = _port_trainer(tmp_path, **{"model.model_path": native})
    _, stored, _ = restore_native(native)
    trunk = trainer.model.transformer.state_dict()
    assert set(stored) == set(trunk) and all(torch.equal(trunk[k], v) for k, v in stored.items())
    bare = tmp_path / "bare"
    bare.mkdir()
    with pytest.raises(FileNotFoundError, match="config.json"):
        _port_trainer(tmp_path, **{"model.model_path": str(bare)})


def test_checkpoint_round_trip(tmp_path):
    """save() then load() into a fresh trainer restores params, optimizer,
    scheduler, counters and every RNG stream: the next step's stats and
    parameters are then identical to the original trainer's."""
    a = _port_trainer(tmp_path / "a")
    a.prepare_learning()
    batches = list(a.create_train_dataloader())
    a.train_step(batches[0])
    a.iter_count = 1
    a.save(str(tmp_path / "ck"))

    b = _port_trainer(tmp_path / "b")
    b.load(str(tmp_path / "ck"))
    assert b.iter_count == 1
    for (name, pa), (_, pb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(pa, pb), name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert b.scheduler.last_epoch == a.scheduler.last_epoch == 1
    b.num_mb = a.num_mb
    b.rollout_stats = a.rollout_stats
    sa, sb = a.train_step(batches[1]), b.train_step(batches[1])
    assert sa == sb
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
    assert a._extra_state()["prompt_batches_drawn"] == 2 and b._resume_prompt_batches == 2
    assert b.running_moments.__dict__ == a.running_moments.__dict__ and b.kl_ctl.value == a.kl_ctl.value
