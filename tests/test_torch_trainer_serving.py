"""Port parity for PPO rollouts through the serving engine
(``train.serving.enabled``): on the tiny config of tests/test_serving.py
(2 layers, hidden 32, char tokenizer, greedy, f32), one experience phase
through the port's engine — plain, speculative, and speculative with
chunked prefill — must fill the same rollout store as the JAX trainer with
the same serving knobs on the same weights (tokens identical; logprobs,
values and rewards within 1e-4) and as the port's own padded ``generate``
path; the engine must end with no blocks in use, its gauges reach the step
stats, and ``learn`` closes it."""

import numpy as np
import pytest

import jax

from trlx_tpu_torch.models.convert import policy_params_from_jax

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c"]
ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)


def reward_fn(samples, **kw):
    return [float(s.count("a")) for s in samples]


def _config_dict(tmp_path, serving=None):
    return dict(
        method=dict(
            name="PPOConfig", num_rollouts=4, chunk_size=2, ppo_epochs=1, init_kl_coef=0.01,
            target=None, gen_kwargs=dict(max_new_tokens=4, do_sample=False),
        ),
        train=dict(
            seq_length=16, epochs=1, total_steps=1, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False,
            serving=serving or {},
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=-1,
            model_overrides=dict(
                vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=64,
            ),
        ),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=100, eta_min=1e-3)),
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


def _jax_trainer(tmp_path, serving):
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu.utils.loading import get_trainer

    trainer = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path, serving)),
                                        reward_fn=reward_fn)
    trainer.add_prompt_pipeline(PromptPipeline(PROMPTS, 12, trainer.tokenizer))
    return trainer


def _port_trainer(tmp_path, serving, jax_params):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    trainer = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path, serving)),
                                        reward_fn=reward_fn, device="cpu")
    trainer.model.load_state_dict(policy_params_from_jax(jax_params, trainer.model_config))
    trainer.ref_model.load_state_dict(trainer.model.transformer.state_dict())
    trainer.add_prompt_pipeline(PromptPipeline(PROMPTS, 12, trainer.tokenizer))
    return trainer


def _experience(trainer):
    trainer.num_mb = 2
    trainer._resolve_serving()
    trainer.make_experience(4, 0)
    return list(trainer.store.history)


def _assert_same_store(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.query_tensor), np.asarray(w.query_tensor))
        np.testing.assert_array_equal(np.asarray(g.response_tensor), np.asarray(w.response_tensor))
        for field in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(getattr(g, field), np.asarray(getattr(w, field)),
                                       err_msg=field, **ELEMENT_TOL)


@pytest.mark.parametrize(
    "spec_k,prefill_chunk", [(0, 0), (4, 0), (3, 2)], ids=["plain", "spec_k4", "spec_k3+chunk2"]
)
def test_serving_rollouts_match_jax_and_padded_generate(tmp_path, single_device_mesh, spec_k, prefill_chunk):
    serving = dict(enabled=True, num_slots=3, block_size=4, spec_k=spec_k, prefill_chunk=prefill_chunk)
    jt = _jax_trainer(tmp_path / "jax", serving)
    jax_params = jax.tree.map(np.asarray, jax.device_get(jt.params))
    want = _experience(jt)
    assert jt._serving_client is not None

    pt = _port_trainer(tmp_path / "port", serving, jax_params)
    got = _experience(pt)
    engine = pt._serving_engine
    assert engine is not None
    _assert_same_store(got, want)
    _assert_same_store(got, _experience(_port_trainer(tmp_path / "off", None, jax_params)))
    assert engine.allocator.blocks_in_use == 0
    engine.allocator.check_invariants()
    assert engine.stats.spec_rounds == jt._serving_engine.stats.spec_rounds
    assert engine.stats.chunk_appends == jt._serving_engine.stats.chunk_appends
    assert (engine.stats.spec_rounds > 0) == (spec_k > 0)
    assert (engine.stats.chunk_appends > 0) == (prefill_chunk > 0)

    stats = pt.train_step(next(iter(pt.create_train_dataloader())))
    assert stats["serving/blocks_in_use"] == 0.0
    assert stats["serving/accepted_tok_per_round"] >= 1.0
    pt.on_learn_end()  # learn()'s teardown: the engine closes, its gauges clear
    assert pt._serving_client is None and "serving/blocks_in_use" not in pt.train_step(
        next(iter(pt.create_train_dataloader())))
    # the JAX trainer never closes its engine; its gauges sit in trlx_tpu's
    # process-global registry until this does (later test files check it)
    jt._serving_engine.close()


def test_serving_falls_back_on_unsupported_gen_kwargs(tmp_path):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = _config_dict(tmp_path, dict(enabled=True))
    cfg["method"]["gen_kwargs"]["repetition_penalty"] = 1.2
    trainer = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(cfg), reward_fn=reward_fn, device="cpu")
    trainer._resolve_serving()
    assert trainer._serving_client is None
