"""Port parity at the GPT-J head dim: the ``gptj`` preset (gptj rotary over 64
of the 256 dims of a head, parallel residual with one shared layernorm, an
untied head with a bias) cut to hidden 512 and 2 heads, so D = 256 as in
the published GPT-J-6B, at 2 layers. On the CPU the port runs the plain
versions of its kernels and the JAX package its Pallas kernels in
interpret mode (``attention_impl="flash"``). Hydra PPO
(``num_layers_unfrozen=1``) for one experience phase and 2 optimizer
steps, the port through ``generate`` and through the serving engine (paged
decode over 256-wide rows), each against one run of the JAX
``PPOTrainer`` through ``generate`` (greedy: the engine's rollouts are
``generate``'s): experience within 1e-4, stats within 1e-3 relative, the
trainer-parity limits."""

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
#: the gptj preset at 2 layers, hidden 512 and 2 heads: D = 256, rotary over 64 dims
GPTJ_OVERRIDES = dict(vocab_size=len(ALPHABET) + 3, hidden_size=512, num_layers=2, num_heads=2,
                      intermediate_size=256, max_position_embeddings=64, attention_impl="flash")


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def _config_dict(tmp_path, serving):
    cfg = dict(
        method=dict(
            name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05,
            target=6.0, horizon=1000, num_value_layers_unfrozen=0,
            gen_kwargs=dict(max_new_tokens=5, do_sample=False),
        ),
        train=dict(
            seq_length=16, epochs=1, total_steps=2, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False,
        ),
        model=dict(model_path="gptj", num_layers_unfrozen=1, model_overrides=dict(GPTJ_OVERRIDES)),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4,
                                                  max_grad_norm=1.0)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )
    if serving:
        cfg["train"]["serving"] = dict(enabled=True, block_size=4)
    return cfg


def _record(trainer):
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


def _branch_state(jt):
    from trlx_tpu_torch.models.convert import _flatten

    flat = _flatten(jax.tree.map(np.asarray, jax.device_get(jt.frozen_branch_params)))
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in flat.items()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX ``PPOTrainer`` (through ``generate``) on one CPU device: its
    initial policy and frozen branch, converted, and what its run recorded.
    Both port variants are held to it: the experience is scored by the
    trainer, and greedy rollouts through the engine are ``generate``'s."""
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.parallel import mesh as mesh_lib
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer

    real = mesh_lib.make_mesh
    with pytest.MonkeyPatch.context() as mp:  # pin meshes to the first of conftest's 8 virtual CPU devices
        mp.setattr(mesh_lib, "mesh_from_config",
                   lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]))
        jcfg = JaxConfig.from_dict(_config_dict(tmp_path_factory.mktemp("jax"), serving=False))
        jt = jax_get_trainer("PPOTrainer")(config=jcfg, reward_fn=reward_fn)
        _attach_pipelines(jt, JaxPipeline, jcfg)
        params0 = jax.tree.map(np.asarray, jax.device_get(jt.params))
        branch0 = _branch_state(jt)
        rec = _record(jt)
        jt.learn()
    return params0, branch0, rec


@pytest.mark.parametrize("serving", [False, True], ids=["generate", "serving"])
def test_gptj_hydra_ppo_matches_jax(tmp_path, jax_run, serving):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    params0, branch_state, jrec = jax_run
    cfg = TRLConfig.from_dict(_config_dict(tmp_path / "port", serving))
    pt = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")
    _attach_pipelines(pt, PromptPipeline, cfg)
    c = pt.model_config
    assert (c.hidden_size // c.num_heads, c.rope_style, c.parallel_residual, c.tie_word_embeddings) == (
        256, "gptj", True, False)
    assert pt.branch_start == 1 and pt.ref_model is None
    pt.model.load_state_dict(policy_params_from_jax(params0, c))
    pt.frozen_branch.load_state_dict(branch_state)
    branch0 = {k: v.clone() for k, v in pt.frozen_branch.state_dict().items()}

    prec = _record(pt)
    engine_calls = []
    serving_generate = pt._serving_generate
    pt._serving_generate = lambda *a, **kw: engine_calls.append(1) or serving_generate(*a, **kw)
    pt.learn()
    assert bool(engine_calls) == serving

    assert len(prec["phases"]) == len(jrec["phases"]) == 1
    for je, pe in zip(jrec["phases"][0], prec["phases"][0]):
        np.testing.assert_array_equal(np.asarray(pe.query_tensor), np.asarray(je.query_tensor))
        np.testing.assert_array_equal(np.asarray(pe.response_tensor), np.asarray(je.response_tensor))
        for field in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(getattr(pe, field), np.asarray(getattr(je, field)), err_msg=field,
                                       **ELEMENT_TOL)
    assert len(prec["steps"]) == len(jrec["steps"]) == 2
    for i, (js, ps) in enumerate(zip(jrec["steps"], prec["steps"])):
        compared = [k for k in js if k.split("/")[0] in (
            "losses", "values", "old_values", "returns", "policy", "ratio", "padding_percentage",
            "learning_rate_group_0", "rollout_scores", "kl_ctl_value")]
        assert len(compared) >= 20
        for key in compared:
            np.testing.assert_allclose(ps[key], js[key], err_msg=f"step {i + 1} {key}", **STAT_TOL)
    for k, v in pt.frozen_branch.state_dict().items():
        assert torch.equal(v, branch0[k]), k
