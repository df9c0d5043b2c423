"""Port parity for hydra PPO: the branch capture (``branch_layer``, an int
and a tuple), ``forward_from``, the value branch and the frozen reference
branch of trlx_tpu_torch against trlx_tpu on the same weights (carried by
``policy_params_from_jax``) and seeded numpy inputs, in f32 on the CPU with
attention_impl "xla" and "flash" (the JAX kernels in interpret mode, the
port's plain versions): activations and logits within 1e-5, values within
1e-5. Then ``PPOTrainer`` with ``num_layers_unfrozen=2`` and
``num_value_layers_unfrozen=1`` on a 4-layer model against the JAX trainer
for two experience phases and three optimizer steps: experience within
1e-4, stats within 1e-3 relative; and the frozen layers, the trunk's
embedding, final norm and the frozen branch bit-identical after the steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.models.policy import CausalLMWithValueHead as JaxPolicy
from trlx_tpu.models.policy import apply_hydra_branch
from trlx_tpu.models.policy import branch_param_subtree as jax_branch_param_subtree
from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu.models.transformer import TransformerLM as JaxTrunk
from trlx_tpu_torch.models.convert import policy_params_from_jax
from trlx_tpu_torch.models.policy import (
    CausalLMWithValueHead,
    ModelBranch,
    branch_param_subtree,
    init_value_branch_from_trunk,
)
from trlx_tpu_torch.models.presets import PRESETS

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = dict(vocab_size=37, hidden_size=32, num_layers=4, num_heads=4, max_position_embeddings=64)


def _models(impl, num_value_layers=0, tie=True):
    jcfg = JAX_PRESETS["gpt2"].replace(**DIMS, compute_dtype=jnp.float32, attention_impl=impl,
                                       tie_word_embeddings=tie)
    tcfg = PRESETS["gpt2"].replace(**DIMS, compute_dtype=torch.float32, attention_impl=impl,
                                   tie_word_embeddings=tie)
    jm = JaxPolicy(jcfg, num_value_layers=num_value_layers)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))["params"]
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32) for x in leaves]
    params = jax.tree.unflatten(treedef, leaves)
    tm = CausalLMWithValueHead(tcfg, num_value_layers=num_value_layers)
    tm.load_state_dict(policy_params_from_jax(params, tcfg))
    return jm, params, tm


def _inputs(B=3, T=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, DIMS["vocab_size"], (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, :4] = 0
    mask[2, :T - 3] = 0
    return ids, mask


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_branch_capture_and_forward_from_match_jax(impl):
    jm, params, tm = _models(impl)
    ids, mask = _inputs()
    jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    _, _, jhid, _ = jm.apply({"params": params}, jids, jmask, branch_layer=2)
    _, _, jcaps, _ = JaxTrunk(jm.config).apply({"params": params["transformer"]}, jids, jmask, None, None, (1, 3))
    with torch.no_grad():
        tl, tv, thid, _ = tm(tids, tmask, branch_layer=2)
        _, _, tcaps, _ = tm.transformer(tids, tmask, branch_layer=(1, 3))
    np.testing.assert_allclose(thid.numpy(), np.asarray(jhid), **TOL)
    assert sorted(tcaps) == sorted(jcaps) == [1, 3]
    for i in (1, 3):
        np.testing.assert_allclose(tcaps[i].numpy(), np.asarray(jcaps[i]), **TOL)

    # forward_from with the policy's own trunk, and with the frozen branch copy
    jl = jm.apply({"params": params}, jhid, jmask, None, 2, method=jm.forward_branch)
    jfrozen = apply_hydra_branch(jm, jax_branch_param_subtree(params["transformer"], 2, jm.config), jhid, jmask, 2)
    with torch.no_grad():
        tl_own = tm.forward_branch(thid, tmask, None, 2)
        branch = ModelBranch(tm.config, 2)
        branch.load_state_dict(branch_param_subtree(tm.transformer.state_dict(), 2, tm.config))
        tl_frozen = tm.forward_branch(thid, tmask, None, 2, branch=branch)
    np.testing.assert_allclose(tl_own.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tl_frozen.numpy(), np.asarray(jfrozen), **TOL)
    # the branch from the entry activation is the whole model
    np.testing.assert_allclose(tl_own.numpy(), tl.numpy(), **TOL)


@pytest.mark.parametrize("tie", [True, False])
def test_branch_param_subtree_is_a_detached_copy(tie):
    _, params, tm = _models("xla", tie=tie)
    sub = branch_param_subtree(tm.transformer.state_dict(), 3, tm.config)
    jsub = jax_branch_param_subtree(params["transformer"], 3, JAX_PRESETS["gpt2"].replace(
        **DIMS, tie_word_embeddings=tie))
    from trlx_tpu_torch.models.convert import _flatten

    assert sorted(sub) == sorted(_flatten(jax.tree.map(np.asarray, jsub)))
    head = "embed_tokens.embedding" if tie else "lm_head.kernel"
    assert head in sub and "layers_3.attn.q_proj.kernel" in sub and "layers_2.attn.q_proj.kernel" not in sub
    trunk = dict(tm.transformer.named_parameters())
    for name, value in sub.items():
        assert torch.equal(value, trunk[name]) and value.data_ptr() != trunk[name].data_ptr(), name
        assert not value.requires_grad


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_value_branch_matches_jax(impl):
    jm, params, tm = _models(impl, num_value_layers=2)
    ids, mask = _inputs(seed=5)
    jl, jv, jhid, _ = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), branch_layer=1)
    with torch.no_grad():
        tl, tv, thid, _ = tm(torch.from_numpy(ids), torch.from_numpy(mask), branch_layer=1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(thid.numpy(), np.asarray(jhid), **TOL)
    with pytest.raises(NotImplementedError, match="cached decode"):
        tm(torch.from_numpy(ids), torch.from_numpy(mask), cache=tm.init_cache(3, 16))


def test_init_value_branch_from_trunk_matches_jax():
    from trlx_tpu.models.policy import init_value_branch_from_trunk as jax_init
    from trlx_tpu_torch.models.convert import _flatten

    jm, params, tm = _models("xla", num_value_layers=2)
    jtree = _flatten(jax.tree.map(np.asarray, jax_init(dict(params), jm.config, 2)))
    state = init_value_branch_from_trunk(tm.state_dict(), tm.config, 2)
    assert sorted(state) == sorted(jtree)
    for name, value in state.items():
        np.testing.assert_array_equal(value.numpy(), jtree[name], err_msg=name)
    assert state["value_blocks_0.attn.q_proj.kernel"].data_ptr() != \
        state["transformer.layers_2.attn.q_proj.kernel"].data_ptr()


# ---------------------------------------------------------------------------- trainer

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
            target=6.0, horizon=1000, num_value_layers_unfrozen=1,
            gen_kwargs=dict(max_new_tokens=5, do_sample=False),
        ),
        train=dict(
            seq_length=16, epochs=2, total_steps=3, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False,
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=2,
            model_overrides=dict(
                vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=4, num_heads=2,
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


def test_hydra_ppo_trainer_matches_jax(tmp_path, single_device_mesh):
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    jcfg = JaxConfig.from_dict(_config_dict(tmp_path / "jax"))
    jt = jax_get_trainer("PPOTrainer")(config=jcfg, reward_fn=reward_fn)
    _attach_pipelines(jt, JaxPipeline, jcfg)
    assert jt.branch_start == 2 and jt.ref_params is None

    cfg = TRLConfig.from_dict(_config_dict(tmp_path / "port"))
    pt = get_trainer("PPOTrainer")(config=cfg, reward_fn=reward_fn, device="cpu")
    _attach_pipelines(pt, PromptPipeline, cfg)
    assert pt.branch_start == 2 and pt.ref_model is None
    assert sorted(k for k in pt.frozen_branch.state_dict()) == sorted(
        _flatten_np(jt.frozen_branch_params))
    pt.model.load_state_dict(policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)),
                                                    pt.model_config))
    pt.frozen_branch.load_state_dict(policy_branch_state(jt))
    frozen0 = {k: v.clone() for k, v in pt.model.state_dict().items() if not _trains(k)}
    branch0 = {k: v.clone() for k, v in pt.frozen_branch.state_dict().items()}
    assert any(k.startswith("transformer.layers_0.") for k in frozen0)
    assert "transformer.embed_tokens.embedding" in frozen0 and "transformer.ln_f.scale" in frozen0

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

    # the frozen trunk layers, embedding and final norm and the frozen branch
    # held bit for bit; the trained layers and the value branch moved
    state = pt.model.state_dict()
    for k, v in frozen0.items():
        assert torch.equal(state[k], v), k
    for k, v in pt.frozen_branch.state_dict().items():
        assert torch.equal(v, branch0[k]), k
    assert not torch.equal(state["transformer.layers_3.attn.q_proj.kernel"],
                           branch0["layers_3.attn.q_proj.kernel"])
    moved = policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)), pt.model_config)
    np.testing.assert_allclose(state["value_blocks_0.mlp.up_proj.kernel"].numpy(),
                               moved["value_blocks_0.mlp.up_proj.kernel"].numpy(), rtol=1e-3, atol=1e-5)


def _trains(name: str) -> bool:
    return not name.startswith("transformer.") or name.startswith(("transformer.layers_2.", "transformer.layers_3."))


def _flatten_np(tree):
    from trlx_tpu_torch.models.convert import _flatten

    return _flatten(jax.tree.map(np.asarray, jax.device_get(tree)))


def policy_branch_state(jt):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in _flatten_np(jt.frozen_branch_params).items()}
