"""Port parity for the seq2seq (T5) trainers: trlx_tpu_torch's
``SFTTrainer``, ``PPOTrainer`` (a full frozen reference at
``num_layers_unfrozen=-1``, the decoder-top branch at 1) and
``ILQLTrainer`` with ``model.model_arch_type="seq2seq"`` against
trlx_tpu's, on a tiny T5 (2+2 layers, d_model 32, char tokenizer, f32) from
the same weights (``policy_params_from_jax`` / ``t5_params_from_jax``):
collated batches identical, experience within 1e-4, every step's stats
within rtol 1e-3, greedy generations identical; PPO also under
``train.async_rollouts`` (the producer's copy of the T5 policy fills the
first store at version 0). Also: ``check_port_config``
accepts seq2seq and T5 LoRA, T5 refuses prompt tuning, and the SFT export
loads back through both packages' seq2seq loaders."""

import numpy as np
import pytest
import torch

import jax

from trlx_tpu_torch.models.convert import policy_params_from_jax, t5_params_from_jax

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]
DIALOGUES = [["ab", "cd"], ["ef", "gh"], ["a b", "c d"], ["gh", "ab"], ["hhh", "a"], ["bad", "cafe e"],
             ["e", "fg ab"], ["dead", "beef"]]
STAT_TOL = dict(rtol=1e-3, atol=1e-5)
ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def _config_dict(tmp_path, trainer, method, n_unfrozen=-1, train=None, **model):
    return dict(
        method=method,
        train=dict(seq_length=16, epochs=4, total_steps=3, batch_size=4, minibatch_size=2,
                   checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
                   pipeline="PromptPipeline", trainer=trainer, tracker=None, seed=3, save_best=False,
                   **(train or {})),
        model=dict(model_path="t5", model_arch_type="seq2seq", num_layers_unfrozen=n_unfrozen, model_overrides=dict(
            vocab_size=len(ALPHABET) + 3, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2,
            num_heads=4, relative_attention_num_buckets=8, decoder_start_token_id=1), **model),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4, max_grad_norm=1.0)),
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


def _trainers(tmp_path, trainer, method, **kw):
    import trlx_tpu.methods  # noqa: F401  (registers the method configs)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    extra = dict(reward_fn=reward_fn) if trainer == "PPOTrainer" else {}
    jt = jax_get_trainer(trainer)(config=JaxConfig.from_dict(_config_dict(tmp_path / "jax", trainer, method, **kw)),
                                  **extra)
    pt = get_trainer(trainer)(config=TRLConfig.from_dict(_config_dict(tmp_path / "port", trainer, method, **kw)),
                              device="cpu", **extra)
    assert pt.is_seq2seq and pt.model_type == "t5" and pt.decoder_start_token_id == 1
    return jt, pt, jax.tree.map(np.asarray, jax.device_get(jt.params))


def _greedy_equal(jt, pt, n=4):
    prompts = [np.asarray(pt.tokenizer(p).input_ids, np.int32) for p in PROMPTS[:n]]
    js, jm, jp = jt.generate(prompts, eval_mode=True)
    ps, pm, pp = pt.generate(prompts, eval_mode=True)
    assert jp == pp == 1
    np.testing.assert_array_equal(ps, np.asarray(js))
    np.testing.assert_array_equal(pm, np.asarray(jm))


def _stats_close(js, ps, keys):
    assert len(ps) == len(js)
    for i, (a, b) in enumerate(zip(js, ps)):
        compared = [k for k in a if k.split("/")[0] in keys]
        assert compared
        for k in compared:
            np.testing.assert_allclose(b[k], a[k], err_msg=f"step {i + 1} {k}", **STAT_TOL)


def test_sft_seq2seq_matches_jax(tmp_path, single_device_mesh):
    jt, pt, jparams = _trainers(tmp_path, "SFTTrainer", dict(name="SFTConfig", gen_kwargs=dict(
        max_new_tokens=5, do_sample=False)))
    pt.model.t5.load_state_dict(t5_params_from_jax(jparams["t5"], pt.model_config))
    runs = []
    for tr in (jt, pt):
        tr.make_experience(DIALOGUES[:7], tr.config.train.seq_length)
        tr.prepare_learning()
        batches = [b for _ in range(2) for b in tr.create_train_dataloader()][:3]
        runs.append((batches, [tr.train_step(b) for b in batches]))
    (jb, js), (pb, ps) = runs
    for a, b in zip(jb, pb):
        for key in ("input_ids", "attention_mask", "labels"):
            np.testing.assert_array_equal(b[key], a[key])
    _stats_close(js, ps, ("losses", "learning_rate_group_0"))
    _greedy_equal(jt, pt)


def test_sft_seq2seq_export_loads_in_both_packages(tmp_path):
    from trlx_tpu.models.hf_loading import load_pretrained_seq2seq as jax_load
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.models.hf_loading import load_pretrained_seq2seq
    from trlx_tpu_torch.models.t5 import T5LM
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.from_dict(_config_dict(tmp_path, "SFTTrainer", dict(name="SFTConfig")))
    pt = get_trainer("SFTTrainer")(config=cfg, device="cpu")
    out = str(tmp_path / "sft_t5")
    pt.save_pretrained(out)
    config2, state2 = load_pretrained_seq2seq(out, {"compute_dtype": "float32"})
    model = T5LM(config2)
    model.load_state_dict(state2)
    for k, v in pt.model.t5.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    jcfg, jparams = jax_load(out, overrides={})
    assert jcfg.decoder_start_token_id == 1 and jparams is not None


@pytest.mark.parametrize("n_unfrozen", [-1, 1])
def test_ppo_seq2seq_matches_jax(tmp_path, single_device_mesh, n_unfrozen):
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu_torch.models.policy import t5_branch_param_subtree
    from trlx_tpu_torch.pipeline import PromptPipeline

    method = dict(name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05, target=None,
                  gen_kwargs=dict(max_new_tokens=5, do_sample=False))
    jt, pt, jparams = _trainers(tmp_path, "PPOTrainer", method, n_unfrozen=n_unfrozen)
    pt.model.load_state_dict(policy_params_from_jax(jparams, pt.model_config))
    if n_unfrozen > 0:
        assert pt.branch_start == 1 and pt.ref_model is None
        pt.frozen_branch.load_state_dict(t5_branch_param_subtree(pt.model.t5.state_dict(), 1, pt.model_config))
        frozen = [n for n, p in pt.model.named_parameters() if not p.requires_grad]
        assert "t5.shared.embedding" in frozen and "t5.decoder_blocks_0.ln_1.scale" in frozen
        assert not any(n.startswith(("t5.decoder_blocks_1.", "t5.decoder_ln.", "v_head_mlp.")) for n in frozen)
    else:
        pt.ref_model.load_state_dict(pt.model.t5.state_dict())
    for tr, cls in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.add_prompt_pipeline(cls(PROMPTS, 11, tr.tokenizer))
    runs = []
    for tr in (jt, pt):
        tr.prepare_learning()
        batches = list(tr.create_train_dataloader())[:2]
        runs.append((list(tr.store.history), [tr.train_step(b) for b in batches]))
    (je, js), (pe, ps) = runs
    assert len(pe) == len(je) == 8
    for a, b in zip(je, pe):
        np.testing.assert_array_equal(b.query_tensor, np.asarray(a.query_tensor))
        np.testing.assert_array_equal(b.response_tensor, np.asarray(a.response_tensor))
        for field in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(getattr(b, field), np.asarray(getattr(a, field)), err_msg=field,
                                       **ELEMENT_TOL)
    _stats_close(js, ps, ("losses", "values", "returns", "policy", "ratio", "learning_rate_group_0"))
    _greedy_equal(jt, pt)


def test_ppo_seq2seq_async_rollouts_matches_jax(tmp_path, single_device_mesh):
    """``train.async_rollouts``: each producer thread generates, scores and
    queues from its copy of the T5 policy; the first store (version 0, so
    no staleness) and two learner steps on it match the JAX trainer's."""
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu_torch.models.policy import Seq2SeqLMWithValueHead
    from trlx_tpu_torch.pipeline import PromptPipeline

    method = dict(name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05, target=None,
                  gen_kwargs=dict(max_new_tokens=5, do_sample=False))
    jt, pt, jparams = _trainers(tmp_path, "PPOTrainer", method,
                                train=dict(async_rollouts=dict(enabled=True, max_staleness=1)))
    pt.model.load_state_dict(policy_params_from_jax(jparams, pt.model_config))
    pt.ref_model.load_state_dict(pt.model.t5.state_dict())
    for tr, cls in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.add_prompt_pipeline(cls(PROMPTS, 11, tr.tokenizer))
    runs = []
    try:
        for tr in (jt, pt):
            tr.prepare_learning()
            batches = list(tr.create_train_dataloader())[:2]
            runs.append((list(tr.store.history), [tr.train_step(b) for b in batches]))
        assert isinstance(pt._producer_model, Seq2SeqLMWithValueHead) and pt._engine is not None
    finally:
        jt.on_learn_end()
        pt.on_learn_end()
    (je, js), (pe, ps) = runs
    for step in js + ps:
        # the producer's most recent chunk's KL: which chunk that is depends
        # on the producer thread's progress, in both packages
        step.pop("policy/sqrt_kl")
    assert len(pe) == len(je) == 8
    for a, b in zip(je, pe):
        assert b.policy_version == a.policy_version == 0
        np.testing.assert_array_equal(b.query_tensor, np.asarray(a.query_tensor))
        np.testing.assert_array_equal(b.response_tensor, np.asarray(a.response_tensor))
        for field in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(getattr(b, field), np.asarray(getattr(a, field)), err_msg=field,
                                       **ELEMENT_TOL)
    _stats_close(js, ps, ("losses", "values", "returns", "policy", "ratio", "learning_rate_group_0"))
    assert pt._engine is None and pt.rollout_engine_summary["produced"] >= 8


def test_ilql_seq2seq_matches_jax(tmp_path, single_device_mesh):
    method = dict(name="ILQLConfig", steps_for_target_q_sync=2, two_qs=True,
                  gen_kwargs=dict(max_new_tokens=5, top_k=1, beta=1.0, temperature=1.0))
    jt, pt, jparams = _trainers(tmp_path, "ILQLTrainer", method)
    pt.model.load_state_dict(policy_params_from_jax(jparams, pt.model_config))
    rewards = [1.0, 0.5, -0.5, 0.25, 0.0, 2.0, -1.0, 0.75]
    runs = []
    for tr in (jt, pt):
        tr.make_experience(DIALOGUES, rewards, tr.config.train.seq_length)
        tr.prepare_learning()
        batches = [b for _ in range(2) for b in tr.create_train_dataloader()][:4]
        stats = []
        for b in batches:
            stats.append(tr.train_step(b))
            tr.iter_count += 1
            tr.post_backward_callback()
        runs.append((batches, stats))
    (jb, js), (pb, ps) = runs
    for a, b in zip(jb, pb):
        for field in ("input_ids", "attention_mask", "decoder_input_ids", "rewards", "states_ixs", "actions_ixs",
                      "dones"):
            np.testing.assert_array_equal(getattr(b, field), np.asarray(getattr(a, field)), err_msg=field)
    _stats_close(js, ps, ("losses", "values", "qvalues", "learning_rate_group_0"))
    _greedy_equal(jt, pt)


def test_check_port_config_accepts_seq2seq_but_not_t5_peft(tmp_path):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.mesh_trainer import check_port_config

    d = _config_dict(tmp_path, "SFTTrainer", dict(name="SFTConfig"))
    check_port_config(TRLConfig.from_dict(d))
    d["model"]["peft_config"] = {"peft_type": "LORA", "r": 4}
    check_port_config(TRLConfig.from_dict(d))  # T5 LoRA: ported (tests/test_torch_peft_trainers.py)
    d["model"]["peft_config"] = {"peft_type": "PROMPT_TUNING"}
    from trlx_tpu_torch.utils.loading import get_trainer

    with pytest.raises(NotImplementedError, match="LORA"):  # T5 takes LoRA only, as in the JAX package
        get_trainer("SFTTrainer")(config=TRLConfig.from_dict(d), device="cpu")
