"""Port parity for the trainers under peft: trlx_tpu_torch's ``PPOTrainer``
with LoRA, prefix and prompt tuning, with T5 LoRA, and ``SFTTrainer`` and
``ILQLTrainer`` with LoRA, against trlx_tpu's on the same tiny models (char
tokenizer, f32, greedy rollouts) from the same weights, the adapters drawn
non-zero from a seed in both packages before anything runs. Checked, after
``tests/test_trainers.py``'s peft cases: experience within 1e-4 (the KL
reference being the same trunk with the adapters disabled), every step's
stats within rtol 1e-3, greedy generations identical, no reference copy and
no trunk gradient or optimizer state, the trunk unchanged by training, and
the export's merged trunk and adapter file; LoRA PPO also under
``train.async_rollouts`` (and, in ``tests/test_torch_islands.py``, under
``train.islands``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu_torch.models.convert import policy_params_from_jax

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]
DIALOGUES = [["ab", "cd"], ["ef", "gh"], ["a b", "c d"], ["gh", "ab"], ["hhh", "a"], ["bad", "cafe e"],
             ["e", "fg ab"], ["dead", "beef"]]
STAT_TOL = dict(rtol=1e-3, atol=1e-5)
ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)
ADAPTERS = ("lora_a", "lora_b", "prefix_k", "prefix_v", "prompt_embeddings")
PEFT = {
    "lora": {"peft_type": "LORA", "r": 4, "lora_alpha": 8},
    "prefix": {"peft_type": "PREFIX_TUNING", "num_virtual_tokens": 3},
    "prompt": {"peft_type": "PROMPT_TUNING", "num_virtual_tokens": 3},
}
CAUSAL = dict(vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
              max_position_embeddings=64, attention_impl="flash")
T5 = dict(vocab_size=len(ALPHABET) + 3, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2,
          num_heads=4, relative_attention_num_buckets=8, decoder_start_token_id=1)


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def _config_dict(tmp_path, trainer, method, peft, seq2seq=False, train=None):
    model = dict(model_path="gpt2", num_layers_unfrozen=2, model_overrides=dict(CAUSAL), peft_config=peft)
    if seq2seq:
        model.update(model_path="t5", model_arch_type="seq2seq", model_overrides=dict(T5))
    return dict(
        method=method,
        train=dict(seq_length=16, epochs=4, total_steps=3, batch_size=4, minibatch_size=2,
                   checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
                   pipeline="PromptPipeline", trainer=trainer, tracker=None, seed=3, save_best=False,
                   **(train or {})),
        model=model,
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-2, betas=(0.9, 0.95), weight_decay=1e-4, max_grad_norm=1.0)),
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


def _seeded(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: (walk(v) if isinstance(v, dict) else
                    ((0.3 * rng.standard_normal(np.shape(v))).astype(np.float32) if k in ADAPTERS else v))
                for k, v in t.items()}

    return walk(tree)


def _trainers(tmp_path, trainer, method, peft, seq2seq=False, train=None):
    """Both packages' trainers, the JAX adapters re-drawn non-zero from a
    seed and the port loaded from the JAX params (``train``: more
    ``train`` config keys)."""
    import trlx_tpu.methods  # noqa: F401  (registers the method configs)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    extra = dict(reward_fn=reward_fn) if trainer == "PPOTrainer" else {}
    jt = jax_get_trainer(trainer)(
        config=JaxConfig.from_dict(_config_dict(tmp_path / "jax", trainer, method, peft, seq2seq, train)), **extra)
    pt = get_trainer(trainer)(
        config=TRLConfig.from_dict(_config_dict(tmp_path / "port", trainer, method, peft, seq2seq, train)),
        device="cpu", **extra)
    jparams = _seeded(jax.tree.map(np.asarray, jax.device_get(jt.params)), 5)
    jt.params = jax.tree.map(lambda new, old: jax.device_put(jnp.asarray(new), old.sharding), jparams, jt.params)
    if trainer == "SFTTrainer":
        key = "t5" if seq2seq else "transformer"
        state = policy_params_from_jax({key: jparams[key]}, pt.model_config) if seq2seq else None
        if state is None:
            from trlx_tpu_torch.models.convert import params_from_jax

            state = {f"transformer.{k}": v for k, v in params_from_jax(jparams["transformer"], pt.model_config).items()}
        pt.model.load_state_dict(state)
    else:
        pt.model.load_state_dict(policy_params_from_jax(jparams, pt.model_config))
    return jt, pt


def _stats_close(js, ps, keys):
    assert len(ps) == len(js)
    for i, (a, b) in enumerate(zip(js, ps)):
        compared = [k for k in a if k.split("/")[0] in keys]
        assert compared
        for k in compared:
            np.testing.assert_allclose(b[k], a[k], err_msg=f"step {i + 1} {k}", **STAT_TOL)


def _elements_close(je, pe):
    assert len(pe) == len(je) == 8
    for a, b in zip(je, pe):
        np.testing.assert_array_equal(b.query_tensor, np.asarray(a.query_tensor))
        np.testing.assert_array_equal(b.response_tensor, np.asarray(a.response_tensor))
        for field in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(getattr(b, field), np.asarray(getattr(a, field)), err_msg=field,
                                       **ELEMENT_TOL)


def _greedy_equal(jt, pt, n=4):
    prompts = [np.asarray(pt.tokenizer(p).input_ids, np.int32) for p in PROMPTS[:n]]
    js, jm, jp = jt.generate(prompts, eval_mode=True)
    ps, pm, pp = pt.generate(prompts, eval_mode=True)
    assert jp == pp
    np.testing.assert_array_equal(ps, np.asarray(js))
    np.testing.assert_array_equal(pm, np.asarray(jm))


def _frozen_trunk(pt, prefix):
    """The trunk's non-adapter tensors, and a check that none trains."""
    trunk = {n: p.detach().clone() for n, p in pt.model.named_parameters()
             if n.startswith(prefix) and n.rsplit(".", 1)[-1] not in ADAPTERS}
    trained = {id(p) for p in pt.trainable_params}
    for n, p in pt.model.named_parameters():
        if n in trunk:
            assert not p.requires_grad and id(p) not in trained, n
    return trunk


def _check_after(pt, trunk, prefix):
    """The trunk is unchanged, holds no gradient and no optimizer state;
    the adapters and heads do."""
    named = dict(pt.model.named_parameters())
    for n, v in trunk.items():
        assert torch.equal(named[n], v), n
        assert named[n].grad is None and named[n] not in pt.optimizer.state, n
    adapters = [n for n in named if n.rsplit(".", 1)[-1] in ADAPTERS]
    assert adapters and all(named[n] in pt.optimizer.state for n in adapters)
    assert all(named[n] in pt.optimizer.state for n in named if not n.startswith(prefix))


@pytest.mark.parametrize("kind", list(PEFT))
def test_ppo_peft_matches_jax(tmp_path, single_device_mesh, kind):
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu_torch.pipeline import PromptPipeline

    method = dict(name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05, target=None,
                  gen_kwargs=dict(max_new_tokens=5, do_sample=False))
    jt, pt = _trainers(tmp_path, "PPOTrainer", method, PEFT[kind])
    # peft wins over num_layers_unfrozen=2: no hydra branch, no reference copy
    assert pt.peft_base_ref and pt.ref_model is None and pt.frozen_branch is None and pt.branch_start is None
    trunk = _frozen_trunk(pt, "transformer.")
    for tr, cls in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.add_prompt_pipeline(cls(PROMPTS, 11, tr.tokenizer))
    runs = []
    for tr in (jt, pt):
        tr.prepare_learning()
        batches = list(tr.create_train_dataloader())[:2]
        runs.append((list(tr.store.history), [tr.train_step(b) for b in batches]))
    (je, js), (pe, ps) = runs
    _elements_close(je, pe)
    # the adapters move the policy off its reference from the first phase
    assert max(float(np.abs(e.rewards[:-1]).max()) for e in pe if len(e.rewards) > 1) > 0
    _stats_close(js, ps, ("losses", "values", "returns", "policy", "ratio", "learning_rate_group_0"))
    _greedy_equal(jt, pt)
    _check_after(pt, trunk, "transformer.")
    if kind != "lora":  # the engine refuses virtual rows: the padded generate serves
        pt.config.train.serving.enabled = True
        pt._resolve_serving()
        assert pt._serving_client is None


PPO_METHOD = dict(name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05, target=None,
                  gen_kwargs=dict(max_new_tokens=5, do_sample=False))


def async_lora_ppo_runs(tmp_path, train):
    """LoRA PPO in both packages under ``train`` (async rollouts, and
    whatever else the caller adds): the first store, filled by the producer
    at version 0 (no staleness), and two learner steps on it. Returns
    (JAX, port) as ((elements, stats), ...) and the port trainer, each
    trainer's producer stopped."""
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu_torch.pipeline import PromptPipeline

    jt, pt = _trainers(tmp_path, "PPOTrainer", PPO_METHOD, PEFT["lora"], train=train)
    assert pt.peft_base_ref and pt.ref_model is None
    for tr, cls in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.add_prompt_pipeline(cls(PROMPTS, 11, tr.tokenizer))
    runs = []
    try:
        for tr in (jt, pt):
            tr.prepare_learning()
            assert tr._engine is not None
            assert (tr._island is not None) == ("islands" in train)
            batches = list(tr.create_train_dataloader())[:2]
            runs.append((list(tr.store.history), [tr.train_step(b) for b in batches]))
    finally:
        jt.on_learn_end()
        pt.on_learn_end()
    for elements, stats in runs:
        assert all(e.policy_version == 0 for e in elements)
        for step in stats:
            # the producer's most recent chunk's KL: which chunk that is
            # depends on the producer thread's progress, in both packages
            step.pop("policy/sqrt_kl")
    return runs, pt


def test_ppo_lora_async_rollouts_matches_jax(tmp_path, single_device_mesh):
    """LoRA PPO under ``train.async_rollouts``: the producer's copy of the
    policy carries the adapters and scores its KL reference with them
    disabled, as the learner's does."""
    ((je, js), (pe, ps)), pt = async_lora_ppo_runs(
        tmp_path, dict(async_rollouts=dict(enabled=True, max_staleness=1)))
    assert any(n.endswith("lora_a") for n in pt._producer_model.state_dict())
    _elements_close(je, pe)
    _stats_close(js, ps, ("losses", "values", "returns", "policy", "ratio", "learning_rate_group_0"))


def test_ppo_t5_lora_matches_jax(tmp_path, single_device_mesh):
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu_torch.pipeline import PromptPipeline

    method = dict(name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05, target=None,
                  gen_kwargs=dict(max_new_tokens=5, do_sample=False))
    jt, pt = _trainers(tmp_path, "PPOTrainer", method, {"peft_type": "LORA", "r": 4, "lora_alpha": 16},
                       seq2seq=True)
    assert pt.is_seq2seq and pt.ref_model is None and pt.frozen_branch is None
    assert pt.model_config.lora_targets == ("q", "v")
    trunk = _frozen_trunk(pt, "t5.")
    for tr, cls in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.add_prompt_pipeline(cls(PROMPTS, 11, tr.tokenizer))
    runs = []
    for tr in (jt, pt):
        tr.prepare_learning()
        batches = list(tr.create_train_dataloader())[:2]
        runs.append((list(tr.store.history), [tr.train_step(b) for b in batches]))
    (je, js), (pe, ps) = runs
    _elements_close(je, pe)
    _stats_close(js, ps, ("losses", "values", "returns", "policy", "ratio", "learning_rate_group_0"))
    _greedy_equal(jt, pt)
    _check_after(pt, trunk, "t5.")


def test_sft_lora_matches_jax_and_exports_merged(tmp_path, single_device_mesh):
    from trlx_tpu_torch.models.hf_loading import load_adapters, load_pretrained
    from trlx_tpu_torch.models.transformer import TransformerLM

    jt, pt = _trainers(tmp_path, "SFTTrainer", dict(name="SFTConfig", gen_kwargs=dict(max_new_tokens=5,
                                                                                         do_sample=False)),
                       PEFT["lora"])
    trunk = _frozen_trunk(pt, "transformer.")
    runs = []
    for tr in (jt, pt):
        tr.make_experience(DIALOGUES[:7], tr.config.train.seq_length)
        tr.prepare_learning()
        batches = [b for _ in range(2) for b in tr.create_train_dataloader()][:3]
        runs.append([tr.train_step(b) for b in batches])
    _stats_close(runs[0], runs[1], ("losses", "learning_rate_group_0"))
    _greedy_equal(jt, pt)
    named = dict(pt.model.named_parameters())
    for n, v in trunk.items():
        assert torch.equal(named[n], v), n

    out = str(tmp_path / "export")
    pt.save_pretrained(out)
    config, state, _ = load_pretrained(out, {"compute_dtype": "float32"})
    assert not any("lora_" in k for k in state)
    merged = TransformerLM(config)
    merged.load_state_dict(state)
    ids = torch.tensor([[3, 4, 5, 6, 7]], dtype=torch.int32)
    with torch.no_grad():
        np.testing.assert_allclose(merged(ids)[0].numpy(), pt.model.transformer(ids)[0].numpy(),
                                   rtol=1e-4, atol=1e-4)
    state = pt.model.state_dict()
    fresh = {k: torch.zeros_like(v) for k, v in state.items()}
    restored = load_adapters(out, fresh)
    for k, v in state.items():
        if k.rsplit(".", 1)[-1] in ADAPTERS:
            assert torch.equal(restored[k], v), k


def test_ilql_lora_matches_jax(tmp_path, single_device_mesh):
    method = dict(name="ILQLConfig", steps_for_target_q_sync=2, two_qs=True,
                  gen_kwargs=dict(max_new_tokens=5, top_k=1, beta=1.0, temperature=1.0))
    jt, pt = _trainers(tmp_path, "ILQLTrainer", method, PEFT["lora"])
    trunk = _frozen_trunk(pt, "transformer.")
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
        runs.append(stats)
    _stats_close(runs[0], runs[1], ("losses", "values", "qvalues", "learning_rate_group_0"))
    _greedy_equal(jt, pt)
    named = dict(pt.model.named_parameters())
    for n, v in trunk.items():
        assert torch.equal(named[n], v), n


def test_check_port_config_accepts_every_peft_type(tmp_path):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.mesh_trainer import check_port_config

    method = dict(name="PPOConfig", num_rollouts=8, chunk_size=4)
    for peft in PEFT.values():
        check_port_config(TRLConfig.from_dict(_config_dict(tmp_path, "PPOTrainer", method, peft)))
    check_port_config(TRLConfig.from_dict(_config_dict(tmp_path, "PPOTrainer", method, PEFT["lora"], seq2seq=True)))
