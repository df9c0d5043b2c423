"""Port parity for ILQL: trlx_tpu_torch against trlx_tpu in f32 on the CPU
(the JAX flash kernels in interpret mode, the port's plain versions), on
seeded numpy inputs and weights carried by ``policy_params_from_jax``.

Checked: ``ILQLConfig.loss`` and its stats and ``sync_target_q_heads``
within 1e-5; ``make_experience``'s store arrays equal; the ILQL heads and
the advantage-shaped logits processor (with a ``logit_mask``) within 1e-5;
greedy generation through the processor identical token for token;
``ILQLTrainer`` for three optimizer steps of two microbatches with a target
sync (stats within rtol 1e-3, atol 1e-5), and the list-valued ``beta`` that
``evaluate`` sweeps. Also ``train(samples=..., rewards=...)`` and its
default config reach the port's ILQL trainer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu_torch.models.convert import _flatten, policy_params_from_jax

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
STAT_TOL = dict(rtol=1e-3, atol=1e-5)
ALPHABET = "abcdefgh "
SAMPLES = [["ab", "cd"], ["ef", "gh"], ["a", "bc"], ["de", "fg"], ["h", "abc d"], ["b a", "e"],
           ["cc", "ddd"], ["g", "a"]]
REWARDS = [1.0, 0.5, -0.5, 0.25, 0.75, -1.0, 0.0, 2.0]
PROMPTS = ["ab", "ef", "c", "hg"]


def _config_dict(tmp_path, beta=1.0):
    return dict(
        method=dict(name="ILQLConfig", steps_for_target_q_sync=2, two_qs=True, alpha=0.1, beta=0.5,
                    gen_kwargs=dict(max_new_tokens=4, top_k=4, beta=beta, do_sample=False)),
        train=dict(
            seq_length=16, epochs=4, total_steps=3, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="ILQLTrainer", tracker=None, seed=2, save_best=False,
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


def _logit_mask(V):
    """A seeded [V, V] successor mask; every row allows at least two tokens."""
    rng = np.random.default_rng(7)
    mask = rng.random((V, V)) < 0.5
    mask[:, :2] = True
    return mask


def _trainers(tmp_path, beta=1.0, logit_mask=None):
    """(JAX trainer, port trainer) on the same weights (the JAX init,
    perturbed so the Q heads and their targets differ)."""
    import trlx_tpu.methods  # noqa: F401  (registers ILQLConfig)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    kw = {} if logit_mask is None else {"logit_mask": logit_mask}
    jt = jax_get_trainer("ILQLTrainer")(config=JaxConfig.from_dict(_config_dict(tmp_path / "jax", beta)), **kw)
    leaves, treedef = jax.tree.flatten(jt.params)
    rng = np.random.default_rng(1)
    leaves = [jax.device_put(np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32), x.sharding)
              for x in leaves]
    jt.params = jax.tree.unflatten(treedef, leaves)
    pt = get_trainer("ILQLTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path / "port", beta)),
                                     device="cpu", **kw)
    pt.model.load_state_dict(policy_params_from_jax(jax.tree.map(np.asarray, jt.params), pt.model_config))
    return jt, pt


def _batch(seed=0, B=3, T=10, A=6, V=11):
    from trlx_tpu.data.ilql_types import ILQLBatch as JaxBatch

    rng = np.random.default_rng(seed)
    arrays = dict(
        input_ids=rng.integers(0, V, (B, T)).astype(np.int32),
        attention_mask=np.ones((B, T), np.int32),
        rewards=rng.normal(size=(B, A)).astype(np.float32),
        states_ixs=np.sort(rng.integers(0, T - 1, (B, A + 1)), axis=1).astype(np.int32),
        actions_ixs=np.sort(rng.integers(0, T - 1, (B, A)), axis=1).astype(np.int32),
        dones=(np.arange(A + 1)[None, :] < rng.integers(2, A + 2, (B, 1))).astype(np.int32),
    )
    outputs = [rng.normal(size=(B, A, V)).astype(np.float32) for _ in range(5)]  # logits, q0, q1, tq0, tq1
    vs = rng.normal(size=(B, A + 1, 1)).astype(np.float32)
    return arrays, outputs, vs, JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("two_qs", [True, False])
def test_ilql_loss_matches_jax(two_qs):
    from trlx_tpu.methods.ilql import ILQLConfig as JaxILQL
    from trlx_tpu.utils.modeling import flatten_dict as jax_flatten
    from trlx_tpu_torch.data.ilql_types import ILQLBatch
    from trlx_tpu_torch.methods.ilql import ILQLConfig
    from trlx_tpu_torch.utils.modeling import flatten_dict

    arrays, (logits, *heads), vs, jbatch = _batch(seed=3)
    n = 2 if two_qs else 1
    hp = dict(tau=0.6, gamma=0.9, cql_scale=0.2, awac_scale=0.7, beta=0.5)
    jl, js = JaxILQL(**hp).loss(
        (jnp.asarray(logits), (tuple(map(jnp.asarray, heads[:n])), tuple(map(jnp.asarray, heads[2:2 + n])),
                               jnp.asarray(vs))), jbatch)
    t = torch.from_numpy
    tl, ts = ILQLConfig(**hp).loss(
        (t(logits), (tuple(map(t, heads[:n])), tuple(map(t, heads[2:2 + n])), t(vs))),
        ILQLBatch(**{k: t(v) for k, v in arrays.items()}))
    js, ts = jax_flatten(js), flatten_dict(ts)
    assert sorted(js) == sorted(ts) and len(ts) == 7 + n
    for k in js:
        np.testing.assert_allclose(float(ts[k]), float(js[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_topk_mask_and_batched_index_select_match_jax():
    from trlx_tpu.methods.ilql import batched_index_select as jbis
    from trlx_tpu.methods.ilql import topk_mask as jtopk
    from trlx_tpu_torch.methods.ilql import batched_index_select, topk_mask

    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 9)).astype(np.float32)
    idx = rng.integers(0, 5, (3, 4)).astype(np.int32)
    np.testing.assert_array_equal(topk_mask(torch.from_numpy(x), 3).numpy(), np.asarray(jtopk(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(batched_index_select(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
                                  np.asarray(jbis(jnp.asarray(x), jnp.asarray(idx))))


def test_sync_target_q_heads_matches_jax(tmp_path, single_device_mesh):
    from trlx_tpu.models.heads import sync_target_q_heads as jax_sync
    from trlx_tpu_torch.models.heads import sync_target_q_heads

    jt, pt = _trainers(tmp_path)
    jheads = jax_sync(dict(jax.device_get(jt.params)["ilql_heads"]), 0.3)
    sync_target_q_heads(pt.model.ilql_heads, 0.3)
    want = _flatten(jax.tree.map(np.asarray, jheads))
    got = pt.model.ilql_heads.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], err_msg=k, **TOL)
    assert not any(p.requires_grad for name, p in pt.model.named_parameters() if "target_q_heads" in name)
    assert all(p.requires_grad for name, p in pt.model.named_parameters() if "target_q_heads" not in name)


@pytest.mark.parametrize("side", ["right", "left"])
def test_make_experience_matches_jax(side):
    from trlx_tpu.pipeline.tokenization import load_tokenizer as jax_tok
    from trlx_tpu.trainer.ilql_trainer import make_experience as jax_make
    from trlx_tpu_torch.data.configs import TokenizerConfig
    from trlx_tpu_torch.pipeline.tokenization import load_tokenizer
    from trlx_tpu_torch.trainer.ilql_trainer import make_experience

    samples = SAMPLES + ["abc", ["a", "b", "cd", "e f"]]
    rewards = REWARDS + [0.3, -0.2]
    from trlx_tpu.data.configs import TokenizerConfig as JaxTokenizerConfig

    jstore = jax_make(samples, rewards, jax_tok(JaxTokenizerConfig(f"char://{ALPHABET}", truncation_side=side)), 7)
    store = make_experience(samples, rewards, load_tokenizer(TokenizerConfig(f"char://{ALPHABET}",
                                                                               truncation_side=side)), 7)
    assert len(store) == len(jstore) == len(samples)
    for i in range(len(store)):
        a, b = store[i], jstore[i]
        for field in ("input_ids", "attention_mask", "rewards", "states_ixs", "actions_ixs", "dones"):
            np.testing.assert_array_equal(np.asarray(getattr(a, field)), np.asarray(getattr(b, field)),
                                          err_msg=f"{i} {field}")
    jbatch = next(iter(jstore.create_loader(4, shuffle=True, seed=5)))
    batch = next(iter(store.create_loader(4, shuffle=True, seed=5)))
    for field in ("input_ids", "attention_mask", "rewards", "states_ixs", "actions_ixs", "dones"):
        np.testing.assert_array_equal(getattr(batch, field), np.asarray(getattr(jbatch, field)), err_msg=field)


def test_logits_processor_matches_jax(tmp_path, single_device_mesh):
    V = len(ALPHABET) + 3
    mask = _logit_mask(V)
    jt, pt = _trainers(tmp_path, beta=2.5, logit_mask=mask)
    rng = np.random.default_rng(4)
    hidden = rng.normal(size=(5, 32)).astype(np.float32)
    logits = rng.normal(size=(5, V)).astype(np.float32)
    prev = rng.integers(0, V, (5,)).astype(np.int32)
    want = jt.gen_logits_processor()(jt.params, jnp.asarray(hidden), jnp.asarray(logits), jnp.asarray(prev))
    with torch.no_grad():
        got = pt.gen_logits_processor()(torch.from_numpy(hidden), torch.from_numpy(logits), torch.from_numpy(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy()[~mask[prev]] == -1e10).all()
    # the heads themselves, at every position
    h3 = rng.normal(size=(2, 3, 32)).astype(np.float32)
    jq, jtq, jv = jt.module.apply({"params": jt.params}, jnp.asarray(h3), method=jt.module.heads_only)
    with torch.no_grad():
        tq, ttq, tv = pt.model.heads_only(torch.from_numpy(h3))
    for a, b in zip((*tq, *ttq, tv), (*jq, *jtq, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_greedy_generate_with_processor_is_identical(tmp_path, single_device_mesh, with_mask):
    V = len(ALPHABET) + 3
    jt, pt = _trainers(tmp_path, beta=3.0, logit_mask=_logit_mask(V) if with_mask else None)
    prompts = [np.asarray(jt.tokenizer(p, add_special_tokens=False).input_ids, np.int32) for p in PROMPTS]
    jseq, jmask, jP = jt.generate(prompts, eval_mode=True)
    pseq, pmask, pP = pt.generate(prompts, eval_mode=True)
    assert jP == pP
    np.testing.assert_array_equal(pseq, np.asarray(jseq))
    np.testing.assert_array_equal(pmask, np.asarray(jmask))
    # the processor moves the output: beta 0 decodes the plain policy
    plain, _, _ = pt.generate(prompts, eval_mode=True, beta=0.0)
    jplain, _, _ = jt.generate(prompts, eval_mode=True, beta=0.0)
    np.testing.assert_array_equal(plain, np.asarray(jplain))
    assert not np.array_equal(plain, pseq)


def _record(trainer):
    steps, step = [], trainer.train_step

    def train_step(batch):
        out = step(batch)
        steps.append(dict(out))
        return out

    trainer.train_step = train_step
    return steps


def _metric_fn(samples, **kw):
    return {"a_share": [s.count("a") / max(len(s), 1) for s in samples]}


def test_ilql_trainer_matches_jax(tmp_path, single_device_mesh):
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu_torch.pipeline import PromptPipeline

    jt, pt = _trainers(tmp_path)
    heads0 = {k: v.clone() for k, v in pt.model.ilql_heads.state_dict().items()}
    for tr, pipe in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.make_experience(SAMPLES, REWARDS, tr.config.train.seq_length)
        tr.add_eval_pipeline(pipe(PROMPTS, 12, tr.tokenizer))
        tr.metric_fn = _metric_fn
    jsteps, psteps = _record(jt), _record(pt)
    jres, pres = jt.learn(), pt.learn()
    assert len(psteps) == len(jsteps) == 3
    for i, (js, ps) in enumerate(zip(jsteps, psteps)):
        assert sorted(ps) == sorted(js)
        for key in js:
            np.testing.assert_allclose(ps[key], js[key], err_msg=f"step {i + 1} {key}", **STAT_TOL)
    assert pres["metrics/a_share"] == jres["metrics/a_share"]
    # the target heads moved at the step-2 sync only, as the JAX ones
    state = pt.model.ilql_heads.state_dict()
    assert not torch.equal(state["target_q_heads_0.fc_out.kernel"], heads0["target_q_heads_0.fc_out.kernel"])
    want = _flatten(jax.tree.map(np.asarray, jax.device_get(jt.params)["ilql_heads"]))
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), want[k], err_msg=k, rtol=1e-3, atol=1e-5)


def test_beta_list_is_swept_by_evaluate(tmp_path, single_device_mesh):
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu_torch.pipeline import PromptPipeline

    jt, pt = _trainers(tmp_path, beta=[1.0, 4.0])
    assert pt.ilql_beta == jt.ilql_beta == 1.0 and pt.generate_kwargs["beta"] == [1.0, 4.0]
    results = []
    for tr, pipe in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.add_eval_pipeline(pipe(PROMPTS, 12, tr.tokenizer))
        tr.metric_fn = _metric_fn
        results.append(tr.evaluate())
    jres, pres = results
    assert sorted(pres) == sorted(jres) == ["metrics/a_share@beta=1.0", "metrics/a_share@beta=4.0"]
    assert pres == jres


def test_train_with_samples_and_rewards_runs_ilql(tmp_path, monkeypatch):
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data import default_configs
    from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer

    cfg = TRLConfig.from_dict(_config_dict(tmp_path))
    trainer = trlx_tpu_torch.train(samples=SAMPLES, rewards=REWARDS, eval_prompts=PROMPTS, config=cfg, device="cpu")
    assert isinstance(trainer, ILQLTrainer) and trainer.iter_count == 3
    with pytest.raises(ValueError, match="should match"):
        trlx_tpu_torch.train(samples=SAMPLES, rewards=REWARDS[:3], config=cfg, device="cpu")
    # config=None with rewards picks the ILQL default
    from trlx_tpu_torch import trlx as entry

    seen = {}

    def fake_get_trainer(name):
        seen["trainer"] = name
        raise RuntimeError("stop")

    monkeypatch.setattr(entry, "get_trainer", fake_get_trainer)
    with pytest.raises(RuntimeError, match="stop"):
        trlx_tpu_torch.train(samples=SAMPLES, rewards=REWARDS, device="cpu")
    assert seen["trainer"] == "ILQLTrainer" == default_configs.default_ilql_config().train.trainer


def test_q_head_matches_jax():
    from trlx_tpu.models.heads import QHead as JaxQHead
    from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
    from trlx_tpu_torch.models.heads import QHead
    from trlx_tpu_torch.models.presets import PRESETS

    dims = dict(vocab_size=13, hidden_size=16, num_layers=1, num_heads=2)
    jm = JaxQHead(JAX_PRESETS["gpt2"].replace(**dims, compute_dtype=jnp.float32))
    x = np.random.default_rng(3).normal(size=(2, 5, 16)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = QHead(PRESETS["gpt2"].replace(**dims, compute_dtype=torch.float32))
    flat = _flatten(jax.tree.map(np.asarray, params))
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in flat.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 5, 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": params}, jnp.asarray(x))), **TOL)
