"""Port parity for the stacked layer layout on one device (``scan_layers``, or
``pipeline_stages > 1`` with no pipe axis): trlx_tpu_torch's ``layers_scan``
``TransformerLM`` against trlx_tpu's on the same weights (a JAX
``layers_scan`` tree carried across by ``params_from_jax``) and the same
seeded numpy inputs, f32 on the CPU — the counterparts of
``tests/test_pipeline_parallel.py``'s stacked-layout cases and
``tests/test_generation.py``'s stacked int8 cache.

Checked against JAX (atol 1e-5): forward logits (plain and flash: the JAX
kernel in interpret mode), the gradients of a scalar loss, greedy
``generate`` over a bf16 and an int8 stacked cache (tokens identical), and
``paged_verify`` over stacked int8 pools (logits, and the pools within one
int8 step). Within the port: stacked against listed on the same weights
(forward and gradients within 1e-6, remat included; cached decode; one
layer's pool view writes in place), forwards on many threads,
``stack_layer_params`` / ``unstack_layer_params`` as inverses
(hypothesis). The trainers with ``scan_layers`` (or ``pipeline_stages >
1`` and ``mesh.pipe == 1``): SFT's per-step loss and PPO's experience and
stats against JAX's, ILQL, GRPO and RFT one finite step each; the HF
export of a stacked model reloads ``torch.equal`` into both layouts and
into a stacked trainer; a stacked checkpoint resumes exactly. Every case
the JAX package refuses for a stacked model raises here with its message,
and the scale-out cases stay refused.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu.models.transformer import TransformerLM as JaxLM
from trlx_tpu_torch.models.convert import load_jax_params, params_from_jax, policy_params_from_jax
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.ops.generation import left_pad_batch
from trlx_tpu_torch.models.transformer import (
    STACKED_BRANCH_ERROR,
    STACKED_CAPTURE_ERROR,
    TransformerLM,
)
from trlx_tpu_torch.parallel.pipeline import pick_microbatches, stack_layer_params, unstack_layer_params

pytestmark = pytest.mark.torch_port

DIMS = dict(vocab_size=256, hidden_size=64, num_layers=3, num_heads=4, intermediate_size=128,
            max_position_embeddings=64)
TOL = dict(rtol=1e-5, atol=1e-5)
ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]
STAT_TOL = dict(rtol=1e-3, atol=1e-5)
ELEMENT_TOL = dict(rtol=1e-4, atol=1e-4)


def _models(scale=1.0, **over):
    """The JAX stacked module and params (perturbed off their init) and the
    port's stacked module loaded from them."""
    jcfg = JAX_PRESETS["gpt2"].replace(**DIMS, compute_dtype=jnp.float32, scan_layers=True, **over)
    tcfg = PRESETS["gpt2"].replace(**DIMS, compute_dtype=torch.float32, scan_layers=True, **over)
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))["params"]
    assert "layers_scan" in params and "layers_0" not in params
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(1)
    leaves = [(np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)) * scale
              for x in leaves]
    params = jax.tree.unflatten(treedef, leaves)
    return jm, params, load_jax_params(TransformerLM(tcfg), params)


def _listed_twin(tm: TransformerLM) -> TransformerLM:
    """The listed model holding the stacked one's weights."""
    listed = TransformerLM(tm.config.replace(scan_layers=False, pipeline_stages=1))
    listed.load_state_dict(unstack_layer_params(tm.state_dict(), tm.config.num_layers))
    return listed


def _inputs(B=3, T=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, DIMS["vocab_size"], (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, :4] = 0  # left padding
    mask[2, :T - 2] = 0
    return ids, mask


# ----------------------------------------------------------- against JAX


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_match_jax(impl):
    jm, params, tm = _models(attention_impl=impl)
    names = list(tm.state_dict())
    assert "layers_scan.attn.q_proj.kernel" in names and not any(n.startswith("layers_0.") for n in names)
    assert tm.state_dict()["layers_scan.attn.q_proj.kernel"].shape == (3, 64, 64)
    ids, mask = _inputs()
    jl = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))[0]
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids), torch.from_numpy(mask))[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _loss_weights(shape):
    return np.random.default_rng(7).standard_normal(shape).astype(np.float32)


def test_gradients_match_jax():
    jm, params, tm = _models(attention_impl="flash")
    ids, mask = _inputs()
    w = _loss_weights((3, 12, DIMS["vocab_size"]))
    # a mean over the real tokens, as a trainer's loss is
    valid = mask[:, :, None].astype(np.float32) / mask.sum()

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask))[0]
        return jnp.sum(jnp.tanh(logits) * w * valid)

    jgrads = jax.tree.map(np.asarray, jax.grad(jloss)(params))
    tl = tm(torch.from_numpy(ids), torch.from_numpy(mask))[0]
    (torch.tanh(tl) * torch.from_numpy(w) * torch.from_numpy(valid)).sum().backward()
    flat = params_from_jax(jgrads, tm.config)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat[name].numpy(), err_msg=name, **TOL)


def _jax_generate(jm, params, ids, mask, n_new, cache_dtype):
    from trlx_tpu.ops.generation import generate as jax_generate

    def step(p, i, m, pos, cache):
        logits, hidden, _, cache = jm.apply({"params": p}, i, m, pos, cache)
        return logits, hidden, cache

    out = jax_generate(step, params, lambda b, s: jm.init_cache(b, s, cache_dtype), jnp.asarray(ids),
                       jnp.asarray(mask), jax.random.PRNGKey(0), n_new, pad_token_id=0, do_sample=False)
    return np.asarray(out["sequences"]), np.asarray(out["response_mask"])


def _torch_generate(tm, ids, mask, n_new, cache_dtype):
    from trlx_tpu_torch.ops.generation import generate

    def step(i, m, pos, cache):
        logits, hidden, _, cache = tm(i, m, pos, cache)
        return logits, hidden, cache

    with torch.no_grad():
        out = generate(step, lambda b, s: tm.init_cache(b, s, cache_dtype), torch.from_numpy(ids),
                       torch.from_numpy(mask), None, n_new, pad_token_id=0, do_sample=False)
    return out["sequences"].numpy(), out["response_mask"].numpy()


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_greedy_generate_over_a_stacked_cache_matches_jax(cache):
    quant = cache == "int8"
    jm, params, tm = _models(scale=4.0, kv_cache_quant=quant)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, DIMS["vocab_size"], n).astype(np.int32) for n in (5, 8, 2, 7)]
    ids, mask = left_pad_batch(prompts, 0, 8)
    ids, mask = np.asarray(ids), np.asarray(mask)
    tdtype, jdtype = (None, None) if quant else (torch.bfloat16, jnp.bfloat16)
    cache0 = tm.init_cache(4, 18, tdtype)
    assert cache0["k"].shape == (3, 4, 4, 18, 16)  # one [L, B, Hkv, S, D] leaf
    assert cache0["k"].dtype == (torch.int8 if quant else torch.bfloat16)
    if quant:
        assert cache0["k_scale"].shape == (3, 4, 4, 18, 1)
    js, jmask = _jax_generate(jm, params, ids, mask, 10, jdtype)
    ts, tmask = _torch_generate(tm, ids, mask, 10, tdtype)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tmask, jmask)


def test_paged_verify_over_stacked_int8_pools_matches_jax():
    """Two verify rounds through the same block tables from empty stacked
    int8 pools (slot 2 idle on the null block): logits and every layer's
    written pool rows agree."""
    jm, params, tm = _models(kv_cache_quant=True, paged_attention_impl="xla")
    rng = np.random.default_rng(3)
    B, NB, BS, MB, Q = 3, 10, 4, 3, 3
    tables = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    jcache = jm.init_paged_cache(NB, BS, MB, B)
    tcache = tm.init_paged_cache(NB, BS, MB, B)
    assert tcache["k"].shape == (3, NB, BS, 4, 16) and tcache["k_scale"].shape == (3, NB, BS, 4)
    jcache["block_tables"] = jnp.asarray(tables)
    tcache["block_tables"] = torch.from_numpy(tables.copy())
    for r, lens in enumerate((np.array([0, 0, 0], np.int32), np.array([3, 2, 0], np.int32))):
        tokens = rng.integers(1, DIMS["vocab_size"], (B, Q)).astype(np.int32)
        jcache["context_lens"] = jnp.asarray(lens)
        tcache["context_lens"] = torch.from_numpy(lens.copy())
        jl, _, jcache = jm.apply({"params": params}, jnp.asarray(tokens), jcache, method=jm.paged_verify)
        with torch.no_grad():
            tl, _, tcache = tm.paged_verify(torch.from_numpy(tokens), tcache)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], err_msg=f"round {r}", **TOL)
        assert np.isfinite(tl[2].numpy()).all()
    live = tables[:2][tables[:2] > 0]
    for key in ("k", "v", "k_scale", "v_scale"):
        tb, jb = tcache[key].numpy()[:, live], np.asarray(jcache[key])[:, live]
        if key in ("k", "v"):
            assert np.abs(tb.astype(np.int32) - jb.astype(np.int32)).max() <= 1, key
        else:
            np.testing.assert_allclose(tb, jb, err_msg=key, **TOL)


# ------------------------------------------------ stacked against listed


@pytest.mark.parametrize("remat", ["none", "per_layer", "dots_saveable"])
def test_stacked_equals_listed_forward_and_gradients(remat):
    _, _, tm = _models(attention_impl="flash", remat=remat)
    listed = _listed_twin(tm)
    ids, mask = _inputs()
    w = torch.from_numpy(_loss_weights((3, 12, DIMS["vocab_size"])))
    outs = []
    for model in (tm, listed):
        logits = model(torch.from_numpy(ids), torch.from_numpy(mask))[0]
        (torch.tanh(logits) * w).sum().backward()
        outs.append(logits.detach())
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)
    grads = {n: p.grad for n, p in listed.named_parameters()}
    for name, grad in unstack_layer_params({n: p.grad for n, p in tm.named_parameters()}, 3).items():
        torch.testing.assert_close(grad, grads[name], rtol=0, atol=1e-6, msg=name)


@pytest.mark.parametrize("quant", [False, True], ids=["f32kv", "int8kv"])
def test_stacked_cached_decode_equals_listed_and_writes_the_leaf_in_place(quant):
    _, _, tm = _models(kv_cache_quant=quant)
    listed = _listed_twin(tm)
    ids, mask = _inputs(T=8)
    caches = [tm.init_cache(3, 10), listed.init_cache(3, 10)]
    leaf = caches[0]["k"]
    full = np.concatenate([mask, np.zeros((3, 2), np.int32)], 1)
    with torch.no_grad():
        logits = [m(torch.from_numpy(ids), torch.from_numpy(full), None, c)[0] for m, c in zip((tm, listed), caches)]
        torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=1e-6)
        full[:, 8] = 1
        tok = torch.from_numpy(ids[:, -1:].copy())
        logits = [m(tok, torch.from_numpy(full), None, c)[0] for m, c in zip((tm, listed), caches)]
        torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=1e-6)
    assert caches[0]["k"] is leaf and caches[0]["index"] == caches[1]["index"] == 9
    for key in caches[1]:
        if key != "index":
            for i in range(3):
                torch.testing.assert_close(caches[0][key][i], caches[1][key][i], rtol=0, atol=1e-6)


def test_stacked_forwards_on_many_threads_each_see_their_own_layer():
    """A stacked layer runs by swapping the block's parameters for one
    layer's views: forwards on more threads than cores, switching every
    microsecond, each give the single-threaded logits (a swap seen by
    another thread's layer would give another layer's weights)."""
    import os
    import sys
    import threading

    _, _, tm = _models()
    ids, mask = _inputs()
    with torch.no_grad():
        want = tm(torch.from_numpy(ids), torch.from_numpy(mask))[0]
    got, errors = [], []

    def run():
        try:
            with torch.no_grad():
                for _ in range(4):
                    got.append(tm(torch.from_numpy(ids), torch.from_numpy(mask))[0])
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(2 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(got) == 4 * len(threads) and all(torch.equal(g, want) for g in got)


_BLOCK_PATHS = st.lists(
    st.tuples(st.sampled_from(["attn.q_proj", "attn.o_proj", "mlp.up_proj", "ln_1", "prefix"]),
              st.sampled_from(["kernel", "bias", "scale", "lora_a"]),
              st.lists(st.integers(1, 3), min_size=0, max_size=3)),
    min_size=1, max_size=6, unique_by=lambda t: (t[0], t[1]))


@settings(max_examples=25, deadline=None)
@given(L=st.integers(1, 5), paths=_BLOCK_PATHS, seed=st.integers(0, 2 ** 16))
def test_stack_and_unstack_are_inverses(L, paths, seed):
    g = torch.Generator().manual_seed(seed)
    listed = {"embed_tokens.embedding": torch.randn(4, 2, generator=g), "ln_f.scale": torch.randn(2, generator=g)}
    for mod, leaf, shape in paths:
        for i in range(L):
            listed[f"layers_{i}.{mod}.{leaf}"] = torch.randn(tuple(shape), generator=g)
    stacked = stack_layer_params(listed, L)
    assert not any(k.startswith("layers_0.") for k in stacked)
    for mod, leaf, shape in paths:
        assert stacked[f"layers_scan.{mod}.{leaf}"].shape == (L, *shape)
    back = unstack_layer_params(stacked, L)
    assert set(back) == set(listed) and all(torch.equal(back[k], listed[k]) for k in listed)
    again = stack_layer_params(back, L)
    assert set(again) == set(stacked) and all(torch.equal(again[k], stacked[k]) for k in stacked)


def test_stacking_rejects_a_missing_layer_and_picks_microbatches_as_jax():
    from trlx_tpu.parallel.pipeline import pick_microbatches as jax_pick

    with pytest.raises(ValueError, match="expected 0..2"):
        stack_layer_params({"layers_0.w": torch.ones(2), "layers_2.w": torch.ones(2)}, 3)
    with pytest.raises(ValueError, match="num_layers"):
        unstack_layer_params({"layers_scan.w": torch.ones(2, 2)}, 3)
    for batch in range(1, 13):
        for req in range(1, 9):
            assert pick_microbatches(batch, req) == jax_pick(batch, req)


# ------------------------------------------------------------ refusals


def test_what_the_jax_package_refuses_for_stacked_raises_with_its_message():
    from trlx_tpu.serving.engine import ServingEngine as JaxEngine
    from trlx_tpu_torch.models.policy import CausalLMWithValueHead
    from trlx_tpu_torch.serving import ServingEngine

    jm, params, tm = _models()
    ids, mask = _inputs()
    with pytest.raises(NotImplementedError) as jerr:
        jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), branch_layer=1)
    assert str(jerr.value) == STACKED_CAPTURE_ERROR
    with pytest.raises(NotImplementedError, match="hydra branch capture") as err:
        tm(torch.from_numpy(ids), torch.from_numpy(mask), branch_layer=1)
    assert str(err.value) == STACKED_CAPTURE_ERROR
    with pytest.raises(NotImplementedError) as jerr:
        jm.apply({"params": params}, jnp.zeros((3, 12, 64)), None, None, 1, method=jm.forward_from)
    with pytest.raises(NotImplementedError) as err:
        tm.forward_from(torch.zeros(3, 12, 64), None, None, 1)
    assert str(err.value) == str(jerr.value) == STACKED_BRANCH_ERROR
    with pytest.raises(NotImplementedError) as err:
        CausalLMWithValueHead(tm.config, num_value_layers=1)
    assert str(err.value) == STACKED_CAPTURE_ERROR
    jcache, tcache = jm.init_paged_cache(4, 4, 2, 2), tm.init_paged_cache(4, 4, 2, 2)
    with pytest.raises(NotImplementedError) as jerr:
        jm.apply({"params": params}, jnp.ones((2, 1), jnp.int32), jcache, method=jm.paged_decode)
    with pytest.raises(NotImplementedError) as err:
        tm.paged_decode(torch.ones((2, 1), dtype=torch.int32), tcache)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(NotImplementedError) as jerr:
        JaxEngine(jm, params, num_slots=2, max_seq_len=16, block_size=4)
    with pytest.raises(NotImplementedError) as err:
        ServingEngine(tm, num_slots=2, max_seq_len=16, block_size=4, device="cpu")
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------- the trainers


def _trainer_config(tmp_path, trainer, method, **model):
    model = {"model_path": "gpt2", "num_layers_unfrozen": -1, **model}
    return dict(
        method=method,
        train=dict(seq_length=16, epochs=4, total_steps=3, batch_size=4, minibatch_size=2,
                   checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
                   pipeline="PromptPipeline", trainer=trainer, tracker=None, seed=3, save_best=False),
        model=dict(model_overrides=dict(
            vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=64, attention_impl="flash", scan_layers=True), **model),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4, max_grad_norm=1.0)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )


PPO = dict(name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05, target=None,
           gen_kwargs=dict(max_new_tokens=5, do_sample=False))
SFT = dict(name="SFTConfig", gen_kwargs=dict(max_new_tokens=4, do_sample=False))


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def _port_trainer(tmp_path, trainer, method, **kw):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    extra = dict(reward_fn=reward_fn) if trainer in ("PPOTrainer", "GRPOTrainer", "RFTTrainer") else {}
    return get_trainer(trainer)(config=TRLConfig.from_dict(_trainer_config(tmp_path, trainer, method, **kw)),
                                device="cpu", **extra)


@pytest.fixture
def single_device_mesh(monkeypatch):
    """Pin JAX trainer meshes to the first of conftest's 8 virtual CPU devices."""
    from trlx_tpu.parallel import mesh as mesh_lib

    real = mesh_lib.make_mesh
    monkeypatch.setattr(mesh_lib, "mesh_from_config",
                        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]))


def _jax_trainer(tmp_path, trainer, method, **kw):
    import trlx_tpu.methods  # noqa: F401  (registers the method configs)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer

    extra = dict(reward_fn=reward_fn) if trainer == "PPOTrainer" else {}
    return jax_get_trainer(trainer)(config=JaxConfig.from_dict(_trainer_config(tmp_path, trainer, method, **kw)),
                                    **extra)


SAMPLES = [["ab", "cd"], "ef gh", ["a b", "c d"], "hhh a", ["bad", "cafe"], "e fg", ["dead", "beef"], "ab ab"]


def _sft_steps(trainer, steps=3):
    trainer.make_experience(SAMPLES, trainer.config.train.seq_length)
    trainer.prepare_learning()
    stats = []
    while len(stats) < steps:
        for batch in trainer.create_train_dataloader():
            stats.append(trainer.train_step(batch))
            if len(stats) == steps:
                break
    return stats


def test_sft_with_scan_layers_matches_jax_per_step(tmp_path, single_device_mesh):
    jt = _jax_trainer(tmp_path / "jax", "SFTTrainer", SFT)
    assert "layers_scan" in jt.params["transformer"]
    pt = _port_trainer(tmp_path / "port", "SFTTrainer", SFT)
    jparams = jax.tree.map(np.asarray, jax.device_get(jt.params))
    pt.model.transformer.load_state_dict(params_from_jax(jparams["transformer"], pt.model_config))
    jstats, pstats = _sft_steps(jt), _sft_steps(pt)
    for i, (js, ps) in enumerate(zip(jstats, pstats)):
        np.testing.assert_allclose(ps["losses/loss"], js["losses/loss"], rtol=1e-4, err_msg=f"step {i + 1}")
    final = params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params))["transformer"], pt.model_config)
    for name, value in pt.model.transformer.state_dict().items():
        np.testing.assert_allclose(value.numpy(), final[name].numpy(), rtol=1e-3, atol=1e-5, err_msg=name)


def test_ppo_with_scan_layers_matches_jax(tmp_path, single_device_mesh, monkeypatch):
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.trainer import ppo_trainer

    jt = _jax_trainer(tmp_path / "jax", "PPOTrainer", PPO)
    pt = _port_trainer(tmp_path / "port", "PPOTrainer", PPO)
    pt.model.load_state_dict(policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)),
                                                    pt.model_config))
    # num_layers_unfrozen=-1: the full reference copy, stacked as the policy
    assert pt.frozen_branch is None and "layers_scan.attn.q_proj.kernel" in pt.ref_model.state_dict()
    pt.ref_model.load_state_dict(pt.model.transformer.state_dict())
    pt.config.train.serving.enabled = True  # the engine refuses stacked: padded generate, with a warning
    for tr, cls in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.add_prompt_pipeline(cls(PROMPTS, 11, tr.tokenizer))
    warned = []
    monkeypatch.setattr(ppo_trainer.logger, "warning", lambda msg, *a, **kw: warned.append(msg))
    runs = []
    for tr in (jt, pt):
        tr.prepare_learning()
        batches = list(tr.create_train_dataloader())[:2]
        runs.append((list(tr.store.history), [tr.train_step(b) for b in batches]))
    assert pt._serving_client is None
    assert "train.serving disabled for this run: stacked/pipelined layouts keep the contiguous cache" in warned
    (je, js), (pe, ps) = runs
    assert len(pe) == len(je) == 8
    for a, b in zip(je, pe):
        np.testing.assert_array_equal(b.query_tensor, np.asarray(a.query_tensor))
        np.testing.assert_array_equal(b.response_tensor, np.asarray(a.response_tensor))
        for field in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(getattr(b, field), np.asarray(getattr(a, field)), err_msg=field,
                                       **ELEMENT_TOL)
    for i, (a, b) in enumerate(zip(js, ps)):
        keys = [k for k in a if k.split("/")[0] in ("losses", "values", "returns", "policy", "ratio",
                                                     "learning_rate_group_0")]
        assert len(keys) >= 15
        for k in keys:
            np.testing.assert_allclose(b[k], a[k], err_msg=f"step {i + 1} {k}", **STAT_TOL)


@pytest.mark.parametrize("trainer", ["ILQLTrainer", "GRPOTrainer", "RFTTrainer"])
def test_ilql_grpo_and_rft_take_a_finite_step_with_scan_layers(tmp_path, trainer):
    from trlx_tpu_torch.data.default_configs import default_grpo_config, default_ilql_config, default_rft_config
    from trlx_tpu_torch.pipeline import PromptPipeline

    base = {"ILQLTrainer": default_ilql_config, "GRPOTrainer": default_grpo_config,
            "RFTTrainer": default_rft_config}[trainer]().method
    method = {"name": type(base).__name__, "gen_kwargs": dict(max_new_tokens=4, do_sample=False)}
    if trainer == "GRPOTrainer":
        method.update(num_rollouts=4, chunk_size=2, group_size=2, gen_kwargs=dict(max_new_tokens=4, do_sample=True))
    if trainer == "RFTTrainer":
        method.update(n_generations_per_prompt=2, start_percentile=0.0, end_percentile=0.0, n_improve_steps=1)
    pt = _port_trainer(tmp_path, trainer, method)
    assert any(n.startswith("transformer.layers_scan.") for n in pt.model.state_dict())
    if trainer == "ILQLTrainer":
        pt.make_experience(["ab cd", "ef gh", "a b", "hh a"], [1.0, 0.0, 0.5, 0.2])
    else:
        pt.add_prompt_pipeline(PromptPipeline(PROMPTS, 11, pt.tokenizer))
    pt.prepare_learning()
    batch = next(iter(pt.create_train_dataloader()))
    stats = pt.train_step(batch)
    assert stats and all(np.isfinite(v) for v in stats.values())
    assert all(torch.isfinite(p).all() for p in pt.model.parameters())


# -------------------------------------------------------- round trips


def test_hf_export_of_a_stacked_model_reloads_equal_into_both_layouts(tmp_path):
    import json
    import os

    from trlx_tpu_torch.models.hf_loading import load_pretrained

    pt = _port_trainer(tmp_path, "SFTTrainer", SFT)
    out = str(tmp_path / "export")
    pt.save_pretrained(out)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["n_layer"] == 2
    trunk = pt.model.transformer.state_dict()
    for stacked in (True, False):
        config, state, _ = load_pretrained(out, {"compute_dtype": "float32", "scan_layers": stacked})
        assert config.stacked is stacked
        model = TransformerLM(config)
        model.load_state_dict(stack_layer_params(state, 2) if stacked else state)
        want = trunk if stacked else unstack_layer_params(trunk, 2)
        assert set(model.state_dict()) == set(want)
        for name, value in model.state_dict().items():
            assert torch.equal(value, want[name]), name
    # and a stacked trainer loads the listed export through maybe_stack_loaded
    again = _port_trainer(tmp_path / "again", "SFTTrainer", SFT, model_path=out)
    for name, value in again.model.transformer.state_dict().items():
        assert torch.equal(value, trunk[name]), name


def test_stacked_checkpoint_resumes_exactly(tmp_path):
    a = _port_trainer(tmp_path / "a", "SFTTrainer", SFT)
    _sft_steps(a, 2)
    path = str(tmp_path / "ck")
    a.save(path)
    b = _port_trainer(tmp_path / "b", "SFTTrainer", SFT)
    b.make_experience(SAMPLES, b.config.train.seq_length)
    b.prepare_learning()
    b.load(path)
    assert b.model.transformer.state_dict()["layers_scan.attn.q_proj.kernel"].shape[0] == 2
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    batch = next(iter(a.create_train_dataloader()))
    assert a.train_step(batch) == b.train_step(batch)
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name


def test_pipeline_stages_without_a_pipe_axis_is_the_stacked_layout(tmp_path):
    cfg = PRESETS["gpt2"].replace(**DIMS, compute_dtype=torch.float32, pipeline_stages=3, pipeline_microbatches=2)
    model = TransformerLM(cfg)
    assert cfg.stacked and "layers_scan.mlp.up_proj.kernel" in model.state_dict()
    # through the trainer: model_overrides.pipeline_stages with mesh.pipe == 1
    d = _trainer_config(tmp_path, "SFTTrainer", SFT)
    d["model"]["model_overrides"].update(scan_layers=False, pipeline_stages=2, pipeline_microbatches=4)
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_trainer

    trainer = get_trainer("SFTTrainer")(config=TRLConfig.from_dict(d), device="cpu")
    assert trainer.model_config.stacked and not trainer.model_config.scan_layers
    assert "transformer.layers_scan.attn.q_proj.kernel" in trainer.model.state_dict()
    assert np.isfinite(_sft_steps(trainer, 1)[0]["losses/loss"])


def test_trainers_refuse_layer_freezing_and_value_branches_on_a_stacked_model(tmp_path):
    from types import SimpleNamespace

    from trlx_tpu.trainer.mesh_trainer import MeshRLTrainer as JaxMeshTrainer

    fake = SimpleNamespace(config=SimpleNamespace(model=SimpleNamespace(peft_config=None, num_layers_unfrozen=0)))
    with pytest.raises(ValueError) as jerr:
        JaxMeshTrainer.trainable_path_predicate(fake, "transformer/layers_scan/attn/q_proj/kernel")
    for trainer, method, n in (("PPOTrainer", PPO, 1), ("SFTTrainer", SFT, 0)):
        with pytest.raises(ValueError) as err:
            _port_trainer(tmp_path / trainer, trainer, method, **{"num_layers_unfrozen": n})
        assert str(err.value) == str(jerr.value)
    with pytest.raises(NotImplementedError) as err:
        _port_trainer(tmp_path / "value", "PPOTrainer", dict(PPO, num_value_layers_unfrozen=1))
    assert str(err.value) == STACKED_CAPTURE_ERROR


@pytest.mark.parametrize("case", ["mesh.pipe", "ring", "ring_pipelined", "indivisible"])
def test_scale_out_stays_refused(tmp_path, case):
    from trlx_tpu.models.transformer import TransformerLM as JaxLM2
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.mesh_trainer import check_port_config

    if case == "mesh.pipe":
        # the pipe axis is ported: one rank cannot hold a mesh of two stages
        d = _trainer_config(tmp_path, "SFTTrainer", SFT)
        d["mesh"]["pipe"] = 2
        check_port_config(TRLConfig.from_dict(d))
        from trlx_tpu_torch.utils.loading import get_trainer

        with pytest.raises(ValueError, match="does not match device count 1"):
            get_trainer("SFTTrainer")(config=TRLConfig.from_dict(d), device="cpu")
        return
    if case == "ring":
        # ring attention is ported: with no mesh it takes the plain path
        ring = TransformerLM(PRESETS["gpt2"].replace(**DIMS, scan_layers=True, attention_impl="ring"))
        plain = TransformerLM(PRESETS["gpt2"].replace(**DIMS, scan_layers=True))
        ring.init_params(0)
        plain.load_state_dict(ring.state_dict())
        ids = torch.randint(1, DIMS["vocab_size"], (2, 8), generator=torch.Generator().manual_seed(0))
        mask = torch.ones_like(ids)
        assert torch.equal(ring(ids, mask)[0], plain(ids, mask)[0])
        return
    over = dict(attention_impl="ring", pipeline_stages=3) if case == "ring_pipelined" else dict(pipeline_stages=2)
    jcfg = JAX_PRESETS["gpt2"].replace(**DIMS, **over)
    with pytest.raises(ValueError) as jerr:
        JaxLM2(jcfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))
    with pytest.raises(ValueError) as err:
        TransformerLM(PRESETS["gpt2"].replace(**DIMS, **over))
    assert str(err.value) == str(jerr.value)
