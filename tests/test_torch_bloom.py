"""Port parity for ALiBi and bloom: ``alibi_slopes`` (H = 16, 12 and 6, the
last two through the non-power-of-two branch) and ``alibi_bias`` on a
left-padded batch against ``trlx_tpu/models/transformer.py``; a tiny bloom
``TransformerLM`` (f32, ``attention_impl="flash"``, which ALiBi must leave
for the plain path in both packages) with logits within 1e-5 of the JAX
model's and greedy cached decode identical to JAX's; the bloom converter
pair across packages on a directory the test writes; the serving engine
and paged decode refusing ALiBi with the JAX package's error types; and
``PPOTrainer`` on a tiny bloom against the JAX trainer (experience within
1e-4, stats within rtol 1e-3)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.models import transformer as jtr
from trlx_tpu.models.presets import PRESETS as JPRESETS
from trlx_tpu_torch.models import transformer as ttr
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.presets import PRESETS

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4, max_position_embeddings=64,
            attention_impl="flash")
T = torch.from_numpy


def _pair():
    jcfg = JPRESETS["bloom"].replace(**TINY, compute_dtype=jnp.float32)
    jm = jtr.TransformerLM(jcfg)
    ids = jnp.ones((1, 4), jnp.int32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), ids, ids)["params"])
    tcfg = PRESETS["bloom"].replace(**TINY, compute_dtype=torch.float32)
    tm = ttr.TransformerLM(tcfg)
    tm.load_state_dict(params_from_jax(params, tcfg))
    return jm, params, tm


def _left_padded(seed=0, B=3, L=9):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 61, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, :3] = 0
    mask[2, :7] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("heads", [16, 12, 6])
def test_alibi_slopes_match_jax(heads):
    np.testing.assert_array_equal(ttr.alibi_slopes(heads).numpy(), np.asarray(jtr.alibi_slopes(heads)))


def test_alibi_bias_on_a_left_padded_batch_matches_jax():
    _, mask = _left_padded()
    tcfg, jcfg = PRESETS["bloom"].replace(num_heads=12), JPRESETS["bloom"].replace(num_heads=12)
    got = ttr.alibi_bias(tcfg, T(mask), 3, 9, "cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jtr.alibi_bias(jcfg, jnp.asarray(mask), 3, 9)))
    # key positions count valid tokens: row 2's first real token sits at 0
    np.testing.assert_array_equal(got[2, 0, 0, 7:] / got[2, 0, 0, 8], [0.0, 1.0])
    np.testing.assert_array_equal(got[:, :, :, :1], 0.0)
    no_mask = ttr.alibi_bias(tcfg, None, 2, 5, "cpu").numpy()
    np.testing.assert_array_equal(no_mask, np.asarray(jtr.alibi_bias(jcfg, None, 2, 5)))


def test_logits_match_jax_on_the_plain_path():
    from trlx_tpu_torch.ops import attention

    jm, params, tm = _pair()
    ids, mask = _left_padded()
    jl, jh, _, _ = jm.apply({"params": params}, ids, mask)
    calls = []
    flash = attention.flash_attention
    attention_spy = lambda *a, **k: calls.append(1) or flash(*a, **k)
    ttr.flash_attention = attention_spy
    try:
        with torch.no_grad():
            tl, th, _, _ = tm(T(ids), T(mask))
    finally:
        ttr.flash_attention = flash
    assert not calls  # the kernel takes no additive bias: ALiBi stays off it
    valid = mask.astype(bool)
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **TOL)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], **TOL)


def test_cached_greedy_decode_matches_jax():
    """The padded generate over the contiguous cache (the ALiBi slot bias
    included) gives JAX's greedy tokens on a ragged left-padded batch."""
    from trlx_tpu.ops.generation import generate as jgenerate
    from trlx_tpu.ops.generation import left_pad_batch
    from trlx_tpu_torch.ops.generation import generate

    jm, params, tm = _pair()
    prompts = [np.array([5, 9, 11, 2, 30], np.int32), np.array([7, 1], np.int32), np.arange(3, 11, dtype=np.int32)]
    ids, mask = left_pad_batch(prompts, pad_token_id=0, target_len=8)

    def jstep(p, i, m, pos, cache):
        logits, hidden, _, cache = jm.apply({"params": p}, i, m, pos, cache)
        return logits, hidden, cache

    jout = jgenerate(jstep, params, lambda b, s: jm.init_cache(b, s, jnp.float32), jnp.asarray(ids),
                     jnp.asarray(mask), jax.random.PRNGKey(0), max_new_tokens=6, do_sample=False, pad_token_id=0)

    def tstep(i, m, pos, cache):
        logits, hidden, _, cache = tm(i, m, pos, cache)
        return logits, hidden, cache

    tout = generate(tstep, lambda b, s: tm.init_cache(b, s, torch.float32), T(ids), T(mask), None, 6,
                    do_sample=False, pad_token_id=0)
    np.testing.assert_array_equal(tout["sequences"].numpy(), np.asarray(jout["sequences"]))


def test_engine_and_paged_decode_refuse_alibi():
    from trlx_tpu.serving.engine import ServingEngine as JaxEngine
    from trlx_tpu_torch.serving.engine import ServingEngine

    jm, params, tm = _pair()
    with pytest.raises(NotImplementedError, match="alibi"):
        JaxEngine(jm, params, num_slots=2, max_seq_len=16)
    with pytest.raises(NotImplementedError, match="alibi"):
        ServingEngine(tm, num_slots=2, max_seq_len=16, device="cpu")
    cache = tm.init_paged_cache(num_blocks=4, block_size=4, max_blocks_per_seq=2, batch_size=2)
    with pytest.raises(ValueError, match="paged decode does not support alibi"):
        tm.paged_decode(torch.ones((2, 1), dtype=torch.int32), cache)
    jcache = jm.init_paged_cache(num_blocks=4, block_size=4, max_blocks_per_seq=2, batch_size=2)
    with pytest.raises(ValueError, match="paged decode does not support alibi"):
        jm.apply({"params": params}, jnp.ones((2, 1), jnp.int32), jcache, method=jm.paged_decode)


def test_bloom_converters_across_packages(tmp_path):
    """A transformers bloom directory: the port loads it to the JAX
    package's parameters; the port's export is read back by the JAX
    loader and by transformers, and reloads to torch.equal logits."""
    import transformers

    from trlx_tpu.models.hf_loading import load_pretrained as jax_load
    from trlx_tpu_torch.models.hf_loading import load_pretrained, save_pretrained_hf

    torch.manual_seed(0)
    hf = transformers.BloomForCausalLM(transformers.BloomConfig(vocab_size=61, hidden_size=32, n_layer=2,
                                                                n_head=4)).eval()
    hf.save_pretrained(tmp_path / "hf")
    cfg, state, family = load_pretrained(str(tmp_path / "hf"), {"compute_dtype": "float32"})
    _, jparams, _ = jax_load(str(tmp_path / "hf"), {"compute_dtype": jnp.float32})
    assert family == "bloom" and cfg.embed_ln and cfg.pos_embedding == "alibi"
    for name, value in params_from_jax(jax.tree.map(np.asarray, jparams), cfg).items():
        assert torch.equal(state[name], value), name
    tm = ttr.TransformerLM(cfg)
    tm.load_state_dict(state)
    ids, mask = _left_padded(1)
    with torch.no_grad():
        logits = tm(T(ids), T(mask))[0]
        save_pretrained_hf(str(tmp_path / "port"), "bloom", tm.state_dict(), cfg)
        cfg2, state2, _ = load_pretrained(str(tmp_path / "port"), {"compute_dtype": "float32"})
        tm2 = ttr.TransformerLM(cfg2)
        tm2.load_state_dict(state2)
        assert torch.equal(tm2(T(ids), T(mask))[0], logits)
        hf2 = transformers.BloomForCausalLM.from_pretrained(tmp_path / "port").eval()
        full = torch.ones(2, 9, dtype=torch.long)
        np.testing.assert_allclose(hf2(T(ids[:1]).long(), attention_mask=full[:1]).logits.numpy(),
                                   logits[:1].numpy(), atol=2e-3, rtol=1e-3)
    _, jparams2, _ = jax_load(str(tmp_path / "port"), {"compute_dtype": jnp.float32})
    for name, value in params_from_jax(jax.tree.map(np.asarray, jparams2), cfg).items():
        assert torch.equal(tm.state_dict()[name], value), name


# ------------------------------------------------------------------ PPO

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


def _config_dict(tmp_path):
    return dict(
        method=dict(name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05,
                    target=None, gen_kwargs=dict(max_new_tokens=5, do_sample=False)),
        train=dict(seq_length=16, epochs=2, total_steps=2, batch_size=4, minibatch_size=2,
                   checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
                   pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False),
        model=dict(model_path="bigscience/bloom-560m", num_layers_unfrozen=-1, model_overrides=dict(
            vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=4, attention_impl="flash")),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4)),
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


def test_ppo_trainer_on_bloom_matches_jax(tmp_path, single_device_mesh):
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.models.convert import policy_params_from_jax
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    jt = jax_get_trainer("PPOTrainer")(config=JaxConfig.from_dict(_config_dict(tmp_path / "jax")),
                                       reward_fn=reward_fn)
    pt = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path / "port")),
                                   reward_fn=reward_fn, device="cpu")
    assert pt.model_type == jt.model_type == "bloom" and pt.model_config.pos_embedding == "alibi"
    for tr, cls in ((jt, JaxPipeline), (pt, PromptPipeline)):
        tr.add_prompt_pipeline(cls(PROMPTS, 11, tr.tokenizer))
    pt.model.load_state_dict(policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)),
                                                    pt.model_config))
    pt.ref_model.load_state_dict(pt.model.transformer.state_dict())
    runs = []
    for tr in (jt, pt):
        tr.prepare_learning()
        batches = list(tr.create_train_dataloader())[:2]
        runs.append((list(tr.store.history), [tr.train_step(b) for b in batches]))
    (je, js), (pe, ps) = runs
    assert len(pe) == len(je) == 8 and len(ps) == 2
    for a, b in zip(je, pe):
        np.testing.assert_array_equal(b.response_tensor, np.asarray(a.response_tensor))
        for field in ("logprobs", "values", "rewards"):
            np.testing.assert_allclose(getattr(b, field), np.asarray(getattr(a, field)), rtol=1e-4, atol=1e-4)
    for i, (a, b) in enumerate(zip(js, ps)):
        for k in a:
            if k.split("/")[0] in ("losses", "values", "returns", "policy", "ratio"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-3, atol=1e-5, err_msg=f"step {i} {k}")
