"""Port parity: trlx_tpu_torch's TransformerLM against trlx_tpu's on the same
weights (carried across by ``params_from_jax``) and the same numpy inputs,
in f32 on the CPU, for three families: gpt2-style, llama-style (rotary
neox, rmsnorm, GLU, GQA 4/2, untied head) and gptj-style (rotary gptj,
shared parallel LN, head bias). Checked: cache-free logits, cached-prefill
logits and cache contents under attention_impl "xla" and "flash", each with
and without int8 KV, and token-by-token paged decode. Tolerance 1e-4 (f32;
the two frameworks sum in different orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu.models.transformer import TransformerLM as JaxLM
from trlx_tpu_torch.models.convert import load_jax_params, params_from_jax
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM, quantize_kv_rows

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-4, atol=1e-4)

FAMILIES = {
    "gpt2": ("gpt2", dict(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2,
                          max_position_embeddings=64)),
    "llama": ("llama", dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                            num_kv_heads=2, intermediate_size=48, max_position_embeddings=64)),
    "gptj": ("gptj", dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                          rotary_pct=0.5, max_position_embeddings=64)),
}


def _models(family, **over):
    preset, dims = FAMILIES[family]
    jcfg = JAX_PRESETS[preset].replace(**dims, compute_dtype=jnp.float32, **over)
    tcfg = PRESETS[preset].replace(**dims, compute_dtype=torch.float32, **over)
    jm = JaxLM(jcfg)
    params = jm.init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32)
    )["params"]
    # perturb biases / norm params off their init so the mapping is exercised
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32) for x in leaves]
    params = jax.tree.unflatten(treedef, leaves)
    return jm, params, load_jax_params(TransformerLM(tcfg), params)


def _inputs(vocab, B=3, T=9, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, :3] = 0  # left padding
    mask[2, :T - 1] = 0  # one real token
    return ids, mask


@pytest.mark.parametrize("family", list(FAMILIES))
def test_params_from_jax_roundtrip(family):
    jm, params, tm = _models(family)
    sd = tm.state_dict()
    flat = {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(flat) == set(sd)
    for name, value in flat.items():
        np.testing.assert_array_equal(sd[name].numpy(), value)
    with pytest.raises(ValueError, match="mismatch"):
        params_from_jax({**params, "stray": np.zeros(2)}, tm.config)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_cache_free_logits(family, impl):
    jm, params, tm = _models(family, attention_impl=impl)
    ids, mask = _inputs(tm.config.vocab_size)
    jl = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))[0]
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids), torch.from_numpy(mask))[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_cached_prefill_logits_and_cache(family, impl, quant):
    jm, params, tm = _models(family, attention_impl=impl, kv_cache_quant=quant)
    ids, mask = _inputs(tm.config.vocab_size)
    B, T = ids.shape
    positions = np.clip(np.cumsum(mask, 1) - 1, 0, None).astype(np.int32)
    jcache = {**jm.init_cache(B, T), "index": 0}
    jl, _, _, jcache = jm.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(positions), jcache
    )
    tcache = tm.init_cache(B, T)
    with torch.no_grad():
        tl, _, _, tcache = tm(
            torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(positions), tcache
        )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["index"] == int(jcache["index"]) == T
    for key in [k for k in tcache if k != "index"]:
        for layer, (tb, jb) in enumerate(zip(tcache[key], jcache[key])):
            jb = np.asarray(jb)
            if key in ("k", "v") and quant:
                # int8 rows may differ by one step where a value sits on a
                # rounding boundary within f32 noise
                assert np.abs(tb.numpy().astype(np.int32) - jb.astype(np.int32)).max() <= 1, (key, layer)
            else:
                np.testing.assert_allclose(tb.numpy(), jb, **TOL, err_msg=f"{key}[{layer}]")


@pytest.mark.parametrize("quant", [False, True], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_paged_decode_token_by_token(family, quant):
    """Both packages decode the same token stream through the same block
    tables from empty pools: per-step logits and final pools agree."""
    jm, params, tm = _models(family, kv_cache_quant=quant, paged_attention_impl="xla")
    rng = np.random.default_rng(3)
    B, NB, BS, MB, steps = 3, 10, 4, 3, 7
    tables = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)  # slot 2 idle
    tokens = rng.integers(1, tm.config.vocab_size, (steps, B)).astype(np.int32)
    jcache = jm.init_paged_cache(NB, BS, MB, B)
    jcache["block_tables"] = jnp.asarray(tables)
    tcache = tm.init_paged_cache(NB, BS, MB, B)
    tcache["block_tables"] = torch.from_numpy(tables.copy())
    for step in range(steps):
        lens = np.array([step, step, 0], np.int32)
        jcache["context_lens"] = jnp.asarray(lens)
        tcache["context_lens"] = torch.from_numpy(lens.copy())
        jl, _, jcache = jm.apply(
            {"params": params}, jnp.asarray(tokens[step][:, None]), jcache, method=jm.paged_decode
        )
        with torch.no_grad():
            tl, _, tcache = tm.paged_decode(torch.from_numpy(tokens[step][:, None]), tcache)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL, err_msg=f"step {step}")
        assert np.isfinite(tl[2].numpy()).all()  # idle slot on the null block
        np.testing.assert_array_equal(tcache["context_lens"].numpy(), lens + 1)
    live = tables[:2][tables[:2] > 0]
    for layer in range(tm.config.num_layers):
        for key in [k for k in tcache if k not in ("block_tables", "context_lens")]:
            tb, jb = tcache[key][layer].numpy()[live], np.asarray(jcache[key][layer])[live]
            if key in ("k", "v") and quant:
                assert np.abs(tb.astype(np.int32) - jb.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(tb, jb, **TOL)


def test_unsupported_config_raises():
    # stacked layouts build since the stacked-layout slice (tests/test_torch_stacked.py);
    # ring attention and sequence sharding since scale-out part two
    # (tests/test_torch_ring_attention.py, tests/test_torch_sequence_shard.py)
    for over in (dict(attention_impl="ring"), dict(sequence_sharding=True)):
        TransformerLM(PRESETS["gpt2"].replace(**FAMILIES["gpt2"][1], **over))
    with pytest.raises(ValueError, match="attention_impl"):
        TransformerLM(PRESETS["gpt2"].replace(**FAMILIES["gpt2"][1], attention_impl="splash"))
    # peft and remat build since the peft / training-memory slice
    # (tests/test_torch_peft.py, tests/test_torch_training_memory.py)
    for over in (dict(lora_r=4), dict(peft_type="prefix", num_virtual_tokens=2), dict(remat="dots_saveable")):
        TransformerLM(PRESETS["gpt2"].replace(**FAMILIES["gpt2"][1], **over))
    with pytest.raises(ValueError, match="remat"):
        TransformerLM(PRESETS["gpt2"].replace(**FAMILIES["gpt2"][1], remat="everything"))


def test_init_params_is_seeded_and_finite():
    cfg = PRESETS["gpt2"].replace(**FAMILIES["gpt2"][1], compute_dtype=torch.float32)
    a = TransformerLM(cfg).init_params(7).state_dict()
    b = TransformerLM(cfg).init_params(7).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.isfinite(a[k]).all()
    assert float(a["layers_0.attn.o_proj.kernel"].std()) < float(a["layers_0.attn.q_proj.kernel"].std())
    x = torch.randn(4, 5, 8)
    q, s = quantize_kv_rows(x)
    assert q.dtype == torch.int8 and s.shape == (4, 5, 1)
