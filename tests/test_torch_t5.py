"""Port parity for T5 (``trlx_tpu_torch/models/t5.py``) against
``trlx_tpu/models/t5.py`` on the same weights (carried across with
``t5_params_from_jax``), f32, both FFN kinds: the relative-position buckets
(exact integer equality over every relative position in -512..512, both
directions), full-forward logits, cached decode, the decoder-top hydra
branch and the int8 decoder KV cache (within 1e-5); the HF checkpoint
round trip through a directory, against ``transformers``'
``T5ForConditionalGeneration`` as ``tests/test_t5.py`` holds the JAX
module, and across packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import transformers

from trlx_tpu.models import t5 as jt5
from trlx_tpu_torch.models import t5 as tt5
from trlx_tpu_torch.models.convert import t5_params_from_jax

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(vocab_size=48, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2, num_heads=4,
             relative_attention_num_buckets=8, decoder_start_token_id=0)


def _pair(ffn="relu", **over):
    """(JAX module, JAX params, port module) on the same seed-0 weights."""
    jcfg = jt5.T5Config(**SMALL, feed_forward_proj=ffn, compute_dtype=jnp.float32, **over)
    jm = jt5.T5LM(jcfg)
    ids = jnp.ones((1, 4), jnp.int32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), ids, ids, jnp.zeros((1, 2), jnp.int32))["params"])
    tcfg = tt5.T5Config(**SMALL, feed_forward_proj=ffn, compute_dtype=torch.float32, **over)
    tm = tt5.T5LM(tcfg)
    tm.load_state_dict(t5_params_from_jax(params, tcfg))
    return jm, params, tm


def _inputs(seed=0, B=3, S=7, T=5):
    rng = np.random.default_rng(seed)
    enc = rng.integers(2, 48, (B, S)).astype(np.int32)
    enc_mask = np.ones((B, S), np.int32)
    enc_mask[1, :2] = 0  # a left-padded row
    dec = np.concatenate([np.zeros((B, 1), np.int32), rng.integers(2, 48, (B, T - 1)).astype(np.int32)], axis=1)
    dec_mask = np.ones((B, T), np.int32)
    dec_mask[2, -2:] = 0  # a right-padded row
    return enc, enc_mask, dec, dec_mask


T = torch.from_numpy


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 20)])
def test_relative_position_buckets_equal_jax(bidirectional, num_buckets, max_distance):
    rel = np.arange(-512, 513, dtype=np.int32)
    got = tt5.relative_position_bucket(T(rel), bidirectional, num_buckets, max_distance).numpy()
    ref = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), bidirectional, num_buckets, max_distance))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32


@pytest.mark.parametrize("ffn", ["relu", "gated-gelu"])
def test_logits_match_jax(ffn):
    jm, params, tm = _pair(ffn)
    enc, enc_mask, dec, dec_mask = _inputs()
    jl, jh, je = jm.apply({"params": params}, enc, enc_mask, dec, dec_mask)
    with torch.no_grad():
        tl, th, te = tm(T(enc), T(enc_mask), T(dec), T(dec_mask))
    for got, ref in ((tl, jl), (th, jh), (te, je)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_cached_decode_matches_jax(quant):
    """Teacher-forced one-token steps over the cache (int8 under quant),
    cross K/V precomputed once: every step's logits as JAX's."""
    jm, params, tm = _pair("gated-gelu", kv_cache_quant=quant)
    enc, enc_mask, dec, _ = _inputs(1)
    B, Td = dec.shape
    jenc = jm.apply({"params": params}, enc, enc_mask, method=jm.encode)
    jckv = jm.apply({"params": params}, jenc, method=jm.precompute_cross_kv)
    jcache = jm.init_cache(B, Td, jnp.float32)
    with torch.no_grad():
        tenc = tm.encode(T(enc), T(enc_mask))
        tckv = tm.precompute_cross_kv(tenc)
        tcache = tm.init_cache(B, Td, torch.float32)
        assert (tcache["k"][0].dtype == torch.int8) == quant
        dec_mask = np.ones((B, Td), np.int32)
        for t in range(Td):
            jl, _, jcache = jm.apply({"params": params}, dec[:, t:t + 1], jenc, enc_mask, dec_mask, None, jcache,
                                     jckv, method=jm.decode)
            tl, _, tcache = tm.decode(T(dec[:, t:t + 1]), tenc, T(enc_mask), T(dec_mask), None, tcache, tckv)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {t}", **TOL)
        assert tcache["index"] == Td


def test_hydra_branch_matches_jax():
    """forward_with_branch and the frozen T5Branch (loaded from
    t5_branch_param_subtree) against the JAX module's forward_branch; at
    init the branch reproduces the full logits."""
    from trlx_tpu.models.policy import t5_branch_param_subtree as jax_subtree
    from trlx_tpu_torch.models.policy import t5_branch_param_subtree

    jm, params, tm = _pair("relu")
    enc, enc_mask, dec, dec_mask = _inputs(2)
    start = 1
    jout = jm.apply({"params": params}, enc, enc_mask, dec, dec_mask, start, method=jm.forward_with_branch)
    jref = jm.apply({"params": jax_subtree(params, start, jm.config)}, jout[3], jout[2], enc_mask, dec_mask,
                    jout[4], start, method=jm.forward_branch)
    branch = tt5.T5Branch(tm.config, start)
    branch.load_state_dict(t5_branch_param_subtree(tm.state_dict(), start, tm.config))
    with torch.no_grad():
        tout = tm.forward_with_branch(T(enc), T(enc_mask), T(dec), T(dec_mask), start)
        tref = branch.forward_branch(tout[3], tout[2], T(enc_mask), T(dec_mask), tout[4], start)
    for got, ref in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), **TOL)
    np.testing.assert_allclose(tref.numpy(), tout[0].numpy(), **TOL)
    with pytest.raises(ValueError):
        branch.forward_branch(tout[3], tout[2], T(enc_mask), T(dec_mask), tout[4], 0)


def test_lora_raises_naming_the_peft_slice():
    """T5 LoRA builds since the peft slice (parity: tests/test_torch_peft.py):
    adapters on the default targets q and v only."""
    model = tt5.T5LM(tt5.T5Config(**SMALL, lora_r=4))
    lora = [n for n, _ in model.named_parameters() if "lora_" in n]
    assert lora and {n.split(".")[-2] for n in lora} == {"q", "v"}


def _hf_model(ffn):
    torch.manual_seed(0)
    cfg = transformers.T5Config(**{k: v for k, v in SMALL.items()}, dropout_rate=0.0, feed_forward_proj=ffn,
                                tie_word_embeddings=True, eos_token_id=1, pad_token_id=0)
    return transformers.T5ForConditionalGeneration(cfg).eval()


@pytest.mark.parametrize("ffn", ["relu", "gated-gelu"])
def test_hf_directory_round_trip(tmp_path, ffn):
    """An HF-written directory loads to HF's logits; the port's export
    loads back in transformers, in the port (logits torch.equal) and in the
    JAX package."""
    from trlx_tpu.models.hf_loading import load_pretrained_seq2seq as jax_load
    from trlx_tpu_torch.models.hf_loading import load_pretrained_seq2seq, save_pretrained_hf

    hf = _hf_model(ffn)
    hf.save_pretrained(tmp_path / "hf")
    cfg, state = load_pretrained_seq2seq(str(tmp_path / "hf"), {"compute_dtype": "float32"})
    assert cfg.is_gated == (ffn == "gated-gelu") and cfg.num_decoder_layers == 2
    tm = tt5.T5LM(cfg)
    tm.load_state_dict(state)
    enc, enc_mask, dec, _ = _inputs(3)
    with torch.no_grad():
        ref = hf(input_ids=T(enc).long(), attention_mask=T(enc_mask), decoder_input_ids=T(dec).long()).logits
        logits = tm(T(enc), T(enc_mask), T(dec))[0]
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=2e-3, rtol=1e-3)

        save_pretrained_hf(str(tmp_path / "port"), "t5", tm.state_dict(), cfg)
        hf2 = transformers.T5ForConditionalGeneration.from_pretrained(tmp_path / "port").eval()
        ref2 = hf2(input_ids=T(enc).long(), attention_mask=T(enc_mask), decoder_input_ids=T(dec).long()).logits
        np.testing.assert_allclose(ref2.numpy(), ref.numpy(), atol=1e-6)
        cfg2, state2 = load_pretrained_seq2seq(str(tmp_path / "port"), {"compute_dtype": torch.float32})
        tm2 = tt5.T5LM(cfg2)
        tm2.load_state_dict(state2)
        assert torch.equal(tm2(T(enc), T(enc_mask), T(dec))[0], logits)
    jcfg, jparams = jax_load(str(tmp_path / "port"), overrides=dict(compute_dtype=jnp.float32))
    jl = jt5.T5LM(jcfg).apply({"params": jparams}, enc, enc_mask, dec)[0]
    np.testing.assert_allclose(np.asarray(jl), logits.numpy(), **TOL)


def test_seq2seq_loader_without_a_directory_gives_t5_small(tmp_path):
    from trlx_tpu_torch.models.hf_loading import load_pretrained_seq2seq

    cfg, state = load_pretrained_seq2seq("t5-small", {"param_dtype": "float32"})
    assert state is None and cfg == tt5.T5Config()
    (tmp_path / "bare").mkdir()
    with pytest.raises(FileNotFoundError):
        load_pretrained_seq2seq(str(tmp_path / "bare"))
    # a native store restores since it was ported; a causal one asked for as seq2seq raises, as in the JAX package
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "native_config.json").write_text("{}")
    with pytest.raises(ValueError, match="causal but a seq2seq model was requested"):
        load_pretrained_seq2seq(str(tmp_path / "native"))
