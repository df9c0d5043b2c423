"""Port parity for the paged verify attention (speculative verify / chunked
prefill) and its writes: the port's verify wrapper on CPU tensors (its plain
version; the CUDA kernel is held against the same plain version on the card
by chip_smoke.py) against trlx_tpu's ``paged_verify_attention_xla`` and
``paged_verify_attention_pallas`` in interpret mode, Q = 1..4, f32 and int8
pools, MHA and GQA, with a prefix-shared block, a query run crossing a block
edge, ``lens + Q`` reaching the table's end and an idle slot at len 0 on the
null block. At Q=1 the plain verify must equal the plain decode at lens + 1
bit for bit; ``write_paged_kv_multi`` (with the drop past the table and a
null-block landing) and ``count_accepted_drafts`` must equal JAX's. The
append rows (``paged_write_rows``) are computed once per multi-token
forward and shared by its layers, with the same writes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trlx_tpu.models.transformer import quantize_kv_rows as jax_quantize
from trlx_tpu.ops.paged_attention import (
    paged_verify_attention_pallas,
    paged_verify_attention_xla,
    write_paged_kv_multi as jax_write_paged_kv_multi,
)
from trlx_tpu.ops.sampling import count_accepted_drafts as jax_count_accepted
from trlx_tpu_torch.ops import _kernels
from trlx_tpu_torch.ops.paged_attention import (
    paged_attention_reference,
    paged_verify_attention,
    paged_verify_attention_kernel,
    paged_verify_attention_reference,
    paged_write_rows,
    write_paged_kv,
    write_paged_kv_multi,
)
from trlx_tpu_torch.models import transformer as transformer_mod
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.ops.sampling import count_accepted_drafts

pytestmark = pytest.mark.torch_port

B, HKV, D = 4, 2, 8
NB, BS, MB = 10, 4, 4
#: slot 0 ends on the table's last block (lens + 4 == MB * BS), slot 1 shares
#: block 1 with slot 0 and its queries cross a block edge, slot 2 holds a
#: later wave's blocks, slot 3 is idle: a null row at len 0
TABLES = np.array([[1, 2, 3, 5], [1, 4, 6, 0], [7, 8, 9, 0], [0, 0, 0, 0]], np.int32)
LENS = np.array([12, 3, 5, 0], np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _pools(rng, quant):
    kf = rng.standard_normal((NB, BS, HKV, D)).astype(np.float32)
    vf = rng.standard_normal((NB, BS, HKV, D)).astype(np.float32)
    if not quant:
        return dict(k=kf, v=vf)
    kq, ks = jax_quantize(jnp.asarray(kf))
    vq, vs = jax_quantize(jnp.asarray(vf))
    return dict(k=np.array(kq), v=np.array(vq), k_scale=np.array(ks[..., 0]), v_scale=np.array(vs[..., 0]))


def _args(pools, q, tables=TABLES, lens=LENS):
    jargs = (jnp.asarray(q), jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
             jnp.asarray(tables), jnp.asarray(lens))
    targs = (torch.from_numpy(q), torch.from_numpy(pools["k"]), torch.from_numpy(pools["v"]),
             torch.from_numpy(tables), torch.from_numpy(lens))
    jkw = {k: jnp.asarray(pools[k]) for k in ("k_scale", "v_scale") if k in pools}
    tkw = {k: torch.from_numpy(pools[k]) for k in ("k_scale", "v_scale") if k in pools}
    return jargs, jkw, targs, tkw


@pytest.mark.parametrize("rep", [1, 3], ids=["mha", "gqa"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("Q", [1, 2, 3, 4])
def test_verify_plain_matches_jax_xla_and_pallas(Q, quant, rep):
    rng = np.random.default_rng(10 * Q + rep)
    pools = _pools(rng, quant)
    q = rng.standard_normal((B, Q, HKV * rep, D)).astype(np.float32)
    jargs, jkw, targs, tkw = _args(pools, q)
    ref_xla = np.asarray(paged_verify_attention_xla(*jargs, **jkw))
    ref_pl = np.asarray(paged_verify_attention_pallas(*jargs, **jkw, interpret=True))
    _kernels.reset_launches()
    out = paged_verify_attention_kernel(*targs, **tkw).numpy()
    assert _kernels.launches()["paged_verify"] == 0  # CPU tensors never launch
    assert out.shape == q.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref_xla, **TOL)
    np.testing.assert_allclose(out, ref_pl, **TOL)
    assert np.isfinite(out[3]).all()  # the idle slot stays finite
    for impl in ("auto", "pallas", "xla"):
        np.testing.assert_array_equal(paged_verify_attention(*targs, **tkw, impl=impl).numpy(), out)


def test_verify_dispatch_rejects_unknown_impl():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, 2, HKV, D)).astype(np.float32)
    _, _, targs, tkw = _args(_pools(rng, False), q)
    with pytest.raises(ValueError, match="impl"):
        paged_verify_attention(*targs, **tkw, impl="tpu")


def test_verify_wrapper_checks_a_non_cpu_tensor():
    """Off the CPU the wrapper takes the kernel route and its input checks:
    a tensor on neither CPU nor CUDA raises instead of falling back."""
    q = torch.zeros((B, 2, HKV, D), device="meta")
    k = torch.zeros((NB, BS, HKV, D), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        paged_verify_attention_kernel(q, k, k, torch.from_numpy(TABLES), torch.from_numpy(LENS))


@pytest.mark.parametrize("rep", [1, 3], ids=["mha", "gqa"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
def test_verify_q1_is_decode_at_lens_plus_one_bit_for_bit(quant, rep):
    rng = np.random.default_rng(20 + rep)
    pools = _pools(rng, quant)
    q = rng.standard_normal((B, HKV * rep, D)).astype(np.float32)
    _, _, targs, tkw = _args(pools, q[:, None])
    verify = paged_verify_attention_reference(*targs, **tkw)
    decode = paged_attention_reference(targs[0][:, 0], *targs[1:4], targs[4] + 1, **tkw)
    assert torch.equal(verify[:, 0], decode)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
def test_write_paged_kv_multi_bit_exact(quant):
    """Q=3 tokens per slot: slot 0 writes the table's last two rows and drops
    its third token (position 16 == MB * BS); slot 1 crosses into its second
    block; slot 2's last two tokens hit table entries 0 and land in the null
    block; slot 3 (len 30) is past the table and drops everything."""
    rng = np.random.default_rng(3)
    pools = _pools(rng, quant)
    tables = np.array([[1, 2, 3, 5], [1, 4, 6, 0], [7, 8, 0, 0], [9, 0, 0, 0]], np.int32)
    lens = np.array([14, 3, 7, 30], np.int32)
    k_new = rng.standard_normal((B, 3, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((B, 3, HKV, D)).astype(np.float32)
    k_new[1, 1] = 0.0  # an all-zero row quantizes to scale 1e-8/127
    jcache = {key: jnp.asarray(val) for key, val in pools.items()}
    jcache.update(block_tables=jnp.asarray(tables), context_lens=jnp.asarray(lens))
    tcache = {key: torch.from_numpy(val.copy()) for key, val in pools.items()}
    tcache.update(block_tables=torch.from_numpy(tables), context_lens=torch.from_numpy(lens))
    jout = jax_write_paged_kv_multi(jcache, jnp.asarray(k_new), jnp.asarray(v_new))
    tout = write_paged_kv_multi(tcache, torch.from_numpy(k_new), torch.from_numpy(v_new))
    assert tout is tcache  # in place
    for key in pools:
        np.testing.assert_array_equal(tout[key].numpy(), np.asarray(jout[key]), err_msg=key)
    assert not np.array_equal(tout["k"][0].numpy(), pools["k"][0])  # slot 2 reached the null block
    np.testing.assert_array_equal(tout["k"][9].numpy(), pools["k"][9])  # slot 3 dropped

    # one token per slot: the single-token write, bit for bit
    single = {key: torch.from_numpy(val.copy()) for key, val in pools.items()}
    single.update(block_tables=torch.from_numpy(tables), context_lens=torch.from_numpy(lens % 16))
    multi = {key: val.clone() for key, val in single.items()}
    write_paged_kv(single, torch.from_numpy(k_new[:, 0]), torch.from_numpy(v_new[:, 0]))
    write_paged_kv_multi(multi, torch.from_numpy(k_new[:, :1]), torch.from_numpy(v_new[:, :1]))
    for key in pools:
        assert torch.equal(single[key], multi[key]), key


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
def test_write_rows_computed_once_are_the_same_writes(quant):
    """``paged_write_rows`` keeps only positions inside the table, and a
    cache carrying them (as every layer of one forward does) writes exactly
    what the per-call computation writes."""
    rng = np.random.default_rng(5)
    pools = _pools(rng, quant)
    tables = torch.from_numpy(np.array([[1, 2, 3, 5], [1, 4, 6, 0], [7, 8, 0, 0], [9, 0, 0, 0]], np.int32))
    lens = torch.from_numpy(np.array([14, 3, 7, 30], np.int32))
    rows, keep = paged_write_rows(tables, lens, 3, BS)
    assert keep.tolist() == [0, 1, 3, 4, 5, 6, 7, 8]  # slot 0's third token and slot 3 dropped
    assert rows.tolist() == [5 * BS + 2, 5 * BS + 3, 1 * BS + 3, 4 * BS + 0, 4 * BS + 1, 8 * BS + 3, 0, 1]
    k_new = torch.from_numpy(rng.standard_normal((B, 3, HKV, D)).astype(np.float32))
    v_new = torch.from_numpy(rng.standard_normal((B, 3, HKV, D)).astype(np.float32))
    caches = []
    for write_rows in (None, (rows, keep)):
        cache = {key: torch.from_numpy(val.copy()) for key, val in pools.items()}
        cache.update(block_tables=tables, context_lens=lens)
        if write_rows is not None:
            cache["write_rows"] = write_rows
        caches.append(write_paged_kv_multi(cache, k_new, v_new))
    for key in pools:
        assert torch.equal(caches[0][key], caches[1][key]), key


def test_paged_verify_filters_the_append_once_per_forward(monkeypatch):
    """A multi-token forward computes its append rows (the one host sync of
    the drop filter) once for all layers, not once per layer."""
    cfg = PRESETS["gpt2"].replace(vocab_size=37, hidden_size=16, num_layers=3, num_heads=2,
                                  max_position_embeddings=64, compute_dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu").init_params(0)
    cache = model.init_paged_cache(num_blocks=9, block_size=4, max_blocks_per_seq=4, batch_size=2)
    cache["block_tables"][0] = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    cache["context_lens"][0] = 5
    calls = []
    monkeypatch.setattr(transformer_mod, "paged_write_rows", lambda *a: calls.append(a) or paged_write_rows(*a))
    with torch.no_grad():
        logits, _, _ = model.paged_verify(torch.tensor([[3, 4, 5], [0, 0, 0]]), cache)
    assert len(calls) == 1 and logits.shape == (2, 3, 37) and torch.isfinite(logits).all()
    assert cache["k"][0][2].abs().sum() > 0  # slot 0's tokens landed in block 2 of every layer
    assert all(cache["k"][i][2].abs().sum() > 0 for i in range(3))


def test_count_accepted_drafts_matches_jax():
    rng = np.random.default_rng(4)
    for K in range(5):
        proposed = rng.integers(0, 3, (64, K + 1)).astype(np.int32)
        sampled = rng.integers(0, 3, (64, K + 1)).astype(np.int32)
        sampled[::4, :K] = proposed[::4, 1:]  # every 4th row accepts everything
        got = count_accepted_drafts(torch.from_numpy(sampled), torch.from_numpy(proposed))
        want = np.asarray(jax_count_accepted(jnp.asarray(sampled), jnp.asarray(proposed)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy()[::4] == K).all()


@pytest.mark.parametrize("heads", [(2, 2), (16, 1)], ids=["mha", "mqa16"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("d", [80, 256])
def test_verify_plain_matches_jax_at_wide_head_dims(d, quant, heads):
    """The verify parity above at the head dims 80 and 256, Q = 3, MHA and
    MQA at 16 : 1; the same tables (a query run crossing a block edge, the
    table's end, an idle slot at len 0), and at Q = 1 the decode at lens + 1
    bit for bit."""
    H, hkv = heads
    rng = np.random.default_rng(3 * d + H)
    kf = rng.standard_normal((NB, BS, hkv, d)).astype(np.float32)
    vf = rng.standard_normal((NB, BS, hkv, d)).astype(np.float32)
    pools = dict(k=kf, v=vf)
    if quant:
        (kq, ks), (vq, vs) = jax_quantize(jnp.asarray(kf)), jax_quantize(jnp.asarray(vf))
        pools = dict(k=np.array(kq), v=np.array(vq), k_scale=np.array(ks[..., 0]), v_scale=np.array(vs[..., 0]))
    lens = np.minimum(LENS, MB * BS - 3)
    q = rng.standard_normal((B, 3, H, d)).astype(np.float32)
    jargs, jkw, targs, tkw = _args(pools, q, lens=lens)
    out = paged_verify_attention_kernel(*targs, **tkw).numpy()
    np.testing.assert_allclose(out, np.asarray(paged_verify_attention_xla(*jargs, **jkw)), **TOL)
    np.testing.assert_allclose(out, np.asarray(paged_verify_attention_pallas(*jargs, **jkw, interpret=True)), **TOL)
    assert np.isfinite(out[3]).all()
    _, _, t1, _ = _args(pools, q[:, :1].copy(), lens=lens)
    verify = paged_verify_attention_reference(*t1, **tkw)
    decode = paged_attention_reference(t1[0][:, 0], *t1[1:4], t1[4] + 1, **tkw)
    assert torch.equal(verify[:, 0], decode)
