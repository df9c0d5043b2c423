"""Port parity for paged decode attention and the paged-KV writes: the port's
kernel wrapper on CPU tensors (its plain version; the CUDA kernel is held
against the same plain version on the card by chip_smoke.py) against
trlx_tpu's Pallas ``paged_attention_pallas`` in interpret mode and its
``paged_attention_xla``, on pools with a prefix-shared block, a mid-batch
replaced slot and an idle slot at len 1 on the null block, f32 and int8
pools, rep=2. ``quantize_kv_rows`` and ``write_paged_kv`` must be bit-exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trlx_tpu.models.transformer import quantize_kv_rows as jax_quantize
from trlx_tpu.ops.paged_attention import (
    paged_attention_pallas,
    paged_attention_xla,
    write_paged_kv as jax_write_paged_kv,
)
from trlx_tpu_torch.models.transformer import quantize_kv_rows
from trlx_tpu_torch.ops import _kernels
from trlx_tpu_torch.ops.paged_attention import (
    paged_attention_kernel,
    paged_attention_reference,
    paged_decode_attention,
    write_paged_kv,
)

pytestmark = pytest.mark.torch_port

B, HKV, REP, D = 4, 2, 2, 8
NB, BS, MB = 10, 4, 4


def _pools(rng, quant):
    """Slots 0 and 1 share physical block 1 (prefix sharing), slot 2 holds
    fresh blocks from a later wave (mid-batch replacement), slot 3 is idle:
    a null table row at len 1."""
    kf = rng.standard_normal((NB, BS, HKV, D)).astype(np.float32)
    vf = rng.standard_normal((NB, BS, HKV, D)).astype(np.float32)
    tables = np.array([[1, 2, 3, 0], [1, 4, 0, 0], [7, 8, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.array([11, 6, 2, 1], np.int32)
    if not quant:
        return dict(k=kf, v=vf), tables, lens
    kq, ks = jax_quantize(jnp.asarray(kf))
    vq, vs = jax_quantize(jnp.asarray(vf))
    return dict(k=np.array(kq), v=np.array(vq), k_scale=np.array(ks[..., 0]),
                v_scale=np.array(vs[..., 0])), tables, lens


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
def test_paged_plain_matches_jax_pallas_and_xla(quant):
    rng = np.random.default_rng(0)
    pools, tables, lens = _pools(rng, quant)
    q = rng.standard_normal((B, HKV * REP, D)).astype(np.float32)
    jkw = {k: jnp.asarray(pools[k]) for k in ("k_scale", "v_scale") if k in pools}
    tkw = {k: torch.from_numpy(pools[k]) for k in ("k_scale", "v_scale") if k in pools}
    jargs = (jnp.asarray(q), jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
             jnp.asarray(tables), jnp.asarray(lens))
    targs = (torch.from_numpy(q), torch.from_numpy(pools["k"]), torch.from_numpy(pools["v"]),
             torch.from_numpy(tables), torch.from_numpy(lens))
    ref_pl = np.asarray(paged_attention_pallas(*jargs, **jkw, interpret=True))
    ref_xla = np.asarray(paged_attention_xla(*jargs, **jkw))
    _kernels.reset_launches()
    out = paged_attention_kernel(*targs, **tkw).numpy()
    assert _kernels.launches()["paged_decode"] == 0  # CPU tensors never launch
    np.testing.assert_allclose(out, ref_pl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, ref_xla, rtol=1e-5, atol=1e-5)
    assert np.isfinite(out[3]).all()
    for impl in ("auto", "pallas", "xla"):
        got = paged_decode_attention(*targs, **tkw, impl=impl).numpy()
        np.testing.assert_array_equal(got, out)
    with pytest.raises(ValueError, match="impl"):
        paged_decode_attention(*targs, **tkw, impl="tpu")


def test_prefix_shared_block_and_mid_batch_replacement():
    rng = np.random.default_rng(1)
    pools, tables, lens = _pools(rng, quant=False)
    q = np.repeat(rng.standard_normal((1, HKV * REP, D)), B, 0).astype(np.float32)
    kp, vp = torch.from_numpy(pools["k"]), torch.from_numpy(pools["v"])
    same = np.full((B,), BS, np.int32)  # every slot attends over its first block only
    out = paged_attention_reference(torch.from_numpy(q), kp, vp, torch.from_numpy(tables), torch.from_numpy(same))
    assert torch.equal(out[0], out[1])  # same physical block 1
    assert (out[0] - out[2]).abs().max() > 1e-3
    before = paged_attention_reference(torch.from_numpy(q), kp, vp, torch.from_numpy(tables), torch.from_numpy(lens))
    t2, l2 = tables.copy(), lens.copy()
    t2[1], l2[1] = [5, 6, 0, 0], 7  # a new admission into slot 1
    after = paged_attention_reference(torch.from_numpy(q), kp, vp, torch.from_numpy(t2), torch.from_numpy(l2))
    for b in (0, 2, 3):
        assert torch.equal(before[b], after[b])
    assert (before[1] - after[1]).abs().max() > 1e-3


def test_quantize_kv_rows_bit_exact():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((6, 3, 8)) * 3).astype(np.float32)
    x[0] = 0.0  # all-zero rows: scale 1e-8/127, values 0
    # exact .5 ties: amax 127 gives scale 1.0, so x / scale hits .5 exactly
    x[1, :, 0] = 127.0
    x[1, :, 1:] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32)
    q, s = quantize_kv_rows(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy()[1, 0, 1:], [0, 2, 2, 0, -2, -2, 126])


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
def test_write_paged_kv_bit_exact(quant):
    rng = np.random.default_rng(3)
    pools, tables, _ = _pools(rng, quant)
    lens = np.array([11, 6, 3, 0], np.int32)  # write positions; slot 3 idle -> null block
    k_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    k_new[2] = 0.0
    jcache = {key: jnp.asarray(val) for key, val in pools.items()}
    jcache.update(block_tables=jnp.asarray(tables), context_lens=jnp.asarray(lens))
    tcache = {key: torch.from_numpy(val.copy()) for key, val in pools.items()}
    tcache.update(block_tables=torch.from_numpy(tables), context_lens=torch.from_numpy(lens))
    jout = jax_write_paged_kv(jcache, jnp.asarray(k_new), jnp.asarray(v_new))
    tout = write_paged_kv(tcache, torch.from_numpy(k_new), torch.from_numpy(v_new))
    assert tout is tcache  # in place
    for key in pools:
        np.testing.assert_array_equal(tout[key].numpy(), np.asarray(jout[key]), err_msg=key)


@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (16, 1)], ids=["mha", "gqa", "mqa16"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("d", [80, 256])
def test_paged_plain_matches_jax_at_wide_head_dims(d, quant, heads):
    """The decode parity above at the head dims 80 and 256 of the kernels'
    set, over MHA, GQA and MQA at ``gpt_bigcode``'s 16 : 1; the same tables
    (a prefix-shared block, a replaced slot, an idle slot at len 1 on the
    null block)."""
    H, hkv = heads
    rng = np.random.default_rng(d + H)
    kf = rng.standard_normal((NB, BS, hkv, d)).astype(np.float32)
    vf = rng.standard_normal((NB, BS, hkv, d)).astype(np.float32)
    _, tables, lens = _pools(rng, False)
    pools = dict(k=kf, v=vf)
    if quant:
        (kq, ks), (vq, vs) = jax_quantize(jnp.asarray(kf)), jax_quantize(jnp.asarray(vf))
        pools = dict(k=np.array(kq), v=np.array(vq), k_scale=np.array(ks[..., 0]), v_scale=np.array(vs[..., 0]))
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    jkw = {k: jnp.asarray(pools[k]) for k in ("k_scale", "v_scale") if k in pools}
    tkw = {k: torch.from_numpy(pools[k]) for k in ("k_scale", "v_scale") if k in pools}
    jargs = (jnp.asarray(q), jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
             jnp.asarray(tables), jnp.asarray(lens))
    out = paged_attention_kernel(torch.from_numpy(q), torch.from_numpy(pools["k"]), torch.from_numpy(pools["v"]),
                                 torch.from_numpy(tables), torch.from_numpy(lens), **tkw).numpy()
    np.testing.assert_allclose(out, np.asarray(paged_attention_pallas(*jargs, **jkw, interpret=True)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(paged_attention_xla(*jargs, **jkw)), rtol=1e-5, atol=1e-5)
    assert np.isfinite(out[3]).all()
