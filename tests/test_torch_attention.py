"""Port parity for the flash-attention forward: the port's ``flash_attention``
on CPU tensors (its plain version; the CUDA kernel is held against the same
plain version on the card by chip_smoke.py) against trlx_tpu's Pallas
``flash_attention`` in interpret mode and its ``xla_attention``. Inputs come
from numpy with a fixed seed. f32, tolerance 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trlx_tpu.ops.attention import _flash_forward, flash_attention as jax_flash, xla_attention
from trlx_tpu_torch.ops import _kernels
from trlx_tpu_torch.ops.attention import NEG_INF, attention_reference, flash_attention

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, H, Hkv, T, S, D, seed=0, pad=(0,)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    valid = np.ones((B, S), np.int32)
    for b, p in enumerate(pad):
        valid[b, :p] = 0  # left padding
    return q, k, v, valid


CASES = {
    "square": dict(B=2, H=2, Hkv=2, T=16, S=16, D=8, pad=(0, 5)),
    "odd_37": dict(B=2, H=2, Hkv=2, T=37, S=37, D=8, pad=(3, 0)),
    "t144": dict(B=1, H=2, Hkv=2, T=144, S=144, D=16, pad=(16,)),
    "gqa_8_2": dict(B=2, H=8, Hkv=2, T=24, S=24, D=8, pad=(0, 7)),
    # the wide head dims of the kernels' set: 80 (Pythia-2.8B, OPT-2.7B) and 256 (GPT-J)
    "d80_gqa": dict(B=2, H=4, Hkv=2, T=40, S=40, D=80, pad=(0, 9)),
    "d256_mqa": dict(B=2, H=4, Hkv=1, T=24, S=24, D=256, pad=(5, 0)),
}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_matches_jax(case, causal):
    q, k, v, valid = _inputs(**CASES[case])
    out = flash_attention(*map(torch.from_numpy, (q, k, v, valid)), causal=causal)
    ref_pallas = jax_flash(*map(jnp.asarray, (q, k, v, valid)), causal, None, 128, 128, True)
    ref_xla = xla_attention(*map(jnp.asarray, (q, k, v, valid)), causal, 1.0 / np.sqrt(q.shape[-1]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_pallas), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_xla), **TOL)


def test_fully_masked_row_is_zero_with_neg_inf_lse():
    q, k, v, valid = _inputs(B=2, H=2, Hkv=1, T=12, S=12, D=8, pad=(4, 12))
    out, lse = flash_attention(*map(torch.from_numpy, (q, k, v, valid)), return_lse=True)
    jout, jlse = _flash_forward(
        *map(jnp.asarray, (q, k, v, valid)), True, 1.0 / np.sqrt(8), 128, 128, True, with_lse=True
    )
    # batch 1 has no valid key at all; batch 0's first 4 query rows see only padding
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.equal(out[0, :, :4], torch.zeros_like(out[0, :, :4]))
    assert (lse[1] == NEG_INF).all() and (lse[0, :, :4] == NEG_INF).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("D", [80, 256])
def test_fully_masked_row_at_wide_head_dims(D):
    """As above at the head dims 80 and 256, with grouped heads: a batch row
    with no valid key gives 0 and lse NEG_INF, padding-only query rows too."""
    q, k, v, valid = _inputs(B=2, H=4, Hkv=2, T=20, S=20, D=D, pad=(6, 20), seed=D)
    out, lse = flash_attention(*map(torch.from_numpy, (q, k, v, valid)), return_lse=True)
    jout, jlse = _flash_forward(
        *map(jnp.asarray, (q, k, v, valid)), True, 1.0 / np.sqrt(D), 128, 128, True, with_lse=True
    )
    assert torch.equal(out[1], torch.zeros_like(out[1])) and (lse[1] == NEG_INF).all()
    assert torch.equal(out[0, :, :6], torch.zeros_like(out[0, :, :6])) and (lse[0, :, :6] == NEG_INF).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    q, k, v, valid = map(torch.from_numpy, _inputs(B=1, H=2, Hkv=2, T=8, S=8, D=8))
    _kernels.reset_launches()
    a = flash_attention(q, k, v, valid)
    b = attention_reference(q, k, v, valid)
    assert torch.equal(a, b)
    assert _kernels.launches()["flash_fwd"] == 0
