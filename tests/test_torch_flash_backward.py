"""Port parity for the flash-attention backward: the port's
``flash_backward_reference`` (the plain version of the dK/dV and dQ kernels,
which chip_smoke.py holds the CUDA kernels against on the card) and its
autograd path, on CPU tensors, against ``jax.grad`` through trlx_tpu's
Pallas ``flash_attention`` in interpret mode with ``BACKWARD_IMPL="pallas"``.
Inputs come from numpy with a fixed seed; f32; tolerance atol 2e-4 /
rtol 1e-4 (the Pallas backward's own grad-parity tolerance). Besides the
Pallas tests' own cases, the shapes the Hopper kernels' 64-row tiling makes
into edges: T = S below one tile (16, 17), every head dim of
``FLASH_HEAD_DIMS`` (80 and 256 too), query-head groups of 1, 3 and 12,
and a key tile with no valid key beside a query tile of rows that see no
key."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import trlx_tpu.ops.attention as jattn
import trlx_tpu_torch.ops.attention as tattn
from trlx_tpu_torch.ops import _kernels

pytestmark = pytest.mark.torch_port

TOL = dict(atol=2e-4, rtol=1e-4)

# (B, H, Hkv, T, S, share of batch row 0's keys masked from the left[, D]):
# the four grad-parity cases of tests/test_attention.py (D = 16), then the
# kernels' tile edges
CASES = {
    "mha": (2, 2, 2, 64, 64, 0.0),
    "ragged": (2, 2, 2, 40, 72, 0.25),
    "gqa": (1, 4, 2, 48, 48, 0.3),
    "mqa_ragged": (2, 4, 1, 33, 62, 0.2),
    "t16": (2, 4, 4, 16, 16, 0.3),
    "t17": (2, 4, 2, 17, 17, 0.2),
    "d32": (1, 2, 2, 40, 40, 0.1, 32),
    "d64": (1, 2, 2, 40, 40, 0.1, 64),
    "d96": (1, 2, 1, 40, 40, 0.1, 96),
    "d128": (1, 2, 2, 40, 40, 0.1, 128),
    "rep3": (1, 6, 2, 48, 48, 0.2),
    "rep12": (1, 12, 1, 40, 40, 0.2),
    # row 0: keys 0..63 invalid (one whole 64-key tile), so query rows 0..63
    # see no key (one whole 64-row tile of lse == NEG_INF)
    "dead_tiles": (2, 2, 2, 100, 100, 0.64),
    # the wide head dims: 80 with grouped heads; 256 with MHA, and with MQA
    # over a dead key tile and a dead query tile (the D = 256 kernels split
    # each 16-row group over two warps)
    "d80_gqa": (1, 4, 2, 40, 40, 0.1, 80),
    "d256": (1, 2, 2, 40, 40, 0.1, 256),
    "d256_mqa_dead_tiles": (2, 4, 1, 100, 100, 0.64, 256),
}


def _inputs(B, H, Hkv, T, S, maskfrac, D=16, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    valid = np.ones((B, S), np.int32)
    valid[0, : int(S * maskfrac)] = 0
    # a non-uniform cotangent exercises dO properly
    w = (np.arange(B * H * T * D, dtype=np.float32) / (B * H * T * D)).reshape(B, H, T, D)
    return q, k, v, valid, w


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """(inputs, JAX grads) of a CASES entry, computed once per process."""
    inputs = _inputs(*CASES[case])
    return inputs, _jax_grads(*inputs)


def _jax_grads(q, k, v, valid, w):
    def loss(q, k, v):
        out = jattn.flash_attention(q, k, v, jnp.asarray(valid), True, None, 32, 32, True)
        return jnp.sum(out * w) + jnp.sum(out**2)

    prev = jattn.BACKWARD_IMPL
    try:
        jattn.BACKWARD_IMPL = "pallas"
        grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    finally:
        jattn.BACKWARD_IMPL = prev
    return [np.asarray(g) for g in grads]


def _torch_grads(q, k, v, valid, w, impl="pallas"):
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    prev = tattn.set_flash_backward(impl)
    try:
        out = tattn.flash_attention(*qkv, torch.from_numpy(valid))
        loss = (out * torch.from_numpy(w)).sum() + (out**2).sum()
        return [g.numpy() for g in torch.autograd.grad(loss, qkv)]
    finally:
        tattn.set_flash_backward(prev)


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_matches_jax_pallas_backward(case):
    (q, k, v, valid, w), ref = _jax_case(case)
    got = _torch_grads(q, k, v, valid, w)
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_backward_reference_matches_jax(case):
    """The plain backward alone, fed the forward's out and lse and the
    loss's output gradient, against the same JAX grads."""
    (q, k, v, valid, w), ref = _jax_case(case)
    qt, kt, vt, vd = map(torch.from_numpy, (q, k, v, valid))
    out, lse = tattn.flash_attention(qt, kt, vt, vd, return_lse=True)
    g = torch.from_numpy(w) + 2 * out  # d/dout of sum(out*w) + sum(out^2)
    got = tattn.flash_backward_reference(qt, kt, vt, vd, out, lse, g)
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"d{name}", **TOL)


def test_fully_masked_rows_have_zero_grads():
    """A batch row with no valid key (lse == NEG_INF) and query rows that see
    only padding get exactly zero gradients, not NaN, as in JAX."""
    q, k, v, valid, w = _inputs(2, 4, 2, 16, 16, 0.0)
    valid[0] = 0  # batch row 0: everything masked
    valid[1, :5] = 0  # batch row 1: query rows 0..4 see only padding
    got = _torch_grads(q, k, v, valid, w)
    ref = _jax_grads(q, k, v, valid, w)
    for g in got:
        assert np.isfinite(g).all()
        assert (g[0] == 0).all()
    assert (got[0][1, :, :5] == 0).all()  # dq of the padding-only rows
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("D", [80, 256])
def test_fully_masked_rows_have_zero_grads_at_wide_head_dims(D):
    """The fully-masked-row case at the head dims 80 and 256."""
    q, k, v, valid, w = _inputs(2, 4, 2, 16, 16, 0.0, D)
    valid[0] = 0
    valid[1, :5] = 0
    got = _torch_grads(q, k, v, valid, w)
    ref = _jax_grads(q, k, v, valid, w)
    for g in got:
        assert np.isfinite(g).all() and (g[0] == 0).all()
    assert (got[0][1, :, :5] == 0).all()
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **TOL)


def test_set_flash_backward_round_trip_and_env_default():
    prev = tattn.set_flash_backward("xla")
    try:
        assert tattn.BACKWARD_IMPL == "xla"
        assert tattn.set_flash_backward("pallas") == "xla"
        with pytest.raises(ValueError):
            tattn.set_flash_backward("cuda")
        assert tattn.BACKWARD_IMPL == "pallas"
    finally:
        tattn.set_flash_backward(prev)
    import os
    import subprocess
    import sys

    env = dict(os.environ, TRLX_FLASH_BWD="xla")
    out = subprocess.run(
        [sys.executable, "-c", "import trlx_tpu_torch.ops.attention as a; print(a.BACKWARD_IMPL)"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.stdout.strip() == "xla", out.stderr


@pytest.mark.parametrize("case", ["ragged", "mqa_ragged"])
def test_xla_backward_matches_pallas_backward(case):
    q, k, v, valid, w = _inputs(*CASES[case])
    gp = _torch_grads(q, k, v, valid, w, "pallas")
    gx = _torch_grads(q, k, v, valid, w, "xla")
    for a, b in zip(gp, gx):
        np.testing.assert_allclose(a, b, **TOL)


def test_backward_impl_is_captured_at_forward_time():
    """The forward records the selected backward (the JAX package fixes it
    at trace time): switching before ``backward()`` changes nothing."""
    q, k, v, valid, w = _inputs(*CASES["gqa"])
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    prev = tattn.set_flash_backward("pallas")
    try:
        out = tattn.flash_attention(*qkv, torch.from_numpy(valid))
        tattn.set_flash_backward("xla")
        grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), qkv)
    finally:
        tattn.set_flash_backward(prev)
    qt, kt, vt = (x.detach() for x in qkv)
    o, lse = tattn.flash_attention(qt, kt, vt, torch.from_numpy(valid), return_lse=True)
    ref = tattn.flash_backward_reference(qt, kt, vt, torch.from_numpy(valid), o, lse, torch.from_numpy(w))
    for a, b in zip(grads, ref):
        assert torch.equal(a, b)


def test_cpu_backward_launches_no_kernel():
    q, k, v, valid, w = _inputs(*CASES["mha"])
    _kernels.reset_launches()
    _torch_grads(q, k, v, valid, w)
    counts = _kernels.launches()
    assert counts["flash_bwd_dkv"] == 0 and counts["flash_bwd_dq"] == 0 and counts["flash_fwd"] == 0


def test_per_kernel_plain_versions_match_the_whole_backward():
    """chip_smoke.py times K2 and K3 each against its own plain version:
    those are exactly the parts of the whole plain backward."""
    q, k, v, valid, w = _inputs(*CASES["mqa_ragged"])
    qt, kt, vt, vd = map(torch.from_numpy, (q, k, v, valid))
    out, lse = tattn.flash_attention(qt, kt, vt, vd, return_lse=True)
    g = torch.from_numpy(w)
    dq, dk, dv = tattn.flash_backward_reference(qt, kt, vt, vd, out, lse, g)
    dk2, dv2 = tattn.flash_bwd_dkv_reference(qt, kt, vt, vd, out, lse, g)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, tattn.flash_bwd_dq_reference(qt, kt, vt, vd, out, lse, g))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; the CPU path goes through
    flash_backward, which picks the plain version by device."""
    q, k, v, valid, w = _inputs(*CASES["mha"])
    qt, kt, vt, vd, g = map(torch.from_numpy, (q, k, v, valid, w))
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tattn.flash_bwd_dkv(qt, kt, vt, vd, g, lse, lse)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tattn.flash_bwd_dq(qt, kt, vt, vd, g, lse, lse)
