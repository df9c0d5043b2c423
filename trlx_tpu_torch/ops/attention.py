"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``trlx_tpu/ops/attention.py``. Layouts match the JAX
package's public functions: q ``[B, H, T, D]``, k/v ``[B, Hkv, S, D]`` with
grouped heads (query head h reads kv head ``h // (H // Hkv)``), ``kv_valid``
``[B, S]``. Masking is by cache slot: key s is visible to query t when
``kv_valid[b, s] > 0`` and, if causal, ``s <= t``. Rows with no visible key
produce 0; their logsumexp is ``NEG_INF``.

- :func:`attention_reference` — the plain forward, step by step as
  ``xla_attention`` (grouped K/V repeated, f32 scores and softmax).
- :func:`flash_backward_reference` — the plain version of
  ``_flash_backward``: recompute ``P = exp(S - lse)`` under the same mask,
  ``delta = rowsum(dO * O)`` in f32, dK/dV summed over the query-head group.
- :func:`flash_attention` — the differentiable wrapper. A CUDA tensor
  launches the forward kernel (``csrc/flash_fwd.cu``) and, in the backward,
  the dK/dV and dQ kernels (``csrc/flash_bwd.cu``), or raises; a CPU tensor
  takes the plain versions. :func:`set_flash_backward` (or the
  ``TRLX_FLASH_BWD`` environment variable) picks the backward as the JAX
  package does: ``"pallas"`` is the kernels (their plain version on the
  CPU), ``"xla"`` is autograd through :func:`attention_reference`.
"""

import math
import os
from typing import Optional

import torch

from trlx_tpu_torch.ops import _kernels

NEG_INF = -1e30

#: head dims the kernels are instantiated for (the ``switch (D)`` of csrc/flash_fwd.cu and
#: flash_bwd.cu, f32 and bf16 alike; tests/test_torch_kernels_build.py reads them)
FLASH_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)

# "pallas" (default) or "xla": which backward flash_attention runs. The names
# are the JAX package's, so configs carry over: "pallas" is the hand-written
# dK/dV and dQ kernels (their plain version on CPU tensors), "xla" is
# autograd through attention_reference. Read when the forward runs.
BACKWARD_IMPL = os.environ.get("TRLX_FLASH_BWD", "pallas")


def set_flash_backward(impl: str) -> str:
    """Select the flash-attention backward ("pallas" | "xla") for later
    forwards; returns the previous value."""
    global BACKWARD_IMPL
    if impl not in ("pallas", "xla"):
        raise ValueError(f"flash backward must be 'pallas' or 'xla', got {impl!r}")
    prev, BACKWARD_IMPL = BACKWARD_IMPL, impl
    return prev


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Plain attention in f32, ``[B, H, T, D]`` layout; output in q's dtype
    (plus the f32 per-row logsumexp ``[B, H, T]`` when ``return_lse``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    T, S = s.shape[-2], s.shape[-1]
    mask = (kv_valid > 0)[:, None, None, :]
    if causal:
        q_pos = torch.arange(T, device=q.device)[:, None]
        k_pos = torch.arange(S, device=q.device)[None, :]
        mask = mask & (k_pos <= q_pos)[None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # fully-masked rows -> 0
    any_valid = mask.any(dim=-1, keepdim=True)
    p = torch.where(any_valid, p, torch.zeros_like(p))
    out = torch.einsum("bhts,bhsd->bhtd", p, v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(any_valid[..., 0], lse, torch.full_like(lse, NEG_INF))
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Flash attention, ``[B, H, T, D]`` layout; K/V may carry fewer
    (grouped) heads. CUDA tensors run the kernels; CPU tensors run the plain
    versions. Returns ``out`` or ``(out, lse)``. Differentiable in q, k and v
    (``out`` only): the backward is the one :func:`set_flash_backward`
    selected when this forward ran."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not return_lse and torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kv_valid, causal, scale)
    return _flash_forward(q, k, v, kv_valid, causal, scale, return_lse)


def _flash_forward(q, k, v, kv_valid, causal, scale, return_lse):
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_valid, causal, scale, return_lse)
    return _flash_cuda(q, k, v, kv_valid, causal, scale, return_lse)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash forward with its logsumexp saved. Backward: the
    dK/dV and dQ kernels (``"pallas"``) or autograd through the plain
    forward (``"xla"``)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, scale):
        out, lse = _flash_forward(q, k, v, kv_valid, causal, scale, True)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.causal, ctx.scale, ctx.impl = causal, scale, BACKWARD_IMPL
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        if ctx.impl == "pallas":
            dq, dk, dv = flash_backward(q, k, v, kv_valid, out, lse, g, ctx.causal, ctx.scale)
        else:
            with torch.enable_grad():
                qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
                ref = attention_reference(*qkv, kv_valid, ctx.causal, ctx.scale)
                dq, dk, dv = torch.autograd.grad(ref, qkv, g)
        return dq, dk, dv, None, None, None


def _bwd_p_ds(q, k, v, kv_valid, out, lse, g, causal, scale):
    """The recompute both backward kernels share: P = exp(S - lse) under the
    forward's mask, delta = rowsum(dO * O), dS = P * (dP - delta) * scale.
    Returns (p, ds, qf, kf, gf) in f32 with K/V repeated to H heads."""
    B, H, T, D = q.shape
    S = k.shape[2]
    rep = H // k.shape[1]
    qf, gf = q.float(), g.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    mask = (kv_valid > 0)[:, None, None, :]
    if causal:
        q_pos = torch.arange(T, device=q.device)[:, None]
        k_pos = torch.arange(S, device=q.device)[None, :]
        mask = mask & (k_pos <= q_pos)[None, None]
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf) * scale
    # rows with no visible key carry lse == NEG_INF: the guard keeps exp()
    # finite, and their all-false mask zeroes p
    lse_safe = torch.where(lse > NEG_INF / 2, lse, torch.zeros_like(lse))
    p = torch.where(mask, torch.exp(s - lse_safe[..., None]), torch.zeros_like(s))
    delta = (gf * out.float()).sum(dim=-1)  # [B, H, T]
    dp = torch.einsum("bhtd,bhsd->bhts", gf, vf)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, qf, kf, gf


def _dkv_from(p, ds, qf, gf, k, v):
    """dK/dV of kv head hk, summed over its query heads [hk*rep, (hk+1)*rep)."""
    B, Hkv, S, D = k.shape
    rep = qf.shape[1] // Hkv
    dv = torch.einsum("bhts,bhtd->bhsd", p, gf).reshape(B, Hkv, rep, S, D).sum(dim=2)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf).reshape(B, Hkv, rep, S, D).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_reference(q, k, v, kv_valid, out, lse, g, causal: bool = True, scale: Optional[float] = None):
    """Plain flash backward, step by step as ``_flash_backward``: (dq, dk, dv)
    in the dtypes of q, k, v. Sums run in f32; fully-masked rows (lse ==
    ``NEG_INF``) give exactly zero gradients."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p, ds, qf, kf, gf = _bwd_p_ds(q, k, v, kv_valid, out, lse, g, causal, scale)
    dk, dv = _dkv_from(p, ds, qf, gf, k, v)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf).to(q.dtype)
    return dq, dk, dv


def flash_bwd_dkv_reference(q, k, v, kv_valid, out, lse, g, causal: bool = True, scale: Optional[float] = None):
    """The plain version of the dK/dV kernel alone: (dk, dv)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p, ds, qf, _, gf = _bwd_p_ds(q, k, v, kv_valid, out, lse, g, causal, scale)
    return _dkv_from(p, ds, qf, gf, k, v)


def flash_bwd_dq_reference(q, k, v, kv_valid, out, lse, g, causal: bool = True, scale: Optional[float] = None):
    """The plain version of the dQ kernel alone: dq."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _, ds, _, kf, _ = _bwd_p_ds(q, k, v, kv_valid, out, lse, g, causal, scale)
    return torch.einsum("bhts,bhsd->bhtd", ds, kf).to(q.dtype)


def flash_backward(q, k, v, kv_valid, out, lse, g, causal: bool = True, scale: Optional[float] = None):
    """(dq, dk, dv) of flash attention from the forward's ``out`` and
    ``lse`` and the output gradient ``g``: the dK/dV and dQ kernels for CUDA
    tensors (or raises), :func:`flash_backward_reference` for CPU tensors."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, kv_valid, out, lse, g, causal, scale)
    return _flash_bwd_cuda(q, k, v, kv_valid, out, lse, g, causal, scale)


def _check_cuda_inputs(name, q, k, v, kv_valid):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    for arg, x in (("k", k), ("v", v), ("kv_valid", kv_valid)):
        if x.device != q.device:
            raise ValueError(f"{name}: {arg} on {x.device}, q on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"{name}: q/k/v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if kv_valid.dtype != torch.int32 or kv_valid.shape != (B, S):
        raise ValueError(
            f"{name}: kv_valid must be int32 [{B}, {S}], got {kv_valid.dtype} {tuple(kv_valid.shape)}"
        )
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {FLASH_HEAD_DIMS}")
    if not all(x.is_contiguous() for x in (q, k, v, kv_valid)):
        raise ValueError(f"{name}: q, k, v and kv_valid must be contiguous")
    return B, H, Hkv, T, S, D


def _flash_cuda(q, k, v, kv_valid, causal, scale, return_lse):
    B, H, Hkv, T, S, D = _check_cuda_inputs("flash_attention", q, k, v, kv_valid)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if return_lse else None
    if q.numel() == 0:
        return (o, lse) if return_lse else o
    lib = _kernels.library("flash_fwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            B, H, Hkv, T, S, D, int(causal), float(scale),
            _kernels.dtype_code(q.dtype),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _kernels.check("flash_fwd", rc)
    _kernels.count_launch("flash_fwd")
    return (o, lse) if return_lse else o


def _flash_bwd_cuda(q, k, v, kv_valid, out, lse, g, causal, scale):
    g = g.contiguous()
    dims = _check_bwd_inputs("flash_backward", q, k, v, kv_valid, g, lse, out=out)
    delta = (g.float() * out.float()).sum(dim=-1).contiguous()
    dk, dv = _launch_dkv(dims, q, k, v, kv_valid, g, lse, delta, causal, scale)
    dq = _launch_dq(dims, q, k, v, kv_valid, g, lse, delta, causal, scale)
    return dq, dk, dv


def _check_bwd_inputs(name, q, k, v, kv_valid, g, lse, out=None, delta=None):
    """Validate the backward's CUDA inputs once; returns (B, H, Hkv, T, S, D)."""
    dims = _check_cuda_inputs(name, q, k, v, kv_valid)
    B, H, _, T, _, _ = dims
    for arg, x in (("g", g), ("out", out)):
        if x is not None and (x.shape != q.shape or x.dtype != q.dtype or not x.is_contiguous()):
            raise ValueError(
                f"{name}: {arg} must be contiguous and match q {tuple(q.shape)} {q.dtype}, got "
                f"{tuple(x.shape)} {x.dtype}"
            )
    for arg, x in (("lse", lse), ("delta", delta)):
        if x is not None and (x.dtype != torch.float32 or x.shape != (B, H, T) or not x.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be contiguous float32 [{B}, {H}, {T}]")
    return dims


def bwd_delta(q, k, v, kv_valid, out, lse, g):
    """Check the backward's CUDA inputs and return delta = rowsum(dO * O) in
    f32 [B, H, T], taken outside the kernels as ``_flash_backward`` does."""
    _check_bwd_inputs("flash_backward", q, k, v, kv_valid, g, lse, out=out)
    return (g.float() * out.float()).sum(dim=-1).contiguous()


def _launch_dkv(dims, q, k, v, kv_valid, g, lse, delta, causal, scale):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    lib = _kernels.library("flash_bwd_dkv")
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            kv_valid.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims, int(causal), float(scale),
            _kernels.dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _kernels.check("flash_bwd_dkv", rc)
    _kernels.count_launch("flash_bwd_dkv")
    return dk, dv


def _launch_dq(dims, q, k, v, kv_valid, g, lse, delta, causal, scale):
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    lib = _kernels.library("flash_bwd_dq")
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            kv_valid.data_ptr(), dq.data_ptr(), *dims, int(causal), float(scale),
            _kernels.dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _kernels.check("flash_bwd_dq", rc)
    _kernels.count_launch("flash_bwd_dq")
    return dq


def flash_bwd_dkv(q, k, v, kv_valid, g, lse, delta, causal: bool = True, scale: Optional[float] = None):
    """(dk, dv) from the dK/dV kernel (CUDA tensors only; ``delta`` from
    :func:`bwd_delta`)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dims = _check_bwd_inputs("flash_bwd_dkv", q, k, v, kv_valid, g, lse, delta=delta)
    return _launch_dkv(dims, q, k, v, kv_valid, g, lse, delta, causal, scale)


def flash_bwd_dq(q, k, v, kv_valid, g, lse, delta, causal: bool = True, scale: Optional[float] = None):
    """dq from the dQ kernel (CUDA tensors only; ``delta`` from
    :func:`bwd_delta`)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dims = _check_bwd_inputs("flash_bwd_dq", q, k, v, kv_valid, g, lse, delta=delta)
    return _launch_dq(dims, q, k, v, kv_valid, g, lse, delta, causal, scale)
