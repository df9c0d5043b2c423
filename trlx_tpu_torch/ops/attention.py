"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Counterpart of ``trlx_tpu/ops/attention.py`` (forward only; the two backward
kernels come with the training slice). Layouts match the JAX package's public
functions: q ``[B, H, T, D]``, k/v ``[B, Hkv, S, D]`` with grouped heads
(query head h reads kv head ``h // (H // Hkv)``), ``kv_valid`` ``[B, S]``.
Masking is by cache slot: key s is visible to query t when
``kv_valid[b, s] > 0`` and, if causal, ``s <= t``. Rows with no visible key
produce 0; their logsumexp is ``NEG_INF``.

- :func:`attention_reference` — the plain PyTorch version, step by step as
  ``xla_attention`` (grouped K/V repeated, f32 scores and softmax).
- :func:`flash_attention` — the wrapper: a CUDA tensor launches the kernel
  in ``csrc/flash_fwd.cu`` (or raises); a CPU tensor takes the plain version.
"""

import math
from typing import Optional

import torch

from trlx_tpu_torch.ops import _kernels

NEG_INF = -1e30

#: head dims the kernel is instantiated for (csrc/flash_fwd.cu dispatch_d)
FLASH_HEAD_DIMS = (16, 32, 64, 96, 128)


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
    """Flash attention forward, ``[B, H, T, D]`` layout; K/V may carry fewer
    (grouped) heads. CUDA tensors run the kernel; CPU tensors run
    :func:`attention_reference`. Returns ``out`` or ``(out, lse)``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_valid, causal, scale, return_lse)
    return _flash_cuda(q, k, v, kv_valid, causal, scale, return_lse)


def _flash_cuda(q, k, v, kv_valid, causal, scale, return_lse):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    for name, x in (("k", k), ("v", v), ("kv_valid", kv_valid)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, q on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q/k/v must share float32 or bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if kv_valid.dtype != torch.int32 or kv_valid.shape != (B, S):
        raise ValueError(
            f"flash_attention: kv_valid must be int32 [{B}, {S}], got "
            f"{kv_valid.dtype} {tuple(kv_valid.shape)}"
        )
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {FLASH_HEAD_DIMS}")
    if not all(x.is_contiguous() for x in (q, k, v, kv_valid)):
        raise ValueError("flash_attention: q, k, v and kv_valid must be contiguous")
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
