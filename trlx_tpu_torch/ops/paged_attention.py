"""Paged-KV attention: gather K/V through a block table.

Counterpart of ``trlx_tpu/ops/paged_attention.py``. The serving engine
stores the KV cache as a pool of fixed-size token blocks; each slot
addresses its tokens through a per-sequence block table.

- single-token decode: :func:`paged_attention_reference` (the plain PyTorch
  version, step by step as ``paged_attention_xla``: gather, masked f32
  softmax, int8 scales folded into the scores (k) and the probabilities
  (v)), :func:`paged_attention_kernel` (the wrapper of the CUDA kernel
  ``paged_decode`` in ``csrc/paged_decode.cu``) and the dispatch
  :func:`paged_decode_attention`;
- multi-token verify (speculative decoding, chunked prefill):
  :func:`paged_verify_attention_reference` (as ``paged_verify_attention_xla``),
  :func:`paged_verify_attention_kernel` (the kernel ``paged_verify`` in the
  same source) and :func:`paged_verify_attention`;
- the in-place pool writes :func:`write_paged_kv` (one token per slot) and
  :func:`write_paged_kv_multi` (Q tokens per slot, landing where
  :func:`paged_write_rows` says).

A wrapper takes the plain version for a CPU tensor; a CUDA tensor launches
the kernel or raises.

Layouts (per layer), the JAX package's own so converted pools drop in:

- ``k_pool`` / ``v_pool``: ``[num_blocks, block_size, Hkv, D]`` in the cache
  dtype, or int8 under quantization,
- ``k_scale`` / ``v_scale``: ``[num_blocks, block_size, Hkv]`` f32 per-row
  scales (quantized layout only; scheme: ``quantize_kv_rows``),
- ``block_tables``: ``[B, max_blocks]`` int32 physical block ids,
- ``context_lens``: ``[B]`` int32 — for decode, valid tokens per slot
  INCLUDING the token written this step; for verify, the tokens present
  BEFORE the step's append (query j sees positions ``< lens + j + 1``).

Block 0 is reserved by the allocator as the null block: unused block-table
entries point at it, keeping every gather in range.
"""

import math
from typing import Dict, Optional

import torch

from trlx_tpu_torch.ops import _kernels

NEG_INF = -1e30  # kernel-internal mask value (f32 exact, like ops/attention.py)

#: head dims of the tensor-core body (bf16 queries; dispatch_mma in csrc/paged_decode.cu)
PAGED_MMA_HEAD_DIMS = (16, 32, 64, 96, 128)


def paged_attention_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain path: gather each slot's blocks, mask, softmax in f32.

    q ``[B, H, D]``; returns ``[B, H, D]`` in ``q.dtype``. A slot with
    ``context_lens == 0`` gets a uniform softmax over its masked scores (as
    ``paged_attention_xla`` does); the kernel writes 0 there. The engine
    never attends at length 0."""
    B, H, D = q.shape
    NB, BS, Hkv, _ = k_pool.shape
    MB = block_tables.shape[1]
    S = MB * BS
    rep = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    tables = block_tables.long()
    kh = k_pool[tables].reshape(B, S, Hkv, D)  # [B, MB, BS, Hkv, D] -> [B, S, Hkv, D]
    vh = v_pool[tables].reshape(B, S, Hkv, D)
    qg = q.reshape(B, Hkv, rep, D)
    scores = torch.einsum("bkrd,bskd->bkrs", qg.float(), kh.float()) * scale
    if k_scale is not None:
        ks = k_scale[tables].reshape(B, S, Hkv)
        scores = scores * ks.permute(0, 2, 1)[:, :, None, :]
    valid = torch.arange(S, device=q.device)[None, :] < context_lens[:, None]
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        vs = v_scale[tables].reshape(B, S, Hkv)
        probs = probs * vs.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkrs,bskd->bkrd", probs, vh.float())
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention_kernel(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The decode kernel's wrapper: CUDA tensors launch
    ``csrc/paged_decode.cu``; CPU tensors run :func:`paged_attention_reference`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, context_lens,
            k_scale=k_scale, v_scale=v_scale, scale=scale,
        )
    _check_kernel_inputs(q, k_pool, v_pool, block_tables, context_lens, k_scale, v_scale)
    B, H, D = q.shape
    NB, BS, Hkv, _ = k_pool.shape
    MB = block_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _kernels.library("paged_decode")
    quant = k_scale is not None
    with torch.cuda.device(q.device):
        rc = lib.paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            B, H, Hkv, D, BS, MB, float(scale),
            _kernels.dtype_code(q.dtype), _kernels.dtype_code(k_pool.dtype),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _kernels.check("paged_decode", rc)
    _kernels.count_launch("paged_decode")
    return out


def _check_kernel_inputs(q, k_pool, v_pool, block_tables, context_lens, k_scale, v_scale) -> None:
    """What both CUDA entry points take: q ``[B, H, D]`` (decode) or ``[B,
    Q, H, D]`` (verify) in f32 or bf16 on a CUDA device (bf16: a head dim in
    :data:`PAGED_MMA_HEAD_DIMS`); pools of q's dtype, or int8 with f32
    scales; int32 tables ``[B, MB]`` and lens ``[B]``; everything contiguous
    on q's device. Raises ``ValueError`` otherwise."""
    if q.device.type != "cuda":
        raise ValueError(f"paged attention: no kernel for device {q.device}")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    NB, BS, Hkv, Dk = k_pool.shape
    MB = block_tables.shape[1]
    quant = k_scale is not None
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "context_lens": context_lens}
    if quant:
        if v_scale is None:
            raise ValueError("paged attention: k_scale without v_scale")
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"paged attention: {name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"paged attention: {name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged attention: q must be float32 or bfloat16, got {q.dtype}")
    kv_ok = k_pool.dtype == torch.int8 if quant else k_pool.dtype == q.dtype
    if not kv_ok or v_pool.dtype != k_pool.dtype:
        raise ValueError(
            f"paged attention: pools {k_pool.dtype}/{v_pool.dtype} do not match q "
            f"{q.dtype} (int8 pools need scales)"
        )
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                  or k_scale.shape != (NB, BS, Hkv) or v_scale.shape != (NB, BS, Hkv)):
        raise ValueError(f"paged attention: scales must be float32 [{NB}, {BS}, {Hkv}]")
    if Dk != D or v_pool.shape != k_pool.shape or H % Hkv:
        raise ValueError(f"paged attention: bad shapes q{tuple(q.shape)} pool{tuple(k_pool.shape)}")
    if q.dtype == torch.bfloat16 and D not in PAGED_MMA_HEAD_DIMS:
        raise ValueError(f"paged attention: bfloat16 head dim {D} not in {PAGED_MMA_HEAD_DIMS}")
    if (block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32
            or block_tables.shape != (B, MB) or context_lens.shape != (B,)):
        raise ValueError("paged attention: block_tables [B, MB] and context_lens [B] must be int32")


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatch: ``impl`` in {"auto", "pallas", "xla"} (the JAX config's
    names). "auto" and "pallas" go through the kernel's wrapper, which
    launches the CUDA kernel for a CUDA tensor and runs the plain version for
    a CPU tensor; "xla" always runs the plain version."""
    kw = dict(k_scale=k_scale, v_scale=v_scale, scale=scale)
    if impl in ("auto", "pallas"):
        return paged_attention_kernel(q, k_pool, v_pool, block_tables, context_lens, **kw)
    if impl == "xla":
        return paged_attention_reference(q, k_pool, v_pool, block_tables, context_lens, **kw)
    raise ValueError(f"unknown paged attention impl {impl!r}")


def paged_verify_attention_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain path of the multi-token verify, step by step as
    ``paged_verify_attention_xla``: q ``[B, Q, H, D]``, token j at position
    ``context_lens + j`` (lens = tokens present BEFORE the append), query j
    attending positions ``< context_lens + j + 1``. Returns ``[B, Q, H, D]``
    in ``q.dtype``.

    The Q tokens fold into the grouped-head row axis (row r is query
    ``r // rep``), so the products are the decode path's; at Q=1 this is
    :func:`paged_attention_reference` with ``context_lens + 1``, bit for bit."""
    B, Q, H, D = q.shape
    NB, BS, Hkv, _ = k_pool.shape
    MB = block_tables.shape[1]
    S = MB * BS
    rep = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    tables = block_tables.long()
    kh = k_pool[tables].reshape(B, S, Hkv, D)
    vh = v_pool[tables].reshape(B, S, Hkv, D)
    # [B, Q, H, D] -> [B, Hkv, Q*rep, D]; row r <-> (query r // rep, head r % rep)
    qg = q.reshape(B, Q, Hkv, rep, D).permute(0, 2, 1, 3, 4).reshape(B, Hkv, Q * rep, D).contiguous()
    scores = torch.einsum("bkrd,bskd->bkrs", qg.float(), kh.float()) * scale
    if k_scale is not None:
        ks = k_scale[tables].reshape(B, S, Hkv)
        scores = scores * ks.permute(0, 2, 1)[:, :, None, :]
    q_idx = torch.arange(Q * rep, device=q.device) // rep
    valid = (torch.arange(S, device=q.device)[None, None, :]
             < context_lens[:, None, None] + q_idx[None, :, None] + 1)  # [B, Q*rep, S]
    scores = torch.where(valid[:, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        vs = v_scale[tables].reshape(B, S, Hkv)
        probs = probs * vs.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkrs,bskd->bkrd", probs, vh.float())
    return out.reshape(B, Hkv, Q, rep, D).permute(0, 2, 1, 3, 4).reshape(B, Q, H, D).to(q.dtype)


def paged_verify_attention_kernel(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The verify kernel's wrapper: CUDA tensors launch ``paged_verify`` in
    ``csrc/paged_decode.cu``; CPU tensors run
    :func:`paged_verify_attention_reference`. Input checks as
    :func:`paged_attention_kernel`'s, with q ``[B, Q, H, D]``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_verify_attention_reference(
            q, k_pool, v_pool, block_tables, context_lens,
            k_scale=k_scale, v_scale=v_scale, scale=scale,
        )
    if q.dim() != 4:
        raise ValueError(f"paged verify: q must be [B, Q, H, D], got {tuple(q.shape)}")
    _check_kernel_inputs(q, k_pool, v_pool, block_tables, context_lens, k_scale, v_scale)
    B, Q, H, D = q.shape
    NB, BS, Hkv, _ = k_pool.shape
    MB = block_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0 or Q == 0:
        return out
    lib = _kernels.library("paged_verify")
    quant = k_scale is not None
    with torch.cuda.device(q.device):
        rc = lib.paged_verify(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            B, Q, H, Hkv, D, BS, MB, float(scale),
            _kernels.dtype_code(q.dtype), _kernels.dtype_code(k_pool.dtype),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _kernels.check("paged_verify", rc)
    _kernels.count_launch("paged_verify")
    return out


def paged_verify_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Multi-token dispatch, the ``impl`` policy of
    :func:`paged_decode_attention`. q is ``[B, Q, H, D]``; ``context_lens``
    counts the tokens present BEFORE the Q-token append."""
    kw = dict(k_scale=k_scale, v_scale=v_scale, scale=scale)
    if impl in ("auto", "pallas"):
        return paged_verify_attention_kernel(q, k_pool, v_pool, block_tables, context_lens, **kw)
    if impl == "xla":
        return paged_verify_attention_reference(q, k_pool, v_pool, block_tables, context_lens, **kw)
    raise ValueError(f"unknown paged attention impl {impl!r}")


def write_paged_kv(cache: Dict[str, torch.Tensor], k_new: torch.Tensor, v_new: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write one token's K/V per slot into the block pool, IN PLACE.

    ``cache`` is one layer's paged cache: pools plus the shared
    ``block_tables`` / ``context_lens`` (lens here = tokens already present,
    i.e. the write position of the incoming token). ``k_new``/``v_new`` are
    ``[B, Hkv, D]``. Quantizes when the layer carries scale pools. The pools
    are updated in place (one row per slot) instead of copied as JAX's
    functional scatter does: a copy of every layer's pool per decode step
    would move the whole cache to write B rows. Returns ``cache``.

    Distinct live slots always write distinct rows (the allocator never lets
    a write frontier sit in a shared block); idle slots all write the
    reserved null block 0, whose contents are never read as valid. An idle
    slot's length keeps growing with every step, and once it reaches the
    table's reach (``max_blocks * block_size``) its write goes to the null
    block too: JAX's gather / scatter drop that write, a torch gather past
    the table would fail.
    """
    from trlx_tpu_torch.models.transformer import quantize_kv_rows

    NB, BS = cache["k"].shape[:2]
    tables = cache["block_tables"].long()
    lens = cache["context_lens"].long()
    inside = lens < tables.shape[1] * BS
    col = torch.where(inside, lens // BS, torch.zeros_like(lens))
    block = torch.where(inside, torch.gather(tables, 1, col[:, None])[:, 0], torch.zeros_like(lens))
    slot = block * BS + lens % BS  # [B] flat row in the (NB*BS) pool

    def scatter(pool, rows):
        pool.view(NB * BS, *pool.shape[2:])[slot] = rows.to(pool.dtype)

    if "k_scale" in cache:
        kq, ks = quantize_kv_rows(k_new)
        vq, vs = quantize_kv_rows(v_new)
        scatter(cache["k"], kq)
        scatter(cache["v"], vq)
        scatter(cache["k_scale"], ks[..., 0])
        scatter(cache["v_scale"], vs[..., 0])
    else:
        scatter(cache["k"], k_new)
        scatter(cache["v"], v_new)
    return cache


def paged_write_rows(block_tables: torch.Tensor, context_lens: torch.Tensor, Q: int, block_size: int):
    """Where a Q-token append lands: ``(rows, keep)``, with ``keep`` the
    indices into the flattened ``[B * Q]`` tokens whose position
    ``context_lens + j`` lies inside the table's reach (``max_blocks *
    block_size``), and ``rows`` their flat rows in the ``(num_blocks *
    block_size)`` pool. Positions past the reach are dropped (the JAX
    package's ``mode="drop"``): filtering them costs one device-to-host
    sync, so a forward computes this once for all its layers."""
    tables = block_tables.long()
    MB = tables.shape[1]
    pos = context_lens.long()[:, None] + torch.arange(Q, device=tables.device)[None, :]
    pos_c = pos.clamp(max=MB * block_size - 1)
    blk = torch.gather(tables, 1, pos_c // block_size)
    keep = torch.nonzero((pos < MB * block_size).reshape(-1))[:, 0]  # the one sync
    rows = (blk * block_size + pos_c % block_size).reshape(-1)[keep]
    return rows, keep


def write_paged_kv_multi(cache: Dict[str, torch.Tensor], k_new: torch.Tensor, v_new: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write Q tokens' K/V per slot IN PLACE: ``k_new``/``v_new`` ``[B, Q,
    Hkv, D]``, token j landing at position ``context_lens + j`` through the
    slot's block table (lens = tokens already present, as in
    :func:`write_paged_kv`). Returns ``cache``.

    Positions at or past the table's reach are dropped and positions whose
    table entry is 0 land in the null block (:func:`paged_write_rows`; a
    ``cache["write_rows"]`` computed once per forward is used as it is).
    Quantization is per ``[Hkv, D]`` row through ``quantize_kv_rows``, as the
    single-token write does, which is what keeps the speculative path
    bit-identical to one-token decode. Idle slots may write the same
    null-block rows: the stored value is then any one of them, harmless
    because the null block is never read as valid."""
    from trlx_tpu_torch.models.transformer import quantize_kv_rows

    NB, BS, Hkv, D = cache["k"].shape
    B, Q = k_new.shape[:2]
    rows, keep = cache.get("write_rows") or paged_write_rows(cache["block_tables"], cache["context_lens"], Q, BS)

    def scatter(pool, vals):
        vals = vals.reshape(B * Q, *pool.shape[2:])[keep]
        pool.view(NB * BS, *pool.shape[2:])[rows] = vals.to(pool.dtype)

    if "k_scale" in cache:
        kq, ks = quantize_kv_rows(k_new.reshape(B * Q, Hkv, D))
        vq, vs = quantize_kv_rows(v_new.reshape(B * Q, Hkv, D))
        scatter(cache["k"], kq)
        scatter(cache["v"], vq)
        scatter(cache["k_scale"], ks[..., 0])
        scatter(cache["v_scale"], vs[..., 0])
    else:
        scatter(cache["k"], k_new)
        scatter(cache["v"], v_new)
    return cache


def paged_pool_layout(
    num_blocks: int, block_size: int, kv_heads: int, dim_per_head: int,
    dtype: torch.dtype, quant: bool,
) -> dict:
    """Per-layer pool buffers as ``{key: (shape, dtype)}`` (mirror of the
    contiguous ``kv_cache_layout``)."""
    shape = (num_blocks, block_size, kv_heads, dim_per_head)
    if quant:
        return {
            "k": (shape, torch.int8), "v": (shape, torch.int8),
            "k_scale": (shape[:-1], torch.float32),
            "v_scale": (shape[:-1], torch.float32),
        }
    return {"k": (shape, dtype), "v": (shape, dtype)}
