"""Ring attention: sequence-parallel causal attention over a group of ranks
(counterpart of ``trlx_tpu/ops/ring_attention.py``).

Q/K/V are sharded along the sequence dimension over the group (rank ``i``
holds positions ``[i T/n, (i + 1) T/n)``, every head). Each of ``n`` steps
every rank runs one online-softmax block against the K/V shard it holds,
then passes K/V (and the key mask) one hop around the ring: rank ``i`` sends
to ``i + 1`` and receives from ``i - 1``, so after ``step`` rotations it holds
the shard that started on rank ``(i - step) mod n``.

The causal structure is taken at shard granularity, as the reference's
``_shard_mask``: a visiting shard from an earlier rank is attended in full,
the rank's own shard under the within-shard causal triangle, a later rank's
shard not at all (its block is skipped: every score masked, the reference's
update leaves the accumulators as they were).

GQA keys and values ride the ring at their own head count: the query heads
of one group fold into the row axis (``_fold_q``), so no K/V head is
repeated.

:class:`_Ring` is a ``torch.autograd.Function``: the forward saves only the
local q/k/v, the key mask, the output and the per-row logsumexp (O(T/n) per
rank); the backward runs the ring again, recomputing each block's
probabilities, while the dK/dV accumulators ride with their K/V shard and
arrive home after the full circle of ``n`` rotations. The block products are
``torch.matmul`` in f32 (the reference computes them with ``jnp.einsum``
outside any Pallas kernel). Rotations go through
:func:`~trlx_tpu_torch.parallel.collectives.exchange` and are counted by
``collectives.sequence_counts()``.
"""

import math
from typing import Optional

import torch

from trlx_tpu_torch.parallel import collectives as coll

NEG_INF = -1e30


def _fold_q(x: torch.Tensor, hkv: int):
    """[B, Hkv * rep, T, ...] -> [B, Hkv, rep * T, ...] (row ``r T + t`` is
    query head ``k rep + r`` at position ``t``)."""
    B, H, T = x.shape[:3]
    rep = H // hkv
    return x.reshape((B, hkv, rep * T) + tuple(x.shape[3:])), rep


def _unfold_q(x: torch.Tensor, rep: int) -> torch.Tensor:
    B, hkv, RT = x.shape[:3]
    return x.reshape((B, hkv * rep, RT // rep) + tuple(x.shape[3:]))


def _shard_mask(causal: bool, src: int, my: int, valid_cur: torch.Tensor, tri: torch.Tensor):
    """The visiting shard's mask [B, 1, rows, Tk]: key validity, and the
    causal structure at shard granularity; None when nothing is visible."""
    mask = (valid_cur > 0)[:, None, None, :]
    if causal:
        if src > my:
            return None
        if src == my:
            mask = mask & tri[None, None]
    return mask


def _rotate(tensors, group):
    """Each tensor one hop around the ring (to member ``i + 1``, from ``i - 1``)."""
    n, i = group.size, group.index
    nxt, prv = coll.global_rank(group, (i + 1) % n), coll.global_rank(group, (i - 1) % n)
    coll.count_rotation()
    return coll.exchange([(t, nxt) for t in tensors], [(t, prv) for t in tensors], group)


def _ring_fwd(q, k, v, valid, group, causal, scale):
    B, H, T, D = q.shape
    hkv = k.shape[1]
    qf, rep = _fold_q(q, hkv)
    n = group.size if group is not None else 1
    my = group.index if group is not None else 0
    tri = torch.ones((T, T), dtype=torch.bool, device=q.device).tril().repeat(rep, 1)
    rows = qf.shape[2]
    m = torch.full((B, hkv, rows, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, hkv, rows, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, hkv, rows, D), dtype=torch.float32, device=q.device)
    k_cur, v_cur, valid_cur = k, v, valid
    for step in range(n):
        src = (my - step) % n
        mask = _shard_mask(causal, src, my, valid_cur, tri)
        if mask is not None:
            s = torch.matmul(qf, k_cur.transpose(-1, -2)).float() * scale
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(m_new > NEG_INF / 2, torch.exp(s - m_new), torch.zeros_like(s))
            alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, v_cur.float())
            m = m_new
        if step < n - 1:
            k_cur, v_cur, valid_cur = _rotate([k_cur, v_cur, valid_cur], group)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = _unfold_q(acc / safe_l, rep).to(q.dtype)
    lse = torch.where(l > 0.0, m + torch.log(safe_l), torch.full_like(m, NEG_INF))[..., 0]
    return out, _unfold_q(lse, rep)


def _ring_bwd(q, k, v, valid, out, lse, g, group, causal, scale):
    B, H, T, D = q.shape
    hkv = k.shape[1]
    qf, rep = _fold_q(q.float(), hkv)
    n = group.size if group is not None else 1
    my = group.index if group is not None else 0
    tri = torch.ones((T, T), dtype=torch.bool, device=q.device).tril().repeat(rep, 1)
    g32 = _fold_q(g.float(), hkv)[0]
    out32 = _fold_q(out.float(), hkv)[0]
    lse_f = _fold_q(lse, hkv)[0][..., None]
    lse_safe = torch.where(lse_f > NEG_INF / 2, lse_f, torch.zeros_like(lse_f))
    delta = (g32 * out32).sum(dim=-1, keepdim=True)
    k_cur, v_cur, valid_cur = k, v, valid
    dk_cur = torch.zeros((B, hkv, T, D), dtype=torch.float32, device=q.device)
    dv_cur = torch.zeros_like(dk_cur)
    dq = torch.zeros_like(qf)
    for step in range(n):
        src = (my - step) % n
        mask = _shard_mask(causal, src, my, valid_cur, tri)
        if mask is not None:
            kf, vf = k_cur.float(), v_cur.float()
            s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
            p = torch.where(mask, torch.exp(s - lse_safe), torch.zeros_like(s))
            dv_cur = dv_cur + torch.matmul(p.transpose(-1, -2), g32)
            dp = torch.matmul(g32, vf.transpose(-1, -2))
            ds = p * (dp - delta) * scale
            dq = dq + torch.matmul(ds, kf)
            dk_cur = dk_cur + torch.matmul(ds.transpose(-1, -2), qf)
        if n > 1:
            if step < n - 1:
                k_cur, v_cur, valid_cur, dk_cur, dv_cur = _rotate([k_cur, v_cur, valid_cur, dk_cur, dv_cur], group)
            else:  # the last hop brings the accumulators home
                dk_cur, dv_cur = _rotate([dk_cur, dv_cur], group)
    return _unfold_q(dq, rep).to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid, group, causal, scale):
        out, lse = _ring_fwd(q, k, v, valid, group, causal, scale)
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, valid, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, valid, out, lse, g, ctx.group, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, causal: bool = True,
                   scale: Optional[float] = None, kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-parallel attention over ``group`` (an
    :class:`~trlx_tpu_torch.parallel.mesh.AxisGroup`; None or size 1: one
    rank, no rotation). ``q`` [B, H, T/n, D], ``k`` / ``v`` [B, Hkv, T/n, D]
    (Hkv dividing H), this rank's sequence shard with every head;
    ``kv_valid`` [B, T/n] masks padding keys (it rides the ring). Returns
    the output [B, H, T/n, D], sharded like ``q``. Differentiable with O(T/n)
    saved tensors."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kv_valid is None:
        kv_valid = torch.ones(q.shape[0], k.shape[2], dtype=torch.int32, device=q.device)
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), kv_valid.to(torch.int32).contiguous(),
                       group, bool(causal), float(scale))
