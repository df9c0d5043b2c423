"""8-bit optimizer states: AdamW with blockwise-quantized moments, the
counterpart of ``trlx_tpu/ops/quantized_adam.py`` (the reference's
bitsandbytes 8-bit optimizers) as a ``torch.optim.Optimizer``.

Each parameter's moments live in blocks of :data:`BLOCK` elements (the
flattened tensor, zero-padded):

- ``m_q`` int8 ``[nb, 256]`` with ``m_scale`` f32 ``[nb]``: the first moment,
  symmetric linear codes against the block's absmax;
- ``v_q`` uint8 ``[nb, 256]`` with ``v_scale`` f32 ``[nb, 2]`` = ``(log_min,
  log_range)``: the second moment in log-space codes 1..255 over the
  block's positive range, code 0 reserved for exact zero.

A step dequantizes, does the Adam math in f32 (bias correction from the
step count, decoupled decay added to the step before ``-lr``), and
requantizes: ~2.05 bytes of state per element against AdamW's 8. The step
count is one int32 per parameter group (``group["count"]``, the optax
state's ``count``). The formulas are the JAX module's, line for line; torch
and XLA both round half to even, but their f32 ``log`` / ``exp`` may differ
by an ulp, so a code can differ by one at a boundary.

On a mesh the optimizer is given each leaf's master: this rank's fsdp
shard (:class:`~trlx_tpu_torch.parallel.fsdp.ShardedParams`), so the blocks
tile the local shard and never straddle ranks, as the JAX module's do
inside the overlapped step's ``shard_map``.

Plain tensor ops on both devices: the JAX module is XLA code, not a Pallas
kernel. A fused kernel is later speed work.
"""

from typing import Iterable, Tuple

import torch
import torch.nn.functional as F

BLOCK = 256

#: the dtype each state entry keeps (a checkpoint load casts state to the
#: parameter's dtype; :meth:`AdamW8bit.load_state_dict` casts back)
STATE_DTYPES = {"m_q": torch.int8, "m_scale": torch.float32, "v_q": torch.uint8, "v_scale": torch.float32}


def _blocked(x: torch.Tensor) -> torch.Tensor:
    """Flatten to ``[n_blocks, BLOCK]`` (zero-padded)."""
    flat = x.reshape(-1)
    pad = -flat.numel() % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def _unblocked(xb: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return xb.reshape(-1)[:n].reshape(shape)


def quant_signed(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and one f32 absmax per block."""
    xb = _blocked(x.float())
    scale = xb.abs().amax(dim=1)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xb / safe[:, None] * 127.0), -127, 127).to(torch.int8)
    return q, scale


def dequant_signed(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    return _unblocked(q.float() * (safe[:, None] / 127.0), shape)


def quant_pos(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-space codes for the non-negative second moment: code 0 is exact
    zero, codes 1..255 span ``[log vmin, log vmax]`` of the block (bounded
    multiplicative error, where linear codes would starve a block's small
    entries). Side info ``[nb, 2]`` f32: ``(log_min, log_range)``."""
    xb = _blocked(x.float())
    pos = xb > 0.0
    logs = torch.log(torch.where(pos, xb, torch.ones_like(xb)))
    inf = torch.full_like(logs, float("inf"))
    lmin = torch.where(pos, logs, inf).amin(dim=1)
    lmax = torch.where(pos, logs, -inf).amax(dim=1)
    has_pos = torch.isfinite(lmin)
    lmin = torch.where(has_pos, lmin, torch.zeros_like(lmin))
    lrange = torch.where(has_pos, torch.clamp(lmax - lmin, min=1e-12), torch.ones_like(lmin))
    q = 1 + torch.round((logs - lmin[:, None]) / lrange[:, None] * 254.0)
    q = torch.where(pos, torch.clamp(q, 1, 255), torch.zeros_like(q)).to(torch.uint8)
    return q, torch.stack([lmin, lrange], dim=1)


def dequant_pos(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    lmin, lrange = scale[:, 0], scale[:, 1]
    vals = torch.exp(lmin[:, None] + (q.float() - 1.0) / 254.0 * lrange[:, None])
    return _unblocked(torch.where(q == 0, torch.zeros_like(vals), vals), shape)


class AdamW8bit(torch.optim.Optimizer):
    """``adamw_8bit(lr, b1, b2, eps, weight_decay)`` of the JAX package: per
    parameter ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2`` on the
    dequantized moments, ``step = m / bc1 / (sqrt(v / bc2) + eps) + wd * p``,
    ``p += -lr * step``, then the moments requantized. It reads its rate
    from ``group["lr"]`` at every step (the port's schedulers set it). A
    trained parameter without a gradient steps with a zero gradient, as
    optax updates every leaf of its partition."""

    def __init__(self, params: Iterable, lr: float, betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        for group in self.param_groups:
            group["count"] = torch.zeros((), dtype=torch.int32)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, (b1, b2), eps, wd = group["lr"], group["betas"], group["eps"], group["weight_decay"]
            # a new tensor, never an in-place add: a host snapshot of the
            # state keeps the count it was taken at
            group["count"] = count = group["count"] + 1
            for p in group["params"]:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                state = self.state[p]
                if not state:
                    nb = -(-p.numel() // BLOCK)
                    state.update(
                        m_q=torch.zeros((nb, BLOCK), dtype=torch.int8, device=p.device),
                        m_scale=torch.zeros((nb,), dtype=torch.float32, device=p.device),
                        v_q=torch.zeros((nb, BLOCK), dtype=torch.uint8, device=p.device),
                        v_scale=torch.zeros((nb, 2), dtype=torch.float32, device=p.device),
                    )
                n = count.to(device=p.device, dtype=torch.float32)
                bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=p.device) ** n
                bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=p.device) ** n
                g32 = g.float()
                m = b1 * dequant_signed(state["m_q"], state["m_scale"], g.shape) + (1 - b1) * g32
                v = b2 * dequant_pos(state["v_q"], state["v_scale"], g.shape) + (1 - b2) * g32 * g32
                upd = m / bc1 / (torch.sqrt(v / bc2) + eps)
                if wd:
                    upd = upd + wd * p.float()
                state["m_q"], state["m_scale"] = quant_signed(m)
                state["v_q"], state["v_scale"] = quant_pos(v)
                p.add_((-lr * upd).to(p.dtype))

    def load_state_dict(self, state_dict):
        """``torch.optim``'s load casts every state tensor to its
        parameter's dtype: the codes are cast back (exactly: int8 and uint8
        values are exact in any float type)."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            for key, dtype in STATE_DTYPES.items():
                if key in state:
                    state[key] = state[key].to(dtype)


def adam_8bit(params: Iterable, lr: float, betas: Tuple[float, float] = (0.9, 0.999),
              eps: float = 1e-8) -> AdamW8bit:
    """The JAX package's ``adam_8bit``: :class:`AdamW8bit` without decay."""
    return AdamW8bit(params, lr=lr, betas=betas, eps=eps, weight_decay=0.0)
