"""The optimizers the JAX package builds from optax beside AdamW: ``sgd``,
``lion``, ``adafactor`` and ``rmsprop``, each a ``torch.optim.Optimizer``
written to optax 0.2.6's formulas (``optax/_src/alias.py``,
``transform.py``, ``factorized.py``), since ``torch.optim`` has no Lion and
its SGD, Adafactor and RMSprop differ from optax's in order, defaults or
where eps sits.

Each reads its learning rate from ``group["lr"]`` at every step, so the
port's schedulers (``make_lr_scheduler``: a base rate of 1 and the schedule
written into the group) drive it exactly as they drive AdamW. A trained
parameter without a gradient steps with a zero gradient, as optax updates
every leaf of its partition: decay still applies and moments still advance.

State per parameter (f32 like the parameter), which ``state_bytes``
reports: SGD one momentum trace (none at momentum 0), Lion one moment,
RMSprop one second moment (plus the first moment when centered and a trace
with momentum), Adafactor a row and a column factor for a tensor whose two
largest dimensions are both at least ``min_dim_size_to_factor`` and a full
second moment otherwise (plus a momentum when set).
"""

from typing import Iterable, Optional, Tuple

import numpy as np
import torch


def _grad(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p) if p.grad is None else p.grad


def state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of every tensor in the optimizer's per-parameter state, and of
    any tensor its parameter groups hold (the 8-bit AdamW's step count)."""
    per_param = sum(v.numel() * v.element_size() for s in optimizer.state.values() for v in s.values()
                    if isinstance(v, torch.Tensor))
    return per_param + sum(v.numel() * v.element_size() for g in optimizer.param_groups for k, v in g.items()
                           if k != "params" and isinstance(v, torch.Tensor))


class SGD(torch.optim.Optimizer):
    """``optax.chain(add_decayed_weights(wd), sgd(lr, momentum or None,
    nesterov))``: ``u = g + wd * p``; with momentum the trace ``t = u + m *
    t`` (zeros at first, no dampening) replaces ``u`` (nesterov: ``u + m *
    t``); then ``p -= lr * u``."""

    def __init__(self, params: Iterable, lr: float, momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, m, wd = group["lr"], group["momentum"], group["weight_decay"]
            for p in group["params"]:
                u = _grad(p)
                if wd:
                    u = u + wd * p
                if m:
                    state = self.state[p]
                    if "trace" not in state:
                        state["trace"] = torch.zeros_like(p)
                    trace = state["trace"]
                    trace.copy_(u + m * trace)
                    u = u + m * trace if group["nesterov"] else trace
                p.add_(-lr * u)


class Lion(torch.optim.Optimizer):
    """``optax.lion(lr, b1, b2, weight_decay)``: ``u = sign((1 - b1) * g +
    b1 * mu)``, then ``mu = (1 - b2) * g + b2 * mu``, then ``p -= lr * (u +
    wd * p)``."""

    def __init__(self, params: Iterable, lr: float, betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, (b1, b2), wd = group["lr"], group["betas"], group["weight_decay"]
            for p in group["params"]:
                g = _grad(p)
                state = self.state[p]
                if "mu" not in state:
                    state["mu"] = torch.zeros_like(p)
                mu = state["mu"]
                u = torch.sign((1.0 - b1) * g + b1 * mu)
                mu.copy_((1.0 - b2) * g + b2 * mu)
                if wd:
                    u = u + wd * p
                p.add_(-lr * u)


def factored_dims(shape, factored: bool, min_dim_size_to_factor: int) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (d1, d0), the second-largest and the
    largest dimension, when both are at least ``min_dim_size_to_factor``;
    else None (numpy's argsort, so ties resolve as optax resolves them)."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr, ...)`` with optax's defaults: the factored RMS
    scaling (``decay_rate_t = 1 - (step + 1) ** -decay_rate`` in f32, eps
    added to ``g**2``), block-RMS clipping of the update at
    ``clipping_threshold``, the learning rate, the update times the
    parameter's RMS (floor 1e-3), an optional momentum (an EMA without
    debiasing), optional decayed weights, then ``p -= u``.

    A parameter in :attr:`layouts` is a block of a larger leaf (a mesh's
    shard: :class:`~trlx_tpu_torch.parallel.fsdp.WholeLeafOptimizer`): it
    is factored by the whole leaf's ``shape``, and each mean is its block's
    partial sum completed by the layout's ``sum(x, dim)`` over the ranks
    holding the leaf's other blocks along ``dim`` (every dim when None),
    divided by the whole leaf's count."""

    def __init__(self, params: Iterable, lr: float, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, decay_offset: int = 0, multiply_by_parameter_scale: bool = True,
                 clipping_threshold: Optional[float] = 1.0, momentum: Optional[float] = None,
                 weight_decay_rate: Optional[float] = None, eps: float = 1e-30, factored: bool = True):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor, decay_rate=decay_rate,
            decay_offset=decay_offset, multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum, weight_decay_rate=weight_decay_rate,
            eps=eps, factored=factored))
        #: {parameter: layout} of the parameters held as blocks of a larger leaf
        self.layouts = {}

    def _mean(self, p: torch.Tensor, x: torch.Tensor, dim=None, leaf_dim=None, keepdim=False) -> torch.Tensor:
        """The mean of ``x`` over its ``dim`` (every dim when None), which
        is ``p``'s dim ``leaf_dim``: over the whole leaf where ``p`` is a block."""
        layout = self.layouts.get(p)
        if layout is None:
            return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
        part = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
        return layout.sum(part, leaf_dim) / (int(np.prod(layout.shape)) if leaf_dim is None else layout.shape[leaf_dim])

    @staticmethod
    def _init_state(p: torch.Tensor, dims) -> dict:
        state = {"step": 0}
        if dims is not None:
            d1, d0 = dims
            state["v_row"] = torch.zeros(tuple(s for i, s in enumerate(p.shape) if i != d0), dtype=p.dtype,
                                         device=p.device)
            state["v_col"] = torch.zeros(tuple(s for i, s in enumerate(p.shape) if i != d1), dtype=p.dtype,
                                         device=p.device)
        else:
            state["v"] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                g = _grad(p)
                layout = self.layouts.get(p)
                shape = layout.shape if layout is not None else tuple(p.shape)
                dims = factored_dims(shape, group["factored"], group["min_dim_size_to_factor"])
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p, dims))
                    if group["momentum"] is not None:
                        state["ema"] = torch.zeros_like(p)
                t = np.float32(state["step"] - group["decay_offset"] + 1)
                decay = float(np.float32(1.0) - t ** np.float32(-group["decay_rate"]))
                state["step"] += 1
                grad_sqr = g * g + group["eps"]
                if dims is not None:
                    d1, d0 = dims
                    v_row, v_col = state["v_row"], state["v_col"]
                    v_row.copy_(decay * v_row + (1.0 - decay) * self._mean(p, grad_sqr, d0, d0))
                    v_col.copy_(decay * v_col + (1.0 - decay) * self._mean(p, grad_sqr, d1, d1))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / self._mean(p, v_row, reduced_d1, d1, keepdim=True)) ** -0.5
                    col_factor = v_col ** -0.5
                    u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                else:
                    v = state["v"]
                    v.copy_(decay * v + (1.0 - decay) * grad_sqr)
                    u = g * v ** -0.5
                if group["clipping_threshold"] is not None:
                    u = u / torch.clamp(torch.sqrt(self._mean(p, u * u)) / group["clipping_threshold"], min=1.0)
                u = u * group["lr"]
                if group["multiply_by_parameter_scale"]:
                    rms = torch.sqrt(self._mean(p, p * p))
                    u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
                if group["momentum"] is not None:
                    ema = state["ema"]
                    ema.copy_((1.0 - group["momentum"]) * u + group["momentum"] * ema)
                    u = ema
                if group["weight_decay_rate"] is not None:
                    u = u + group["weight_decay_rate"] * p
                p.sub_(u)


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, ...)`` with optax's defaults: ``nu = (1 - decay)
    * g**2 + decay * nu`` from ``initial_scale``, the update ``g *
    rsqrt(nu + eps)`` (eps inside the root; ``eps_in_sqrt=False`` puts it
    outside), optional bias correction and centering, then ``-lr`` times
    it, then an optional momentum trace over that."""

    def __init__(self, params: Iterable, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, eps_in_sqrt: bool = True, centered: bool = False,
                 momentum: Optional[float] = None, nesterov: bool = False, bias_correction: bool = False):
        super().__init__(params, dict(
            lr=lr, decay=decay, eps=eps, initial_scale=initial_scale, eps_in_sqrt=eps_in_sqrt, centered=centered,
            momentum=momentum, nesterov=nesterov, bias_correction=bias_correction))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, eps = group["decay"], group["eps"]
            for p in group["params"]:
                g = _grad(p)
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["nu"] = torch.full_like(p, group["initial_scale"])
                    if group["centered"]:
                        state["mu"] = torch.zeros_like(p)
                    if group["momentum"] is not None:
                        state["trace"] = torch.zeros_like(p)
                state["step"] += 1
                nu = state["nu"]
                nu.copy_((1.0 - decay) * (g * g) + decay * nu)
                nu_hat = nu
                if group["bias_correction"]:
                    nu_hat = nu / (1.0 - decay ** state["step"])
                if group["centered"]:
                    mu = state["mu"]
                    mu.copy_((1.0 - decay) * g + decay * mu)
                    mu_hat = mu / (1.0 - decay ** state["step"]) if group["bias_correction"] else mu
                    nu_hat = nu_hat - mu_hat * mu_hat
                if group["eps_in_sqrt"]:
                    u = torch.rsqrt(nu_hat + eps) * g
                else:
                    u = g / (torch.sqrt(nu_hat) + eps)
                u = -group["lr"] * u
                if group["momentum"] is not None:
                    trace = state["trace"]
                    trace.copy_(u + group["momentum"] * trace)
                    u = u + group["momentum"] * trace if group["nesterov"] else trace
                p.add_(u)
