"""Host utilities: seeding, timers, loaders, and the optimizer / scheduler
registries (counterpart of ``trlx_tpu/utils/__init__.py``), plus logging and
runtime gauges in the submodules.

Optimizers resolve to ``torch.optim``; schedules are plain functions of the
optimizer step count that reproduce optax's formulas, applied through
``LambdaLR`` over a base learning rate of 1 (:func:`make_lr_scheduler`), so
the rate at step k is exactly the JAX schedule's value at k.
"""

import math
import random
import time
from enum import Enum
from numbers import Number
from typing import Any, Callable, Dict, Iterable, Iterator

import numpy as np
import torch


def set_seed(seed: int) -> np.random.Generator:
    """Seed python, numpy and torch RNGs and return a numpy Generator for
    host-side sampling (no per-process offset, as the JAX package)."""
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return np.random.default_rng(seed)


def significant(x: Any, ndigits: int = 3) -> Any:
    """Round a number to ``ndigits`` significant figures (for stat logging)."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        x = float(x)
    if not isinstance(x, Number) or x == 0 or not math.isfinite(x):
        return x
    return round(x, ndigits - int(math.floor(math.log10(abs(x)))) - 1)


def filter_non_scalars(xs: Dict) -> Dict:
    """Keep only numeric leaves of a flat stats dict (for tracker logging)."""
    ys = {}
    for k, v in xs.items():
        try:
            ys[k] = float(v)
        except (TypeError, ValueError):
            continue
    return ys


class Clock:
    """Wall-clock timer: ``tick`` returns the seconds since the last tick."""

    def __init__(self):
        self.start = time.time()

    def tick(self) -> float:
        end = time.time()
        delta = end - self.start
        self.start = end
        return delta


def infinite_loader(loader: Iterable) -> Iterator:
    """Cycle a (re-iterable) dataloader forever."""
    while True:
        yield from loader


# ----------------------------- optimizers ------------------------------------


class OptimizerName(str, Enum):
    """Optimizer names of the JAX package's registry."""

    ADAM = "adam"
    ADAMW = "adamw"
    ADAM_8BIT = "adam_8bit_bnb"
    ADAMW_8BIT = "adamw_8bit_bnb"
    SGD = "sgd"
    LION = "lion"
    ADAFACTOR = "adafactor"
    RMSPROP = "rmsprop"


def get_optimizer_class(name) -> Callable:
    """Resolve an optimizer registry name to a constructor
    ``make(params, learning_rate, **kwargs) -> torch.optim.Optimizer``.

    ``adamw`` is ``torch.optim.AdamW``, the same update as optax's ``adamw``
    (bias-corrected moments, eps outside the root, decoupled decay applied
    to every trained parameter) with the JAX package's default
    ``weight_decay=0``; ``adam`` is ``torch.optim.Adam`` (no decay). The
    others raise, naming the slice that brings them.
    """
    name = OptimizerName(name.lower() if isinstance(name, str) else name)

    if name == OptimizerName.ADAMW:

        def make_adamw(params, learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
            return torch.optim.AdamW(
                params, lr=learning_rate, betas=tuple(betas), eps=eps, weight_decay=weight_decay
            )

        return make_adamw
    if name == OptimizerName.ADAM:

        def make_adam(params, learning_rate, betas=(0.9, 0.999), eps=1e-8, **kw):
            kw.pop("weight_decay", None)
            if kw:
                raise TypeError(f"adam: unexpected kwargs {sorted(kw)}")
            return torch.optim.Adam(params, lr=learning_rate, betas=tuple(betas), eps=eps)

        return make_adam
    if name in (OptimizerName.ADAM_8BIT, OptimizerName.ADAMW_8BIT):
        raise NotImplementedError(
            f"trlx_tpu_torch does not port optimizer {name.value!r} yet: int8 optimizer-state slice"
        )
    raise NotImplementedError(
        f"trlx_tpu_torch does not port optimizer {name.value!r} yet: optimizers slice"
    )


# ----------------------------- schedulers ------------------------------------


class SchedulerName(str, Enum):
    COSINE_ANNEALING = "cosine_annealing"
    LINEAR = "linear"
    CONSTANT = "constant"
    COSINE_WARMUP = "cosine_warmup"


def _linear(init_value: float, end_value: float, transition_steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _cosine(init_value: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule (exponent 1): the cosine holds at its end
    value past ``decay_steps``, unlike torch's periodic CosineAnnealingLR."""

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def get_scheduler_class(name) -> Callable:
    """Resolve a scheduler registry name to a constructor of a schedule
    ``step -> learning rate`` with the JAX package's hyperparameters
    (``T_max``/``eta_min`` for cosine) and optax's formulas."""
    name = SchedulerName(name.lower() if isinstance(name, str) else name)
    if name == SchedulerName.COSINE_ANNEALING:

        def make_cosine(learning_rate, T_max, eta_min=0.0, **_):
            alpha = eta_min / learning_rate if learning_rate else 0.0
            return _cosine(learning_rate, max(int(T_max), 1), alpha)

        return make_cosine
    if name == SchedulerName.LINEAR:

        def make_linear(learning_rate, total_steps, end_value=0.0, **_):
            return _linear(learning_rate, end_value, max(int(total_steps), 1))

        return make_linear
    if name == SchedulerName.CONSTANT:
        return lambda learning_rate, **_: (lambda count: learning_rate)
    if name == SchedulerName.COSINE_WARMUP:

        def make_warmup(learning_rate, warmup_steps, total_steps, eta_min=0.0, **_):
            # optax.warmup_cosine_decay_schedule(0, learning_rate, ...): a linear
            # warmup joined at warmup_steps to a cosine over the remaining steps
            warmup_steps = int(warmup_steps)
            decay_steps = max(int(total_steps), 1) - warmup_steps
            if decay_steps <= 0:
                # optax refuses the schedule when it is built, not mid-run
                raise ValueError(
                    f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}."
                )
            alpha = 0.0 if learning_rate == 0.0 else eta_min / learning_rate
            warm = _linear(0.0, learning_rate, warmup_steps) if warmup_steps > 0 else None
            cos = _cosine(learning_rate, decay_steps, alpha)
            return lambda count: warm(count) if count < warmup_steps else cos(count - warmup_steps)

        return make_warmup
    raise ValueError(f"Unknown scheduler {name}")


def make_lr_scheduler(optimizer: torch.optim.Optimizer, schedule: Callable[[int], float]):
    """``LambdaLR`` that sets every group's rate to ``schedule(step)``, where
    step counts the optimizer steps taken so far (the optax count before the
    update). The optimizer must be built with a base rate of 1."""
    for group in optimizer.param_groups:
        if group["lr"] != 1.0:
            raise ValueError("make_lr_scheduler needs an optimizer built with lr=1.0")
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: float(schedule(step)))
