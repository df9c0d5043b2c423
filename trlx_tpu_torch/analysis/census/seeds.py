"""Seeded census regressions: prove the gate fails closed.

The counterpart of the reference's ``TRLX_IR_SEED_REGRESSION`` and
``TRLX_RT_SEED_REGRESSION``. When ``TRLX_CENSUS_SEED_REGRESSION`` names a
seed, the factories inject the defect into the built step (the source stays
as it is) and ``python -m trlx_tpu_torch.analysis.census`` must exit 1:

``f32_upcast``
    ``decode_step``'s step function runs its logits through an f32 copy of
    the embedding: a heavy op in f32 inside a bf16 step (IR001's class).
``extra_item``
    ``decode_step``'s step function reads a logit on the host every decode
    iteration: one more host round-trip per token (IR004's class).
``shape_churn``
    ``stream_score_bucket`` scores at the raw completion lengths instead of
    the streaming ladder's: steady state brings shapes the warmup never
    dispatched (the reference's ``shape_churn``).
``allreduce_under_fsdp``
    ``ppo_train_step_overlap``'s per-leaf gradient reduce-scatter over
    ``fsdp`` becomes a full-gradient all-reduce over ``fsdp`` and a local
    slice: ``reduce-scatter:fsdp`` goes, ``all-reduce:fsdp`` comes (the
    reference's seed of the same name, ``trlx_tpu/parallel/fsdp.py:296``).
``allgather``
    ``ppo_train_step`` on :data:`~trlx_tpu_torch.analysis.census.
    entrypoints.DEFAULT_AUDIT_MESH` (``@cpu:mesh``) gathers the policy's
    logits whole over the batch ranks inside the loss (and keeps its own
    rows): an all-gather over ``data+fsdp`` the budget lacks (the
    reference's ``allgather``, ``trlx_tpu/methods/ppo.py:324``).

``budget.write`` refuses to regenerate while a seed is active.
"""

import os
from typing import Optional

ENV_VAR = "TRLX_CENSUS_SEED_REGRESSION"

SEEDS = ("f32_upcast", "extra_item", "shape_churn", "allreduce_under_fsdp", "allgather")


def active() -> Optional[str]:
    """The active seed name, validated; None when unset."""
    seed = os.environ.get(ENV_VAR)
    if not seed:
        return None
    if seed not in SEEDS:
        raise ValueError(f"unknown {ENV_VAR} seed {seed!r}; known: {', '.join(SEEDS)}")
    return seed

