"""PPO rollout datatypes (counterpart of ``trlx_tpu/data/ppo_types.py``):
plain dataclasses of host numpy arrays. The JAX package makes them
``flax.struct`` pytrees so batches flow through ``jit``; the port moves a
batch to its device field by field (:meth:`PPORLBatch.to`)."""

from dataclasses import dataclass, fields, replace
from typing import Any


@dataclass
class PPORLElement:
    """One rollout: query (prompt) tokens, response tokens, and per-response-token
    logprobs / values / rewards (KL-penalized, score at last token).
    ``policy_version`` tags the parameter snapshot that sampled it (0 on the
    synchronous path)."""

    query_tensor: Any  # [P]
    response_tensor: Any  # [R]
    logprobs: Any  # [R]
    values: Any  # [R]
    rewards: Any  # [R]
    policy_version: Any = 0  # scalar int

    def replace(self, **kw) -> "PPORLElement":
        return replace(self, **kw)


@dataclass
class PPORLBatch:
    """Collated rollouts: queries left-padded, responses right-padded.
    ``policy_version`` carries the per-sample sampling version from collate;
    ``staleness`` (learner_version - policy_version, [B] int32) is filled in
    by the trainer right before the train step when staleness correction is
    on (the learner keeps publishing while collated batches wait)."""

    query_tensors: Any  # [B, P]
    response_tensors: Any  # [B, R]
    logprobs: Any  # [B, R]
    values: Any  # [B, R]
    rewards: Any  # [B, R]
    attention_mask: Any  # [B, P] mask for queries
    response_mask: Any  # [B, R] mask for responses
    policy_version: Any = None  # [B] int32
    staleness: Any = None  # [B] int32

    def replace(self, **kw) -> "PPORLBatch":
        return replace(self, **kw)

    def to(self, device) -> "PPORLBatch":
        """The batch as torch tensors on ``device`` (None fields stay None)."""
        import torch

        return PPORLBatch(**{
            f.name: None if getattr(self, f.name) is None
            else torch.as_tensor(getattr(self, f.name)).to(device)
            for f in fields(self)
        })

    def split(self, n: int):
        """``n`` equal microbatches along the batch dim (the JAX step's reshape)."""
        B = len(self.query_tensors)
        if B % n:
            raise ValueError(f"batch of {B} does not split into {n} microbatches")
        m = B // n
        return [
            PPORLBatch(**{
                f.name: None if getattr(self, f.name) is None else getattr(self, f.name)[i * m:(i + 1) * m]
                for f in fields(self)
            })
            for i in range(n)
        ]
