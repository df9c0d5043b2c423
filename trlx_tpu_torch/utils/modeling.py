"""Model/numeric helpers: logprobs, masked statistics, whitening, running
moments, dict flattening (counterpart of ``trlx_tpu/utils/modeling.py``).

Under a batch group (:func:`~trlx_tpu_torch.parallel.collectives.batch_group`,
set by the train step over ``data × fsdp``) ``masked_mean``, ``masked_var``
and ``whiten`` reduce numerator and denominator over the group's ranks, as
the JAX step's statistics cover the global microbatch; with none they are
the one-device functions.
"""

from typing import Any, Dict, MutableMapping, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.parallel.collectives import batch_count, batch_sum, current_batch_group


def logprobs_of_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log-probabilities of ``labels`` under ``logits``: log softmax in f32 +
    gather. Shapes: logits [..., T, V], labels [..., T] -> [..., T] f32.
    Logits arrive in the compute dtype (bf16 on the card); the vocab-wide
    logsumexp must not accumulate in a 7-bit mantissa, so upcast first."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logprobs, -1, labels[..., None].long())[..., 0]


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None) -> torch.Tensor:
    """Mean of ``x`` over positions where ``mask`` is 1."""
    mask = mask.to(x.dtype)
    if axis is None:
        return batch_sum((x * mask).sum()) / torch.clamp(batch_sum(mask.sum()), min=1e-8)
    return (x * mask).sum(dim=axis) / torch.clamp(mask.sum(dim=axis), min=1e-8)


def masked_var(x: torch.Tensor, mask: torch.Tensor, mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked (biased) variance about ``mean`` (the masked mean by default)."""
    if mean is None:
        mean = masked_mean(x, mask)
    return masked_mean((x - mean) ** 2, mask)


def whiten(xs: torch.Tensor, shift_mean: bool = True, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whiten to zero mean / unit variance over the whole batch (masked
    positions excluded when ``mask`` is given; biased variance either way,
    as ``jnp.var``)."""
    if mask is not None:
        mean = masked_mean(xs, mask)
        var = masked_var(xs, mask, mean)
    elif current_batch_group() is not None:
        n = batch_count(xs.numel())
        mean = batch_sum(xs.sum()) / n
        var = batch_sum(((xs - mean) ** 2).sum()) / n
    else:
        mean, var = xs.mean(), xs.var(unbiased=False)
    whitened = (xs - mean) * torch.rsqrt(var + 1e-8)
    if not shift_mean:
        whitened = whitened + mean
    return whitened


class RunningMoments:
    """Streaming mean/std of reward batches with Welford-style merging, on
    the host in float64 (the JAX package's class, unchanged)."""

    def __init__(self):
        self.mean = 0.0
        self.std = 1.0
        self.var = 1.0
        self.count = 1e-24

    def update(self, xs) -> Tuple[float, float]:
        """Update from a batch; returns (batch mean, batch std)."""
        if isinstance(xs, torch.Tensor):
            xs = xs.detach().cpu().numpy()
        xs = np.asarray(xs, dtype=np.float64).reshape(-1)
        xs_count = xs.size
        xs_mean = float(xs.mean())
        xs_var = float(xs.var())

        delta = xs_mean - self.mean
        tot_count = self.count + xs_count
        new_sum = xs_var * xs_count
        old_sum = self.var * self.count + delta**2 * self.count * xs_count / tot_count
        tot_sum = old_sum + new_sum

        self.mean += delta * xs_count / tot_count
        self.var = tot_sum / tot_count
        self.std = float(np.sqrt(self.var * tot_count / max(tot_count - 1, 1)))
        self.count = tot_count
        return xs_mean, float(np.sqrt(xs_var * xs_count / max(xs_count - 1, 1)))


def flatten_dict(d: MutableMapping, parent_key: str = "", sep: str = "/") -> Dict[str, Any]:
    """Flatten a nested dict with ``/``-joined keys."""
    items = []
    for k, v in d.items():
        new_key = parent_key + sep + str(k) if parent_key else str(k)
        if isinstance(v, MutableMapping):
            items.extend(flatten_dict(v, new_key, sep).items())
        else:
            items.append((new_key, v))
    return dict(items)
