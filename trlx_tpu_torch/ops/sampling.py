"""Token sampling: greedy, temperature, top-k and top-p (counterpart of
``trlx_tpu/ops/sampling.py``).

Randomness comes from a caller-owned ``torch.Generator``; sampled streams
therefore never match the JAX package's bits, only its distributions.
Greedy decoding is ``argmax`` with first-index tie-breaking in both
frameworks, so greedy streams do match.

Top-k selection is always exact (``torch.topk``): the JAX package's default
``approx_max_k`` is a TPU-specific binned selection with no GPU counterpart,
so ``top_k_impl="approx"`` is accepted and runs the exact selection.
"""

import torch

NEG_INF = -1e9


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / max(temperature, 1e-6)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit. k<=0 disables."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _nucleus_keep(sorted_vals: torch.Tensor, p: float) -> torch.Tensor:
    """Boolean keep-mask over descending-sorted logits: the smallest prefix
    whose cumulative softmax mass reaches ``p`` (top-1 always kept)."""
    cum = torch.cumsum(torch.softmax(sorted_vals, dim=-1), dim=-1)
    return torch.cat(
        [torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < p], dim=-1
    )


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens with cumulative
    prob >= p (the top-1 always). p>=1 disables."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    keep = _nucleus_keep(sorted_logits, p)
    inf = torch.full_like(sorted_logits, float("inf"))
    cutoff = torch.where(keep, sorted_logits, inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)


def _categorical(generator: torch.Generator, logits: torch.Tensor, rows=None) -> torch.Tensor:
    """One draw per row. ``rows = (offset, total)`` marks ``logits`` as rows
    ``[offset, offset + B)`` of a ``total``-row batch: the draw is made over
    all ``total`` rows (the others uniform) and this slice kept, so every
    rank of a mesh consumes the same stream and samples what one rank would
    for those rows (``multinomial`` draws one exponential per element)."""
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    if rows is not None:
        offset, total = rows
        full = torch.ones((total, flat.shape[-1]), dtype=flat.dtype, device=flat.device)
        full[offset:offset + flat.shape[0]] = flat
        choice = torch.multinomial(full, 1, generator=generator)[offset:offset + flat.shape[0], 0]
    else:
        choice = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return choice.reshape(probs.shape[:-1])


def sample_token(
    generator: torch.Generator,
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    do_sample: bool = True,
    top_k_impl: str = "exact",
    rows=None,
) -> torch.Tensor:
    """Sample (or argmax) next tokens from [..., V] logits -> [...] int32.

    With ``0 < top_k < V`` the top-k / top-p / categorical pipeline runs in
    the k-candidate space: select (values, indices), nucleus-mask the sorted
    values, draw over k, gather the token id. ``top_k_impl`` is accepted for
    the JAX signature; selection is exact either way (module docstring).
    ``rows`` places a rank's rows in the global batch (:func:`_categorical`)."""
    if top_k_impl not in ("approx", "exact"):
        raise ValueError(f"unknown top_k_impl {top_k_impl!r}")
    if not do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = apply_temperature(logits.float(), temperature)
    if 0 < top_k < logits.shape[-1]:
        vals, idx = torch.topk(logits, top_k, dim=-1)
        if top_p < 1.0:
            vals = torch.where(_nucleus_keep(vals, top_p), vals, torch.full_like(vals, NEG_INF))
        choice = _categorical(generator, vals, rows)
        return torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)
    return _categorical(generator, apply_top_p(logits, top_p), rows).to(torch.int32)


def count_accepted_drafts(sampled: torch.Tensor, proposed: torch.Tensor) -> torch.Tensor:
    """Leading-match accept count for speculative verify: ``proposed`` ``[B,
    K+1]`` is what the verify pass scored (the pending token, then K drafts),
    ``sampled`` ``[B, K+1]`` the model's output at each position. Draft j+1
    is accepted iff it equals ``sampled[:, j]`` and every earlier draft was
    accepted: the length of the leading run of ``proposed[:, 1:] ==
    sampled[:, :K]``, in ``[0, K]``, int32."""
    K = proposed.shape[1] - 1
    if K == 0:
        return torch.zeros((proposed.shape[0],), dtype=torch.int32, device=proposed.device)
    match = (proposed[:, 1:] == sampled[:, :K]).to(torch.int32)
    return torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
