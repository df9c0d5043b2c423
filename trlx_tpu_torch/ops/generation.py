"""Padded one-shot generation with a contiguous KV cache (counterpart of
``trlx_tpu/ops/generation.py``): the PPO trainer's default rollout path.

Prompts are left-padded to a bucketed length, the cache is preallocated at
``prompt_len + max_new_tokens``, prefill runs from cache slot 0 through the
flash kernel (``attention_impl="flash"``), and each decode step attends over
the contiguous cache on the plain path, as the JAX package's einsum does.
The loop exits early once every row has finished. Sampling goes through
:func:`trlx_tpu_torch.ops.sampling.sample_token` with a caller-owned
``torch.Generator``.

ILQL's advantage-shaped decoding plugs in as a ``logits_processor(hidden,
logits, prev_token) -> logits`` hook, evaluated on the last position's
hidden state after the prefill and after every decode step. Without it the
output is unchanged.

:func:`generate_seq2seq` is the encoder-decoder loop (T5): encode once,
cross-attention K/V once, then one decoder token a step over the decoder's
cache, on the plain attention path.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trlx_tpu_torch.analysis.census.entrypoints import Entry, register_entrypoint
from trlx_tpu_torch.native import pad_collate_i32
from trlx_tpu_torch.ops.sampling import sample_token
from trlx_tpu_torch.parallel.collectives import all_reduce

# step_fn(ids[B,T], mask[B,S], positions[B,T], cache) -> (logits[B,T',V],
# hidden[B,T',H], cache); T' may be 1 (the last position only)
StepFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, Any]]


def pad_to_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length; past the last bucket, the next multiple of 64."""
    for b in sorted(buckets):
        if b >= length:
            return b
    return int(np.ceil(length / 64) * 64)


def left_pad_batch(
    ids_list: List[np.ndarray], pad_token_id: int, target_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad a ragged list of prompt id arrays to ``[B, target_len]``:
    (int32 ids, int32 0/1 mask), through the host data plane. Rows longer
    than ``target_len`` keep their last ``target_len`` tokens."""
    return pad_collate_i32(ids_list, target_len, pad_token_id, pad_left=True)


@torch.no_grad()
def generate(
    step_fn: StepFn,
    init_cache_fn: Callable[[int, int], Any],
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    generator: Optional[torch.Generator],
    max_new_tokens: int,
    eos_token_id: Optional[int] = None,
    pad_token_id: int = 0,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    do_sample: bool = True,
    top_k_impl: str = "approx",
    min_new_tokens: int = 0,
    logits_processor: Optional[Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    rows: Optional[Tuple[int, int]] = None,
    sync_group=None,
) -> Dict[str, torch.Tensor]:
    """Generate continuations for left-padded prompts.

    Returns ``sequences`` [B, P+N] (prompt + generation, ``pad_token_id``
    after eos) and ``response_mask`` [B, N] (1 on generated tokens up to and
    including eos), as the JAX function. ``logits_processor(hidden [B, H],
    logits [B, V], prev_token [B])`` reshapes each step's logits before
    sampling (ILQL's advantage shaping).

    On a mesh: ``rows = (offset, total)`` places these rows in the global
    batch, so the draws are the global batch's (the same tokens on any rank
    count), and ``sync_group`` makes the early exit the whole group's (every
    rank steps until every rank's rows have finished, as the JAX loop stops
    on the global batch: under fsdp or model each step is a collective)."""
    B, P = input_ids.shape
    N = int(max_new_tokens)
    dev = input_ids.device
    prompt_lens = attention_mask.sum(dim=1).to(torch.int32)

    cache = init_cache_fn(B, P + N)
    cache["index"] = 0  # prefill from slot 0: the flash prefill path engages
    # mask over all cache slots; generated slots are enabled as they are written
    full_mask = torch.cat(
        [attention_mask.to(torch.int32), torch.zeros((B, N), dtype=torch.int32, device=dev)], dim=1
    )
    positions = (torch.cumsum(attention_mask, dim=1) - 1).clamp(min=0).to(torch.int32)
    logits, hidden, cache = step_fn(input_ids, full_mask, positions, cache)
    last_logits = logits[:, -1, :]
    if logits_processor is not None:
        last_logits = logits_processor(hidden[:, -1, :], last_logits, input_ids[:, -1])

    seqs = torch.cat(
        [input_ids.to(torch.int32), torch.full((B, N), pad_token_id, dtype=torch.int32, device=dev)], dim=1
    )
    vocab = torch.arange(last_logits.shape[-1], device=dev)

    def sample_step(step: int, logits: torch.Tensor, finished: torch.Tensor) -> torch.Tensor:
        if eos_token_id is not None and step < min_new_tokens:
            logits = torch.where((vocab == eos_token_id)[None, :], torch.full_like(logits, -1e9), logits)
        tok = sample_token(generator, logits, temperature, top_k, top_p, do_sample, top_k_impl, rows)
        return torch.where(finished, torch.full_like(tok, pad_token_id), tok)

    def all_finished(finished: torch.Tensor) -> torch.Tensor:
        done = finished.all()
        return done if sync_group is None else all_reduce(done.to(torch.int32), sync_group, "min")

    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    tok = sample_step(0, last_logits, finished)
    if eos_token_id is not None:
        finished = tok == eos_token_id
    seqs[:, P] = tok
    full_mask[:, P] = 1

    step = 1
    while step < N and not bool(all_finished(finished)):
        # `tok` sits at sequence slot P+step-1, per-sample position prompt_len+step-1
        pos = (prompt_lens + step - 1)[:, None]
        logits, hidden, cache = step_fn(tok[:, None], full_mask, pos, cache)
        step_logits = logits[:, -1, :]
        if logits_processor is not None:
            step_logits = logits_processor(hidden[:, -1, :], step_logits, tok)
        tok = sample_step(step, step_logits, finished)
        if eos_token_id is not None:
            finished = finished | (tok == eos_token_id)
        seqs[:, P + step] = tok
        full_mask[:, P + step] = 1
        step += 1

    response_mask = full_mask[:, P:]
    if eos_token_id is not None:
        # rebuild the mask from the tokens: nothing after a row's first eos,
        # and never the slots the early exit left unwritten
        resp = seqs[:, P:]
        is_eos = (resp == eos_token_id).to(torch.int32)
        after_eos = torch.cumsum(torch.nn.functional.pad(is_eos[:, :-1], (1, 0)), dim=1) > 0
        written = torch.arange(N, device=dev)[None, :] < step
        response_mask = response_mask * (~after_eos & written).to(torch.int32)
        seqs = torch.cat(
            [seqs[:, :P], torch.where(response_mask > 0, resp, torch.full_like(resp, pad_token_id))], dim=1
        )
    return {"sequences": seqs, "response_mask": response_mask}


@torch.no_grad()
def generate_seq2seq(
    encode_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    cross_kv_fn: Callable[[torch.Tensor], Any],
    decode_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor, Any]],
    init_cache_fn: Callable[[int, int], Any],
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    generator: Optional[torch.Generator],
    max_new_tokens: int,
    decoder_start_token_id: int = 0,
    eos_token_id: Optional[int] = None,
    pad_token_id: int = 0,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    do_sample: bool = True,
    top_k_impl: str = "approx",
    min_new_tokens: int = 0,
    logits_processor: Optional[Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    rows: Optional[Tuple[int, int]] = None,
    sync_group=None,
) -> Dict[str, torch.Tensor]:
    """Seq2seq generation: encode once, compute the cross-attention K/V once,
    then one decoder token a step over a preallocated self-attention cache,
    exiting early once every row has finished (the JAX ``while_loop``).
    ``rows`` and ``sync_group`` are :func:`generate`'s (a mesh's rows of
    the global batch, and the group whose rows all end the loop).

    ``decode_fn(tok [B, 1], enc, enc_mask, dec_mask [B, 1+N], positions,
    cache, cross_kvs) -> (logits, hidden, cache)``. Returns ``sequences``
    [B, 1+N] (the decoder start token, then the generation, ``pad_token_id``
    after eos) and ``response_mask`` [B, N], as the JAX function."""
    B = input_ids.shape[0]
    N = int(max_new_tokens)
    dev = input_ids.device
    enc = encode_fn(input_ids, attention_mask)
    cross_kvs = cross_kv_fn(enc)
    cache = init_cache_fn(B, N + 1)
    seqs = torch.full((B, N + 1), pad_token_id, dtype=torch.int32, device=dev)
    seqs[:, 0] = decoder_start_token_id
    dec_mask = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)
    dec_mask[:, 0] = 1
    tok = torch.full((B,), decoder_start_token_id, dtype=torch.int32, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    vocab = None
    step = 0

    def all_finished() -> torch.Tensor:
        done = finished.all()
        return done if sync_group is None else all_reduce(done.to(torch.int32), sync_group, "min")

    while step < N and not bool(all_finished()):
        logits, hidden, cache = decode_fn(tok[:, None], enc, attention_mask, dec_mask, None, cache, cross_kvs)
        step_logits = logits[:, -1, :]
        if logits_processor is not None:
            step_logits = logits_processor(hidden[:, -1, :], step_logits, tok)
        if eos_token_id is not None and step < min_new_tokens:
            if vocab is None:
                vocab = torch.arange(step_logits.shape[-1], device=dev)
            step_logits = torch.where((vocab == eos_token_id)[None, :], torch.full_like(step_logits, -1e9),
                                      step_logits)
        new_tok = sample_token(generator, step_logits, temperature, top_k, top_p, do_sample, top_k_impl, rows)
        tok = torch.where(finished, torch.full_like(new_tok, pad_token_id), new_tok).to(torch.int32)
        if eos_token_id is not None:
            finished = finished | (tok == eos_token_id)
        seqs[:, step + 1] = tok
        dec_mask[:, step + 1] = 1
        step += 1

    response_mask = dec_mask[:, 1:]
    if eos_token_id is not None:
        resp = seqs[:, 1:]
        is_eos = (resp == eos_token_id).to(torch.int32)
        after_eos = torch.cumsum(torch.nn.functional.pad(is_eos[:, :-1], (1, 0)), dim=1) > 0
        written = torch.arange(N, device=dev)[None, :] < step
        response_mask = response_mask * (~after_eos & written).to(torch.int32)
        seqs = torch.cat(
            [seqs[:, :1], torch.where(response_mask > 0, resp, torch.full_like(resp, pad_token_id))], dim=1
        )
    return {"sequences": seqs, "response_mask": response_mask}


# -- the census (python -m trlx_tpu_torch.analysis.census) ---------------------


@register_entrypoint(
    "decode_step",
    roots=(
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.generate",
        "trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer.gen_step_fn",
        "trlx_tpu_torch.ops.generation.generate",
        "trlx_tpu_torch.models.transformer.*",
        "trlx_tpu_torch.ops.attention.flash_attention",
        "trlx_tpu_torch.ops.sampling.*",
    ),
    readback={
        # the host fetch of sequences and mask
        "trlx_tpu_torch.trainer.mesh_trainer.MeshRLTrainer.generate": 2,
        # the early exit once every row has finished: one read a token
        "trlx_tpu_torch.ops.generation.generate": 1,
        "trlx_tpu_torch.ops.generation.generate_seq2seq": 1,
    },
)
def build_decode_step(device, size, shared):
    """The rollout decode as the trainer runs it (the reference's
    ``decode_step``, ``trlx_tpu/ops/generation.py:262``):
    ``MeshRLTrainer.generate`` of a prompt batch, greedy, ``N`` new tokens
    every row (eos held off by ``min_new_tokens``, so the loop never exits
    early), over the PPO trainer's policy. Variants: the same prompt lengths
    with other tokens."""
    from trlx_tpu_torch.analysis.census import fixtures, seeds

    tr = fixtures.trainer("ppo", device, size, shared)
    d = fixtures.shapes(size, "decode")
    rng = np.random.default_rng(fixtures.SEED)
    lens = rng.integers(d["lo"], d["hi"] + 1, size=d["B"])
    prompts = {k: [np.random.default_rng(100 + k).integers(1, 250, size=n).astype(np.int32) for n in lens]
               for k in range(4)}
    seed = seeds.active()
    if seed in ("f32_upcast", "extra_item"):
        real = tr.gen_step_fn

        def seeded_gen_step_fn(policy=None):
            step_fn, init_cache = real(policy)

            def seeded(ids, mask, positions, cache):
                logits, hidden, cache = step_fn(ids, mask, positions, cache)
                if seed == "f32_upcast":  # an f32 copy of the vocab projection
                    emb = tr.model.transformer.embed_tokens.embedding
                    logits = torch.matmul(hidden.float(), emb.float().t())
                else:  # a host read every decode iteration
                    logits[0, -1, 0].item()
                return logits, hidden, cache

            return seeded, init_cache

        tr.gen_step_fn = seeded_gen_step_fn

    def step(k):
        tr.generate(prompts[k], eval_mode=True, max_new_tokens=d["N"], min_new_tokens=d["N"], do_sample=False)

    return Entry(step=step)
