"""Persistent continuous-batching generation engine (counterpart of
``trlx_tpu/serving/engine.py``).

One :class:`ServingEngine` owns a model trunk, per-layer device block pools
(``trunk.init_paged_cache``), a host-side :class:`PagedBlockAllocator` and an
:class:`InflightScheduler`. The hot loop has two device programs:

- **bucketed prefill** — each admission wave runs the trunk's ordinary
  left-padded contiguous prefill at a bucketed ``(batch, prompt_len)``
  shape (flash kernel under ``attention_impl="flash"``), then a scatter
  packs the K/V rows into the pools through each sequence's block table.
- **decode step** — one fixed-shape step over all ``num_slots`` slots:
  ``TransformerLM.paged_decode`` (paged write + paged decode kernel per
  layer) followed by sampling. Slot membership changes only through the
  block-table / context-length inputs.

The step always runs full-batch; idle slots run against the reserved null
block and their outputs are discarded. A slot freed by a finished sequence
is refilled on the next round.

Two optional multi-token modes, both through ``TransformerLM.paged_verify``
(the paged verify kernel per layer):

- **speculative decoding** (``spec_k > 0``): a host-side prompt-lookup
  n-gram draft proposes K tokens per slot; one fixed-shape verify step
  scores the pending token + K drafts, samples every position, and accepts
  the longest leading run of drafts that match what the model would have
  emitted. Greedy output is identical to one-token decode; rejected-draft KV
  sits past ``context_lens`` and is rewritten before it can become valid.
- **chunked prefill** (``prefill_chunk > 0``): prompts longer than the chunk
  prefill their first chunk in the bucketed wave and the rest through
  per-round batch-1 verify appends interleaved with decode rounds;
  mid-prefill slots are masked out of the decode batch (null table row,
  len 0) until their last chunk samples the first token.

Greedy decoding is byte-identical to the JAX engine on the same weights and
prompts, with and without both modes (tests/test_torch_serving.py,
tests/test_torch_serving_spec.py). Sampled streams draw from a
``torch.Generator`` seeded with ``seed`` and do not match JAX's bits; a
sampled speculative stream differs from a sampled one-token stream by
construction (other draws per position).

With a :class:`~trlx_tpu_torch.serving.policy.ServingResiliencePolicy`
(``policy=``) each admission round first expires and sheds pending
requests, each decode round expires live ones, and under
``policy.preemption`` admission is optimistic: before every decode round
each live slot grows its blocks through ``allocator.extend``, and when the
pool cannot serve the growth the longest-remaining other sequence is
preempted (re-queued at the front, re-prefilled later from prompt +
generated-so-far). With a :class:`~trlx_tpu_torch.serving.tenancy.TenantRegistry`
(``tenants=``) requests carry a tenant and an SLO class: admission and
shedding follow the classes, a tenant's KV-block quota gates its admissions
and preempts its own sequences when one of them grows past it, and the
victim of KV pressure comes from an over-share tenant first. Both ``None``
keep every pass a no-op: the engine is then the plain one, token for token.

Four chaos sites (:mod:`trlx_tpu_torch.resilience.chaos`) drive the
recovery paths: ``serving-prefill`` raises after placement and before the
prefill wave, ``serving-decode`` before the device step, ``serving-alloc``
reports one block extension as failed, and ``serving-wedge`` parks
:meth:`step` under the engine lock until :meth:`request_abort` (then
:class:`~trlx_tpu_torch.serving.policy.EngineWedgedError`). The
:class:`~trlx_tpu_torch.serving.supervisor.ServingSupervisor` turns each
into a restart that replays every request.

Generation islands (:meth:`attach_island`, :class:`~trlx_tpu_torch.serving.island.GenerationIsland`):
every :meth:`step` first touches the island's round gate (serializing
against a chunk install of the
:class:`~trlx_tpu_torch.rollout.broadcast.ChunkedParameterPublisher`),
polls for a newly committed broadcast and installs it through
:meth:`set_params` (one prefix-cache flush per version, between rounds,
never torn), and reports the round's busy interval to the island's ledger.
In a fleet (:class:`~trlx_tpu_torch.fleet.FleetRouter`) each replica writes
its gauges under ``serving/replica/<seat>/`` (``gauge_prefix``) and tags
its typed errors with its seat (``replica_id``); a retired replica drops
its trunk and pools (:meth:`release_device_state`).

Request flights (:mod:`trlx_tpu_torch.obs.flight`): besides the
scheduler's lifecycle events, the engine journals each chunk append
(``prefill_chunk``), each decode or verify round a request takes part in
(``decode_round``, before the device step) and accepted drafts
(``spec_accept``), all on the scheduler's clock and only when the recorder
is enabled.

Thread-safety: ``submit``/``cancel`` may be called from producer threads;
``step``/``run`` are serialized by the engine lock.
"""

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trlx_tpu_torch.obs.flight import flight
from trlx_tpu_torch.ops.generation import left_pad_batch, pad_to_bucket
from trlx_tpu_torch.ops.sampling import count_accepted_drafts, sample_token
from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.serving.allocator import PagedBlockAllocator
from trlx_tpu_torch.serving.policy import (
    EngineDrainingError,
    EngineWedgedError,
    RequestTooLarge,
    ServingResiliencePolicy,
)
from trlx_tpu_torch.serving.scheduler import InflightScheduler, Request
from trlx_tpu_torch.serving.tenancy import TenantRegistry, select_victim
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges, nearest_rank

logger = logging.get_logger(__name__)

# prompt-length buckets for prefill (same family the JAX engine uses)
PREFILL_LEN_BUCKETS = tuple(2 ** i for i in range(3, 14))
# namespace of every gauge the engine writes (and close() clears)
GAUGE_PREFIX = "serving/"


def _pow2_at_least(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _ngram_propose(ctx: np.ndarray, k: int, max_order: int, pad_token: int) -> np.ndarray:
    """Prompt-lookup drafting: propose ``k`` tokens by matching the longest
    suffix n-gram (order ``max_order`` down to 1) earlier in the context and
    continuing from the LATEST such match. Host numpy: the draft must cost
    far less than the verify pass. No match (or a match flush against the
    end) pads with ``pad_token``: a wrong draft costs nothing beyond the
    verify work the fixed-shape step does anyway."""
    out = np.full((k,), pad_token, np.int32)
    L = len(ctx)
    if L < 2:
        return out
    for n in range(min(max_order, L - 1), 0, -1):
        tail = ctx[L - n:]
        # windows of length n starting at j cover ctx[j : j+n]; the suffix
        # itself (j = L - n) is excluded so the continuation is a real lookbehind
        n_cand = L - n
        m = np.ones((n_cand,), bool)
        for j in range(n):
            m &= ctx[j : j + n_cand] == tail[j]
        hits = np.nonzero(m)[0]
        if len(hits) == 0:
            continue
        start = int(hits[-1]) + n  # continuation of the latest match
        take = ctx[start : start + k]
        out[: len(take)] = take
        return out
    return out


def pack_targets(rows: np.ndarray, lens: np.ndarray, P: int, block_size: int, max_blocks: int,
                 shared: bool = True):
    """(pool positions, source rows) of a prefill pack: the flat pool slot
    (``block * block_size + offset``) of every non-padding position of a
    left-padded ``[n, P]`` wave, and its index into the wave's ``n * P``
    positions. With ``shared`` (prefix caching on), rows whose prompts share
    a cached prefix block name the same slots, and their values differ in
    the last bits (each row computed them at its own padding). A CUDA
    ``index_put_`` with repeated indices keeps an arbitrary one, so two
    identical runs could serve different prefix K/V; each slot is therefore
    written once, by the last row that names it (what a sequential CPU
    scatter keeps). Without prefix caching no two rows share a block and
    the positions are returned as they are."""
    pos = np.arange(P)[None, :] - (P - lens[:, None])  # logical position, <0 on padding
    keep = pos >= 0
    pos_c = np.clip(pos, 0, max_blocks * block_size - 1)
    blk = np.take_along_axis(rows, pos_c // block_size, axis=1)
    dest = (blk * block_size + pos_c % block_size).reshape(-1)
    src = np.flatnonzero(keep.reshape(-1))
    dest = dest[src]
    if not shared:
        return dest.astype(np.int64), src.astype(np.int64)
    _, last_rev = np.unique(dest[::-1], return_index=True)
    last = np.sort(len(dest) - 1 - last_rev)
    return dest[last].astype(np.int64), src[last].astype(np.int64)


def resolve_device(device) -> torch.device:
    """``None`` means the card: with no CUDA the caller must ask for the
    CPU explicitly (``device="cpu"``); nothing falls back silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain CPU path"
            )
        device = "cuda"
    return torch.device(device)


@dataclass
class ServingStats:
    # every token a decode round hands to the scheduler: 1 per live slot
    # plain, 1..K+1 speculative (prefill's first token is prefill accounting)
    delivered_tokens: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    prefill_waves: int = 0
    finished_requests: int = 0
    # live slots summed over decode rounds: the denominator of
    # accepted_tok_per_round (exactly 1.0 with spec off)
    decode_slot_rounds: int = 0
    spec_rounds: int = 0
    spec_draft_tokens: int = 0
    spec_accepted_tokens: int = 0
    chunk_appends: int = 0
    # host-clock seconds in admission rounds (prefill + pack) and decode
    # rounds; each round ends by copying sampled tokens to the host, so
    # these include the device work they issued
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # stream-overlapped PPO: the trainer reports each streaming window's
    # decode-busy seconds and the reward / score / learn-stage seconds that
    # overlapped them (:meth:`ServingEngine.note_overlap`)
    overlap_decode_s: float = 0.0
    overlap_overlapped_s: float = 0.0
    overlap_windows: int = 0


class ServingEngine:
    def __init__(
        self,
        trunk,
        params: Optional[Dict[str, torch.Tensor]] = None,
        *,
        num_slots: int,
        max_seq_len: int,
        block_size: int = 16,
        num_blocks: int = 0,
        eos_token_id: Optional[int] = None,
        pad_token_id: int = 0,
        gen_kwargs: Optional[Dict[str, Any]] = None,
        min_new_tokens: int = 0,
        prefix_caching: bool = True,
        seed: int = 0,
        policy: Optional[ServingResiliencePolicy] = None,
        spec_k: int = 0,
        spec_ngram: int = 3,
        prefill_chunk: int = 0,
        tenants: Optional[TenantRegistry] = None,
        gauge_prefix: str = GAUGE_PREFIX,
        replica_id: Optional[int] = None,
        device=None,
    ):
        """``trunk`` is a ``TransformerLM`` (its config decides the KV dtype
        via ``kv_cache_quant`` and the attention kernels via
        ``attention_impl`` / ``paged_attention_impl``); it is moved to
        ``device`` in place. ``params`` is an optional ``state_dict`` loaded
        into it (e.g. from ``models.convert.params_from_jax``); ``None``
        serves the trunk's own weights. ``device=None`` means ``"cuda"``.

        ``spec_k`` > 0 turns on speculative decoding (K n-gram drafts
        verified per round); ``spec_ngram`` caps the draft-match n-gram
        order. ``prefill_chunk`` > 0 splits admissions longer than the chunk
        into per-round verify appends interleaved with decode (0 =
        whole-prompt bucketed prefill). ``policy`` installs deadlines,
        shedding and KV-pressure preemption; ``tenants`` the tenancy
        registry (module docs); ``None`` keeps each pass a no-op.
        ``gauge_prefix`` namespaces every gauge the engine writes (and the
        prefix ``close()`` clears): a fleet gives each replica
        ``serving/replica/<i>/``. ``replica_id`` tags typed errors with the
        raising replica (None outside a fleet)."""
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.prefill_chunk = int(prefill_chunk)
        if self.spec_k < 0 or self.spec_ngram < 1 or self.prefill_chunk < 0:
            raise ValueError(
                f"spec_k={spec_k} must be >= 0, spec_ngram={spec_ngram} >= 1, "
                f"prefill_chunk={prefill_chunk} >= 0"
            )
        self.device = resolve_device(device)
        self.trunk = trunk.to(self.device)
        if params is not None:
            self.trunk.load_state_dict(params)
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.max_seq_len = int(max_seq_len)
        self.max_blocks_per_seq = -(-self.max_seq_len // self.block_size)
        if num_blocks <= 0:
            # full reservation for every slot, +1 for the reserved null block
            num_blocks = self.num_slots * self.max_blocks_per_seq + 1
        self.num_blocks = int(num_blocks)
        self.eos_token_id = eos_token_id
        self.pad_token_id = int(pad_token_id)
        self.gen_kwargs = dict(gen_kwargs or {})
        self.min_new_tokens = int(min_new_tokens)
        self.gauge_prefix = str(gauge_prefix)
        self.replica_id = None if replica_id is None else int(replica_id)
        # the generation island (attach_island) and the broadcast version
        # installed from it; -1 before the first swap or with no island
        self._island = None
        self._island_version = -1

        self.allocator = PagedBlockAllocator(
            self.num_blocks, self.block_size, prefix_caching=prefix_caching
        )
        self.policy = policy
        self.tenants = tenants
        self.scheduler = InflightScheduler(self.num_slots, self.allocator, policy=policy, tenants=tenants)
        # per-tenant / per-class latency windows of the p99 gauges (bounded),
        # written by step() under the engine lock
        self._tenant_latency: Dict[str, deque] = {}
        self._class_latency: Dict[int, deque] = {}
        self.stats = ServingStats()
        self._lock = threading.Lock()
        # drain() sets _draining so submit() rejects; request_abort() sets
        # _abort_evt to unstick a wedged step. Events, not the lock: both are
        # called from other threads while a round (or a wedge) holds the lock
        self._draining = threading.Event()
        self._abort_evt = threading.Event()

        # device state
        with torch.no_grad():
            self.cache = self.trunk.init_paged_cache(
                self.num_blocks, self.block_size, self.max_blocks_per_seq, self.num_slots
            )
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        # host mirrors of the table/length leaves; pushed when dirty
        self._tables = np.zeros((self.num_slots, self.max_blocks_per_seq), np.int32)
        self._lens = np.zeros((self.num_slots,), np.int32)
        self._tables_dirty = True
        # the next input token per slot (sampled last round, not yet written)
        self._pending_tok = np.zeros((self.num_slots,), np.int32)
        # slots mid chunked-prefill: masked out of the decode batch (their
        # device table row / len are zeroed) until the final chunk lands
        self._prefilling = np.zeros((self.num_slots,), bool)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A device COPY of a host array. ``torch.from_numpy`` (and
        ``torch.as_tensor`` on the CPU) would alias the numpy buffer, and the
        host mirrors are mutated in place (``self._lens += 1``, slot frees)
        while an issued step may still read them — the aliasing race the JAX
        engine fixed by pushing copies. ``torch.tensor`` always copies."""
        return torch.tensor(arr, device=self.device)

    @property
    def _pool_keys(self) -> List[str]:
        return [k for k in self.cache if k not in ("block_tables", "context_lens")]

    # -- device programs -----------------------------------------------------

    def _sample(self, logits: torch.Tensor, new_counts: torch.Tensor) -> torch.Tensor:
        if self.eos_token_id is not None and self.min_new_tokens > 0:
            eos_col = torch.arange(logits.shape[-1], device=logits.device) == self.eos_token_id
            block = (new_counts[:, None] < self.min_new_tokens) & eos_col[None, :]
            logits = torch.where(block, torch.full_like(logits, -1e9), logits)
        return sample_token(self._gen, logits, **self.gen_kwargs)

    @torch.no_grad()
    def _decode_step(self, tok: torch.Tensor, new_counts: torch.Tensor) -> torch.Tensor:
        logits, _, self.cache = self.trunk.paged_decode(tok[:, None], self.cache)
        return self._sample(logits[:, -1, :], new_counts)

    def _sample_positions(self, logits: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        """Per-position sampling for the verify step: ``logits`` [S, Q, V],
        ``counts`` [S, Q] = each position's generated-token index (the
        min_new_tokens eos mask as :meth:`_sample` applies it per step:
        position j of a verify round IS generated token ``len(generated) + j``
        of the one-token decode it replays). Returns [S, Q] int32."""
        if self.eos_token_id is not None and self.min_new_tokens > 0:
            eos_col = torch.arange(logits.shape[-1], device=logits.device) == self.eos_token_id
            block = (counts[..., None] < self.min_new_tokens) & eos_col[None, None, :]
            logits = torch.where(block, torch.full_like(logits, -1e9), logits)
        return sample_token(self._gen, logits, **self.gen_kwargs)

    @torch.no_grad()
    def _verify_step(self, tok: torch.Tensor, new_counts: torch.Tensor):
        """Speculative verify round: ``tok`` [S, K+1] = pending token + K
        n-gram drafts per slot. One widened paged forward scores every
        position; per-position sampling and the leading-match accept count
        stay on the device, and ``context_lens`` advances by ``accepted + 1``
        (rejected-draft KV past the new frontier stays invisible to the mask
        and is rewritten before it can become valid, so rollback is free).
        Returns (sampled [S, K+1], accepted [S]) on the device."""
        lens0 = self.cache["context_lens"]
        logits, _, self.cache = self.trunk.paged_verify(tok, self.cache)
        counts = new_counts[:, None] + torch.arange(tok.shape[1], dtype=torch.int32, device=tok.device)[None, :]
        y = self._sample_positions(logits, counts)
        accepted = count_accepted_drafts(y, tok)
        self.cache["context_lens"] = lens0 + accepted + 1
        return y, accepted

    @torch.no_grad()
    def _chunk_step(self, ids: torch.Tensor, cache: Dict[str, Any], last_idx: torch.Tensor,
                    new_counts: torch.Tensor) -> torch.Tensor:
        """One chunked-prefill append: ``ids`` [n, C] (pad-filled on a final
        partial chunk) writes all C positions' KV through ``cache``'s table
        rows (the engine's pools, written in place) and samples a next token
        from the logit at ``last_idx``: only the final chunk's sample is
        used. ``context_lens`` is not advanced; the host mirror owns the
        prefilled frontier. Pad positions write garbage KV past the prompt,
        which the first decode / verify round overwrites before the mask can
        expose it."""
        logits, _, _ = self.trunk.paged_verify(ids, cache)
        last = logits[torch.arange(ids.shape[0], device=ids.device), last_idx.long()]
        return self._sample(last, new_counts)

    @torch.no_grad()
    def _prefill(self, ids: torch.Tensor, mask: torch.Tensor, new_counts: torch.Tensor):
        """Left-padded contiguous prefill from slot 0; returns (first sampled
        token per row, the filled contiguous cache)."""
        B, P = ids.shape
        cache = self.trunk.init_cache(B, P)
        positions = (torch.cumsum(mask, dim=1) - 1).clamp(min=0).to(torch.int32)
        logits, _, _, cache = self.trunk(ids, mask, positions, cache, last_only=True)
        return self._sample(logits[:, -1, :], new_counts), cache

    @torch.no_grad()
    def _pack(self, cont: Dict[str, List[torch.Tensor]], rows: np.ndarray, lens: np.ndarray) -> None:
        """Scatter a contiguous left-padded prefill cache into the block
        pools IN PLACE (``cont``: k/v [n,Hkv,P,D], scales [n,Hkv,P,1];
        ``rows`` [n, MB] block-table rows; ``lens`` [n] prompt lengths).
        Padding positions are dropped. Rewriting a shared prefix block stores
        the values it already holds (same tokens, same weights), up to the
        rounding of the row that computed them: each pool position is written
        once (:func:`pack_targets`)."""
        n, P = rows.shape[0], cont["k"][0].shape[2]
        dest, src = pack_targets(rows, lens, P, self.block_size, self.max_blocks_per_seq,
                                 shared=self.allocator.prefix_caching)
        flat, src = self._to_device(dest), self._to_device(src)
        for key in self._pool_keys:
            for pool, cl in zip(self.cache[key], cont[key]):
                if key.endswith("_scale"):
                    cl = cl[..., 0]  # [n,Hkv,P,1] -> [n,Hkv,P]
                # cont [n, Hkv, P, ...] -> rows [n*P, Hkv, ...]
                vals = cl.movedim(2, 1).reshape(n * P, *pool.shape[2:])[src]
                pool.view(-1, *pool.shape[2:])[flat] = vals.to(pool.dtype)

    # -- host loop -----------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        stop_sequences: Sequence[Sequence[int]] = (),
        deadline_s: Optional[float] = None,
        tenant_id: Optional[str] = None,
    ) -> int:
        spec = self.tenants.resolve(tenant_id) if self.tenants is not None else None
        tags = dict(tenant_id=spec.tenant_id if spec else None, slo_class=spec.slo_class if spec else None,
                    replica_id=self.replica_id)
        if self._draining.is_set():
            raise EngineDrainingError("engine is draining: new requests are rejected (graceful shutdown)", **tags)
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"engine max_seq_len {self.max_seq_len}"
            )
        worst = self.allocator.blocks_needed(len(prompt) + max_new_tokens)
        if worst > self.num_blocks - 1:
            raise RequestTooLarge(
                f"request needs {worst} KV blocks worst-case but the pool "
                f"holds {self.num_blocks - 1}: it can never be admitted", **tags
            )
        if spec is not None and spec.kv_block_quota and worst > spec.kv_block_quota:
            # the same never-admittable check against the tenant's cap, and the
            # guarantee quota enforcement leans on: any one admitted sequence
            # fits its tenant's quota alone
            raise RequestTooLarge(
                f"request needs {worst} KV blocks worst-case but tenant "
                f"{spec.tenant_id!r} is capped at {spec.kv_block_quota}: it "
                f"can never be admitted", **tags
            )
        return self.scheduler.submit(
            prompt, max_new_tokens, eos_token_id=self.eos_token_id,
            stop_sequences=stop_sequences, deadline_s=deadline_s, tenant_id=tenant_id,
        )

    def cancel(self, uid: int) -> bool:
        return self.scheduler.cancel(uid)

    def attach_island(self, island) -> None:
        """Run this engine as a generation island
        (:class:`~trlx_tpu_torch.serving.island.GenerationIsland`): every
        :meth:`step` touches the island's round gate, polls its publisher for
        a newly committed chunked broadcast, installs it through
        :meth:`set_params` (one prefix-cache flush per version, between
        rounds) and reports the round's busy interval to the island's ledger.

        Called only on a quiescent engine: at wiring time before the first
        step, or by the supervisor on a freshly built successor before it
        adopts the replay state."""
        self._island = island
        self._island_version = -1

    @property
    def serving_version(self) -> int:
        """The broadcast version the engine serves (-1 before the first
        island swap, or with no island attached)."""
        return self._island_version

    def release_device_state(self) -> None:
        """Drop the trunk and the KV pools (a retired fleet replica): the
        host-side scheduler and allocator stay readable for the fleet's
        counters, and the device memory returns to the caching allocator
        once nothing else holds the tensors. The engine cannot step again."""
        with self._lock:
            self.trunk = None
            self.cache = None

    def set_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Swap the weights (a ``state_dict``). Cached prefix K/V was computed
        under the old weights, so the prefix cache flushes."""
        with self._lock:
            self.trunk.load_state_dict(params)
            self.allocator.flush_prefix_cache()

    def _free_slot_state(self, slot: int) -> None:
        self._tables[slot] = 0
        self._lens[slot] = 0
        self._pending_tok[slot] = self.pad_token_id
        self._prefilling[slot] = False
        self._tables_dirty = True

    def _admit(self) -> List[Request]:
        """One admission round: reap cancels, place pending requests, run
        bucketed prefills, pack pools, sample each new sequence's first
        token. Returns requests that finished during admission (a first
        token can already be eos). With chunked prefill a prompt longer
        than the chunk prefills its first chunk here and is marked
        mid-prefill; :meth:`_advance_prefill_chunks` appends the rest."""
        finished: List[Request] = []
        for slot in self.scheduler.reap_cancelled():
            self._free_slot_state(slot)
        # the policy's admission-side pass: expire and shed pending requests
        # (they hold no device state) before placement
        finished.extend(self.scheduler.expire_and_shed_pending())
        placements = self.scheduler.admissions()
        if not placements:
            return finished
        # placed requests hold slots and blocks now: a crash here is the
        # supervisor's replay case
        chaos.fail_if_armed("serving-prefill", f"{len(placements)} placements")
        # group by bucketed prefill length so one wave runs per bucket pair;
        # prefill covers prompt + generated-so-far (re-admissions)
        by_bucket: Dict[int, List[Tuple[int, Request, List[int]]]] = {}
        for slot, req in placements:
            ids_full = req.prefill_ids
            if 0 < self.prefill_chunk < len(ids_full):
                self._prefilling[slot] = True
                req.prefilled = 0
                first = ids_full[: self.prefill_chunk]
            else:
                first = ids_full
            by_bucket.setdefault(
                pad_to_bucket(len(first), PREFILL_LEN_BUCKETS), []
            ).append((slot, req, first))
        for P_b, group in sorted(by_bucket.items()):
            n_b = _pow2_at_least(len(group), self.num_slots)
            ids_list = [np.asarray(first, np.int32) for _, _, first in group]
            ids, mask = left_pad_batch(ids_list, self.pad_token_id, P_b)
            if n_b > len(group):  # pad the wave to its batch bucket
                ids = np.concatenate(
                    [ids, np.full((n_b - len(group), P_b), self.pad_token_id, np.int32)]
                )
                mask = np.concatenate([mask, np.zeros((n_b - len(group), P_b), mask.dtype)])
                # all-pad rows still get one "valid" token (token 0 @ pos 0)
                mask[len(group):, -1] = 1
            counts = np.zeros((n_b,), np.int32)
            for i, (_, req, _) in enumerate(group):
                counts[i] = len(req.generated)
            tok, cont = self._prefill(
                self._to_device(ids), self._to_device(mask), self._to_device(counts)
            )
            rows = np.zeros((n_b, self.max_blocks_per_seq), np.int32)
            lens = np.zeros((n_b,), np.int32)
            for i, (slot, req, first) in enumerate(group):
                blocks = req.seq_blocks.blocks
                rows[i, : len(blocks)] = blocks
                lens[i] = len(first)
            self._pack(cont, rows, lens)
            tok_np = tok.cpu().numpy()
            self.stats.prefill_waves += 1
            self.stats.prefill_tokens += int(sum(len(first) for _, _, first in group))
            for i, (slot, req, first) in enumerate(group):
                self._tables[slot] = rows[i]
                self._lens[slot] = len(first)
                self._tables_dirty = True
                if self._prefilling[slot]:
                    # prompt incomplete: the wave's token conditioned on a
                    # truncated prompt and is discarded; the final chunk
                    # samples the real first token
                    req.prefilled = len(first)
                    continue
                self._pending_tok[slot] = tok_np[i]
                done = self.scheduler.on_token(slot, int(tok_np[i]))
                if done is not None:
                    finished.append(done)
                    self._free_slot_state(slot)
        return finished

    def _advance_prefill_chunks(self) -> List[Request]:
        """Advance every mid-prefill slot by one chunk (a batch-1 verify
        append into the shared pools through the slot's own table row),
        interleaved with decode rounds. The final chunk samples the
        sequence's first token; after it the slot's state is the one a
        whole-prompt prefill leaves (lens = prompt length, pending = first
        token), which keeps chunked output identical to unchunked."""
        finished: List[Request] = []
        if not self._prefilling.any():
            return finished
        C = self.prefill_chunk
        for slot in np.nonzero(self._prefilling)[0]:
            slot = int(slot)
            req = self.scheduler.slots[slot]
            if req is None:  # freed (cancel / expiry / preemption) mid-prefill
                self._prefilling[slot] = False
                continue
            ids_full = req.prefill_ids
            start = req.prefilled
            chunk = ids_full[start : start + C]
            n_v = len(chunk)
            ids = np.full((1, C), self.pad_token_id, np.int32)
            ids[0, :n_v] = chunk
            row = np.zeros((1, self.max_blocks_per_seq), np.int32)
            blocks = req.seq_blocks.blocks
            row[0, : len(blocks)] = blocks
            cache1 = {key: self.cache[key] for key in self._pool_keys}
            cache1["block_tables"] = self._to_device(row)
            cache1["context_lens"] = self._to_device(np.array([start], np.int32))
            tok = self._chunk_step(
                self._to_device(ids), cache1,
                self._to_device(np.array([n_v - 1], np.int32)),
                self._to_device(np.array([len(req.generated)], np.int32)),
            )
            req.prefilled = start + n_v
            self._lens[slot] = req.prefilled
            self.stats.prefill_tokens += n_v
            self.stats.chunk_appends += 1
            if flight.enabled:
                flight.record(req.uid, "prefill_chunk", t=self.scheduler.clock())
            if req.prefilled >= len(ids_full):
                # prompt complete: unmask the slot into the decode batch
                self._prefilling[slot] = False
                self._tables_dirty = True
                tok_i = int(tok.cpu()[0])
                self._pending_tok[slot] = tok_i
                done = self.scheduler.on_token(slot, tok_i)
                if done is not None:
                    finished.append(done)
                    self._free_slot_state(slot)
        return finished

    def _tenant_shares(self) -> Dict[str, int]:
        """Per-tenant block share for fair-share preemption: the tenant's
        quota when it has one, else an equal split of the pool over the
        tenants holding blocks. Past its share a tenant is only the
        preferred victim under KV pressure."""
        census = self.allocator.owner_census()
        owners = [t for t in census if t is not None]
        fair = (self.num_blocks - 1) // max(1, len(owners))
        return {t: (self.tenants.quota(t) or fair) for t in owners}

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """The preemption victim: the live sequence with the most decode
        budget left, never ``exclude``; with a tenancy registry, one of an
        over-share tenant first (:func:`~trlx_tpu_torch.serving.tenancy.select_victim`)."""
        candidates = [
            (slot, req) for slot, req in enumerate(self.scheduler.slots)
            if req is not None and slot != exclude
        ]
        if self.tenants is not None:
            return select_victim(candidates, self.allocator.owner_census(), self._tenant_shares())
        best, best_remaining = None, -1
        for slot, req in candidates:
            if req.remaining_tokens > best_remaining:
                best, best_remaining = slot, req.remaining_tokens
        return best

    def _enforce_quota(self, slot: int, req: Request, need_len: int) -> None:
        """Keep a live sequence's growth inside its tenant's KV-block quota:
        while the growth would cross it, preempt the tenant's OWN
        longest-remaining other sequence (never another tenant's). A lone
        sequence always fits: submit() rejects a request whose worst case
        exceeds its quota."""
        quota = self.tenants.quota(req.tenant_id)
        if not quota:
            return
        while True:
            grow = self.allocator.blocks_needed(need_len) - len(req.seq_blocks.blocks)
            if grow <= 0 or self.allocator.owner_usage(req.tenant_id) + grow <= quota:
                return
            victim, victim_remaining = None, -1
            for s, r in enumerate(self.scheduler.slots):
                if r is None or s == slot or r.tenant_id != req.tenant_id:
                    continue
                if r.remaining_tokens > victim_remaining:
                    victim, victim_remaining = s, r.remaining_tokens
            if victim is None:
                return
            logger.warning(
                f"quota pressure: preempting uid={self.scheduler.slots[victim].uid} "
                f"(slot {victim}, tenant {req.tenant_id!r}) to grow slot {slot}"
            )
            self.scheduler.preempt(victim)
            self._free_slot_state(victim)

    def _ensure_decode_capacity(self) -> None:
        """Optimistic admission (``policy.preemption``): before the decode
        step every live slot must own blocks covering this round's writes.
        Growth comes from ``allocator.extend``; when the pool cannot serve
        it, victims are preempted until it can. Chaos site ``serving-alloc``
        reports one extension as failed."""
        if self.policy is None or not self.policy.preemption:
            return
        for slot, req in enumerate(self.scheduler.slots):
            if req is None or self._prefilling[slot]:
                # mid chunked-prefill: admission reserved the whole prefill
                # (+1) up front; no growth until decode starts
                continue
            # every KV position this round can write: the incoming token plus
            # spec_k draft positions, clamped to the sequence's cap
            need_len = min(int(self._lens[slot]) + 1 + self.spec_k, len(req.prompt) + req.max_new_tokens)
            if self.tenants is not None:
                self._enforce_quota(slot, req, need_len)
            before = len(req.seq_blocks.blocks)
            ok = (not chaos.should_fail("serving-alloc")) and self.allocator.extend(req.seq_blocks, need_len)
            while not ok:
                victim = self._pick_victim(exclude=slot)
                if victim is not None:
                    logger.warning(
                        f"kv pressure: preempting uid={self.scheduler.slots[victim].uid} "
                        f"(slot {victim}) to grow slot {slot}"
                    )
                    self.scheduler.preempt(victim)
                    self._free_slot_state(victim)
                ok = self.allocator.extend(req.seq_blocks, need_len)
                if not ok and victim is None:
                    # submit() bounds every worst case to the pool, so a lone
                    # sequence always extends: the accounting broke
                    raise RuntimeError(f"kv pool cannot cover lone slot {slot} at len {need_len}")
            if len(req.seq_blocks.blocks) != before:
                self._tables[slot, : len(req.seq_blocks.blocks)] = req.seq_blocks.blocks
                self._tables_dirty = True

    def _push_mirrors(self) -> None:
        """Push the host table/len mirrors to the device when stale (as
        copies — see :meth:`_to_device`). While a slot is mid chunked-prefill
        its real state (partial lens, table row) stays OFF the decode inputs:
        the pushed copy masks it to the null row / len 0 so the full-batch
        step treats it as idle, and the mirror stays dirty so completion
        pushes the real state."""
        prefill_active = bool(self._prefilling.any())
        if not (self._tables_dirty or prefill_active):
            return
        tables = np.array(self._tables)
        lens = np.array(self._lens)
        if prefill_active:
            tables[self._prefilling] = 0
            lens[self._prefilling] = 0
        self.cache["block_tables"] = self._to_device(tables)
        self.cache["context_lens"] = self._to_device(lens)
        self._tables_dirty = prefill_active

    def _decode_round(self) -> List[Request]:
        finished: List[Request] = []
        for slot, req in self.scheduler.expire_live():
            self._free_slot_state(slot)
            finished.append(req)
        self._ensure_decode_capacity()
        live = [
            s for s, r in enumerate(self.scheduler.slots)
            if r is not None and not self._prefilling[s]
        ]
        if not live:
            return finished
        chaos.fail_if_armed("serving-decode", f"{len(live)} live slots")
        if flight.enabled:
            # journal before the device step: the request may finish inside
            # it, and the round marks decode participation either way
            t_round = self.scheduler.clock()
            for s in live:
                flight.record(self.scheduler.slots[s].uid, "decode_round", t=t_round)
        self._push_mirrors()
        new_counts = np.array(
            [len(r.generated) if r is not None else 0 for r in self.scheduler.slots],
            np.int32,
        )
        if self.spec_k > 0:
            finished.extend(self._spec_round(live, new_counts))
        else:
            next_tok = self._decode_step(
                self._to_device(self._pending_tok), self._to_device(new_counts)
            )
            # device lens advanced for every slot; mirror so a no-admission
            # next step needs no host->device push
            self._lens += 1
            tok_np = next_tok.cpu().numpy()
            for slot in live:
                self._pending_tok[slot] = tok_np[slot]
                done = self.scheduler.on_token(slot, int(tok_np[slot]))
                if done is not None:
                    finished.append(done)
                    self._free_slot_state(slot)
            self.stats.delivered_tokens += len(live)
        self.scheduler.note_step()
        self.stats.decode_steps += 1
        self.stats.decode_slot_rounds += len(live)
        return finished

    def _spec_round(self, live: List[int], new_counts: np.ndarray) -> List[Request]:
        """One speculative round over the full slot batch: host n-gram
        drafts, one verify step, per-slot accept bookkeeping. Emits
        ``accepted + 1`` tokens per live slot, each what one-token greedy
        decode would have produced (the accept rule)."""
        finished: List[Request] = []
        K = self.spec_k
        drafts = np.zeros((self.num_slots, K), np.int32)
        for slot in live:
            req = self.scheduler.slots[slot]
            drafts[slot] = _ngram_propose(
                np.asarray(req.prefill_ids, np.int32), K, self.spec_ngram, self.pad_token_id,
            )
        tok = np.concatenate([self._pending_tok[:, None], drafts], axis=1)
        y, accepted = self._verify_step(self._to_device(tok), self._to_device(new_counts))
        acc_np = accepted.cpu().numpy()
        y_np = y.cpu().numpy()
        # the device advanced EVERY slot's frontier by accepted + 1 (idle and
        # masked mid-prefill slots included, off their null-block garbage);
        # the mirror does the same arithmetic so the two never diverge
        self._lens += acc_np.astype(np.int32) + 1
        self.stats.spec_rounds += 1
        self.stats.spec_draft_tokens += K * len(live)
        for slot in live:
            a = int(acc_np[slot])
            self.stats.spec_accepted_tokens += a
            if flight.enabled and a > 0:
                flight.record(self.scheduler.slots[slot].uid, "spec_accept", t=self.scheduler.clock(), accepted=a)
            self._pending_tok[slot] = y_np[slot, a]
            done, emitted = self.scheduler.on_tokens(slot, [int(t) for t in y_np[slot, : a + 1]])
            self.stats.delivered_tokens += emitted
            if done is not None:
                finished.append(done)
                self._free_slot_state(slot)
        return finished

    def request_abort(self) -> None:
        """Unstick a wedged step (the supervisor's wedge timer or the
        watchdog's escalation, from their threads). Never takes the engine
        lock: the wedged step holds it."""
        self._abort_evt.set()

    def step(self) -> List[Request]:
        """One engine round: admissions (bucketed prefill), one chunk per
        mid-prefill slot, then one decode (or verify) round. Returns requests
        finished during the round. With an island attached the round
        boundary is also the weight-swap point: the gate touch waits out an
        in-flight chunk install, and a committed broadcast is installed
        before (never during) the round."""
        island = self._island
        t_round0 = 0.0
        if island is not None:
            gate = island.round_gate
            gate.acquire()
            gate.release()
            upd = island.poll_swap(self._island_version)
            if upd is not None:
                version, params = upd
                self.set_params(params)  # one prefix-cache flush per version
                self._island_version = version
            t_round0 = time.monotonic()
        with self._lock:
            if chaos.should_fail("serving-wedge"):
                # a wedged device loop: no progress, no exception, the lock
                # held, until someone aborts it
                logger.warning("chaos: serving step wedged, waiting for abort")
                self._abort_evt.wait()
                self._abort_evt.clear()
                raise EngineWedgedError("engine step loop wedged and was aborted")
            t0 = time.perf_counter()
            finished = self._admit()
            finished += self._advance_prefill_chunks()
            t1 = time.perf_counter()
            finished += self._decode_round()
            self.stats.prefill_s += t1 - t0
            self.stats.decode_s += time.perf_counter() - t1
            for req in finished:
                self.stats.finished_requests += 1
                if req.latency_s is not None:
                    gauges.observe(self.gauge_prefix + "request_latency_s", req.latency_s)
                    if self.tenants is not None:
                        self._tenant_latency.setdefault(req.tenant_id, deque(maxlen=512)).append(req.latency_s)
                        self._class_latency.setdefault(req.slo_class, deque(maxlen=512)).append(req.latency_s)
        if island is not None:
            island.note_round(t_round0, time.monotonic())
        return finished

    def begin_drain(self, shed_pending: bool = True) -> None:
        """Enter drain mode: reject new submits. ``shed_pending=False`` is the
        supervisor's mid-drain restart: its replay queue holds requests that
        were live and must finish, not be shed again."""
        self._draining.set()
        if shed_pending:
            self.scheduler.shed_all_pending()

    def drain(self) -> Dict[int, Request]:
        """Graceful shutdown: reject new submits (:class:`EngineDrainingError`),
        shed everything pending with an accountable ``shed`` outcome, and
        drive rounds until the live slots finish. Returns every request that
        reached a terminal state during the drain."""
        self.begin_drain()
        done: Dict[int, Request] = dict(self.scheduler.pop_finished())
        while self.scheduler.has_work:  # live slots and preemption re-queues
            self.step()
            done.update(self.scheduler.pop_finished())
        return done

    def adopt(self, state: Dict[str, object]) -> None:
        """Install a dead predecessor's exported request state (a supervised
        restart): :meth:`InflightScheduler.adopt_state`."""
        self.scheduler.adopt_state(state)

    def run(self, uids: Optional[Sequence[int]] = None) -> Dict[int, Request]:
        """Drive rounds until the given uids (or all work) complete."""
        want = set(uids) if uids is not None else None
        done: Dict[int, Request] = dict(self.scheduler.pop_finished())
        while True:
            if want is not None:
                if want <= set(done):
                    break
                if not self.scheduler.has_work:
                    raise RuntimeError(
                        f"engine drained with requests unaccounted: {want - set(done)}"
                    )
            elif not self.scheduler.has_work:
                break
            self.step()
            done.update(self.scheduler.pop_finished())
            self.export_gauges()
        return done

    # -- observability -------------------------------------------------------

    def note_overlap(self, decode_busy_s: float, overlapped_s: float) -> None:
        """Record one stream-overlap window (the trainer's interval ledger):
        ``decode_busy_s`` seconds of engine rounds, ``overlapped_s`` seconds
        of reward / score / learn-stage work inside them."""
        with self._lock:
            self.stats.overlap_decode_s += float(decode_busy_s)
            self.stats.overlap_overlapped_s += float(overlapped_s)
            self.stats.overlap_windows += 1

    def summary(self) -> Dict[str, float]:
        with self._lock:
            out = {
                "delivered_tokens": float(self.stats.delivered_tokens),
                "decode_steps": float(self.stats.decode_steps),
                "prefill_waves": float(self.stats.prefill_waves),
                "prefill_tokens": float(self.stats.prefill_tokens),
                "finished_requests": float(self.stats.finished_requests),
                "prefill_s": self.stats.prefill_s,
                "decode_s": self.stats.decode_s,
                # tokens emitted per live slot per decode round: exactly 1.0
                # with spec off; > 1 is the speculative multiplier delivered
                "accepted_tok_per_round": (
                    self.stats.delivered_tokens / max(1, self.stats.decode_slot_rounds)
                ),
                "spec_accept_rate": (
                    self.stats.spec_accepted_tokens / max(1, self.stats.spec_draft_tokens)
                ),
                "spec_rounds": float(self.stats.spec_rounds),
                "chunk_appends": float(self.stats.chunk_appends),
                # overlapped work / decode time; above 1.0 when several reward
                # workers hide more than a second per decode second (unclamped)
                "overlap_fraction": (
                    self.stats.overlap_overlapped_s / max(1e-9, self.stats.overlap_decode_s)
                    if self.stats.overlap_windows else 0.0
                ),
                "overlap_decode_s": float(self.stats.overlap_decode_s),
                "overlap_overlapped_s": float(self.stats.overlap_overlapped_s),
                "overlap_windows": float(self.stats.overlap_windows),
            }
        out["mean_slot_occupancy"] = self.scheduler.mean_slot_occupancy
        out["prefix_cache_hit_rate"] = self.allocator.stats.hit_rate
        out["blocks_in_use"] = float(self.allocator.blocks_in_use)
        out["pending_depth"] = float(self.scheduler.pending_depth)
        for key, count in self.scheduler.outcome_counts().items():
            out[key] = float(count)
        return out

    @staticmethod
    def _p99(window: Sequence[float]) -> float:
        """Nearest-rank p99 of a latency window (0.0 when empty)."""
        xs = sorted(window)
        return nearest_rank(xs, 0.99) if xs else 0.0

    def export_gauges(self) -> None:
        s = self.summary()
        gp = self.gauge_prefix
        for key in (
            "mean_slot_occupancy", "prefix_cache_hit_rate", "blocks_in_use",
            "delivered_tokens", "finished_requests", "pending_depth",
            "accepted_tok_per_round", "spec_accept_rate", "overlap_fraction",
            "shed", "expired", "preempted",
        ):
            gauges.set(gp + ("slot_occupancy" if key == "mean_slot_occupancy" else key), s[key])
        gauges.set(gp + "live_slots", float(self.scheduler.live_slots))
        if self.tenants is None:
            return
        # per-tenant and per-class breakdowns under <prefix>tenant/* and
        # <prefix>class/*; every registered tenant is zero-filled so the keys
        # are stable before its first outcome
        tenant_counts = self.scheduler.tenant_outcome_counts()
        for tid in set(self.tenants.tenant_ids()) | set(tenant_counts):
            counts = tenant_counts.get(tid, {})
            for key in ("shed", "expired", "preempted"):
                gauges.set(f"{gp}tenant/{tid}/{key}", float(counts.get(key, 0)))
        for cls, counts in self.scheduler.class_outcome_counts().items():
            for key in ("shed", "expired", "preempted"):
                gauges.set(f"{gp}class/{cls}/{key}", float(counts.get(key, 0)))
        with self._lock:
            tenant_lat = {t: list(w) for t, w in self._tenant_latency.items()}
            class_lat = {c: list(w) for c, w in self._class_latency.items()}
        for tid, window in tenant_lat.items():
            gauges.set(f"{gp}tenant/{tid}/p99_latency_s", self._p99(window))
        for cls, window in class_lat.items():
            gauges.set(f"{gp}class/{cls}/p99_latency_s", self._p99(window))
        for tid, used in self.allocator.owner_census().items():
            if tid is not None:
                gauges.set(f"{gp}tenant/{tid}/blocks_in_use", float(used))

    def close(self) -> None:
        """Clear every gauge under this engine's prefix."""
        gauges.clear(prefix=self.gauge_prefix)
