"""Persistent continuous-batching generation engine (counterpart of
``trlx_tpu/serving/engine.py``, default path).

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

Greedy decoding is byte-identical to the JAX engine on the same weights and
prompts (tests/test_torch_serving.py). Sampled streams draw from a
``torch.Generator`` seeded with ``seed`` and do not match JAX's bits.

Not in this slice (``NotImplementedError`` naming the slice): speculative
decoding (``spec_k``), chunked prefill (``prefill_chunk``), the resilience
policy, tenancy and generation islands.

Thread-safety: ``submit``/``cancel`` may be called from producer threads;
``step``/``run`` are serialized by the engine lock.
"""

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trlx_tpu_torch.ops.generation import left_pad_batch, pad_to_bucket
from trlx_tpu_torch.ops.sampling import sample_token
from trlx_tpu_torch.serving.allocator import PagedBlockAllocator
from trlx_tpu_torch.serving.policy import RequestTooLarge
from trlx_tpu_torch.serving.scheduler import InflightScheduler, Request
from trlx_tpu_torch.utils.metrics import gauges

# prompt-length buckets for prefill (same family the JAX engine uses)
PREFILL_LEN_BUCKETS = tuple(2 ** i for i in range(3, 14))
# namespace of every gauge the engine writes (and close() clears)
GAUGE_PREFIX = "serving/"


def _pow2_at_least(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


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
    delivered_tokens: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    prefill_waves: int = 0
    finished_requests: int = 0
    # host-clock seconds in admission rounds (prefill + pack) and decode
    # rounds; each round ends by copying sampled tokens to the host, so
    # these include the device work they issued
    prefill_s: float = 0.0
    decode_s: float = 0.0


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
        policy=None,
        spec_k: int = 0,
        spec_ngram: int = 3,
        prefill_chunk: int = 0,
        tenants=None,
        device=None,
    ):
        """``trunk`` is a ``TransformerLM`` (its config decides the KV dtype
        via ``kv_cache_quant`` and the attention kernels via
        ``attention_impl`` / ``paged_attention_impl``); it is moved to
        ``device`` in place. ``params`` is an optional ``state_dict`` loaded
        into it (e.g. from ``models.convert.params_from_jax``); ``None``
        serves the trunk's own weights. ``device=None`` means ``"cuda"``.
        ``spec_k``, ``spec_ngram``, ``prefill_chunk``, ``policy`` and
        ``tenants`` keep the JAX engine's signature; any non-default value
        raises ``NotImplementedError`` naming the slice that brings it."""
        for value, what in (
            (spec_k, "speculative decoding (spec_k > 0)"),
            (prefill_chunk, "chunked prefill (prefill_chunk > 0)"),
        ):
            if value:
                raise NotImplementedError(f"{what} comes with the paged verify kernel in a later slice")
        if policy is not None:
            raise NotImplementedError("the serving resilience policy comes in a later slice")
        if tenants is not None:
            raise NotImplementedError("multi-tenant serving comes in a later slice")
        del spec_ngram  # only meaningful with spec_k > 0
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
        self.gauge_prefix = GAUGE_PREFIX

        self.allocator = PagedBlockAllocator(
            self.num_blocks, self.block_size, prefix_caching=prefix_caching
        )
        self.scheduler = InflightScheduler(self.num_slots, self.allocator)
        self.stats = ServingStats()
        self._lock = threading.Lock()

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
        the values it already holds (same tokens, same weights)."""
        n, P = rows.shape[0], cont["k"][0].shape[2]
        BS = self.block_size
        pos = np.arange(P)[None, :] - (P - lens[:, None])  # logical position, <0 on padding
        keep = pos >= 0
        pos_c = np.clip(pos, 0, self.max_blocks_per_seq * BS - 1)
        blk = np.take_along_axis(rows, pos_c // BS, axis=1)
        flat = self._to_device((blk * BS + pos_c % BS)[keep].astype(np.int64))
        src = self._to_device(keep.reshape(-1))
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
    ) -> int:
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"engine max_seq_len {self.max_seq_len}"
            )
        worst = self.allocator.blocks_needed(len(prompt) + max_new_tokens)
        if worst > self.num_blocks - 1:
            raise RequestTooLarge(
                f"request needs {worst} KV blocks worst-case but the pool "
                f"holds {self.num_blocks - 1}: it can never be admitted"
            )
        return self.scheduler.submit(
            prompt, max_new_tokens, eos_token_id=self.eos_token_id,
            stop_sequences=stop_sequences,
        )

    def cancel(self, uid: int) -> bool:
        return self.scheduler.cancel(uid)

    def attach_island(self, island) -> None:
        raise NotImplementedError("generation islands come with the fleet slice")

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
        self._tables_dirty = True

    def _admit(self) -> List[Request]:
        """One admission round: reap cancels, place pending requests, run
        bucketed prefills, pack pools, sample each new sequence's first
        token. Returns requests that finished during admission (a first
        token can already be eos)."""
        finished: List[Request] = []
        for slot in self.scheduler.reap_cancelled():
            self._free_slot_state(slot)
        placements = self.scheduler.admissions()
        if not placements:
            return finished
        # group by bucketed prefill length so one wave runs per bucket pair;
        # prefill covers prompt + generated-so-far (re-admissions)
        by_bucket: Dict[int, List[Tuple[int, Request, List[int]]]] = {}
        for slot, req in placements:
            ids_full = req.prefill_ids
            by_bucket.setdefault(
                pad_to_bucket(len(ids_full), PREFILL_LEN_BUCKETS), []
            ).append((slot, req, ids_full))
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
                self._pending_tok[slot] = tok_np[i]
                done = self.scheduler.on_token(slot, int(tok_np[i]))
                if done is not None:
                    finished.append(done)
                    self._free_slot_state(slot)
        return finished

    def _push_mirrors(self) -> None:
        """Push the host table/len mirrors to the device when stale (as
        copies — see :meth:`_to_device`)."""
        if not self._tables_dirty:
            return
        self.cache["block_tables"] = self._to_device(self._tables)
        self.cache["context_lens"] = self._to_device(self._lens)
        self._tables_dirty = False

    def _decode_round(self) -> List[Request]:
        finished: List[Request] = []
        live = [s for s, r in enumerate(self.scheduler.slots) if r is not None]
        if not live:
            return finished
        self._push_mirrors()
        new_counts = np.array(
            [len(r.generated) if r is not None else 0 for r in self.scheduler.slots],
            np.int32,
        )
        next_tok = self._decode_step(
            self._to_device(self._pending_tok), self._to_device(new_counts)
        )
        # device lens advanced for every slot; mirror so a no-admission next
        # step needs no host->device push
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
        return finished

    def step(self) -> List[Request]:
        """One engine round: admissions (bucketed prefill) + one decode step.
        Returns requests finished during the round."""
        with self._lock:
            t0 = time.perf_counter()
            finished = self._admit()
            t1 = time.perf_counter()
            finished += self._decode_round()
            self.stats.prefill_s += t1 - t0
            self.stats.decode_s += time.perf_counter() - t1
            for req in finished:
                self.stats.finished_requests += 1
                if req.latency_s is not None:
                    gauges.observe(self.gauge_prefix + "request_latency_s", req.latency_s)
        return finished

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
            }
        out["mean_slot_occupancy"] = self.scheduler.mean_slot_occupancy
        out["prefix_cache_hit_rate"] = self.allocator.stats.hit_rate
        out["blocks_in_use"] = float(self.allocator.blocks_in_use)
        out["pending_depth"] = float(self.scheduler.pending_depth)
        return out

    def export_gauges(self) -> None:
        s = self.summary()
        gp = self.gauge_prefix
        for key in (
            "mean_slot_occupancy", "prefix_cache_hit_rate", "blocks_in_use",
            "delivered_tokens", "finished_requests", "pending_depth",
        ):
            gauges.set(gp + ("slot_occupancy" if key == "mean_slot_occupancy" else key), s[key])
        gauges.set(gp + "live_slots", float(self.scheduler.live_slots))

    def close(self) -> None:
        """Clear every gauge under this engine's prefix."""
        gauges.clear(prefix=self.gauge_prefix)
