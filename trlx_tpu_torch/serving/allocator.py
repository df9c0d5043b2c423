"""Paged KV block allocator: host-side bookkeeping for the device block pools.

The device holds per-layer K/V pools of ``num_blocks`` fixed-size token
blocks (see ``trlx_tpu_torch/ops/paged_attention.py``). This allocator owns the
*assignment* of physical blocks: which blocks back which live sequence, which
are free, and which carry a reusable prompt prefix.

Invariants (tested in tests/test_torch_serving.py):

- Block 0 is reserved as the null block — unused block-table entries point at
  it so every device gather stays in range. It is never allocated.
- ``blocks_in_use + len(free) + len(cached_free) == num_blocks - 1`` always.
- A sequence's write frontier is never inside a shared block: only FULL
  prompt blocks are ever shared (keyed on the chain hash of their token
  ids), and decode writes start at ``prompt_len``, which lies either in the
  exclusive partial tail block or at the start of a fresh exclusive block.
- Admission reserves the sequence's worst-case block count up front
  (``prompt_len + max_new_tokens``), so a mid-flight allocation failure is
  impossible by construction.

Prefix sharing is ref-counted: a cached full block may back several live
sequences at once. When the last holder frees it, the block parks in an LRU
of ``cached_free`` blocks — contents intact, hash still registered — and is
revived on the next prefix hit or evicted when fresh blocks run out. The
engine flushes the prefix cache whenever the parameter snapshot changes
(stale K/V must never be shared across versions).
"""

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence


@dataclass
class AllocatorStats:
    prefix_lookups: int = 0
    prefix_hits: int = 0  # full blocks served from the prefix cache

    @property
    def hit_rate(self) -> float:
        return self.prefix_hits / max(1, self.prefix_lookups)


@dataclass
class SeqBlocks:
    """One live sequence's physical blocks. ``num_shared`` leading blocks are
    prefix-cache hits (ref-counted, possibly backing other sequences too);
    the rest are exclusive. ``owner`` is the tenant the reservation counts
    against (None = untracked / tenant-blind mode)."""

    blocks: List[int]
    num_shared: int = 0
    owner: Optional[str] = None


class PagedBlockAllocator:
    def __init__(self, num_blocks: int, block_size: int, prefix_caching: bool = True):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the reserved null block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_caching = prefix_caching
        # LIFO free list over blocks 1..num_blocks-1 (block 0 reserved)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refcount: Dict[int, int] = {}
        # chain_hash -> block id, for blocks (live or parked) holding a full
        # prompt-prefix block; _block_hash is the inverse for cleanup
        self._prefix: Dict[int, int] = {}
        self._block_hash: Dict[int, int] = {}
        # refcount-0 blocks with valid cached contents, LRU order
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        # owner -> blocks held across that owner's live sequences. A shared
        # block counts once per holding sequence (sum == sum of refcounts),
        # so quota checks never under-count via prefix sharing.
        self._owner_usage: Dict[Optional[str], int] = {}
        self.stats = AllocatorStats()

    # -- capacity ------------------------------------------------------------

    def blocks_needed(self, total_len: int) -> int:
        return -(-total_len // self.block_size)

    @property
    def blocks_in_use(self) -> int:
        return len(self._refcount)

    @property
    def free_blocks(self) -> int:
        """Blocks allocatable right now (fresh + evictable parked blocks)."""
        return len(self._free) + len(self._cached_free)

    def can_admit(self, total_len: int) -> bool:
        """Conservative: ignores prefix hits, so admission never over-commits."""
        return self.blocks_needed(total_len) <= self.free_blocks

    # -- tenant attribution --------------------------------------------------

    def owner_usage(self, owner: Optional[str]) -> int:
        """Blocks currently held across ``owner``'s live sequences."""
        return self._owner_usage.get(owner, 0)

    def owner_census(self) -> Dict[Optional[str], int]:
        """Snapshot of per-owner block usage (quota checks / scenario
        assertions). Sums to the total refcount — see check_invariants."""
        return dict(self._owner_usage)

    def _charge(self, owner: Optional[str], delta: int) -> None:
        n = self._owner_usage.get(owner, 0) + delta
        if n:
            self._owner_usage[owner] = n
        else:
            self._owner_usage.pop(owner, None)

    def cached_prefix_blocks(self, prompt_tokens: Sequence[int]) -> int:
        """How many leading full blocks of this prompt the prefix cache can
        serve right now (no state change). The scheduler's tenant-affinity
        sort uses it to keep shared-prefix requests adjacent in admission
        waves, before the cache churns their blocks out."""
        if not self.prefix_caching:
            return 0
        hits = 0
        for h in self._chain_hashes(prompt_tokens):
            if h not in self._prefix:
                break
            hits += 1
        return hits

    # -- alloc / free --------------------------------------------------------

    def _pop_fresh(self) -> int:
        if self._free:
            return self._free.pop()
        # evict the least-recently-parked cached block
        block, _ = self._cached_free.popitem(last=False)
        h = self._block_hash.pop(block)
        del self._prefix[h]
        return block

    def _chain_hashes(self, prompt_tokens: Sequence[int]) -> List[int]:
        """One hash per FULL block of the prompt, each folding in the chain
        before it (a block is only shareable when its entire prefix matches)."""
        hashes = []
        h = 0
        bs = self.block_size
        for start in range(0, len(prompt_tokens) - bs + 1, bs):
            h = hash((h, tuple(prompt_tokens[start:start + bs])))
            hashes.append(h)
        return hashes

    def allocate(
        self,
        prompt_tokens: Sequence[int],
        max_total_len: int,
        owner: Optional[str] = None,
    ) -> Optional[SeqBlocks]:
        """Reserve blocks covering ``max_total_len`` tokens, sharing leading
        full prompt blocks through the prefix cache. Returns None when the
        pool can't guarantee the reservation (caller keeps the request
        pending)."""
        if max_total_len < len(prompt_tokens):
            raise ValueError("max_total_len must cover the prompt")
        need = self.blocks_needed(max_total_len)
        if need > self.free_blocks:
            return None
        blocks: List[int] = []
        num_shared = 0
        if self.prefix_caching:
            for h in self._chain_hashes(prompt_tokens):
                self.stats.prefix_lookups += 1
                block = self._prefix.get(h)
                if block is None:
                    break
                self.stats.prefix_hits += 1
                if block in self._cached_free:  # revive a parked block
                    del self._cached_free[block]
                    self._refcount[block] = 1
                else:
                    self._refcount[block] += 1
                blocks.append(block)
                num_shared += 1
        hashes = self._chain_hashes(prompt_tokens) if self.prefix_caching else []
        while len(blocks) < need:
            block = self._pop_fresh()
            self._refcount[block] = 1
            i = len(blocks)
            if i < len(hashes):
                # a freshly-written full prompt block becomes shareable, unless
                # that chain hash is already registered to another block (two
                # identical prompts admitted in one wave: both keep their own
                # copy; only the first registers)
                h = hashes[i]
                if h not in self._prefix:
                    self._prefix[h] = block
                    self._block_hash[block] = h
            blocks.append(block)
        self._charge(owner, len(blocks))
        return SeqBlocks(blocks=blocks, num_shared=num_shared, owner=owner)

    def extend(self, seq: SeqBlocks, total_len: int) -> bool:
        """Grow a live sequence's reservation to cover ``total_len`` tokens
        (optimistic-admission mode: blocks are allocated as the sequence
        grows instead of worst-case up front). Appends exclusive fresh
        blocks only — the write frontier never enters a shared block, and a
        decode-time block is never prefix-registered. Returns False without
        allocating anything when the pool cannot cover the growth (the
        engine's KV-pressure preemption path takes over).

        Speculative lookahead: with ``serving.spec_k > 0`` the engine calls
        this with ``total_len = lens + spec_k + 1`` (clamped to the
        sequence's hard cap) BEFORE the verify round, so all K+1 in-flight
        draft positions have real blocks. The clamp means positions past the
        cap are intentionally uncovered — the verify write drops them
        (``write_paged_kv_multi``), and the request finishes at the cap
        before any such position could become valid. Worst-case admission
        (no policy) needs no per-round call at all: the up-front
        ``prompt + max_new`` reservation already covers every position the
        accept rule can validate."""
        need = self.blocks_needed(total_len) - len(seq.blocks)
        if need <= 0:
            return True
        if need > self.free_blocks:
            return False
        for _ in range(need):
            block = self._pop_fresh()
            self._refcount[block] = 1
            seq.blocks.append(block)
        self._charge(seq.owner, need)
        return True

    def free(self, seq: SeqBlocks) -> None:
        """Release a sequence's reservation (finish, stop-sequence, or
        cancel): decref every block; blocks reaching refcount 0 either park in
        the prefix LRU (registered full prompt blocks) or return to the free
        list."""
        self._charge(seq.owner, -len(seq.blocks))
        for block in seq.blocks:
            rc = self._refcount.get(block)
            if rc is None:
                raise ValueError(f"double free of block {block}")
            if rc > 1:
                self._refcount[block] = rc - 1
                continue
            del self._refcount[block]
            if block in self._block_hash:
                self._cached_free[block] = None  # park, contents reusable
                self._cached_free.move_to_end(block)
            else:
                self._free.append(block)
        seq.blocks = []

    def flush_prefix_cache(self) -> None:
        """Drop every registered prefix (parameter snapshot changed: cached
        K/V is stale). Live blocks stay live but stop being shareable; parked
        blocks return to the free list."""
        for block in list(self._cached_free):
            self._free.append(block)
        self._cached_free.clear()
        self._prefix.clear()
        self._block_hash.clear()

    def check_invariants(self) -> None:
        """Debug/test hook: the block census must always add up."""
        total = self.blocks_in_use + len(self._free) + len(self._cached_free)
        assert total == self.num_blocks - 1, (
            f"block leak: {self.blocks_in_use} live + {len(self._free)} free "
            f"+ {len(self._cached_free)} parked != {self.num_blocks - 1}"
        )
        assert 0 not in self._refcount and 0 not in self._free, "null block escaped"
        for h, b in self._prefix.items():
            assert self._block_hash.get(b) == h
            assert b in self._refcount or b in self._cached_free
        # tenant attribution census: per-owner holdings must account for
        # exactly the total of all live refcounts (a shared block counts
        # once per holding sequence)
        owner_total = sum(self._owner_usage.values())
        ref_total = sum(self._refcount.values())
        assert owner_total == ref_total, (
            f"owner census drift: {owner_total} charged != {ref_total} held"
        )
        assert all(n > 0 for n in self._owner_usage.values()), "stale owner entry"
