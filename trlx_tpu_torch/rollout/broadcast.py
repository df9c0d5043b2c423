"""Chunked, decode-overlapped parameter broadcast for disaggregated islands
(counterpart of ``trlx_tpu/rollout/broadcast.py``).

The monolithic :class:`~trlx_tpu_torch.rollout.publisher.ParameterPublisher`
copies the whole state in one shot, which on a generation island means one
long transfer the decode loop must hide all at once. This module streams
the state **layer by layer** while decode rounds keep running, stamps every
broadcast with a version-numbered :class:`BroadcastManifest`, and only when
the last chunk has landed commits the assembled state in one atomic swap.
Consumers (the serving engine's round-boundary poll,
:meth:`trlx_tpu_torch.serving.engine.ServingEngine.step`) can therefore
never observe a torn version: ``latest``/``poll_update`` hand out committed
snapshots only, and a publisher that dies mid-broadcast leaves the previous
version in place (its burned version number shows in the
``rollout/broadcast/aborted`` gauge, nothing else).

The port publishes ``state_dict``s: flat mappings with dotted keys
(``embed_tokens.embedding``, ``layers_3.attn.q_proj.kernel``, ...; the
trainer's full state adds ``transformer.``). :func:`layer_chunks` groups the
keys by their first dotted component, in first-appearance order, which
gives the reference's chunks of a nested tree: ``embed_tokens``, ...,
``layers_<i>``, ..., ``ln_f`` for a trunk.

Round-boundary synchronization happens through an optional ``round_gate``
lock shared with the generation island: the publisher takes it only for the
brief per-chunk staging install, so a decode round and a chunk install never
interleave but the broadcast as a whole stays hidden under decode. The
seeded regression ``TRLX_ISLAND_SEED_REGRESSION=blocking_broadcast`` inverts
exactly that property (the publisher holds the gate for the entire
broadcast), which must make the idle-bubble proof fail.

Streams: the default copy (``detach().clone()`` of each tensor) runs on the
publishing thread's current CUDA stream, and the engine's swap
(``load_state_dict``) on the engine thread's. Both are the device's default
stream unless a caller sets another, so the device orders every chunk copy
before the swap that reads it without events.
"""

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.rollout.publisher import _default_copy
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)

#: every broadcast gauge lives under this prefix; cleared prefix-aware on
#: island shutdown (GaugeRegistry.clear)
BROADCAST_GAUGE_PREFIX = "rollout/broadcast/"


def _tree_nbytes(tree: Any) -> int:
    """Bytes of every tensor (or array) leaf of a (nested) mapping."""
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if hasattr(tree, "element_size"):
        return int(tree.numel() * tree.element_size())
    return int(getattr(tree, "nbytes", 0) or 0)


def layer_chunks(tree: Any, chunk_layers: int = 1) -> List[Tuple[str, Dict[str, Any]]]:
    """Split a ``state_dict`` into named broadcast chunks.

    A mapping splits by the first dotted component of its keys (for a
    transformer trunk that is per layer: ``embed_tokens``, ``layers_0`` …
    ``layers_N``, ``ln_f``; a key without a dot is its own group), grouping
    ``chunk_layers`` consecutive groups per chunk; anything else is a single
    ``"all"`` chunk. Group order is first appearance in the mapping, so the
    chunking is deterministic for a fixed state and reassembly by key is
    exact regardless of chunk grouping.
    """
    if not isinstance(tree, dict) or not tree:
        return [("all", tree)]
    groups: Dict[str, List[str]] = {}
    for key in tree:
        groups.setdefault(str(key).split(".", 1)[0], []).append(key)
    names = list(groups)
    k = max(1, int(chunk_layers))
    out: List[Tuple[str, Dict[str, Any]]] = []
    for i in range(0, len(names), k):
        group = names[i:i + k]
        name = group[0] if len(group) == 1 else f"{group[0]}..{group[-1]}"
        out.append((name, {key: tree[key] for g in group for key in groups[g]}))
    return out


@dataclass(frozen=True)
class BroadcastManifest:
    """Version-stamped description of one chunked broadcast: what was shipped
    and how big each chunk was. Committed alongside the assembled snapshot so
    a consumer can attribute the version it swapped to."""

    version: int
    chunk_names: Tuple[str, ...]
    chunk_bytes: Tuple[int, ...]

    @property
    def total_bytes(self) -> int:
        return sum(self.chunk_bytes)

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_names)


class ChunkedParameterPublisher:
    """Drop-in for :class:`~trlx_tpu_torch.rollout.publisher.ParameterPublisher`
    (same ``publish``/``latest``/``version`` surface) that broadcasts
    layer-by-layer with an atomic commit (module docstring).

    Single-writer (the learner thread calls ``publish``), many-reader
    (``latest``/``poll_update`` from the producer and engine threads). The
    torn-version invariant is structural: the staging dict is private to the
    in-flight ``publish`` call, and the committed ``(version, snapshot,
    manifest)`` triple only ever changes under ``_lock`` after the last chunk
    landed.
    """

    def __init__(
        self,
        copy_fn: Optional[Callable[[Any], Any]] = None,
        chunk_layers: int = 1,
        chunk_pause_s: float = 0.0,
        round_gate: Optional[threading.Lock] = None,
    ):
        self._copy = copy_fn or _default_copy
        self.chunk_layers = max(1, int(chunk_layers))
        self.chunk_pause_s = float(chunk_pause_s)
        self._gate = round_gate
        seed_reg = os.environ.get("TRLX_ISLAND_SEED_REGRESSION", "")
        if seed_reg not in ("", "blocking_broadcast"):
            raise ValueError(
                f"TRLX_ISLAND_SEED_REGRESSION={seed_reg!r}: only "
                f"'blocking_broadcast' is defined"
            )
        self._blocking = seed_reg == "blocking_broadcast"
        if self._blocking:
            logger.warning(
                "TRLX_ISLAND_SEED_REGRESSION=blocking_broadcast: the publisher "
                "will hold the round gate for entire broadcasts"
            )
        self._lock = threading.Lock()
        self._version = -1
        self._snapshot: Any = None
        self._manifest: Optional[BroadcastManifest] = None
        self._next_version = 0
        self._chunks_sent = 0
        self._bytes_sent = 0
        self._aborted = 0
        self._last_bytes_s = 0.0
        self._last_broadcast_s = 0.0
        # island observability hook: object with note_broadcast_chunk(t0, t1)
        self._observer: Any = None

    # --------------------------------------------------------------- wiring

    def attach_observer(self, observer: Any) -> None:
        """Register the generation island (or any object with a
        ``note_broadcast_chunk(t0, t1)`` method) to receive per-chunk busy
        intervals for the broadcast-hidden-under-decode ledger.

        Wiring-time only: called once while the island is assembled, before
        the learner thread ever publishes — no publish can be in flight."""
        self._observer = observer

    # -------------------------------------------------------------- publish

    def publish(self, params: Any) -> int:
        """Broadcast ``params`` chunk-by-chunk and atomically commit the new
        version; returns it. On any failure mid-broadcast the previous
        committed version stays visible and the in-flight version number is
        burned (monotonicity is preserved; the abort is counted)."""
        with self._lock:
            version = self._next_version
            self._next_version += 1
        named = layer_chunks(params, self.chunk_layers)
        staged = {}
        chunk_bytes: List[int] = []
        gate = self._gate
        held = False
        t_start = time.monotonic()
        try:
            if self._blocking and gate is not None:
                # seeded regression: the whole broadcast squats on the round
                # gate, serializing decode behind it — the exact failure the
                # idle-bubble proof must catch
                gate.acquire()
                held = True
            for i, (name, subtree) in enumerate(named):
                chaos.fail_if_armed(
                    "broadcast-chunk", f"chunk {name!r} of version {version}"
                )
                t0 = time.monotonic()
                copied = self._copy(subtree)
                if gate is not None and not held:
                    # per-chunk install at a round boundary: a decode round
                    # and a staging install never interleave, but the gate is
                    # released between chunks so rounds keep flowing
                    with gate:
                        staged[name] = copied
                else:
                    staged[name] = copied
                t1 = time.monotonic()
                chunk_bytes.append(_tree_nbytes(copied))
                if self._observer is not None:
                    self._observer.note_broadcast_chunk(t0, t1)
                if self.chunk_pause_s > 0 and i + 1 < len(named):
                    time.sleep(self.chunk_pause_s)
        except BaseException:
            with self._lock:
                self._aborted += 1
                aborted = self._aborted
            gauges.set(BROADCAST_GAUGE_PREFIX + "aborted", float(aborted))
            raise
        finally:
            if held:
                gate.release()
        manifest = BroadcastManifest(version, tuple(n for n, _ in named), tuple(chunk_bytes))
        if isinstance(params, dict) and params:
            assembled: Any = {}
            for name, _ in named:
                assembled.update(staged[name])
        else:
            assembled = staged["all"]
        wall = max(time.monotonic() - t_start, 1e-9)
        with self._lock:
            # the atomic swap: version, snapshot and manifest move together,
            # and only after every chunk landed
            self._version = version
            self._snapshot = assembled
            self._manifest = manifest
            self._chunks_sent += manifest.num_chunks
            self._bytes_sent += manifest.total_bytes
            self._last_broadcast_s = wall
            self._last_bytes_s = manifest.total_bytes / wall
        self._export_gauges()
        return version

    # --------------------------------------------------------------- readers

    def latest(self) -> Tuple[int, Any]:
        """Newest committed ``(version, params)``; raises before the first
        commit (mirrors ParameterPublisher)."""
        with self._lock:
            if self._version < 0:
                raise RuntimeError(
                    "ChunkedParameterPublisher.latest() before first commit"
                )
            return self._version, self._snapshot

    def poll_update(self, last_seen: int) -> Optional[Tuple[int, Any]]:
        """Newest committed ``(version, params)`` if newer than ``last_seen``,
        else None. Also records the observed version lag (how many commits
        behind the poller was) in the ``rollout/broadcast/version_lag``
        gauge."""
        with self._lock:
            if self._version < 0 or self._version <= last_seen:
                return None
            lag = self._version - max(int(last_seen), -1)
            out = (self._version, self._snapshot)
        gauges.set(BROADCAST_GAUGE_PREFIX + "version_lag", float(lag))
        return out

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def manifest(self) -> Optional[BroadcastManifest]:
        """Manifest of the committed version (None before the first)."""
        with self._lock:
            return self._manifest

    # ------------------------------------------------------------------ obs

    def stats(self) -> dict:
        with self._lock:
            return {
                "version": self._version,
                "chunks_sent": self._chunks_sent,
                "bytes_sent": self._bytes_sent,
                "aborted": self._aborted,
                "last_broadcast_s": self._last_broadcast_s,
                "last_bytes_s": self._last_bytes_s,
            }

    def _export_gauges(self) -> None:
        s = self.stats()
        gauges.set(BROADCAST_GAUGE_PREFIX + "version", float(s["version"]))
        gauges.set(BROADCAST_GAUGE_PREFIX + "chunks_sent", float(s["chunks_sent"]))
        gauges.set(BROADCAST_GAUGE_PREFIX + "bytes_s", s["last_bytes_s"])
        gauges.set(BROADCAST_GAUGE_PREFIX + "broadcast_s", s["last_broadcast_s"])
        gauges.set(BROADCAST_GAUGE_PREFIX + "aborted", float(s["aborted"]))

    def close(self) -> None:
        """Retire this publisher's observability surface (prefix-aware clear,
        same contract as ServingEngine.close)."""
        gauges.clear(prefix=BROADCAST_GAUGE_PREFIX)
