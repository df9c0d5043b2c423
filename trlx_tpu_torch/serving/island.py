"""Generation-island runtime glue for the Sebulba disaggregated split
(counterpart of ``trlx_tpu/serving/island.py``).

:class:`GenerationIsland` ties the four pieces of the split together around
one :class:`~trlx_tpu_torch.serving.engine.ServingEngine` (or its supervisor):

- the **round gate** — a lock the engine touches at every round boundary and
  the :class:`~trlx_tpu_torch.rollout.broadcast.ChunkedParameterPublisher` takes
  for each per-layer staging install, so a decode round and a chunk install
  never interleave while the broadcast as a whole stays hidden under decode;
- the **atomic version swap** — the engine polls :meth:`poll_swap` at each
  round boundary and installs a newly *committed* broadcast via
  ``set_params`` (one prefix-cache flush per version, never a torn one);
- the **idle-bubble ledgers** — an :class:`~trlx_tpu_torch.obs.islands.IslandLedger`
  per island (engine rounds on the generation side; train steps + publishes
  on the learner side) plus an :class:`~trlx_tpu_torch.obs.overlap.OverlapWindow`
  intersecting broadcast-chunk intervals with decode-busy intervals, the
  measured proof that weight shipping hid under decode;
- the **gauges** — everything above exported under ``serving/island/*``
  (broadcast internals ride ``rollout/broadcast/*`` from the publisher),
  cleared prefix-aware on :meth:`close`.

The island is pure host-side observability + synchronization: it owns no
device state, so it survives supervised engine restarts untouched — the
supervisor re-attaches it to each successor generation, whose first round
re-polls and re-installs the newest committed version.

On one CUDA device the engine's rounds and the publisher's chunk copies are
queued on the same (default) stream from two threads, so the device orders
them: ``broadcast_hidden_frac`` measures overlap on the host clock (chunk
copies issued while a round was in flight), not copy engines running beside
decode kernels. A :class:`~trlx_tpu_torch.fleet.FleetRouter` has no
``attach_island``: an island over a fleet raises, as in the reference.
"""

import threading
import time
from typing import Any, Dict, Optional, Tuple

from trlx_tpu_torch.obs.islands import IslandLedger
from trlx_tpu_torch.obs.overlap import OverlapWindow
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)

#: every island gauge lives under this prefix; cleared prefix-aware on close
ISLAND_GAUGE_PREFIX = "serving/island/"


class GenerationIsland:
    """Host-side runtime for one generation island (module docstring)."""

    def __init__(self, engine: Any, param_selector: Any = None):
        # the published state may be wider than what the engine serves (the
        # trainer publishes its full state_dict incl. the value head; the
        # engine wants the trunk's keys) — the selector maps one onto the other
        self._select = param_selector or (lambda tree: tree)
        # round-boundary sync point shared with the chunked publisher
        self.round_gate = threading.Lock()
        self.gen_ledger = IslandLedger("gen")
        self.learn_ledger = IslandLedger("learn")
        self._overlap = OverlapWindow()
        self.engine = engine
        self.publisher: Any = None
        self._lock = threading.Lock()
        self._swaps = 0
        self._last_lag = 0
        self._broadcast_work_s = 0.0
        engine.attach_island(self)

    def bind_publisher(self, publisher: Any) -> None:
        """Wire the chunked publisher in: the island observes its per-chunk
        intervals and the engine polls it for committed versions.

        Wiring-time only: runs once while the island is assembled, before
        the engine steps or the learner publishes."""
        self.publisher = publisher
        publisher.attach_observer(self)

    def open_window(self) -> float:
        """Open the measurement window on both ledgers (call after warmup so
        compiles never pollute the idle-bubble fractions)."""
        t0 = time.monotonic()
        self.gen_ledger.open_window(t0)
        self.learn_ledger.open_window(t0)
        return t0

    # ------------------------------------------------- hooks from the engine

    def note_round(self, start: float, end: float) -> None:
        """One engine round's busy interval (engine-driving thread)."""
        self.gen_ledger.note_busy(start, end)
        self._overlap.note_decode(start, end)

    def poll_swap(self, last_seen: int) -> Optional[Tuple[int, Any]]:
        """Round-boundary poll: newest *committed* ``(version, params)`` if
        newer than ``last_seen``, else None. Counting happens here so swap
        count and version lag are observable per island."""
        if self.publisher is None:
            return None
        upd = self.publisher.poll_update(last_seen)
        if upd is not None:
            with self._lock:
                self._swaps += 1
                self._last_lag = upd[0] - max(int(last_seen), -1)
            return upd[0], self._select(upd[1])
        return None

    # ---------------------------------------------- hooks from the publisher

    def note_broadcast_chunk(self, start: float, end: float) -> None:
        """One broadcast chunk's busy interval (learner/publisher thread)."""
        self._overlap.note_work(start, end)
        with self._lock:
            self._broadcast_work_s += max(0.0, end - start)

    # ------------------------------------------------ hooks from the learner

    def note_learn(self, start: float, end: float) -> None:
        """One unit of learner-island work (train step or publish)."""
        self.learn_ledger.note_busy(start, end)

    # ---------------------------------------------------------------- output

    def broadcast_hidden_fraction(self) -> float:
        """Fraction of broadcast-chunk time that ran inside decode-busy
        intervals — 1.0 means weight shipping was fully hidden under decode."""
        with self._lock:
            work = self._broadcast_work_s
        if work <= 0.0:
            return 1.0
        return min(1.0, self._overlap.overlapped_s / work)

    def summary(self) -> Dict[str, float]:
        now = time.monotonic()
        with self._lock:
            swaps, lag = self._swaps, self._last_lag
        out = {
            "gen_idle_frac": self.gen_ledger.idle_fraction(now),
            "learn_idle_frac": self.learn_ledger.idle_fraction(now),
            "broadcast_hidden_frac": self.broadcast_hidden_fraction(),
            "swaps": float(swaps),
            "version_lag": float(lag),
        }
        if self.publisher is not None:
            out["published_version"] = float(self.publisher.version)
        out["serving_version"] = float(getattr(self.engine, "serving_version", -1))
        return out

    def export_gauges(self) -> None:
        for key, value in self.summary().items():
            gauges.set(ISLAND_GAUGE_PREFIX + key, value)

    def close(self) -> None:
        """Island shutdown: final gauge export is the caller's job (snapshot
        before close, same contract as ServingEngine.close); here the whole
        ``serving/island/*`` surface is cleared, and the publisher retires
        its ``rollout/broadcast/*`` gauges with it."""
        gauges.clear(prefix=ISLAND_GAUGE_PREFIX)
        if self.publisher is not None:
            self.publisher.close()
