"""The async rollout producer loop (counterpart of
``trlx_tpu/rollout/engine.py``).

One daemon thread runs ``produce_fn(params, version) -> [PPORLElement]`` —
the trainer's generate -> reward -> score chunk pipeline, run on a published
parameter snapshot — in a loop:

    snapshot = publisher.latest()        # freshest policy the learner published
    elements = produce_fn(*snapshot)     # device decode + scoring, host reward
    tag each element with the snapshot's policy version
    queue.put(elements)                  # blocks on backpressure / watermarks

The learner, on the main thread, calls :meth:`AsyncRolloutEngine.collect`
to pop experience, runs staleness admission, and keeps training while the
producer refills the queue. Both threads queue their CUDA work on the same
(default) stream.

Coordination rules (enforced here, relied on by the trainer):

- ``paused()`` grabs the lock the producer holds across one produce
  iteration; the trainer wraps ``evaluate()`` in it.
- A producer crash closes the queue and re-raises from ``collect`` /
  ``stop``, so a dead producer never silently starves the learner. Under a
  :class:`~trlx_tpu_torch.rollout.supervisor.ProducerSupervisor` the engine
  is built with ``close_queue_on_death=False``: the crash still re-raises
  from ``collect``, but the shared queue stays open so a *replacement*
  engine can keep feeding it (the supervisor catches the raise, ``abandon``s
  this engine and restarts).
- ``stop()`` closes the queue (waking a blocked ``put``), joins the thread,
  and reports drain statistics; no thread is left after ``learn()``.
  Elements abandoned mid-``put`` during shutdown count as
  ``dropped_shutdown``, so the drain ledger balances:
  ``produced == consumed + dropped_stale + leftover + dropped_shutdown``.

The producer beats the watchdog heartbeat :data:`PRODUCER_HEARTBEAT` after
each publish and between bounded put retries, and carries the chaos sites
``rollout-producer`` (the producer dies) and ``producer-wedge`` (it stops
beating and parks until abandoned or stopped).
"""

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from trlx_tpu_torch.obs import span, watchdog
from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.rollout.publisher import ParameterPublisher
from trlx_tpu_torch.rollout.queue import ExperienceQueue, QueueClosed
from trlx_tpu_torch.rollout.staleness import StalenessAccountant
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)

#: Watchdog heartbeat name for the producer thread.
PRODUCER_HEARTBEAT = "rollout-producer"


def length_bucketed(batches: Iterator[Dict[str, list]], lookahead: int) -> Iterator[Dict[str, list]]:
    """Reorder a prompt-batch stream so each batch holds similar-length prompts.

    The one-shot generate path pads every batch to the length bucket of its
    longest prompt, so one straggler makes the whole batch pay its prefill and
    per-token attention cost. This wrapper pulls a window of ``lookahead``
    batches, stable-sorts the window's prompts by token length, and re-chunks
    them into batches of the original sizes — tight buckets without changing
    the set of prompts drawn (the serving engine's admission rounds do the
    same sort slot-by-slot; this is the cheap precursor for the generate path).

    Deterministic and replay-safe: the reorder is a pure function of the
    incoming window, and k batches in -> k batches out, so the auto-resume
    fast-forward (which counts batches drawn) lands on the same stream
    position. ``lookahead <= 1`` yields the stream unchanged.
    """
    if lookahead <= 1:
        yield from batches
        return
    batches = iter(batches)
    while True:
        window = []
        try:
            for _ in range(lookahead):
                window.append(next(batches))
        except StopIteration:
            pass
        if not window:
            return
        sizes = [len(b["input_ids"]) for b in window]
        keys = list(window[0].keys())
        flat = {k: [v for b in window for v in b[k]] for k in keys}
        order = sorted(range(len(flat["input_ids"])), key=lambda i: len(flat["input_ids"][i]))
        start = 0
        for size in sizes:
            idx = order[start:start + size]
            start += size
            yield {k: [flat[k][i] for i in idx] for k in keys}
        if len(window) < lookahead:  # underlying stream ended mid-window
            return


class AsyncRolloutEngine:
    """Continuously-running experience producer decoupled from the learner."""

    def __init__(
        self,
        produce_fn: Callable[[Any, int], List[Any]],
        publisher: ParameterPublisher,
        queue: ExperienceQueue,
        accountant: StalenessAccountant,
        name: str = "rollout-producer",
        close_queue_on_death: bool = True,
    ):
        self._produce = produce_fn
        self.publisher = publisher
        self.queue = queue
        self.accountant = accountant
        self._name = name
        # True (default, unsupervised): a producer crash closes the queue so
        # the learner unblocks and the error re-raises. False (supervised):
        # the queue is shared with successor engines and must outlive us.
        self._close_queue_on_death = close_queue_on_death
        self._abandoned = False
        self._stop_evt = threading.Event()
        # held by the producer across one produce iteration; evaluate() takes
        # it to pause production while it shares tokenizer/RNG/generate caches
        self._pause_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # guards the producer-written counters below; deliberately separate
        # from _pause_lock so stats readers on the learner thread never wait
        # out a full produce iteration
        self._stats_lock = threading.Lock()
        self._busy_time = 0.0
        self._wall_start: Optional[float] = None
        self._produced = 0
        self._dropped_shutdown = 0

    # ---------------------------------------------------------------- lifecycle

    def start(self):
        # the handle/counters are guarded: running/summary()/overlap_fraction()
        # are read from the learner thread while this engine starts elsewhere
        with self._stats_lock:
            if self._thread is not None:
                raise RuntimeError("engine already started")
            self._wall_start = time.monotonic()
            thread = threading.Thread(target=self._loop, name=self._name, daemon=True)
            self._thread = thread
        # register the heartbeat before the first produce: a producer wedged on
        # its very first iteration must still be detectable
        watchdog.beat(PRODUCER_HEARTBEAT)
        thread.start()

    def _loop(self):
        try:
            while not self._stop_evt.is_set():
                # chaos site "producer-wedge": simulate a hang (stuck reward
                # RPC, wedged decode) — no heartbeats, no exception, no
                # progress, until abandoned or shut down. Outside the pause
                # lock so a wedged producer cannot deadlock evaluate(); the
                # supervisor's wedge timer (or the watchdog's escalation) is
                # what recovers from this.
                if chaos.should_fail("producer-wedge"):
                    logger.warning(
                        "chaos: rollout producer wedged at site 'producer-wedge' "
                        "(silent, no heartbeats) — waiting for abandon/stop"
                    )
                    self._stop_evt.wait()
                    break
                with self._pause_lock:
                    if self._stop_evt.is_set():
                        break
                    # resilience fault site: kills the producer to prove the
                    # close-on-death / re-raise-from-collect contract
                    chaos.fail_if_armed("rollout-producer")
                    version, params = self.publisher.latest()
                    t0 = time.monotonic()
                    elements = self._produce(params, version)
                    with self._stats_lock:
                        self._busy_time += time.monotonic() - t0
                        self._produced += len(elements)
                tagged = [e.replace(policy_version=version) for e in elements]
                # outside the pause lock: backpressure must not block
                # evaluate(). Bounded puts with heartbeats between retries: a
                # gated queue (backpressure working as designed) must not read
                # as a producer stall, and a stop between retries is seen
                delivered = False
                try:
                    with span("queue_put"):
                        while not self._stop_evt.is_set():
                            if self.queue.put(tagged, timeout=5.0):
                                delivered = True
                                break
                            watchdog.beat(PRODUCER_HEARTBEAT)
                except QueueClosed:
                    pass
                if not delivered:
                    # shutdown raced the put: the batch is lost by design, but
                    # it must show up in the drain ledger, not vanish from it
                    with self._stats_lock:
                        self._dropped_shutdown += len(tagged)
                    break
                watchdog.beat(PRODUCER_HEARTBEAT)
                self._export_gauges()
        except QueueClosed:
            pass
        except BaseException as e:  # noqa: B036 — re-raised from collect/stop
            with self._stats_lock:
                self._error = e
            logger.error(f"async rollout producer died: {type(e).__name__}: {e}")
        finally:
            # a dead producer must never leave the learner blocked in get() —
            # except under supervision, where the queue is shared with the
            # replacement engine and collect() detects death by polling
            with self._stats_lock:
                close_queue = self._close_queue_on_death and not self._abandoned
            if close_queue:
                self.queue.close()

    def stop(self, timeout: Optional[float] = 30.0) -> dict:
        """Close the queue, join the producer, return drain statistics."""
        self._stop_evt.set()
        self.queue.close()
        try:
            with self._stats_lock:
                thread = self._thread
            if thread is not None:
                # join OUTSIDE the lock: the producer's finally-clause and the
                # stats/gauge readers must stay live while we wait it out
                thread.join(timeout)
                if thread.is_alive():
                    raise RuntimeError(
                        f"rollout producer failed to stop within {timeout}s"
                    )
                with self._stats_lock:
                    if self._thread is thread:  # re-check under the lock
                        self._thread = None
            with self._stats_lock:
                error = self._error
            if error is not None:
                raise RuntimeError("async rollout producer died") from error
            stats = self.summary()
            stats["leftover"] = self.queue.qsize()
            return stats
        finally:
            # a finished producer must neither page the watchdog nor keep its
            # last gauge values being exported as if still live
            watchdog.unregister(PRODUCER_HEARTBEAT)
            gauges.clear(prefix="rollout/")

    def abandon(self):
        """Give up on this engine without draining it (supervisor restart path).

        Sets the stop event (a wedged-by-chaos or healthy producer exits at
        the next check) but does NOT close the shared queue and does NOT join:
        a genuinely wedged thread cannot be joined, and as a daemon it is
        harmless once abandoned. Its finally-clause is told not to close the
        queue either, so the successor engine keeps feeding the same queue."""
        with self._stats_lock:
            self._abandoned = True
        self._stop_evt.set()

    @property
    def running(self) -> bool:
        with self._stats_lock:
            thread = self._thread
        return thread is not None and thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Best-effort join of the producer thread without ``stop()`` semantics
        (the supervisor reaps abandoned generations this way). Returns whether
        the thread is still alive afterwards."""
        with self._stats_lock:
            thread = self._thread
        if thread is None:
            return False
        thread.join(timeout)
        return thread.is_alive()

    @contextlib.contextmanager
    def paused(self):
        """Hold production across a critical section (e.g. ``evaluate()``)."""
        with self._pause_lock:
            yield

    # ----------------------------------------------------------------- learner

    def collect(self, n: int, learner_version: int, timeout: Optional[float] = None) -> List[Any]:
        """Pop ``n`` staleness-admitted elements for the learner; dropped-stale
        elements are replaced by further pops. Raises if the producer died or
        the queue closed before ``n`` elements could be collected."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = []
        while len(out) < n:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"collected {len(out)}/{n} rollouts within {timeout}s "
                    f"(queue depth {self.queue.qsize()})"
                )
            got = self.queue.get(n - len(out), timeout=1.0 if remaining is None else min(1.0, remaining))
            if not got:
                with self._stats_lock:
                    error = self._error
                if error is not None:
                    raise RuntimeError("async rollout producer died") from error
                if self.queue.closed and self.queue.qsize() == 0:
                    raise RuntimeError(
                        f"experience queue closed after {len(out)}/{n} rollouts"
                    )
                # liveness, not just error state: a producer killed without
                # running its except-clause (or never started) leaves _error
                # unset and the queue open — with timeout=None this loop would
                # otherwise poll an empty queue forever
                if not self.running and not self._stop_evt.is_set() and self.queue.qsize() == 0:
                    raise RuntimeError(
                        f"async rollout producer is not running (no error recorded); "
                        f"collected {len(out)}/{n} rollouts from an empty open queue"
                    )
                continue
            fresh, dropped = self.accountant.admit(got, learner_version)
            if dropped:
                logger.info(
                    f"dropped {dropped} rollouts staler than "
                    f"{self.accountant.max_staleness} (learner v{learner_version})"
                )
            out.extend(fresh)
        self._export_gauges()
        return out

    # ------------------------------------------------------------------ metrics

    def overlap_fraction(self) -> float:
        """Fraction of engine wall-time the producer spent generating — the
        recovered generator utilization (1.0 = fully hidden behind learning)."""
        with self._stats_lock:
            wall_start = self._wall_start
            busy = self._busy_time
        if wall_start is None:
            return 0.0
        wall = max(time.monotonic() - wall_start, 1e-9)
        return min(1.0, busy / wall)

    def summary(self) -> dict:
        q = self.queue.stats()
        s = self.accountant.stats()
        with self._stats_lock:
            produced = self._produced
            dropped_shutdown = self._dropped_shutdown
        return {
            "produced": produced,
            # admitted-to-the-learner count, NOT raw queue pops: with
            # ``leftover`` stamped by stop(), the drain ledger balances as
            # produced == consumed + dropped_stale + leftover + dropped_shutdown
            "consumed": s["admitted"],
            "dropped_stale": s["dropped_stale"],
            "dropped_shutdown": dropped_shutdown,
            "peak_queue_depth": q["peak_depth"],
            "overlap_fraction": self.overlap_fraction(),
            "staleness_mean": s["staleness_mean"],
            "staleness_max": s["staleness_max"],
        }

    def _export_gauges(self):
        q = self.queue.stats()
        s = self.accountant.stats()
        gauges.set("rollout/queue_depth", float(q["depth"]))
        gauges.set("rollout/queue_peak_depth", float(q["peak_depth"]))
        gauges.set("rollout/queue_gated", q["gated"])
        with self._stats_lock:
            produced = self._produced
            dropped_shutdown = self._dropped_shutdown
        gauges.set("rollout/produced", float(produced))
        gauges.set("rollout/dropped_shutdown", float(dropped_shutdown))
        gauges.set("rollout/dropped_stale", float(s["dropped_stale"]))
        gauges.set("rollout/staleness_mean", float(s["staleness_last_mean"]))
        gauges.set("rollout/staleness_max", float(s["staleness_max"]))
        gauges.set("rollout/overlap_fraction", self.overlap_fraction())
