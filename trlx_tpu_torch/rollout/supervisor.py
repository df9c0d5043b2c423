"""Producer supervision: restart a crashed or wedged rollout producer
(counterpart of ``trlx_tpu/rollout/supervisor.py``).

The base :class:`~trlx_tpu_torch.rollout.engine.AsyncRolloutEngine`
contract is deliberately fatal — a producer crash closes the queue and
re-raises from ``collect``. Supervision turns "re-raise fatally" into
"restart with backoff, bounded by a budget".

:class:`ProducerSupervisor` is a drop-in replacement for the engine from the
trainer's point of view (``publisher`` / ``start`` / ``collect`` /
``paused`` / ``running`` / ``stop``), built on three mechanisms:

- **Engine generations.** The supervisor owns an ``engine_factory`` that
  builds a fresh engine sharing the *same* queue, publisher and staleness
  accountant, constructed with ``close_queue_on_death=False`` so a dead
  generation never closes the queue its successor must feed. Restart =
  ``abandon()`` the old generation (set its stop event, never join a wedged
  thread), sleep an exponential backoff (``restart_backoff_base_s``
  doubling up to ``restart_backoff_max_s``), build + start the next one.
  The new producer's first iteration reads ``publisher.latest()`` — that
  *is* the resync: it samples with the freshest published policy.
- **Crash detection at the collect seam.** All recovery runs on the learner
  thread inside :meth:`collect`: the engine's liveness checks raise
  ``RuntimeError``, the supervisor catches it and restarts.
- **Wedge detection.** A wedged producer raises nothing. Two detectors cover
  it: the watchdog's per-heartbeat escalation hook
  (:meth:`~trlx_tpu_torch.obs.watchdog.StallWatchdog.escalate` on
  ``"rollout-producer"``) sets a flag from the watchdog thread, and a
  supervisor-side fallback restarts when ``collect`` has waited
  ``wedge_timeout_s`` with a live-but-silent producer. The trainer installs
  the watchdog with ``train.observability`` (``watchdog_timeout_s > 0``);
  without it the fallback timer is the only wedge detector.

The restart budget fails closed: exceeding ``max_producer_restarts`` writes
a diagnostics bundle (gauges, restart history, thread stacks) and raises
:class:`ProducerRestartBudgetExceeded` with the bundle path in the message.
Every restart increments the ``resilience/restarts`` gauge.
"""

import time
import threading
from typing import Any, Callable, Dict, List, Optional

from trlx_tpu_torch.obs import watchdog
from trlx_tpu_torch.rollout.engine import PRODUCER_HEARTBEAT, AsyncRolloutEngine
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)


class ProducerRestartBudgetExceeded(RuntimeError):
    """Restart budget exhausted; the message carries the diagnostics bundle path."""


class ProducerSupervisor:
    """Self-healing wrapper around generations of rollout engines (module docs).

    Single-consumer by design: ``collect``/``stop`` run on the learner
    thread; the only cross-thread touch is the watchdog escalation setting
    ``_wedge_evt``.
    """

    def __init__(
        self,
        engine_factory: Callable[[], AsyncRolloutEngine],
        max_restarts: int = 5,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        wedge_timeout_s: Optional[float] = 600.0,
        diagnostics_dir: str = "diagnostics",
        heartbeat: str = PRODUCER_HEARTBEAT,
    ):
        self._factory = engine_factory
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.wedge_timeout_s = None if wedge_timeout_s is None else float(wedge_timeout_s)
        self.diagnostics_dir = diagnostics_dir
        self._heartbeat = heartbeat
        self._engine: Optional[AsyncRolloutEngine] = None
        self._abandoned: List[AsyncRolloutEngine] = []
        self._wedge_evt = threading.Event()
        self.restarts = 0
        self.restart_history: List[Dict[str, Any]] = []
        # drain stats of abandoned generations, folded into stop()'s summary
        self._dead_produced = 0
        self._dead_dropped_shutdown = 0

    # ---------------------------------------------------------------- lifecycle

    def start(self):
        if self._engine is not None:
            raise RuntimeError("supervisor already started")
        self._engine = self._factory()
        self._engine.start()
        # watchdog escalation: a stale producer heartbeat becomes a restart
        # request, not just a stack dump. The callback must return fast (it
        # runs on the watchdog thread): set the flag, let collect() act on it.
        watchdog.escalate(self._heartbeat, self._on_stall)

    def _on_stall(self, name: str, age: float):
        logger.warning(
            f"watchdog escalation: heartbeat {name!r} stale for {age:.1f}s — "
            f"flagging producer as wedged for supervised restart"
        )
        self._wedge_evt.set()

    def stop(self, timeout: Optional[float] = 30.0) -> dict:
        """Stop the current generation and return aggregated drain stats."""
        watchdog.escalate(self._heartbeat, None)
        engine = self._engine
        self._engine = None
        if engine is None:
            return {"producer_restarts": self.restarts}
        try:
            stats = engine.stop(timeout)
        except RuntimeError as e:
            # a generation that died right before shutdown is not a *shutdown*
            # failure — report the drain honestly instead of re-raising
            logger.warning(f"supervised producer was dead at stop(): {e}")
            stats = engine.summary()
            stats["leftover"] = engine.queue.qsize()
            engine.queue.close()
        for old in self._abandoned:
            old.join(timeout=1.0)  # best effort; wedged daemons linger
        stats["produced"] += self._dead_produced
        stats["dropped_shutdown"] += self._dead_dropped_shutdown
        stats["producer_restarts"] = self.restarts
        return stats

    @property
    def publisher(self):
        return self._require_engine().publisher

    @property
    def running(self) -> bool:
        return self._engine is not None and self._engine.running

    def paused(self):
        return self._require_engine().paused()

    def summary(self) -> dict:
        stats = self._require_engine().summary()
        stats["produced"] += self._dead_produced
        stats["dropped_shutdown"] += self._dead_dropped_shutdown
        stats["producer_restarts"] = self.restarts
        return stats

    def _require_engine(self) -> AsyncRolloutEngine:
        if self._engine is None:
            raise RuntimeError("supervisor not started")
        return self._engine

    # ------------------------------------------------------------------ restart

    def _restart(self, reason: str, cause: Optional[BaseException] = None):
        self.restarts += 1
        gauges.set("resilience/restarts", float(self.restarts))
        if self.restarts > self.max_restarts:
            from trlx_tpu_torch.resilience.health import write_diagnostics_bundle

            bundle = write_diagnostics_bundle(
                self.diagnostics_dir,
                kind="producer-restart-budget",
                extra={
                    "restart_history": self.restart_history,
                    "last_reason": reason,
                    "max_restarts": self.max_restarts,
                },
            )
            raise ProducerRestartBudgetExceeded(
                f"rollout producer restart budget exhausted "
                f"({self.max_restarts} restarts); last failure: {reason}; "
                f"diagnostics bundle: {bundle}"
            ) from cause
        backoff = min(self.backoff_base_s * (2 ** (self.restarts - 1)), self.backoff_max_s)
        self.restart_history.append({"time": time.time(), "reason": reason, "backoff_s": backoff})
        logger.warning(
            f"restarting rollout producer ({self.restarts}/{self.max_restarts}, "
            f"backoff {backoff:.2f}s) after: {reason}"
        )
        old = self._require_engine()
        old.abandon()
        dead_stats = old.summary()
        self._dead_produced += dead_stats["produced"]
        self._dead_dropped_shutdown += dead_stats["dropped_shutdown"]
        self._abandoned.append(old)
        self._wedge_evt.clear()
        time.sleep(backoff)
        # the successor's first produce reads publisher.latest(): the restart
        # resyncs to the freshest policy instead of replaying a stale snapshot
        self._engine = self._factory()
        self._engine.start()

    # ------------------------------------------------------------------ learner

    def collect(self, n: int, learner_version: int, timeout: Optional[float] = None) -> List[Any]:
        """Pop ``n`` admitted elements, restarting the producer as needed.

        The caller's ``timeout`` bounds the *whole* collect including
        restarts and backoff; ``TimeoutError`` is not a producer failure and
        consumes no restart budget.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = []
        last_progress = time.monotonic()
        while len(out) < n:
            if self._wedge_evt.is_set():
                self._restart("watchdog escalation: stale producer heartbeat")
                last_progress = time.monotonic()
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"collected {len(out)}/{n} rollouts within {timeout}s "
                    f"(after {self.restarts} producer restarts)"
                )
            slice_s = 1.0 if self.wedge_timeout_s is None else max(0.05, self.wedge_timeout_s / 4)
            if remaining is not None:
                slice_s = min(slice_s, remaining)
            engine = self._require_engine()
            try:
                # one element per call: engine.collect discards its partial
                # batch when its timeout fires, so short supervision slices
                # must never ask for more than they can lose
                got = engine.collect(1, learner_version, timeout=slice_s)
            except TimeoutError:
                waited = time.monotonic() - last_progress
                if self.wedge_timeout_s is not None and waited > self.wedge_timeout_s:
                    self._restart(
                        f"wedge timeout: producer alive but silent for {waited:.1f}s "
                        f"while the learner waited (wedge_timeout_s={self.wedge_timeout_s})"
                    )
                    last_progress = time.monotonic()
                continue
            except RuntimeError as e:
                if engine.queue.closed:
                    raise  # external shutdown, not a producer fault
                self._restart(f"producer died: {e}", cause=e)
                last_progress = time.monotonic()
                continue
            out.extend(got)
            last_progress = time.monotonic()
            # delivery disproves a pending wedge escalation: the watchdog may
            # have flagged the producer just as it recovered, and acting on
            # that stale flag would abandon a healthy generation and burn a
            # restart. Queue delivery IS the producer's liveness proof.
            self._wedge_evt.clear()
        return out
