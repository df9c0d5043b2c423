"""Serving supervision: restart a crashed or wedged engine, replay requests
(counterpart of ``trlx_tpu/serving/supervisor.py``).

The :class:`~trlx_tpu_torch.serving.engine.ServingEngine` contract is deliberately
fatal — a failed prefill/decode round raises out of ``step()`` and the device
pools it leaves behind are unusable. Supervision turns that into "rebuild and
replay", the serving analogue of the rollout
:class:`~trlx_tpu_torch.rollout.supervisor.ProducerSupervisor`:

- **Engine generations.** The supervisor owns an ``engine_factory`` building
  a fresh :class:`ServingEngine` (fresh pools, allocator, scheduler). On a
  step failure it exports the dead scheduler's host-side request state
  (:meth:`InflightScheduler.export_state`), sleeps an exponential backoff,
  builds the successor, re-installs the last parameter snapshot, and adopts
  the state — every live and pending request re-enters the new pending queue
  and re-prefills from ``prompt + generated-so-far``. Zero accepted requests
  are lost across a restart; uid continuity is preserved so client-held uids
  stay valid.
- **Crash detection at the step seam.** All recovery runs on the
  engine-driving thread inside :meth:`step`: any exception from the engine
  round (including chaos-injected ``serving-prefill``/``serving-decode``
  faults) is caught and becomes a restart.
- **Wedge detection.** A wedged device loop raises nothing. Two independent
  detectors cover it: the obs watchdog's escalation hook on the
  ``serving-engine`` heartbeat (beaten once per successful round) calls
  :meth:`ServingEngine.request_abort` from the watchdog thread, and a
  supervisor-side per-round wedge timer does the same when the watchdog is
  disabled. An aborted wedge surfaces as
  :class:`~trlx_tpu_torch.serving.policy.EngineWedgedError` and restarts like any
  crash.

The restart budget fails closed: exceeding ``max_restarts`` writes a
diagnostics bundle (:func:`trlx_tpu_torch.resilience.health.write_diagnostics_bundle`:
gauges, restart history, all thread stacks) and raises
:class:`ServingRestartBudgetExceeded` with the bundle path in the message.
Every restart updates the ``serving/restarts`` gauge.

The supervisor is a drop-in for the engine from
:class:`~trlx_tpu_torch.serving.client.GenerationClient`'s point of view
(``submit`` / ``cancel`` / ``step`` / ``run`` / ``drain`` / ``scheduler`` /
``summary``); ``scheduler``/``allocator`` always resolve against the *current*
generation.
"""

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from trlx_tpu_torch.obs.flight import flight
from trlx_tpu_torch.obs.watchdog import watchdog
from trlx_tpu_torch.resilience.health import write_diagnostics_bundle
from trlx_tpu_torch.serving.engine import ServingEngine
from trlx_tpu_torch.serving.scheduler import Request
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)

#: watchdog heartbeat name, beaten once per successful engine round
SERVING_HEARTBEAT = "serving-engine"


class ServingRestartBudgetExceeded(RuntimeError):
    """Restart budget exhausted; the message carries the diagnostics bundle path."""


class ServingSupervisor:
    """Self-healing wrapper around generations of serving engines (module docs).

    One driving thread by design: ``step``/``run``/``drain`` run on the
    engine-driving thread; the only cross-thread touches are producer-side
    ``submit``/``cancel`` (thread-safe on the engine already) and the
    watchdog escalation aborting a wedged step.
    """

    def __init__(
        self,
        engine_factory: Callable[[], ServingEngine],
        max_restarts: int = 3,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 10.0,
        wedge_timeout_s: Optional[float] = 60.0,
        diagnostics_dir: str = "diagnostics",
        heartbeat: str = SERVING_HEARTBEAT,
    ):
        self._factory = engine_factory
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.wedge_timeout_s = None if wedge_timeout_s is None else float(wedge_timeout_s)
        self.diagnostics_dir = diagnostics_dir
        self._heartbeat = heartbeat
        # guards the engine handle: step() swaps it on restart while the
        # watchdog escalation reads it to abort a wedge
        self._lock = threading.Lock()
        self._engine = engine_factory()
        self._params = None
        self._params_set = False
        self._island = None
        self._draining = False
        self.restarts = 0
        self.restart_history: List[Dict[str, Any]] = []
        # a stale serving heartbeat becomes an abort (which unsticks a wedged
        # step into EngineWedgedError), not just a stack dump. The callback
        # runs on the watchdog thread and must return fast.
        watchdog.escalate(self._heartbeat, self._on_stall)

    # ---------------------------------------------------------------- surface

    @property
    def engine(self) -> ServingEngine:
        with self._lock:
            return self._engine

    @property
    def scheduler(self):
        return self.engine.scheduler

    @property
    def allocator(self):
        return self.engine.allocator

    @property
    def stats(self):
        return self.engine.stats

    @property
    def pad_token_id(self) -> int:
        return self.engine.pad_token_id

    @property
    def tenants(self):
        return self.engine.tenants

    @property
    def num_blocks(self) -> int:
        return self.engine.num_blocks

    @property
    def gauge_prefix(self) -> str:
        return self.engine.gauge_prefix

    @property
    def replica_id(self):
        return self.engine.replica_id

    @property
    def num_slots(self) -> int:
        return self.engine.num_slots

    def submit(self, *args, **kwargs) -> int:
        return self.engine.submit(*args, **kwargs)

    def cancel(self, uid: int) -> bool:
        return self.engine.cancel(uid)

    def set_params(self, params) -> None:
        """Swap the parameter snapshot — remembered so a restarted generation
        comes up with the same weights the dead one served."""
        with self._lock:
            self._params = params
            self._params_set = True
            engine = self._engine
        engine.set_params(params)

    def attach_island(self, island) -> None:
        """Attach the generation island, remembered so every restarted
        generation is re-attached: the successor's first round re-polls the
        island's publisher and installs the newest committed broadcast (its
        swap cursor starts at -1, so recovery is a fresh install, never a
        torn one)."""
        with self._lock:
            self._island = island
            engine = self._engine
        engine.attach_island(island)

    @property
    def serving_version(self) -> int:
        return self.engine.serving_version

    def note_overlap(self, decode_busy_s: float, overlapped_s: float) -> None:
        self.engine.note_overlap(decode_busy_s, overlapped_s)

    def summary(self) -> Dict[str, float]:
        out = self.engine.summary()
        with self._lock:
            out["restarts"] = float(self.restarts)
        return out

    def export_gauges(self) -> None:
        engine = self.engine
        engine.export_gauges()
        with self._lock:
            n = self.restarts
        gauges.set(engine.gauge_prefix + "restarts", float(n))

    def close(self) -> None:
        """Unregister the watchdog escalation (a retired supervisor must not
        abort anyone else's engine)."""
        watchdog.escalate(self._heartbeat, None)

    # ---------------------------------------------------------------- recovery

    def _on_stall(self, name: str, age: float):
        logger.warning(
            f"watchdog escalation: heartbeat {name!r} stale for {age:.1f}s — "
            f"aborting the serving step for supervised restart"
        )
        with self._lock:
            engine = self._engine
        engine.request_abort()

    def _restart(self, reason: str, cause: Optional[BaseException] = None):
        # one lock acquisition snapshots every shared field this restart
        # needs: set_params/drain may race from the trainer thread, and the
        # counters are read by summary()/export_gauges() on other threads
        with self._lock:
            self.restarts += 1
            n = self.restarts
            backoff = min(self.backoff_base_s * (2 ** (n - 1)), self.backoff_max_s)
            if n <= self.max_restarts:
                self.restart_history.append(
                    {"time": time.time(), "reason": reason, "backoff_s": backoff}
                )
            history = list(self.restart_history)
            old = self._engine
            params_set = self._params_set
            params = self._params
            island = self._island
            draining = self._draining
        gauges.set(old.gauge_prefix + "restarts", float(n))
        if n > self.max_restarts:
            bundle = write_diagnostics_bundle(
                self.diagnostics_dir,
                kind="serving-restart-budget",
                extra={
                    "restart_history": history,
                    "last_reason": reason,
                    "max_restarts": self.max_restarts,
                },
            )
            raise ServingRestartBudgetExceeded(
                f"serving engine restart budget exhausted "
                f"({self.max_restarts} restarts); last failure: {reason}; "
                f"diagnostics bundle: {bundle}"
            ) from cause
        # host-side request state survives the dead engine: live requests
        # fold into the replay queue (prompt + generated-so-far), pending and
        # finished-but-uncollected carry over, uids stay unique
        state = old.scheduler.export_state()
        if flight.enabled:
            # a supervised restart is an intra-seat re-route: the same flight
            # keeps accumulating, and everything from here until decoding
            # resumes on the successor is preempt_replay tax (pending
            # requests that never held device state keep waiting in
            # queue_wait — the recorder distinguishes them)
            t_kill = old.scheduler.clock()
            for req in state["replay"]:
                flight.record(req.uid, "re_route", t=t_kill, reason=reason)
        logger.warning(
            f"restarting serving engine ({n}/{self.max_restarts}, "
            f"backoff {backoff:.2f}s, replaying {len(state['replay'])} requests) "
            f"after: {reason}"
        )
        time.sleep(backoff)
        new = self._factory()
        if params_set:
            new.set_params(params)
        if island is not None:
            new.attach_island(island)
        new.adopt(state)
        if draining:
            # mid-drain restart: keep rejecting new submits, but do NOT shed
            # the replay queue — those requests were live and drain lets them
            # finish
            new.begin_drain(shed_pending=False)
        # restarts run on the one driving thread (only step/run/drain reach
        # here), so the handle the snapshot read is still the live one. But
        # set_params / attach_island / begin_drain may come from other
        # threads (the learner publishes weights while rollouts step), and
        # one that landed since the snapshot reached the dead engine, not
        # `new`: re-validate under the lock and bring `new` up to date
        # before publishing it.
        with self._lock:
            if self._engine is not old:
                raise RuntimeError("serving engine replaced during a restart: restarts run on one thread")
            if self._params_set and (not params_set or self._params is not params):
                new.set_params(self._params)
            if self._island is not None and self._island is not island:
                new.attach_island(self._island)
            if self._draining and not draining:
                new.begin_drain(shed_pending=False)
            self._engine = new

    # ------------------------------------------------------------------ stepping

    def step(self) -> List[Request]:
        """One supervised engine round. Crashes and aborted wedges consume
        restart budget and return an empty round (the replayed requests
        re-prefill on the successor's next rounds)."""
        with self._lock:
            engine = self._engine
        timer = None
        if self.wedge_timeout_s is not None:
            # watchdog-independent wedge fallback: if this round outlives the
            # timeout, abort it from outside (a wedge raises nothing by itself)
            timer = threading.Timer(self.wedge_timeout_s, engine.request_abort)
            timer.daemon = True
            timer.start()
        try:
            finished = engine.step()
        except Exception as e:
            self._restart(f"engine step failed: {type(e).__name__}: {e}", cause=e)
            return []
        finally:
            if timer is not None:
                timer.cancel()
        watchdog.beat(self._heartbeat)
        return finished

    def run(self, uids: Optional[Sequence[int]] = None) -> Dict[int, Request]:
        """Drive supervised rounds until the given uids (or all work)
        complete — the supervised mirror of :meth:`ServingEngine.run`."""
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

    def begin_drain(self, shed_pending: bool = True) -> None:
        """Enter drain mode without driving it to completion: reject new
        submits (restarted generations stay draining too). The fleet
        autoscaler decommissions a replica this way — it keeps stepping the
        fleet as a whole while the drained replica's live slots finish.
        ``shed_pending=False`` lets queued requests finish instead of
        shedding them (graceful decommission re-prefills nothing)."""
        with self._lock:
            self._draining = True
        self.engine.begin_drain(shed_pending=shed_pending)

    def drain(self) -> Dict[int, Request]:
        """Supervised graceful shutdown: shed pending, finish live slots —
        restarting through crashes so accepted live requests still finish."""
        self.begin_drain()
        done: Dict[int, Request] = dict(self.scheduler.pop_finished())
        while self.scheduler.has_work:
            self.step()
            done.update(self.scheduler.pop_finished())
        return done
