"""Stall watchdog: detect a wedged learner or rollout producer and dump
stacks (counterpart of ``trlx_tpu/obs/watchdog.py``, a copy).

- Participants call :meth:`StallWatchdog.beat` with their name after each
  unit of progress (the learner after each optimizer step and eval, the
  rollout producer after each queue publish, the checkpoint writer while it
  commits).
- A daemon thread checks every heartbeat's age. When one exceeds
  ``timeout_s``, it logs a warning naming the stalled heartbeat and dumps
  **every** Python thread's stack (``sys._current_frames``).
- One dump per stall episode: after firing, a heartbeat must beat again
  before it can fire again. ``obs/stalls`` counts episodes in the gauges.
- :meth:`StallWatchdog.escalate` registers a per-heartbeat callback, run on
  the watchdog thread when that heartbeat stalls: the rollout
  ``ProducerSupervisor`` turns a stale producer into a restart with it.
- :meth:`unregister` removes a heartbeat that is legitimately done.

The process-global :data:`watchdog` is a handle that forwards to a no-op
watchdog until a real :class:`StallWatchdog` is installed: subsystems beat
it unconditionally. The trainer's
:class:`~trlx_tpu_torch.obs.runtime.Observability` installs and starts one
when ``train.observability.watchdog_timeout_s > 0``; without it the
supervisor's ``wedge_timeout_s`` timer is the only wedge detector.
"""

import sys
import threading
import time
import traceback
from typing import Callable, Dict, Optional

from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)


def format_all_stacks() -> str:
    """All Python threads' current stacks as one readable block."""
    names = {t.ident: t.name for t in threading.enumerate()}
    blocks = []
    for tid, frame in sys._current_frames().items():
        name = names.get(tid, "?")
        stack = "".join(traceback.format_stack(frame))
        blocks.append(f'--- thread "{name}" (tid {tid}) ---\n{stack}')
    return "\n".join(blocks)


class StallWatchdog:
    """Heartbeat monitor with stack-dump-on-stall (see module docstring)."""

    def __init__(
        self,
        timeout_s: float,
        poll_s: Optional[float] = None,
        on_stall: Optional[Callable[[str, float], None]] = None,
    ):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s) if poll_s else max(0.05, self.timeout_s / 4)
        self.on_stall = on_stall
        self._lock = threading.Lock()
        self._beats: Dict[str, float] = {}
        self._fired: Dict[str, float] = {}  # heartbeat -> beat ts already reported
        self._escalations: Dict[str, Callable[[str, float], None]] = {}
        self._stalls = 0
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- heartbeats

    def beat(self, name: str):
        """Record progress for ``name`` (registers it on first call)."""
        with self._lock:
            self._beats[name] = time.monotonic()

    def unregister(self, name: str):
        """Forget ``name`` — a heartbeat that finished cleanly must not fire."""
        with self._lock:
            self._beats.pop(name, None)
            self._fired.pop(name, None)

    def escalate(self, name: str, callback: Optional[Callable[[str, float], None]]):
        """Register a per-heartbeat escalation: when ``name`` stalls, invoke
        ``callback(name, age)`` (on the watchdog thread, once per stall
        episode) in addition to the stack dump. This is how a *recovery*
        subsystem — e.g. the rollout ``ProducerSupervisor`` — turns a
        diagnosis into an action: the callback should set a flag and return
        fast, never block. ``None`` unregisters."""
        with self._lock:
            if callback is None:
                self._escalations.pop(name, None)
            else:
                self._escalations[name] = callback

    @property
    def stall_count(self) -> int:
        with self._lock:
            return self._stalls

    # -------------------------------------------------------------- lifecycle

    def start(self):
        # _thread is guarded: concurrent start()/stop()/running callers (the
        # trainer plus obs shutdown hooks) race on the handle otherwise
        # the Event is its own synchronization — clear it outside the section
        self._stop_evt.clear()
        with self._lock:
            if self._thread is not None:
                return
            thread = threading.Thread(
                target=self._loop, name="obs-watchdog", daemon=True
            )
            self._thread = thread
        thread.start()

    def stop(self, timeout: float = 5.0):
        self._stop_evt.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)  # outside the lock: beat() must never wait on it

    @property
    def running(self) -> bool:
        with self._lock:
            thread = self._thread
        return thread is not None and thread.is_alive()

    def _loop(self):
        while not self._stop_evt.wait(self.poll_s):
            self.check()

    def check(self, now: Optional[float] = None):
        """One poll: fire for any heartbeat older than ``timeout_s`` that has
        not already been reported at that beat timestamp. Exposed for tests
        (and callers that want a synchronous poll without the thread)."""
        now = time.monotonic() if now is None else now
        stalled = []
        with self._lock:
            for name, last in self._beats.items():
                if now - last > self.timeout_s and self._fired.get(name) != last:
                    self._fired[name] = last
                    self._stalls += 1
                    stalled.append((name, now - last))
            stalls = self._stalls
            escalations = {n: cb for n, cb in self._escalations.items()}
        if not stalled:
            return
        gauges.set("obs/stalls", float(stalls))
        # format stacks OUTSIDE the lock: beat() must never wait on a dump
        stacks = format_all_stacks()
        for name, age in stalled:
            logger.warning(
                f"STALL DETECTED: no progress from {name!r} for {age:.1f}s "
                f"(timeout {self.timeout_s}s); dumping all thread stacks:\n{stacks}"
            )
            if self.on_stall is not None:
                try:
                    self.on_stall(name, age)
                except Exception as e:  # diagnostics must never kill training
                    logger.warning(f"watchdog on_stall callback failed: {e}")
            escalation = escalations.get(name)
            if escalation is not None:
                try:
                    escalation(name, age)
                except Exception as e:  # recovery hooks must never kill the watchdog
                    logger.warning(f"watchdog escalation for {name!r} failed: {e}")


class _NullWatchdog:
    """Disabled stand-in so subsystems can beat unconditionally."""

    timeout_s = 0.0
    running = False
    stall_count = 0

    def beat(self, name: str):
        pass

    def unregister(self, name: str):
        pass

    def escalate(self, name: str, callback=None):
        pass

    def start(self):
        pass

    def stop(self, timeout: float = 5.0):
        pass

    def check(self, now: Optional[float] = None):
        pass


class _WatchdogHandle:
    """Process-global mount point: forwards to the installed watchdog (a no-op
    one until the trainer installs a real :class:`StallWatchdog`)."""

    def __init__(self):
        self._impl = _NullWatchdog()

    def install(self, impl):
        prev, self._impl = self._impl, impl if impl is not None else _NullWatchdog()
        if isinstance(prev, StallWatchdog):
            prev.stop()

    def __getattr__(self, name):
        return getattr(self._impl, name)


#: Process-global watchdog handle; subsystems beat, the trainer installs.
watchdog = _WatchdogHandle()
