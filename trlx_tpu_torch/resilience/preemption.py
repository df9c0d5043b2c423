"""Graceful preemption: turn SIGTERM into a checkpoint, not a lost run
(counterpart of ``trlx_tpu/resilience/preemption.py``, a copy).

Preemptions (maintenance events, spot reclaims) follow a fixed script:
the job receives SIGTERM, gets a grace window (typically 30s–5min depending
on provisioning), then SIGKILL. Untrapped, that loses everything since the
last periodic checkpoint. :class:`PreemptionHandler` makes the window count:

- ``install()`` traps SIGTERM/SIGINT **on the main thread** (Python delivers
  signals there; installing from a worker raises ``ValueError``, so we check
  first and no-op with a warning — e.g. under pytest-xdist workers).
- The handler body only sets a flag and records the deadline — everything
  else (emergency checkpoint, rollout drain) runs in the trainer loop when it
  polls :meth:`should_stop`, because signal-handler context cannot safely
  touch the device: the handler takes no lock a worker thread may hold and
  makes no CUDA call.
- After the first signal the previous handler is **reinstated**: a second
  SIGTERM/SIGINT terminates immediately. This is deliberate — the operator's
  ctrl-C-twice escape hatch, and the SIGKILL-after-SIGTERM contract needs no
  special case (SIGKILL is untrappable anyway).
- :meth:`simulate` arms the same flag without any OS signal, which is how
  chaos's ``preempt-step:N`` site and the tests drive the full
  emergency-checkpoint path deterministically in-process.
"""

import signal
import threading
import time
from typing import Optional, Tuple

from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)


class PreemptionHandler:
    def __init__(
        self,
        grace_period_s: float = 30.0,
        signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
    ):
        self.grace_period_s = float(grace_period_s)
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._deadline: Optional[float] = None
        self._reason: Optional[str] = None
        self._prev_handlers = {}
        self._installed = False

    # -------------------------------------------------------------- lifecycle

    def install(self) -> bool:
        """Trap the signals; returns False (with a warning) off the main thread."""
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "PreemptionHandler.install() called off the main thread; "
                "signal handling disabled (simulated preemption still works)"
            )
            return False
        for sig in self.signals:
            self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return True

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # off main thread / handler gone
                pass
        self._prev_handlers = {}
        self._installed = False

    def _on_signal(self, signum, frame) -> None:
        # keep this body minimal: flag + deadline + reinstate previous handler
        # (second signal = immediate termination, the operator escape hatch)
        self._arm(f"signal {signal.Signals(signum).name}")
        self.uninstall()

    # ------------------------------------------------------------------ state

    def _arm(self, reason: str) -> None:
        if self._flag.is_set():
            return
        self._reason = reason
        self._deadline = time.monotonic() + self.grace_period_s
        self._flag.set()
        gauges.inc("resilience/preemptions")
        logger.warning(
            f"PREEMPTION: {reason}; grace window {self.grace_period_s:.0f}s — "
            "will checkpoint and exit at the next step boundary"
        )

    def simulate(self, reason: str = "simulated") -> None:
        """Arm the preemption flag without an OS signal (chaos / tests)."""
        self._arm(reason)

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    @property
    def grace_remaining_s(self) -> Optional[float]:
        """Seconds left in the grace window; None if not preempted."""
        if self._deadline is None:
            return None
        return self._deadline - time.monotonic()
