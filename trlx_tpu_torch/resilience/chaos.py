"""Env-driven fault injection for resilience testing (counterpart of
``trlx_tpu/resilience/chaos.py``, a copy).

A resilience subsystem that is only exercised by real outages is untested
code. :class:`ChaosMonkey` lets tests (and brave operators) inject the exact
faults the subsystem claims to survive — without touching application code
paths beyond a one-line ``chaos.fail_if_armed("site")`` at each seam.

Faults are armed through the ``TRLX_CHAOS`` environment variable (or
programmatically via :meth:`ChaosMonkey.configure`), as a comma-separated list
of ``site:arg`` tokens:

- ``reward:N`` — the next ``N`` reward-fn calls raise
  :class:`ChaosInjectedError` (exercises the retry wrapper);
- ``rollout-producer:N`` — the async rollout producer thread dies ``N`` times
  (exercises queue close-on-death and error propagation);
- ``hf-load:N`` — the next ``N`` HF checkpoint loads fail (exercises the
  hub-loading retry policy);
- ``checkpoint:N`` — the next ``N`` checkpoint payload writes fail *before*
  the commit rename (exercises torn-checkpoint detection: the ``.tmp`` dir is
  left behind, no ``_COMMITTED`` sentinel ever appears);
- ``preempt-step:N`` — a simulated preemption "signal" is reported once the
  trainer reaches optimizer step ``N`` (exercises the emergency-checkpoint +
  auto-resume path end-to-end, no real SIGTERM required);
- ``producer-wedge:N`` — the async rollout producer *wedges* ``N`` times: it
  stops beating the watchdog and blocks silently instead of raising
  (exercises the watchdog-escalation → supervisor-restart path — the failure
  mode of a hung reward RPC, which no exception-based site can model);
- ``nan-loss:N`` — the next ``N`` train batches are poisoned to NaN before
  the optimizer step (exercises the TrainingHealthGuard skip/rollback
  ladder);
- ``bad-element:N`` — one element in each of the next ``N`` scored rollout
  chunks gets non-finite logprobs (exercises the experience quarantine);
- ``serving-prefill:N`` — the next ``N`` serving admission waves raise before
  their prefill runs (exercises supervised restart + replay of placed
  requests);
- ``serving-decode:N`` — the next ``N`` serving decode rounds raise before
  the device step (exercises restart + replay of live sequences);
- ``serving-alloc:N`` — the next ``N`` live-sequence KV-block extensions are
  reported as allocation failures (exercises KV-pressure preemption);
- ``serving-wedge:N`` — the serving engine's step loop wedges ``N`` times: it
  stops beating the watchdog and blocks until aborted (exercises the
  watchdog-escalation / wedge-timer → supervised-restart path);
- ``broadcast-chunk:N`` — the next ``N`` chunked-broadcast layer installs
  raise mid-broadcast (exercises the torn-version guarantee: the committed
  snapshot must stay the previous version, the burned version number must
  stay monotonic, and a re-publish must recover);
- ``fleet-route:N`` — the next ``N`` fleet routing decisions deliberately
  pick the WORST-scoring replica instead of the best (exercises the
  guarantee that routing quality is performance-only: mis-routed requests
  still finish exactly once, only affinity hit rates suffer);
- ``fleet-replica-kill:N`` — the fleet router hard-kills its busiest live
  replica ``N`` times (exercises cross-replica re-route: the dead replica's
  host-side request state is adopted by a survivor and every uid still
  reaches exactly one terminal state).

Count-based sites are *budgets*: each injected fault decrements the budget, so
``reward:2`` means exactly two failures then clean behavior — which is exactly
the shape of a transient outage.

Every site of the JAX package parses here, so one ``TRLX_CHAOS`` spec
drives both packages. The port checks ``reward``, ``rollout-producer``,
``hf-load``, ``checkpoint``, ``preempt-step``, ``producer-wedge``,
``nan-loss`` and ``bad-element``; the serving sites (``serving-*``),
``broadcast-chunk`` and the fleet sites (``fleet-*``) belong to paths that
are not ported yet, and nothing checks them.

The process-global handle is ``trlx_tpu_torch.resilience.chaos.chaos``. It reads the
env var at each :meth:`reload_from_env`; the ``Resilience`` runtime calls that
at trainer init, so subprocess-spawned trainers pick up the spec without any
plumbing. With no spec armed, every check is a dict lookup that misses —
effectively free.
"""

import os
import threading
from typing import Dict, Optional

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

ENV_VAR = "TRLX_CHAOS"

# count-budget sites; "preempt-step" is threshold-based and handled separately
_COUNT_SITES = (
    "reward",
    "rollout-producer",
    "hf-load",
    "checkpoint",
    "producer-wedge",
    "nan-loss",
    "bad-element",
    "serving-prefill",
    "serving-decode",
    "serving-alloc",
    "serving-wedge",
    "broadcast-chunk",
    "fleet-route",
    "fleet-replica-kill",
)


class ChaosInjectedError(RuntimeError):
    """A fault deliberately injected by :class:`ChaosMonkey`."""


class ChaosMonkey:
    def __init__(self, spec: Optional[str] = None):
        self._lock = threading.Lock()
        self._budgets: Dict[str, int] = {}
        self._preempt_step: Optional[int] = None
        self._preempt_fired = False
        self._injected: Dict[str, int] = {}
        if spec:
            self.configure(spec)

    def configure(self, spec: Optional[str]) -> None:
        """Arm faults from a spec string (see module docstring); ``None``/"" disarms."""
        with self._lock:
            self._budgets = {}
            self._preempt_step = None
            self._preempt_fired = False
            self._injected = {}
            if not spec:
                return
            for token in spec.split(","):
                token = token.strip()
                if not token:
                    continue
                site, _, arg = token.partition(":")
                site = site.strip()
                try:
                    count = int(arg.strip()) if arg.strip() else 1
                except ValueError:
                    raise ValueError(f"chaos spec token {token!r}: argument must be an integer")
                if site == "preempt-step":
                    self._preempt_step = count
                elif site in _COUNT_SITES:
                    self._budgets[site] = self._budgets.get(site, 0) + count
                else:
                    raise ValueError(
                        f"chaos spec token {token!r}: unknown site "
                        f"(expected one of {_COUNT_SITES + ('preempt-step',)})"
                    )
            logger.warning(f"chaos armed: budgets={self._budgets} preempt_step={self._preempt_step}")

    def reload_from_env(self) -> None:
        self.configure(os.environ.get(ENV_VAR))

    @property
    def armed(self) -> bool:
        with self._lock:
            return bool(self._budgets) or self._preempt_step is not None

    def should_fail(self, site: str) -> bool:
        """Consume one unit of ``site``'s fault budget; True if a fault fires."""
        with self._lock:
            remaining = self._budgets.get(site, 0)
            if remaining <= 0:
                return False
            self._budgets[site] = remaining - 1
            self._injected[site] = self._injected.get(site, 0) + 1
            return True

    def fail_if_armed(self, site: str, detail: str = "") -> None:
        """Raise :class:`ChaosInjectedError` if ``site`` has budget left."""
        if self.should_fail(site):
            suffix = f" ({detail})" if detail else ""
            raise ChaosInjectedError(f"chaos: injected failure at site {site!r}{suffix}")

    def preempt_due(self, step: int) -> bool:
        """True exactly once, when ``step`` first reaches the armed threshold."""
        with self._lock:
            if self._preempt_step is None or self._preempt_fired:
                return False
            if step >= self._preempt_step:
                self._preempt_fired = True
                self._injected["preempt-step"] = 1
                return True
            return False

    def stats(self) -> Dict[str, int]:
        """Faults injected so far, by site (for tests and logs)."""
        with self._lock:
            return dict(self._injected)


# Process-global handle; tests reset it via chaos.configure(None).
chaos = ChaosMonkey()
