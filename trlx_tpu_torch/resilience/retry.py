"""Retry with exponential backoff, jitter, and a wall-clock deadline
(counterpart of ``trlx_tpu/resilience/retry.py``, a copy).

The hot failure mode on a production RLHF run is not the device program —
it is the *host-side* calls around it: a served reward model's RPC flaking, an
HF checkpoint read off congested NFS, a tracker backend hiccuping. Today any
one of those kills the whole run and throws away everything since the last
checkpoint. :func:`retry_call` wraps exactly those call sites:

- exponential backoff (``base_delay_s * 2^(attempt-1)``, capped at
  ``max_delay_s``) with symmetric jitter so a fleet of preempted-and-restarted
  jobs does not hammer a recovering reward endpoint in lockstep;
- a **deadline**: total wall time across attempts is bounded, so a
  hard-down endpoint surfaces as a clear :class:`RetryDeadlineExceeded`
  instead of an unbounded stall (the watchdog would page on the stall, but a
  typed error is a diagnosis, not a symptom);
- ``giveup_on`` exceptions are never retried (a ``FileNotFoundError`` is an
  answer, not a transient fault);
- every retry increments the ``resilience/retries`` gauge so the tracker
  backends see flakiness *before* it becomes an outage.

``sleep`` / ``clock`` / ``rng`` are injectable for deterministic tests.
"""

import random as _random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)


class RetryDeadlineExceeded(TimeoutError):
    """The retry loop ran out of wall-clock budget (``RetryPolicy.deadline_s``)."""


@dataclass
class RetryPolicy:
    """How to retry one class of flaky call.

    :param max_retries: retries *after* the first attempt (total attempts =
        ``max_retries + 1``).
    :param base_delay_s: backoff before the first retry; doubles per retry.
    :param max_delay_s: cap on any single backoff sleep.
    :param jitter: symmetric jitter fraction — each delay is scaled by a
        uniform factor in ``[1 - jitter, 1 + jitter]``.
    :param deadline_s: total wall-clock budget across all attempts (sleeps
        included); ``None`` means attempts alone bound the loop.
    :param retry_on: exception types that are retried.
    :param giveup_on: exception types never retried, even when they match
        ``retry_on`` (checked first).
    """

    max_retries: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    jitter: float = 0.5
    deadline_s: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)
    giveup_on: Tuple[Type[BaseException], ...] = ()

    def delay(self, attempt: int, rng=_random) -> float:
        """Backoff before retry ``attempt`` (1-based), jittered and capped."""
        d = min(self.base_delay_s * (2.0 ** (attempt - 1)), self.max_delay_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)


def retry_call(
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy] = None,
    name: Optional[str] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng=_random,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)`` under ``policy`` (see module docstring)."""
    policy = policy or RetryPolicy()
    name = name or getattr(fn, "__name__", "call")
    start = clock()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except policy.giveup_on:
            raise
        except policy.retry_on as e:
            attempt += 1
            if attempt > policy.max_retries:
                logger.error(
                    f"{name}: failed after {attempt} attempts "
                    f"({type(e).__name__}: {e}); giving up"
                )
                raise
            delay = policy.delay(attempt, rng=rng)
            elapsed = clock() - start
            if policy.deadline_s is not None and elapsed + delay > policy.deadline_s:
                gauges.inc("resilience/retry_deadline_exceeded")
                raise RetryDeadlineExceeded(
                    f"{name}: retry deadline {policy.deadline_s}s would be "
                    f"exceeded after {attempt} attempts ({elapsed:.1f}s elapsed)"
                ) from e
            gauges.inc("resilience/retries")
            logger.warning(
                f"{name}: attempt {attempt}/{policy.max_retries + 1} failed "
                f"({type(e).__name__}: {e}); retrying in {delay:.2f}s"
            )
            sleep(delay)


def with_retries(
    fn: Callable, policy: Optional[RetryPolicy] = None, name: Optional[str] = None
) -> Callable:
    """Return ``fn`` wrapped in :func:`retry_call` (keeps the signature)."""

    def wrapped(*args, **kwargs):
        return retry_call(fn, *args, policy=policy, name=name, **kwargs)

    wrapped.__name__ = getattr(fn, "__name__", "wrapped")
    wrapped.__wrapped__ = fn
    return wrapped
