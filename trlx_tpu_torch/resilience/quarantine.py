"""Experience quarantine: divert invalid rollout elements instead of training
on them (counterpart of ``trlx_tpu/resilience/quarantine.py``, a copy over the
port's ``PPORLElement``, whose fields are host numpy arrays).

The PPO learner trusts its experience buffer completely — a single element
with NaN logprobs turns the importance ratio, hence the loss, hence the
*parameters* non-finite, and the run is dead long before
anyone reads a metric. Rollout elements cross a trust boundary (reward
servers, decode numerics, staleness bookkeeping), so they get validated at
the single choke point where both the synchronous and the async producer
paths assemble them (``PPOTrainer._score_and_store``).

:class:`ExperienceQuarantine` screens each element for

- non-finite ``logprobs`` / ``values`` / ``rewards``,
- an empty response,

and diverts offenders to a JSONL sidecar (one record per element: reason,
policy version, and the full arrays as lists) for postmortem — the learner
only ever sees clean experience, and nothing is silently discarded. Counts
land in the ``resilience/quarantined`` gauge, which rides the per-step stats
and the end-of-run self-healing summary.

Thread-safety: the async producer thread and the learner (sync path) may both
score; a lock serializes sidecar appends. Chaos site ``bad-element``
(:func:`chaos_corrupt_elements`) fabricates offenders to prove the screen
holds end-to-end.
"""

import json
import os
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)

QUARANTINE_FILE = "quarantine.jsonl"


def validate_element(element) -> Optional[str]:
    """Reason this element must not reach the learner, or ``None`` if clean."""
    response = np.asarray(element.response_tensor)
    if response.size == 0:
        return "empty response"
    for field in ("logprobs", "values", "rewards"):
        arr = np.asarray(getattr(element, field))
        if arr.size and not np.all(np.isfinite(arr.astype(np.float64))):
            return f"non-finite {field}"
    return None


def chaos_corrupt_elements(elements: List[Any]) -> List[Any]:
    """Chaos site ``bad-element``: replace the first element's logprobs with
    NaNs — the signature of a poisoned scoring pass. Free when unarmed."""
    if not elements or not chaos.should_fail("bad-element"):
        return elements
    logger.warning("chaos: corrupting one rollout element at site 'bad-element'")
    first = elements[0]
    bad = np.full_like(np.asarray(first.logprobs, dtype=np.float32), np.nan)
    return [first.replace(logprobs=bad)] + list(elements[1:])


class ExperienceQuarantine:
    """Validate rollout elements; sidecar the bad ones (module docstring)."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, QUARANTINE_FILE)
        self._lock = threading.Lock()
        self._count = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def filter(self, elements: List[Any], context: str = "") -> List[Any]:
        """Split ``elements`` into clean (returned) and quarantined (written
        to the sidecar). Never raises on I/O: losing the sidecar must not
        lose the protection."""
        clean, bad = [], []
        for element in elements:
            reason = validate_element(element)
            if reason is None:
                clean.append(element)
            else:
                bad.append((reason, element))
        if bad:
            self._record(bad, context)
        return clean

    def _record(self, bad: List[Tuple[str, Any]], context: str):
        records = [
            {
                "time": time.time(),
                "context": context,
                "reason": reason,
                "policy_version": int(np.asarray(e.policy_version)),
                "query_tokens": np.asarray(e.query_tensor).tolist(),
                "response_tokens": np.asarray(e.response_tensor).tolist(),
                "logprobs": np.asarray(e.logprobs, dtype=np.float64).tolist(),
                "values": np.asarray(e.values, dtype=np.float64).tolist(),
                "rewards": np.asarray(e.rewards, dtype=np.float64).tolist(),
            }
            for reason, e in bad
        ]
        with self._lock:
            self._count += len(bad)
            count = self._count
            try:
                os.makedirs(self.directory, exist_ok=True)
                with open(self.path, "a") as f:
                    for record in records:
                        f.write(json.dumps(record) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            except OSError as e:
                logger.error(f"failed to append quarantine sidecar {self.path}: {e}")
        gauges.set("resilience/quarantined", float(count))
        reasons = ", ".join(sorted({r for r, _ in bad}))
        logger.warning(
            f"quarantined {len(bad)} rollout element(s) ({reasons}) -> {self.path}"
        )
