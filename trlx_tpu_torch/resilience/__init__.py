"""Resilience subsystem: survive preemptions and transient faults
(counterpart of ``trlx_tpu/resilience``).

The primitives, each usable standalone, plus the :class:`Resilience` facade
the trainer drives from ``TRLConfig.train.resilience``:

- :mod:`trlx_tpu_torch.resilience.checkpoint` — atomic commit protocol
  (tmp-dir → rename → ``_COMMITTED`` sentinel), retention GC, host
  snapshots of live tensors, and the background
  :class:`AsyncCheckpointWriter`.
- :mod:`trlx_tpu_torch.resilience.preemption` — SIGTERM/SIGINT grace-window
  handler: flag now, emergency-checkpoint at the next step boundary.
- :mod:`trlx_tpu_torch.resilience.resume` — newest-committed-checkpoint
  discovery (numeric step order, torn dirs skipped) and RNG state packing.
- :mod:`trlx_tpu_torch.resilience.retry` — backoff + jitter + deadline for
  flaky host-side calls (reward RPCs, HF checkpoint reads).
- :mod:`trlx_tpu_torch.resilience.chaos` — ``TRLX_CHAOS`` fault injection
  that proves all of the above in tests.
- :mod:`trlx_tpu_torch.resilience.health` — :class:`TrainingHealthGuard`
  escalation ladder (skip anomalous updates → roll back to the last
  committed checkpoint → halt with a diagnostics bundle) behind
  ``TRLConfig.train.self_healing``.
- :mod:`trlx_tpu_torch.resilience.quarantine` — :class:`ExperienceQuarantine`
  screening rollout elements for non-finite numerics / empty responses and
  diverting offenders to a JSONL sidecar.
"""

from trlx_tpu_torch.resilience.chaos import ChaosInjectedError, ChaosMonkey, chaos
from trlx_tpu_torch.resilience.checkpoint import (
    COMMITTED_SENTINEL,
    AsyncCheckpointWriter,
    gc_checkpoints,
    host_snapshot,
    is_committed,
    mark_committed,
    write_checkpoint,
    write_json_atomic,
)
from trlx_tpu_torch.resilience.health import (
    TrainingHealthError,
    TrainingHealthGuard,
    chaos_poison_batch,
    write_diagnostics_bundle,
)
from trlx_tpu_torch.resilience.preemption import PreemptionHandler
from trlx_tpu_torch.resilience.quarantine import (
    ExperienceQuarantine,
    chaos_corrupt_elements,
    validate_element,
)
from trlx_tpu_torch.resilience.resume import (
    CHECKPOINT_PREFIX,
    checkpoint_step,
    find_latest_committed,
    list_checkpoints,
)
from trlx_tpu_torch.resilience.retry import (
    RetryDeadlineExceeded,
    RetryPolicy,
    retry_call,
    with_retries,
)
from trlx_tpu_torch.resilience.runtime import PROTECTED_CHECKPOINTS, Resilience

__all__ = [
    "AsyncCheckpointWriter",
    "CHECKPOINT_PREFIX",
    "COMMITTED_SENTINEL",
    "ChaosInjectedError",
    "ChaosMonkey",
    "ExperienceQuarantine",
    "PROTECTED_CHECKPOINTS",
    "PreemptionHandler",
    "Resilience",
    "RetryDeadlineExceeded",
    "RetryPolicy",
    "TrainingHealthError",
    "TrainingHealthGuard",
    "chaos",
    "chaos_corrupt_elements",
    "chaos_poison_batch",
    "checkpoint_step",
    "find_latest_committed",
    "gc_checkpoints",
    "host_snapshot",
    "is_committed",
    "list_checkpoints",
    "mark_committed",
    "retry_call",
    "validate_element",
    "with_retries",
    "write_checkpoint",
    "write_diagnostics_bundle",
    "write_json_atomic",
]
