"""Training health guard: skip → roll back → halt instead of training on
garbage (counterpart of ``trlx_tpu/resilience/health.py``).

A NaN loss does not crash a training loop — it *converges* it, to a
parameter set of NaNs that every later step happily "optimizes".
:class:`TrainingHealthGuard` closes that hole with an escalation ladder,
wired into ``MeshRLTrainer._learn_loop`` behind ``train.self_healing``:

1. **Skip** — the optimizer step (``MeshRLTrainer.make_grad_accum_step``)
   checks that the mean microbatch loss and the global norm of the averaged
   gradients (before clipping) are finite and that the norm is at most
   ``grad_norm_cap()``; if not, neither ``optimizer.step()`` nor
   ``scheduler.step()`` runs, so parameters, AdamW's moments and step count,
   and the learning-rate schedule stay as they were. The reference decides
   inside its jitted step with ``jnp.where`` (its buffers are donated); the
   port decides on the host from the step's one device→host transfer of
   its stats. The step reports ``health/grad_norm`` and
   ``health/update_applied``.
2. **Roll back** — ``rollback_after`` *consecutive* anomalies (skips, or KL
   spikes vs the rolling window) mean the run is poisoned beyond one bad
   batch: the trainer restores the last committed checkpoint and
   re-collects experience. Bounded by ``max_rollbacks``.
3. **Halt** — an exhausted rollback budget raises
   :class:`TrainingHealthError` whose message carries the path of a
   diagnostics bundle (recent gauges, anomaly history, span trace, thread
   stacks) written by :func:`write_diagnostics_bundle`.

The guard is pure host-side bookkeeping (deques + counters). Chaos site
``nan-loss`` (:func:`chaos_poison_batch`) poisons real batches to exercise
the whole ladder end-to-end.
"""

import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

from trlx_tpu_torch.data.configs import SelfHealingConfig
from trlx_tpu_torch.obs import format_all_stacks, tracer
from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.resilience.checkpoint import write_json_atomic
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.metrics import gauges

logger = logging.get_logger(__name__)


class TrainingHealthError(RuntimeError):
    """Raised when the health guard halts the run (budget exhausted); the
    message contains the diagnostics bundle path."""


def write_diagnostics_bundle(
    directory: str,
    kind: str,
    anomalies: Optional[List[Dict[str, Any]]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a postmortem bundle and return its path.

    The bundle is a directory ``<directory>/<kind>-<unix_ts>/`` holding
    ``bundle.json`` (gauge snapshot, anomaly history, chaos stats, extras),
    ``stacks.txt`` (every Python thread's stack — a wedged producer shows up
    here), and ``trace.json`` (Chrome span trace, when tracing is active).
    Best-effort: a failure to write diagnostics must never mask the failure
    being diagnosed, so errors degrade to a log line.
    """
    bundle_dir = os.path.join(directory, f"{kind}-{int(time.time() * 1000)}")
    try:
        os.makedirs(bundle_dir, exist_ok=True)
        payload = {
            "kind": kind,
            "written_at": time.time(),
            "gauges": gauges.snapshot(),
            "chaos_injected": chaos.stats(),
            "anomalies": list(anomalies or []),
        }
        if extra:
            payload.update(extra)
        write_json_atomic(os.path.join(bundle_dir, "bundle.json"), payload)
        with open(os.path.join(bundle_dir, "stacks.txt"), "w") as f:
            f.write(format_all_stacks())
        try:
            tracer.write_trace(os.path.join(bundle_dir, "trace.json"))
        except Exception:
            pass  # tracing disabled or empty — the JSON + stacks still land
        logger.warning(f"diagnostics bundle written: {bundle_dir}")
    except OSError as e:
        logger.error(f"failed to write diagnostics bundle at {bundle_dir}: {e}")
    return bundle_dir


def chaos_poison_batch(batch):
    """Chaos site ``nan-loss``: multiply every floating tensor (or numpy
    array) of ``batch`` by NaN, on its own device, so the next loss and
    gradient are non-finite — the signature of a numerics blowup, injected
    at the last host-side seam before the step. ``batch`` is a tensor, an
    array, a dataclass (the port's batch types) or a dict / list / tuple of
    them. Free when unarmed (one dict lookup)."""
    if not chaos.should_fail("nan-loss"):
        return batch
    import dataclasses

    import numpy as np
    import torch

    logger.warning("chaos: poisoning train batch to NaN at site 'nan-loss'")

    def poison(x):
        if isinstance(x, torch.Tensor):
            return x * float("nan") if x.is_floating_point() else x
        if isinstance(x, np.ndarray):
            return x * x.dtype.type(np.nan) if np.issubdtype(x.dtype, np.floating) else x
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: poison(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return type(x)((k, poison(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(poison(v) for v in x)
        return x

    return poison(batch)


class TrainingHealthGuard:
    """Escalation-ladder bookkeeping for :class:`MeshRLTrainer` (module docs).

    Single-threaded by design: every method is called from the learner
    thread, between steps. The guard never touches device memory.
    """

    def __init__(self, config: SelfHealingConfig, diagnostics_dir: str):
        self.config = config
        self.diagnostics_dir = diagnostics_dir
        self._grad_norms: deque = deque(maxlen=max(1, config.anomaly_window))
        self._kls: deque = deque(maxlen=max(1, config.anomaly_window))
        self.anomalies: List[Dict[str, Any]] = []
        self.consecutive_anomalies = 0
        self.skipped_updates = 0
        self.rollbacks = 0

    # ------------------------------------------------------------- thresholds

    #: Below this, the window median is not a usable baseline and the cap
    #: stays disarmed. A warm-started policy sits at its KL reference
    #: (sqrt_kl ~ 0), so a ratio spike test against that median would flag
    #: every healthy step once the policy starts moving; likewise a ~zero
    #: grad-norm median means the run is converged or frozen, and "10x of
    #: nothing" is still nothing. Non-finite values are caught by the
    #: step's isfinite check regardless of the cap.
    _MIN_BASELINE = 1e-6

    @staticmethod
    def _median(window: deque) -> float:
        ordered = sorted(window)
        return float(ordered[len(ordered) // 2])

    def _cap(self, window: deque, factor: float) -> float:
        if len(window) < max(1, self.config.min_window):
            return float("inf")
        median = self._median(window)
        if median <= self._MIN_BASELINE:
            return float("inf")
        return factor * median

    def grad_norm_cap(self) -> float:
        """Grad-norm ceiling for the *next* step: inf until
        the rolling window holds ``min_window`` healthy samples with a
        meaningfully nonzero median, then ``grad_norm_spike_factor`` x the
        window median."""
        return self._cap(self._grad_norms, self.config.grad_norm_spike_factor)

    def _kl_cap(self) -> float:
        return self._cap(self._kls, self.config.kl_spike_factor)

    # -------------------------------------------------------------- the ladder

    def observe(self, stats: Dict[str, Any], step: int) -> str:
        """Classify one completed step: ``"ok"``, ``"anomaly"`` (the step
        already skipped the update, or a KL spike), or
        ``"rollback"`` (``rollback_after`` consecutive anomalies — the caller
        decides restore-vs-halt against the budget)."""
        reasons = []
        applied = stats.get("health/update_applied")
        if applied is not None and float(applied) < 0.5:
            reasons.append("update skipped (non-finite loss/grads or grad-norm spike)")
        kl = stats.get("policy/sqrt_kl")
        kl_cap = self._kl_cap()
        if kl is not None and float(kl) > kl_cap:
            reasons.append(f"KL spike: sqrt_kl {float(kl):.4g} > {kl_cap:.4g}")

        if not reasons:
            # only healthy samples feed the baselines — an accepted spike
            # would inflate the median and blind the detector to the next one
            gn = stats.get("health/grad_norm")
            if gn is not None and float(gn) == float(gn):  # finite-ish (not NaN)
                self._grad_norms.append(float(gn))
            if kl is not None and float(kl) == float(kl):
                self._kls.append(float(kl))
            self.consecutive_anomalies = 0
            return "ok"

        self.consecutive_anomalies += 1
        if applied is not None and float(applied) < 0.5:
            self.skipped_updates += 1
            gauges.set("resilience/skipped_updates", float(self.skipped_updates))
        self.anomalies.append(
            {
                "step": step,
                "reasons": reasons,
                "grad_norm": _maybe_float(stats.get("health/grad_norm")),
                "loss": _maybe_float(stats.get("loss")),
                "sqrt_kl": _maybe_float(kl),
                "consecutive": self.consecutive_anomalies,
            }
        )
        del self.anomalies[:-256]  # bounded history; newest kept for the bundle
        gauges.set("resilience/anomalies", float(len(self.anomalies)))
        logger.warning(
            f"health anomaly at step {step} "
            f"({self.consecutive_anomalies} consecutive): {'; '.join(reasons)}"
        )
        if self.consecutive_anomalies >= max(1, self.config.rollback_after):
            return "rollback"
        return "anomaly"

    def rollback_budget_left(self) -> bool:
        return self.rollbacks < self.config.max_rollbacks

    def on_rollback(self, step: int, restored: bool):
        """Account one consumed rollback (whether or not a checkpoint existed
        to restore — a budget that only counts successes never exhausts)."""
        self.rollbacks += 1
        self.consecutive_anomalies = 0
        gauges.set("resilience/rollbacks", float(self.rollbacks))
        logger.warning(
            f"health rollback #{self.rollbacks}/{self.config.max_rollbacks} at step {step} "
            f"({'restored last committed checkpoint' if restored else 'no committed checkpoint to restore'})"
        )

    def halt(self, step: int, reason: str) -> None:
        """Fail closed: write the diagnostics bundle and raise with its path."""
        bundle = write_diagnostics_bundle(
            self.diagnostics_dir,
            kind="health-halt",
            anomalies=self.anomalies,
            extra={"halt_step": step, "halt_reason": reason, "rollbacks": self.rollbacks},
        )
        raise TrainingHealthError(
            f"training halted at step {step}: {reason}; diagnostics bundle: {bundle}"
        )

    def report(self) -> Dict[str, Any]:
        """End-of-run self-healing summary (also mirrored in gauges)."""
        return {
            "producer_restarts": int(gauges.get("resilience/restarts") or 0),
            "skipped_updates": self.skipped_updates,
            "rollbacks": self.rollbacks,
            "anomalies": len(self.anomalies),
            "quarantined": int(gauges.get("resilience/quarantined") or 0),
        }


def _maybe_float(x) -> Optional[float]:
    try:
        return float(x)
    except (TypeError, ValueError):
        return None
