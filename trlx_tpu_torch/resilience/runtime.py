"""``Resilience`` — the facade ``MeshRLTrainer`` drives from
``TRLConfig.train.resilience`` (counterpart of
``trlx_tpu/resilience/runtime.py``).

One object owns the subsystem's moving parts and their lifecycle:

- the :class:`~trlx_tpu.resilience.checkpoint.AsyncCheckpointWriter`
  (``None`` when async checkpointing is off or the run is multi-process:
  the reference's saves are collective there and a per-host background
  thread cannot order them safely, so it warns and falls back to the
  synchronous path; the port keeps that rule);
- the :class:`~trlx_tpu.resilience.preemption.PreemptionHandler`, installed
  at construction (main thread) when ``preemption_handling`` is on;
- the reward-fn wrapper: chaos's ``reward`` site is checked on *every* call
  (so tests can prove an unprotected run dies), and the retry policy is
  layered outside it when ``retry_rewards`` is on — an injected fault is
  retried exactly like a real transient one;
- chaos itself: :meth:`ChaosMonkey.reload_from_env` runs at construction, so
  a subprocess-spawned trainer picks up ``TRLX_CHAOS`` with no plumbing.

A disabled config (`enabled: false`, the default) constructs a facade whose
every hook is a cheap no-op and whose reward wrapper returns the function
unchanged — the trainer code can call it unconditionally.
"""

from typing import Callable, Optional

from trlx_tpu_torch.resilience.chaos import chaos
from trlx_tpu_torch.resilience.checkpoint import AsyncCheckpointWriter
from trlx_tpu_torch.resilience.preemption import PreemptionHandler
from trlx_tpu_torch.resilience.retry import RetryPolicy, with_retries
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

#: directory names the retention policy must never delete
PROTECTED_CHECKPOINTS = ("best_checkpoint", "hf_model")


class Resilience:
    def __init__(self, config, multiprocess: bool = False):
        self.config = config
        self.enabled = bool(getattr(config, "enabled", False))
        self.writer: Optional[AsyncCheckpointWriter] = None
        self.preemption: Optional[PreemptionHandler] = None
        self.retry_policy: Optional[RetryPolicy] = None
        chaos.reload_from_env()
        if not self.enabled:
            return
        if config.async_checkpointing:
            if multiprocess:
                logger.warning(
                    "resilience.async_checkpointing is single-process only "
                    "(multi-process saves are collective); falling back to "
                    "synchronous atomic saves"
                )
            else:
                self.writer = AsyncCheckpointWriter(
                    keep_last=config.keep_last, protected=list(PROTECTED_CHECKPOINTS)
                )
        if config.preemption_handling:
            self.preemption = PreemptionHandler(grace_period_s=config.grace_period_s)
            self.preemption.install()
        if config.retry_rewards:
            self.retry_policy = RetryPolicy(
                max_retries=config.retry_max_retries,
                base_delay_s=config.retry_base_delay_s,
                max_delay_s=config.retry_max_delay_s,
                deadline_s=config.retry_deadline_s,
            )

    # ------------------------------------------------------------ reward calls

    def wrap_reward_fn(self, reward_fn: Optional[Callable]) -> Optional[Callable]:
        """Chaos-instrument (always) and retry-protect (when enabled) a
        reward_fn. Covers every call path — sync PPO scoring, the overlap
        thread, the async rollout producer, and evals — because they all go
        through ``trainer.reward_fn``."""
        if reward_fn is None:
            return None

        def chaos_checked(*args, **kwargs):
            chaos.fail_if_armed("reward")
            return reward_fn(*args, **kwargs)

        chaos_checked.__name__ = getattr(reward_fn, "__name__", "reward_fn")
        chaos_checked.__wrapped__ = reward_fn
        if self.retry_policy is None:
            return chaos_checked
        return with_retries(chaos_checked, policy=self.retry_policy, name="reward_fn")

    # -------------------------------------------------------------- preemption

    def should_stop(self, step: int) -> bool:
        """Poll once per optimizer step. Converts an armed chaos
        ``preempt-step`` into a simulated preemption, then reports whether the
        trainer must emergency-checkpoint and exit."""
        if self.preemption is None:
            return False
        if chaos.preempt_due(step):
            self.preemption.simulate(f"chaos preempt-step at step {step}")
        return self.preemption.preempted

    @property
    def auto_resume(self) -> bool:
        return self.enabled and bool(self.config.auto_resume)

    # --------------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Flush the writer and release the signal handlers. Idempotent."""
        if self.writer is not None:
            self.writer.close()
        if self.preemption is not None:
            self.preemption.uninstall()
