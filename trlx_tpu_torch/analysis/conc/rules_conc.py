"""graftcheck-conc rules: CC001–CC005 over the interprocedural model.

CC001  shared attribute with an empty lockset intersection across thread
       roles. Lifts TH001's single-class lexical approximation: roles come
       from discovered thread roots (``Thread(target=...)``, watchdog
       escalation callbacks, spawned closures) plus the public API of
       lock-owning classes, and locksets propagate through intra-class call
       edges — ``step() -> _admit() -> self.params`` is guarded even though
       ``_admit`` never names the lock.
CC002  cycle in the lock-order graph. Edges come from nested ``with`` blocks
       and from calls made under a lock into methods (same or other class)
       whose transitive acquired-lock summary adds new locks.
CC003  condition-variable protocol: ``wait()`` outside a predicate loop,
       timed ``wait(t)`` with the result ignored outside a loop,
       wait/notify without the condition lock held.
CC004  check-then-act: an attribute read under a lock in one ``with`` block,
       then written under the same lock in a *later* block of the same
       method with the lock released in between — the re-acquired state may
       no longer satisfy the check. A write that re-reads the attribute
       first (read-modify-merge) is the safe idiom and stays clean.
CC005  blocking call while a lock is held — queue put/get, Event.wait,
       Thread.join, ``jax.device_get``/``block_until_ready``, file I/O,
       subprocess, time.sleep — directly or through a call whose transitive
       may-block summary is non-empty. A latency hazard on the serving hot
       path and a deadlock hazard everywhere.

All five ride the standard machinery: per-line ``# graftcheck: noqa[CC00x]``,
justified entries in ``graftcheck-baseline.txt``, ``--select CC`` (family
prefix), exit 1 on new findings. The model is computed once per ``run()``
(:func:`trlx_tpu_torch.analysis.conc.model.analyze`); each rule just replays the
records for its file.
"""

from typing import Iterable

from trlx_tpu_torch.analysis.core import FileContext, Finding, Rule, register
from trlx_tpu_torch.analysis.conc import model as conc_model


def _report_for(ctx: FileContext):
    """The project-wide ConcReport; single-file callers (tests, library use
    without ``run()``) get a throwaway one-file project."""
    project = ctx.project
    if project is None:
        from trlx_tpu_torch.analysis.callgraph import Project

        project = getattr(ctx, "_conc_project", None)
        if project is None:
            project = Project([ctx])
            ctx._conc_project = project
    return conc_model.analyze(project)


class _ConcRule(Rule):
    def check(self, ctx: FileContext) -> Iterable[Finding]:
        report = _report_for(ctx)
        for rule, node, message in report.records.get(ctx.rel, []):
            if rule == self.id:
                yield self.finding(ctx, node, message)


@register
class CC001SharedLockset(_ConcRule):
    id = "CC001"
    summary = "attribute shared across thread roles with no common lock (interprocedural)"


@register
class CC002LockOrderCycle(_ConcRule):
    id = "CC002"
    summary = "cycle in the lock-order graph (deadlock between threads)"


@register
class CC003CondProtocol(_ConcRule):
    id = "CC003"
    summary = "condition-variable misuse: bare wait outside a loop, unlocked wait/notify"


@register
class CC004CheckThenAct(_ConcRule):
    id = "CC004"
    summary = "lock released between a guarded check and the dependent guarded write"


@register
class CC005BlockingUnderLock(_ConcRule):
    id = "CC005"
    summary = "blocking call (queue/join/device sync/file I/O) while holding a lock"
