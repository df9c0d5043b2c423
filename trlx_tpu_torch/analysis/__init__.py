"""graftcheck for the port: concurrency- and PyTorch-aware static analysis.

A copy of the JAX package's analyzer (``trlx_tpu/analysis``) with the
port's rule families. Every rule, with an offending example and its fix, is
in its module's docstring:

======  ==============================================================
TH001   lock-guarded attribute accessed without the lock elsewhere
TH002   threading.Thread with neither daemon= nor a reachable join()
CC001   attribute shared across thread roles (spawned threads, escalation
        callbacks, multi-threaded public API) with an empty lockset
        intersection — interprocedural, lifts TH001's lexical limit
CC002   cycle in the lock-order graph (deadlock), edges propagated
        through call-graph acquired-lock summaries
CC003   condition-variable protocol: bare wait() outside a predicate
        loop, ignored wait-timeout result, wait/notify without the lock
CC004   check-then-act: lock released between a guarded read and the
        dependent guarded write in the same method
CC005   blocking call (queue put/get, Event.wait, Thread.join, file I/O)
        while holding a lock
TX001   sampling op with no generator= (the process-global RNG)
TX002   host round-trip reachable from a registered hot entrypoint
        beyond its declared readback
TX005   mesh axis as a string literal (a hard-coded known axis, or an
        unknown one), not a constant of parallel/mesh.py
TX007   reduction over bf16/f16 without dtype=, or a narrowing-then-
        widening .to() round trip
TX008   PartitionSpec with an axis outside the vocabulary, an axis on two
        dims, or a rank off the sharding table
======  ==============================================================

TH and CC are the reference's rules copied rule for rule: over either
package they report what ``trlx_tpu.analysis`` reports. TX rules are the
eager counterparts of the reference's JX rules
(:mod:`trlx_tpu_torch.analysis.rules_torch` says which JX rules have none).
``TRLX_CONC_SEED_REGRESSION=scheduler_race`` seeds the scheduler race in
memory as a must-fail gate self-test.

The dynamic half, the counterpart of the reference's ``analysis/ir`` and
``analysis/rt``, is :mod:`trlx_tpu_torch.analysis.census`: a per-step op,
launch, round-trip, shape and memory census of the registered hot
entrypoints (on a mesh also its collectives by kind and axes, one process
per rank), held to a committed budget.

Run: ``python -m trlx_tpu_torch.analysis PATH...`` (exit 1 on new findings).
Suppress per line with ``# graftcheck: noqa[RULE]``; grandfather with a
justified entry in ``trlx_tpu_torch/analysis/baseline.txt``.
"""

#: the analyzer's API, imported on first use: the modules that register hot
#: entrypoints import ``analysis.census.entrypoints`` at module scope, and must
#: not load the rules to do so
__all__ = ["Finding", "FileContext", "RULES", "Rule", "check_file", "load_context", "register", "run"]


def __getattr__(name):
    if name in __all__:
        from trlx_tpu_torch.analysis import core

        core.load_rules()
        return getattr(core, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
