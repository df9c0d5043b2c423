"""Seeded concurrency regressions: prove the conc gate catches the bug class
it was built for, without keeping broken code in the tree.

When ``TRLX_CONC_SEED_REGRESSION`` names a seed, :func:`apply` rewrites the
parsed AST of the affected file *in memory* — source on disk is untouched —
so the analyzer sees the historical bug and must exit 1.

``scheduler_race``
    Re-introduces the serving-scheduler race of the reference:
    ``InflightScheduler``'s ``finished`` map is written by producer-side
    ``cancel()`` under ``self._lock`` and by the engine-side ``_finish()`` —
    the seed strips the ``with self._lock:`` wrapper inside ``_finish``
    (``trlx_tpu_torch/serving/scheduler.py``). CC001 must flag ``finished``
    (engine-thread write with an empty lockset vs the locked producer side).

Used as a must-fail self-test of the gate by
``tests/test_torch_analysis_conc.py`` and ``chip_smoke.py``.
"""

import ast
import os
from typing import List

ENV_VAR = "TRLX_CONC_SEED_REGRESSION"

_SEEDS = ("scheduler_race",)


def _unwrap_lock(fn: ast.AST) -> bool:
    """Replace every ``with self._lock: BODY`` statement directly in ``fn``'s
    body (recursively) with BODY. True when something was unwrapped."""
    changed = False

    class T(ast.NodeTransformer):
        def visit_With(self, node):
            nonlocal changed
            self.generic_visit(node)
            for item in node.items:
                ce = item.context_expr
                if (
                    isinstance(ce, ast.Attribute)
                    and ce.attr == "_lock"
                    and isinstance(ce.value, ast.Name)
                    and ce.value.id == "self"
                ):
                    changed = True
                    return node.body
            return node

    T().visit(fn)
    ast.fix_missing_locations(fn)
    return changed


def apply(contexts: List) -> None:
    """Mutate the parsed contexts per ``TRLX_CONC_SEED_REGRESSION``. No-op
    when the variable is unset; ValueError on an unknown seed name."""
    seed = os.environ.get(ENV_VAR)
    if not seed:
        return
    if seed not in _SEEDS:
        raise ValueError(f"unknown {ENV_VAR} seed {seed!r}; known: {', '.join(_SEEDS)}")
    if seed == "scheduler_race":
        for ctx in contexts:
            if not ctx.rel.endswith("serving/scheduler.py"):
                continue
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.ClassDef) and node.name == "InflightScheduler":
                    for stmt in node.body:
                        if (
                            isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and stmt.name == "_finish"
                        ):
                            _unwrap_lock(stmt)
