"""Shared AST reasoning for graftcheck rules: import aliases, dotted names,
parent maps, and the callable references a call hands on (the edges the
call graph follows into thread targets and hot-path callees).

A copy of ``trlx_tpu/analysis/astutils.py`` without its JAX-specific
discovery (``jax.jit`` roots, ``jax.random`` key flow): in the port the
roots of the hot-path rules are the registered census entrypoints
(:mod:`trlx_tpu_torch.analysis.census.entrypoints`), resolved by
:class:`trlx_tpu_torch.analysis.callgraph.Project`. ``Aliases.jax`` stays so
the concurrency model reports over the JAX package what its own copy does.
"""

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set


@dataclass
class Aliases:
    """Names each interesting module/function is bound to in one file."""

    jax: Set[str] = field(default_factory=set)
    numpy: Set[str] = field(default_factory=set)
    torch: Set[str] = field(default_factory=set)
    time: Set[str] = field(default_factory=set)
    threading: Set[str] = field(default_factory=set)
    thread_class: Set[str] = field(default_factory=set)  # `from threading import Thread`
    lock_factories: Set[str] = field(default_factory=set)  # `from threading import Lock`
    event_class: Set[str] = field(default_factory=set)  # `from threading import Event`


_LOCK_FACTORY_NAMES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}


def collect_aliases(tree: ast.Module) -> Aliases:
    al = Aliases()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                bound = a.asname or a.name.split(".")[0]
                if a.name == "jax" or (a.asname is None and a.name.startswith("jax.")):
                    al.jax.add(bound)
                if a.name == "numpy":
                    al.numpy.add(bound)
                if a.name == "torch" or (a.asname is None and a.name.startswith("torch.")):
                    al.torch.add(bound)
                if a.name == "time":
                    al.time.add(bound)
                if a.name == "threading":
                    al.threading.add(bound)
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            for a in node.names:
                bound = a.asname or a.name
                if mod == "threading" and a.name == "Thread":
                    al.thread_class.add(bound)
                elif mod == "threading" and a.name in _LOCK_FACTORY_NAMES:
                    al.lock_factories.add(bound)
                elif mod == "threading" and a.name == "Event":
                    al.event_class.add(bound)
    return al


#: Call names (last dotted component) treated as *higher-order entry points*:
#: a function-valued argument handed to one of these runs — maybe later, maybe
#: on another thread — so for reachability the reference IS a call edge:
#: activation checkpointing (``checkpoint(run_block, ...)``),
#: ``functools.partial``, and the runtime's thread/callback spawners
#: (``threading.Thread(target=self._loop)``, ``watchdog.escalate(name, cb)``).
HOF_NAMES = frozenset({"checkpoint", "partial", "map", "Thread", "Timer", "escalate"})


def callable_arg_refs(call: ast.Call) -> List[ast.AST]:
    """Function-valued references passed *into* a call: lambdas anywhere
    (they execute as part of the call), plus Name/Attribute args when the
    callee is a known higher-order entry point (:data:`HOF_NAMES`). Used by
    the call graph so ``checkpoint(run_block, ...)``,
    ``Thread(target=self._x)`` and ``escalate(name, cb)`` count as calls."""
    fn = call.func
    last: Optional[str] = None
    if isinstance(fn, ast.Name):
        last = fn.id
    elif isinstance(fn, ast.Attribute):
        last = fn.attr
    out: List[ast.AST] = []
    for a in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(a, ast.Lambda):
            out.append(a)
        elif last in HOF_NAMES and isinstance(a, (ast.Name, ast.Attribute)):
            out.append(a)
    return out


def _closure_callees(call: ast.Call, defs_by_name: Dict[str, List[ast.AST]]) -> List[ast.AST]:
    """Same-file defs a call may reach: bare-name calls plus callable args to
    higher-order entry points (``fn`` in ``checkpoint(fn, ...)``, ``self._x``
    in ``Thread(target=self._x)`` — bound methods resolve by bare attr name)."""
    out: List[ast.AST] = []
    if isinstance(call.func, ast.Name):
        out.extend(defs_by_name.get(call.func.id, []))
    for ref in callable_arg_refs(call):
        if isinstance(ref, ast.Lambda):
            out.append(ref)
        elif isinstance(ref, ast.Name):
            out.extend(defs_by_name.get(ref.id, []))
        elif isinstance(ref, ast.Attribute) and isinstance(ref.value, ast.Name) and ref.value.id == "self":
            out.extend(defs_by_name.get(ref.attr, []))
    return out


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def build_parents(tree: ast.Module) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def iter_functions(tree: ast.Module) -> Iterable[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            yield node
