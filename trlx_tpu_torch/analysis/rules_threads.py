"""graftcheck thread rules: lock discipline and thread hygiene.

TH001  lock-discipline inference per class. If any method writes
       ``self.attr`` inside ``with self._lock:``, the class has declared that
       attribute lock-guarded — every read or write of it outside a lock
       block (in any method but ``__init__``, which runs before the object is
       shared) is a data race candidate. Writes include container mutation
       (``self._items.extend(...)`` under the lock guards ``_items``).
TH002  thread hygiene. A ``threading.Thread`` that is neither ``daemon=``
       nor joined anywhere in the file outlives shutdown invisibly: it keeps
       the process alive (non-daemon) or dies mid-write (daemon with no
       join), and either way there is no reachable shutdown path for it.

Both rules are per-class / per-file approximations: they do not see
cross-file subclassing or locks passed between objects. That bias is
deliberate — the port's threads (the rollout producer, the checkpoint
writer, the watchdog) each keep a single-class, single-file lock scheme,
exactly the shape these rules can prove things about. A copy of
``trlx_tpu/analysis/rules_threads.py``, rule for rule.
"""

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from trlx_tpu_torch.analysis.core import FileContext, Finding, Rule, register
from trlx_tpu_torch.analysis.astutils import collect_aliases, dotted

#: Attribute names that denote a lock even without seeing the factory call.
_LOCK_NAME_RE = re.compile(r"lock|mutex|cond|_cv$|sem(aphore)?", re.IGNORECASE)

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

#: Method calls that mutate their receiver (list/deque/dict/set surface).
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "pop", "popleft",
    "popitem", "remove", "discard", "clear", "update", "setdefault", "add",
    "sort", "reverse", "rotate",
}


def _is_lock_factory(call: ast.Call, al) -> bool:
    d = dotted(call.func)
    if d is None:
        return False
    parts = d.split(".")
    if parts[0] in al.threading and parts[-1] in _LOCK_FACTORIES:
        return True
    return len(parts) == 1 and parts[0] in al.lock_factories


class _MethodAccesses(ast.NodeVisitor):
    """Collect self-attribute accesses in one method, tagged guarded/unguarded.

    ``guarded`` means lexically inside ``with self.<lock>:`` for any of the
    class's lock attributes. ``self`` is whatever the method's first
    parameter is named.
    """

    def __init__(self, self_name: str, lock_attrs: Set[str]):
        self.self_name = self_name
        self.lock_attrs = lock_attrs
        self.depth = 0  # > 0 while inside a lock-guarded with-block
        # attr -> list of (node, is_write, guarded)
        self.accesses: List[Tuple[str, ast.AST, bool, bool]] = []

    def _self_attr(self, node) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == self.self_name
        ):
            return node.attr
        return None

    def visit_With(self, node):
        locked = any(
            self._self_attr(item.context_expr) in self.lock_attrs
            for item in node.items
        )
        for item in node.items:
            self.visit(item.context_expr)
        if locked:
            self.depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if locked:
            self.depth -= 1

    visit_AsyncWith = visit_With

    def visit_Attribute(self, node):
        attr = self._self_attr(node)
        if attr is not None and attr not in self.lock_attrs:
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            self.accesses.append((attr, node, is_write, self.depth > 0))
        self.generic_visit(node)

    def visit_Call(self, node):
        # self.attr.mutator(...) counts as a write to attr
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
            attr = self._self_attr(fn.value)
            if attr is not None and attr not in self.lock_attrs:
                self.accesses.append((attr, node, True, self.depth > 0))
        self.generic_visit(node)

    def visit_Subscript(self, node):
        # self.attr[k] = v / del self.attr[k]
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            attr = self._self_attr(node.value)
            if attr is not None and attr not in self.lock_attrs:
                self.accesses.append((attr, node, True, self.depth > 0))
        self.generic_visit(node)


@register
class TH001LockDiscipline(Rule):
    id = "TH001"
    summary = "attribute guarded by a lock in one method, accessed without it in another"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        al = collect_aliases(ctx.tree)
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(ctx, node, al))
        return findings

    def _methods(self, cls: ast.ClassDef):
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield stmt

    def _check_class(self, ctx: FileContext, cls: ast.ClassDef, al) -> Iterable[Finding]:
        # 1. which attributes are locks?
        lock_attrs: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if _is_lock_factory(node.value, al):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute):
                            lock_attrs.add(t.attr)
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    d = dotted(item.context_expr)
                    if d and d.count(".") == 1 and _LOCK_NAME_RE.search(d.split(".")[1]):
                        lock_attrs.add(d.split(".")[1])
        if not lock_attrs:
            return []

        # 2. per-method access maps
        per_method: Dict[str, _MethodAccesses] = {}
        for meth in self._methods(cls):
            if not meth.args.args:
                continue
            self_name = meth.args.args[0].arg
            acc = _MethodAccesses(self_name, lock_attrs)
            for stmt in meth.body:
                acc.visit(stmt)
            per_method[meth.name] = acc

        # 3. guarded = written under a lock anywhere
        guarded: Dict[str, str] = {}  # attr -> method that guards it
        for name, acc in per_method.items():
            for attr, _node, is_write, is_guarded in acc.accesses:
                if is_write and is_guarded and attr not in guarded:
                    guarded[attr] = name

        # 4. unguarded accesses to guarded attrs, outside __init__
        findings: List[Finding] = []
        seen_lines: Set[Tuple[str, int]] = set()
        for name, acc in per_method.items():
            if name == "__init__":
                continue
            for attr, node, is_write, is_guarded in acc.accesses:
                if is_guarded or attr not in guarded:
                    continue
                key = (attr, node.lineno)
                if key in seen_lines:
                    continue
                seen_lines.add(key)
                kind = "written" if is_write else "read"
                findings.append(
                    self.finding(
                        ctx,
                        node,
                        f"{cls.name}.{attr} is lock-guarded (written under a "
                        f"lock in {guarded[attr]}()) but {kind} without the "
                        f"lock in {name}()",
                    )
                )
        return findings


@register
class TH002ThreadHygiene(Rule):
    id = "TH002"
    summary = "threading.Thread without daemon= and without a reachable join()"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        al = collect_aliases(ctx.tree)
        if not (al.threading or al.thread_class):
            return []

        # names/attrs that have .join() called on them, or .daemon set, file-wide
        joined: Set[str] = set()
        daemon_set: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if node.func.attr == "join":
                    base = dotted(node.func.value)
                    if base:
                        joined.add(base.split(".")[-1])
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and t.attr == "daemon":
                        base = dotted(t.value)
                        if base:
                            daemon_set.add(base.split(".")[-1])
            # `for t in threads: t.join()` joins the collection `threads`
            if isinstance(node, (ast.For, ast.AsyncFor)):
                coll = dotted(node.iter)
                loopvar = dotted(node.target)
                if coll and loopvar:
                    for inner in ast.walk(node):
                        if (
                            isinstance(inner, ast.Call)
                            and isinstance(inner.func, ast.Attribute)
                            and inner.func.attr == "join"
                            and dotted(inner.func.value) == loopvar
                        ):
                            joined.add(coll.split(".")[-1])

        parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(ctx.tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node

        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if not self._is_thread_ctor(node, al):
                continue
            if any(kw.arg == "daemon" for kw in node.keywords):
                continue
            bound = self._binding(node, parents)
            if bound is not None and (bound in joined or bound in daemon_set):
                continue
            where = f"bound to {bound!r}" if bound else "unbound"
            findings.append(
                self.finding(
                    ctx,
                    node,
                    f"threading.Thread ({where}) has no daemon= and no "
                    f"join() reachable in this file: it will outlive shutdown",
                )
            )
        return findings

    def _is_thread_ctor(self, call: ast.Call, al) -> bool:
        fn = call.func
        if isinstance(fn, ast.Name):
            return fn.id in al.thread_class
        d = dotted(fn)
        if d is None:
            return False
        parts = d.split(".")
        return parts[0] in al.threading and parts[-1] == "Thread"

    def _binding(self, call: ast.Call, parents) -> Optional[str]:
        """The terminal name the Thread is assigned to (``t`` or ``_thread``
        for ``self._thread``), walking up through expression wrappers —
        list/dict displays and comprehensions bind to the enclosing Assign's
        target (the ``threads = [Thread(...) for ...]`` idiom)."""
        node: ast.AST = call
        while True:
            parent = parents.get(node)
            if parent is None or isinstance(parent, ast.stmt):
                break
            node = parent
        if isinstance(parent, ast.Assign):
            for t in parent.targets:
                d = dotted(t)
                if d:
                    return d.split(".")[-1]
        return None
