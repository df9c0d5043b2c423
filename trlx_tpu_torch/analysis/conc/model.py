"""graftcheck-conc model: thread roots, shared objects, static locksets.

TH001 proves lock discipline per class, per file, lexically. This module is
the interprocedural half the threaded runtime now needs: it consumes the
repo-wide call graph (:class:`trlx_tpu_torch.analysis.callgraph.Project`) and
computes, once per ``run()``:

1. **Thread roots** — ``threading.Thread(target=...)`` constructions
   (bound methods, nested closures, imported functions), ``threading.Timer``,
   and watchdog ``escalate(name, callback)`` registrations, straight from
   :attr:`Project.thread_targets`. A bound-method target is narrowed to the
   class lexically enclosing the spawn site.

2. **Thread roles per method** — every class method is tagged with the set of
   execution contexts it may run in: ``thread:<m>``/``callback:<m>`` for
   spawned roots and everything intra-class-reachable from them, ``api:<m>``
   per public entry point of a lock-owning class (owning a lock *declares*
   the API multi-threaded), one collapsed ``caller`` role for the public
   surface of lock-less classes (their API is single-threaded unless a spawn
   says otherwise), and ``init`` for ``__init__``-only code (construction
   happens-before sharing). A private method never called inside the class is
   treated as externally callable — its own entry role.

3. **Eraser-style static locksets** — lexical ``with self.<lock>:`` nesting
   per access, plus an *entry lockset* propagated through intra-class call
   edges to a fixpoint: a private method whose every call site holds
   ``self._lock`` inherits ``{_lock}``, so ``step() -> _admit() ->
   self.params`` is provably guarded even though ``_admit`` never names the
   lock. Entry points (public/spawned) enter with the empty lockset.

4. **Cross-class summaries** — attributes are typed from constructor
   assignments (``self.scheduler = InflightScheduler(...)``) and parameter
   annotations (``engine: ServingEngine``), which threads objects between
   classes; per-method *acquired-locks* and *may-block* summaries flow over
   those edges to a project-wide fixpoint, feeding the lock-order graph
   (CC002) and blocking-under-lock (CC005).

A copy of ``trlx_tpu/analysis/conc/model.py``, rule for rule: over either
package it reports what the reference reports (``tests/test_torch_analysis_conc.py``).

The emitters (:func:`analyze`) turn this model into CC001–CC005 records;
:mod:`trlx_tpu_torch.analysis.conc.rules_conc` wraps them as registered rules so
they ride the normal noqa/baseline/--select machinery.

Approximations, chosen so a missed edge loses a finding but a wrong edge
does not invent one (same bias as the call graph): lock identity is the
``(class, attr)`` pair (locks passed around as bare arguments are invisible);
``lock.acquire()`` without ``with`` is not modeled; module-level functions
have no roles (class-centric by design); a non-spawned nested def is analyzed
as part of its enclosing method.
"""

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from trlx_tpu_torch.analysis.astutils import Aliases, build_parents, dotted
from trlx_tpu_torch.analysis.rules_threads import _LOCK_NAME_RE, _MUTATORS

#: factory call (last dotted component) -> sync attribute kind
_SYNC_FACTORIES = {
    "Lock": "lock",
    "RLock": "lock",
    "Condition": "cond",
    "Semaphore": "sem",
    "BoundedSemaphore": "sem",
    "Event": "event",
}

#: sync kinds that can be held via ``with`` (participate in locksets)
_HOLDABLE = {"lock", "cond", "sem"}

#: ``module.fn`` calls that block the calling thread (textual module names —
#: these stdlib modules are imported unaliased everywhere in this repo)
_BLOCKING_MODULE_CALLS = {
    ("time", "sleep"): "time.sleep",
    ("os", "replace"): "file I/O (os.replace)",
    ("os", "fsync"): "file I/O (os.fsync)",
    ("os", "rename"): "file I/O (os.rename)",
    ("shutil", "rmtree"): "file I/O (shutil.rmtree)",
    ("shutil", "copytree"): "file I/O (shutil.copytree)",
    ("subprocess", "run"): "subprocess.run",
    ("subprocess", "check_call"): "subprocess.check_call",
    ("subprocess", "check_output"): "subprocess.check_output",
}


@dataclass
class AttrType:
    """What one ``self.<attr>`` holds, as far as statics can tell."""

    kind: str  # "thread" | "queue" | "obj"
    class_name: str = ""
    target: Optional["ClassModel"] = None  # resolved scanned class, if any
    queue_like: bool = False  # name says Queue (blocking put/get surface)


@dataclass
class Access:
    attr: str
    node: ast.AST
    write: bool
    locks: FrozenSet[str]  # lexically held lock ids at the access
    method: "MethodModel"


@dataclass
class CallSite:
    node: ast.Call
    locks: FrozenSet[str]
    method: "MethodModel"
    self_callee: Optional[str] = None  # ``self.m(...)``
    attr_callee: Optional[Tuple[str, str]] = None  # (attr, method): ``self.x.m(...)``


@dataclass
class Acquire:
    lock: str
    node: ast.AST
    held: FrozenSet[str]  # locks lexically held when this one is acquired
    method: "MethodModel"


@dataclass
class CondOp:
    kind: str  # "wait" | "wait_for" | "notify" | "notify_all"
    attr: str
    node: ast.Call
    locks: FrozenSet[str]
    cond_lock: str
    in_loop: bool  # a While/For sits between the with-cond and the call
    timed: bool
    discarded: bool  # call result unused (statement expression)
    method: "MethodModel"


@dataclass
class BlockOp:
    desc: str
    node: ast.AST
    locks: FrozenSet[str]
    method: "MethodModel"


@dataclass
class Region:
    """One ``with self.<lock>:`` block — the CC004 unit of atomicity."""

    lock: str
    node: ast.AST
    first_kind: Dict[str, str] = field(default_factory=dict)  # attr -> "read"|"write"
    reads: Dict[str, ast.AST] = field(default_factory=dict)
    writes: Dict[str, ast.AST] = field(default_factory=dict)


@dataclass
class MethodModel:
    name: str
    node: ast.AST
    cls: "ClassModel"
    self_name: str
    spawned: bool = False
    spawn_kind: str = ""  # "thread" | "callback"
    public: bool = False
    is_init: bool = False
    accesses: List[Access] = field(default_factory=list)
    calls: List[CallSite] = field(default_factory=list)
    acquires: List[Acquire] = field(default_factory=list)
    cond_ops: List[CondOp] = field(default_factory=list)
    block_ops: List[BlockOp] = field(default_factory=list)
    regions: List[Region] = field(default_factory=list)
    roles: Set[str] = field(default_factory=set)
    entry_locks: Optional[FrozenSet[str]] = None  # None = unreached in the EL fixpoint


@dataclass
class ClassModel:
    module: str
    rel: str  # file the class lives in, for findings
    node: ast.ClassDef
    name: str
    aliases: Aliases
    info: object  # callgraph.ModuleInfo
    sync_attrs: Dict[str, str] = field(default_factory=dict)  # attr -> sync kind
    attr_types: Dict[str, AttrType] = field(default_factory=dict)
    methods: Dict[str, MethodModel] = field(default_factory=dict)

    @property
    def has_lock(self) -> bool:
        return any(k in _HOLDABLE for k in self.sync_attrs.values())

    def lock_id(self, attr: str) -> str:
        return f"{self.module}::{self.name}.{attr}"


def fmt_lock(lock_id: str) -> str:
    """Display form of a lock id: ``Class.attr`` (module prefix dropped)."""
    return lock_id.split("::", 1)[-1]


def fmt_locks(locks: Iterable[str]) -> str:
    return "{" + ", ".join(sorted(fmt_lock(x) for x in locks)) + "}"


@dataclass
class ConcReport:
    """CC001–CC005 records per file, produced once per project."""

    #: rel path -> [(rule id, anchor node, message)]
    records: Dict[str, List[Tuple[str, ast.AST, str]]] = field(default_factory=dict)
    classes: List[ClassModel] = field(default_factory=list)

    def add(self, rel: str, rule: str, node: ast.AST, message: str) -> None:
        self.records.setdefault(rel, []).append((rule, node, message))


# ---------------------------------------------------------------------------
# per-method AST visitor
# ---------------------------------------------------------------------------


class _MethodVisitor(ast.NodeVisitor):
    """Collect accesses/acquisitions/calls/cond-ops/blocking-ops for one
    method body, tracking the lexically held lockset. ``skip`` holds nested
    def nodes analyzed separately (spawned closures)."""

    def __init__(self, method: MethodModel, skip: Set[int]):
        self.m = method
        self.cls = method.cls
        self.skip = skip
        self.held: List[str] = []
        self.stack: List[Tuple[str, object]] = []  # ("loop", node) | ("with", locks)
        self.region_stack: List[Region] = []
        self.local_attr: Dict[str, str] = {}  # local name -> aliased self attr
        self.local_kind: Dict[str, str] = {}  # local name -> "thread"

    # -- helpers ------------------------------------------------------------

    def _self_attr(self, node) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == self.m.self_name
        ):
            return node.attr
        return None

    def _lock_of(self, expr) -> Optional[str]:
        attr = self._self_attr(expr)
        if attr is not None and self.cls.sync_attrs.get(attr) in _HOLDABLE:
            return self.cls.lock_id(attr)
        return None

    def _record(self, attr: str, node: ast.AST, write: bool) -> None:
        if attr in self.cls.sync_attrs:
            return  # lock/cond/event objects themselves are not shared data
        self.m.accesses.append(Access(attr, node, write, frozenset(self.held), self.m))
        for region in self.region_stack:
            if attr not in region.first_kind:
                region.first_kind[attr] = "write" if write else "read"
            if write:
                region.writes.setdefault(attr, node)
            else:
                region.reads.setdefault(attr, node)

    def _block(self, desc: str, node: ast.AST) -> None:
        self.m.block_ops.append(BlockOp(desc, node, frozenset(self.held), self.m))

    # -- assignment targets: self.a / self.a.b / self.a[k] are writes to a --

    def _record_target(self, t, aug: bool = False) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for elt in t.elts:
                self._record_target(elt, aug)
            return
        expr = t
        while isinstance(expr, (ast.Attribute, ast.Subscript)):
            if isinstance(expr, ast.Subscript):
                self.visit(expr.slice)  # the key is an ordinary read expression
            attr = self._self_attr(expr if isinstance(expr, ast.Attribute) else expr.value)
            if attr is not None:
                if aug:
                    self._record(attr, expr, write=False)  # += reads before writing
                self._record(attr, expr, write=True)
                return
            expr = expr.value
        self.visit(t)  # plain Name / other target shapes

    def visit_Assign(self, node):
        # local alias tracking (``t = self._thread`` / ``t = Thread(...)``)
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            src = self._self_attr(node.value)
            if src is not None:
                self.local_attr[name] = src
            elif isinstance(node.value, ast.Call):
                d = dotted(node.value.func)
                if d and d.split(".")[-1] in ("Thread", "Timer"):
                    self.local_kind[name] = "thread"
        # value before targets: Python evaluates the RHS first, and CC004's
        # read-before-write test depends on that order (`self.p = kept +
        # self.p` re-reads the attribute — the safe read-modify-merge idiom)
        self.visit(node.value)
        for t in node.targets:
            self._record_target(t)

    def visit_AugAssign(self, node):
        self.visit(node.value)
        self._record_target(node.target, aug=True)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self.visit(node.value)
        self._record_target(node.target)

    def visit_Delete(self, node):
        for t in node.targets:
            self._record_target(t)

    def visit_Attribute(self, node):
        attr = self._self_attr(node)
        if attr is not None:
            self._record(attr, node, write=isinstance(node.ctx, (ast.Store, ast.Del)))
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            attr = self._self_attr(node.value)
            if attr is not None:
                self._record(attr, node, write=True)
                self.visit(node.slice)
                return
        self.generic_visit(node)

    # -- scopes, loops, with ------------------------------------------------

    def visit_FunctionDef(self, node):
        if id(node) in self.skip:
            return  # spawned closure: analyzed as its own method model
        self.generic_visit(node)  # non-spawned nested defs run on this thread

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_While(self, node):
        self.stack.append(("loop", node))
        self.generic_visit(node)
        self.stack.pop()

    def visit_For(self, node):
        self.stack.append(("loop", node))
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFor = visit_For

    def visit_With(self, node):
        acquired: List[str] = []
        for item in node.items:
            self.visit(item.context_expr)
            lock = self._lock_of(item.context_expr)
            if lock is not None and lock not in self.held:
                self.m.acquires.append(Acquire(lock, node, frozenset(self.held), self.m))
                self.held.append(lock)
                region = Region(lock, node)
                self.region_stack.append(region)
                self.m.regions.append(region)
                acquired.append(lock)
            if item.optional_vars is not None:
                self._record_target(item.optional_vars)
        self.stack.append(("with", tuple(acquired)))
        for stmt in node.body:
            self.visit(stmt)
        self.stack.pop()
        for _ in acquired:
            self.held.pop()
            self.region_stack.pop()

    visit_AsyncWith = visit_With

    # -- calls --------------------------------------------------------------

    def _receiver_type(self, base) -> Tuple[Optional[str], Optional[AttrType], Optional[str]]:
        """(attr name, declared AttrType, sync kind) for a call receiver:
        ``self.x`` directly, or a local alias of it."""
        attr = self._self_attr(base)
        if attr is None and isinstance(base, ast.Name):
            attr = self.local_attr.get(base.id)
            if attr is None and self.local_kind.get(base.id) == "thread":
                return None, AttrType(kind="thread"), None
        if attr is None:
            return None, None, None
        return attr, self.cls.attr_types.get(attr), self.cls.sync_attrs.get(attr)

    def _cond_in_loop(self, cond_lock: str) -> bool:
        """Is there a loop between the innermost ``with`` holding the cond
        and this call? When the cond is not lexically held (entry-lockset
        case) any enclosing loop counts."""
        seen_loop = False
        for kind, payload in reversed(self.stack):
            if kind == "loop":
                seen_loop = True
            elif kind == "with" and cond_lock in payload:  # type: ignore[operator]
                return seen_loop
        return seen_loop

    def visit_Call(self, node):
        fn = node.func
        if isinstance(fn, ast.Attribute):
            base, meth = fn.value, fn.attr
            # container mutation is a write to the receiver attribute
            if meth in _MUTATORS:
                attr = self._self_attr(base)
                if attr is not None:
                    self._record(attr, node, write=True)
            attr, atype, sync = self._receiver_type(base)
            if sync == "cond" and meth in ("wait", "wait_for", "notify", "notify_all"):
                cond_lock = self.cls.lock_id(attr)
                self.m.cond_ops.append(
                    CondOp(
                        kind=meth,
                        attr=attr,
                        node=node,
                        locks=frozenset(self.held),
                        cond_lock=cond_lock,
                        in_loop=self._cond_in_loop(cond_lock),
                        timed=bool(node.args or node.keywords),
                        discarded=False,  # filled from the parent map post-walk
                        method=self.m,
                    )
                )
            elif sync == "event" and meth == "wait":
                self._block(f"Event.wait ({attr})", node)
            elif sync in ("lock", "sem") and meth == "acquire":
                # blocking by definition when another lock is already held
                self._block(f"{fmt_lock(self.cls.lock_id(attr))}.acquire()", node)
            elif atype is not None and atype.kind == "thread" and meth == "join":
                self._block("Thread.join", node)
            elif atype is not None and atype.target is not None:
                self.m.calls.append(
                    CallSite(node, frozenset(self.held), self.m, attr_callee=(attr, meth))
                )
            elif atype is not None and atype.queue_like and meth in ("put", "get", "join"):
                self._block(f"queue {meth} ({attr})", node)
            elif meth == "block_until_ready":
                self._block("block_until_ready", node)
            elif isinstance(base, ast.Name) and base.id == self.m.self_name:
                self.m.calls.append(
                    CallSite(node, frozenset(self.held), self.m, self_callee=meth)
                )
            else:
                d = dotted(fn)
                if d is not None and "." in d:
                    root, last = d.split(".")[0], d.split(".")[-1]
                    blocked = _BLOCKING_MODULE_CALLS.get((root, last))
                    if root in self.cls.aliases.time and last == "sleep":
                        self._block("time.sleep", node)
                    elif blocked is not None:
                        self._block(blocked, node)
                    elif root in self.cls.aliases.jax and last in ("device_get", "block_until_ready"):
                        # the reference's device syncs: kept so this copy
                        # reports over the JAX package what its own gate does
                        self._block(f"jax.{last}", node)
        elif isinstance(fn, ast.Name) and fn.id == "open":
            self._block("file I/O (open)", node)
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# model construction
# ---------------------------------------------------------------------------


def _ann_names(ann) -> List[str]:
    """Candidate type names in an annotation (handles Optional[...] nesting
    and string annotations)."""
    if ann is None:
        return []
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return re.findall(r"[A-Za-z_][A-Za-z0-9_]*", ann.value)
    out: List[str] = []
    for n in ast.walk(ann):
        if isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Attribute):
            out.append(n.attr)
    return out


class _ModelAssembly:
    def __init__(self, project):
        self.project = project
        self.classes: List[ClassModel] = []
        self.by_key: Dict[Tuple[str, str], ClassModel] = {}
        self.by_name: Dict[str, List[ClassModel]] = {}
        self.method_of: Dict[int, Tuple[ClassModel, str]] = {}  # id(def) -> owner
        self._parents: Dict[str, Dict[ast.AST, ast.AST]] = {}

    # -- shells -------------------------------------------------------------

    def collect_classes(self) -> None:
        for name, info in self.project.modules.items():
            for node in ast.walk(info.ctx.tree):
                if isinstance(node, ast.ClassDef):
                    cm = ClassModel(
                        module=name,
                        rel=info.ctx.rel,
                        node=node,
                        name=node.name,
                        aliases=info.aliases,
                        info=info,
                    )
                    self.classes.append(cm)
                    self.by_key.setdefault((name, node.name), cm)
                    self.by_name.setdefault(node.name, []).append(cm)
                    for stmt in node.body:
                        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            self.method_of[id(stmt)] = (cm, stmt.name)

    def parents_for(self, module: str) -> Dict[ast.AST, ast.AST]:
        if module not in self._parents:
            self._parents[module] = build_parents(self.project.modules[module].ctx.tree)
        return self._parents[module]

    # -- thread roots -------------------------------------------------------

    def collect_spawns(self) -> Tuple[Dict[int, str], Dict[int, str]]:
        """(spawned method def id -> kind, spawned nested def id -> kind)."""
        method_spawn: Dict[int, str] = {}
        nested_spawn: Dict[int, str] = {}
        for tt in self.project.thread_targets:
            # a bound-method target narrows to the class enclosing the spawn
            if (
                isinstance(tt.target, ast.Attribute)
                and isinstance(tt.target.value, ast.Name)
                and tt.target.value.id == "self"
            ):
                parents = self.parents_for(tt.module)
                node: Optional[ast.AST] = tt.call
                encl: Optional[ClassModel] = None
                while node is not None:
                    node = parents.get(node)
                    if isinstance(node, ast.ClassDef):
                        encl = self.by_key.get((tt.module, node.name))
                        break
                if encl is not None:
                    for stmt in encl.node.body:
                        if (
                            isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and stmt.name == tt.target.attr
                        ):
                            method_spawn[id(stmt)] = tt.kind
                            break
                    else:
                        self._mark_resolved(tt, method_spawn, nested_spawn)
                    continue
            self._mark_resolved(tt, method_spawn, nested_spawn)
        return method_spawn, nested_spawn

    def _mark_resolved(self, tt, method_spawn, nested_spawn) -> None:
        for mod, d in tt.resolved:
            if id(d) in self.method_of:
                method_spawn[id(d)] = tt.kind
                continue
            # nested closure: attach to its enclosing class method, if any
            parents = self.parents_for(mod) if mod in self.project.modules else {}
            node: Optional[ast.AST] = d
            while node is not None:
                node = parents.get(node)
                if node is not None and id(node) in self.method_of:
                    nested_spawn[id(d)] = tt.kind
                    break

    # -- attribute typing ---------------------------------------------------

    def _resolve_class(self, cm: ClassModel, name: str) -> Optional[ClassModel]:
        local = self.by_key.get((cm.module, name))
        if local is not None:
            return local
        sym = cm.info.symbol_bindings.get(name)
        if sym is not None:
            hit = self.by_key.get(sym)
            if hit is not None:
                return hit
        cands = self.by_name.get(name, [])
        return cands[0] if len(cands) == 1 else None

    def _classify_value(self, cm: ClassModel, attr: str, value) -> None:
        if not isinstance(value, ast.Call):
            return
        d = dotted(value.func)
        if d is None:
            return
        parts = d.split(".")
        root, last = parts[0], parts[-1]
        al = cm.aliases
        sync = _SYNC_FACTORIES.get(last)
        if sync is not None and (
            (len(parts) >= 2 and root in al.threading)
            or (len(parts) == 1 and (last in al.lock_factories or last in al.event_class))
        ):
            cm.sync_attrs.setdefault(attr, sync)
            return
        if last in ("Thread", "Timer") and (root in al.threading or last in al.thread_class):
            cm.attr_types.setdefault(attr, AttrType(kind="thread"))
            return
        target = None
        if len(parts) == 1:
            target = self._resolve_class(cm, last)
        elif root in cm.info.module_bindings:
            target = self.by_key.get((cm.info.module_bindings[root], last))
        if target is not None or last.endswith("Queue"):
            cm.attr_types.setdefault(
                attr,
                AttrType(
                    kind="obj" if target is not None else "queue",
                    class_name=last,
                    target=target,
                    queue_like=last.endswith("Queue"),
                ),
            )

    def _classify_ann(self, cm: ClassModel, attr: str, ann) -> None:
        for name in _ann_names(ann):
            if name == "Thread":
                cm.attr_types.setdefault(attr, AttrType(kind="thread"))
                return
            if name == "Condition":
                cm.sync_attrs.setdefault(attr, "cond")
                return
            if name == "Event":
                cm.sync_attrs.setdefault(attr, "event")
                return
            if name in ("Lock", "RLock"):
                cm.sync_attrs.setdefault(attr, "lock")
                return
            target = self._resolve_class(cm, name)
            if target is not None or name.endswith("Queue"):
                cm.attr_types.setdefault(
                    attr,
                    AttrType(
                        kind="obj" if target is not None else "queue",
                        class_name=name,
                        target=target,
                        queue_like=name.endswith("Queue"),
                    ),
                )
                return

    def type_attrs(self, cm: ClassModel) -> None:
        for meth in _class_methods(cm.node):
            if not meth.args.args:
                continue
            self_name = meth.args.args[0].arg
            params = {
                a.arg: a.annotation
                for a in list(meth.args.args) + list(meth.args.kwonlyargs)
                if a.annotation is not None
            }
            for node in ast.walk(meth):
                target = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target = node.targets[0]
                elif isinstance(node, ast.AnnAssign):
                    target = node.target
                if (
                    not isinstance(target, ast.Attribute)
                    or not isinstance(target.value, ast.Name)
                    or target.value.id != self_name
                ):
                    continue
                attr = target.attr
                if isinstance(node, ast.AnnAssign):
                    self._classify_ann(cm, attr, node.annotation)
                    if node.value is not None:
                        self._classify_value(cm, attr, node.value)
                else:
                    self._classify_value(cm, attr, node.value)
                    # ``self.queue = queue`` where the parameter is annotated
                    if isinstance(node.value, ast.Name) and node.value.id in params:
                        self._classify_ann(cm, attr, params[node.value.id])
            # TH001's heuristic: ``with self._lock:`` declares a lock even
            # when the factory call is inherited / out of sight
            for node in ast.walk(meth):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        d = dotted(item.context_expr)
                        if (
                            d is not None
                            and d.count(".") == 1
                            and d.split(".")[0] == self_name
                            and _LOCK_NAME_RE.search(d.split(".")[1])
                        ):
                            cm.sync_attrs.setdefault(d.split(".")[1], "lock")

    # -- method models ------------------------------------------------------

    def build_methods(self, cm: ClassModel, method_spawn, nested_spawn) -> None:
        for meth in _class_methods(cm.node):
            if not meth.args.args:
                continue
            self_name = meth.args.args[0].arg
            is_init = meth.name == "__init__"
            mm = MethodModel(
                name=meth.name,
                node=meth,
                cls=cm,
                self_name=self_name,
                spawned=id(meth) in method_spawn,
                spawn_kind=method_spawn.get(id(meth), ""),
                public=not meth.name.startswith("_") or _is_dunder(meth.name),
                is_init=is_init,
            )
            cm.methods[meth.name] = mm
            # spawned nested closures become their own roots
            skip: Set[int] = set()
            for node in ast.walk(meth):
                if node is not meth and id(node) in nested_spawn:
                    skip.add(id(node))
                    sub = MethodModel(
                        name=f"{meth.name}.<{getattr(node, 'name', 'lambda')}>",
                        node=node,
                        cls=cm,
                        self_name=self_name,
                        spawned=True,
                        spawn_kind=nested_spawn[id(node)],
                    )
                    cm.methods[sub.name] = sub
                    v = _MethodVisitor(sub, set())
                    body = getattr(node, "body", [])
                    for stmt in body if isinstance(body, list) else [body]:
                        v.visit(stmt)
                    _fill_discarded(sub)
            v = _MethodVisitor(mm, skip)
            for stmt in meth.body:
                v.visit(stmt)
            _fill_discarded(mm)


def _is_dunder(name: str) -> bool:
    return name.startswith("__") and name.endswith("__")


def _class_methods(cls: ast.ClassDef):
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield stmt


def _fill_discarded(mm: MethodModel) -> None:
    """A cond-op's result is discarded when its call is a bare statement."""
    if not mm.cond_ops:
        return
    parents = build_parents(mm.node)  # type: ignore[arg-type]
    for op in mm.cond_ops:
        parent = parents.get(op.node)
        op.discarded = isinstance(parent, ast.Expr)


# ---------------------------------------------------------------------------
# per-class fixpoints: roles and entry locksets
# ---------------------------------------------------------------------------


def _compute_roles(cm: ClassModel) -> None:
    edges: Dict[str, Set[str]] = {n: set() for n in cm.methods}
    called: Set[str] = set()
    for mm in cm.methods.values():
        for site in mm.calls:
            if site.self_callee is not None and site.self_callee in cm.methods:
                edges[mm.name].add(site.self_callee)
                called.add(site.self_callee)
    for mm in cm.methods.values():
        if mm.spawned:
            mm.roles.add(f"{mm.spawn_kind or 'thread'}:{mm.name}")
        elif mm.is_init:
            mm.roles.add("init")
        elif mm.public or mm.name not in called:
            # public API, or a private method nothing in the class calls
            # (assumed externally callable — callbacks, test hooks)
            mm.roles.add(f"api:{mm.name}" if cm.has_lock else "caller")
    changed = True
    while changed:
        changed = False
        for mm in cm.methods.values():
            for callee in edges[mm.name]:
                tgt = cm.methods[callee]
                add = mm.roles - tgt.roles
                if add:
                    tgt.roles |= add
                    changed = True


def _compute_entry_locks(cm: ClassModel) -> None:
    for mm in cm.methods.values():
        if mm.spawned or mm.public or mm.is_init:
            mm.entry_locks = frozenset()
    # private methods also called cross-class lose the inference — an outside
    # caller enters with nothing; approximate by whether anything in the
    # project calls them by attr. (Cheap approximation: keep intra-class only;
    # cross-class calls target public methods everywhere in this repo.)
    called_privately: Set[str] = set()
    for mm in cm.methods.values():
        for site in mm.calls:
            if site.self_callee is not None:
                called_privately.add(site.self_callee)
    for mm in cm.methods.values():
        if mm.entry_locks is None and mm.name not in called_privately:
            mm.entry_locks = frozenset()  # uncalled private: externally callable
    changed = True
    while changed:
        changed = False
        for mm in cm.methods.values():
            if mm.entry_locks is None:
                continue
            for site in mm.calls:
                if site.self_callee is None:
                    continue
                tgt = cm.methods.get(site.self_callee)
                if tgt is None or tgt.spawned or tgt.public or tgt.is_init:
                    continue
                cand = mm.entry_locks | site.locks
                new = cand if tgt.entry_locks is None else (tgt.entry_locks & cand)
                if new != tgt.entry_locks:
                    tgt.entry_locks = frozenset(new)
                    changed = True
    for mm in cm.methods.values():
        if mm.entry_locks is None:
            mm.entry_locks = frozenset()  # unreachable: stay conservative


def _el(mm: MethodModel) -> FrozenSet[str]:
    return mm.entry_locks if mm.entry_locks is not None else frozenset()


def _resolve_callee(mm: MethodModel, site: CallSite) -> Optional[MethodModel]:
    if site.self_callee is not None:
        return mm.cls.methods.get(site.self_callee)
    if site.attr_callee is not None:
        attr, meth = site.attr_callee
        atype = mm.cls.attr_types.get(attr)
        if atype is not None and atype.target is not None:
            return atype.target.methods.get(meth)
    return None


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------


def _emit_cc001(report: ConcReport, cm: ClassModel) -> None:
    """Shared attribute with an empty lockset intersection across threads."""
    spawned = any(m.spawned for m in cm.methods.values())
    if not (cm.has_lock or spawned):
        return
    by_attr: Dict[str, List[Access]] = {}
    for mm in cm.methods.values():
        if mm.is_init:
            continue  # construction happens-before sharing
        for acc in mm.accesses:
            by_attr.setdefault(acc.attr, []).append(acc)
    for attr, accs in sorted(by_attr.items()):
        roles: Set[str] = set()
        for acc in accs:
            roles |= acc.method.roles - {"init"}
        if len(roles) < 2:
            continue  # single execution context: no sharing
        if not any(a.write for a in accs):
            continue  # read-only after construction
        locksets = [a.locks | _el(a.method) for a in accs]
        common = frozenset.intersection(*[frozenset(s) for s in locksets])
        if common:
            continue
        accs_sorted = sorted(accs, key=lambda a: getattr(a.node, "lineno", 0))
        anchor = next(
            (a for a in accs_sorted if not (a.locks | _el(a.method))), accs_sorted[0]
        )
        others = sorted(
            {
                f"{a.method.name}():{getattr(a.node, 'lineno', 0)}"
                for a in accs_sorted
                if a is not anchor
            }
        )
        report.add(
            cm.rel,
            "CC001",
            anchor.node,
            f"{cm.name}.{attr} is shared across contexts ({', '.join(sorted(roles))}) "
            f"with no common lock — unguarded here in {anchor.method.name}(); "
            f"other accesses: {', '.join(others[:4])}"
            + (", ..." if len(others) > 4 else ""),
        )


def _emit_cc002(report: ConcReport, classes: List[ClassModel], acq) -> None:
    """Cycles in the lock-order graph."""
    edges: Dict[str, Dict[str, Tuple[str, ast.AST]]] = {}

    def add_edge(a: str, b: str, rel: str, node: ast.AST) -> None:
        edges.setdefault(a, {}).setdefault(b, (rel, node))

    for cm in classes:
        for mm in cm.methods.values():
            for a in mm.acquires:
                for h in a.held | _el(mm):
                    if h != a.lock:
                        add_edge(h, a.lock, cm.rel, a.node)
            for site in mm.calls:
                callee = _resolve_callee(mm, site)
                if callee is None:
                    continue
                held = site.locks | _el(mm)
                for h in held:
                    for l2 in acq.get(id(callee), set()) - held:
                        add_edge(h, l2, cm.rel, site.node)
    # DFS cycle detection over the lock-order graph
    seen_cycles: Set[Tuple[str, ...]] = set()
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(u: str) -> None:
        color[u] = GREY
        stack.append(u)
        for v in sorted(edges.get(u, {})):
            if color.get(v, WHITE) == WHITE:
                dfs(v)
            elif color.get(v) == GREY:
                cyc = stack[stack.index(v):]
                k = min(range(len(cyc)), key=lambda i: cyc[i])
                canon = tuple(cyc[k:] + cyc[:k])
                if canon in seen_cycles:
                    continue
                seen_cycles.add(canon)
                sites = [edges[canon[i]][canon[(i + 1) % len(canon)]] for i in range(len(canon))]
                rel, node = min(sites, key=lambda s: (s[0], getattr(s[1], "lineno", 0)))
                order = " -> ".join(fmt_lock(x) for x in canon + (canon[0],))
                report.add(
                    rel,
                    "CC002",
                    node,
                    f"lock-order cycle: {order} — two threads taking these locks in "
                    f"opposite orders deadlock; acquire them in one global order",
                )
        stack.pop()
        color[u] = BLACK

    for u in sorted(set(edges) | {v for m in edges.values() for v in m}):
        if color.get(u, WHITE) == WHITE:
            dfs(u)


def _emit_cc003(report: ConcReport, cm: ClassModel) -> None:
    """Condition-variable protocol violations."""
    for mm in cm.methods.values():
        for op in mm.cond_ops:
            held = op.locks | _el(mm)
            if op.cond_lock not in held:
                why = (
                    "the waiter can miss the wakeup"
                    if op.kind.startswith("notify")
                    else "raises RuntimeError at runtime"
                )
                report.add(
                    cm.rel,
                    "CC003",
                    op.node,
                    f"{cm.name}.{op.attr}.{op.kind}() without holding the condition lock — {why}",
                )
                continue
            if op.kind == "wait" and not op.timed and not op.in_loop:
                report.add(
                    cm.rel,
                    "CC003",
                    op.node,
                    f"{cm.name}.{op.attr}.wait() outside a predicate loop — spurious "
                    f"wakeups make a bare wait() return with the predicate still false; "
                    f"use `while not pred: cond.wait()`",
                )
            elif op.kind == "wait" and op.timed and op.discarded and not op.in_loop:
                report.add(
                    cm.rel,
                    "CC003",
                    op.node,
                    f"{cm.name}.{op.attr}.wait(timeout) result ignored outside a loop — "
                    f"a timeout returns False with the predicate unmet; check the result "
                    f"or re-test the predicate in a loop",
                )


def _emit_cc004(report: ConcReport, cm: ClassModel) -> None:
    """Check-then-act: guarded read, lock released, dependent guarded write."""
    for mm in cm.methods.values():
        by_lock: Dict[str, List[Region]] = {}
        for region in mm.regions:
            by_lock.setdefault(region.lock, []).append(region)
        for lock, regions in by_lock.items():
            if len(regions) < 2:
                continue
            earlier_reads: Dict[str, int] = {}
            for region in regions:  # already in source order (visit order)
                for attr, wnode in sorted(region.writes.items()):
                    if attr in earlier_reads and region.first_kind.get(attr) == "write":
                        report.add(
                            cm.rel,
                            "CC004",
                            wnode,
                            f"{cm.name}.{attr} was read under {fmt_lock(lock)} at line "
                            f"{earlier_reads[attr]} but is written here in a separate "
                            f"locked block — the lock was released between check and "
                            f"act, so the state may have changed; merge the blocks or "
                            f"re-validate before writing",
                        )
                for attr, rnode in region.reads.items():
                    earlier_reads.setdefault(attr, getattr(rnode, "lineno", 0))


def _emit_cc005(report: ConcReport, classes: List[ClassModel], block) -> None:
    """Blocking calls while holding a lock."""
    seen: Set[Tuple[str, int]] = set()
    for cm in classes:
        for mm in cm.methods.values():
            for op in mm.block_ops:
                held = op.locks | _el(mm)
                if not held:
                    continue
                key = (cm.rel, getattr(op.node, "lineno", 0))
                if key in seen:
                    continue
                seen.add(key)
                report.add(
                    cm.rel,
                    "CC005",
                    op.node,
                    f"{op.desc} while holding {fmt_locks(held)} — every thread "
                    f"contending for the lock stalls behind this blocking call",
                )
            for site in mm.calls:
                callee = _resolve_callee(mm, site)
                if callee is None:
                    continue
                # self-calls to private methods are covered by the entry-lockset
                # propagation into the callee's own lexical report
                if site.self_callee is not None and not callee.public:
                    continue
                held = site.locks | _el(mm)
                kinds = block.get(id(callee), set())
                if not held or not kinds:
                    continue
                key = (cm.rel, getattr(site.node, "lineno", 0))
                if key in seen:
                    continue
                seen.add(key)
                report.add(
                    cm.rel,
                    "CC005",
                    site.node,
                    f"call to {callee.cls.name}.{callee.name.split('.')[0]}() may block "
                    f"({', '.join(sorted(kinds))}) while holding {fmt_locks(held)}",
                )


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def analyze(project) -> ConcReport:
    """Build (or fetch the cached) concurrency model + CC records for one
    project. Called once per ``run()`` before files are checked — under
    ``--jobs`` the report is computed in the parent and inherited by the
    forked workers."""
    cached = getattr(project, "_conc_report", None)
    if cached is not None:
        return cached
    b = _ModelAssembly(project)
    b.collect_classes()
    method_spawn, nested_spawn = b.collect_spawns()
    for cm in b.classes:
        b.type_attrs(cm)
    for cm in b.classes:
        b.build_methods(cm, method_spawn, nested_spawn)
    for cm in b.classes:
        _compute_roles(cm)
        _compute_entry_locks(cm)

    # project-wide acquired-locks and may-block summaries (grow-only fixpoint)
    acq: Dict[int, Set[str]] = {}
    block: Dict[int, Set[str]] = {}
    for cm in b.classes:
        for mm in cm.methods.values():
            acq[id(mm)] = {a.lock for a in mm.acquires}
            block[id(mm)] = {op.desc.split(" (")[0] for op in mm.block_ops}
            block[id(mm)] |= {"Condition.wait" for op in mm.cond_ops if op.kind.startswith("wait")}
    changed = True
    while changed:
        changed = False
        for cm in b.classes:
            for mm in cm.methods.values():
                for site in mm.calls:
                    callee = _resolve_callee(mm, site)
                    if callee is None:
                        continue
                    if not acq[id(mm)] >= acq[id(callee)]:
                        acq[id(mm)] |= acq[id(callee)]
                        changed = True
                    if not block[id(mm)] >= block[id(callee)]:
                        block[id(mm)] |= block[id(callee)]
                        changed = True

    report = ConcReport(classes=b.classes)
    for cm in b.classes:
        _emit_cc001(report, cm)
        _emit_cc003(report, cm)
        _emit_cc004(report, cm)
    _emit_cc002(report, b.classes, acq)
    _emit_cc005(report, b.classes, block)
    for recs in report.records.values():
        recs.sort(key=lambda r: (getattr(r[1], "lineno", 0), r[0]))
    project._conc_report = report
    return report
