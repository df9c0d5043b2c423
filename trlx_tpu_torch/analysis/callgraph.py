"""Cross-module call graph: import resolution, thread entry points and
hot-path reachability.

A copy of ``trlx_tpu/analysis/callgraph.py`` in which the jit-taint
fixpoint gives way to the port's roots: the hot entrypoints registered for
the census (:mod:`trlx_tpu_torch.analysis.census.entrypoints`). Each
``@register_entrypoint("name", roots=(...), readback={...})`` in a scanned
file is read from the AST (nothing is imported): ``roots`` names the
functions one step of the entry runs, as dotted module paths plus
qualified names (``trlx_tpu_torch.ops.generation.generate``,
``...mesh_trainer.MeshRLTrainer.make_grad_accum_step``; ``pkg.mod.*`` and
``pkg.mod.Class.*`` name every def of a module or class); ``readback`` the
host round-trips each function may make per call. :meth:`Project.hot_for`
gives, for a def, the entries that reach it.

Reachability follows bare-name calls (same file and imported symbols),
``self.m(...)`` calls within the enclosing class, module attributes
(``helpers.f(x)``), callable arguments to higher-order entry points
(:data:`astutils.HOF_NAMES`), and every def nested in a reached def. Calls
through other attributes (``self._step_fn(batch)``) are not followed: a
registration names such callees among its roots.

Import resolution is textual, not importlib: module names derive from file
paths, and a ``from helpers import f`` resolves by exact dotted name first,
then by unique *suffix* match (so both ``trlx_tpu_torch/ops/foo.py`` scanned
as ``trlx_tpu_torch.ops.foo`` and a bare tmp-dir fixture ``helpers.py``
resolve). An ambiguous suffix is disambiguated package-relatively from the
importing module; what remains ambiguous resolves to nothing — a missed edge
only loses a finding, a wrong edge invents one.

Thread/callback spawns — ``threading.Thread(target=self._loop)``,
``threading.Timer``, and watchdog ``escalate(name, callback)``
registrations — are collected into :attr:`Project.thread_targets` with each
target resolved to its def node(s): the entry points the concurrency
analyzer (:mod:`trlx_tpu_torch.analysis.conc`) roots its thread roles and
locksets at.
"""

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from trlx_tpu_torch.analysis.astutils import Aliases, callable_arg_refs, collect_aliases, dotted


@dataclass
class ThreadTarget:
    """One discovered thread entry point: a ``threading.Thread(target=...)``
    (or ``Timer``) construction, or a watchdog/supervisor ``escalate(name,
    callback)`` registration. ``resolved`` holds every (module name, def node)
    the target expression may denote — bound methods (``self._loop``), nested
    closures, imported symbols."""

    module: str
    call: ast.Call
    kind: str  # "thread" | "callback"
    target: Optional[ast.AST]  # the target expression (Name/Attribute/Lambda)
    resolved: List[Tuple[str, ast.AST]] = field(default_factory=list)


def module_name_for(rel: str) -> str:
    """Dotted module name for a scanned path: ``trlx_tpu/ops/a.py`` →
    ``trlx_tpu.ops.a``; ``pkg/__init__.py`` → ``pkg``. Path separators become
    dots; dots inside a component (tmp dirs like ``pytest-0.d``) become ``_``
    so they cannot fake a package boundary."""
    parts = [p for p in rel.split("/") if p]
    if not parts:
        return ""
    last = parts[-1]
    if last.endswith(".py"):
        last = last[:-3]
    if last == "__init__":
        parts = parts[:-1]
    else:
        parts[-1] = last
    return ".".join(p.replace(".", "_") for p in parts)


@dataclass
class ModuleInfo:
    """One parsed file plus everything edge-building needs about it."""

    ctx: object  # FileContext (untyped to avoid a core<->callgraph import cycle)
    name: str
    aliases: Aliases
    defs_by_name: Dict[str, List[ast.AST]] = field(default_factory=dict)
    #: local name -> dotted module it is bound to (``import a.b as m``)
    module_bindings: Dict[str, str] = field(default_factory=dict)
    #: local name -> (module dotted name, symbol) (``from a.b import f as g``)
    symbol_bindings: Dict[str, Tuple[str, str]] = field(default_factory=dict)


class Project:
    """Import resolution, thread entry points and hot-path reachability over
    one ``run()``'s files."""

    def __init__(self, contexts):
        self.modules: Dict[str, ModuleInfo] = {}
        self._by_ctx: Dict[int, ModuleInfo] = {}
        #: trailing-component index for suffix resolution: "a.b" -> {names}
        self._suffixes: Dict[str, Set[str]] = {}
        for ctx in contexts:
            name = module_name_for(ctx.rel)
            if not name or name in self.modules:
                continue  # duplicate names cannot be told apart; skip edges
            info = ModuleInfo(ctx=ctx, name=name, aliases=collect_aliases(ctx.tree))
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info.defs_by_name.setdefault(node.name, []).append(node)
            self.modules[name] = info
            self._by_ctx[id(ctx)] = info
            parts = name.split(".")
            for i in range(len(parts)):
                self._suffixes.setdefault(".".join(parts[i:]), set()).add(name)
        for info in self.modules.values():
            self._collect_imports(info)
        #: every Thread(target=...)/Timer/escalate(...) registration, with the
        #: target resolved to def nodes — the conc analyzer's entry points
        self.thread_targets: List[ThreadTarget] = []
        for info in self.modules.values():
            self._collect_thread_targets(info)
        self._hot: Optional[Dict[int, List[Tuple[HotEntry, str]]]] = None

    # -- thread entry points -------------------------------------------------

    def _collect_thread_targets(self, info: ModuleInfo) -> None:
        al = info.aliases
        for node in ast.walk(info.ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            target: Optional[ast.AST] = None
            kind = ""
            d = dotted(fn)
            parts = d.split(".") if d else []
            is_thread = (isinstance(fn, ast.Name) and fn.id in al.thread_class) or (
                len(parts) >= 2 and parts[0] in al.threading and parts[-1] in ("Thread", "Timer")
            )
            if is_thread:
                kind = "thread"
                for kw in node.keywords:
                    if kw.arg in ("target", "function"):
                        target = kw.value
            elif isinstance(fn, ast.Attribute) and fn.attr == "escalate" and len(node.args) >= 2:
                # watchdog.escalate(heartbeat_name, callback): the callback
                # runs on the watchdog thread when the heartbeat stalls
                kind = "callback"
                target = node.args[1]
            else:
                continue
            tt = ThreadTarget(module=info.name, call=node, kind=kind, target=target)
            if isinstance(target, ast.Lambda):
                tt.resolved.append((info.name, target))
            elif isinstance(target, ast.Name):
                resolved = self._defs_for(info, target)
                if resolved:
                    tt.resolved.extend(resolved)
                else:
                    for d_ in info.defs_by_name.get(target.id, []):
                        tt.resolved.append((info.name, d_))
            elif isinstance(target, ast.Attribute):
                if isinstance(target.value, ast.Name) and target.value.id == "self":
                    # bound method: resolve by bare attr name in this module;
                    # the conc analyzer narrows to the lexically enclosing class
                    for d_ in info.defs_by_name.get(target.attr, []):
                        tt.resolved.append((info.name, d_))
                else:
                    tt.resolved.extend(self._defs_for(info, target))
            if target is not None:
                self.thread_targets.append(tt)

    # -- import resolution ---------------------------------------------------

    def _resolve(self, target: str, importer: Optional[ModuleInfo] = None) -> Optional[str]:
        """Dotted import target -> scanned module name, or None. Exact match
        first; otherwise the unique module whose name ends with the target
        (tmp-dir fixtures and partial scans make exact prefixes unknowable).
        An ambiguous suffix is disambiguated package-relatively: walking out
        from ``importer``'s package, the first enclosing package holding
        exactly ONE candidate wins (``from helpers import f`` inside
        ``pkg.ops.foo`` picks ``pkg.ops.helpers`` over ``tests.helpers``).
        Still-ambiguous targets resolve to nothing — a missed edge only
        loses a finding, a wrong edge invents one."""
        if target in self.modules:
            return target
        candidates = self._suffixes.get(target, set())
        if len(candidates) == 1:
            return next(iter(candidates))
        if len(candidates) > 1 and importer is not None:
            parts = importer.name.split(".")[:-1]
            while parts:
                prefix = ".".join(parts) + "."
                in_pkg = [c for c in candidates if c.startswith(prefix)]
                if len(in_pkg) == 1:
                    return in_pkg[0]
                if in_pkg:
                    return None  # several candidates in the SAME package
                parts.pop()
        return None

    def _collect_imports(self, info: ModuleInfo) -> None:
        pkg_parts = info.name.split(".")[:-1]
        for node in ast.walk(info.ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod = self._resolve(a.name, info)
                    if mod is None:
                        continue
                    if a.asname:
                        info.module_bindings[a.asname] = mod
                    else:
                        # `import a.b.c` binds `a`; attribute chains a.b.c.f
                        # are matched against the full dotted path at use sites
                        info.module_bindings[a.name.split(".")[0]] = a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                    prefix = ".".join(base + ([node.module] if node.module else []))
                else:
                    prefix = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    bound = a.asname or a.name
                    # `from pkg import sub` may bind a submodule...
                    sub = self._resolve(f"{prefix}.{a.name}" if prefix else a.name, info)
                    if sub is not None:
                        info.module_bindings[bound] = sub
                        continue
                    # ...or a symbol defined in `prefix`
                    mod = self._resolve(prefix, info) if prefix else None
                    if mod is not None:
                        info.symbol_bindings[bound] = (mod, a.name)

    def _defs_for(self, info: ModuleInfo, func: ast.AST) -> List[Tuple[str, ast.AST]]:
        """(module name, def node) targets a call/wrap expression may reach,
        through this module's import bindings. Local defs are handled by the
        per-file closure, not here."""
        out: List[Tuple[str, ast.AST]] = []
        if isinstance(func, ast.Name):
            target = info.symbol_bindings.get(func.id)
            if target is not None:
                mod, sym = target
                for d in self.modules[mod].defs_by_name.get(sym, []):
                    out.append((mod, d))
        elif isinstance(func, ast.Attribute):
            d = dotted(func)
            if d is None or "." not in d:
                return out
            base, attr = d.rsplit(".", 1)
            mod = None
            if base in info.module_bindings:
                bound = info.module_bindings[base]
                mod = bound if bound in self.modules else self._resolve(bound, info)
            elif self._resolve(base, info) is not None and base.split(".")[0] in info.module_bindings:
                mod = self._resolve(base, info)  # full dotted `a.b.c.f` after `import a.b.c`
            if mod is not None:
                for node in self.modules[mod].defs_by_name.get(attr, []):
                    out.append((mod, node))
        return out

    # -- hot entrypoints -----------------------------------------------------

    def _registrations(self) -> List["HotEntry"]:
        """Every ``@register_entrypoint(name, roots=..., readback=...)``
        decorator in the scanned files, read from the AST."""
        out: List[HotEntry] = []
        for info in self.modules.values():
            for node in ast.walk(info.ctx.tree):
                if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                for dec in node.decorator_list:
                    entry = _parse_registration(dec, info)
                    if entry is not None:
                        out.append(entry)
        return out

    def _resolve_qualname(self, dotted_name: str) -> List[Tuple[str, ast.AST]]:
        """``pkg.mod.Class.meth`` / ``pkg.mod.func`` / ``pkg.mod.func.inner``
        -> [(module, def node)]: the longest scanned-module prefix, then the
        qualified name inside it. A trailing ``.*`` names every def of a
        module (``pkg.mod.*``) or every method of a class (``pkg.mod.Class.*``)."""
        parts = dotted_name.split(".")
        star = parts[-1] == "*"
        if star:
            parts = parts[:-1]
        for cut in range(len(parts), 0, -1):
            mod = self._resolve(".".join(parts[:cut]))
            if mod is None:
                continue
            node: ast.AST = self.modules[mod].ctx.tree
            for name in parts[cut:]:
                node = next((s for s in getattr(node, "body", [])
                             if isinstance(s, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
                             and s.name == name), None)
                if node is None:
                    break
            if node is None:
                continue
            if star:
                return [(mod, d) for d in ast.walk(node) if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef))]
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return [(mod, node)]
        return []

    def _callees(self, mod: str, fn: ast.AST, classes: Dict[int, ast.ClassDef]) -> List[Tuple[str, ast.AST]]:
        info = self.modules[mod]
        cls = classes.get(id(fn))
        methods = {s.name: s for s in cls.body if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))} if cls else {}
        out: List[Tuple[str, ast.AST]] = []
        for node in ast.walk(fn):
            if node is not fn and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                out.append((mod, node))  # nested defs run as part of their parent
            if not isinstance(node, ast.Call):
                continue
            refs = [node.func] + [r for r in callable_arg_refs(node) if not isinstance(r, ast.Lambda)]
            for ref in refs:
                if isinstance(ref, ast.Name):
                    out.extend((mod, d) for d in info.defs_by_name.get(ref.id, []))
                    out.extend(self._defs_for(info, ref))
                elif isinstance(ref, ast.Attribute):
                    if isinstance(ref.value, ast.Name) and ref.value.id == "self":
                        if ref.attr in methods:
                            out.append((mod, methods[ref.attr]))
                    else:
                        out.extend(self._defs_for(info, ref))
        return out

    def _compute_hot(self) -> Dict[int, List[Tuple["HotEntry", str]]]:
        """def node id -> [(entry, qualified root it is reached from)]."""
        classes: Dict[int, ast.ClassDef] = {}
        for info in self.modules.values():
            for node in ast.walk(info.ctx.tree):
                if isinstance(node, ast.ClassDef):
                    for s in node.body:
                        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            classes[id(s)] = node
        hot: Dict[int, List[Tuple[HotEntry, str]]] = {}
        self._entries = self._registrations()
        for entry in self._entries:
            seen: Set[int] = set()
            for root in entry.roots:
                todo = self._resolve_qualname(root)
                if not todo:
                    entry.unresolved.append(root)
                    continue
                while todo:
                    mod, fn = todo.pop()
                    if id(fn) in seen:
                        continue
                    seen.add(id(fn))
                    entry.reached.append((mod, fn))
                    hot.setdefault(id(fn), []).append((entry, root))
                    todo.extend(self._callees(mod, fn, classes))
        return hot

    def hot_for(self, fn: ast.AST) -> List[Tuple["HotEntry", str]]:
        """The registered entries whose step reaches ``fn``."""
        if self._hot is None:
            self._hot = self._compute_hot()
        return self._hot.get(id(fn), [])

    def hot_entries(self) -> List["HotEntry"]:
        """Every registration in the scanned files, resolved."""
        if self._hot is None:
            self._hot = self._compute_hot()
        return self._entries

    def module_for(self, ctx) -> Optional[ModuleInfo]:
        return self._by_ctx.get(id(ctx))


@dataclass
class HotEntry:
    """One registration read from the AST."""

    name: str
    module: str  #: the registering module
    node: ast.AST  #: the decorator call, for findings about the registration
    roots: Tuple[str, ...]
    readback: Dict[str, int]  #: qualified function name -> round-trips allowed per call
    reached: List[Tuple[str, ast.AST]] = field(default_factory=list)
    unresolved: List[str] = field(default_factory=list)


def _literal(node: ast.AST):
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError, TypeError):
        return None


def _parse_registration(dec: ast.AST, info: ModuleInfo) -> Optional[HotEntry]:
    if not isinstance(dec, ast.Call):
        return None
    d = dotted(dec.func)
    if d is None or d.split(".")[-1] != "register_entrypoint" or not dec.args:
        return None
    name = _literal(dec.args[0])
    kw = {k.arg: _literal(k.value) for k in dec.keywords if k.arg}
    if not isinstance(name, str):
        return None
    roots = tuple(r for r in (kw.get("roots") or ()) if isinstance(r, str))
    readback = {str(k): int(v) for k, v in (kw.get("readback") or {}).items()}
    return HotEntry(name=name, module=info.name, node=dec, roots=roots, readback=readback)
