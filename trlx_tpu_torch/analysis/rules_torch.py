"""graftcheck PyTorch rules: the eager counterparts of the JAX package's
``rules_jax.py`` / ``rules_spmd.py`` hazards.

TX001  a sampling op with no ``generator=`` in package code:
       ``torch.multinomial``, ``rand*``, ``randn*``, ``randint*``,
       ``bernoulli``, ``normal``, ``randperm`` and the in-place samplers
       (``x.normal_()``, ``uniform_``, ``bernoulli_``, ...) draw from the
       process-global generator, which every thread and library shares, so a
       run's rollouts stop being a function of its seed. Dropout in train
       mode (``F.dropout(..., training=...)`` not literally ``False``) takes
       no generator at all. The port's idiom is an explicit
       ``torch.Generator`` per owner. (JX001's intent: an RNG stream that is
       silently shared.)
TX002  a host round-trip reachable from a registered hot entrypoint
       (:mod:`trlx_tpu_torch.analysis.census.entrypoints`) through the call
       graph, beyond the round-trips the registration declares for that
       function (``readback={qualname: n}``): ``.item()``, ``.tolist()``,
       ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``float()`` / ``int()`` /
       ``bool()`` of a tensor, an ``if`` or ``while`` on a tensor, and
       ``torch.cuda.synchronize()``. Each one stalls the host until the
       device drains its queue. (JX002 and JX004's intent.)
TX007  a ``sum`` / ``mean`` / ``cumsum`` / ``softmax`` / ``log_softmax``
       over a bf16/f16 operand with no ``dtype=``, which accumulates in the
       narrow type, or a ``.to()`` round trip that narrows then widens
       (``x.bfloat16().float()``), which has already lost the mantissa.

JX005 and JX008 (mesh-axis names, PartitionSpecs) are TX005 and TX008 in
:mod:`trlx_tpu_torch.analysis.rules_spmd`; the reference's IR005 (the
collective census) is the census's ``collectives`` on a mesh
(:mod:`trlx_tpu_torch.analysis.census`).

No counterpart in eager PyTorch: JX003 (impure ops under jit: eager code
runs every statement every step, there is no trace to run once), JX006
(reading a donated buffer: eager PyTorch does not donate) and SH002-SH004
(jit-cache churn from weak types, unstable static arguments and
data-dependent output shapes: there is no compile cache to churn; the
census' steady-state shape count stands in for the last, see
:mod:`trlx_tpu_torch.analysis.census`).

The tensor tests are syntactic, as in the reference: an expression is
tensor-valued when it calls ``torch.*`` or a tensor reduction method, or
reads a name assigned from one in the same function; ``.numpy()``,
``.tolist()`` and ``.item()`` end tensor-valuedness.
"""

import ast
from typing import Dict, Iterable, List, Optional, Set

from trlx_tpu_torch.analysis.astutils import collect_aliases, dotted
from trlx_tpu_torch.analysis.core import FileContext, Finding, Rule, register

# -- TX001 ---------------------------------------------------------------------

_TORCH_SAMPLERS = {
    "multinomial", "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "bernoulli", "normal", "randperm", "poisson",
}
_INPLACE_SAMPLERS = {
    "normal_", "uniform_", "bernoulli_", "exponential_", "geometric_", "cauchy_", "log_normal_", "random_",
}
_INIT_SAMPLERS = {
    "normal_", "uniform_", "trunc_normal_", "xavier_uniform_", "xavier_normal_", "kaiming_uniform_",
    "kaiming_normal_", "orthogonal_", "sparse_",
}


def _torch_fn(call: ast.Call, torch_names: Set[str]) -> Optional[str]:
    """``'multinomial'`` for ``torch.multinomial(...)``, ``'init.normal_'``
    for ``torch.nn.init.normal_(...)``, ``'dropout'`` for
    ``torch.nn.functional.dropout`` / ``F.dropout``; else None."""
    d = dotted(call.func)
    if d is None:
        return None
    parts = d.split(".")
    if parts[0] in torch_names:
        if len(parts) == 2:
            return parts[1]
        if parts[1:-1] == ["nn", "init"]:
            return "init." + parts[-1]
        if parts[1:-1] in (["nn", "functional"],) and parts[-1] == "dropout":
            return "dropout"
    if len(parts) == 2 and parts[0] in ("F", "functional") and parts[1] == "dropout":
        return "dropout"
    if len(parts) == 2 and parts[0] == "init" and parts[1] in _INIT_SAMPLERS:
        return "init." + parts[1]
    return None


@register
class TX001UnseededSampling(Rule):
    id = "TX001"
    summary = "sampling op with no generator= (draws from the process-global RNG)"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        al = collect_aliases(ctx.tree)
        torch_names = al.torch | {"torch"}
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if any(kw.arg == "generator" for kw in node.keywords):
                continue
            fn = _torch_fn(node, torch_names)
            what = None
            if fn == "dropout":
                training = next((kw.value for kw in node.keywords if kw.arg == "training"), None)
                if training is None and len(node.args) >= 3:
                    training = node.args[2]
                if not (isinstance(training, ast.Constant) and training.value is False):
                    what = "dropout in train mode"
            elif fn in _TORCH_SAMPLERS:
                what = f"torch.{fn}()"
            elif fn is not None and fn.startswith("init.") and fn[5:] in _INIT_SAMPLERS:
                what = f"torch.nn.{fn}()"
            elif (
                fn is None
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _INPLACE_SAMPLERS
                and dotted(node.func.value) not in ("init", "nn.init")
            ):
                what = f".{node.func.attr}()"
            if what:
                fix = ("it takes no generator: disable it or draw the mask from an owned generator"
                       if fn == "dropout" else "pass generator= (a torch.Generator seeded by its owner)")
                findings.append(self.finding(ctx, node, f"{what} draws from the process-global generator: {fix}"))
        return findings


# -- TX002 ---------------------------------------------------------------------

#: tensor methods whose result is a tensor on the same device
_TENSOR_METHODS = {
    "all", "any", "sum", "mean", "max", "min", "amax", "amin", "norm", "argmax", "argmin", "prod",
    "isfinite", "isnan", "eq", "ne", "gt", "lt", "ge", "le", "abs", "float", "long", "int", "bool",
}
#: methods whose result lives on the host (metadata, or the value itself)
_HOST_METHODS = {
    "item", "tolist", "numpy", "dim", "size", "numel", "nelement", "ndimension", "stride", "is_contiguous",
    "data_ptr", "element_size", "get_device", "is_floating_point", "is_complex",
}
#: torch functions that return Python values, not tensors
_HOST_TORCH_FNS = {
    "device", "is_tensor", "is_grad_enabled", "is_inference_mode_enabled", "is_floating_point", "finfo", "iinfo",
    "get_default_dtype", "dtype", "Size", "Generator",
}
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "requires_grad", "is_leaf", "grad_fn", "layout"}
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """Nodes of ``fn``'s body, nested defs excluded (they are defs of their own)."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        if isinstance(node, _SCOPES):
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


class _TensorNames:
    """Which names of one function hold tensors, by source-order assignment."""

    def __init__(self, fn: ast.AST, torch_names: Set[str]):
        self.torch_names = torch_names
        self.names: Set[str] = set()
        args = getattr(fn, "args", None)
        for a in (args.posonlyargs + args.args + args.kwonlyargs) if args is not None else []:
            ann = dotted(a.annotation) if a.annotation is not None else None
            if ann and ann.split(".")[-1] == "Tensor":
                self.names.add(a.arg)
        for node in sorted((n for n in _own_nodes(fn) if isinstance(n, ast.Assign)), key=lambda n: n.lineno):
            if self.tensor_valued(node.value):
                for t in node.targets:
                    for n in [t] + (list(t.elts) if isinstance(t, (ast.Tuple, ast.List)) else []):
                        if isinstance(n, ast.Name):  # x = ... and x, y = ...; not x[k] = ...
                            self.names.add(n.id)

    def tensor_valued(self, expr: ast.AST) -> bool:
        todo = [expr]
        while todo:
            n = todo.pop()
            if isinstance(n, _SCOPES):
                continue
            if isinstance(n, ast.Call):
                fn = n.func
                if isinstance(fn, ast.Attribute) and fn.attr in _HOST_METHODS:
                    continue  # host-valued from here down
                if isinstance(fn, ast.Name) and fn.id in ("len", "isinstance", "float", "int", "bool"):
                    continue
                d = dotted(fn)
                if d is not None and d.split(".")[0] in self.torch_names:
                    parts = d.split(".")
                    if len(parts) > 1 and (parts[1] == "cuda" or parts[-1] in _HOST_TORCH_FNS):
                        continue
                    return True
                if isinstance(fn, ast.Attribute) and fn.attr in _TENSOR_METHODS and self.tensor_valued(fn.value):
                    return True
            if isinstance(n, ast.Attribute) and n.attr in _META_ATTRS:
                continue
            if isinstance(n, ast.Compare) and all(isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
                continue
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) and n.id in self.names:
                return True
            if isinstance(n, ast.comprehension):
                todo.extend(n.ifs)  # what is iterated over is not what the test reads
                continue
            todo.extend(ast.iter_child_nodes(n))
        return False


def round_trips(fn: ast.AST, torch_names: Set[str]) -> List[tuple]:
    """(node, description) of every host round-trip in ``fn``'s own body."""
    names = _TensorNames(fn, torch_names)
    out = []
    explicit: Set[int] = set()
    for node in _own_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        desc = None
        if isinstance(f, ast.Attribute):
            if f.attr in ("item", "tolist", "numpy") and not node.args:
                fetched = isinstance(f.value, ast.Call) and isinstance(f.value.func, ast.Attribute) and (
                    f.value.func.attr == "cpu" or (f.value.func.attr == "to" and any(
                        isinstance(a, ast.Constant) and a.value == "cpu" for a in f.value.args)))
                if not fetched:  # x.cpu().numpy() is one round-trip, counted at .cpu()
                    desc = f".{f.attr}()"
            elif f.attr == "cpu" and names.tensor_valued(f.value):
                desc = ".cpu()"
            elif f.attr == "to" and any(isinstance(a, ast.Constant) and a.value == "cpu"
                                        for a in list(node.args) + [k.value for k in node.keywords]):
                desc = '.to("cpu")'
            elif dotted(f) in {f"{t}.cuda.synchronize" for t in torch_names}:
                desc = "torch.cuda.synchronize()"
        elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool") and len(node.args) == 1:
            if names.tensor_valued(node.args[0]):
                desc = f"{f.id}(<tensor>)"
        if desc:
            out.append((node, desc))
            explicit.add(id(node))
    for node in _own_nodes(fn):
        if isinstance(node, (ast.If, ast.While)):
            # a test that converts explicitly (`while not bool(done.all())`) is counted at the conversion
            if not any(id(n) in explicit for n in ast.walk(node.test)) and names.tensor_valued(node.test):
                out.append((node, f"`{'if' if isinstance(node, ast.If) else 'while'}` on a tensor"))
    return sorted(out, key=lambda p: (p[0].lineno, p[0].col_offset))


def _qualname(fn: ast.AST, parents: Dict[ast.AST, ast.AST], module: str) -> str:
    parts = []
    node = fn
    while node is not None and not isinstance(node, ast.Module):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            parts.append(node.name)
        node = parents.get(node)
    return ".".join([module] + list(reversed(parts)))


def _declared(entry, qual: str) -> int:
    """Round-trips ``entry`` declares for the function ``qual``: keys are
    dotted module paths plus qualified names, matched exactly or as a
    suffix (a scan rooted above the package names modules longer)."""
    for key, n in entry.readback.items():
        if qual == key or qual.endswith("." + key):
            return n
    return 0


@register
class TX002HotRoundTrip(Rule):
    id = "TX002"
    summary = "host round-trip reachable from a registered hot entrypoint beyond its declared readback"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        project = ctx.project
        if project is None:
            return []
        info = project.module_for(ctx)
        if info is None:
            return []
        findings: List[Finding] = []
        for entry in project.hot_entries():
            if entry.module == info.name:
                for root in entry.unresolved:
                    findings.append(self.finding(
                        ctx, entry.node, f"entrypoint {entry.name!r}: root {root!r} resolves to no scanned def"))
        torch_names = info.aliases.torch | {"torch"}
        parents = None
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            hits = project.hot_for(fn)
            if not hits:
                continue
            sites = round_trips(fn, torch_names)
            if not sites:
                continue
            if parents is None:
                from trlx_tpu_torch.analysis.astutils import build_parents

                parents = build_parents(ctx.tree)
            qual = _qualname(fn, parents, info.name)
            over = sorted({e.name for e, _ in hits if len(sites) > _declared(e, qual)})
            if not over:
                continue
            allowed = min(_declared(e, qual) for e, _ in hits if e.name in over)
            for node, desc in sites:
                findings.append(self.finding(
                    ctx, node,
                    f"host round-trip {desc} on the hot path of {', '.join(over)} "
                    f"({qual.rsplit('.', 1)[-1]}() makes {len(sites)}, declared readback {allowed})",
                ))
        return findings


# -- TX007 ---------------------------------------------------------------------

_NARROW = {"bfloat16", "float16", "half"}
_WIDE = {"float32", "float64", "float", "double"}
_REDUCERS = {"sum", "mean", "cumsum", "softmax", "log_softmax"}


def _dtype_class(node: ast.AST) -> Optional[str]:
    name = node.value if isinstance(node, ast.Constant) and isinstance(node.value, str) else None
    if name is None:
        d = dotted(node)
        name = d.split(".")[-1] if d else None
    if name in _NARROW:
        return "narrow"
    if name in _WIDE:
        return "wide"
    return None


def _cast_class(call: ast.Call) -> Optional[str]:
    """'narrow' / 'wide' for ``x.to(<dtype>)`` / ``x.to(dtype=...)`` /
    ``x.bfloat16()`` / ``x.half()`` / ``x.float()`` / ``x.double()``."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in ("bfloat16", "half") and not call.args:
        return "narrow"
    if f.attr in ("float", "double") and not call.args:
        return "wide"
    if f.attr == "to":
        for a in list(call.args) + [k.value for k in call.keywords if k.arg == "dtype"]:
            c = _dtype_class(a)
            if c:
                return c
    return None


def _narrows(expr: ast.AST) -> bool:
    """True when ``expr`` provably produces a bf16/f16 tensor: its outermost
    cast narrows, or it is built with ``dtype=<narrow>``."""
    if isinstance(expr, ast.Call):
        c = _cast_class(expr)
        if c is not None:
            return c == "narrow"
        return any(kw.arg == "dtype" and _dtype_class(kw.value) == "narrow" for kw in expr.keywords)
    return False


@register
class TX007MixedPrecision(Rule):
    id = "TX007"
    summary = "reduction over bf16/f16 without dtype=, or a narrowing-then-widening .to() round trip"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and _cast_class(node) == "wide":
                recv = node.func.value
                if isinstance(recv, ast.Call) and _cast_class(recv) == "narrow":
                    findings.append(self.finding(
                        ctx, node,
                        "cast round trip narrows then widens: the narrow cast already lost "
                        "the mantissa; drop one of the casts",
                    ))
        self._scope(ctx, ctx.tree.body, findings)
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scope(ctx, fn.body, findings)
        return findings

    def _scope(self, ctx: FileContext, body: List[ast.stmt], findings: List[Finding]) -> None:
        narrow: Set[str] = set()

        def operand(call: ast.Call) -> Optional[ast.AST]:
            if any(kw.arg == "dtype" for kw in call.keywords):
                return None
            f = call.func
            if not isinstance(f, ast.Attribute) or f.attr not in _REDUCERS:
                return None
            base = dotted(f.value)
            if base is not None and base.split(".")[-1] in ("torch", "F", "functional", "special"):
                return call.args[0] if call.args else None
            return f.value  # x.sum() method form

        def is_narrow(expr: Optional[ast.AST]) -> bool:
            if expr is None:
                return False
            d = dotted(expr)
            return (d is not None and d in narrow) or _narrows(expr)

        def check_expr(expr: ast.AST) -> None:
            for n in ast.walk(expr):
                if isinstance(n, _SCOPES) or not isinstance(n, ast.Call):
                    continue
                if is_narrow(operand(n)):
                    findings.append(self.finding(
                        ctx, n,
                        "reduction over a bf16/f16 operand accumulates in the narrow dtype; "
                        "pass dtype=torch.float32 or upcast first",
                    ))

        def visit(stmts: List[ast.stmt]) -> None:
            for stmt in stmts:
                if isinstance(stmt, _SCOPES):
                    continue
                if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    value = getattr(stmt, "value", None)
                    if value is not None:
                        check_expr(value)
                        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                        for t in targets:
                            name = dotted(t)
                            if name is None:
                                continue
                            if _narrows(value):
                                narrow.add(name)
                            else:
                                narrow.discard(name)
                    continue
                for child in ast.iter_child_nodes(stmt):
                    if isinstance(child, ast.expr):
                        check_expr(child)
                for block in (getattr(stmt, "body", None), getattr(stmt, "orelse", None),
                              getattr(stmt, "finalbody", None)):
                    if isinstance(block, list):
                        visit([s for s in block if isinstance(s, ast.stmt)])
                for h in getattr(stmt, "handlers", []) or []:
                    visit(h.body)

        visit(body)
