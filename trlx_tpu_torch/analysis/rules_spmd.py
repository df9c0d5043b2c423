"""graftcheck SPMD rules of the port: mesh-axis names and PartitionSpecs
(the intent of the JAX package's ``rules_spmd.py`` JX005 and JX008).

TX005  a string literal used as a mesh axis must be one of the constants
       :mod:`trlx_tpu_torch.parallel.mesh` exports (``DATA_AXIS`` ...
       ``MODEL_AXIS``, ``BATCH_AXES``, ``MESH_AXES``). A hard-coded
       ``"model"`` works until the vocabulary changes; an unknown axis fails
       only when the line runs, on as many ranks as reach it. The places
       read: the axis argument of ``Mesh.group`` (on a receiver named
       ``*mesh``), ``axis_index``, ``axis_size``, the keys of
       ``ranks_with({...})`` and ``spec_dim(spec, axis)``; subscripts and
       ``.get`` of ``*.shape`` / ``*.coords`` by a string; ``axis=``,
       ``axis_name=`` and ``axes=`` keywords on any call and parameter
       defaults; and comparisons of a spec entry or an axis (a name ending
       in ``entry``, ``axis`` or ``axes``) with a string.
TX008  a ``PartitionSpec`` (``trlx_tpu_torch.parallel.sharding``'s) with
       an axis outside the vocabulary, the same axis on two dims, a
       rule-table entry whose spec has more entries than its parameter's
       rank (``kernel`` / ``embedding`` 2, ``bias`` / ``scale`` 1, one more
       under ``layers_scan``), or a literal spec handed to
       ``shard_tensor`` whose rank is above every rule of the table.

Both parse the vocabulary (``*_AXIS = "..."`` in ``parallel/mesh.py``) and
the table's largest rank (``parallel/sharding.py``) statically from the
port's own modules, as the reference parses its package's.
"""

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from trlx_tpu_torch.analysis.astutils import dotted
from trlx_tpu_torch.analysis.core import FileContext, Finding, Rule, register

_PARALLEL = Path(__file__).resolve().parents[1] / "parallel"
#: last-resort vocabulary if parallel/mesh.py cannot be parsed (value -> constant)
_FALLBACK_VOCAB = {"data": "DATA_AXIS", "fsdp": "FSDP_AXIS", "pipe": "PIPE_AXIS", "model": "MODEL_AXIS"}

_vocab_cache: Optional[Dict[str, str]] = None
_table_rank_cache: Optional[int] = None


def mesh_axis_vocabulary() -> Dict[str, str]:
    """Axis value -> exporting constant (``{"model": "MODEL_AXIS", ...}``),
    from the module-level ``*_AXIS = "literal"`` assignments of the port's
    ``parallel/mesh.py``."""
    global _vocab_cache
    if _vocab_cache is None:
        vocab: Dict[str, str] = {}
        try:
            for node in ast.parse((_PARALLEL / "mesh.py").read_text()).body:
                if (isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id.endswith("_AXIS") and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)):
                    vocab[node.value.value] = node.targets[0].id
        except (OSError, SyntaxError):
            pass
        _vocab_cache = vocab or dict(_FALLBACK_VOCAB)
    return _vocab_cache


def _table_max_rank() -> int:
    """The most entries of any ``PartitionSpec`` in the rule tables of the
    port's ``parallel/sharding.py`` (3, the stacked-layer kernels', if it
    cannot be parsed)."""
    global _table_rank_cache
    if _table_rank_cache is None:
        rank = 0
        try:
            for node in ast.walk(ast.parse((_PARALLEL / "sharding.py").read_text())):
                if _rule_entry(node) is not None:
                    rank = max(rank, len(node.elts[1].args))
        except (OSError, SyntaxError):
            pass
        _table_rank_cache = rank or 3
    return _table_rank_cache


def _rule_entry(node: ast.AST) -> Optional[str]:
    """The pattern of a rule-table tuple ``("regex", PartitionSpec(...))``."""
    if (isinstance(node, ast.Tuple) and len(node.elts) == 2 and isinstance(node.elts[0], ast.Constant)
            and isinstance(node.elts[0].value, str) and isinstance(node.elts[1], ast.Call)
            and (dotted(node.elts[1].func) or "").split(".")[-1] in ("PartitionSpec", "P")):
        return node.elts[0].value
    return None


def _strings(expr: Optional[ast.AST]) -> List[ast.Constant]:
    """The string constants of an axis expression: a literal, or the
    literals of a tuple / list of them."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [expr]
    if isinstance(expr, (ast.Tuple, ast.List)):
        return [e for e in expr.elts if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []


# -- TX005 ---------------------------------------------------------------------

#: Mesh methods -> the positional index of their axis argument
_MESH_METHODS = {"axis_index": 0, "axis_size": 0}
#: functions of the port taking an axis -> its positional index
_AXIS_FUNCTIONS = {"spec_dim": 1, "shard_tensor": 3}
_AXIS_KEYWORDS = ("axis", "axis_name", "axes")
_AXIS_LIKE = re.compile(r"(entry|axis|axes)$")


def _last_name(node: ast.AST) -> Optional[str]:
    """The last identifier of a name, attribute or subscripted one."""
    if isinstance(node, ast.Subscript):
        node = node.value
    d = dotted(node)
    return d.split(".")[-1] if d else None


@register
class TX005MeshAxisName(Rule):
    id = "TX005"
    summary = "mesh axis as a string literal, not a constant of trlx_tpu_torch.parallel.mesh"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        vocab = mesh_axis_vocabulary()
        findings: List[Finding] = []
        seen: Set[int] = set()

        def flag(expr: Optional[ast.AST], where: str) -> None:
            for const in _strings(expr):
                if id(const) in seen:
                    continue
                seen.add(id(const))
                value = const.value
                if value in vocab:
                    msg = (f"hard-coded mesh axis {value!r} in {where}; use {vocab[value]} from "
                           f"trlx_tpu_torch.parallel.mesh")
                else:
                    msg = (f"unknown mesh axis {value!r} in {where}: mesh vocabulary is {sorted(vocab)} "
                           f"(trlx_tpu_torch/parallel/mesh.py)")
                findings.append(self.finding(ctx, const, msg))

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                self._call(node, flag)
            elif isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute) \
                    and node.value.attr in ("shape", "coords"):
                if isinstance(node.slice, ast.Constant) and isinstance(node.slice.value, str):
                    flag(node.slice, f"{dotted(node.value) or node.value.attr}[...]")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for arg, default in _arg_defaults(node):
                    if arg in _AXIS_KEYWORDS:
                        flag(default, f"default of {node.name}({arg}=...)")
            elif isinstance(node, ast.Compare):
                operands = [node.left] + list(node.comparators)
                if any(_AXIS_LIKE.search(_last_name(o) or "") for o in operands):
                    for o in operands:
                        if isinstance(o, ast.Constant):
                            flag(o, f"a comparison with {ast.unparse(node)[:60]}")
        return findings

    @staticmethod
    def _call(call: ast.Call, flag) -> None:
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else fn.id if isinstance(fn, ast.Name) else None
        callee = dotted(fn) or name or "<call>"
        if isinstance(fn, ast.Attribute) and name == "group" and (_last_name(fn.value) or "").endswith("mesh"):
            flag(call.args[0] if call.args else None, f"{callee}(...)")
        elif isinstance(fn, ast.Attribute) and name in _MESH_METHODS:
            flag(call.args[0] if call.args else None, f"{callee}(...)")
        elif isinstance(fn, ast.Attribute) and name == "ranks_with" and call.args \
                and isinstance(call.args[0], ast.Dict):
            for key in call.args[0].keys:
                flag(key, f"{callee}({{...}})")
        elif isinstance(fn, ast.Attribute) and name == "get" and isinstance(fn.value, ast.Attribute) \
                and fn.value.attr in ("shape", "coords"):
            flag(call.args[0] if call.args else None, f"{callee}(...)")
        elif name in _AXIS_FUNCTIONS and len(call.args) > _AXIS_FUNCTIONS[name]:
            flag(call.args[_AXIS_FUNCTIONS[name]], f"{callee}(...)")
        for kw in call.keywords:
            if kw.arg in _AXIS_KEYWORDS:
                flag(kw.value, f"{callee}({kw.arg}=...)")


def _arg_defaults(fn) -> Iterable[Tuple[str, ast.AST]]:
    positional = fn.args.posonlyargs + fn.args.args
    defaults = fn.args.defaults
    for arg, default in zip(positional[len(positional) - len(defaults):], defaults):
        yield arg.arg, default
    for arg, default in zip(fn.args.kwonlyargs, fn.args.kw_defaults):
        if default is not None:
            yield arg.arg, default


# -- TX008 ---------------------------------------------------------------------


def _pspec_names(tree: ast.Module) -> Set[str]:
    """Names bound to the port's ``PartitionSpec`` in this file: imported
    from ``trlx_tpu_torch.parallel.sharding``, defined here (the module
    itself), and local re-aliases (``P = PartitionSpec``)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").endswith("parallel.sharding"):
            names |= {a.asname or a.name for a in node.names if a.name == "PartitionSpec"}
        elif isinstance(node, ast.ClassDef) and node.name == "PartitionSpec":
            names.add(node.name)
    changed = True
    while changed:  # chase P = PartitionSpec; PS = P
        changed = False
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name) and node.value.id in names:
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id not in names:
                        names.add(t.id)
                        changed = True
    return names


@register
class TX008PartitionSpecSanity(Rule):
    id = "TX008"
    summary = "PartitionSpec with unknown/duplicate axes or rank off the sharding table"

    #: expected rank of a rule-table pattern, by path suffix; ``layers_scan``
    #: rules carry one more (stacked-layer) dim
    _SUFFIX_RANK = {"kernel$": 2, "embedding$": 2, "bias$": 1, "scale$": 1}

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        pspec = _pspec_names(ctx.tree)
        if not pspec:
            return []
        vocab = mesh_axis_vocabulary()
        constants = {c: v for v, c in vocab.items()}
        findings: List[Finding] = []

        def is_pspec(node: ast.AST) -> bool:
            if not isinstance(node, ast.Call):
                return False
            if isinstance(node.func, ast.Name):
                return node.func.id in pspec
            return (dotted(node.func) or "").endswith("sharding.PartitionSpec")

        for node in ast.walk(ctx.tree):
            if not is_pspec(node):
                continue
            first: Dict[str, int] = {}
            for arg in node.args:
                if isinstance(arg, ast.Starred):
                    continue  # PartitionSpec(*entries): nothing provable
                for e in arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]:
                    if isinstance(e, ast.Constant):
                        value = e.value if isinstance(e.value, str) else None
                    else:
                        value = constants.get((dotted(e) or "").split(".")[-1])
                    if value is None:
                        continue
                    if value not in vocab:
                        msg = (f"PartitionSpec axis {value!r} is not in the mesh vocabulary {sorted(vocab)} "
                               f"(trlx_tpu_torch/parallel/mesh.py)")
                        findings.append(self.finding(ctx, e, msg))
                    elif value in first:
                        msg = (f"mesh axis {value!r} appears twice in one PartitionSpec (first at line "
                               f"{first[value]}): an axis may shard at most one dim")
                        findings.append(self.finding(ctx, e, msg))
                    else:
                        first[value] = e.lineno
        findings.extend(self._rank_checks(ctx, is_pspec))
        return findings

    def _rank_checks(self, ctx: FileContext, is_pspec) -> List[Finding]:
        findings: List[Finding] = []
        max_rank = _table_max_rank()
        for node in ast.walk(ctx.tree):
            pattern = _rule_entry(node)
            if pattern is not None and is_pspec(node.elts[1]):
                expected = next((rank + ("layers_scan" in pattern) for suffix, rank in self._SUFFIX_RANK.items()
                                 if pattern.endswith(suffix)), None)
                rank = len(node.elts[1].args)
                if expected is not None and rank > expected:
                    findings.append(self.finding(ctx, node.elts[1], f"sharding rule {pattern!r} names a "
                                                                    f"rank-{expected} parameter but its "
                                                                    f"PartitionSpec has {rank} entries"))
            elif isinstance(node, ast.Call) and (dotted(node.func) or "").split(".")[-1] == "shard_tensor":
                spec = node.args[1] if len(node.args) > 1 else next(
                    (kw.value for kw in node.keywords if kw.arg == "spec"), None)
                if spec is None or not is_pspec(spec) or any(isinstance(a, ast.Starred) for a in spec.args):
                    continue
                if len(spec.args) > max_rank:
                    findings.append(self.finding(ctx, spec, f"shard_tensor spec has rank {len(spec.args)}, above "
                                                            f"every rule in parallel/sharding.py's table "
                                                            f"(max rank {max_rank})"))
        return findings
