"""graftcheck core: findings, rule registry, noqa suppression, file runner.

A copy of the JAX package's framework (``trlx_tpu/analysis/core.py``) with
the port's rule families: thread and lock discipline (``TH0xx``,
:mod:`trlx_tpu_torch.analysis.rules_threads`), the interprocedural
concurrency model (``CC0xx``, :mod:`trlx_tpu_torch.analysis.conc`) and the
PyTorch hazards (``TX0xx``, :mod:`trlx_tpu_torch.analysis.rules_torch`).
Rules see one file's AST at a time, plus one whole-program structure:
``run()`` parses every file first and builds a
:class:`trlx_tpu_torch.analysis.callgraph.Project` (cross-module import-aware
call graph, thread entry points, the functions reachable from the
registered hot entrypoints), attached to each :class:`FileContext` as
``ctx.project``.

Suppression layers, in order of preference:

1. Fix the code.
2. ``# graftcheck: noqa[RULE]`` on the offending line — for findings that are
   *intentional* and local (e.g. a documented lock-free fast path). Bare
   ``# graftcheck: noqa`` suppresses every rule on that line.
3. The committed baseline file (:mod:`trlx_tpu_torch.analysis.baseline`,
   ``trlx_tpu_torch/analysis/baseline.txt``) — for grandfathered findings,
   each carrying a one-line justification. The gate fails on any finding
   that is neither suppressed nor baselined.
"""

import ast
import os
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

#: ``# graftcheck: noqa`` / ``# graftcheck: noqa[TX001]`` / ``[TX001,TH002]``
_NOQA_RE = re.compile(r"#\s*graftcheck:\s*noqa(?:\s*\[([A-Za-z0-9_,\s]+)\])?")

#: Matches every rule on the line (bare ``noqa``).
_ALL_RULES = "*"


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source line."""

    path: str  # as given on the command line (posix-normalized)
    lineno: int
    rule: str
    message: str
    line_text: str = ""  # stripped source line, the line-number-stable key

    def key(self) -> str:
        """Baseline identity: path + rule + code text, NOT the line number —
        a finding must stay matched when unrelated edits shift it."""
        return f"{self.path}:{self.rule}:{self.line_text}"

    def __str__(self) -> str:
        return f"{self.path}:{self.lineno}: {self.rule} {self.message}"


class Rule:
    """A semantic check. Subclasses set ``id``/``summary`` and implement
    :meth:`check` yielding :class:`Finding`s for one file."""

    id: str = ""
    summary: str = ""

    def check(self, ctx: "FileContext") -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "FileContext", node: ast.AST, message: str) -> Finding:
        lineno = getattr(node, "lineno", 0)
        return Finding(
            path=ctx.rel,
            lineno=lineno,
            rule=self.id,
            message=message,
            line_text=ctx.line(lineno),
        )


#: rule id -> rule instance; populated by :func:`register` at import time.
RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule to the global registry."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if inst.id in RULES:
        raise ValueError(f"duplicate rule id {inst.id}")
    RULES[inst.id] = inst
    return cls


@dataclass
class FileContext:
    """Everything a rule may need about one file, parsed once."""

    path: Path
    rel: str
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)
    noqa: Dict[int, Set[str]] = field(default_factory=dict)
    #: the run-wide callgraph.Project; None for single-file use (tests,
    #: library callers) — rules must degrade to per-file reasoning then
    project: Optional[object] = None

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, finding: Finding) -> bool:
        rules = self.noqa.get(finding.lineno)
        if rules is None:
            return False
        return _ALL_RULES in rules or finding.rule in rules


def _parse_noqa(source: str) -> Dict[int, Set[str]]:
    """Line -> suppressed rule ids, via the token stream so ``graftcheck:
    noqa`` inside a string literal is not a suppression."""
    noqa: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(iter(source.splitlines(True)).__next__)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _NOQA_RE.search(tok.string)
            if not m:
                continue
            rules = noqa.setdefault(tok.start[0], set())
            if m.group(1) is None:
                rules.add(_ALL_RULES)
            else:
                rules.update(r.strip() for r in m.group(1).split(",") if r.strip())
    except (tokenize.TokenizeError, IndentationError):
        pass
    return noqa


def load_context(path: Path, rel: Optional[str] = None) -> Optional[FileContext]:
    """Parse one file into a :class:`FileContext`; None when unreadable
    (the caller reports syntax errors through a finding instead)."""
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    return FileContext(
        path=path,
        rel=rel if rel is not None else path.as_posix(),
        source=source,
        tree=tree,
        lines=source.splitlines(),
        noqa=_parse_noqa(source),
    )


def iter_py_files(paths: Sequence) -> Iterable[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" not in f.parts:
                    yield f
        elif p.suffix == ".py":
            yield p


def load_rules() -> Dict[str, "Rule"]:
    """The full registry: the rule modules register on import, so importing
    them here makes ``from analysis.core import run`` (or ``check_file``)
    enough on its own."""
    from trlx_tpu_torch.analysis import rules_spmd, rules_threads, rules_torch  # noqa: F401
    from trlx_tpu_torch.analysis.conc import rules_conc  # noqa: F401

    return RULES


def check_file(ctx: FileContext, rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Run ``rules`` (default: all registered) over one parsed file,
    dropping noqa-suppressed findings."""
    out: List[Finding] = []
    for rule in rules if rules is not None else load_rules().values():
        for f in rule.check(ctx):
            if not ctx.suppressed(f):
                out.append(f)
    out.sort(key=lambda f: (f.lineno, f.rule))
    return out


def resolve_select(select: Sequence[str]) -> List[Rule]:
    """Selectors -> rule instances. A selector matches its exact rule id, or
    — as a *family prefix* — every registered rule id starting with it
    (``--select CC`` runs CC001–CC005). Unknown selectors raise."""
    load_rules()
    out: List[Rule] = []
    seen: Set[str] = set()
    unknown: List[str] = []
    for sel in select:
        if sel in RULES:
            matched = [sel]
        else:
            matched = sorted(r for r in RULES if r.startswith(sel))
        if not matched:
            unknown.append(sel)
        for rid in matched:
            if rid not in seen:
                seen.add(rid)
                out.append(RULES[rid])
    if unknown:
        raise ValueError(f"unknown rule id(s): {sorted(unknown)}")
    return out


# module state for the --jobs fork pool: workers inherit the parsed contexts,
# the call graph, and the conc report copy-on-write instead of pickling them
_POOL_STATE: Dict[str, object] = {}


def _check_indexed(i: int) -> List[Finding]:
    contexts = _POOL_STATE["contexts"]
    rules = _POOL_STATE["rules"]
    return check_file(contexts[i], rules)  # type: ignore[index]


def run(paths: Sequence, select: Optional[Sequence[str]] = None, jobs: int = 1) -> List[Finding]:
    """Check every ``.py`` under ``paths``; unparseable files yield a single
    ``GC000`` finding. ``jobs > 1`` fans the per-file checks out over a fork pool —
    parsing, the call graph, and the conc model stay in the parent (they are
    whole-program), the workers inherit them copy-on-write."""
    load_rules()
    from trlx_tpu_torch.analysis.callgraph import Project
    from trlx_tpu_torch.analysis.conc import model as conc_model, seeds as conc_seeds

    rules: Optional[List[Rule]] = None
    if select is not None:
        rules = resolve_select(select)
    findings: List[Finding] = []
    contexts: List[FileContext] = []
    for f in iter_py_files(paths):
        rel = f.as_posix()
        try:
            contexts.append(load_context(f, rel))
        except (SyntaxError, UnicodeDecodeError) as e:
            lineno = getattr(e, "lineno", 0) or 0
            findings.append(
                Finding(path=rel, lineno=lineno, rule="GC000", message=f"unparseable: {e}")
            )
    # seeded regressions mutate the parsed ASTs before any whole-program
    # structure is built (TRLX_CONC_SEED_REGRESSION; no-op when unset)
    conc_seeds.apply(contexts)
    # two-phase: parse everything, then build the cross-module call graph so
    # every rule sees hot-path reachability that crosses file boundaries, then
    # the conc model on top of it (both computed once, shared by every rule)
    project = Project(contexts)
    conc_model.analyze(project)
    for ctx in contexts:
        ctx.project = project
    # more workers than cores is pure fork/pickle overhead: on a 1-core host
    # --jobs N degrades to the serial path instead of paying for a pool
    jobs = min(jobs, os.cpu_count() or 1)
    if jobs > 1 and len(contexts) > 1:
        try:
            import multiprocessing

            mp = multiprocessing.get_context("fork")
        except ValueError:
            mp = None
        if mp is not None:
            _POOL_STATE["contexts"] = contexts
            _POOL_STATE["rules"] = rules
            try:
                with mp.Pool(min(jobs, len(contexts))) as pool:
                    for file_findings in pool.map(_check_indexed, range(len(contexts))):
                        findings.extend(file_findings)
                return findings
            finally:
                _POOL_STATE.clear()
        # fork unavailable: fall through to the serial path
    for ctx in contexts:
        findings.extend(check_file(ctx, rules))
    return findings
