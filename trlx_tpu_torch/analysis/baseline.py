"""Committed baseline of grandfathered graftcheck findings.

Format (one finding per line, ``#`` comments and blanks ignored)::

    path.py:RULE:<stripped source line>  # one-line justification

The key is path + rule + *code text*, never the line number, so unrelated
edits that shift a finding do not invalidate the baseline — but changing the
offending line itself (even whitespace-insignificantly) does, which is the
point: touched code must be brought up to the rules.

``compare`` consumes baseline entries as multisets: two identical findings
need two baseline lines. Stale entries (baselined findings that no longer
fire) are reported so the baseline shrinks as code is fixed; they are
warnings, not failures, because a fix landing in one change must not force a
lockstep baseline edit to keep unrelated CI green.
"""

from collections import Counter
from pathlib import Path
from typing import Iterable, List, Tuple

from trlx_tpu_torch.analysis.core import Finding

_SEP = ":"


def parse_line(line: str) -> str:
    """Key portion of one baseline line (justification comment stripped).

    The code text may itself contain ``#`` (in a string literal), so the
    justification separator is the *last* ``  #`` (two spaces + hash)."""
    idx = line.rfind("  #")
    if idx != -1:
        line = line[:idx]
    return line.strip()


def load(path) -> Counter:
    """Baseline file -> multiset of finding keys. Missing file = empty."""
    p = Path(path)
    if not p.exists():
        return Counter()
    keys: Counter = Counter()
    for raw in p.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        key = parse_line(line)
        if key:
            keys[key] += 1
    return keys


def compare(findings: Iterable[Finding], baseline: Counter) -> Tuple[List[Finding], List[str]]:
    """Split findings into (new, stale-baseline-keys).

    ``new`` = findings not covered by the baseline multiset.
    ``stale`` = baseline keys with no matching current finding.
    """
    remaining = Counter(baseline)
    new: List[Finding] = []
    for f in findings:
        k = f.key()
        if remaining[k] > 0:
            remaining[k] -= 1
        else:
            new.append(f)
    stale = sorted(k for k, n in remaining.items() if n > 0 for _ in range(n))
    return new, stale


def prune(path, findings: Iterable[Finding]) -> Tuple[int, List[str]]:
    """Rewrite the baseline keeping only entries that still fire.

    Returns ``(kept, removed_keys)``. Comments, blank lines, and each kept
    entry's justification are preserved verbatim — only stale entries are
    dropped, so a hand-curated baseline survives the prune. Entries are
    consumed as a multiset in file order, mirroring :func:`compare`: if three
    identical findings fire and the file holds four copies, the last copy is
    the stale one. Missing file is a no-op."""
    p = Path(path)
    if not p.exists():
        return 0, []
    available = Counter(f.key() for f in findings)
    kept_lines: List[str] = []
    removed: List[str] = []
    kept = 0
    for raw in p.read_text().splitlines():
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            kept_lines.append(raw)
            continue
        key = parse_line(stripped)
        if available[key] > 0:
            available[key] -= 1
            kept_lines.append(raw)
            kept += 1
        else:
            removed.append(key)
    if removed:
        p.write_text("\n".join(kept_lines) + "\n")
    return kept, removed


def write(path, findings: Iterable[Finding]) -> int:
    """Write a fresh baseline for ``findings`` (used by ``--write-baseline``).
    Every entry gets a TODO justification the author must replace."""
    lines = [
        "# graftcheck baseline — grandfathered findings, one per line.",
        "# Format: path.py:RULE:<offending source line>  # justification",
        "# New findings never land here; fix them or noqa them at the line.",
        "",
    ]
    n = 0
    for f in sorted(findings, key=lambda f: (f.path, f.rule, f.lineno)):
        lines.append(f"{f.key()}  # TODO: justify or fix")
        n += 1
    Path(path).write_text("\n".join(lines) + "\n")
    return n
