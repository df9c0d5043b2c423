"""The port's analyzer (``python -m trlx_tpu_torch.analysis``): the copied
framework (noqa, baseline, selectors, exit codes), the PyTorch hazard rules
TX001, TX002 and TX007 on an offending and a fixed fixture each, and the
whole-port gate (exit 0, every suppression carrying its reason)."""

import re
import textwrap
from pathlib import Path

import pytest

from trlx_tpu_torch.analysis import baseline as baseline_mod
from trlx_tpu_torch.analysis.cli import main
from trlx_tpu_torch.analysis.core import Finding, check_file, load_context, load_rules, resolve_select, run

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent


def _write(tmp_path, name, source):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return path


def _rules(findings):
    return sorted((f.rule, f.lineno) for f in findings)


def _check(tmp_path, source, name="mod.py"):
    return check_file(load_context(_write(tmp_path, name, source)))


# -- framework -----------------------------------------------------------------


def test_registering_an_entrypoint_does_not_load_the_analyzer():
    """The hot modules import ``analysis.census.entrypoints`` at module
    scope; that import must not load the rules, the call graph or the
    concurrency model (the package's API loads them on first use)."""
    import subprocess
    import sys

    code = ("import sys, trlx_tpu_torch.analysis.census.entrypoints; "
            "print(sorted(m for m in sys.modules if m.startswith('trlx_tpu_torch.analysis')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert out.strip() == str(["trlx_tpu_torch.analysis", "trlx_tpu_torch.analysis.census",
                               "trlx_tpu_torch.analysis.census.entrypoints"])
    import trlx_tpu_torch.analysis as analysis

    assert "TX002" in analysis.RULES and analysis.run is run


def test_registry_has_the_port_families_and_no_jax_rules():
    ids = set(load_rules())  # the rule modules register on first use
    assert {"TH001", "TH002", "CC001", "CC002", "CC003", "CC004", "CC005", "TX001", "TX002", "TX007"} <= ids
    assert not [r for r in ids if r.startswith(("JX", "SH", "IR"))]
    assert [r.id for r in resolve_select(["CC"])] == ["CC001", "CC002", "CC003", "CC004", "CC005"]
    with pytest.raises(ValueError):
        resolve_select(["JX001"])


def test_noqa_suppresses_per_rule_and_bare(tmp_path):
    src = """\
    import torch
    def f(x):
        a = torch.rand(3)  # graftcheck: noqa[TX001]
        b = torch.rand(3)  # graftcheck: noqa
        c = torch.rand(3)  # graftcheck: noqa[TX007]
        s = "# graftcheck: noqa"; d = torch.rand(3)
    """
    assert _rules(_check(tmp_path, src)) == [("TX001", 5), ("TX001", 6)]


def test_baseline_matches_by_text_and_reports_stale(tmp_path):
    f1 = Finding("p.py", 3, "TX001", "m", "a = torch.rand(3)")
    f2 = Finding("p.py", 9, "TX001", "m", "b = torch.rand(3)")
    path = tmp_path / "baseline.txt"
    path.write_text("# c\np.py:TX001:a = torch.rand(3)  # why\np.py:TX001:gone()  # why\n")
    new, stale = baseline_mod.compare([f1, f2], baseline_mod.load(path))
    assert new == [f2] and stale == ["p.py:TX001:gone()"]
    kept, removed = baseline_mod.prune(path, [f1, f2])
    assert (kept, removed) == (1, ["p.py:TX001:gone()"]) and "# why" in path.read_text()


def test_cli_exit_codes(tmp_path, capsys):
    bad = _write(tmp_path, "bad.py", "import torch\nx = torch.randn(2)\n")
    good = _write(tmp_path, "good.py", "import torch\ng = torch.Generator()\nx = torch.randn(2, generator=g)\n")
    assert main([str(good), "--no-baseline"]) == 0
    assert main([str(bad), "--no-baseline"]) == 1
    assert main([str(bad), "--no-baseline", "--select", "CC"]) == 0
    assert main([str(bad), "--select", "NOPE"]) == 2
    base = tmp_path / "b.txt"
    assert main([str(bad), "--baseline", str(base), "--write-baseline"]) == 0
    assert main([str(bad), "--baseline", str(base)]) == 0
    assert main(["--list-rules"]) == 0
    assert "TX002" in capsys.readouterr().out


# -- TX001 ---------------------------------------------------------------------


def test_tx001_offending_and_fixed(tmp_path):
    bad = """\
    import torch
    import torch.nn.functional as F
    def f(x, probs):
        a = torch.multinomial(probs, 1)
        b = torch.randint(0, 5, (3,))
        x.normal_(0.0, 1.0)
        torch.nn.init.normal_(x)
        return F.dropout(x, 0.1, training=True)
    """
    fixed = """\
    import torch
    import torch.nn.functional as F
    def f(x, probs, g):
        a = torch.multinomial(probs, 1, generator=g)
        b = torch.randint(0, 5, (3,), generator=g)
        x.normal_(0.0, 1.0, generator=g)
        torch.nn.init.normal_(x, generator=g)
        return F.dropout(x, 0.1, training=False)
    """
    assert _rules(_check(tmp_path, bad, "bad.py")) == [("TX001", n) for n in (4, 5, 6, 7, 8)]
    assert _check(tmp_path, fixed, "fixed.py") == []


# -- TX002 ---------------------------------------------------------------------

_REG = """\
from pkg.census import register_entrypoint


@register_entrypoint("hot", roots=("pkg.hot.step",), readback=READBACK)
def build(device, size, shared):
    return None
"""

_HOT = """\
import torch
from pkg.helpers import helper


def step(x: torch.Tensor):
    y = helper(x)
    if torch.isfinite(y).all():
        y = y * 2
    return y.sum().item()


def cold(x: torch.Tensor):
    return x.item()
"""

_HELPERS = """\
import torch


def helper(x: torch.Tensor):
    n = x.dim()
    if n == 2 and x.requires_grad:
        pass
    return x.cpu()
"""


def _tx002(tmp_path, readback, helpers=_HELPERS):
    pkg = tmp_path / "pkg"
    _write(pkg, "__init__.py", "")
    _write(pkg, "census.py", "def register_entrypoint(name, roots=(), readback=None):\n    return lambda f: f\n")
    _write(pkg, "reg.py", _REG.replace("READBACK", readback))
    _write(pkg, "hot.py", _HOT)
    _write(pkg, "helpers.py", helpers)
    return sorted((Path(f.path).name, f.lineno, f.rule) for f in run([str(pkg)], select=["TX002"]))


def test_tx002_offending_and_fixed(tmp_path):
    """A round-trip on the hot path (through an imported helper) is a
    finding unless the registration declares it; the same op off the path
    (``cold``) is none; metadata reads (``dim()``, ``requires_grad``) are
    not round-trips."""
    assert _tx002(tmp_path / "a", "{}") == [
        ("helpers.py", 8, "TX002"), ("hot.py", 7, "TX002"), ("hot.py", 9, "TX002")]
    declared = '{"pkg.hot.step": 2, "pkg.helpers.helper": 1}'
    assert _tx002(tmp_path / "b", declared) == []
    # one more round-trip than declared brings every site of that function back
    helpers = _HELPERS.replace("    return x.cpu()", "    float(x.sum())\n    return x.cpu()")
    assert [r[0] for r in _tx002(tmp_path / "c", declared, helpers)] == ["helpers.py", "helpers.py"]


def test_tx002_reports_a_root_that_resolves_to_nothing(tmp_path):
    pkg = tmp_path / "pkg"
    _write(pkg, "__init__.py", "")
    _write(pkg, "reg.py", '@register_entrypoint("e", roots=("pkg.nowhere.step",))\ndef b(d, s, sh):\n    pass\n')
    findings = run([str(pkg)], select=["TX002"])
    assert [f.rule for f in findings] == ["TX002"] and "pkg.nowhere.step" in findings[0].message


# -- TX007 ---------------------------------------------------------------------


def test_tx007_offending_and_fixed(tmp_path):
    bad = """\
    import torch
    def f(x):
        h = x.to(torch.bfloat16)
        a = h.sum()
        b = torch.softmax(x.half(), -1)
        c = x.bfloat16().float()
        return h.cumsum(0), a, b, c
    """
    fixed = """\
    import torch
    def f(x):
        h = x.to(torch.bfloat16)
        a = h.sum(dtype=torch.float32)
        b = torch.softmax(x.half(), -1, dtype=torch.float32)
        c = x.float()
        return h.cumsum(0, dtype=torch.float32), a, b, c
    """
    assert _rules(_check(tmp_path, bad, "bad.py")) == [("TX007", 4), ("TX007", 5), ("TX007", 6), ("TX007", 7)]
    assert _check(tmp_path, fixed, "fixed.py") == []


# -- the port -----------------------------------------------------------------


def test_the_whole_port_passes_the_gate(monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("TRLX_CONC_SEED_REGRESSION", raising=False)
    assert main(["trlx_tpu_torch"]) == 0
    assert "0 new" in capsys.readouterr().out


def test_every_suppression_in_the_port_carries_its_reason():
    """Each ``# graftcheck: noqa[...]`` in the port's code says why (after
    the marker, or in the comment lines right above it), and each baseline
    entry carries a justification."""
    bare = []
    for path in sorted((ROOT / "trlx_tpu_torch").rglob("*.py")):
        if "analysis" in path.parts:
            continue
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"#\s*graftcheck:\s*noqa(\[[^\]]*\])?(.*)$", line)
            if not m:
                continue
            above = lines[i - 1].strip() if i else ""
            if not m.group(2).strip(" —-") and not above.startswith("#"):
                bare.append(f"{path.relative_to(ROOT)}:{i + 1}")
    assert not bare, bare
    for raw in (ROOT / "trlx_tpu_torch/analysis/baseline.txt").read_text().splitlines():
        if raw.strip() and not raw.startswith("#"):
            assert "  # " in raw and len(raw.rsplit("  # ", 1)[1]) > 20, raw
