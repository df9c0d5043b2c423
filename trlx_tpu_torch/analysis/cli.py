"""graftcheck command line for the port.

Usage::

    python -m trlx_tpu_torch.analysis PATH [PATH...] [options]

Options:
    --suite NAME         which analyzer(s) to run:
                           ast     static TH/TX rules (in process)
                           conc    static CC rules (in process)
                           census  the per-step census of the registered hot
                                   entrypoints against the committed budget
                                   (``python -m trlx_tpu_torch.analysis.census``,
                                   as a subprocess: it runs the steps)
                           all     every static rule, then the census; exit
                                   status is the worse of the two
                         Without --suite every static rule runs in process.
    --baseline FILE      baseline file (default: the package's baseline.txt)
    --no-baseline        ignore the baseline (report every finding as new)
    --write-baseline     rewrite the baseline from the current findings and
                         exit 0 (each entry gets a TODO justification)
    --prune-baseline     drop stale baseline entries (keeping comments and
                         justifications verbatim) and exit 0
    --select R1,R2       run only the listed rule ids; a prefix selects the
                         whole family (--select CC = CC001..CC005)
    --jobs N             check files on N forked workers
    --list-rules         print the rule registry and exit

Exit status: 1 if any *new* finding (not noqa'd, not baselined) or, for the
census, any budget violation; 2 on a usage error; else 0 — the contract of
the reference's ``python -m trlx_tpu.analysis``.
"""

import argparse
import subprocess
import sys
from pathlib import Path

from trlx_tpu_torch.analysis import baseline as baseline_mod
from trlx_tpu_torch.analysis.core import RULES, load_rules, resolve_select, run

DEFAULT_BASELINE = str(Path(__file__).resolve().parent / "baseline.txt")
DEFAULT_PATHS = ["trlx_tpu_torch"]

# suite -> default --select for the in-process static pass (None = every rule)
SUITE_SELECTS = {"ast": "TH,TX", "conc": "CC"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m trlx_tpu_torch.analysis",
        description="graftcheck: concurrency- and PyTorch-aware static analysis of the port",
    )
    parser.add_argument("paths", nargs="*", default=DEFAULT_PATHS)
    parser.add_argument("--suite", choices=["ast", "conc", "census", "all"], default=None,
                        help="analyzer suite(s) to run; omit for every static rule in process")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE)
    parser.add_argument("--no-baseline", action="store_true")
    parser.add_argument("--write-baseline", action="store_true")
    parser.add_argument("--prune-baseline", action="store_true")
    parser.add_argument("--select", default=None, help="comma-separated rule ids or family prefixes")
    parser.add_argument("--jobs", type=int, default=1, help="process-parallel file checking")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    load_rules()

    if args.list_rules:
        for rid in sorted(RULES):
            print(f"{rid}  {RULES[rid].summary}")
        return 0

    if args.suite == "census":
        if args.write_baseline or args.prune_baseline:
            print("graftcheck: --write-baseline/--prune-baseline apply to the static rules", file=sys.stderr)
            return 2
        return subprocess.call([sys.executable, "-m", "trlx_tpu_torch.analysis.census"])
    if args.suite in ("ast", "conc") and not args.select:
        args.select = SUITE_SELECTS[args.suite]

    select = None
    if args.select:
        select = [r.strip() for r in args.select.split(",") if r.strip()]
    paths = args.paths or DEFAULT_PATHS
    try:
        findings = run(paths, select=select, jobs=args.jobs)
    except ValueError as e:
        print(f"graftcheck: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        n = baseline_mod.write(args.baseline, findings)
        print(f"graftcheck: wrote {n} baseline entries to {args.baseline}")
        return 0

    if args.prune_baseline:
        kept, removed = baseline_mod.prune(args.baseline, findings)
        for key in removed:
            print(f"graftcheck: pruned stale baseline entry: {key}")
        print(f"graftcheck: baseline {args.baseline}: {kept} entr{'y' if kept == 1 else 'ies'} kept, "
              f"{len(removed)} pruned")
        return 0

    base = baseline_mod.load("/dev/null" if args.no_baseline else args.baseline)
    new, stale = baseline_mod.compare(findings, base)
    # a subsetted run cannot prove an entry stale: a rule that did not run,
    # or a file that was not scanned, never had the chance to re-find it
    if select:
        ran = {rule.id for rule in resolve_select(select)}
        stale = [k for k in stale if k.count(":") < 2 or k.split(":", 2)[1] in ran]
    scanned = [p.rstrip("/") for p in paths]
    stale = [
        k for k in stale
        if k.count(":") < 2
        or any(k.split(":", 1)[0] == p or k.split(":", 1)[0].startswith(p + "/") for p in scanned)
    ]

    for f in new:
        print(f)
    for key in stale:
        print(f"graftcheck: stale baseline entry (fixed? remove it): {key}")
    print(
        f"graftcheck: {len(findings)} finding(s) "
        f"({len(new)} new, {len(findings) - len(new)} baselined, {len(stale)} stale baseline)"
    )
    rc = 1 if new else 0
    if args.suite == "all":
        rc = max(rc, subprocess.call([sys.executable, "-m", "trlx_tpu_torch.analysis.census"]))
    return rc


if __name__ == "__main__":
    sys.exit(main())
