"""Branch comparison harness (counterpart of ``trlx_tpu/reference.py``): run
the randomwalks PPO recipe of the port (``scripts/torch_ppo_randomwalks.py``,
on the card by default) on a checkout, record its result keyed by ``git
rev-parse HEAD^{tree}``, and compare two recorded files.

Usage::

    python -m trlx_tpu_torch.reference run  [--output runs/rw_<hash>.json] [--rev REV] [-- script args]
    python -m trlx_tpu_torch.reference diff runs/rw_a.json runs/rw_b.json
    python -m trlx_tpu_torch.reference compare REV

``run --rev REV`` unpacks that revision's tree (``git archive``) into a
temporary directory and runs its copy of the script there. The recorded
metric is the recipe's eval ``reward/mean`` at its gate step (the first
eval at or after step 100); ``diff`` prints it in the JAX harness's format.
"""

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time

SCRIPT = os.path.join("scripts", "torch_ppo_randomwalks.py")


def tree_hash(rev: str = "HEAD") -> str:
    try:
        return subprocess.check_output(["git", "rev-parse", f"{rev}^{{tree}}"], text=True).strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def metrics_of(report: dict) -> dict:
    """The recorded metric of one recipe report: ``reward/mean`` at the gate
    eval (None when PPO stopped before it), with the report's seconds."""
    gate = report.get("gate_eval")
    return {"metric": "reward/mean@gate", "value": None if gate is None else gate[1],
            "gate_step": None if gate is None else gate[0], "ok": report.get("ok"),
            "sft_seconds": report.get("sft_seconds"), "ppo_seconds": report.get("ppo_seconds")}


def last_json_line(text: str):
    for line in reversed(text.splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return None


def run_suite(output: str, rev: str = None, script_args=()):
    """Run the recipe on the current checkout, or with ``rev`` on that
    revision's tree unpacked into a temporary directory; write and return
    the record."""
    cwd, tmp = os.getcwd(), None
    try:
        if rev:
            tmp = tempfile.mkdtemp(prefix=f"trlx_rw_{rev[:12].replace('/', '-')}_")
            blob = subprocess.run(["git", "archive", "--format=tar", rev], capture_output=True, check=True).stdout
            with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
                tar.extractall(tmp, filter="data")
            cwd = tmp
        t0 = time.time()
        proc = subprocess.run([sys.executable, SCRIPT, *script_args], capture_output=True, text=True, cwd=cwd)
        report = last_json_line(proc.stdout) or {}
        record = {
            "rev": rev or "HEAD",
            "tree_hash": tree_hash(rev or "HEAD"),
            "time": time.time(),
            "seconds": round(time.time() - t0, 1),
            "metrics": metrics_of(report) if report else {},
            "report": report,
            "returncode": proc.returncode,
        }
        if proc.returncode != 0:
            record["stderr_tail"] = proc.stderr[-2000:]
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    with open(output, "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps({k: v for k, v in record.items() if k != "report"}))
    return record


def diff(a_path: str, b_path: str) -> str:
    """One line, as the JAX harness prints it: ``metric: a (tree a) -> b
    (tree b)  x ratio``; ``incomparable records`` when either lacks a value."""
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    ma, mb = a.get("metrics", {}), b.get("metrics", {})
    if ma.get("value") is not None and mb.get("value") is not None:
        ratio = mb["value"] / ma["value"] if ma["value"] else float("nan")
        line = (f"{ma.get('metric')}: {ma['value']} ({a['tree_hash'][:8]}) -> "
                f"{mb['value']} ({b['tree_hash'][:8]})  x{ratio:.3f}")
    else:
        line = f"incomparable records {ma} {mb}"
    print(line)
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run")
    p_run.add_argument("--output", default=None)
    p_run.add_argument("--rev", default=None, help="git revision whose tree runs, unpacked in a temporary directory")
    p_run.add_argument("script_args", nargs="*", help="arguments for the recipe script (after --)")
    p_diff = sub.add_parser("diff")
    p_diff.add_argument("a")
    p_diff.add_argument("b")
    p_cmp = sub.add_parser("compare", help="run REV and HEAD, then diff")
    p_cmp.add_argument("rev")
    args = parser.parse_args(argv)
    if args.cmd == "run":
        run_suite(args.output or f"rw_{tree_hash(args.rev or 'HEAD')[:12]}.json", rev=args.rev,
                  script_args=args.script_args)
    elif args.cmd == "compare":
        run_suite("rw_rev.json", rev=args.rev)
        run_suite("rw_head.json")
        diff("rw_rev.json", "rw_head.json")
    else:
        diff(args.a, args.b)


if __name__ == "__main__":
    main()
