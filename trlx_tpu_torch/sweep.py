"""Hyperparameter sweep CLI (counterpart of ``trlx_tpu/sweep.py``, copied:
stdlib and yaml only).

A local process runner over the reference's sweep-config format:

- random | grid trial generation over dotted parameter paths;
- ``--max-concurrent N`` parallel trial subprocesses (keep 1 on one card);
- an asynchronous successive-halving (ASHA) scheduler: trials report
  intermediate metrics (``SWEEP_METRIC`` lines the trainers print at each
  eval under ``TRLX_SWEEP``) and under-performers are asked to stop through
  a stop file (``TRLX_SWEEP_STOP_FILE``) the trainer polls at each eval,
  never a signal, so a trial ends at a step boundary and releases its
  device itself;
- a jsonl results summary plus a markdown report of all trials.

Sweep config YAML format:

    tune_config:
      mode: "max"
      metric: "reward/mean"
      search_alg: "random"      # or "grid"
      num_samples: 8
      scheduler: "asha"         # optional; "none" default
      grace_steps: 100          # first ASHA rung (in trainer steps)
      reduction_factor: 3       # eta
    method.init_kl_coef:
      strategy: "loguniform"
      values: [0.0001, 0.1]
    train.seed:
      strategy: "choice"
      values: [1000, 1001, 1002]

Usage: ``python -m trlx_tpu_torch.sweep --config sweep.yml script.py``,
where the script takes a JSON hparams string as its first argument
(``scripts/torch_ppo_randomwalks.py``, for one).
"""

import argparse
import itertools
import json
import math
import os
import queue
import random
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional


def generate_trials(sweep_config: Dict[str, Any], seed: int = 0) -> List[Dict[str, Any]]:
    tune = sweep_config.get("tune_config", {})
    params = {k: v for k, v in sweep_config.items() if k != "tune_config"}
    rng = random.Random(seed)

    def sample(spec):
        strategy = spec["strategy"]
        values = spec["values"]
        if strategy == "choice":
            return rng.choice(values)
        if strategy == "uniform":
            return rng.uniform(values[0], values[1])
        if strategy == "loguniform":
            import math

            return math.exp(rng.uniform(math.log(values[0]), math.log(values[1])))
        if strategy == "int":
            return rng.randint(values[0], values[1])
        raise ValueError(f"Unknown strategy {strategy}")

    search = tune.get("search_alg", "random")
    if search == "grid":
        keys = list(params)
        grids = [params[k]["values"] for k in keys]
        return [dict(zip(keys, combo)) for combo in itertools.product(*grids)]
    num_samples = int(tune.get("num_samples", 4))
    return [{k: sample(v) for k, v in params.items()} for _ in range(num_samples)]


class _Trial:
    def __init__(self, idx: int, hparams: Dict[str, Any], stop_path: str):
        self.idx = idx
        self.hparams = hparams
        self.stop_path = stop_path
        self.proc: Optional[subprocess.Popen] = None
        self.t0 = 0.0
        self.final_metrics: Optional[Dict[str, Any]] = None
        self.history: List[Dict[str, Any]] = []  # SWEEP_METRIC records
        self.reported_rungs: set = set()
        self.early_stopped = False
        self.returncode: Optional[int] = None
        self.seconds: Optional[float] = None
        self.stderr_path = stop_path + ".stderr"
        self.stderr_file = None


class AshaScheduler:
    """Asynchronous successive halving: when a trial reports a metric at rung
    budget grace*eta^k, it is stopped unless it ranks in the top 1/eta of the
    values seen so far at that rung (Ray Tune's ASHAScheduler)."""

    def __init__(self, metric: str, mode: str, grace_steps: int, eta: int, max_rungs: int = 10):
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self.eta = max(2, int(eta))
        self.rungs = [grace_steps * self.eta ** k for k in range(max_rungs)]
        self.rung_scores: Dict[int, List[float]] = {r: [] for r in self.rungs}

    def on_metric(self, trial: _Trial, step: int, metrics: Dict[str, Any]) -> bool:
        """Record a report; returns True if the trial should be stopped.

        Like Ray's ASHA, a report is credited to at most ONE rung per event —
        the smallest uncredited rung whose budget has been reached — so a late
        report cannot seed several early rungs with an extra-training value."""
        value = metrics.get(self.metric)
        if value is None:
            return False
        for rung in self.rungs:
            if rung in trial.reported_rungs:
                continue
            if step < rung:
                break
            trial.reported_rungs.add(rung)
            scores = self.rung_scores[rung]
            scores.append(self.sign * float(value))
            if len(scores) >= self.eta:
                top_k = max(1, math.ceil(len(scores) / self.eta))
                cutoff = sorted(scores, reverse=True)[top_k - 1]
                if self.sign * float(value) < cutoff:
                    return True
            break
        return False


def _reader(trial: _Trial, events: "queue.Queue"):
    """Stream a trial's stdout, forwarding metric lines as events. The exit
    event is guaranteed even if reading raises (e.g. a decode error from
    non-UTF-8 trial output) — otherwise run_trials would wait forever."""
    try:
        for line in trial.proc.stdout:
            line = line.strip()
            if line.startswith("SWEEP_METRIC "):
                try:
                    events.put(("metric", trial, json.loads(line[len("SWEEP_METRIC "):])))
                except json.JSONDecodeError:
                    pass
            elif line.startswith("SWEEP_RESULT "):
                try:
                    trial.final_metrics = json.loads(line[len("SWEEP_RESULT "):])
                except json.JSONDecodeError:
                    pass
    finally:
        trial.proc.wait()
        events.put(("exit", trial, None))


def run_trials(
    script: str,
    trials: List[Dict[str, Any]],
    out_path: str,
    metric: str,
    mode: str,
    max_concurrent: int = 1,
    scheduler: Optional[AshaScheduler] = None,
    report_path: Optional[str] = None,
    extra_env: Optional[Dict[str, str]] = None,
):
    records: List[_Trial] = [
        _Trial(i, hp, out_path + f".stop{i}") for i, hp in enumerate(trials)
    ]
    pending = list(records)
    running: Dict[int, _Trial] = {}
    events: "queue.Queue" = queue.Queue()

    def launch(trial: _Trial):
        print(f"[sweep] trial {trial.idx + 1}/{len(trials)}: {trial.hparams}", flush=True)
        env = dict(os.environ, TRLX_SWEEP="1", TRLX_SWEEP_STOP_FILE=trial.stop_path)
        env.update(extra_env or {})
        if os.path.exists(trial.stop_path):
            os.remove(trial.stop_path)
        trial.t0 = time.time()
        trial.stderr_file = open(trial.stderr_path, "w")
        trial.proc = subprocess.Popen(
            [sys.executable, script, json.dumps(trial.hparams)],
            stdout=subprocess.PIPE, stderr=trial.stderr_file, text=True, env=env,
        )
        running[trial.idx] = trial
        threading.Thread(target=_reader, args=(trial, events), daemon=True).start()

    while pending and len(running) < max_concurrent:
        launch(pending.pop(0))

    try:
        _event_loop(
            script, trials, out_path, metric, mode, records, pending, running,
            events, scheduler, launch,
        )
    finally:
        # on any abort (Ctrl-C, scheduler error): ask surviving trials to stop
        # via their stop files (a trial then ends at a step boundary and
        # releases its device itself) and give them a grace period
        for trial in list(running.values()):
            try:
                with open(trial.stop_path, "w") as f:
                    f.write("sweep-aborted")
            except OSError:
                pass
        for trial in list(running.values()):
            try:
                trial.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                print(f"[sweep] trial {trial.idx} still running after abort request", flush=True)

    _write_results(records, out_path)
    scored = [t for t in records if (t.final_metrics or {}).get(metric) is not None]
    best = None
    if scored:
        best = (max if mode == "max" else min)(scored, key=lambda t: t.final_metrics[metric])
        print(
            f"[sweep] best trial: {best.idx} {metric}={best.final_metrics[metric]} {best.hparams}"
        )
    if report_path:
        _write_report(report_path, records, metric, mode, best)
    return [_record_dict(t) for t in records]


def _event_loop(script, trials, out_path, metric, mode, records, pending, running, events, scheduler, launch):
    while running:
        kind, trial, payload = events.get()
        if kind == "metric":
            trial.history.append(payload)
            if (
                scheduler is not None
                and not trial.early_stopped  # ignore post-stop reports
                and scheduler.on_metric(trial, int(payload.get("step", 0)), payload)
            ):
                # ask the trainer to stop at its next eval; never signal the process
                with open(trial.stop_path, "w") as f:
                    f.write("asha-stop")
                trial.early_stopped = True
                print(f"[sweep] ASHA stopping trial {trial.idx} at step {payload.get('step')}", flush=True)
        elif kind == "exit":
            trial.returncode = trial.proc.returncode
            trial.seconds = round(time.time() - trial.t0, 1)
            running.pop(trial.idx, None)
            if trial.stderr_file is not None:
                trial.stderr_file.close()
            cleanup = [trial.stop_path]
            if trial.returncode == 0:
                cleanup.append(trial.stderr_path)  # kept only for failure triage
            for path in cleanup:
                if os.path.exists(path):
                    os.remove(path)
            print(
                f"[sweep] trial {trial.idx} finished rc={trial.returncode} "
                f"({trial.seconds}s{', early-stopped' if trial.early_stopped else ''})",
                flush=True,
            )
            _write_results(records, out_path)
            if pending:
                launch(pending.pop(0))


def _record_dict(t: _Trial) -> Dict[str, Any]:
    rec = {
        "trial": t.idx,
        "hparams": t.hparams,
        "returncode": t.returncode,
        "early_stopped": t.early_stopped,
        "num_reports": len(t.history),
        "seconds": t.seconds,
    }
    if t.final_metrics is not None:
        rec["metrics"] = t.final_metrics
    if t.returncode not in (0, None) and os.path.exists(t.stderr_path):
        with open(t.stderr_path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - 2000))
            rec["stderr_tail"] = f.read().decode(errors="replace")
    return rec


def _write_results(records: List[_Trial], out_path: str):
    with open(out_path, "w") as f:
        for t in records:
            f.write(json.dumps(_record_dict(t)) + "\n")


def _write_report(path: str, records: List[_Trial], metric: str, mode: str, best: Optional[_Trial]):
    """Markdown trial report (the local counterpart of a W&B sweep report)."""
    keys = sorted({k for t in records for k in t.hparams})
    lines = ["# Sweep report", ""]
    if best is not None:
        lines += [f"**Best trial**: #{best.idx} with {metric} = {best.final_metrics[metric]} ({mode})", ""]
    lines += ["| trial | " + " | ".join(keys) + f" | {metric} | reports | status |",
              "|" + "---|" * (len(keys) + 4)]
    for t in records:
        val = (t.final_metrics or {}).get(metric, "—")
        status = "early-stopped" if t.early_stopped else ("failed" if t.returncode else "done")
        lines.append(
            f"| {t.idx} | "
            + " | ".join(str(t.hparams.get(k, "")) for k in keys)
            + f" | {val} | {len(t.history)} | {status} |"
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main():
    parser = argparse.ArgumentParser(description="trlx_tpu_torch hyperparameter sweep")
    parser.add_argument("script", help="training script accepting a JSON hparams argv[1]")
    parser.add_argument("--config", required=True, help="sweep config yaml")
    parser.add_argument("--output", default="sweep_results.jsonl")
    parser.add_argument("--report", default=None, help="markdown report path")
    parser.add_argument("--max-concurrent", type=int, default=None,
                        help="parallel trial processes (default: tune_config or 1; "
                        "keep 1 on a single card)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import yaml  # only the CLI reads a config file

    with open(args.config) as f:
        sweep_config = yaml.safe_load(f)
    tune = sweep_config.get("tune_config", {})
    trials = generate_trials(sweep_config, args.seed)
    metric = tune.get("metric", "reward/mean")
    mode = tune.get("mode", "max")
    scheduler = None
    if str(tune.get("scheduler", "none")).lower() == "asha":
        scheduler = AshaScheduler(
            metric, mode,
            grace_steps=int(tune.get("grace_steps", 100)),
            eta=int(tune.get("reduction_factor", 3)),
        )
    max_concurrent = args.max_concurrent or int(tune.get("max_concurrent", 1))
    run_trials(
        args.script, trials, args.output, metric, mode,
        max_concurrent=max_concurrent, scheduler=scheduler,
        report_path=args.report or os.path.splitext(args.output)[0] + ".md",
    )


if __name__ == "__main__":
    main()
