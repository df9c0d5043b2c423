"""Experiment trackers (counterpart of ``trlx_tpu/utils/trackers.py``,
``jsonl`` only: the wandb and tensorboard backends come with the
observability slice)."""

import json
import os
import time
from typing import Any, Dict, Optional


class BaseTracker:
    def log(self, stats: Dict[str, Any], step: int):
        pass

    def log_table(self, name: str, columns, rows, step: int):
        pass

    def finish(self):
        pass


class JsonlTracker(BaseTracker):
    """One JSON object per line: the config first, then each step's stats
    and each eval sample table; flushed per record."""

    def __init__(self, logging_dir: str, run_name: str, config: Optional[dict] = None):
        os.makedirs(logging_dir, exist_ok=True)
        self.path = os.path.join(logging_dir, f"{run_name}.jsonl")
        self._f = open(self.path, "a")
        if config is not None:
            self._f.write(json.dumps({"_config": config, "_time": time.time()}) + "\n")

    def log(self, stats, step):
        rec = {"step": step, "_time": time.time()}
        for k, v in stats.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_table(self, name, columns, rows, step):
        self._f.write(
            json.dumps({"step": step, "_table": name, "columns": columns, "rows": rows[:32]})
            + "\n"
        )
        self._f.flush()

    def finish(self):
        if self._f.closed:
            return
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError:
            pass
        self._f.close()


def make_tracker(train_config, full_config: dict) -> BaseTracker:
    """Build the configured tracker (``jsonl`` or None)."""
    if train_config.tracker is None:
        return BaseTracker()
    run_name = train_config.run_name or f"run-{int(time.time())}"
    logging_dir = train_config.logging_dir or os.path.join(train_config.checkpoint_dir, "logs")
    if train_config.tracker == "jsonl":
        return JsonlTracker(logging_dir, run_name, full_config)
    if train_config.tracker in ("wandb", "tensorboard"):
        raise NotImplementedError(
            f"trlx_tpu_torch does not port the {train_config.tracker!r} tracker yet: "
            "observability slice (use tracker='jsonl' or None)"
        )
    raise ValueError(f"Unknown tracker {train_config.tracker!r}")
