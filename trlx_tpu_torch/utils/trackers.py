"""Experiment trackers: wandb / tensorboard / jsonl (counterpart of
``trlx_tpu/utils/trackers.py``). ``jsonl`` keeps full observability with no
network; ``tensorboard`` writes event files through
``torch.utils.tensorboard``; ``wandb`` is imported when it is asked for. A
backend that cannot be built falls back to jsonl with a warning, as in the
JAX package: a logging backend never stops training. The port runs one
process, so the tracker logs unconditionally."""

import json
import os
import time
from typing import Any, Dict, Optional

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


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


def rows_to_markdown(columns, rows, max_rows: int = 32) -> str:
    """Render a sample table as a GitHub-style markdown table (pipes escaped
    so generated text can't break the layout)."""

    def cell(v):
        return str(v).replace("|", "\\|").replace("\n", " ")

    lines = [
        "| " + " | ".join(cell(c) for c in columns) + " |",
        "|" + " --- |" * len(columns),
    ]
    for row in rows[:max_rows]:
        lines.append("| " + " | ".join(cell(v) for v in row) + " |")
    if len(rows) > max_rows:
        lines.append(f"\n_… {len(rows) - max_rows} more rows truncated_")
    return "\n".join(lines)


class TensorboardTracker(BaseTracker):
    """Scalars through ``SummaryWriter.add_scalar``; eval sample tables as
    markdown text (tensorboard has no table primitive)."""

    def __init__(self, logging_dir: str, run_name: str, config=None):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(os.path.join(logging_dir, run_name))

    def log(self, stats, step):
        for k, v in stats.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                continue

    def log_table(self, name, columns, rows, step):
        try:
            self.writer.add_text(name, rows_to_markdown(columns, rows), step)
        except Exception as e:
            logger.warning(f"tensorboard log_table failed ({e}); table dropped")

    def finish(self):
        # flush before close: close() alone can discard events still buffered
        # in the writer's queue at the end of a run
        try:
            self.writer.flush()
        finally:
            self.writer.close()


class WandbTracker(BaseTracker):
    """wandb backend. ``log``/``log_table`` swallow backend exceptions — a
    network hiccup mid-run must not kill training (the same contract
    :func:`make_tracker` applies to tracker construction)."""

    def __init__(self, project, entity, group, name, tags, config):
        import wandb

        self.run = wandb.init(
            project=project, entity=entity, group=group, name=name, tags=tags,
            config=config, reinit=True,
        )
        self.wandb = wandb

    def log(self, stats, step):
        try:
            self.run.log(dict(stats), step=step)
        except Exception as e:
            logger.warning(f"wandb log failed at step {step} ({e}); stats dropped")

    def log_table(self, name, columns, rows, step):
        try:
            table = self.wandb.Table(columns=columns, rows=rows)
            self.run.log({name: table}, step=step)
        except Exception as e:
            logger.warning(f"wandb log_table failed at step {step} ({e}); table dropped")

    def finish(self):
        try:
            self.run.finish()
        except Exception as e:
            logger.warning(f"wandb finish failed ({e})")


def make_tracker(train_config, full_config: dict) -> BaseTracker:
    """Build the configured tracker (``jsonl``, ``tensorboard``, ``wandb`` or
    None); a backend that fails to build falls back to jsonl."""
    if train_config.tracker is None:
        return BaseTracker()
    run_name = train_config.run_name or f"run-{int(time.time())}"
    logging_dir = train_config.logging_dir or os.path.join(train_config.checkpoint_dir, "logs")
    kind = train_config.tracker
    try:
        if kind == "wandb":
            return WandbTracker(
                train_config.project_name, train_config.entity_name,
                train_config.group_name, run_name, list(train_config.tags), full_config,
            )
        if kind == "tensorboard":
            return TensorboardTracker(logging_dir, run_name, full_config)
        if kind == "jsonl":
            return JsonlTracker(logging_dir, run_name, full_config)
    except Exception as e:  # tracker backends are optional; never kill training
        logger.warning(f"Tracker {kind!r} unavailable ({e}); falling back to jsonl")
        return JsonlTracker(logging_dir, run_name, full_config)
    raise ValueError(f"Unknown tracker {kind!r}")
