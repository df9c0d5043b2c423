"""Port parity for the experiment trackers: trlx_tpu_torch.utils.trackers
against trlx_tpu.utils.trackers.

Checked: ``rows_to_markdown`` equal; the tensorboard trackers of both
packages write the same scalars and the same markdown sample table into
their event files (read back record by record); ``wandb``, which is not
installed, falls back to jsonl with the same warning in both, and
``WandbTracker`` alone raises the missing import; an unknown tracker raises
in both; jsonl records equal but for their wall-clock stamps; and a CPU
``PPOTrainer`` built with ``tracker="tensorboard"`` logs its steps there.
"""

import glob
import json
import logging as py_logging
import os
import struct
import sys

import pytest

from trlx_tpu.utils import trackers as jax_trackers
from trlx_tpu_torch.utils import trackers

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "


@pytest.fixture
def lib_caplog(caplog):
    """Both libraries' root loggers do not propagate: attach caplog's handler."""
    loggers = [py_logging.getLogger(name) for name in ("trlx_tpu", "trlx_tpu_torch")]
    for lg in loggers:
        lg.addHandler(caplog.handler)
    try:
        yield caplog
    finally:
        for lg in loggers:
            lg.removeHandler(caplog.handler)


TABLES = {
    "plain": (["prompt", "output", "reward"], [["ab", "cd", 1.0], ["e", "f", -0.5]]),
    "escapes": (["a|b", "c"], [["x|y", "m\nn"], ["|", ""]]),
    "truncated": (["a"], [[str(i)] for i in range(40)]),
    "empty": (["only"], []),
}


@pytest.mark.parametrize("case", sorted(TABLES))
@pytest.mark.parametrize("max_rows", [1, 32])
def test_rows_to_markdown_matches_jax(case, max_rows):
    columns, rows = TABLES[case]
    assert trackers.rows_to_markdown(columns, rows, max_rows) == \
        jax_trackers.rows_to_markdown(columns, rows, max_rows)


def _events(run_dir):
    """(tag, step, value or text) of every summary value in a run's event
    files, read as TFRecords (no TensorFlow reader needed)."""
    from tensorboard.compat.proto import event_pb2

    out = []
    for path in sorted(glob.glob(os.path.join(run_dir, "events.out.tfevents.*"))):
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            (length,) = struct.unpack("<Q", data[pos:pos + 8])
            record = data[pos + 12:pos + 12 + length]
            pos += 12 + length + 4
            event = event_pb2.Event.FromString(record)
            for v in event.summary.value:
                payload = v.simple_value if v.WhichOneof("value") == "simple_value" else \
                    [s.decode() for s in v.tensor.string_val]
                out.append((v.tag, event.step, payload))
    return out


def test_tensorboard_trackers_write_the_same_events_as_jax(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    logged = []
    for name, module in (("port", trackers), ("jax", jax_trackers)):
        tb = module.TensorboardTracker(str(tmp_path / name), "run")
        tb.log({"losses/total_loss": 0.25, "time/step": 1.5, "note": "not a number", "none": None}, step=1)
        tb.log({"losses/total_loss": 0.125, "throughput/mfu": 0.04}, step=2)
        tb.log_table("samples", *TABLES["escapes"], step=2)
        tb.finish()
        logged.append(_events(str(tmp_path / name / "run")))
    port, ref = logged
    assert port == ref
    assert ("losses/total_loss", 2, 0.125) in port
    [(tag, step, text)] = [e for e in port if e[0].startswith("samples")]
    assert step == 2 and text == [trackers.rows_to_markdown(*TABLES["escapes"])]


def test_missing_wandb_falls_back_to_jsonl_as_jax(tmp_path, lib_caplog, monkeypatch):
    from trlx_tpu.data.default_configs import default_ppo_config as jax_default_ppo_config
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    assert "wandb" not in sys.modules or sys.modules["wandb"] is None
    paths = []
    for name, module, config in (("port", trackers, default_ppo_config()),
                                 ("jax", jax_trackers, jax_default_ppo_config())):
        config.train.tracker = "wandb"
        config.train.run_name = "fb"
        config.train.logging_dir = str(tmp_path / name)
        with lib_caplog.at_level(py_logging.WARNING):
            tracker = module.make_tracker(config.train, config.to_dict())
        assert isinstance(tracker, module.JsonlTracker)
        tracker.log({"x": 1.0, "y": "skipped"}, step=0)
        tracker.log_table("samples", ["a"], [["b"]], step=0)
        tracker.finish()
        tracker.finish()  # idempotent on a closed file
        paths.append(tmp_path / name / "fb.jsonl")
    warnings = [r.getMessage() for r in lib_caplog.records if "falling back to jsonl" in r.getMessage()]
    assert len(warnings) == 2 and warnings[0].split("(")[0] == warnings[1].split("(")[0]

    def records(path):
        with open(path) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "_time"} for line in f]

    port, ref = (records(p) for p in paths)
    assert port[1:] == ref[1:]
    assert port[1] == {"step": 0, "x": 1.0}
    with pytest.raises(ModuleNotFoundError, match="wandb"):
        trackers.WandbTracker("p", None, None, "n", [], {})


def test_tracker_none_and_unknown_tracker_as_jax(tmp_path):
    from trlx_tpu.data.default_configs import default_ppo_config as jax_default_ppo_config
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    for module, config in ((trackers, default_ppo_config()), (jax_trackers, jax_default_ppo_config())):
        config.train.logging_dir = str(tmp_path)
        config.train.tracker = None
        assert type(module.make_tracker(config.train, {})) is module.BaseTracker
        config.train.tracker = "nope"
        with pytest.raises(ValueError, match="Unknown tracker 'nope'"):
            module.make_tracker(config.train, {})


def test_ppo_trainer_logs_to_tensorboard(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig

    config = TRLConfig.from_dict(dict(
        method=dict(name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1,
                    gen_kwargs=dict(max_new_tokens=4, do_sample=False)),
        train=dict(seq_length=16, epochs=2, total_steps=2, batch_size=4, checkpoint_interval=100,
                   eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"), pipeline="PromptPipeline",
                   trainer="PPOTrainer", tracker="tensorboard", run_name="tb", seed=1, save_best=False),
        model=dict(model_path="gpt2", num_layers_unfrozen=-1, model_overrides=dict(
            vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=64)),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    ))
    trainer = trlx_tpu_torch.train(reward_fn=lambda samples, **kw: [float(len(s)) for s in samples],
                                   prompts=["ab", "cd", "ef", "gh"] * 2, config=config, device="cpu")
    assert isinstance(trainer.tracker, trackers.TensorboardTracker)
    trainer.tracker.finish()
    events = _events(str(tmp_path / "ckpts" / "logs" / "tb"))
    assert sorted(step for tag, step, _ in events if tag == "losses/total_loss") == [1, 2]
    assert any(tag.startswith("samples") for tag, _, _ in events)  # the eval table, as text
