"""Port parity for the sweep hooks of ``MeshRLTrainer.learn``: under
``TRLX_SWEEP=1`` both packages' PPO trainers (tiny f32 config, char
tokenizer, greedy, 2 optimizer steps with an eval after each) print the same
``SWEEP_METRIC`` lines (same keys, same step numbers) and one
``SWEEP_RESULT`` line with the same keys; with ``TRLX_SWEEP_STOP_FILE``
pointing at an existing file both stop at the same step, after printing
the result line; without ``TRLX_SWEEP`` neither prints a sweep line.

The sweep runner and the comparison harness: ``trlx_tpu_torch.sweep``
draws the JAX runner's trials (grid and random, same seed) and, over a
fake trial script, records the same ASHA decisions and trial records;
``trlx_tpu_torch.reference.diff`` prints the JAX harness's line for the
same two records; and ``scripts/torch_ppo_randomwalks.py``'s hparams
argument changes the config as the JAX example's ``main`` does."""

import json
from concurrent.futures import ThreadPoolExecutor

import pytest

import jax

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c"]


def reward_fn(samples, **kw):
    return [float(s.count("a")) for s in samples]


def _config_dict(tmp_path):
    return dict(
        method=dict(
            name="PPOConfig", num_rollouts=4, chunk_size=2, ppo_epochs=1, init_kl_coef=0.01,
            target=None, gen_kwargs=dict(max_new_tokens=4, do_sample=False),
        ),
        train=dict(
            seq_length=16, epochs=4, total_steps=2, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=1, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False,
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=-1,
            model_overrides=dict(
                vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=64,
            ),
        ),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=1e-3)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=100, eta_min=1e-3)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )


@pytest.fixture
def single_device_mesh(monkeypatch):
    """Pin JAX trainer meshes to the first of conftest's 8 virtual CPU devices."""
    from trlx_tpu.parallel import mesh as mesh_lib

    real = mesh_lib.make_mesh
    monkeypatch.setattr(
        mesh_lib, "mesh_from_config",
        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]),
    )


def _learn_jax(tmp_path):
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu.utils.loading import get_trainer

    trainer = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path)), reward_fn=reward_fn)
    trainer.add_prompt_pipeline(PromptPipeline(PROMPTS, 12, trainer.tokenizer))
    trainer.add_eval_pipeline(PromptPipeline(PROMPTS[:2], 12, trainer.tokenizer))
    trainer.learn()
    return trainer


def _learn_port(tmp_path):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    trainer = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(_config_dict(tmp_path)), reward_fn=reward_fn,
                                        device="cpu")
    trainer.add_prompt_pipeline(PromptPipeline(PROMPTS, 12, trainer.tokenizer))
    trainer.add_eval_pipeline(PromptPipeline(PROMPTS[:2], 12, trainer.tokenizer))
    trainer.learn()
    return trainer


def _sweep_lines(out):
    """(metric lines, result lines) printed under TRLX_SWEEP, as dicts."""
    metrics, results = [], []
    for line in out.splitlines():
        if line.startswith("SWEEP_METRIC "):
            metrics.append(json.loads(line[len("SWEEP_METRIC "):]))
        elif line.startswith("SWEEP_RESULT "):
            results.append(json.loads(line[len("SWEEP_RESULT "):]))
    return metrics, results


def _run_both(tmp_path, capsys):
    jt = _learn_jax(tmp_path / "jax")
    jax_lines = _sweep_lines(capsys.readouterr().out)
    pt = _learn_port(tmp_path / "port")
    port_lines = _sweep_lines(capsys.readouterr().out)
    return (jt, jax_lines), (pt, port_lines)


def test_sweep_lines_match_jax(tmp_path, capsys, monkeypatch, single_device_mesh):
    monkeypatch.setenv("TRLX_SWEEP", "1")
    monkeypatch.delenv("TRLX_SWEEP_STOP_FILE", raising=False)
    (jt, (jm, jr)), (pt, (pm, pr)) = _run_both(tmp_path, capsys)
    assert [m["step"] for m in pm] == [m["step"] for m in jm] == [1, 2]
    assert [sorted(m) for m in pm] == [sorted(m) for m in jm]
    assert len(pr) == len(jr) == 1 and sorted(pr[0]) == sorted(jr[0])
    assert "reward/mean" in pr[0]
    assert pt.iter_count == jt.iter_count == 2


def test_sweep_stop_file_stops_both_at_the_same_step(tmp_path, capsys, monkeypatch, single_device_mesh):
    stop = tmp_path / "stop"
    stop.write_text("")
    monkeypatch.setenv("TRLX_SWEEP", "1")
    monkeypatch.setenv("TRLX_SWEEP_STOP_FILE", str(stop))
    (jt, (jm, jr)), (pt, (pm, pr)) = _run_both(tmp_path, capsys)
    assert pt.iter_count == jt.iter_count == 1
    assert [m["step"] for m in pm] == [m["step"] for m in jm] == [1]
    assert len(pr) == len(jr) == 1 and sorted(pr[0]) == sorted(jr[0])


def test_no_sweep_lines_without_the_env(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("TRLX_SWEEP", raising=False)
    _learn_port(tmp_path)
    assert _sweep_lines(capsys.readouterr().out) == ([], [])


# ------------------------------------------------------- the sweep runner

FAKE_TRIAL = """
import json, os, sys, time
hp = json.loads(sys.argv[1])
stop = os.environ.get("TRLX_SWEEP_STOP_FILE")
last = 0.0
for step in range(1, 6):
    last = hp["method.q"] * step
    print("SWEEP_METRIC " + json.dumps({"step": step, "reward/mean": last}), flush=True)
    time.sleep(0.05)
    if stop and os.path.exists(stop):
        break
print("SWEEP_RESULT " + json.dumps({"reward/mean": last}), flush=True)
"""

GRID = {
    "tune_config": {"search_alg": "grid"},
    "train.seed": {"strategy": "choice", "values": [1, 2]},
    "method.gamma": {"strategy": "choice", "values": [0.9, 0.99]},
}
RANDOM = {
    "tune_config": {"search_alg": "random", "num_samples": 16},
    "method.init_kl_coef": {"strategy": "loguniform", "values": [1e-4, 1e-1]},
    "optimizer.kwargs.lr": {"strategy": "uniform", "values": [1e-5, 1e-3]},
    "train.seed": {"strategy": "int", "values": [0, 100]},
    "train.batch_size": {"strategy": "choice", "values": [8, 16]},
}


@pytest.mark.parametrize("sweep_config", [GRID, RANDOM], ids=["grid", "random"])
def test_generate_trials_as_jax(sweep_config):
    from trlx_tpu.sweep import generate_trials as jax_generate
    from trlx_tpu_torch.sweep import generate_trials

    for seed in (0, 1):
        assert generate_trials(sweep_config, seed) == jax_generate(sweep_config, seed)


def test_asha_run_records_as_jax(tmp_path):
    """Sequential ASHA over the fake trial: the same early stops, reports,
    metrics and return codes as the JAX runner (seconds aside), and both
    reports name the stopped trials."""
    from trlx_tpu import sweep as jsweep
    from trlx_tpu_torch import sweep as tsweep

    script = tmp_path / "fake_trial.py"
    script.write_text(FAKE_TRIAL)
    trials = [{"method.q": 2.0}, {"method.q": 1.0}, {"method.q": 0.1}]
    records = []
    for name, mod in (("jax", jsweep), ("port", tsweep)):
        sched = mod.AshaScheduler("reward/mean", "max", grace_steps=1, eta=2)
        out = str(tmp_path / f"{name}.jsonl")
        with ThreadPoolExecutor(max_workers=1) as pool:  # the trial subprocesses get 60 s in all
            got = pool.submit(mod.run_trials, str(script), trials, out, "reward/mean", "max", max_concurrent=1,
                              scheduler=sched, report_path=str(tmp_path / f"{name}.md"),
                              extra_env={"JAX_PLATFORMS": "cpu"}).result(timeout=60)
        with open(out) as f:
            assert [json.loads(line) for line in f] == got
        records.append([{k: v for k, v in r.items() if k != "seconds"} for r in got])
        assert "early-stopped" in (tmp_path / f"{name}.md").read_text()
    assert records[1] == records[0]
    assert [r["early_stopped"] for r in records[1]] == [False, True, True]


def test_harness_diff_prints_the_jax_line(tmp_path, capsys):
    from trlx_tpu import reference as jref
    from trlx_tpu_torch import reference as tref

    paths = []
    for i, value in enumerate((0.85, 0.95)):
        path = tmp_path / f"rw_{i}.json"
        path.write_text(json.dumps({"rev": "HEAD", "tree_hash": f"{i}" * 40, "seconds": 1.0, "returncode": 0,
                                    "metrics": {"metric": "reward/mean@gate", "value": value}}))
        paths.append(str(path))
    jref.diff(*paths)
    want = capsys.readouterr().out
    assert tref.diff(*paths) + "\n" == capsys.readouterr().out == want
    assert want.startswith("reward/mean@gate: 0.85 (00000000) -> 0.95 (11111111)  x1.118")
    report = {"gate_eval": [100, 0.9], "ok": True, "sft_seconds": 1.0, "ppo_seconds": 2.0}
    assert tref.metrics_of(report)["value"] == 0.9 and tref.metrics_of({})["value"] is None


def test_randomwalks_hparams_merge_as_the_jax_example():
    """The trial contract of scripts/torch_ppo_randomwalks.py: the hparams
    JSON changes exactly the fields the JAX example's main changes."""
    import os
    import sys

    from examples.randomwalks import generate_random_walks
    from examples.randomwalks.ppo_randomwalks import default_config as jax_default
    from trlx_tpu.data.configs import TRLConfig as JaxConfig

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
    try:
        import torch_ppo_randomwalks as rw
    finally:
        sys.path.pop(0)
    *_, alphabet = generate_random_walks(seed=1002)
    hparams = {"method.init_kl_coef": 0.05, "optimizer.kwargs.lr": 2e-4, "train.seed": 1001,
               "train.total_steps": 7, "pretrain_steps": 11, "pretrain_lr": 5e-4, "device": "cpu"}
    config, steps, lr, device = rw.config_from_hparams(hparams, alphabet)
    assert (steps, lr, device) == (11, 5e-4, "cpu")
    base = rw.default_config(alphabet)
    jax_cfg = JaxConfig.update(jax_default(alphabet).to_dict(), {k: v for k, v in hparams.items()
                                                                 if k not in ("pretrain_steps", "pretrain_lr",
                                                                              "device")})
    for dotted in ("method.init_kl_coef", "optimizer.kwargs.lr", "train.seed", "train.total_steps"):
        section, *rest = dotted.split(".")
        got, want = getattr(config, section), getattr(jax_cfg, section)
        for key in rest:
            got, want = (got[key], want[key]) if isinstance(got, dict) else (getattr(got, key), getattr(want, key))
        assert got == want == hparams[dotted]
    assert config.method.gamma == base.method.gamma and config.train.batch_size == base.train.batch_size
    assert rw.config_from_hparams({}, alphabet)[1:] == (300, 1e-3, None)
