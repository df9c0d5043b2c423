"""Port parity for the sweep hooks of ``MeshRLTrainer.learn``: under
``TRLX_SWEEP=1`` both packages' PPO trainers (tiny f32 config, char
tokenizer, greedy, 2 optimizer steps with an eval after each) print the same
``SWEEP_METRIC`` lines (same keys, same step numbers) and one
``SWEEP_RESULT`` line with the same keys; with ``TRLX_SWEEP_STOP_FILE``
pointing at an existing file both stop at the same step, after printing
the result line; without ``TRLX_SWEEP`` neither prints a sweep line."""

import json

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
