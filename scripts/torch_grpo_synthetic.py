#!/usr/bin/env python3
"""The GRPO synthetic recipe (``examples/grpo_synthetic.py``) run by the
PyTorch port alone: the example's ``build_config`` (char tokenizer, hidden
64, 2 layers, groups of 4, eval every 20) rebuilt on ``trlx_tpu_torch``'s
``TRLConfig``, trained through ``trlx_tpu_torch.train(environment=
SyntheticEnvironment(...))``: the reward of a completion is the share of
its tokens equal to the target token ('a'), so learning shows as a rising
eval ``reward/mean``.

Usage (on a CUDA host; ``--device cpu`` runs the plain CPU path)::

    python3 scripts/torch_grpo_synthetic.py [--seed 1 2 3] [--steps 200] [--device cpu]

Prints one JSON line: each seed's eval ``reward/mean`` curve (sampled
decoding, every 20 steps), the seconds, and the gate. The gate reads more
evidence than the example's own eval (4 samples, where one 'a' moves the
mean by about 0.03, and 40 steps, over which the JAX package's runs rise by
less than that noise): 200 steps, 64 eval samples (:data:`EVAL_PROMPTS`),
three seeds, and each run's late reward, the mean of its last three evals.
Over the seeds it holds the mean late reward to the JAX package's (the CPU
runs of ``scripts/grpo_synthetic_crosscheck.py --which jax``,
:data:`JAX_CURVES`) less :data:`LATE_MARGIN`, the mean rise over step 0 to
at least half of JAX's, and every run's late reward to above its own step
0. Exits 1 when one fails. The model's head dim is 32 and its
``attention_impl`` the preset's ``"xla"``: no kernel runs on this path.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scripts.torch_ppo_randomwalks import recording  # noqa: E402

ALPHABET = "abcdefgh "
GROUP_SIZE = 4
PROMPTS = ["ab c", "cd e", "ef g", "gh a", "a bc", "b cd", "c de", "d ef"]
#: the gate's eval set: 8 samples of each training prompt
EVAL_PROMPTS = PROMPTS * 8
SEEDS, STEPS = (1, 2, 3), 200
#: the JAX package's CPU runs of this recipe (``scripts/grpo_synthetic_crosscheck.py
#: --which jax --seed S``): eval reward/mean at steps 0, 20, ..., 200
JAX_CURVES = {
    1: [
        0.07464657738095237, 0.15844494047619045, 0.15790550595238095, 0.20572916666666663,
        0.22447916666666667, 0.19895833333333335, 0.296484375, 0.3639508928571428,
        0.28776041666666663, 0.2622767857142857, 0.30334821428571423,
    ],
    2: [
        0.10027901785714285, 0.11930803571428569, 0.14507068452380953, 0.21802455357142858,
        0.2388578869047619, 0.2681733630952381, 0.31826636904761907, 0.3010602678571428,
        0.31566220238095233, 0.2726934523809524, 0.34577752976190473,
    ],
    3: [
        0.10186011904761905, 0.12100074404761904, 0.1476376488095238, 0.13547247023809522,
        0.2139880952380952, 0.1837983630952381, 0.22501860119047618, 0.255375744047619,
        0.2578869047619048, 0.17953869047619048, 0.21569940476190474,
    ],
}
#: how far the port's mean late reward may fall below JAX's: the JAX runs'
#: late rewards spread by about 0.04 a seed (0.02 for a mean of three), and a
#: learner that does not learn reads about 0.10, 0.17 below JAX
LATE_MARGIN = 0.07
#: the evals a run's late reward averages
LATE_EVALS = 3


def late_reward(rewards):
    """A run's late reward: the mean of its last :data:`LATE_EVALS` evals."""
    return float(np.mean(rewards[-LATE_EVALS:]))


def gate(curves):
    """The gate over the runs' eval ``reward/mean`` lists (step 0 first):
    the bars from :data:`JAX_CURVES`, each run's late reward and rise, and
    ``ok``."""
    jax_late = float(np.mean([late_reward(c) for c in JAX_CURVES.values()]))
    jax_rise = float(np.mean([late_reward(c) - c[0] for c in JAX_CURVES.values()]))
    late = [late_reward(c) for c in curves]
    rise = [late_reward(c) - c[0] for c in curves]
    checks = {
        "mean late reward >= JAX's less the margin": float(np.mean(late)) >= jax_late - LATE_MARGIN,
        "mean rise over step 0 >= half of JAX's": float(np.mean(rise)) >= jax_rise / 2,
        "every run's late reward above its step 0": all(r > 0 for r in rise),
    }
    return {"late_reward": late, "rise": rise, "mean_late_reward": float(np.mean(late)),
            "mean_rise": float(np.mean(rise)), "bar_late_reward": jax_late - LATE_MARGIN,
            "bar_rise": jax_rise / 2, "jax_late_reward": jax_late, "jax_rise": jax_rise,
            "checks": checks, "ok": all(checks.values())}


def build_config():
    """The example's ``build_config``: ``default_grpo_config()`` cut to a
    char-level model of 2 layers, 8 sampled tokens, groups of 4."""
    from trlx_tpu_torch.data.default_configs import default_grpo_config

    return default_grpo_config().evolve(
        train={
            "seq_length": 48, "batch_size": 8, "minibatch_size": 4, "total_steps": 40, "epochs": 10,
            "checkpoint_interval": 1000, "eval_interval": 20, "checkpoint_dir": "ckpts/grpo_synthetic",
            "tracker": "jsonl", "seed": 1,
        },
        method={
            "num_rollouts": 32, "chunk_size": 8, "group_size": GROUP_SIZE,
            "gen_kwargs": {"max_new_tokens": 8, "top_k": 0, "top_p": 1.0, "do_sample": True},
        },
        model={
            "model_path": "gpt2",
            "model_overrides": dict(vocab_size=len(ALPHABET) + 3, hidden_size=64, num_layers=2, num_heads=2,
                                    intermediate_size=256, max_position_embeddings=64),
        },
        tokenizer={"tokenizer_path": f"char://{ALPHABET}"},
        mesh={"data": 1, "fsdp": 1, "model": 1, "compute_dtype": "float32"},
    )


def environment():
    """The example's environment: reward = share of 'a' (char id 3)."""
    from trlx_tpu_torch.online import SyntheticEnvironment

    return SyntheticEnvironment(vocab_size=len(ALPHABET) + 3, prompt_len=4, target_token=3, max_turns=1, seed=7)


def gate_config(out_dir: str, seed: int, steps: int):
    """The example's config with the seed, the step budget (an epoch budget
    that reaches it), no tracker and a temporary directory."""
    config = build_config()
    config.train.seed = seed
    config.train.total_steps = steps
    config.train.epochs = max(config.train.epochs, steps)
    config.train.tracker = None
    config.train.checkpoint_dir = out_dir
    return config


def run_seed(seed, steps, device=None):
    """The example's GRPO run for one seed in a temporary directory, the
    eval on :data:`EVAL_PROMPTS`. Returns (curve [(step, reward/mean)],
    report dict)."""
    import trlx_tpu_torch
    from trlx_tpu_torch.trainer.mesh_trainer import MeshRLTrainer

    out_dir = tempfile.mkdtemp(prefix="grpo_synthetic_")
    t0 = time.perf_counter()
    try:
        with recording(MeshRLTrainer, "evaluate", []) as evals:
            trainer = trlx_tpu_torch.train(environment=environment(), prompts=PROMPTS, eval_prompts=EVAL_PROMPTS,
                                           config=gate_config(out_dir, seed, steps), device=device)
        report = dict(seconds=time.perf_counter() - t0, final_step=trainer.iter_count,
                      attention_impl=trainer.model_config.attention_impl,
                      head_dim=trainer.model_config.hidden_size // trainer.model_config.num_heads)
        del trainer
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return [(step, stats["reward/mean"]) for step, stats in evals], report


def run_gate(seeds=SEEDS, steps=STEPS, device=None):
    """The example's GRPO run for each seed. Returns the report dict (``ok``:
    every run reached ``steps`` and the gate held)."""
    runs = {seed: run_seed(seed, steps, device) for seed in seeds}
    curves = {seed: curve for seed, (curve, _) in runs.items()}
    report = {"seeds": list(seeds), "steps": steps, "device": device or "cuda", "eval_samples": len(EVAL_PROMPTS),
              "runs": {seed: r for seed, (_, r) in runs.items()}, "eval_curves": curves}
    report.update(gate=gate([[r for _, r in c] for c in curves.values()]))
    finished = all(c and c[-1][0] >= steps for c in curves.values())
    report.update(ok=finished and report["gate"]["ok"])
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None, help="default: the CUDA device (raises without one)")
    args = ap.parse_args(argv)
    report = run_gate(args.seed, args.steps, args.device)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
