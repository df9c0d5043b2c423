#!/usr/bin/env python3
"""The RFT randomwalks recipe (``examples/randomwalks/rft_randomwalks.py``)
run by the PyTorch port alone: the SFT warm start on sampled walks (the
PPO recipe's ``pretrain_on_walks``), HF-format export, then rejection
fine-tuning from the export: 32 sampled generations per prompt, the top
percentile band (0.9 -> 0.95, one improve step per epoch) kept, SFT on the
survivors, with the example's config rebuilt on ``trlx_tpu_torch``'s
``TRLConfig``. The epoch budget is raised from the example's 20 to 1000:
an RFT epoch is one step here, and the bar is read at ``--rft-steps``.

Usage (on a CUDA host; ``--device cpu`` runs the plain CPU path)::

    python3 scripts/torch_rft_randomwalks.py [--pretrain-steps 300] [--rft-steps 100] [--device cpu]

Prints one JSON line: the eval ``reward/mean`` curve (sampled decoding,
every 10 steps), the SFT stage's losses, the seconds of each stage, and
whether the final eval reached ``reward/mean`` >= 0.9 and its own step-0
value. The bar is the JAX package's CPU run of the example at this cut
(300 SFT steps, 100 RFT steps, eval every 10): 0.313@0, 0.95@10, 0.65@20,
1.0@30, 0.95@40, 1.0@50, 0.931@60, 0.95@70, 0.95@80, 1.0@90, 1.0@100; its
final 1.0 less 0.1. Exits 1 when it did not.

The walks come from ``examples/randomwalks/randomwalks.py`` (numpy only);
nothing of the JAX package is imported.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scripts.torch_ppo_randomwalks import default_config as ppo_default_config  # noqa: E402
from scripts.torch_ppo_randomwalks import pretrain_on_walks, recording  # noqa: E402

#: the bar: the final eval's reward/mean (and no lower than the run's step 0)
GATE_REWARD = 0.9
#: the JAX package's CPU run of the example at this cut (step, reward/mean)
JAX_CURVE = [(0, 0.313), (10, 0.95), (20, 0.65), (30, 1.0), (40, 0.95), (50, 1.0), (60, 0.931), (70, 0.95),
             (80, 0.95), (90, 1.0), (100, 1.0)]

#: the gate's own settings on top of the example's ``build_config``: the RFT
#: step budget, an epoch budget that reaches it, eval every 10 steps, no
#: tracker, a temporary dir
GATE_OVERRIDES = ("train.epochs", "train.total_steps", "train.eval_interval", "train.tracker",
                  "train.checkpoint_dir")


def build_config(alphabet: str):
    """The example's ``build_config``: the PPO recipe's config with the RFT
    method and trainer."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.methods.rft import RFTConfig

    d = ppo_default_config(alphabet).to_dict()
    d["method"] = RFTConfig(
        n_generations_per_prompt=32,
        start_percentile=0.9,
        end_percentile=0.95,
        n_improve_steps=1,
        gen_kwargs=dict(max_new_tokens=9, top_k=0, top_p=1.0, temperature=1.0, do_sample=True),
    ).to_dict()
    d["train"].update(trainer="RFTTrainer", checkpoint_dir="ckpts/randomwalks_rft")
    return TRLConfig.from_dict(d)


def gate_config(alphabet: str, out_dir: str, rft_steps: int):
    """The RFT stage's config: the example's, with :data:`GATE_OVERRIDES`."""
    config = build_config(alphabet)
    config.train.epochs = 1000
    config.train.total_steps = rft_steps
    config.train.eval_interval = 10
    config.train.tracker = None
    config.train.checkpoint_dir = out_dir
    return config


def run_gate(pretrain_steps=300, rft_steps=100, device=None):
    """SFT ``pretrain_steps``, export, RFT ``rft_steps`` from the export, in
    a temporary directory. Returns the report dict (``ok``: the bar was met)."""
    import trlx_tpu_torch
    from examples.randomwalks import generate_random_walks
    from trlx_tpu_torch.trainer.mesh_trainer import MeshRLTrainer

    metric_fn, prompts, sample_walks, _, alphabet = generate_random_walks(seed=1000)
    out_dir = tempfile.mkdtemp(prefix="randomwalks_rft_")
    config = gate_config(alphabet, out_dir, rft_steps)
    report = {"pretrain_steps": pretrain_steps, "rft_steps": rft_steps, "device": device or "cuda"}
    try:
        config.model.model_path = pretrain_on_walks(config, sample_walks, out_dir, pretrain_steps, device, report)
        config.model.model_overrides = None
        t0 = time.perf_counter()
        with recording(MeshRLTrainer, "evaluate", []) as evals:
            rft = trlx_tpu_torch.train(
                reward_fn=lambda samples, **kwargs: metric_fn(samples)["optimality"],
                prompts=prompts, eval_prompts=prompts,
                metric_fn=lambda samples, **kwargs: metric_fn(samples),
                config=config, device=device,
            )
        report.update(rft_seconds=time.perf_counter() - t0, rft_final_step=rft.iter_count)
        del rft
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    curve = [(step, stats["reward/mean"]) for step, stats in evals]
    final = curve[-1] if curve and curve[-1][0] >= rft_steps else None
    report.update(eval_curve=curve, jax_curve=JAX_CURVE, gate={"step": rft_steps, "min_reward": GATE_REWARD},
                  gate_eval=final,
                  ok=final is not None and final[1] >= GATE_REWARD and final[1] >= curve[0][1])
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pretrain-steps", type=int, default=300)
    ap.add_argument("--rft-steps", type=int, default=100)
    ap.add_argument("--device", default=None, help="default: the CUDA device (raises without one)")
    args = ap.parse_args(argv)
    report = run_gate(args.pretrain_steps, args.rft_steps, args.device)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
