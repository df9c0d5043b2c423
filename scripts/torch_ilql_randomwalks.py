#!/usr/bin/env python3
"""The ILQL randomwalks recipe (``examples/randomwalks/ilql_randomwalks.py``)
run by the PyTorch port alone: offline ILQL on the sampled walks labelled
with their path-optimality, the example's next-token ``logit_mask``, and
advantage-shaped evaluation, with the example's config rebuilt on
``trlx_tpu_torch``'s ``TRLConfig`` and eval decoding at ``top_k=1`` (as the
JAX package's recorded run).

Usage (on a CUDA host; ``--device cpu`` runs the plain CPU path)::

    python3 scripts/torch_ilql_randomwalks.py [--steps 1000] [--seed 1000] [--device cpu]

Prints one JSON line: the eval optimality curve (``metrics/optimality``,
every 100 steps), the seconds, and whether the final eval, at the end of
the example's budget of 1000 steps, reached optimality >= 0.6. Exits 1 when
it did not (or when training stopped early).

The bar is read at the end of the budget, not at step 500: from one seed,
the eval at step 500 is a draw from a wide spread in the JAX package
itself. Its runs of this recipe on the CPU
(``scripts/ilql_randomwalks_crosscheck.py --which jax --steps 1024``, seeds
1000-1004) read 0.791, 0.843, 0.526, 0.622 and 0.505 at step 512, two of
five below 0.6, and 0.795, 0.780, 0.665, 0.654 and 0.737 at step 992, all
above it. The port from the JAX package's initial weights repeats the JAX
curve (0.7909 both at step 512, seed 1000).

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

from scripts.torch_ppo_randomwalks import recording  # noqa: E402

#: the bar: eval optimality at the final eval (the example's 1000 steps)
GATE_OPTIMALITY = 0.6
#: the JAX package's CPU run of this recipe, seed 1000 (step, optimality)
JAX_CURVE = [(0, 0.0), (128, 0.15), (256, 0.204), (384, 0.666), (512, 0.791), (768, 0.799), (992, 0.795)]

#: the gate's own settings on top of the example's ``default_config``: eval
#: decoding at top_k=1, an eval every 100 steps, no tracker, a temporary dir
GATE_OVERRIDES = ("method.gen_kwargs", "train.eval_interval", "train.tracker", "train.checkpoint_dir")


def default_config(alphabet: str):
    """The example's ``default_config`` (``default_ilql_config`` evolved) on
    the port's TRLConfig."""
    from trlx_tpu_torch.data.default_configs import default_ilql_config

    config = default_ilql_config().evolve(
        train={
            "seq_length": 10, "batch_size": 100, "epochs": 100, "total_steps": 1000,
            "checkpoint_interval": 100000, "eval_interval": 16,
            "checkpoint_dir": "ckpts/randomwalks_ilql", "tracker": "jsonl",
        },
        method={"gen_kwargs": {"max_new_tokens": 9, "top_k": 10, "beta": 100.0, "temperature": 1.0}},
    )
    config.model.model_path = "gpt2"
    config.model.model_overrides = dict(
        vocab_size=len(alphabet) + 3, hidden_size=144, num_layers=6, num_heads=12,
        intermediate_size=512, max_position_embeddings=32,
    )
    config.tokenizer.tokenizer_path = f"char://{alphabet}"
    return config


def gate_config(alphabet: str, out_dir: str, steps: int = 1000, seed: int = 1000):
    """The gate's config: the example's, with :data:`GATE_OVERRIDES` (and
    ``train.total_steps`` and ``train.seed``, the example's 1000 and 1000 by
    default)."""
    config = default_config(alphabet)
    config.train.seed = seed
    config.method.gen_kwargs = {**config.method.gen_kwargs, "top_k": 1}
    config.train.total_steps = steps
    config.train.eval_interval = 100
    config.train.tracker = None
    config.train.checkpoint_dir = out_dir
    return config


def logit_mask(adjacency, alphabet: str):
    """The example's vocab-sized next-token mask: char ids are offset by the
    3 specials, which may follow anything; after a special any node."""
    import numpy as np

    V = len(alphabet) + 3
    mask = np.zeros((V, V), bool)
    mask[:, :3] = True
    mask[3:, 3:] = np.asarray(adjacency, bool)
    mask[:3, 3:] = True
    return mask


def run_gate(steps=1000, device=None, seed=1000):
    """ILQL ``steps`` steps on the walks in a temporary directory. Returns
    the report dict (``ok``: the bar was met)."""
    import trlx_tpu_torch
    from examples.randomwalks import generate_random_walks
    from trlx_tpu_torch.trainer.mesh_trainer import MeshRLTrainer

    metric_fn, eval_prompts, walks, adjacency, alphabet = generate_random_walks(seed=1002)
    rewards = metric_fn(walks)["optimality"]
    out_dir = tempfile.mkdtemp(prefix="randomwalks_ilql_")
    config = gate_config(alphabet, out_dir, steps, seed)
    config.train.trainer_kwargs["logit_mask"] = logit_mask(adjacency, alphabet).tolist()
    report = {"steps": steps, "seed": seed, "device": device or "cuda"}
    try:
        t0 = time.perf_counter()
        with recording(MeshRLTrainer, "evaluate", []) as evals:
            trainer = trlx_tpu_torch.train(
                samples=walks, rewards=rewards, eval_prompts=eval_prompts,
                metric_fn=lambda samples, **kw: metric_fn(samples), config=config, device=device,
            )
        report.update(seconds=time.perf_counter() - t0, final_step=trainer.iter_count)
        del trainer
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    curve = [(step, stats["metrics/optimality"]) for step, stats in evals]
    final = curve[-1] if curve and curve[-1][0] >= steps else None
    report.update(eval_curve=curve, jax_curve=JAX_CURVE, gate={"step": steps, "min_optimality": GATE_OPTIMALITY},
                  gate_eval=final, ok=final is not None and final[1] >= GATE_OPTIMALITY)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1000, help="train.seed (the example's 1000)")
    ap.add_argument("--device", default=None, help="default: the CUDA device (raises without one)")
    args = ap.parse_args(argv)
    report = run_gate(args.steps, args.device, args.seed)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
