#!/usr/bin/env python3
"""The ILQL randomwalks gate's recipe (``scripts/torch_ilql_randomwalks.py``:
the example's config, eval decoding at top_k=1) in both packages on the CPU,
the port starting from the JAX trainer's initial weights (carried by
``policy_params_from_jax``), so that the two eval optimality curves (an
eval every 16 steps, the example's interval) can be laid side by side.
Like the parity tests, and unlike the port's own scripts, it imports both
packages; it runs on the CPU only.

Usage::

    JAX_PLATFORMS=cpu python scripts/ilql_randomwalks_crosscheck.py [--steps 512] [--seed 1000]
        [--which both|jax|port]

Prints one JSON line: ``{"seed": ..., "jax": [[step, optimality], ...],
"port_from_jax_init": [...], "seconds": {...}}``. ``--which jax`` runs the
reference alone (another seed's reference curve). The example's 100 epochs
of 10 steps end a run at step 1000 whatever ``--steps`` says above it.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(trainer, pipeline_cls, walks, rewards, eval_prompts, metric_fn):
    """learn() with the walks as experience; returns ([(step, optimality)], seconds)."""
    trainer.metric_fn = lambda samples, **kw: metric_fn(samples)
    trainer.make_experience(walks, rewards, trainer.config.train.seq_length)
    max_prompt = trainer.config.train.seq_length - trainer.config.method.gen_kwargs["max_new_tokens"]
    trainer.add_eval_pipeline(pipeline_cls(eval_prompts, max_prompt, trainer.tokenizer))
    curve, evaluate = [], trainer.evaluate

    def recorded():
        stats = evaluate()
        curve.append((trainer.iter_count, stats["metrics/optimality"]))
        return stats

    trainer.evaluate = recorded
    t0 = time.perf_counter()
    trainer.learn()
    return curve, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--which", choices=("both", "jax", "port"), default="both")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    import trlx_tpu.methods  # noqa: F401  (registers ILQLConfig)
    from examples.randomwalks import generate_random_walks
    from examples.randomwalks.ilql_randomwalks import default_config as jax_default_config
    from scripts.torch_ilql_randomwalks import gate_config, logit_mask
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer
    from trlx_tpu_torch.models.convert import policy_params_from_jax
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    metric_fn, eval_prompts, walks, adjacency, alphabet = generate_random_walks(seed=1002)
    rewards = metric_fn(walks)["optimality"]
    mask = logit_mask(adjacency, alphabet).tolist()
    out = tempfile.mkdtemp(prefix="ilql_crosscheck_")
    port_cfg = gate_config(alphabet, out + "/port", args.steps, args.seed)
    port_cfg.train.eval_interval = 16  # the example's, as the JAX run below
    jax_cfg = JaxConfig.update(jax_default_config(alphabet).to_dict(), {
        "method.gen_kwargs": port_cfg.method.gen_kwargs, "train.total_steps": args.steps,
        "train.seed": args.seed, "train.tracker": None, "train.checkpoint_dir": out + "/jax"})
    jt = jax_get_trainer("ILQLTrainer")(config=jax_cfg, logit_mask=mask)
    report = {"seed": args.seed, "steps": args.steps, "seconds": {}}
    if args.which in ("both", "port"):
        pt = get_trainer("ILQLTrainer")(config=port_cfg, logit_mask=mask, device="cpu")
        pt.model.load_state_dict(policy_params_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.params)),
                                                        pt.model_config))
        report["port_from_jax_init"], report["seconds"]["port"] = run(
            pt, PromptPipeline, walks, rewards, eval_prompts, metric_fn)
    if args.which in ("both", "jax"):
        report["jax"], report["seconds"]["jax"] = run(jt, JaxPipeline, walks, rewards, eval_prompts, metric_fn)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
