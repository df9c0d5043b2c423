#!/usr/bin/env python3
"""The GRPO synthetic recipe (``examples/grpo_synthetic.py``'s
``build_config`` and environment, ``train(environment=...)``, with the
step budget and eval set of ``scripts/torch_grpo_synthetic.py``'s gate) in
both packages on the CPU, the port starting from the JAX trainer's initial
weights (carried by ``policy_params_from_jax``), so that the two eval
``reward/mean`` curves (every 20 steps) can be laid side by side. Like the
parity tests, and unlike the port's own scripts, it imports both packages;
it runs on the CPU only.

Usage::

    JAX_PLATFORMS=cpu python scripts/grpo_synthetic_crosscheck.py [--seed 1] [--steps 200]
        [--which both|jax|port]

Prints one JSON line: ``{"seed": ..., "jax": [[step, reward_mean], ...],
"port_from_jax_init": [...], "seconds": {...}}``. ``--which jax`` runs the
reference alone: the source of ``scripts/torch_grpo_synthetic.py``'s
``JAX_CURVES``.
Sampled rollouts differ between the packages (their random streams
differ), so the curves agree in trend, not step for step.
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


def run(train, trainer_cls, **kwargs):
    """``train(**kwargs)`` with ``trainer_cls.evaluate`` recorded; returns
    ([(step, reward/mean)], seconds)."""
    curve, evaluate = [], trainer_cls.evaluate

    def recorded(self):
        stats = evaluate(self)
        curve.append((self.iter_count, stats["reward/mean"]))
        return stats

    trainer_cls.evaluate = recorded
    t0 = time.perf_counter()
    try:
        train(**kwargs)
    finally:
        trainer_cls.evaluate = evaluate
    return curve, time.perf_counter() - t0


def main(argv=None) -> int:
    from scripts.torch_grpo_synthetic import STEPS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--which", choices=("both", "jax", "port"), default="both")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    import trlx_tpu
    import trlx_tpu_torch
    from examples.grpo_synthetic import build_config as jax_build_config
    from scripts.torch_grpo_synthetic import EVAL_PROMPTS, PROMPTS, environment, gate_config
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.online import SyntheticEnvironment as JaxEnvironment
    from trlx_tpu.trainer.grpo_trainer import GRPOTrainer as JaxGRPOTrainer
    from trlx_tpu.trainer.mesh_trainer import MeshRLTrainer as JaxMeshRLTrainer
    from trlx_tpu_torch.models.convert import policy_params_from_jax
    from trlx_tpu_torch.models.policy import branch_param_subtree
    from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer
    from trlx_tpu_torch.trainer.mesh_trainer import MeshRLTrainer

    out = tempfile.mkdtemp(prefix="grpo_crosscheck_")
    jax_cfg = JaxConfig.update(jax_build_config().to_dict(), {
        "train.total_steps": args.steps, "train.epochs": max(jax_build_config().train.epochs, args.steps),
        "train.seed": args.seed, "train.tracker": None,
        "train.checkpoint_dir": out + "/jax"})
    report = {"seed": args.seed, "steps": args.steps, "seconds": {}}
    try:
        if args.which in ("both", "port"):
            init = {}
            if args.which == "both":  # the JAX trainer's initial weights
                jt = JaxGRPOTrainer(config=JaxConfig.update(jax_cfg.to_dict(), {}), reward_fn=lambda **kw: [])
                init = jax.tree.map(np.asarray, jax.device_get(jt.params))
                del jt
            setup = GRPOTrainer.setup_model

            def setup_from_jax(self):
                setup(self)
                if init:
                    self.model.load_state_dict(policy_params_from_jax(init, self.model_config))
                    trunk = self.model.transformer.state_dict()
                    if self.frozen_branch is not None:  # the default config's hydra reference
                        self.frozen_branch.load_state_dict(
                            branch_param_subtree(trunk, self.branch_start, self.model_config))
                    else:
                        self.ref_model.load_state_dict(trunk)

            GRPOTrainer.setup_model = setup_from_jax
            try:
                report["port_from_jax_init" if init else "port"], report["seconds"]["port"] = run(
                    trlx_tpu_torch.train, MeshRLTrainer, environment=environment(), prompts=PROMPTS,
                    eval_prompts=EVAL_PROMPTS, config=gate_config(out + "/port", args.seed, args.steps),
                    device="cpu")
            finally:
                GRPOTrainer.setup_model = setup
        if args.which in ("both", "jax"):
            env = JaxEnvironment(vocab_size=12, prompt_len=4, target_token=3, max_turns=1, seed=7)
            report["jax"], report["seconds"]["jax"] = run(
                trlx_tpu.train, JaxMeshRLTrainer, environment=env, prompts=PROMPTS, eval_prompts=EVAL_PROMPTS,
                config=jax_cfg)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
