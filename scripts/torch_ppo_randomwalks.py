#!/usr/bin/env python3
"""The randomwalks recipe (``examples/randomwalks/ppo_randomwalks.py``) run
by the PyTorch port alone: SFT warm start on sampled walks, HF-format
export, then PPO from the exported directory, with the example's config
rebuilt on ``trlx_tpu_torch``'s ``TRLConfig`` (f32 compute). PPO's epoch
budget is raised from the example's 20 to 100 so that it runs to
``--ppo-steps`` (20 epochs of 4 steps end at step 80).

Usage (on a CUDA host; ``--device cpu`` runs the plain CPU path)::

    python3 scripts/torch_ppo_randomwalks.py [--pretrain-steps 300] [--ppo-steps 120]
        [--num-layers-unfrozen 2] [--async-max-staleness 1] [--device cpu]
    python3 scripts/torch_ppo_randomwalks.py '{"method.init_kl_coef": 0.01, "pretrain_steps": 50}'

The second form is the sweep's trial contract (``python -m
trlx_tpu_torch.sweep scripts/torch_ppo_randomwalks.py --config ...``): a
JSON object of dotted hparams merged into the example's ``default_config``
as ``examples/randomwalks/ppo_randomwalks.py``'s ``main`` merges them
(``pretrain_steps`` and ``pretrain_lr`` set the SFT stage, ``device`` the
device; none of the three is a config field), then the example's two
stages run as it runs them, with no gate. Under ``TRLX_SWEEP`` the PPO
trainer prints the ``SWEEP_METRIC`` / ``SWEEP_RESULT`` lines the sweep
reads.

Prints one JSON line: the eval ``reward/mean`` curve, the SFT stage's final
loss, the seconds of each stage, and whether the first eval at or after
step 100 reached ``reward/mean`` >= 0.7 (the bar the JAX package's recorded
curve clears: 0.615@0, 0.851@20, 0.893@60, 0.983@80, 0.95@120). Exits 1 when
it did not (or when PPO stopped before step 100). ``--num-layers-unfrozen
2`` runs the PPO stage as hydra PPO (the example's hparam
``model.num_layers_unfrozen``: the top 2 layers train and the KL reference
is the frozen branch), whose recorded JAX run reached 0.943 within 120
steps. ``--async-max-staleness 1`` runs the PPO stage with
``train.async_rollouts`` (a producer thread, staleness cap 1), whose JAX
CPU run read 0.517@0, 0.867@20, 0.981@40, 0.95@60, 1.0@80, 0.992@100,
0.95@120 (:data:`JAX_ASYNC`).

The walks come from ``examples/randomwalks/randomwalks.py`` (numpy only);
nothing of the JAX package is imported.
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the bar: eval reward/mean at the first eval at or after GATE_STEP
GATE_STEP, GATE_REWARD = 100, 0.7
#: the JAX package's recorded PPO curve on this recipe (step, reward/mean)
JAX_CURVE = [(0, 0.615), (20, 0.851), (60, 0.893), (80, 0.983), (120, 0.95)]
#: its recorded hydra run (num_layers_unfrozen=2): 0.943 within 120 steps
JAX_HYDRA = "reward/mean 0.943 within 120 steps"
#: its CPU run with train.async_rollouts at max_staleness 1 (step, reward/mean)
JAX_ASYNC = [(0, 0.517), (20, 0.867), (40, 0.981), (60, 0.95), (80, 1.0), (100, 0.992), (120, 0.95)]


def default_config(alphabet: str):
    """The example's ``default_config`` on the port's TRLConfig."""
    from trlx_tpu_torch.data.configs import TRLConfig

    return TRLConfig.from_dict(dict(
        train=dict(
            seq_length=10, epochs=20, total_steps=1000, batch_size=100, checkpoint_interval=10000,
            eval_interval=20, pipeline="PromptPipeline", trainer="PPOTrainer",
            checkpoint_dir="ckpts/randomwalks_ppo", tracker="jsonl",
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=-1,
            model_overrides=dict(
                vocab_size=len(alphabet) + 3, hidden_size=144, num_layers=6,
                num_heads=12, intermediate_size=512, max_position_embeddings=32,
            ),
        ),
        tokenizer=dict(tokenizer_path=f"char://{alphabet}", truncation_side="right"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3.0e-4, betas=(0.9, 0.95), eps=1.0e-8, weight_decay=1.0e-6)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=10000, eta_min=3.0e-4)),
        method=dict(
            name="PPOConfig", num_rollouts=128, chunk_size=128, ppo_epochs=4, init_kl_coef=0, target=None,
            horizon=10000, gamma=1, lam=0.95, cliprange=0.2, cliprange_value=0.2, vf_coef=1.2,
            scale_reward="ignored", ref_mean=None, ref_std=None, cliprange_reward=1,
            gen_kwargs=dict(max_new_tokens=9, top_k=0, top_p=1.0, do_sample=True),
        ),
        mesh=dict(compute_dtype="float32"),
    ))


#: the gate's own settings on top of the example's ``default_config``: PPO's
#: step budget, an epoch budget that reaches it, no tracker, a temporary dir
GATE_OVERRIDES = ("train.epochs", "train.total_steps", "train.tracker", "train.checkpoint_dir")


def gate_config(alphabet: str, out_dir: str, ppo_steps: int, num_layers_unfrozen: int = -1):
    """The PPO stage's config: the example's, with :data:`GATE_OVERRIDES`
    and the hparam ``model.num_layers_unfrozen``."""
    config = default_config(alphabet)
    config.model.num_layers_unfrozen = num_layers_unfrozen
    config.train.tracker = None
    config.train.checkpoint_dir = out_dir
    config.train.total_steps = ppo_steps
    # the example's 20 epochs of ppo_epochs x one full batch end PPO at step
    # 80; the bar is read at step 100, so the epoch budget is the SFT stage's
    config.train.epochs = 100
    return config


@contextlib.contextmanager
def recording(cls, name, sink):
    """Wrap ``cls.name`` so each call appends (trainer step, result) to ``sink``."""
    original = getattr(cls, name)

    def wrapped(self, *a, **kw):
        out = original(self, *a, **kw)
        sink.append((self.iter_count, out))
        return out

    setattr(cls, name, wrapped)
    try:
        yield sink
    finally:
        setattr(cls, name, original)


def pretrain_on_walks(config, sample_walks, out_dir: str, steps: int, device=None, report=None,
                      lr: float = 1e-3) -> str:
    """The example's SFT warm start (``ppo_randomwalks.pretrain_on_walks``):
    ``steps`` SFT steps at ``lr`` on the walks, every layer trained, then
    ``save_pretrained``. Returns the exported directory; fills ``report``
    with the stage's seconds and first and final losses."""
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.methods.sft import SFTConfig
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    d = config.to_dict()
    d["method"] = SFTConfig(gen_kwargs=dict(max_new_tokens=9, top_k=1)).to_dict()
    d["train"].update(trainer="SFTTrainer", total_steps=steps, epochs=100, eval_interval=steps,
                      checkpoint_interval=10 * steps, checkpoint_dir=out_dir + "/sft_ckpts")
    d["optimizer"]["kwargs"]["lr"] = lr
    d["model"]["num_layers_unfrozen"] = -1
    t0 = time.perf_counter()
    with recording(SFTTrainer, "train_step", []) as losses:
        sft = trlx_tpu_torch.train(samples=sample_walks, eval_prompts=["a"], config=TRLConfig.from_dict(d),
                                   device=device)
    hf_dir = out_dir + "/sft_model"
    sft.save_pretrained(hf_dir)
    if report is not None:
        report.update(sft_seconds=time.perf_counter() - t0, sft_final_loss=losses[-1][1]["losses/loss"],
                      sft_first_loss=losses[0][1]["losses/loss"], sft_steps=len(losses))
    return hf_dir


def run_gate(pretrain_steps=300, ppo_steps=120, device=None, num_layers_unfrozen=-1, warm_start=None,
             export_to=None, async_max_staleness=None):
    """SFT ``pretrain_steps`` at lr 1e-3 (the example's default), export,
    PPO ``ppo_steps`` from the export with ``num_layers_unfrozen``, in a
    temporary directory. ``warm_start`` names an export of this SFT stage
    made earlier, which replaces it; ``export_to`` keeps this run's export
    there (the caller removes it); ``async_max_staleness`` runs the PPO
    stage with ``train.async_rollouts`` at that cap (the report then holds
    the drain ledger). Returns the report dict (``ok``: the bar was met)."""
    import trlx_tpu_torch
    from examples.randomwalks import generate_random_walks
    from trlx_tpu_torch.trainer.mesh_trainer import MeshRLTrainer

    metric_fn, prompts, sample_walks, _, alphabet = generate_random_walks(seed=1002)
    out_dir = tempfile.mkdtemp(prefix="randomwalks_")
    config = gate_config(alphabet, out_dir, ppo_steps, num_layers_unfrozen)
    if async_max_staleness is not None:
        config.train.async_rollouts.enabled = True
        config.train.async_rollouts.max_staleness = async_max_staleness
    report = {"pretrain_steps": pretrain_steps, "ppo_steps": ppo_steps, "device": device or "cuda",
              "num_layers_unfrozen": num_layers_unfrozen, "async_max_staleness": async_max_staleness}
    try:
        if warm_start is not None:
            hf_dir = warm_start
            report.update(warm_start="an earlier run's SFT export")
        else:
            hf_dir = pretrain_on_walks(config, sample_walks, out_dir, pretrain_steps, device, report)
            if export_to is not None:
                shutil.copytree(hf_dir, export_to)

        # PPO from the export; the architecture comes from its config.json
        config.model.model_path = hf_dir
        config.model.model_overrides = None
        t0 = time.perf_counter()
        with recording(MeshRLTrainer, "evaluate", []) as evals:
            ppo = trlx_tpu_torch.train(
                reward_fn=lambda samples, **kwargs: metric_fn(samples)["optimality"],
                prompts=prompts, eval_prompts=prompts,
                metric_fn=lambda samples, **kwargs: metric_fn(samples),
                config=config, device=device,
            )
        report.update(ppo_seconds=time.perf_counter() - t0, ppo_final_step=ppo.iter_count,
                      reference="hydra branch" if ppo.frozen_branch is not None else "full copy",
                      async_ledger=ppo.rollout_engine_summary)
        del ppo
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    curve = [(step, stats["reward/mean"]) for step, stats in evals]
    at_gate = next(((s, r) for s, r in curve if s >= GATE_STEP), None)
    jax_curve = JAX_HYDRA if num_layers_unfrozen > 0 else (JAX_CURVE if async_max_staleness is None else JAX_ASYNC)
    report.update(eval_curve=curve, jax_curve=jax_curve,
                  gate={"step": GATE_STEP, "min_reward": GATE_REWARD},
                  gate_eval=at_gate, ok=at_gate is not None and at_gate[1] >= GATE_REWARD)
    return report


def config_from_hparams(hparams, alphabet: str):
    """The sweep trial contract: (config, pretrain_steps, pretrain_lr,
    device) from a dict of dotted hparams, as the example's ``main``:
    ``pretrain_steps`` (default 300), ``pretrain_lr`` (1e-3) and ``device``
    come out first, the rest merges into ``default_config``."""
    from trlx_tpu_torch.data.configs import TRLConfig

    hparams = dict(hparams)
    pretrain_steps = int(hparams.pop("pretrain_steps", 300))
    pretrain_lr = float(hparams.pop("pretrain_lr", 1e-3))
    device = hparams.pop("device", None)
    return TRLConfig.update(default_config(alphabet).to_dict(), hparams), pretrain_steps, pretrain_lr, device


def run_trial(hparams) -> None:
    """One sweep trial: the example's SFT warm start into the config's
    checkpoint directory, then PPO from the export on the merged config."""
    import trlx_tpu_torch
    from examples.randomwalks import generate_random_walks

    metric_fn, prompts, sample_walks, _, alphabet = generate_random_walks(seed=1002)
    config, pretrain_steps, pretrain_lr, device = config_from_hparams(hparams, alphabet)
    hf_dir = pretrain_on_walks(config, sample_walks, config.train.checkpoint_dir, pretrain_steps, device,
                               lr=pretrain_lr)
    config.model.model_path = hf_dir
    config.model.model_overrides = None  # the architecture comes from the export's config.json
    trlx_tpu_torch.train(
        reward_fn=lambda samples, **kwargs: metric_fn(samples)["optimality"],
        prompts=prompts, eval_prompts=prompts,
        metric_fn=lambda samples, **kwargs: metric_fn(samples),
        config=config, device=device,
    )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0].lstrip().startswith("{"):
        run_trial(json.loads(argv[0]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pretrain-steps", type=int, default=300)
    ap.add_argument("--ppo-steps", type=int, default=120)
    ap.add_argument("--num-layers-unfrozen", type=int, default=-1,
                    help="the PPO stage's model.num_layers_unfrozen (2: hydra PPO)")
    ap.add_argument("--async-max-staleness", type=int, default=None,
                    help="run the PPO stage with train.async_rollouts at this max_staleness")
    ap.add_argument("--device", default=None, help="default: the CUDA device (raises without one)")
    args = ap.parse_args(argv)
    report = run_gate(args.pretrain_steps, args.ppo_steps, args.device, args.num_layers_unfrozen,
                      async_max_staleness=args.async_max_staleness)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
