#!/usr/bin/env python3
"""Where the port's PPO training time goes, on one CUDA card.

Builds chip_smoke.py's full-width trainer (the gpt2 preset at 12 layers,
hidden 768, vocab 50257, random weights from the seed, bf16 compute, f32
params and AdamW, flash attention, 32 rollouts of up to 128 prompt bytes +
128 sampled tokens per learner batch in 2 microbatches), runs one experience phase and
one learner step to warm up, times a second experience phase and five
learner steps on one batch (their median) on the host clock, then
profiles one generate call, one scoring call and one learner step under
``torch.profiler`` (CPU and CUDA activities). Prints one JSON object: per
part, the unprofiled wall seconds, the profiled wall, device busy time (the
union of kernel intervals), the device's idle share, the kernel count, the
kernels that took the most device time and each of the port's own kernels
with its share of busy time; plus learner tokens/s and peak device memory.
The shapes are the ones these calls really run: the scoring forward's [B, P + R] with R the pow2 bucket of the longest
response (the trainer appends an eos to every response, so 128 sampled
tokens make 129 and R = 256), and the learner batch's [B, P + R] padded to
its longest prompt and response; learner tokens/s counts those padded
positions.

Usage: ``python3 scripts/torch_train_profile.py`` from the repository root.
Exits non-zero without a CUDA device.
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_serving_profile import PORT_KERNELS, _kernel_events, _union_us  # noqa: E402
#: unprofiled learner steps timed (their median is reported)
LEARN_STEPS = 5


def _profiled(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernel_events(prof)
    busy = _union_us(kernels) / 1e6
    by_name = {}
    for name, s, e in kernels:
        calls, us = by_name.get(name, (0, 0.0))
        by_name[name] = (calls + 1, us + (e - s))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    port = [kv for kv in by_name.items() if any(k in kv[0] for k in PORT_KERNELS)]

    def rows(items):
        return [{"name": name[:120], "calls": calls, "device_s": us / 1e6, "share_of_busy": us / 1e6 / busy}
                for name, (calls, us) in items]

    return {
        "profiled_wall_s": wall, "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "kernels": len(kernels), "top_kernels": rows(top), "port_kernels": rows(port),
    }


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import chip_smoke
    from trlx_tpu_torch.native import pad_collate_i32
    from trlx_tpu_torch.ops.generation import left_pad_batch, pad_to_bucket
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi_line()
    ckpt_dir = tempfile.mkdtemp(prefix="torch_train_profile_")
    try:
        cfg = chip_smoke.full_width_train_config(ckpt_dir)
        trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=chip_smoke.byte_share_reward)
        max_prompt = cfg.train.seq_length - cfg.method.gen_kwargs["max_new_tokens"]
        prompts = chip_smoke.byte_prompts(64, 64, 128, chip_smoke.SEED + 1)
        trainer.add_prompt_pipeline(PromptPipeline(prompts, max_prompt, trainer.tokenizer))
        torch.cuda.reset_peak_memory_stats()
        trainer.prepare_learning()  # warm-up experience phase
        batch = next(iter(trainer.create_train_dataloader()))
        trainer.train_step(batch)  # warm-up learner step

        # one experience phase and one learner step, unprofiled
        experience_s, _ = _timed(lambda: trainer.post_epoch_callback(0))
        batch = next(iter(trainer.create_train_dataloader()))
        learn_runs = [_timed(lambda: trainer.train_step(batch))[0] for _ in range(LEARN_STEPS)]
        learn_s = sorted(learn_runs)[LEARN_STEPS // 2]
        split = {k: trainer.rollout_stats[k] for k in
                 ("time/rollout_generate", "time/rollout_reward", "time/rollout_score")}

        # the three device-heavy parts, profiled one call each
        chunk = [np.asarray(e.query_tensor) for e in trainer.store.history[: chip_smoke.TRAIN_B]]
        outs = [np.asarray(e.response_tensor) for e in trainer.store.history[: chip_smoke.TRAIN_B]]
        P = pad_to_bucket(max(len(q) for q in chunk), [2 ** i for i in range(3, 14)])
        R = pad_to_bucket(max(len(o) for o in outs), [2 ** i for i in range(3, 14)])
        q_ids, q_mask = left_pad_batch(chunk, trainer.tokenizer.pad_token_id, P)
        r_ids, r_mask = pad_collate_i32(outs, R, trainer.tokenizer.pad_token_id, pad_left=False)
        seq, mask = np.concatenate([q_ids, r_ids], 1), np.concatenate([q_mask, r_mask], 1)
        gen_s, _ = _timed(lambda: trainer.generate(chunk))
        score_s, _ = _timed(lambda: trainer.score(seq, mask, P, R))
        parts = {
            "generate": dict(unprofiled_s=gen_s, **_profiled(lambda: trainer.generate(chunk))),
            "score": dict(unprofiled_s=score_s, **_profiled(lambda: trainer.score(seq, mask, P, R))),
            "learn": dict(unprofiled_s=learn_s, **_profiled(lambda: trainer.train_step(batch))),
        }
        learn_shape = [len(batch.query_tensors), batch.query_tensors.shape[1] + batch.response_tensors.shape[1]]
        print(json.dumps({
            "card": smi, "batch": chip_smoke.TRAIN_B, "prompt": chip_smoke.TRAIN_P,
            "new_tokens": chip_smoke.TRAIN_N, "microbatches": chip_smoke.TRAIN_B // chip_smoke.TRAIN_MB,
            "score_shape": list(seq.shape), "learn_batch_shape": learn_shape,
            "experience_phase_s": experience_s, "experience_split_s": split,
            "learn_steps_s": learn_runs, "learner_tok_s": learn_shape[0] * learn_shape[1] / learn_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "parts": parts,
        }))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
