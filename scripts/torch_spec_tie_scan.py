#!/usr/bin/env python3
"""How often the speculative engine's greedy tokens split from the one-token
engine's at full gpt2 width, per weight scale, on one CUDA card.

For each scale given, the seeded random weights of chip_smoke.py's
``engine_spec`` phase are multiplied by it (``3`` scales every floating
tensor, as ``train_parity`` does; ``3noln`` leaves the layer norms as they
are). The speculative engine (int8 KV, spec_k 4, prefill_chunk 64, 256
slots) runs the 768 requests of that phase's traffic, every budget 128; the
one-token engine with the same chunking runs the first 32. Prints one JSON
object per scale: whole-row matches of the first 32 requests, each split's
position, logit gap (the dense model's preference for the one-token
engine's token) and top logit, the spec engine's accept rate, and the
teacher-forced gaps: at every generated position of the 32 speculative
rows, the dense model's top logit minus its logit of the token the
speculative engine chose.

Usage: ``python3 scripts/torch_spec_tie_scan.py SCALE [SCALE ...]`` from
the repository root, e.g. ``1 3``. Exits non-zero without a CUDA device.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(engine, prompts, keep):
    """Generated tokens of the first ``keep`` requests, and the summary."""
    import chip_smoke

    uids = [engine.submit(p, chip_smoke.MAX_NEW) for p in prompts]
    done = engine.run(uids)
    out = [list(done[u].generated) for u in uids[:keep]]
    for u in uids:
        engine.scheduler.pop_request(u)
    return out, engine.summary()


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    import torch

    if not torch.cuda.is_available():
        print("torch_spec_tie_scan: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from trlx_tpu_torch.models.transformer import TransformerLM

    print(cs.nvidia_smi_line(), flush=True)
    prompts, _ = cs.serving_traffic(cs.gpt2_config(12, torch.bfloat16).vocab_size)
    base = TransformerLM(cs.gpt2_config(12, torch.bfloat16, True), device="cuda").init_params(cs.SEED).state_dict()
    n = 32
    for arg in args:
        keep_ln = arg.endswith("noln")
        scale = float(arg[:-4] if keep_ln else arg)
        state = {k: v * scale if v.is_floating_point() and not (keep_ln and ("ln" in k or "norm" in k)) else v
                 for k, v in base.items()}
        spec, _ = cs.full_width_engine(True, state, spec_k=4, prefill_chunk=cs.PROMPT_CAP // 2)
        got, summary = run(spec, prompts, n)
        spec.close()
        del spec
        ref, _ = cs.full_width_engine(True, state, num_slots=n, prefill_chunk=cs.PROMPT_CAP // 2)
        want, _ = run(ref, prompts[:n], n)
        splits = cs.tie_aware_splits(ref.trunk, prompts[:n], got, want)
        gaps = cs.teacher_forced_gaps(ref.trunk, prompts[:n], got)
        ref.close()
        del ref
        torch.cuda.empty_cache()
        print(json.dumps({
            "scale": arg, "card": torch.cuda.get_device_name(0),
            "whole_row_matches": n - len(splits),
            "splits_over_2e-2": sum(1 for x in splits if not cs.near_tie(x, "bfloat16")),
            "splits": [(x["position"], x["logit_gap"], x["top_logit"]) for x in splits],
            "spec_accept_rate": summary["spec_accept_rate"],
            "accepted_tok_per_round": summary["accepted_tok_per_round"],
            "forced_positions": len(gaps), "forced_positive": sum(g > 0 for g in gaps),
            "forced_over_2e-2": sum(g > 2e-2 for g in gaps), "forced_max_gap": max(gaps),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
