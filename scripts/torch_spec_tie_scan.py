#!/usr/bin/env python3
"""How often the speculative engine's greedy tokens split from the one-token
engine's at full gpt2 width, per weight scale, on one CUDA card.

For each scale given, the seeded random weights of chip_smoke.py's
``engine_spec`` phase are multiplied by it (``3`` scales every floating
tensor, as ``train_parity`` does; ``3noln`` leaves the layer norms as they
are). The speculative engine (int8 KV, spec_k 4, prefill_chunk 64, 256
slots) runs the 768 requests of that phase's traffic, every budget 128; the
one-token engine with the same chunking and slots runs the first
max(``--rows``, 256), and the first ``--rows`` (default 32, the rows
engine_spec holds) are compared. Prints one JSON object per scale:
whole-row matches, each split's position, logit gap (the dense model's
preference for the one-token engine's token) and top logit, the spec
engine's accept rate, and the teacher-forced gaps: at every generated
position of the held speculative rows, the dense model's top logit minus
its logit of the token the speculative engine chose (``forced_*``), the
same for the one-token engine's own rows (``one_token_forced_*``), and the
speculative rows' gaps teacher-forced through the one-token engine itself
(``engine_forced_*``, chip_smoke.engine_forced_gaps, the arbiter engine_spec
holds; a split's fourth field is its gap there): their histogram in bf16
steps of 1/64, the over-2e-2 counts of each block of 32 rows (the first is
what engine_spec holds) and the largest; and the largest gap of the
one-token engine forced onto its own rows (0 when it reproduces them).

Usage: ``python3 scripts/torch_spec_tie_scan.py [--rows N] SCALE [SCALE
...]`` from the repository root, e.g. ``1 3``. Exits non-zero without a
CUDA device.
"""

import argparse
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


def gap_stats(gaps, rows):
    """Teacher-forced gaps of ``rows`` rows of MAX_NEW tokens: positive
    gaps in bf16 steps of 1/64 (a histogram), gaps over 2e-2 per block of
    32 rows, and the largest."""
    import chip_smoke as cs

    steps = {}
    for g in gaps:
        if g > 0:
            steps[round(g * 64)] = steps.get(round(g * 64), 0) + 1
    per_row = [gaps[i * cs.MAX_NEW:(i + 1) * cs.MAX_NEW] for i in range(rows)]
    return {"positive_in_64ths": dict(sorted(steps.items())), "over_2e-2": sum(g > 2e-2 for g in gaps),
            "over_2e-2_per_32_rows": [sum(g > 2e-2 for row in per_row[i:i + 32] for g in row)
                                      for i in range(0, rows, 32)],
            "max_gap": max(gaps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scales", nargs="+")
    ap.add_argument("--rows", type=int, default=32, help="requests held against the one-token engine")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_spec_tie_scan: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from trlx_tpu_torch.models.transformer import TransformerLM

    print(cs.nvidia_smi_line(), flush=True)
    prompts, _ = cs.serving_traffic(cs.gpt2_config(12, torch.bfloat16).vocab_size)
    base = TransformerLM(cs.gpt2_config(12, torch.bfloat16, True), device="cuda").init_params(cs.SEED).state_dict()
    n = args.rows
    for arg in args.scales:
        keep_ln = arg.endswith("noln")
        scale = float(arg[:-4] if keep_ln else arg)
        state = {k: v * scale if v.is_floating_point() and not (keep_ln and ("ln" in k or "norm" in k)) else v
                 for k, v in base.items()}
        spec, _ = cs.full_width_engine(True, state, spec_k=4, prefill_chunk=cs.PROMPT_CAP // 2)
        got, summary = run(spec, prompts, n)
        spec.close()
        del spec
        # engine_spec's one-token engine: the speculative engine's slots, its first wave of requests
        m = max(n, cs.SLOTS)
        ref, _ = cs.full_width_engine(True, state, num_slots=m, prefill_chunk=cs.PROMPT_CAP // 2)
        everyone, _ = run(ref, prompts[:m], m)
        want = everyone[:n]
        splits = cs.tie_aware_splits(ref.trunk, prompts[:n], got, want)
        gaps = cs.teacher_forced_gaps(ref.trunk, prompts[:n], got)
        ref_gaps = cs.teacher_forced_gaps(ref.trunk, prompts[:n], want)
        own = cs.engine_forced_gaps(ref, prompts[:m], everyone)
        engine = cs.engine_forced_gaps(ref, prompts[:m], got + everyone[n:])[:n]
        ref.close()
        del ref
        torch.cuda.empty_cache()
        print(json.dumps({
            "scale": arg, "card": torch.cuda.get_device_name(0),
            "whole_row_matches": n - len(splits),
            "splits_over_2e-2": sum(1 for x in splits if not cs.near_tie(x, "bfloat16")),
            "engine_splits_over_2e-2": sum(1 for x in splits
                                           if x["logit_gap"] is None or engine[x["row"]][x["position"]] > 2e-2),
            "splits": [(x["position"], x["logit_gap"], x["top_logit"],
                        engine[x["row"]][x["position"]] if x["logit_gap"] is not None else None)
                       for x in splits],
            "spec_accept_rate": summary["spec_accept_rate"],
            "accepted_tok_per_round": summary["accepted_tok_per_round"],
            "forced_positions": len(gaps),
            **{f"{who}_{k}": v for who, g in (("forced", gaps), ("one_token_forced", ref_gaps),
                                              ("engine_forced", [x for row in engine for x in row]))
               for k, v in gap_stats(g, n).items()},
            "engine_own_rows_max_abs_gap": max(abs(x) for row in own for x in row),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
