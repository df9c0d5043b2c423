#!/usr/bin/env python3
"""Where the port's serving time goes, on one CUDA card.

Runs chip_smoke.py's main path — ``ServingEngine`` at full gpt2 width (12
layers, bf16, flash prefill, 256 slots) under the serving benchmark traffic
— three times: a warm-up pass, an unprofiled pass (wall clock and tok/s),
and a pass under ``torch.profiler`` with CPU and CUDA activities. From the
profiled pass it prints one JSON object: the engine's host-clock split
between admission rounds (prefill + pack) and decode rounds, device busy
time (the union of kernel intervals), the device's idle share, kernels per
decode step, the kernels that took the most device time, each of the
port's own kernels with its share of busy time, and the host operations
that took the most host time (self time, which includes the waits of
synchronising calls).

Usage: ``python3 scripts/torch_serving_profile.py [--kv bf16|int8] [--spec]
[--requests N] [--trace PATH]`` from the repository root. ``--spec``
profiles chip_smoke.py's ``engine_spec`` path instead: int8 KV, spec_k 4,
prefill_chunk 64, every budget 128. ``--requests N`` keeps the first N
requests of the traffic (a shorter profile). ``--trace`` also writes the
Chrome trace. Exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


#: the port's hand-written kernels (their CUDA function names), always
#: listed with their share of device busy time
PORT_KERNELS = ("flash_fwd_kernel", "fwd_mma_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel", "dkv_mma_kernel",
                "dq_mma_kernel", "paged_attn_kernel", "paged_mma_kernel")


def _kernel_events(prof):
    """(name, start_us, end_us) of every CUDA kernel the profiler saw."""
    import torch

    out = []
    for evt in prof.events():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        out.append((evt.name, evt.time_range.start, evt.time_range.end))
    return out


def _union_us(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((s, e) for _, s, e in intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kv", choices=("bf16", "int8"), default="bf16")
    ap.add_argument("--spec", action="store_true", help="the engine_spec path (implies --kv int8)")
    ap.add_argument("--requests", type=int, default=None, help="keep the first N requests")
    ap.add_argument("--trace", default=None, help="write the Chrome trace here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi_line()
    knobs = dict(spec_k=4, prefill_chunk=chip_smoke.PROMPT_CAP // 2) if args.spec else {}
    engine, _ = chip_smoke.full_width_engine(quant=args.spec or args.kv == "int8", **knobs)
    prompts, budgets = chip_smoke.serving_traffic(engine.trunk.config.vocab_size)
    if args.spec:
        budgets = [chip_smoke.MAX_NEW] * len(prompts)
    prompts, budgets = prompts[:args.requests], budgets[:args.requests]

    def one_pass():
        stats0 = dict(vars(engine.stats))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        uids = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
        done = engine.run(uids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for u in uids:
            engine.scheduler.pop_request(u)
        delta = {k: v - stats0[k] for k, v in vars(engine.stats).items()}
        return wall, sum(len(done[u].generated) for u in uids), delta

    one_pass()  # warm-up: allocator pools, cuBLAS handles, kernel libraries
    wall, delivered, _ = one_pass()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall, _, delta = one_pass()
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = _kernel_events(prof)
    busy_s = _union_us(kernels) / 1e6
    by_name = {}
    for name, s, e in kernels:
        calls, us = by_name.get(name, (0, 0.0))
        by_name[name] = (calls + 1, us + (e - s))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    steps = max(1, delta["decode_steps"])
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    print(json.dumps({
        "card": smi, "kv": "int8" if args.spec else args.kv, "spec": knobs, "slots": chip_smoke.SLOTS,
        "requests": len(prompts), "spec_rounds": delta["spec_rounds"], "chunk_appends": delta["chunk_appends"],
        "accepted_tok_per_round": delta["delivered_tokens"] / max(1, delta["decode_slot_rounds"]),
        "unprofiled_wall_s": wall, "unprofiled_tok_s": delivered / wall,
        "profiled_wall_s": prof_wall,
        "prefill_s": delta["prefill_s"], "decode_s": delta["decode_s"],
        "prefill_waves": delta["prefill_waves"], "decode_steps": delta["decode_steps"],
        "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / prof_wall,
        "kernels": len(kernels), "kernels_per_decode_step_and_wave": len(kernels) / steps,
        "top_kernels": [
            {"name": name[:120], "calls": calls, "device_s": us / 1e6, "share_of_busy": us / 1e6 / busy_s}
            for name, (calls, us) in top
        ],
        "port_kernels": [
            {"name": name[:120], "calls": calls, "device_s": us / 1e6, "share_of_busy": us / 1e6 / busy_s}
            for name, (calls, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])
            if any(k in name for k in PORT_KERNELS)
        ],
        "top_host_ops": [
            {"name": e.key[:80], "calls": e.count, "self_host_s": e.self_cpu_time_total / 1e6}
            for e in host
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
