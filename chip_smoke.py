#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (trlx_tpu_torch) on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a host with a
CUDA device, the CUDA toolkit (nvcc) and PyTorch built for CUDA. It exits
non-zero, printing no result, when there is no CUDA device or no port
package beside it, and when any check fails.

Phases, each printing one JSON line:

1. ``env``      — card name and power limit (the ``nvidia-smi`` line is also
                  printed on its own), torch / CUDA versions; TF32 off.
2. ``build``    — compile every kernel from ``trlx_tpu_torch/csrc`` (one
                  nvcc per source, in parallel), seconds taken.
3. ``kernels``  — each kernel against its plain PyTorch version on the card
                  at the serving path's shapes: flash prefill (K1) in bf16
                  and f32, paged decode (K4) in bf16 and int8, with GQA and
                  masking corner cases. Max abs error within 1e-4 (f32) /
                  2e-2 (bf16, outputs of O(1)).
4. ``timing``   — CUDA-event times of kernel, plain version and the library
                  yardstick (SDPA for K1; none for K4) beside the bound
                  max(bytes / 3.35 TB/s, flops / 989 TFLOP/s).
5. ``parity``   — the engine on the card against the same engine on the CPU
                  (plain versions): gpt2 widths at 2 layers, f32, 8 prompts x
                  16 greedy tokens must be identical.
6. ``engine``   — the main path: ``ServingEngine`` at full gpt2 width (12
                  layers, bf16, attention_impl="flash", random weights from
                  a seed) under the continuous-batching traffic of the JAX
                  package's serving benchmark (256 slots, 768 requests, a
                  64-token shared prefix, prompts <= 128 tokens, budgets 32 to
                  128 tokens, greedy), with bf16 and int8 KV, each a warm-up
                  and a measured pass. Launch counts are reset just before
                  and read just after; every prefill wave must have launched
                  the flash kernel once per layer and every decode step the
                  paged kernel once per layer.

Then the kernel table (``{"kernels": [...]}``) and, last, the result line
``{"ok": true, "device": {...}}``. ``--phases`` runs a subset (the result
line needs all of them).
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PHASES = ("env", "build", "kernels", "timing", "parity", "engine")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ inputs


def flash_case(torch, gen, B, H, Hkv, T, D, dtype, pad, dev):
    q = torch.randn(B, H, T, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Hkv, T, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Hkv, T, D, generator=gen, device=dev).to(dtype)
    valid = torch.ones(B, T, dtype=torch.int32, device=dev)
    for b, p in enumerate(pad):
        valid[b, :p] = 0  # left padding (p == T: a row with no valid key)
    return q, k, v, valid


def paged_case(torch, gen, B, H, Hkv, D, BS, MB, quant, dev, dtype=None):
    """Pools with ragged lens, slots sharing a 4-block prefix in pairs, and
    every 16th slot idle at len 1 on the null block 0."""
    from trlx_tpu_torch.models.transformer import quantize_kv_rows

    dtype = dtype or torch.bfloat16
    NB = B * MB + 1
    kf = torch.randn(NB, BS, Hkv, D, generator=gen, device=dev)
    vf = torch.randn(NB, BS, Hkv, D, generator=gen, device=dev)
    tables = torch.arange(1, NB, dtype=torch.int32, device=dev).reshape(B, MB)
    tables[1::2, :4] = tables[0::2, :4]  # prefix-shared blocks
    lens = torch.randint(1, MB * BS + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    tables[::16] = 0
    lens[::16] = 1
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    if quant:
        kq, ks = quantize_kv_rows(kf)
        vq, vs = quantize_kv_rows(vf)
        return dict(q=q, k_pool=kq, v_pool=vq, block_tables=tables, context_lens=lens,
                    k_scale=ks[..., 0].contiguous(), v_scale=vs[..., 0].contiguous())
    return dict(q=q, k_pool=kf.to(dtype), v_pool=vf.to(dtype), block_tables=tables,
                context_lens=lens)


def paged_call(fn, case):
    return fn(case["q"], case["k_pool"], case["v_pool"], case["block_tables"],
              case["context_lens"], k_scale=case.get("k_scale"), v_scale=case.get("v_scale"))


def flash_bound(B, H, Hkv, T, D, elem):
    byts = (2 * B * H * T * D + 2 * B * Hkv * T * D) * elem + B * T * 4
    flops = 2 * B * H * T * T * D  # causal: half of the two 2*T*S*D products
    return byts, flops


def paged_bound(case):
    lens = case["context_lens"].long()
    B, H, D = case["q"].shape
    Hkv = case["k_pool"].shape[2]
    live = int(lens.sum())
    byts = 2 * live * Hkv * D * case["k_pool"].element_size()
    if "k_scale" in case:
        byts += 2 * live * Hkv * 4
    byts += 2 * B * H * D * case["q"].element_size() + case["block_tables"].numel() * 4 + B * 4
    flops = 4 * live * H * D
    return byts, flops


def bound_ms(byts, flops):
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases


def phase_env(ctx):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    ctx["smi"] = smi
    emit({"phase": "env", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})


def phase_build(ctx):
    from trlx_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    per_kernel = _kernels.build()
    for name in _kernels.KERNELS:
        _kernels.library(name)  # load, so a bad library fails here
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for name, log in _kernels.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": per_kernel, "ptxas": ptxas})


def phase_kernels(ctx):
    import torch

    from trlx_tpu_torch.ops.attention import attention_reference, flash_attention
    from trlx_tpu_torch.ops.paged_attention import paged_attention_kernel, paged_attention_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results, errs = [], {"flash_fwd": 0.0, "paged_decode": 0.0}
    flash_cases = [
        ("gpt2_prefill", dict(B=16, H=12, Hkv=12, T=128, D=64,
                              pad=[int(x) for x in torch.randint(0, 96, (16,), generator=gen, device=dev)])),
        ("gqa_d128_t200", dict(B=2, H=32, Hkv=8, T=200, D=128, pad=(0, 37))),
        ("fully_masked_row", dict(B=2, H=4, Hkv=4, T=70, D=64, pad=(70, 5))),
    ]
    for name, shape in flash_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, valid = flash_case(torch, gen, dtype=dtype, dev=dev, **shape)
            out, lse = flash_attention(q, k, v, valid, return_lse=True)
            ref, ref_lse = attention_reference(q, k, v, valid, return_lse=True)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(dtype).split(".")[-1]]
            # lse is f32 in both; the kernel's sum order differs from torch's
            lse_err = (lse - ref_lse).abs().max().item()
            ok = err <= tol and lse_err <= 1e-3 and bool(torch.isfinite(out.float()).all())
            if name == "fully_masked_row":
                ok = ok and bool((out[0] == 0).all()) and bool((lse[0] == -1e30).all())
            results.append({"kernel": "flash_fwd", "case": name, "dtype": str(dtype), "max_abs_err": err,
                            "lse_err": lse_err, "tol": tol, "ok": ok})
            errs["flash_fwd"] = max(errs["flash_fwd"], err)
    paged_cases = [
        ("gpt2_decode", dict(B=256, H=12, Hkv=12, D=64, BS=16, MB=16)),
        ("gqa_rep4_d128", dict(B=64, H=32, Hkv=8, D=128, BS=16, MB=16)),
    ]
    for name, shape in paged_cases:
        for quant in (False, True):
            case = paged_case(torch, gen, quant=quant, dev=dev, **shape)
            out = paged_call(paged_attention_kernel, case)
            ref = paged_call(paged_attention_reference, case)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= TOL["bfloat16"] and bool(torch.isfinite(out.float()).all())
            results.append({"kernel": "paged_decode", "case": name, "kv": "int8" if quant else "bf16",
                            "max_abs_err": err, "tol": TOL["bfloat16"], "ok": ok})
            errs["paged_decode"] = max(errs["paged_decode"], err)
    # f32 pools with f32 queries at the gpt2 decode shape: the tight tolerance
    case = paged_case(torch, gen, quant=False, dev=dev, dtype=torch.float32, **paged_cases[0][1])
    err = (paged_call(paged_attention_kernel, case) - paged_call(paged_attention_reference, case)).abs().max().item()
    results.append({"kernel": "paged_decode", "case": "gpt2_decode", "kv": "f32",
                    "max_abs_err": err, "tol": TOL["float32"], "ok": err <= TOL["float32"]})
    for r in results:
        emit({"phase": "kernels", **r})
    ctx["max_abs_err"] = errs
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")


def phase_timing(ctx):
    import torch
    import torch.nn.functional as F

    from trlx_tpu_torch.ops.attention import attention_reference, flash_attention
    from trlx_tpu_torch.ops.paged_attention import paged_attention_kernel, paged_attention_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    timings = {}
    B, H, T, D = 16, 12, 128, 64
    pad = [int(x) for x in torch.randint(0, 96, (B,), generator=gen, device=dev)]
    q, k, v, valid = flash_case(torch, gen, B, H, H, T, D, torch.bfloat16, pad, dev)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    sdpa_mask = causal[None, None] & (valid > 0)[:, None, None, :]
    byts, flops = flash_bound(B, H, H, T, D, 2)
    b_ms, b_by = bound_ms(byts, flops)
    timings["flash_fwd"] = {
        "shape": f"B={B} H={H} T=S={T} D={D} bf16 causal, left-padded",
        "ms": cuda_time_ms(lambda: flash_attention(q, k, v, valid)),
        "plain_ms": cuda_time_ms(lambda: attention_reference(q, k, v, valid)),
        "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": byts, "flops": flops,
    }
    for quant in (False, True):
        case = paged_case(torch, gen, B=256, H=12, Hkv=12, D=64, BS=16, MB=16, quant=quant, dev=dev)
        byts, flops = paged_bound(case)
        b_ms, b_by = bound_ms(byts, flops)
        key = "paged_decode" if not quant else "paged_decode_int8"
        timings[key] = {
            "shape": f"B=256 H=12 D=64 BS=16 MB=16 {'int8' if quant else 'bf16'} KV, "
                     f"{int(case['context_lens'].sum())} live tokens",
            "ms": cuda_time_ms(lambda: paged_call(paged_attention_kernel, case)),
            "plain_ms": cuda_time_ms(lambda: paged_call(paged_attention_reference, case)),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": byts, "flops": flops,
        }
    for name, t in timings.items():
        emit({"phase": "timing", "kernel": name, "card": ctx.get("smi"), **t})
    ctx["timings"] = timings


def gpt2_config(layers: int, dtype, quant: bool = False):
    """The gpt2 preset at full width, cut to ``layers``, flash prefill."""
    from trlx_tpu_torch.models.presets import PRESETS

    return PRESETS["gpt2"].replace(
        num_layers=layers, compute_dtype=dtype, param_dtype=dtype,
        attention_impl="flash", kv_cache_quant=quant,
    )


def _logit_gap(trunk, prompt, generated, pos):
    """Top-2 logit gap of ``trunk`` at generated position ``pos`` (a gap far
    above float noise means the contexts differed, not a near tie)."""
    import torch

    ids = torch.tensor([list(prompt) + list(generated[:pos])], device=trunk.device)
    with torch.no_grad():
        logits = trunk(ids, torch.ones_like(ids))[0][0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def phase_parity(ctx):
    import numpy as np
    import torch

    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.serving import GenerationClient, ServingEngine

    cfg = gpt2_config(2, torch.float32)
    state = TransformerLM(cfg).init_params(SEED).state_dict()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 40, 8)]
    outs = {}
    for device in ("cuda", "cpu"):
        eng = ServingEngine(TransformerLM(cfg), state, num_slots=4, max_seq_len=64, block_size=16,
                            gen_kwargs=dict(do_sample=False), seed=SEED, device=device)
        seqs, mask, P = GenerationClient(eng).generate_batch(prompts, 16)
        assert eng.allocator.blocks_in_use == 0
        outs[device] = (seqs, mask, P, eng)
    cu, cp = outs["cuda"], outs["cpu"]
    same = np.array_equal(cu[0], cp[0]) and np.array_equal(cu[1], cp[1])
    report = {"phase": "parity", "prompts": len(prompts), "new_tokens": 16,
              "identical": bool(same), "prefill_waves": cu[3].stats.prefill_waves}
    if not same:
        P = cu[2]
        row = int(np.nonzero((cu[0] != cp[0]).any(axis=1))[0][0])
        pos = int(np.nonzero(cu[0][row, P:] != cp[0][row, P:])[0][0])
        report.update(row=row, position=pos,
                      cpu_logit_gap=_logit_gap(cp[3].trunk, prompts[row], cp[0][row, P:], pos),
                      cuda_logit_gap=_logit_gap(cu[3].trunk, prompts[row], cp[0][row, P:], pos))
    emit(report)
    if not same:
        raise AssertionError("engine on the card diverged from the CPU engine")


#: the JAX package's serving benchmark traffic (bench.py _serving_perf)
SLOTS, PROMPT_CAP, MAX_NEW = 256, 128, 128


def serving_traffic(vocab_size: int, seed: int = SEED):
    """(prompts, budgets): 3 x SLOTS requests, each a 64-token shared prefix
    plus 1..64 own tokens, budgets spread over [MAX_NEW/4, MAX_NEW]."""
    import numpy as np

    n_req = 3 * SLOTS
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab_size, PROMPT_CAP // 2)
    prompts = [
        np.concatenate([shared, rng.integers(1, vocab_size, 1 + int(rng.integers(0, PROMPT_CAP // 2)))])
        .astype(np.int32).tolist()
        for _ in range(n_req)
    ]
    budgets = [MAX_NEW // 4 + (i * (3 * MAX_NEW // 4)) // n_req for i in range(n_req)]
    return prompts, budgets


def full_width_engine(quant: bool, state=None):
    """(engine, state): gpt2 at full width, 12 layers, bf16, flash prefill,
    random weights from SEED (or ``state``), SLOTS slots."""
    import torch

    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.serving import ServingEngine

    cfg = gpt2_config(12, torch.bfloat16, quant)
    if state is None:
        state = TransformerLM(cfg, device="cuda").init_params(SEED).state_dict()
    engine = ServingEngine(TransformerLM(cfg), state, num_slots=SLOTS,
                           max_seq_len=PROMPT_CAP + MAX_NEW,
                           gen_kwargs=dict(do_sample=False), seed=SEED)
    return engine, state


def phase_engine(ctx):
    import torch

    from trlx_tpu_torch.ops import _kernels

    prompts, budgets = serving_traffic(gpt2_config(12, torch.bfloat16).vocab_size)
    state = None
    _kernels.reset_launches()
    for quant in (False, True):
        eng, state = full_width_engine(quant, state)
        L = eng.trunk.config.num_layers
        for label in ("warmup", "measured"):
            before = dict(_kernels.launches())
            waves0, steps0 = eng.stats.prefill_waves, eng.stats.decode_steps
            prefill0, decode0 = eng.stats.prefill_s, eng.stats.decode_s
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            uids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
            done = eng.run(uids)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            delivered = sum(len(done[u].generated) for u in uids)
            for u in uids:
                eng.scheduler.pop_request(u)
            waves = eng.stats.prefill_waves - waves0
            steps = eng.stats.decode_steps - steps0
            flash = _kernels.launches()["flash_fwd"] - before["flash_fwd"]
            paged = _kernels.launches()["paged_decode"] - before["paged_decode"]
            short = [u for u, n in zip(uids, budgets) if len(done[u].generated) != n]
            run = {"phase": "engine", "kv": "int8" if quant else "bf16", "pass": label,
                   "card": ctx.get("smi"), "requests": len(prompts), "slots": SLOTS,
                   "delivered_tokens": delivered, "wall_s": wall, "tok_s": delivered / wall,
                   "decode_steps": steps, "prefill_waves": waves,
                   "prefill_s": eng.stats.prefill_s - prefill0,
                   "decode_s": eng.stats.decode_s - decode0,
                   "flash_launches": flash, "paged_launches": paged,
                   "blocks_in_use": eng.allocator.blocks_in_use,
                   "prefix_cache_hit_rate": eng.allocator.stats.hit_rate,
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            emit(run)
            checks = {
                "flash launches == prefill waves x layers": flash == waves * L and flash > 0,
                "paged launches == decode steps x layers": paged == steps * L and paged > 0,
                "no blocks in use at the end": eng.allocator.blocks_in_use == 0,
                "every request ran its whole budget": not short,
            }
            failed = [k for k, ok in checks.items() if not ok]
            if failed:
                raise AssertionError(f"engine {run['kv']} {label}: {failed}")
        eng.allocator.check_invariants()
        eng.close()
        del eng
        torch.cuda.empty_cache()
    ctx["main_path_launches"] = _kernels.launches()


def kernel_table(ctx):
    t, launches, errs = ctx["timings"], ctx["main_path_launches"], ctx["max_abs_err"]
    rows = [
        ("flash_fwd", "trlx_tpu_torch/csrc/flash_fwd.cu", "trlx_tpu/ops/attention.py:72"),
        ("paged_decode", "trlx_tpu_torch/csrc/paged_decode.cu", "trlx_tpu/ops/paged_attention.py:183"),
    ]
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": t[name]["ms"], "plain_ms": t[name]["plain_ms"], "bound_ms": t[name]["bound_ms"],
         "bound_by": t[name]["bound_by"], "library_ms": t[name]["library_ms"]}
        for name, src, rep in rows
    ]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 1
    import trlx_tpu_torch  # noqa: F401  (fails in a directory without the package)

    ctx = {}
    runners = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
               "timing": phase_timing, "parity": phase_parity, "engine": phase_engine}
    phase_env(ctx)
    for name in phases:
        if name != "env":
            runners[name](ctx)
    if set(phases) != set(PHASES):
        return 0
    emit(kernel_table(ctx))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
