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
                  at the main paths' shapes: flash prefill (K1) in bf16 and
                  f32, paged decode (K4) in bf16 and int8, the flash backward
                  dK/dV (K2) and dQ (K3) in f32 and bf16 over MHA, GQA, MQA,
                  ragged T/S, left padding and a fully masked batch row, and
                  the whole autograd path against autograd through the plain
                  forward. Max abs error within 1e-4 (f32) / 2e-2 (bf16)
                  times max(1, max|reference|).
4. ``timing``   — CUDA-event times of kernel, plain version and the library
                  yardstick (SDPA for K1, SDPA's backward for K2 and K3; none
                  for K4) beside the bound max(bytes / 3.35 TB/s, flops / 989
                  TFLOP/s); K2 and K3 each alone at the learner's shape.
5. ``parity``   — the engine on the card against the same engine on the CPU
                  (plain versions): gpt2 widths at 2 layers, f32, 8 prompts x
                  16 greedy tokens must be identical.
6. ``engine``   — a main path: ``ServingEngine`` at full gpt2 width (12
                  layers, bf16, attention_impl="flash", random weights from
                  a seed) under the continuous-batching traffic of the JAX
                  package's serving benchmark (256 slots, 768 requests, a
                  64-token shared prefix, prompts <= 128 tokens, budgets 32 to
                  128 tokens, greedy), with bf16 and int8 KV, each a warm-up
                  and a measured pass. Launch counts are reset just before
                  and read just after; every prefill wave must have launched
                  the flash kernel once per layer and every decode step the
                  paged kernel once per layer.
7. ``train_parity`` — ``PPOTrainer`` on the card against ``PPOTrainer`` on
                  the CPU (2 layers, hidden 64, f32, greedy) from the same
                  weights: one experience phase, 2 optimizer steps; tokens
                  identical, experience within 1e-4, losses within 1e-3.
8. ``train``    — the other main path: ``trlx_tpu_torch.train`` at full
                  gpt2-small width (bf16 compute, f32 params and AdamW,
                  flash attention, the bytes tokenizer): 64 sampled rollouts
                  of 128 tokens per experience phase, 4 optimizer steps of 32
                  rollouts in 2 microbatches. Counts reset just before and
                  read just after: K2 and K3 once per layer and microbatch in
                  every step, K1 in every prefill, scoring and loss forward.

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

PHASES = ("env", "build", "kernels", "timing", "parity", "engine", "train_parity", "train")
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

    from trlx_tpu_torch.ops.paged_attention import paged_attention_kernel, paged_attention_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results, errs = [], {"flash_fwd": 0.0, "paged_decode": 0.0, "flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0}
    flash_cases = [
        ("gpt2_prefill", dict(B=16, H=12, Hkv=12, T=128, D=64,
                              pad=[int(x) for x in torch.randint(0, 96, (16,), generator=gen, device=dev)])),
        ("gqa_d128_t200", dict(B=2, H=32, Hkv=8, T=200, D=128, pad=(0, 37))),
        ("fully_masked_row", dict(B=2, H=4, Hkv=4, T=70, D=64, pad=(70, 5))),
    ]
    for name, shape in flash_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, valid = flash_case(torch, gen, dtype=dtype, dev=dev, **shape)
            results.append(compare_fwd(torch, name, q, k, v, valid, errs,
                                       zero_row=name == "fully_masked_row"))
    # K1 at the trainer's shapes, with its mask: left-padded prompts plus
    # right-padded responses
    for name, B, P, R, r_max in TRAIN_FWD_CASES:
        valid = train_valid(torch, gen, B, P, R, dev, r_max)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, _ = flash_case(torch, gen, B, 12, 12, P + R, 64, dtype, (), dev)
            results.append(compare_fwd(torch, name, q, k, v, valid, errs))
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
    results += check_flash_backward(torch, gen, dev, errs)
    for r in results:
        emit({"phase": "kernels", **r})
    ctx["max_abs_err"] = errs
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")


def compare_fwd(torch, name, q, k, v, valid, errs, zero_row=False, causal=True, scale=None):
    """K1 (out and lse) against attention_reference on the same CUDA
    tensors; ``zero_row``: batch row 0 sees no key and must give 0 and
    lse == -1e30."""
    from trlx_tpu_torch.ops.attention import attention_reference, flash_attention

    out, lse = flash_attention(q, k, v, valid, causal, scale, return_lse=True)
    ref, ref_lse = attention_reference(q, k, v, valid, causal, scale, return_lse=True)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[str(q.dtype).split(".")[-1]]
    # lse is f32 in both; the kernel's sum order differs from torch's
    lse_err = (lse - ref_lse).abs().max().item()
    ok = err <= tol and lse_err <= 1e-3 and bool(torch.isfinite(out.float()).all())
    if zero_row:
        ok = ok and bool((out[0] == 0).all()) and bool((lse[0] == -1e30).all())
    errs["flash_fwd"] = max(errs["flash_fwd"], err)
    return {"kernel": "flash_fwd", "case": name, "shape": list(q.shape), "dtype": str(q.dtype),
            "max_abs_err": err, "lse_err": lse_err, "tol": tol, "ok": ok}


def compare_bwd(torch, name, q, k, v, g, valid, errs, zero_row=False, causal=True, scale=None):
    """K2 (dK/dV) and K3 (dQ) against flash_backward_reference on the same
    CUDA tensors (out and lse from K1). Tolerance per gradient: max abs
    error <= TOL[dtype] * max(1, max|grad|); ``zero_row``: batch row 0 sees
    no key and its gradients must be exactly 0."""
    from trlx_tpu_torch.ops.attention import flash_attention, flash_backward, flash_backward_reference

    out, lse = flash_attention(q, k, v, valid, causal, scale, return_lse=True)
    got = flash_backward(q, k, v, valid, out, lse, g, causal, scale)
    ref = flash_backward_reference(q, k, v, valid, out, lse, g, causal, scale)
    torch.cuda.synchronize()
    tol_rel = TOL[str(q.dtype).split(".")[-1]]
    results = []
    for kernel, idx in (("flash_bwd_dkv", (1, 2)), ("flash_bwd_dq", (0,))):
        # per gradient, so a NaN fails its own comparison (Python's max()
        # would drop it)
        errs_i = [(got[i].float() - ref[i].float()).abs().max().item() for i in idx]
        tols_i = [tol_rel * max(1.0, ref[i].float().abs().max().item()) for i in idx]
        ok = all(e <= t for e, t in zip(errs_i, tols_i)) and all(
            bool(torch.isfinite(got[i]).all()) and bool(torch.isfinite(ref[i]).all()) for i in idx)
        if zero_row:
            ok = ok and all(bool((got[i][0] == 0).all()) for i in idx)
        err, tol = max(errs_i), max(tols_i)
        results.append({"kernel": kernel, "case": name, "shape": list(q.shape), "dtype": str(q.dtype),
                        "max_abs_err": err, "tol": tol, "ok": ok})
        errs[kernel] = max(errs[kernel], err)
    return results


#: K1 at the trainer's shapes: (name, B, P, R, longest response). Scoring
#: runs B=32 at P + R = 384: the trainer appends an eos to every 128-token
#: response, so 129 tokens round up to the 256 bucket. The loss forward runs
#: a microbatch of 16 padded to its longest response, 129.
TRAIN_FWD_CASES = [
    ("gpt2_scoring", 32, 128, 256, 129),
    ("gpt2_loss", 16, 128, 129, 129),
]

#: flash backward cases: (name, B, H, Hkv, T, S, D, left pads per batch row,
#: or ("train", P, R) for a learner batch's mask)
BWD_CASES = [
    ("gpt2_learner", 16, 12, 12, 257, 257, 64, ("train", 128, 129)),
    ("gpt2_train", 4, 12, 12, 256, 256, 64, (0, 37, 128, 255)),
    ("gqa_12_4_t200", 2, 12, 4, 200, 200, 64, (0, 61)),
    ("mqa_t37_s200", 2, 8, 1, 37, 200, 32, (5, 0)),
    ("ragged_t37", 3, 4, 4, 37, 37, 64, (0, 3, 36)),
    ("gqa_d128", 2, 8, 2, 100, 100, 128, (17, 0)),
    ("fully_masked_row", 2, 4, 2, 70, 70, 64, (70, 9)),
]


def bwd_case(torch, gen, B, H, Hkv, T, S, D, pad, dtype, dev):
    q = torch.randn(B, H, T, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dtype)
    g = torch.randn(B, H, T, D, generator=gen, device=dev).to(dtype)
    if pad and pad[0] == "train":
        return q, k, v, g, train_valid(torch, gen, B, pad[1], pad[2], dev)
    valid = torch.ones(B, S, dtype=torch.int32, device=dev)
    for b, p in enumerate(pad):
        valid[b, :p] = 0  # left padding (p == S: a batch row with no valid key)
    return q, k, v, g, valid


def check_flash_backward(torch, gen, dev, errs):
    """K2 (dK/dV) and K3 (dQ) against flash_backward_reference on the same
    CUDA tensors (out and lse from K1), f32 and bf16; then the whole autograd
    path against autograd through attention_reference in f32. Tolerance:
    max abs error <= TOL[dtype] * max(1, max|grad|)."""
    from trlx_tpu_torch.ops.attention import attention_reference, flash_attention, set_flash_backward

    results = []
    for name, B, H, Hkv, T, S, D, pad in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g, valid = bwd_case(torch, gen, B, H, Hkv, T, S, D, pad, dtype, dev)
            results += compare_bwd(torch, name, q, k, v, g, valid, errs, zero_row=name == "fully_masked_row")
    # the autograd path: flash_attention(...).backward through K1, K2 and K3
    prev = set_flash_backward("pallas")
    try:
        for name, B, H, Hkv, T, S, D, pad in BWD_CASES[1:4]:
            q, k, v, g, valid = bwd_case(torch, gen, B, H, Hkv, T, S, D, pad, torch.float32, dev)
            qkv = [x.requires_grad_(True) for x in (q, k, v)]
            got = torch.autograd.grad(flash_attention(*qkv, valid), qkv, g)
            ref = torch.autograd.grad(attention_reference(*qkv, valid), qkv, g)
            err = max((a - b).abs().max().item() for a, b in zip(got, ref))
            tol = TOL["float32"] * max(1.0, max(b.abs().max().item() for b in ref))
            results.append({"kernel": "flash_attention.backward", "case": name, "dtype": "torch.float32",
                            "max_abs_err": err, "tol": tol, "ok": err <= tol})
    finally:
        set_flash_backward(prev)
    return results


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
    timings.update(time_flash_backward(torch, F, gen, dev))
    for name, t in timings.items():
        emit({"phase": "timing", "kernel": name, "card": ctx.get("smi"), **t})
    ctx["timings"] = timings


def train_valid(torch, gen, B, P, R, dev, r_max=None):
    """kv_valid of a PPO batch: prompts left-padded to P (P/2..P real
    tokens), responses right-padded to R (1..r_max real tokens; r_max
    defaults to R)."""
    p_len = torch.randint(P // 2, P + 1, (B,), generator=gen, device=dev)
    r_len = torch.randint(1, (r_max or R) + 1, (B,), generator=gen, device=dev)
    pos = torch.arange(P + R, device=dev)[None, :]
    valid = ((pos >= P - p_len[:, None]) & (pos < P)) | ((pos >= P) & (pos < P + r_len[:, None]))
    return valid.to(torch.int32).contiguous()


def visible_pairs(valid, causal=True):
    """(query, key) pairs this batch's mask lets through, summed over the
    batch: what the attention work of this data needs."""
    c = valid.long().cumsum(dim=1) if causal else valid.long().sum(dim=1, keepdim=True).expand_as(valid)
    return int(c.sum())


def time_flash_backward(torch, F, gen, dev):
    """K2 and K3, each alone, at the training shape the JAX package's gpt2
    train leg used (B=32, H=12, T=S=256, D=64, bf16, causal, a P=128 +
    R=128 batch) and at the learner microbatch the train phase runs (B=16,
    T=S=257: 128 prompt bytes + 128 sampled tokens + the eos the trainer
    appends), beside their plain versions (each recomputes P and dS as its
    kernel does), the SDPA backward (the library call computing dQ, dK and
    dV together: ``torch.autograd.grad`` of SDPA's output, timed alone) and
    each kernel's bound. The timed outputs are held against the plain ones
    with the kernels phase's tolerance."""
    timings = time_flash_backward_at(torch, F, gen, dev, 32, 128, 128)
    learner = time_flash_backward_at(torch, F, gen, dev, TRAIN_MB, TRAIN_P, TRAIN_N + 1)
    for name in timings:
        timings[name]["at_learner_shape"] = learner[name]
    return timings


def time_flash_backward_at(torch, F, gen, dev, B, P, R, H=12, D=64):
    from trlx_tpu_torch.ops.attention import (
        bwd_delta, flash_attention, flash_bwd_dkv, flash_bwd_dkv_reference, flash_bwd_dq,
        flash_bwd_dq_reference,
    )

    T = P + R
    q, k, v, g, _ = bwd_case(torch, gen, B, H, H, T, T, D, (), torch.bfloat16, dev)
    valid = train_valid(torch, gen, B, P, R, dev)
    out, lse = flash_attention(q, k, v, valid, return_lse=True)
    delta = bwd_delta(q, k, v, valid, out, lse, g)
    pairs = visible_pairs(valid) * H
    elem = q.element_size()
    io = 4 * B * H * T * D * elem + 2 * B * H * T * 4  # q, k, v, dO; lse and delta
    shape = f"B={B} H={H} T=S={T} D={D} bf16 causal, P={P} left-padded + R={R} right-padded"

    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    mask = torch.ones(T, T, dtype=torch.bool, device=dev).tril()[None, None] & (valid > 0)[:, None, None, :]
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), g, retain_graph=True))

    timings = {}
    # dK/dV: S and dP recomputed, dV and dK produced (4 products); dQ: S, dP, dQ (3)
    for name, fn, plain, n_mm, out_bytes in (
        ("flash_bwd_dkv", lambda: flash_bwd_dkv(q, k, v, valid, g, lse, delta),
         lambda: flash_bwd_dkv_reference(q, k, v, valid, out, lse, g), 4, 2 * B * H * T * D * elem),
        ("flash_bwd_dq", lambda: flash_bwd_dq(q, k, v, valid, g, lse, delta),
         lambda: flash_bwd_dq_reference(q, k, v, valid, out, lse, g), 3, B * H * T * D * elem),
    ):
        got, ref = fn(), plain()
        got, ref = (got if isinstance(got, tuple) else (got,)), (ref if isinstance(ref, tuple) else (ref,))
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)]
        tols = [TOL["bfloat16"] * max(1.0, b.float().abs().max().item()) for b in ref]
        if not all(e <= t for e, t in zip(errs, tols)):  # a NaN fails here too
            raise AssertionError(f"{name} disagrees with its plain version at {shape}: {errs} > {tols}")
        byts, flops = io + out_bytes, n_mm * 2 * D * pairs
        b_ms, b_by = bound_ms(byts, flops)
        timings[name] = {
            "shape": shape, "ms": cuda_time_ms(fn), "plain_ms": cuda_time_ms(plain),
            "library_ms": library_ms, "library": "SDPA backward (dQ, dK, dV together), autograd.grad alone",
            "bound_ms": b_ms, "bound_by": b_by, "bytes": byts, "flops": flops,
            "max_abs_err": max(errs), "tol": max(tols),
        }
    # the pair's bound: five products over the visible pairs; q, k, v, dO,
    # dQ, dK, dV once each, plus lse and delta
    b_ms, b_by = bound_ms(io + 3 * B * H * T * D * elem, 5 * 2 * D * pairs)
    timings["flash_bwd_dkv"]["pair_bound_ms"] = timings["flash_bwd_dq"]["pair_bound_ms"] = b_ms
    return timings


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


# ------------------------------------------------------------------ training


def byte_prompts(n, lo, hi, seed):
    """``n`` seeded prompts of lo..hi bytes over lowercase letters and spaces."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz    ", dtype=np.uint8)
    return [bytes(rng.choice(letters, int(rng.integers(lo, hi + 1)))).decode() for _ in range(n)]


def byte_share_reward(samples, prompts, outputs, **_):
    """Deterministic host reward: the share of the byte 'e' in each output."""
    return [o.count("e") / max(1, len(o)) for o in outputs]


def ppo_config(**train_over):
    """The port's PPO config for the training phases (``train_over`` merged
    in dotted form)."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    base = default_ppo_config()
    base.model.num_layers_unfrozen = -1
    return TRLConfig.update(base, train_over)


def parity_trainer(device, state=None):
    """PPOTrainer at 2 layers / hidden 64 (4 heads of 16), f32, greedy, on
    ``device``; ``state`` replaces the seeded initial weights."""
    import tempfile

    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = ppo_config(**{
        "model.model_path": "gpt2",
        "model.model_overrides": dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4,
                                      max_position_embeddings=128, attention_impl="flash"),
        "mesh.compute_dtype": "float32", "mesh.param_dtype": "float32",
        "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": 64, "train.batch_size": 8, "train.minibatch_size": 4, "train.total_steps": 2,
        "train.tracker": None, "train.checkpoint_dir": tempfile.mkdtemp(prefix="chip_smoke_parity_"),
        "train.seed": SEED,
        "method.num_rollouts": 16, "method.chunk_size": 8, "method.ppo_epochs": 1,
        "method.gen_kwargs": dict(max_new_tokens=16, do_sample=False),
        "optimizer.kwargs": dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6),
        "scheduler.kwargs": dict(T_max=10, eta_min=1e-4),
    })
    trainer = get_trainer("PPOTrainer")(config=cfg, reward_fn=byte_share_reward, device=device)
    if state is not None:
        trainer.model.load_state_dict(state)
        trainer.ref_model.load_state_dict(trainer.model.transformer.state_dict())
    prompts = PromptPipeline(byte_prompts(16, 8, 40, SEED + 3), 48, trainer.tokenizer)
    trainer.add_prompt_pipeline(prompts)
    return trainer


def phase_train_parity(ctx):
    """PPOTrainer on the card against PPOTrainer on the CPU from the same
    weights: one experience phase of 16 rollouts and 2 optimizer steps.
    Tokens identical; logprobs / values / rewards within 1e-4; every step's
    losses/* within 1e-3 relative (+1e-6 absolute: the policy loss of the
    first step is ~0 by construction)."""
    import shutil

    import numpy as np
    import torch

    cpu = parity_trainer("cpu")
    # sharper logits than the 0.02 init, so greedy ties are far above float noise
    state = {k: v * 3 if v.is_floating_point() else v for k, v in cpu.model.state_dict().items()}
    cpu = parity_trainer("cpu", state)
    card = parity_trainer("cuda", state)
    runs = {}
    for name, tr in (("cuda", card), ("cpu", cpu)):
        tr.prepare_learning()
        steps = [tr.train_step(batch) for batch in list(tr.create_train_dataloader())[:2]]
        runs[name] = (list(tr.store.history), steps)
        shutil.rmtree(tr.config.train.checkpoint_dir, ignore_errors=True)
    (ce, cs), (pe, ps) = runs["cuda"], runs["cpu"]
    same_tokens = len(ce) == len(pe) and all(
        np.array_equal(a.query_tensor, b.query_tensor) and np.array_equal(a.response_tensor, b.response_tensor)
        for a, b in zip(ce, pe)
    )
    report = {"phase": "train_parity", "elements": len(ce), "steps": len(cs), "identical_tokens": same_tokens}
    ok = same_tokens
    if not same_tokens:
        row = next(i for i, (a, b) in enumerate(zip(ce, pe))
                   if not np.array_equal(a.response_tensor, b.response_tensor))
        a, b = ce[row].response_tensor, pe[row].response_tensor
        pos = int(np.nonzero(a[:len(b)] != b[:len(a)])[0][0]) if (a[:len(b)] != b[:len(a)]).any() else min(len(a), len(b))
        report.update(row=row, position=pos,
                      cpu_logit_gap=_logit_gap(cpu.model.transformer, pe[row].query_tensor, b, pos),
                      cuda_logit_gap=_logit_gap(card.model.transformer, pe[row].query_tensor, b, pos))
    else:
        elem_errs = [
            float(np.abs(getattr(a, f) - getattr(b, f)).max()) for a, b in zip(ce, pe)
            for f in ("logprobs", "values", "rewards")
        ]
        elem_err = max(elem_errs)
        loss_err = max(
            abs(x[k] - y[k]) / max(abs(y[k]), 1e-3) for x, y in zip(cs, ps) for k in y if k.startswith("losses/")
        )
        loss_ok = all(
            abs(x[k] - y[k]) <= 1e-3 * abs(y[k]) + 1e-6 for x, y in zip(cs, ps) for k in y if k.startswith("losses/")
        )
        report.update(max_element_abs_err=elem_err, max_loss_rel_err=loss_err,
                      losses_cuda=[{k: v for k, v in x.items() if k.startswith("losses/")} for x in cs],
                      losses_cpu=[{k: v for k, v in y.items() if k.startswith("losses/")} for y in ps])
        ok = all(e <= 1e-4 for e in elem_errs) and loss_ok and len(cs) == 2  # a NaN fails here
    emit(report)
    del card, cpu
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"PPOTrainer on the card disagrees with the CPU trainer: {report}")


#: the full-width train phase's shape (bench.py's gpt2 train leg: B=32, P=N=128)
TRAIN_B, TRAIN_P, TRAIN_N, TRAIN_MB = 32, 128, 128, 16


def full_width_train_config(ckpt_dir):
    """The train phase's config: the gpt2 preset at full width with flash
    attention, bf16 compute, f32 params, the bytes tokenizer, 64 rollouts of
    TRAIN_N sampled tokens per experience phase, 4 steps of TRAIN_B rollouts
    in TRAIN_B / TRAIN_MB microbatches."""
    return ppo_config(**{
        "model.model_path": "gpt2", "model.model_overrides": {"attention_impl": "flash"},
        "mesh.compute_dtype": "bfloat16", "mesh.param_dtype": "float32",
        "tokenizer.tokenizer_path": "bytes",
        "train.seq_length": TRAIN_P + TRAIN_N, "train.batch_size": TRAIN_B,
        "train.minibatch_size": TRAIN_MB, "train.total_steps": 4, "train.eval_interval": 100,
        "train.checkpoint_interval": 100, "train.save_best": False, "train.save_optimizer": False,
        "train.tracker": None, "train.checkpoint_dir": ckpt_dir, "train.seed": SEED,
        "method.num_rollouts": 64, "method.chunk_size": TRAIN_B, "method.ppo_epochs": 1,
        "method.gen_kwargs": dict(max_new_tokens=TRAIN_N, do_sample=True, top_k=0, top_p=1.0),
    })


def phase_train(ctx):
    """The main training path at full gpt2-small width: trlx_tpu_torch.train
    with 12 layers, hidden 768, vocab 50257, random weights from the seed,
    bf16 compute, f32 params and AdamW state, flash attention; 64 rollouts of
    128 sampled tokens per experience phase, 4 optimizer steps of 32 rollouts
    in 2 microbatches. Launch counts are reset just before and read just
    after; every prefill and scoring forward must have launched K1 once per
    layer and model, and every learner step K1, K2 and K3 once per layer and
    microbatch. The run records each kernel call's shape and the first mask
    of each shape; afterwards every such shape is held against the plain
    versions (:func:`check_main_path_shapes`)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import trlx_tpu_torch
    from trlx_tpu_torch.ops import _kernels
    from trlx_tpu_torch.ops import attention as attn
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cfg = full_width_train_config(ckpt_dir)
    L = 12
    num_mb = TRAIN_B // TRAIN_MB
    calls = []  # (kind, seconds, launch deltas, train_step stats, [B, T] of the call)
    originals = {name: getattr(PPOTrainer, name) for name in ("generate", "score", "train_step")}

    def call_shape(name, arg):
        if name == "train_step":  # the collated batch; its microbatches share its T
            return [len(arg.query_tensors), arg.query_tensors.shape[1] + arg.response_tensors.shape[1]]
        if name == "score":
            return list(arg.shape)
        return [len(arg)]

    def wrap(name):
        fn = originals[name]

        def timed(self, *a, **kw):
            before = dict(_kernels.launches())
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            delta = {k: _kernels.launches()[k] - before[k] for k in before}
            calls.append((name, seconds, delta, out if name == "train_step" else None, call_shape(name, a[0])))
            return out

        return timed

    seen = {}  # (kernel, q shape, Hkv, S, dtype, causal, scale[, lse]) -> calls and the first mask
    cuda_fwd, cuda_bwd = attn._flash_cuda, attn._flash_bwd_cuda

    def record(key, kv_valid):
        entry = seen.setdefault(key, {"calls": 0, "kv_valid": kv_valid.clone()})
        entry["calls"] += 1

    def fwd(q, k, v, kv_valid, causal, scale, return_lse):
        record(("flash_fwd", tuple(q.shape), k.shape[1], k.shape[2], q.dtype, causal, scale, return_lse), kv_valid)
        return cuda_fwd(q, k, v, kv_valid, causal, scale, return_lse)

    def bwd(q, k, v, kv_valid, out, lse, g, causal, scale):
        record(("flash_bwd", tuple(q.shape), k.shape[1], k.shape[2], q.dtype, causal, scale), kv_valid)
        return cuda_bwd(q, k, v, kv_valid, out, lse, g, causal, scale)

    params0 = {}

    def snapshot_init(self, *a, **kw):
        if not params0:
            params0.update({k: v.detach().clone() for k, v in self.model.state_dict().items()})
        return originals_prepare(self, *a, **kw)

    originals_prepare = PPOTrainer.prepare_learning
    for name in originals:
        setattr(PPOTrainer, name, wrap(name))
    PPOTrainer.prepare_learning = snapshot_init
    attn._flash_cuda, attn._flash_bwd_cuda = fwd, bwd
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = trlx_tpu_torch.train(
            reward_fn=byte_share_reward, prompts=byte_prompts(64, 64, 128, SEED + 1),
            eval_prompts=byte_prompts(32, 64, 128, SEED + 2), config=cfg,
        )
    finally:
        for name, fn in originals.items():
            setattr(PPOTrainer, name, fn)
        PPOTrainer.prepare_learning = originals_prepare
        attn._flash_cuda, attn._flash_bwd_cuda = cuda_fwd, cuda_bwd
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launches()
    peak = torch.cuda.max_memory_allocated()

    steps = [(sec, d, out, shp) for kind, sec, d, out, shp in calls if kind == "train_step"]
    gens = [(sec, d, shp) for kind, sec, d, _, shp in calls if kind == "generate"]
    scores = [(sec, d, shp) for kind, sec, d, _, shp in calls if kind == "score"]
    # learner tokens: the padded positions the step computes, B x (P + R)
    for i, (sec, d, out, shp) in enumerate(steps):
        emit({"phase": "train", "step": i + 1, "card": ctx.get("smi"), "learn_s": sec,
              "batch_shape": shp, "learner_tok_s": shp[0] * shp[1] / sec,
              "losses": {k: v for k, v in out.items() if k.startswith("losses/")},
              "rollout_s": {k: out[k] for k in ("time/rollout_generate", "time/rollout_reward",
                                                "time/rollout_score", "time/rollout_time")},
              "launches": d})
    changed = any(not torch.equal(params0[k], v) for k, v in trainer.model.state_dict().items())
    finite = all(np.isfinite(v) for _, _, out, _ in steps for k, v in out.items() if k.startswith("losses/"))
    summary = {
        "phase": "train", "card": ctx.get("smi"), "wall_s": wall, "steps": len(steps),
        "generate_calls": len(gens), "generate_s": [g[0] for g in gens],
        "score_calls": len(scores), "score_s": [c[0] for c in scores], "score_shapes": [c[2] for c in scores],
        "learn_s": [st[0] for st in steps], "learn_batch_shapes": [st[3] for st in steps],
        "learner_tok_s_mean": sum(st[3][0] * st[3][1] for st in steps) / max(sum(st[0] for st in steps), 1e-9),
        "peak_mem_gib": peak / 2 ** 30, "launches": launches, "params_changed": changed,
        "losses_finite": finite,
        "kernel_shapes": [{"kernel": key[0], "q": list(key[1]), "kv_heads": key[2], "S": key[3],
                           "dtype": str(key[4]), "lse": key[7] if len(key) > 7 else None, "calls": e["calls"]}
                          for key, e in seen.items()],
    }
    emit(summary)
    checks = {
        "4 optimizer steps": len(steps) == 4,
        "losses finite": finite,
        "params changed": changed,
        "K2 and K3: num_layers x num_mb per step": all(
            d["flash_bwd_dkv"] == L * num_mb and d["flash_bwd_dq"] == L * num_mb for _, d, _, _ in steps),
        "K1 on every loss forward": all(d["flash_fwd"] == L * num_mb for _, d, _, _ in steps),
        "K1 on every prefill": bool(gens) and all(d["flash_fwd"] == L for _, d, _ in gens),
        "K1 on every scoring forward (policy + reference)": bool(scores) and all(
            d["flash_fwd"] == 2 * L for _, d, _ in scores),
        "no kernel outside generate / score / train_step": all(
            launches[k] == sum(c[2][k] for c in calls) for k in launches),
    }
    failed = [k for k, ok in checks.items() if not ok]
    ctx["train_launches"] = launches
    del trainer
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"train phase: {failed}")
    check_main_path_shapes(ctx, seen)


def check_main_path_shapes(ctx, seen):
    """K1, K2 and K3 against their plain versions at every shape the train
    phase gave them, each with the first mask the run passed at that shape
    (left-padded prompts, right-padded responses), in the run's dtype and in
    f32; inputs are seeded normals. Tolerances as in the kernels phase."""
    import torch

    if not any(key[0] == "flash_bwd" for key in seen):
        raise AssertionError("train phase: no flash backward call was recorded")
    dev = next(iter(seen.values()))["kv_valid"].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    errs = ctx.setdefault("max_abs_err", {})
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        errs.setdefault(name, 0.0)
    results = []
    for key, entry in seen.items():
        kind, (B, H, T, D), Hkv, S, run_dtype, causal, scale = key[:7]
        valid = entry["kv_valid"]
        case = f"train: {kind} B={B} T={T} S={S}, {entry['calls']} calls"
        for dtype in dict.fromkeys((run_dtype, torch.float32)):
            q, k, v, g, _ = bwd_case(torch, gen, B, H, Hkv, T, S, D, (), dtype, dev)
            if kind == "flash_fwd":
                results.append(compare_fwd(torch, case, q, k, v, valid, errs, causal=causal, scale=scale))
            else:
                results += compare_bwd(torch, case, q, k, v, g, valid, errs, causal=causal, scale=scale)
    for r in results:
        emit({"phase": "train", "check": "kernel at a main-path shape", **r})
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"train phase: kernel disagrees with its plain version at a main-path shape: {bad}")


def kernel_table(ctx):
    """One row per ported TPU kernel; ``launches`` is the count from the main
    path that runs it (the engine for K4, the trainer for K2 and K3; K1 runs
    on both and reports the engine's, with both paths' counts beside it)."""
    t, errs = ctx["timings"], ctx["max_abs_err"]
    engine, train = ctx["main_path_launches"], ctx["train_launches"]
    rows = [
        ("flash_fwd", "trlx_tpu_torch/csrc/flash_fwd.cu", "trlx_tpu/ops/attention.py:72", engine),
        ("flash_bwd_dkv", "trlx_tpu_torch/csrc/flash_bwd.cu", "trlx_tpu/ops/attention.py:263", train),
        ("flash_bwd_dq", "trlx_tpu_torch/csrc/flash_bwd.cu", "trlx_tpu/ops/attention.py:338", train),
        ("paged_decode", "trlx_tpu_torch/csrc/paged_decode.cu", "trlx_tpu/ops/paged_attention.py:183", engine),
    ]
    table = []
    for name, src, rep, launches in rows:
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": launches[name], "max_abs_err": errs[name],
               "ms": t[name]["ms"], "plain_ms": t[name]["plain_ms"], "bound_ms": t[name]["bound_ms"],
               "bound_by": t[name]["bound_by"], "library_ms": t[name]["library_ms"]}
        if name == "flash_fwd":
            row["launches_by_path"] = {"engine": engine[name], "train": train[name]}
        table.append(row)
    return {"kernels": table, "not_yet_ported": [
        {"name": "paged_verify", "replaces": "trlx_tpu/ops/paged_attention.py:244",
         "path": "speculative decoding in the serving engine", "status": "not yet ported"},
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
               "timing": phase_timing, "parity": phase_parity, "engine": phase_engine,
               "train_parity": phase_train_parity, "train": phase_train}
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
