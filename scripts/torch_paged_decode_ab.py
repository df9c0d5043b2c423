#!/usr/bin/env python3
"""A kernel of this checkout against another revision's, on one CUDA card,
in one process: the flash forward (K1), the flash backward pair (K2 dK/dV
and K3 dQ), the paged decode (K4) or the paged verify (K5).

Builds ``--baseline-src`` (the kernel's source file of another revision,
with the same C entry points) with the package's nvcc flags into ``trlx_tpu_torch/_build/``, and this checkout's
source as the package builds it. Both get the same seeded inputs. In f32
their outputs must be equal bit for bit; in bf16 (and int8 KV) this
checkout's output must lie within the kernels phase's tolerance (2e-2 x
max(1, max|ref|)) of the plain version. Both are timed in the order
baseline, current, current, baseline, as device time per launch: CUDA
events around replays of a CUDA graph of ``chip_smoke.GRAPH_LAUNCHES``
launches, so the host's launch overhead is not timed.

- ``--kernel flash_fwd``: at chip_smoke.py's three K1 timing shapes (the
  engine's prefill wave B=16, T=S=128, left-padded; scoring [32, 384] and
  the loss forward [16, 257] with their PPO masks), H=12, D=64, causal.
- ``--kernel flash_bwd``: at chip_smoke.py's two K2/K3 timing shapes (B=32,
  H=12, T=S=256, D=64, a P=128 + R=128 batch; and the learner microbatch
  B=16, T=S=257), each entry point.
- ``--kernel paged_decode``: at chip_smoke.py's K4 timing shape (B=256
  slots, H=12, D=64, BS=16, MB=16): f32, bf16 and int8 KV.
- ``--kernel paged_verify``: at chip_smoke.py's K5 timing shapes: the
  engine's verify round (B=256, Q=5; f32, bf16 and int8 KV) and a chunk
  append (B=1, Q=64 onto 64 tokens; f32 and bf16).

Prints the ``nvidia-smi`` line and one JSON object per case.

Usage: ``python3 scripts/torch_paged_decode_ab.py --baseline-src PATH
[--kernel flash_fwd|flash_bwd|paged_decode|paged_verify] [--iters N]`` from
the repository root. Exits non-zero without a CUDA device or when a check
fails.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the C entry points each --kernel compares (names of _kernels.KERNELS)
ENTRY_POINTS = {"flash_fwd": ("flash_fwd",), "flash_bwd": ("flash_bwd_dkv", "flash_bwd_dq"),
                "paged_decode": ("paged_decode",), "paged_verify": ("paged_verify",)}


def build_baseline(src: Path, kernel: str) -> ctypes.CDLL:
    """Compile ``src`` with the package's flags into the build directory
    (named after its hash) and load it with ``kernel``'s entry points typed."""
    from trlx_tpu_torch.ops import _kernels

    digest = hashlib.sha1(src.read_bytes() + " ".join(_kernels.NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _kernels.BUILD_DIR / f"lib{kernel}_baseline-{digest}.so"
    if not out.exists():
        _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    for name in ENTRY_POINTS[kernel]:
        fn = getattr(lib, name)
        fn.argtypes = _kernels.KERNELS[name][2]
        fn.restype = ctypes.c_int
    return lib


def paged_launcher(lib, entry, case):
    """A no-argument call of ``lib``'s ``paged_decode`` or ``paged_verify`` on
    ``case`` (the argument order of the package's wrappers), writing into a fixed
    output tensor, which it returns. Every launcher launches on the stream
    current at the call, so a graph capture records it."""
    import torch

    from trlx_tpu_torch.ops import _kernels

    q, kp = case["q"], case["k_pool"]
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    Q = q.shape[1] if entry == "paged_verify" else 1
    _, BS, Hkv, _ = kp.shape
    MB = case["block_tables"].shape[1]
    ks, vs = case.get("k_scale"), case.get("v_scale")
    out = torch.empty_like(q)
    dims = [B, Q, H, Hkv, D, BS, MB] if entry == "paged_verify" else [B, H, Hkv, D, BS, MB]

    def call():
        rc = getattr(lib, entry)(
            q.data_ptr(), kp.data_ptr(), case["v_pool"].data_ptr(),
            ks.data_ptr() if ks is not None else None, vs.data_ptr() if vs is not None else None,
            case["block_tables"].data_ptr(), case["context_lens"].data_ptr(), out.data_ptr(),
            *dims, 1.0 / D ** 0.5, _kernels.dtype_code(q.dtype), _kernels.dtype_code(kp.dtype),
            torch.cuda.current_stream().cuda_stream,
        )
        _kernels.check(entry, rc)
        return out

    return call


def fwd_launcher(lib, case):
    """A no-argument call of ``lib``'s ``flash_fwd`` on ``case``, causal, with
    lse, writing into fixed output tensors, which it returns as a tuple."""
    import torch

    from trlx_tpu_torch.ops import _kernels

    q, k, v, valid = (case[x] for x in ("q", "k", "v", "valid"))
    B, H, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)

    def call():
        rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), o.data_ptr(),
                           lse.data_ptr(), B, H, k.shape[1], T, k.shape[2], D, 1, 1.0 / D ** 0.5,
                           _kernels.dtype_code(q.dtype), torch.cuda.current_stream().cuda_stream)
        _kernels.check("flash_fwd", rc)
        return o, lse

    return call


def bwd_launcher(lib, entry, case):
    """A no-argument call of ``lib``'s flash backward ``entry``
    (``flash_bwd_dkv`` or ``flash_bwd_dq``) on ``case``, causal, writing
    into fixed output tensors, which it returns as a tuple."""
    import torch

    from trlx_tpu_torch.ops import _kernels

    q, k, v, g, valid, lse, delta = (case[x] for x in ("q", "k", "v", "g", "valid", "lse", "delta"))
    B, H, T, D = q.shape
    dims = (B, H, k.shape[1], T, k.shape[2], D)
    outs = (torch.empty_like(k), torch.empty_like(v)) if entry == "flash_bwd_dkv" else (torch.empty_like(q),)

    def call():
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            valid.data_ptr(), *(o.data_ptr() for o in outs), *dims, 1, 1.0 / D ** 0.5,
            _kernels.dtype_code(q.dtype), torch.cuda.current_stream().cuda_stream,
        )
        _kernels.check(entry, rc)
        return outs

    return call


def ab_times(chip_smoke, calls, iters):
    """Device ms per launch in the order baseline, current, current,
    baseline (graph replays, :func:`chip_smoke.graphed`)."""
    import torch

    replays = {name: chip_smoke.graphed(torch, fn) for name, fn in calls.items()}
    times = {"baseline": [], "current": []}
    for name in ("baseline", "current", "current", "baseline"):
        ms = chip_smoke.cuda_time_ms(replays[name], iters=max(1, iters // chip_smoke.GRAPH_LAUNCHES), warmup=3)
        times[name].append(ms / chip_smoke.GRAPH_LAUNCHES)
    return times


def compare(chip_smoke, row, calls, ref, dtype, args):
    """Fill ``row`` from the baseline's and this checkout's outputs: f32 must
    be equal bit for bit; otherwise this checkout's output is held against
    the plain one and both are timed. Returns whether the case held."""
    import torch

    base = [x.clone() for x in chip_smoke.as_tuple(calls["baseline"]())]
    cur = [x.clone() for x in chip_smoke.as_tuple(calls["current"]())]
    torch.cuda.synchronize()
    row["max_abs_diff_to_baseline"] = max((a.float() - b.float()).abs().max().item() for a, b in zip(base, cur))
    if dtype == torch.float32:
        row["outputs_equal"] = ok = all(torch.equal(a, b) for a, b in zip(base, cur))
    else:
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(cur, ref)]
        tols = [chip_smoke.TOL["bfloat16"] * max(1.0, b.float().abs().max().item()) for b in ref]
        row.update(max_abs_err=max(errs), tol=max(tols), within_tol=all(e <= t for e, t in zip(errs, tols)))
        ok = row["within_tol"]  # a NaN fails here
    times = ab_times(chip_smoke, calls, args.iters)
    row.update(iters=args.iters, baseline_ms=times["baseline"], current_ms=times["current"],
               speedup=sum(times["baseline"]) / sum(times["current"]))
    return ok


def run_paged(chip_smoke, libs, smi, args):
    """K4 (``--kernel paged_decode``) or K5 (``paged_verify``) at
    chip_smoke.py's timing shapes."""
    import torch

    from trlx_tpu_torch.ops import paged_attention as paged

    dev = torch.device("cuda")
    entry = args.kernel
    pools = (("f32", False, torch.float32), ("bf16", False, torch.bfloat16), ("int8", True, torch.bfloat16))
    if entry == "paged_decode":
        cases = [("B=256 H=12 D=64 BS=16 MB=16", kv, quant, dtype, None) for kv, quant, dtype in pools]
    else:
        cases = [("B=256 Q=5 H=12 D=64 BS=16 MB=16", kv, quant, dtype, None) for kv, quant, dtype in pools]
        cases += [("B=1 Q=64 onto 64 H=12 D=64 BS=16 MB=16 (a chunk append)", kv, quant, dtype, 64)
                  for kv, quant, dtype in pools[:2]]
    ok = True
    for shape, kv, quant, dtype, lens in cases:
        gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1)
        if entry == "paged_decode":
            case = chip_smoke.paged_case(torch, gen, B=256, H=12, Hkv=12, D=64, BS=16, MB=16, quant=quant,
                                         dev=dev, dtype=dtype)
            plain = paged.paged_attention_reference
        else:
            B, Q = (1, 64) if lens else (256, 5)
            live = torch.full((B,), lens, dtype=torch.int32, device=dev) if lens else None
            case = chip_smoke.verify_case(torch, gen, B, Q, 12, 12, 64, 16, 16, quant, dev, dtype, lens=live)
            plain = paged.paged_verify_attention_reference
        calls = {name: paged_launcher(lib, entry, case) for name, lib in libs.items()}
        ref = (chip_smoke.paged_call(plain, case),)
        row = {"kernel": entry, "kv": kv, "dtype": str(dtype), "card": smi, "shape": shape,
               "baseline_src": str(args.baseline_src)}
        ok = compare(chip_smoke, row, calls, ref, dtype, args) and ok
        print(json.dumps(row), flush=True)
    return ok


def run_flash_fwd(chip_smoke, libs, smi, args):
    """K1 at chip_smoke.py's three timing shapes, f32 and bf16."""
    import torch

    from trlx_tpu_torch.ops.attention import attention_reference

    dev = torch.device("cuda")
    shapes = [(16, 128, None)] + [(B, P + R, (P, R, r_max)) for _, B, P, R, r_max in chip_smoke.TRAIN_FWD_CASES]
    ok = True
    for B, T, train in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1)
            if train is None:
                pad = [int(x) for x in torch.randint(0, 96, (B,), generator=gen, device=dev)]
                q, k, v, valid = chip_smoke.flash_case(torch, gen, B, 12, 12, T, 64, dtype, pad, dev)
                shape = f"B={B} H=12 T=S={T} D=64 causal, left-padded"
            else:
                q, k, v, _ = chip_smoke.flash_case(torch, gen, B, 12, 12, T, 64, dtype, (), dev)
                valid = chip_smoke.train_valid(torch, gen, B, train[0], train[1], dev, train[2])
                shape = f"B={B} H=12 T=S={T} D=64 causal, P={train[0]} left-padded + R={train[1]} right-padded"
            case = dict(q=q, k=k, v=v, valid=valid)
            calls = {name: fwd_launcher(lib, case) for name, lib in libs.items()}
            ref = (attention_reference(q, k, v, valid),)  # the output; lse is held in f32 only
            row = {"kernel": "flash_fwd", "dtype": str(dtype), "card": smi, "shape": shape,
                   "baseline_src": str(args.baseline_src)}
            ok = compare(chip_smoke, row, calls, ref, dtype, args) and ok
            print(json.dumps(row), flush=True)
    return ok


def run_flash_bwd(chip_smoke, libs, smi, args):
    """K2 and K3 at chip_smoke.py's two timing shapes, f32 and bf16."""
    import torch

    from trlx_tpu_torch.ops.attention import (
        bwd_delta, flash_attention, flash_bwd_dkv_reference, flash_bwd_dq_reference,
    )

    dev = torch.device("cuda")
    plain = {"flash_bwd_dkv": flash_bwd_dkv_reference, "flash_bwd_dq": flash_bwd_dq_reference}
    ok = True
    for B, P, R in ((32, 128, 128), (chip_smoke.TRAIN_MB, chip_smoke.TRAIN_P, chip_smoke.TRAIN_N + 1)):
        T = P + R
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1)
            q, k, v, g, _ = chip_smoke.bwd_case(torch, gen, B, 12, 12, T, T, 64, (), dtype, dev)
            valid = chip_smoke.train_valid(torch, gen, B, P, R, dev)
            out, lse = flash_attention(q, k, v, valid, return_lse=True)
            case = dict(q=q, k=k, v=v, g=g, valid=valid, lse=lse, delta=bwd_delta(q, k, v, valid, out, lse, g))
            for entry in ENTRY_POINTS["flash_bwd"]:
                calls = {name: bwd_launcher(lib, entry, case) for name, lib in libs.items()}
                ref = chip_smoke.as_tuple(plain[entry](q, k, v, valid, out, lse, g))
                row = {"kernel": entry, "dtype": str(dtype), "card": smi,
                       "shape": f"B={B} H=12 T=S={T} D=64 causal, P={P} left-padded + R={R} right-padded",
                       "baseline_src": str(args.baseline_src)}
                ok = compare(chip_smoke, row, calls, ref, dtype, args) and ok
                print(json.dumps(row), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-src", required=True, type=Path)
    ap.add_argument("--kernel", choices=sorted(ENTRY_POINTS), default="paged_decode")
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_paged_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from trlx_tpu_torch.ops import _kernels

    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    current = None
    for name in ENTRY_POINTS[args.kernel]:
        current = _kernels.library(name)  # one library per source: binds each entry point
    libs = {"baseline": build_baseline(args.baseline_src.resolve(), args.kernel), "current": current}
    run = {"flash_fwd": run_flash_fwd, "flash_bwd": run_flash_bwd}.get(args.kernel, run_paged)
    return 0 if run(chip_smoke, libs, smi, args) else 1


if __name__ == "__main__":
    sys.exit(main())
