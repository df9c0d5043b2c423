#!/usr/bin/env python3
"""A kernel of this checkout against another revision's, on one CUDA card,
in one process: the paged decode kernel (K4) or the flash backward pair
(K2 dK/dV and K3 dQ).

Builds ``--baseline-src`` (the kernel's source file of another revision,
with the same C entry points) with the package's nvcc flags into
``trlx_tpu_torch/_build/``, and this checkout's source as the package builds
it. Both get the same seeded inputs, and each is timed with CUDA events in
the order baseline, current, current, baseline.

- ``--kernel paged_decode``: at chip_smoke.py's K4 timing shape (B=256
  slots, H=12, D=64, BS=16, MB=16, bf16 and int8 KV); the two outputs must
  be equal bit for bit.
- ``--kernel flash_bwd``: at chip_smoke.py's two K2/K3 timing shapes (B=32,
  H=12, T=S=256, D=64, a P=128 + R=128 batch; and the learner microbatch
  B=16, T=S=257), each entry point timed in bf16. The f32 outputs must be
  equal bit for bit to the baseline's, and the bf16 outputs within the
  kernels phase's tolerance (2e-2 x max(1, max|ref|)) of the plain version.

Prints the ``nvidia-smi`` line and one JSON object per case.

Usage: ``python3 scripts/torch_paged_decode_ab.py --baseline-src PATH
[--kernel paged_decode|flash_bwd] [--iters N]`` from the repository root.
Exits non-zero without a CUDA device or when a check fails.
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
ENTRY_POINTS = {"paged_decode": ("paged_decode",), "flash_bwd": ("flash_bwd_dkv", "flash_bwd_dq")}


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


def launcher(lib, case):
    """A no-argument call of ``lib``'s ``paged_decode`` on ``case`` (the
    argument order of ``paged_attention_kernel``), writing into a fixed
    output tensor, which it returns."""
    import torch

    from trlx_tpu_torch.ops import _kernels

    q, kp = case["q"], case["k_pool"]
    B, H, D = q.shape
    _, BS, Hkv, _ = kp.shape
    MB = case["block_tables"].shape[1]
    ks, vs = case.get("k_scale"), case.get("v_scale")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.paged_decode(
            q.data_ptr(), kp.data_ptr(), case["v_pool"].data_ptr(),
            ks.data_ptr() if ks is not None else None, vs.data_ptr() if vs is not None else None,
            case["block_tables"].data_ptr(), case["context_lens"].data_ptr(), out.data_ptr(),
            B, H, Hkv, D, BS, MB, 1.0 / D ** 0.5,
            _kernels.dtype_code(q.dtype), _kernels.dtype_code(kp.dtype), stream,
        )
        _kernels.check("paged_decode", rc)
        return out

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
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            valid.data_ptr(), *(o.data_ptr() for o in outs), *dims, 1, 1.0 / D ** 0.5,
            _kernels.dtype_code(q.dtype), stream,
        )
        _kernels.check(entry, rc)
        return outs

    return call


def ab_times(chip_smoke, calls, iters):
    """ms per launch in the order baseline, current, current, baseline."""
    times = {"baseline": [], "current": []}
    for name in ("baseline", "current", "current", "baseline"):
        times[name].append(chip_smoke.cuda_time_ms(calls[name], iters=iters, warmup=10))
    return times


def run_paged_decode(chip_smoke, libs, smi, args):
    import torch

    dev = torch.device("cuda")
    ok = True
    for quant in (False, True):
        gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1)
        case = chip_smoke.paged_case(torch, gen, B=256, H=12, Hkv=12, D=64, BS=16, MB=16, quant=quant, dev=dev)
        calls = {name: launcher(lib, case) for name, lib in libs.items()}
        same = torch.equal(calls["baseline"]().clone(), calls["current"]().clone())
        times = ab_times(chip_smoke, calls, args.iters)
        ok = ok and same
        print(json.dumps({"kernel": "paged_decode", "kv": "int8" if quant else "bf16", "card": smi,
                          "shape": "B=256 H=12 D=64 BS=16 MB=16", "iters": args.iters,
                          "baseline_src": str(args.baseline_src), "outputs_equal": same,
                          "baseline_ms": times["baseline"], "current_ms": times["current"]}), flush=True)
    return ok


def run_flash_bwd(chip_smoke, libs, smi, args):
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
                base = [x.clone() for x in calls["baseline"]()]
                cur = [x.clone() for x in calls["current"]()]
                ref = chip_smoke.as_tuple(plain[entry](q, k, v, valid, out, lse, g))
                torch.cuda.synchronize()
                row = {"kernel": entry, "dtype": str(dtype), "card": smi,
                       "shape": f"B={B} H=12 T=S={T} D=64 causal, P={P} left-padded + R={R} right-padded",
                       "baseline_src": str(args.baseline_src),
                       "max_abs_diff_to_baseline": max((a.float() - b.float()).abs().max().item()
                                                       for a, b in zip(base, cur))}
                if dtype == torch.float32:
                    row["outputs_equal"] = all(torch.equal(a, b) for a, b in zip(base, cur))
                    ok = ok and row["outputs_equal"]
                else:
                    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(cur, ref)]
                    tols = [chip_smoke.TOL["bfloat16"] * max(1.0, b.float().abs().max().item()) for b in ref]
                    row.update(max_abs_err=max(errs), tol=max(tols),
                               within_tol=all(e <= t for e, t in zip(errs, tols)))  # a NaN fails here
                    ok = ok and row["within_tol"]
                    times = ab_times(chip_smoke, calls, args.iters)
                    row.update(iters=args.iters, baseline_ms=times["baseline"], current_ms=times["current"],
                               speedup=sum(times["baseline"]) / sum(times["current"]))
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
    run = run_paged_decode if args.kernel == "paged_decode" else run_flash_bwd
    return 0 if run(chip_smoke, libs, smi, args) else 1


if __name__ == "__main__":
    sys.exit(main())
