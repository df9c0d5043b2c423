#!/usr/bin/env python3
"""The paged decode kernel (K4) of this checkout against another revision's,
on one CUDA card, in one process.

Builds ``--baseline-src`` (a ``paged_decode.cu`` of another revision, with
the same ``paged_decode`` C entry point) with the package's nvcc flags into
``trlx_tpu_torch/_build/``, and this checkout's source as the package
builds it. Then, at chip_smoke.py's K4 timing shape (B=256 slots, H=12,
D=64, BS=16, MB=16, bf16 and int8 KV, the same seeded case for both), it
checks that both give the same output bit for bit and times them with CUDA
events in the order baseline, current, current, baseline. Prints the
``nvidia-smi`` line and one JSON object per KV layout.

Usage: ``python3 scripts/torch_paged_decode_ab.py --baseline-src PATH
[--iters N]`` from the repository root. Exits non-zero without a CUDA
device or when the outputs differ.
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


def build_baseline(src: Path) -> ctypes.CDLL:
    """Compile ``src`` with the package's flags into the build directory
    (named after its hash) and load it with ``paged_decode`` typed."""
    from trlx_tpu_torch.ops import _kernels

    digest = hashlib.sha1(src.read_bytes() + " ".join(_kernels.NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _kernels.BUILD_DIR / f"libpaged_decode_baseline-{digest}.so"
    if not out.exists():
        _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.paged_decode.argtypes = _kernels.KERNELS["paged_decode"][2]
    lib.paged_decode.restype = ctypes.c_int
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-src", required=True, type=Path)
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
    libs = {"baseline": build_baseline(args.baseline_src.resolve()), "current": _kernels.library("paged_decode")}
    dev = torch.device("cuda")
    ok = True
    for quant in (False, True):
        gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1)
        case = chip_smoke.paged_case(torch, gen, B=256, H=12, Hkv=12, D=64, BS=16, MB=16, quant=quant, dev=dev)
        calls = {name: launcher(lib, case) for name, lib in libs.items()}
        same = torch.equal(calls["baseline"]().clone(), calls["current"]().clone())
        times = {"baseline": [], "current": []}
        for name in ("baseline", "current", "current", "baseline"):
            times[name].append(chip_smoke.cuda_time_ms(calls[name], iters=args.iters, warmup=10))
        ok = ok and same
        print(json.dumps({"kernel": "paged_decode", "kv": "int8" if quant else "bf16", "card": smi,
                          "shape": "B=256 H=12 D=64 BS=16 MB=16", "iters": args.iters,
                          "baseline_src": str(args.baseline_src), "outputs_equal": same,
                          "baseline_ms": times["baseline"], "current_ms": times["current"]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
