#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors, with two ranks sharing one card.

Usage: ``python3 scripts/torch_gloo_cuda_probe.py`` on a host with a CUDA
device. Two processes join a gloo group on 127.0.0.1; each tries every
collective the port uses (all-reduce, broadcast, all-gather,
reduce-scatter, send / recv) on a CUDA tensor and checks the result.
Prints one JSON line: the torch version and, per collective, "ok", "wrong"
or the error. The port stages every gloo collective on a CUDA tensor
through host memory whatever this says (``trlx_tpu_torch/parallel/
collectives.py``): the probe records what gloo itself would take.
"""

import json
import os
import socket
import sys


def rank_main(rank: int, port: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    x = torch.arange(4, dtype=torch.float32, device=dev) + rank
    cases = {}

    def attempt(name, fn, expect):
        try:
            got = fn()
            torch.cuda.synchronize()
            cases[name] = "ok" if torch.equal(got.cpu(), expect) else "wrong"
        except Exception as e:  # noqa: BLE001 - the probe records whatever gloo raises
            cases[name] = f"{type(e).__name__}: {str(e)[:160]}"

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t)
        return t

    def broadcast():
        t = x.clone()
        dist.broadcast(t, src=0)
        return t

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def reduce_scatter():
        out_t = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out_t, x)
        return out_t

    def send_recv():
        t = x.clone()
        if rank == 0:
            dist.send(t, dst=1)
            return torch.arange(4, dtype=torch.float32)
        dist.recv(t, src=0)
        return t

    base = torch.arange(4, dtype=torch.float32)
    attempt("all_reduce", all_reduce, 2 * base + 1)
    attempt("broadcast", broadcast, base)
    attempt("all_gather", all_gather, torch.cat([base, base + 1]))
    attempt("reduce_scatter", reduce_scatter, (2 * base + 1)[2 * rank:2 * rank + 2])
    attempt("send_recv", send_recv, base)
    with open(f"{out}.{rank}", "w") as f:
        json.dump(cases, f)
    dist.destroy_process_group()


def main() -> int:
    import subprocess
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(tempfile.mkdtemp(prefix="gloo_probe_"), "r")
    here = os.path.abspath(__file__)
    code = (f"import importlib.util, sys; spec = importlib.util.spec_from_file_location('probe', {here!r}); "
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
            f"m.rank_main(int(sys.argv[1]), {port}, {out!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    result = {"torch": torch.__version__, "cuda": torch.version.cuda, "rcs": rcs}
    for r in range(2):
        if os.path.exists(f"{out}.{r}"):
            with open(f"{out}.{r}") as f:
                result[f"rank{r}"] = json.load(f)
    print(json.dumps(result), flush=True)
    return 0 if rcs == [0, 0] else 1


if __name__ == "__main__":
    sys.exit(main())
