"""The census on a mesh: one process per rank, each measuring its own steps.

:func:`run_group` starts ``n`` processes of this module under the launch
contract of :func:`~trlx_tpu_torch.parallel.mesh.initialize_distributed`
(``TRLX_NUM_PROCESSES``, ``TRLX_COORDINATOR`` on 127.0.0.1,
``TRLX_PROCESS_ID``). Each rank joins the process group (gloo on the CPU,
and where ranks share a card), builds the requested entries on the mesh
(``shared["mesh"]``), measures each with
:func:`~trlx_tpu_torch.analysis.census.measure.measure` (on the card the
CUPTI counts of its own process) and writes its censuses as JSON. A rank
that exits non-zero stops the group and raises with its log.

:func:`merge` holds the ranks to one SPMD program: every count of every
rank must equal rank 0's, or it raises :class:`RanksDiffer`. The merged
census keeps rank 0's counts, the mesh, and every rank's ``peak_bytes``.

Usage (the CLI runs it): ``python -m trlx_tpu_torch.analysis.census --mesh
[--device cpu]``.
"""

import ctypes
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

#: the directory that holds the ``trlx_tpu_torch`` package (the ranks' import path)
PACKAGE_ROOT = Path(__file__).resolve().parents[3]
#: a rank group's default time limit, seconds
TIMEOUT_S = 900.0
#: fields that may differ between ranks (each rank's own memory and time)
PER_RANK = ("peak_bytes", "seconds")


class RanksDiffer(RuntimeError):
    """The ranks' counts are not those of one SPMD program."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(mesh: Dict[str, int], jobs: Sequence[Tuple[str, str, Optional[str]]], device: str = "cpu",
              size: str = "tiny", timeout: float = TIMEOUT_S) -> List[Dict[str, Dict]]:
    """Measure ``jobs`` (``(entry name, key suffix, seed or None)``, in
    order) on one process per rank of ``mesh`` (axis sizes); returns each
    rank's ``{key: census}`` (key ``name@<device><suffix>``, with
    ``#<seed>`` after a seeded job's). Every rank process is stopped before
    it returns."""
    n = 1
    for size_ in mesh.values():
        n *= int(size_)
    tmp = Path(tempfile.mkdtemp(prefix="census_ranks_"))
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"mesh": mesh, "jobs": [list(j) for j in jobs], "device": device, "size": size}))
    port = _free_port()
    pythonpath = os.pathsep.join(p for p in (str(PACKAGE_ROOT), os.environ.get("PYTHONPATH")) if p)
    procs: List[subprocess.Popen] = []
    try:
        for rank in range(n):
            env = dict(os.environ, PYTHONPATH=pythonpath, TRLX_NUM_PROCESSES=str(n),
                       TRLX_COORDINATOR=f"127.0.0.1:{port}", TRLX_PROCESS_ID=str(rank),
                       OMP_NUM_THREADS="1", TRLX_CENSUS_LAUNCHER=str(os.getpid()))
            with open(tmp / f"rank{rank}.log", "w") as log:
                procs.append(subprocess.Popen([sys.executable, "-m", __name__, str(spec), str(tmp)], env=env,
                                              stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, rc in enumerate(codes) if rc not in (None, 0)]
            if not failed and None not in codes:
                break
            if failed or time.monotonic() > deadline:
                r = failed[0] if failed else codes.index(None)
                what = f"exited {codes[r]}" if failed else f"did not finish in {timeout:.0f}s"
                log = (tmp / f"rank{r}.log").read_text()
                raise RuntimeError(f"census rank {r}/{n} on mesh {mesh} {what}:\n{log[-4000:]}")
            time.sleep(0.1)
        return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(n)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def merge(per_rank: List[Dict[str, Dict]], mesh: Dict[str, int]) -> Dict[str, Dict]:
    """One census per key from every rank's: rank 0's counts (each rank's
    must be equal, else :class:`RanksDiffer`), the mesh, and every rank's
    ``peak_bytes``."""
    out: Dict[str, Dict] = {}
    for key, first in per_rank[0].items():
        ms = [r[key] for r in per_rank]
        differ = sorted(f for f in set().union(*ms) if f not in PER_RANK and any(m.get(f) != first.get(f) for m in ms))
        if differ:
            detail = {f: [m.get(f) for m in ms] for f in differ}
            raise RanksDiffer(f"{key}: the ranks' {', '.join(differ)} differ (one SPMD program counts the same "
                              f"on every rank): {json.dumps(detail)[:2000]}")
        merged = dict(first, mesh=dict(mesh), seconds=max(m["seconds"] for m in ms))
        if "peak_bytes" in first:
            merged["peak_bytes"] = [m["peak_bytes"] for m in ms]
        out[key] = merged
    return out


def _die_with_launcher() -> None:
    """Have the kernel kill this rank when its launcher dies (Linux's
    ``PR_SET_PDEATHSIG``), so a killed launcher leaves no rank behind."""
    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):
        return
    prctl.argtypes, prctl.restype = [ctypes.c_int, ctypes.c_ulong], ctypes.c_int
    prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    launcher = os.environ.get("TRLX_CENSUS_LAUNCHER")
    if launcher is not None and str(os.getppid()) != launcher:
        os._exit(1)  # the launcher died before the request


def rank_main(spec_path: str, out_dir: str) -> None:
    """A rank's body: join the group, measure every job, write the result."""
    _die_with_launcher()
    import torch

    from trlx_tpu_torch.analysis.census import seeds
    from trlx_tpu_torch.analysis.census.entrypoints import load_all
    from trlx_tpu_torch.analysis.census.measure import measure
    from trlx_tpu_torch.parallel import mesh as mesh_lib

    spec = json.loads(Path(spec_path).read_text())
    device = spec["device"]
    if device == "cpu":
        torch.set_num_threads(1)
    mesh_lib.initialize_distributed(device=device)
    rank = mesh_lib.process_index()
    dev = torch.device("cpu") if device == "cpu" else mesh_lib.rank_device(rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    registry = load_all()
    shared = {"mesh": spec["mesh"]}
    results: Dict[str, Dict] = {}
    try:
        for name, suffix, seed in spec["jobs"]:
            if seed:
                os.environ[seeds.ENV_VAR] = seed
            try:
                t0 = time.perf_counter()
                m = measure(registry[name].factory(dev, spec["size"], shared), dev)
            finally:
                if seed:
                    del os.environ[seeds.ENV_VAR]
            m["seconds"] = time.perf_counter() - t0
            results[f"{name}@{dev.type}{suffix}" + (f"#{seed}" if seed else "")] = m
            print(f"[census rank {rank}] {name}{suffix} {seed or ''}: {m['seconds']:.1f}s", flush=True)
    finally:
        shared.clear()
    out = Path(out_dir) / f"rank{rank}.json"
    tmp = out.with_suffix(".tmp")
    tmp.write_text(json.dumps(results))
    os.replace(tmp, out)
    import torch.distributed as dist

    if dist.is_initialized():  # every rank done before any tears its connections down
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(sys.argv[1], sys.argv[2])
