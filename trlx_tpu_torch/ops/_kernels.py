"""Build, load and count the package's hand-written CUDA kernels.

Each kernel is a plain C entry point in a ``csrc/*.cu`` file (one file may
hold several: ``flash_bwd.cu`` holds dK/dV and dQ, ``paged_decode.cu`` the
paged decode and verify entry points of one kernel body). A source is compiled
by ``nvcc`` into its own shared library under ``_build/`` (listed in
``.gitignore``) the first time a CUDA tensor reaches one of its wrappers,
and loaded with :mod:`ctypes`. Nothing here runs at import: the package
imports on a host with no CUDA toolkit, and the CPU paths never build
anything.

A library is named after the hash of its source and of the headers it
includes (``mma_sm90.cuh``), so an edited kernel or header is rebuilt and
an unchanged one is reused within a checkout. ``build()``
starts one ``nvcc`` per missing source, all at once, and waits for all of
them. A failed build raises; there is no fallback.

``LAUNCHES`` counts kernel launches per kernel name. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels (``reset_launches`` / ``launches``).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: kernel name -> (source file, C entry point, argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "flash_fwd": (
        "flash_fwd.cu", "flash_fwd",
        # q, k, v, kv_valid, o, lse, B, H, Hkv, T, S, D, causal, scale, dtype, stream
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    "flash_bwd_dkv": (
        "flash_bwd.cu", "flash_bwd_dkv",
        # q, k, v, dout, lse, delta, kv_valid, dk, dv, B, H, Hkv, T, S, D, causal, scale, dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    "flash_bwd_dq": (
        "flash_bwd.cu", "flash_bwd_dq",
        # q, k, v, dout, lse, delta, kv_valid, dq, B, H, Hkv, T, S, D, causal, scale, dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    "paged_decode": (
        "paged_decode.cu", "paged_decode",
        # q, k_pool, v_pool, k_scale, v_scale, tables, lens, out,
        # B, H, Hkv, D, BS, MB, scale, q_dtype, kv_dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    ),
    "paged_verify": (
        "paged_decode.cu", "paged_verify",
        # q, k_pool, v_pool, k_scale, v_scale, tables, lens, out,
        # B, Q, H, Hkv, D, BS, MB, scale, q_dtype, kv_dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    ),
}

#: dtype codes shared with the C entry points
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2}


def dtype_code(dtype) -> int:
    """The C entry points' code for a torch dtype (``torch.bfloat16`` -> 1)."""
    return DTYPE_CODES[str(dtype).rsplit(".", 1)[-1]]


NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
#: nvcc's output per built source stem (``-Xptxas=-v``: registers, shared memory, spills)
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_count_lock = threading.Lock()  # the learner and the rollout producer both launch
_libs: Dict[str, ctypes.CDLL] = {}  # source file -> loaded library
_bound: set = set()  # kernel names whose entry point has its argtypes set


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        f"{CSRC} at first use and need the CUDA toolkit"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(src: Path) -> List[Path]:
    """``src`` and every file it ``#include``s by quotes from its own
    directory, transitively, in a fixed order."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.exists():
            continue
        seen.append(path)
        todo += [path.parent / name.decode() for name in _INCLUDE.findall(path.read_bytes())]
    return seen


def _lib_path(source: str, csrc: Optional[Path] = None) -> Path:
    """The library of ``source`` (under ``csrc``, default :data:`CSRC`),
    named after the hash of the source, the headers it includes and the
    flags: an edited header rebuilds every source that includes it."""
    src = (csrc or CSRC) / source
    h = hashlib.sha1()
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the source of every requested kernel whose library is
    missing, one ``nvcc`` per source, all started together. Returns seconds
    per source built (keyed by its stem)."""
    names = list(KERNELS if names is None else names)
    todo = sorted({KERNELS[n][0] for n in names if not _lib_path(KERNELS[n][0]).exists()})
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for source in todo:
        out = _lib_path(source)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[Path(source).stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    seconds, failures = {}, []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[stem] = time.perf_counter() - t0
        BUILD_LOG[stem] = log
        if proc.returncode != 0:
            failures.append(f"{stem}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
        logger.info(f"built {out.name} in {seconds[stem]:.1f}s")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library holding kernel ``name``, built first if missing,
    with the kernel's entry point typed."""
    source, entry, argtypes = KERNELS[name]
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(source)))
            _libs[source] = lib
        if name not in _bound:
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _bound.add(name)
        return lib


def check(name: str, rc: int) -> None:
    """Raise when a C entry point reported a CUDA error (launch refused, bad
    configuration): such a launch never ran, and a later synchronize would
    not report it."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
