"""Build, load and count the package's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point. It is
compiled by ``nvcc`` into its own shared library under ``_build/`` (listed
in ``.gitignore``) the first time a CUDA tensor reaches its wrapper, and
loaded with :mod:`ctypes`. Nothing here runs at import: the package imports
on a host with no CUDA toolkit, and the CPU paths never build anything.

A library is named after the hash of its source, so an edited kernel is
rebuilt and an unchanged one is reused within a checkout. ``build()``
starts one ``nvcc`` per missing source, all at once, and waits for all of
them. A failed build raises; there is no fallback.

``LAUNCHES`` counts kernel launches per kernel name. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels (``reset_launches`` / ``launches``).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

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
    "paged_decode": (
        "paged_decode.cu", "paged_decode",
        # q, k_pool, v_pool, k_scale, v_scale, tables, lens, out,
        # B, H, Hkv, D, BS, MB, scale, q_dtype, kv_dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
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
#: nvcc's output per built kernel (``-Xptxas=-v``: registers, shared memory, spills)
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def count_launch(name: str) -> None:
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


def _lib_path(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every requested kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns seconds per kernel built."""
    names = list(KERNELS if names is None else names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    seconds, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
        logger.info(f"built {out.name} in {seconds[name]:.1f}s")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, KERNELS[name][1])
            fn.argtypes = KERNELS[name][2]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(name: str, rc: int) -> None:
    """Raise when a C entry point reported a CUDA error (launch refused, bad
    configuration): such a launch never ran, and a later synchronize would
    not report it."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
