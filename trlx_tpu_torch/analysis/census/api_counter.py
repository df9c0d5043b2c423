"""Exact counts of the CUDA API calls a step makes, from CUPTI's callback API.

``torch.profiler`` reads CUPTI's device activity records, which are buffered
and can be dropped: a kernel count taken from a profiler window varied by
one to 25 kernels from window to window. CUPTI's callback API instead calls
``census_callback`` (``csrc/api_counter.cpp``, built with g++ at first use
as the data plane is) at the entry of every runtime and driver API call,
synchronously, in the thread that makes it. A launch is counted when it is
made, so the count is exact.

:func:`counting` yields a dict that it fills on exit with the calls made
inside the block, from any thread of the process. A runtime call reaches
the device through the driver, and CUPTI reports the driver calls the
runtime makes too (a ``cudaLaunchKernel`` shows as a ``cuLaunchKernel``
inside it), while libraries such as cuBLAS call the driver directly. So
the driver's calls are the ones counted, each launch once:

- ``launches``: the driver's kernel launches (``cuLaunchKernel``,
  ``cuLaunchKernelEx`` and their variants, :data:`LAUNCH_APIS`);
- ``graph_launches``: CUDA-graph launches (kernels the host does not see);
- ``syncs``: the driver's synchronizing calls (``cu*Synchronize``);
- ``memcpys``: the driver's copy and set calls (``cuMemcpy*``, ``cuMemset*``);
- ``launch_apis``: the driver's launches per API function;
- ``runtime_launches``: the runtime's launches (``cudaLaunchKernel`` and its
  variants), each also among ``launches``.

A process has one CUPTI subscriber. The first :func:`counting` subscribes
and the subscription lasts as long as the process. A process that has run
``torch.profiler`` already holds it, and then :func:`counting` raises: the
census runs in a process of its own.
"""

import contextlib
import ctypes
import glob
import os
import re
import sys
import threading
from pathlib import Path
from typing import Dict, Iterator

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "api_counter.cpp"

_DRIVER, _RUNTIME = 1, 2  # CUpti_CallbackDomain
#: the driver functions that launch one kernel, version and per-thread-stream suffixes stripped
LAUNCH_APIS = frozenset({
    "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel", "cuLaunchCooperativeKernelMultiDevice",
    "cuLaunch", "cuLaunchGrid", "cuLaunchGridAsync",
})
RUNTIME_LAUNCH_APIS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cudaLaunchCooperativeKernelMultiDevice", "cudaLaunch",
})
_SUFFIX = re.compile(r"(_v\d+|_pt(sz|ds))+$")

_lock = threading.Lock()
_state: Dict[str, object] = {}  # the counter library and the subscription, once per process


def api_name(name: str) -> str:
    """``cudaLaunchKernel_ptsz`` -> ``cudaLaunchKernel``."""
    return _SUFFIX.sub("", name)


def summarize(calls: Dict[str, int]) -> Dict[str, object]:
    """Launch, sync and copy counts of ``{API function: calls}`` (both
    domains: runtime functions are named ``cuda*``, the driver's ``cu*``)."""
    out = {"launches": 0, "graph_launches": 0, "syncs": 0, "memcpys": 0, "launch_apis": {}, "runtime_launches": 0}
    for raw, n in calls.items():
        name = api_name(raw)
        if name.startswith("cuda"):
            if name in RUNTIME_LAUNCH_APIS:
                out["runtime_launches"] += n
            continue
        if name in LAUNCH_APIS:
            out["launches"] += n
            out["launch_apis"][name] = out["launch_apis"].get(name, 0) + n
        elif name == "cuGraphLaunch":
            out["graph_launches"] += n
        elif "Synchronize" in name:
            out["syncs"] += n
        elif name.startswith(("cuMemcpy", "cuMemset")):
            out["memcpys"] += n
    return out


def counter_library() -> ctypes.CDLL:
    """The callback library, built first if missing."""
    from trlx_tpu_torch import native

    lib = ctypes.CDLL(str(native.build(SOURCE, what="CUDA API counter")))
    lib.census_callback.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p]
    lib.census_callback.restype = None
    lib.census_reset.restype = None
    lib.census_ids.restype = ctypes.c_uint32
    lib.census_snapshot.argtypes = [ctypes.c_void_p]
    lib.census_snapshot.restype = None
    lib.census_name.argtypes = [ctypes.c_int, ctypes.c_uint32]
    lib.census_name.restype = ctypes.c_char_p
    lib.census_out_of_range.restype = ctypes.c_longlong
    return lib


def read(lib: ctypes.CDLL) -> Dict[str, int]:
    """``{API function: calls}`` since the last ``census_reset``."""
    ids = lib.census_ids()
    counts = np.zeros(2 * ids, np.int64)
    lib.census_snapshot(counts.ctypes.data)
    out: Dict[str, int] = {}
    for flat in np.flatnonzero(counts):
        domain, cbid = int(flat) // ids + 1, int(flat) % ids
        name = (lib.census_name(domain, cbid) or b"?").decode()
        out[name] = out.get(name, 0) + int(counts[flat])
    lost = lib.census_out_of_range()
    if lost:
        raise RuntimeError(f"{lost} API call(s) had a callback id beyond the counter's {ids}: raise kIds in {SOURCE}")
    return out


def _load_cupti() -> ctypes.CDLL:
    """libcupti: the one torch loaded, else torch's wheel's, else the toolkit's."""
    import torch

    major = (torch.version.cuda or "12").split(".")[0]
    candidates = [f"libcupti.so.{major}", "libcupti.so"]
    for entry in sys.path:
        candidates += sorted(glob.glob(os.path.join(entry, "nvidia", "cuda_cupti", "lib", "libcupti.so*")))
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidates += sorted(glob.glob(os.path.join(home, "extras", "CUPTI", "lib64", "libcupti.so*")))
    errors = []
    for cand in candidates:
        try:
            return ctypes.CDLL(cand)
        except OSError as e:
            errors.append(f"{cand}: {e}")
    raise RuntimeError("CUPTI (libcupti) not found; tried:\n  " + "\n  ".join(errors))


def _check(cupti: ctypes.CDLL, result: int, what: str) -> None:
    if result != 0:
        msg = ctypes.c_char_p()
        cupti.cuptiGetResultString(result, ctypes.byref(msg))
        hint = " (is torch.profiler running in this process?)" if what == "cuptiSubscribe" else ""
        raise RuntimeError(f"{what} failed: CUPTI error {result} {(msg.value or b'').decode()}{hint}")


def _subscribed() -> ctypes.CDLL:
    with _lock:
        if not _state:
            lib = counter_library()
            cupti = _load_cupti()
            handle = ctypes.c_void_p()
            callback = ctypes.cast(lib.census_callback, ctypes.c_void_p)
            cupti.cuptiSubscribe.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p]
            cupti.cuptiEnableDomain.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int]
            cupti.cuptiGetResultString.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]
            _check(cupti, cupti.cuptiSubscribe(ctypes.byref(handle), callback, None), "cuptiSubscribe")
            for domain in (_DRIVER, _RUNTIME):
                _check(cupti, cupti.cuptiEnableDomain(1, handle, domain), "cuptiEnableDomain")
            _state.update(lib=lib, cupti=cupti, handle=handle)
        return _state["lib"]


@contextlib.contextmanager
def counting() -> Iterator[Dict[str, object]]:
    """Count the CUDA API calls made inside the block (see the module
    docstring); the yielded dict is filled on exit."""
    lib = _subscribed()
    lib.census_reset()
    out: Dict[str, object] = {}
    try:
        yield out
    finally:
        out.update(summarize(read(lib)))
