"""Host data plane: padded collation and stop-sequence scans in C++.

``csrc/data_plane.cpp`` holds ``pad_collate_i32``, ``pad_collate_f32`` and
``find_stop_positions`` as plain C entry points. The first call of any of
them compiles it with ``g++ -O3 -shared -fPIC`` into ``_build/`` (listed in
``.gitignore``), named after the hash of the source, and loads it with
:mod:`ctypes`. A failed build raises with the compiler's output: there is no
fallback, so a run that returns went through the library.

The numpy functions ``plain_*`` define the semantics (those of the JAX
package's ``trlx_tpu/native``); the tests hold the library against them.
``CALLS`` counts calls per function, as ``ops/_kernels.py::LAUNCHES``
counts kernel launches (:func:`reset_calls` / :func:`calls`).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "data_plane.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
#: entry point -> argtypes
_ENTRIES = {
    # rows, offsets, lengths, batch, target_len, pad_value, pad_left, out, mask
    "pad_collate_i32": [_P, _P, _P, _I64, _I64, ctypes.c_int32, ctypes.c_int, _P, _P],
    # rows, offsets, lengths, batch, target_len, pad_value, pad_left, out
    "pad_collate_f32": [_P, _P, _P, _I64, _I64, ctypes.c_float, ctypes.c_int, _P],
    # seqs, batch, seq_len, stops, stop_offsets, stop_lens, n_stops, out
    "find_stop_positions": [_P, _I64, _I64, _P, _P, _P, _I64, _P],
}

CALLS: Dict[str, int] = {name: 0 for name in _ENTRIES}

_lock = threading.Lock()  # the build, and the counts (learner and rollout producer both collate)
_lib = None


def reset_calls() -> None:
    with _lock:
        for name in CALLS:
            CALLS[name] = 0


def calls() -> Dict[str, int]:
    with _lock:
        return dict(CALLS)


def lib_path(source: Path = SOURCE) -> Path:
    """The library built from ``source``: named after the hash of the
    source and the flags, so an edited source is rebuilt."""
    h = hashlib.sha1(source.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def build(source: Path = SOURCE, cxx: str = None, what: str = "host data plane") -> Path:
    """Compile ``source`` (``what`` names it in errors) into its library
    unless it exists; raise with the compiler's output when the build fails."""
    out = lib_path(source)
    if out.exists():
        return out
    cxx = cxx or os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"no C++ compiler (g++) to build the {what} from {source}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{what} build failed: could not run {cxx}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{what} build failed ({cxx} exited {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return out


def library() -> ctypes.CDLL:
    """The loaded data-plane library, built first if missing."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = lib
        return _lib


def _count(name: str) -> None:
    with _lock:
        CALLS[name] += 1


def _ragged(rows: Sequence[np.ndarray], dtype) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(flat contiguous data, offsets, lengths) of ragged rows."""
    rows = [np.asarray(r, dtype).reshape(-1) for r in rows]
    lengths = np.asarray([len(r) for r in rows], np.int64)
    offsets = np.zeros(len(rows), np.int64)
    if len(rows) > 1:
        np.cumsum(lengths[:-1], out=offsets[1:])
    flat = np.ascontiguousarray(np.concatenate(rows) if rows else np.zeros(0), dtype)
    return flat, offsets, lengths


def pad_collate_i32(
    rows: Sequence[np.ndarray], target_len: int, pad_value: int, pad_left: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ragged int32 rows to [B, target_len] + int32 0/1 mask. Rows
    longer than ``target_len`` keep their last (left pad) or first (right
    pad) tokens."""
    lib = library()
    flat, offsets, lengths = _ragged(rows, np.int32)
    B = len(lengths)
    out = np.empty((B, target_len), np.int32)
    mask = np.empty((B, target_len), np.int32)
    lib.pad_collate_i32(flat.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, B, int(target_len),
                        int(pad_value), int(bool(pad_left)), out.ctypes.data, mask.ctypes.data)
    _count("pad_collate_i32")
    return out, mask


def pad_collate_f32(
    rows: Sequence[np.ndarray], target_len: int, pad_value: float = 0.0, pad_left: bool = False
) -> np.ndarray:
    """Pad ragged float32 rows to [B, target_len]."""
    lib = library()
    flat, offsets, lengths = _ragged(rows, np.float32)
    B = len(lengths)
    out = np.empty((B, target_len), np.float32)
    lib.pad_collate_f32(flat.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, B, int(target_len),
                        float(pad_value), int(bool(pad_left)), out.ctypes.data)
    _count("pad_collate_f32")
    return out


def find_stop_positions(seqs: np.ndarray, stop_token_seqs: Sequence[Sequence[int]]) -> np.ndarray:
    """First start index of any stop token-sequence per row; seq_len if none."""
    lib = library()
    seqs = np.ascontiguousarray(seqs, np.int32)
    B, T = seqs.shape
    flat, offsets, lengths = _ragged([s for s in stop_token_seqs if len(s) > 0], np.int32)
    out = np.empty(B, np.int64)
    lib.find_stop_positions(seqs.ctypes.data, B, T, flat.ctypes.data, offsets.ctypes.data, lengths.ctypes.data,
                            len(lengths), out.ctypes.data)
    _count("find_stop_positions")
    return out


# -- the plain versions (numpy) ------------------------------------------------


def plain_pad_collate_i32(
    rows: Sequence[np.ndarray], target_len: int, pad_value: int, pad_left: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """numpy version of :func:`pad_collate_i32`."""
    B = len(rows)
    out = np.full((B, target_len), pad_value, np.int32)
    mask = np.zeros((B, target_len), np.int32)
    for i, r in enumerate(rows):
        r = np.asarray(r, np.int32)
        r = r[len(r) - target_len:] if pad_left and len(r) > target_len else r[:target_len]
        if pad_left:
            out[i, target_len - len(r):] = r
            mask[i, target_len - len(r):] = 1
        else:
            out[i, : len(r)] = r
            mask[i, : len(r)] = 1
    return out, mask


def plain_pad_collate_f32(
    rows: Sequence[np.ndarray], target_len: int, pad_value: float = 0.0, pad_left: bool = False
) -> np.ndarray:
    """numpy version of :func:`pad_collate_f32`."""
    B = len(rows)
    out = np.full((B, target_len), pad_value, np.float32)
    for i, r in enumerate(rows):
        r = np.asarray(r, np.float32)
        r = r[len(r) - target_len:] if pad_left and len(r) > target_len else r[:target_len]
        if pad_left:
            out[i, target_len - len(r):] = r
        else:
            out[i, : len(r)] = r
    return out


def plain_find_stop_positions(seqs: np.ndarray, stop_token_seqs: Sequence[Sequence[int]]) -> np.ndarray:
    """numpy version of :func:`find_stop_positions`."""
    seqs = np.ascontiguousarray(seqs, np.int32)
    B, T = seqs.shape
    stops = [np.asarray(s, np.int32) for s in stop_token_seqs if len(s) > 0]
    out = np.full(B, T, np.int64)
    for i in range(B):
        row = seqs[i]
        for pat in stops:
            m = len(pat)
            for j in range(0, T - m + 1):
                if int(out[i]) <= j:
                    break
                if np.array_equal(row[j : j + m], pat):
                    out[i] = min(out[i], j)
                    break
    return out
