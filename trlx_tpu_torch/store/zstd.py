"""zstd through the system library ``libzstd.so.1``, bound with ``ctypes``.

The converted store compresses twice with zstd: OCDBT manifests and nodes,
and zarr chunks. :func:`decompress` reads any frame, with or without its
content size in the header (tensorstore writes streaming frames without
one); :func:`compress` writes one frame at a level. When the library does
not load, :func:`available` is False and every call raises
:class:`ZstdUnavailable`, naming the library: nothing carries on without it.
"""

import ctypes
import threading
from typing import Optional

LIBRARY = "libzstd.so.1"
#: ZSTD_CONTENTSIZE_UNKNOWN / ZSTD_CONTENTSIZE_ERROR
_UNKNOWN = (1 << 64) - 1
_ERROR = (1 << 64) - 2


class ZstdUnavailable(RuntimeError):
    """libzstd could not be loaded."""


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_LOCK = threading.Lock()
_LIB = None
_LOAD_ERROR: Optional[str] = None


def _load():
    global _LIB, _LOAD_ERROR
    with _LOCK:
        if _LIB is not None or _LOAD_ERROR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            _LOAD_ERROR = str(e)
            return None
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_versionString.restype = ctypes.c_char_p
        lib.ZSTD_isError.argtypes = [size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getFrameContentSize.argtypes = [vp, size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_decompress.argtypes = [vp, size_t, vp, size_t]
        lib.ZSTD_decompress.restype = size_t
        lib.ZSTD_compressBound.argtypes = [size_t]
        lib.ZSTD_compressBound.restype = size_t
        lib.ZSTD_compress.argtypes = [vp, size_t, vp, size_t, ctypes.c_int]
        lib.ZSTD_compress.restype = size_t
        lib.ZSTD_createDCtx.restype = vp
        lib.ZSTD_freeDCtx.argtypes = [vp]
        lib.ZSTD_DStreamOutSize.restype = size_t
        lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)]
        lib.ZSTD_decompressStream.restype = size_t
        _LIB = lib
        return lib


def available() -> bool:
    """Whether libzstd loads."""
    return _load() is not None


def version() -> Optional[str]:
    """libzstd's version string, or None when it does not load."""
    lib = _load()
    return lib.ZSTD_versionString().decode() if lib is not None else None


def _lib():
    lib = _load()
    if lib is None:
        raise ZstdUnavailable(f"zstd needs the system library {LIBRARY}, which did not load: {_LOAD_ERROR}")
    return lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what} failed: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data: bytes, level: int = 1) -> bytes:
    """One zstd frame of ``data`` (its content size in the header)."""
    lib = _lib()
    data = bytes(data)
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = _check(lib, lib.ZSTD_compress(out, cap, data, len(data), level), "compress")
    return out.raw[:n]


def decompress(data: bytes) -> bytes:
    """The content of the zstd frame ``data``."""
    lib = _lib()
    data = bytes(data)
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _ERROR:
        raise ValueError("zstd decompress failed: not a zstd frame")
    if size != _UNKNOWN:
        out = ctypes.create_string_buffer(max(int(size), 1))
        n = _check(lib, lib.ZSTD_decompress(out, int(size), data, len(data)), "decompress")
        return out.raw[:n]
    # a streaming frame: decode it chunk by chunk
    dctx = lib.ZSTD_createDCtx()
    try:
        src = ctypes.create_string_buffer(data, len(data))
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        step = int(lib.ZSTD_DStreamOutSize())
        buf = ctypes.create_string_buffer(step)
        parts = []
        while True:
            outb = _OutBuffer(ctypes.cast(buf, ctypes.c_void_p), step, 0)
            left = _check(lib, lib.ZSTD_decompressStream(dctx, ctypes.byref(outb), ctypes.byref(inb)), "decompress")
            parts.append(buf.raw[:outb.pos])
            if left == 0:
                return b"".join(parts)
            if inb.pos >= inb.size and outb.pos == 0:
                raise ValueError("zstd decompress failed: truncated frame")
    finally:
        lib.ZSTD_freeDCtx(dctx)
