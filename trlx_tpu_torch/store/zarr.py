"""zarr v2 arrays over a key-value mapping: ``<name>/.zarray`` metadata and
C-order chunks keyed ``i.j.k`` (``dimension_separator "."``), as
tensorstore writes them for orbax. The layout is defined
publicly by the zarr v2 storage specification.

:func:`read_region` decodes only the chunks that overlap a box, for any
chunk grid (a store saved from a mesh holds chunks at shard shape; edge
chunks are stored at the full chunk shape). Compressors read: zstd (through
:mod:`trlx_tpu_torch.store.zstd`) and none. :func:`encode_array` cuts each
array into a grid of chunks (:func:`default_chunks`), zstd at level 1 as
orbax does when libzstd loads, else uncompressed (``compressor: null``).
"""

import itertools
import json
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from trlx_tpu_torch.store import zstd

ZARRAY = ".zarray"
#: zarr dtype string -> (numpy storage dtype, torch dtype); bfloat16 is
#: stored as its 16 bits and viewed as torch.bfloat16
DTYPES = {
    "<f4": (np.float32, torch.float32),
    "<f8": (np.float64, torch.float64),
    "<f2": (np.float16, torch.float16),
    "bfloat16": (np.uint16, torch.bfloat16),
    "<i8": (np.int64, torch.int64),
    "<i4": (np.int32, torch.int32),
    "<i2": (np.int16, torch.int16),
    "|i1": (np.int8, torch.int8),
    "|u1": (np.uint8, torch.uint8),
    "|b1": (np.bool_, torch.bool),
}
_TORCH_TO_ZARR = {t: name for name, (_, t) in DTYPES.items()}


def zarr_dtype(dtype: torch.dtype) -> str:
    if dtype not in _TORCH_TO_ZARR:
        raise TypeError(f"no zarr dtype for {dtype}")
    return _TORCH_TO_ZARR[dtype]


def parse_metadata(raw: bytes, name: str = "") -> Dict[str, Any]:
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')} is not 2")
    if meta["dtype"] not in DTYPES:
        raise ValueError(f"{name}: dtype {meta['dtype']!r} is not supported")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: order {meta['order']!r} is not supported (C only)")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')!r} is not supported (zstd or none)")
    return meta


def chunk_key(index: Sequence[int], meta: Dict[str, Any]) -> str:
    sep = meta.get("dimension_separator", ".")
    return sep.join(str(i) for i in index) if index else "0"


def _decode_chunk(raw: bytes, meta: Dict[str, Any]) -> np.ndarray:
    if meta.get("compressor") is not None:
        raw = zstd.decompress(raw)
    np_dtype = DTYPES[meta["dtype"]][0]
    chunks = tuple(meta["chunks"])
    return np.frombuffer(raw, dtype=np_dtype).reshape(chunks)


def _to_torch(arr: np.ndarray, zdtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.view(torch.bfloat16) if zdtype == "bfloat16" else t


def read_region(get: Callable[[str], Optional[bytes]], name: str, meta: Dict[str, Any],
                box: Optional[Sequence[Tuple[int, int]]] = None) -> Tuple[torch.Tensor, int]:
    """The ``box`` (``[(start, stop)]`` per dim, default the whole array) of
    the array ``name`` as a CPU tensor, and the count of chunk bytes read.
    ``get(key)`` returns a stored value or None; a missing chunk is the
    fill value."""
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    box = [(0, s) for s in shape] if box is None else [tuple(b) for b in box]
    np_dtype = DTYPES[meta["dtype"]][0]
    out = np.empty([b - a for a, b in box], dtype=np_dtype)
    fill = meta.get("fill_value")
    read = 0
    ranges = [range(a // c, -(-b // c)) if b > a else range(0) for (a, b), c in zip(box, chunks)]
    for index in itertools.product(*ranges):
        raw = get(f"{name}/{chunk_key(index, meta)}")
        src = tuple(slice(max(a, i * c) - i * c, min(b, (i + 1) * c) - i * c)
                    for (a, b), c, i in zip(box, chunks, index))
        dst = tuple(slice(max(a, i * c) - a, min(b, (i + 1) * c) - a) for (a, b), c, i in zip(box, chunks, index))
        if raw is None:
            out[dst] = 0 if fill is None else fill
            continue
        read += len(raw)
        out[dst] = _decode_chunk(raw, meta)[src]
    return _to_torch(out, meta["dtype"]), read


#: a dim of at least this size is cut into :data:`SPLITS` chunks
SPLIT_MIN, SPLITS = 16, 8


def default_chunks(shape: Sequence[int]) -> list:
    """The writer's chunk grid: each dim of at least :data:`SPLIT_MIN`
    elements in :data:`SPLITS` chunks (the last one at the edge), so that a
    rank's block under any mesh of up to 8 along a dim reads a share of the
    array, as orbax's shard-shaped chunks let it."""
    return [-(-d // SPLITS) if d >= SPLIT_MIN else d for d in shape]


def encode_array(name: str, tensor: torch.Tensor, compress: Optional[bool] = None) -> Dict[str, bytes]:
    """``{key: value}`` of one array: its ``.zarray`` (compact, sorted keys,
    as tensorstore writes it) and its chunks over :func:`default_chunks`'
    grid (edge chunks stored at the full chunk shape, zero-padded, as zarr
    v2 stores them), zstd level 1 when ``compress`` (default: libzstd
    loads)."""
    if compress is None:
        compress = zstd.available()
    zdtype = zarr_dtype(tensor.dtype)
    shape = list(tensor.shape)
    chunks = default_chunks(shape)
    meta = {"chunks": chunks, "compressor": {"id": "zstd", "level": 1} if compress else None,
            "dimension_separator": ".", "dtype": zdtype, "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}
    t = tensor.detach().to("cpu").contiguous()
    if zdtype == "bfloat16":
        t = t.view(torch.int16)
    arr = t.numpy()
    out = {f"{name}/{ZARRAY}": json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()}
    for index in itertools.product(*[range(-(-d // c)) for d, c in zip(shape, chunks)]):
        block = arr[tuple(slice(i * c, (i + 1) * c) for i, c in zip(index, chunks))]
        if list(block.shape) != chunks:
            block = np.pad(block, [(0, c - b) for b, c in zip(block.shape, chunks)])
        raw = np.ascontiguousarray(block).tobytes()
        out[f"{name}/{chunk_key(index, meta)}"] = zstd.compress(raw, 1) if compress else raw
    return out
