"""Read and write the safetensors file format with ``json``, ``struct`` and
torch: the port's own copy of what the JAX package takes from the
``safetensors`` package, so checkpoints load and export on a host without it.

Layout of a file: an 8-byte little-endian header length ``n``; ``n`` bytes
of JSON, ``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` with
an optional ``"__metadata__"`` map of strings, padded with spaces to a
multiple of 8; then the tensors' raw little-endian bytes, each at its
offsets relative to the end of the header.

:func:`save_file` lays tensors out as ``safetensors`` does: by dtype (widest
first) and then by name, with ``__metadata__`` first in the header, so the
bytes equal the library's for the same tensors. bf16 has no numpy dtype: it
is read and written through a uint16 view.
"""

import json
import struct
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

#: safetensors dtype name -> (torch dtype, numpy dtype of its bytes, layout
#: rank: the library's dtype order, widest first)
DTYPES = {
    "I64": (torch.int64, np.int64, 4),
    "F32": (torch.float32, np.float32, 3),
    "I32": (torch.int32, np.int32, 2),
    "BF16": (torch.bfloat16, np.uint16, 1),
    "F16": (torch.float16, np.float16, 0),
}
_NAME_OF_TORCH = {torch_dtype: name for name, (torch_dtype, _, _) in DTYPES.items()}


def _as_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    return torch.from_numpy(np.asarray(value, order="C"))


def _raw_bytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save_file(tensors: Mapping[str, Any], path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays) to ``path``."""
    items = []
    for name, value in tensors.items():
        t = _as_tensor(value)
        if t.dtype not in _NAME_OF_TORCH:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        items.append((name, _NAME_OF_TORCH[t.dtype], t))
    items.sort(key=lambda it: (-DTYPES[it[1]][2], it[0]))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    chunks, offset = [], 0
    for name, dtype, t in items:
        data = _raw_bytes(t)
        header[name] = {"dtype": dtype, "shape": list(t.shape), "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * ((8 - len(head) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in chunks:
            f.write(data)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file as a CPU torch tensor of its own
    dtype, in the header's order. Reads the whole file."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    (n,) = struct.unpack("<Q", bytes(buf[:8]))
    header = json.loads(bytes(buf[8:8 + n]))
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']!r}")
        torch_dtype, np_dtype, _ = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        arr = np.frombuffer(buf, dtype=np_dtype, count=(end - begin) // np.dtype(np_dtype).itemsize,
                            offset=base + begin)
        t = torch.from_numpy(arr.reshape(shape))  # shares the (writable) file buffer
        out[name] = t.view(torch.bfloat16) if torch_dtype == torch.bfloat16 else t
    return out
