"""The OCDBT key-value database, read and written without tensorstore.

OCDBT (Optionally-Cooperative Distributed B+Tree) is the layout orbax's
``StandardCheckpointer`` writes through tensorstore. The format is defined
publicly by tensorstore's "OCDBT format" page; this module implements the
parts a converted store uses:

- a **manifest** (``manifest.ocdbt``): the config (uuid, inline-value and
  node size limits, compression) and the version list, whose newest entry
  names the root B+tree node;
- **B+tree nodes**: interior nodes list child references with their key
  ranges, leaf nodes list keys with values that are either inline or an
  indirect ``(data file, offset, length)`` reference into ``d/``;
- **data files** ``d/<id>``, referenced through each node's data-file table
  as a base path plus a relative path, so a root database can point into a
  sub-database's files (orbax's ``ocdbt.process_<i>/d/...``).

Every manifest and node file is: a 4-byte big-endian magic (``0x0cdb3a2a``
manifest, ``0x0cdb20de`` node), the file's length as a little-endian
u64, a format-version varint, a compression byte (0 none, 1 zstd), the
(compressed) body, and the CRC-32C of everything before it (little-endian
u32). Integers in a body are LEB128 varints unless stated; arrays are
stored column by column, and keys are prefix-compressed against the key
before them.

:func:`read_database` returns ``{key: value bytes}`` of a database's
newest version; :func:`write_database` writes a single-process database
(one leaf node, values over ``max_inline_value_bytes`` packed into one
data file), compressed with zstd when libzstd loads and uncompressed
otherwise, both of which tensorstore reads.
"""

import hashlib
import os
import struct
import time
from typing import Dict, List, Mapping, Optional, Tuple

from trlx_tpu_torch.store import zstd
from trlx_tpu_torch.store.crc32c import crc32c

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
NO_COMPRESSION, ZSTD = 0, 1
#: a leaf value's kind
INLINE, INDIRECT = 0, 1
#: orbax's settings for the databases it writes
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
#: the offset / length of a version that has no root (an empty database)
_NO_ROOT = (1 << 64) - 1


class FormatError(ValueError):
    """A file that is not valid OCDBT."""


# -- encoding primitives -----------------------------------------------------------


class Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise FormatError(f"{self.what}: truncated")
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise FormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise FormatError(f"{self.what}: truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]


def varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(varint(v) for v in values)


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def decode_file(data: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file, its header, length and checksum checked."""
    if len(data) < 18:
        raise FormatError(f"{what}: {len(data)} bytes is too short")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise FormatError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise FormatError(f"{what}: header length {length} != {len(data)} bytes")
    if crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise FormatError(f"{what}: CRC-32C mismatch")
    r = Reader(data[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != FORMAT_VERSION:
        raise FormatError(f"{what}: format version {version} is not supported")
    compression = r.byte()
    body = data[r.pos:-4]
    if compression == ZSTD:
        return zstd.decompress(body)
    if compression != NO_COMPRESSION:
        raise FormatError(f"{what}: unknown compression {compression}")
    return body


def encode_file(body: bytes, magic: int, compress: bool) -> bytes:
    payload = zstd.compress(body, 0) if compress else body
    head = varint(FORMAT_VERSION) + bytes([ZSTD if compress else NO_COMPRESSION])
    length = 4 + 8 + len(head) + len(payload) + 4
    data = struct.pack(">I", magic) + struct.pack("<Q", length) + head + payload
    return data + struct.pack("<I", crc32c(data))


# -- structures --------------------------------------------------------------------


def _read_data_file_table(r: Reader) -> List[str]:
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + r.raw(suffix[i])
        if base[i] > len(path):
            raise FormatError(f"{r.what}: base path longer than its path")
        paths.append(path.decode())
        prev = path
    return paths


def _data_file_table(paths: List[Tuple[str, str]]) -> bytes:
    """``paths``: (base path, relative path) pairs."""
    full = [(b + p).encode() for b, p in paths]
    prefix = [_common_prefix(full[i - 1], full[i]) for i in range(1, len(full))]
    suffix = [full[i][(prefix[i - 1] if i else 0):] for i in range(len(full))]
    return (varint(len(full)) + _varints(prefix) + _varints(len(s) for s in suffix)
            + _varints(len(b.encode()) for b, _ in paths) + b"".join(suffix))


def _read_keys(r: Reader, n: int, interior: bool = False) -> Tuple[List[bytes], List[int]]:
    """A node's keys; an interior node stores each child's subtree common
    prefix length between the key lengths and the key bytes."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        key = prev[:prefix[i]] + r.raw(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


def read_manifest(path: str) -> dict:
    """The config and the newest version of a database directory."""
    with open(os.path.join(path, MANIFEST), "rb") as f:
        r = Reader(decode_file(f.read(), MANIFEST_MAGIC, f"{path}/{MANIFEST}"), MANIFEST)
    config = {"uuid": r.raw(16).hex(), "manifest_kind": r.varint(), "max_inline_value_bytes": r.varint(),
              "max_decoded_node_bytes": r.varint(), "version_tree_arity_log2": r.byte(),
              "compression": r.varint()}
    if config["compression"] == ZSTD:
        config["zstd_level"] = struct.unpack("<i", r.raw(4))[0]
    if config["manifest_kind"] != 0:
        raise FormatError(f"{path}: numbered manifests are not supported (manifest_kind {config['manifest_kind']})")
    files = _read_data_file_table(r)
    n = r.varint()
    if n == 0:
        raise FormatError(f"{path}: the manifest lists no version")
    gen = r.varints(n)
    height = [r.byte() for _ in range(n)]
    file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
    num_keys, tree_bytes, indirect = r.varints(n), r.varints(n), r.varints(n)
    commit = [r.u64() for _ in range(n)]
    newest = max(range(n), key=lambda i: gen[i])
    root = None
    if offset[newest] != _NO_ROOT:
        root = (files[file_id[newest]], offset[newest], length[newest])
    return {"config": config, "generation": gen[newest], "root_height": height[newest], "root": root,
            "num_keys": num_keys[newest], "num_tree_bytes": tree_bytes[newest],
            "num_indirect_value_bytes": indirect[newest], "commit_time": commit[newest]}


class _Files:
    """Whole data files of one database, read once each."""

    def __init__(self, root: str):
        self.root, self.cache = root, {}

    def read(self, path: str, offset: int, length: int) -> bytes:
        if path not in self.cache:
            with open(os.path.join(self.root, path), "rb") as f:
                self.cache[path] = f.read()
        data = self.cache[path]
        if offset + length > len(data):
            raise FormatError(f"{path}: [{offset}, {offset + length}) past its {len(data)} bytes")
        return data[offset:offset + length]


def _read_node(files: _Files, ref, prefix: bytes, height: int, out: Dict[bytes, object]) -> None:
    path, offset, length = ref
    r = Reader(decode_file(files.read(path, offset, length), NODE_MAGIC, f"{path}@{offset}"), path)
    got = r.byte()
    if got != height:
        raise FormatError(f"{path}@{offset}: node height {got}, its parent says {height}")
    table = _read_data_file_table(r)
    n = r.varint()
    keys, common = _read_keys(r, n, interior=height > 0)
    if height == 0:
        lengths = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == INDIRECT]
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        refs = dict(zip(indirect, zip(ids, offsets)))
        for i in range(n):
            if kinds[i] == INDIRECT:
                fid, off = refs[i]
                out[prefix + keys[i]] = (table[fid], off, lengths[i])
            elif kinds[i] == INLINE:
                out[prefix + keys[i]] = r.raw(lengths[i])
            else:
                raise FormatError(f"{path}@{offset}: unknown value kind {kinds[i]}")
        return
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    r.varints(n), r.varints(n), r.varints(n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
    for i in range(n):
        _read_node(files, (table[ids[i]], offsets[i], lengths[i]), prefix + keys[i][:common[i]], height - 1, out)


class Database:
    """A database's newest version: its keys, and each value read on demand
    (indirect values from their data files; a data file is read once)."""

    def __init__(self, path: str):
        self.path = path
        self.manifest = read_manifest(path)
        self._files = _Files(path)
        self._entries: Dict[bytes, object] = {}
        m = self.manifest
        if m["root"] is not None:
            _read_node(self._files, m["root"], b"", m["root_height"], self._entries)
        #: bytes read from data files for indirect values
        self.value_bytes_read = 0

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._entries)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._entries

    def get(self, key: str) -> bytes:
        entry = self._entries[key.encode()]
        if isinstance(entry, bytes):
            return entry
        path, offset, length = entry
        self.value_bytes_read += length
        with open(os.path.join(self.path, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise FormatError(f"{path}: [{offset}, {offset + length}) past its end")
        return data


def read_database(path: str) -> Dict[str, bytes]:
    """``{key: value}`` of the newest version of the database at ``path``."""
    db = Database(path)
    return {k: db.get(k) for k in db.keys()}


def _file_id(data: bytes) -> str:
    return "d/" + hashlib.blake2b(data, digest_size=16).hexdigest()


def write_database(path: str, items: Mapping[str, bytes], compress: Optional[bool] = None) -> None:
    """Write ``items`` as a new single-process database at ``path`` (one
    version, one leaf node; values over ``MAX_INLINE_VALUE_BYTES`` go to one
    data file). ``compress`` defaults to whether libzstd loads."""
    if compress is None:
        compress = zstd.available()
    os.makedirs(os.path.join(path, "d"), exist_ok=True)
    entries = sorted((k.encode(), bytes(v)) for k, v in items.items())
    keys = [k for k, _ in entries]
    values = [v for _, v in entries]
    indirect = [i for i, v in enumerate(values) if len(v) > MAX_INLINE_VALUE_BYTES]
    offsets, blob = [], bytearray()
    for i in indirect:
        offsets.append(len(blob))
        blob += values[i]
    files = []
    if indirect:
        blob = bytes(blob)
        files.append(("", _file_id(blob)))
        with open(os.path.join(path, files[0][1]), "wb") as f:
            f.write(blob)
    n = len(keys)
    prefix = [_common_prefix(keys[i - 1], keys[i]) for i in range(1, n)]
    suffix = [keys[i][(prefix[i - 1] if i else 0):] for i in range(n)]
    kinds = [INDIRECT if i in set(indirect) else INLINE for i in range(n)]
    body = (bytes([0]) + _data_file_table(files) + varint(n) + _varints(prefix) + _varints(len(s) for s in suffix)
            + b"".join(suffix) + _varints(len(v) for v in values) + _varints(kinds)
            + _varints([0] * len(indirect)) + _varints(offsets)
            + b"".join(v for v, k in zip(values, kinds) if k == INLINE))
    node = encode_file(body, NODE_MAGIC, compress)
    node_file = _file_id(node)
    with open(os.path.join(path, node_file), "wb") as f:
        f.write(node)
    config = (os.urandom(16) + varint(0) + varint(MAX_INLINE_VALUE_BYTES) + varint(MAX_DECODED_NODE_BYTES)
              + bytes([VERSION_TREE_ARITY_LOG2]) + varint(ZSTD if compress else NO_COMPRESSION)
              + (struct.pack("<i", 0) if compress else b""))
    versions = (varint(1) + varint(1) + bytes([0]) + varint(0) + varint(0) + varint(len(node)) + varint(n)
                + varint(len(node)) + varint(sum(len(values[i]) for i in indirect))
                + struct.pack("<Q", time.time_ns()) + varint(0))
    manifest = encode_file(config + _data_file_table([("", node_file)]) + versions, MANIFEST_MAGIC, compress)
    tmp = os.path.join(path, MANIFEST + ".tmp")
    with open(tmp, "wb") as f:
        f.write(manifest)
    os.replace(tmp, os.path.join(path, MANIFEST))
