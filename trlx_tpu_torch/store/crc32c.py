"""CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), table-driven.

The OCDBT format ends every manifest and B+tree node with the CRC-32C of
the bytes before it, little-endian. Those files are small (a node holds
keys and inline values only), so one table lookup per byte in Python is
fast enough. Checked against RFC 3720 appendix B.4's test vectors.
"""

POLY = 0x82F63B78


def _table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_TABLE = _table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """The CRC-32C of ``data`` (continuing from ``crc``, the value of the
    bytes before it)."""
    c = crc ^ 0xFFFFFFFF
    table = _TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF
