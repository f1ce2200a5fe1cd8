"""CRC32 oracle.

BZ3v1 uses a reflected CRC-32C (Castagnoli) byte-at-a-time checksum with
initial value 1 and *no* final inversion (reference: src/libbz3.c:37-72,
called as crc32sum(1, buf, n) at src/libbz3.c:593).

The 256-entry table is generated from the reflected Castagnoli
polynomial 0x82F63B78 rather than hard-coded.
"""

import numpy as np

_POLY = np.uint32(0x82F63B78)


def _make_table() -> np.ndarray:
    idx = np.arange(256, dtype=np.uint32)
    crc = idx.copy()
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> np.uint32(1)) ^ _POLY, crc >> np.uint32(1))
    return crc


CRC32C_TABLE = _make_table()
_TABLE = CRC32C_TABLE.tolist()  # Python ints: the byte loop's speed


def crc32(data, crc: int = 1) -> int:
    """crc = T[(crc ^ byte) & 0xff] ^ (crc >> 8) over all bytes; init 1."""
    c = int(crc) & 0xFFFFFFFF
    tbl = _TABLE
    for b in bytes(data):
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c
