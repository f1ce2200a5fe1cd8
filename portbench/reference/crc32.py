"""CRC-32C as BZ3v1 uses it: reflected Castagnoli polynomial 0x82F63B78,
initial value 1, no final inversion (src/libbz3.c:37-72, called as
crc32sum(1, buf, n) at :593).

``crc32`` is the byte loop of the port's ``ops/ref/crc32.py`` (frozen
copy).  ``crc32_blocks`` gives the same values for many blocks at once:
each block is cut into lanes of ``LANE`` bytes, every lane of every block
runs the byte loop from 0 in one vector step a byte, and each block's
lanes are folded in order, c = A(c) ^ lane, where A advances a register
over ``LANE`` zero bytes (the update is linear in the register), then the
tail runs the byte loop.
"""

import numpy as np

_POLY = np.uint32(0x82F63B78)
LANE = 4096


def _make_table() -> np.ndarray:
    idx = np.arange(256, dtype=np.uint32)
    crc = idx.copy()
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> np.uint32(1)) ^ _POLY, crc >> np.uint32(1))
    return crc


CRC32C_TABLE = _make_table()
_TABLE = CRC32C_TABLE.tolist()


def crc32(data, crc: int = 1) -> int:
    """crc = T[(crc ^ byte) & 0xff] ^ (crc >> 8) over all bytes; init 1."""
    c = int(crc) & 0xFFFFFFFF
    tbl = _TABLE
    for b in bytes(data):
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c


def _advance_tables(nbytes: int) -> list[list[int]]:
    """Four 256-entry tables whose xor over a register's bytes advances
    it over ``nbytes`` zero bytes."""
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(nbytes):
        basis = CRC32C_TABLE[basis & np.uint32(0xFF)] ^ (basis >> np.uint32(8))
    cols = basis.tolist()
    tables = []
    for byte in range(4):
        t = [0] * 256
        for v in range(256):
            acc = 0
            for bit in range(8):
                if v >> bit & 1:
                    acc ^= cols[8 * byte + bit]
            t[v] = acc
        tables.append(t)
    return tables


_ADVANCE: list[list[int]] = []


def crc32_blocks(data: bytes, bounds: list[tuple[int, int]]) -> list[int]:
    """CRC-32C (init 1) of each ``data[start:stop]`` for (start, stop) in
    ``bounds``."""
    if not _ADVANCE:
        _ADVANCE.extend(_advance_tables(LANE))
    t0, t1, t2, t3 = _ADVANCE
    buf = np.frombuffer(data, np.uint8)
    lanes = [(s, (e - s) // LANE) for s, e in bounds]
    total = sum(m for _, m in lanes)
    cols = np.empty((LANE, total), np.uint8)
    at = 0
    for s, m in lanes:
        cols[:, at : at + m] = buf[s : s + m * LANE].reshape(m, LANE).T
        at += m
    c = np.zeros(total, np.uint32)
    mask = np.uint32(0xFF)
    eight = np.uint32(8)
    for j in range(LANE):
        c = CRC32C_TABLE[(c ^ cols[j]) & mask] ^ (c >> eight)
    del cols
    lane_crc = c.tolist()
    out, at = [], 0
    for (s, e), (_, m) in zip(bounds, lanes):
        r = 1
        for z in lane_crc[at : at + m]:
            r = t0[r & 255] ^ t1[r >> 8 & 255] ^ t2[r >> 16 & 255] ^ t3[r >> 24] ^ z
        at += m
        out.append(crc32(buf[s + m * LANE : e].tobytes(), r))
    return out
