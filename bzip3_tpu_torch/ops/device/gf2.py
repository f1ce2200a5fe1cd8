"""GF(2) linear-operator toolkit for CRC folding on device (the port's
own copy of the JAX package's ``ops/device/gf2.py``; NumPy only).

The BZ3v1 CRC (reflected CRC-32C, init 1, no final xor — reference:
src/libbz3.c:37-72) is an affine map over GF(2): one byte step is

    crc' = T[(crc ^ b) & 0xff] ^ (crc >> 8)  =  Z(crc) ^ B(b)

with Z and B linear.  That makes the checksum parallelizable: split the
buffer into L equal lanes, scan each lane with init 0, then combine the
lane states with precomputed powers of Z (this file), exactly the
zlib crc32_combine construction.  Zero padding is undone afterwards by
applying the *inverse* of Z (Z is invertible because the Castagnoli
polynomial has a nonzero constant term), so fixed-shape padded arrays
give exact CRCs of the true lengths.

All matrices here are built once on the host with NumPy; on device a
matrix is a uint32[32] column bank and application is 32 masked XORs.
"""

import numpy as np

POLY = np.uint32(0x82F63B78)  # reflected Castagnoli


def make_crc_table() -> np.ndarray:
    idx = np.arange(256, dtype=np.uint32)
    crc = idx.copy()
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> np.uint32(1)) ^ POLY, crc >> np.uint32(1))
    return crc


CRC_TABLE = make_crc_table()


def _apply(mat: np.ndarray, v: int) -> int:
    """Apply a 32x32 GF(2) matrix (uint32[32] columns) to a scalar."""
    out = 0
    for i in range(32):
        if (v >> i) & 1:
            out ^= int(mat[i])
    return out


def matrix_of(fn) -> np.ndarray:
    """Column bank of a linear map fn: uint32 -> uint32."""
    return np.array([fn(1 << i) for i in range(32)], dtype=np.uint32)


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose: (a @ b)(v) == a(b(v)).  Vectorized over columns."""
    bits = ((b[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
    terms = np.where(bits, a[None, :], np.uint32(0))
    return np.bitwise_xor.reduce(terms, axis=1).astype(np.uint32)


def mat_pow(m: np.ndarray, e: int) -> np.ndarray:
    result = matrix_of(lambda v: v)  # identity
    base = m
    while e:
        if e & 1:
            result = mat_mul(base, result)
        base = mat_mul(base, base)
        e >>= 1
    return result


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a 32x32 GF(2) matrix by Gaussian elimination."""
    # rows[i] = (m_row_i, identity_row_i) packed as 64-bit ints where
    # bit j of the low word is column j.  Work row-wise on bit masks.
    lo = [0] * 32  # row i of m  (bit j = m[j] bit i)
    hi = [0] * 32  # row i of identity
    for i in range(32):
        for j in range(32):
            lo[i] |= ((int(m[j]) >> i) & 1) << j
        hi[i] = 1 << i
    for col in range(32):
        pivot = next(r for r in range(col, 32) if (lo[r] >> col) & 1)
        lo[col], lo[pivot] = lo[pivot], lo[col]
        hi[col], hi[pivot] = hi[pivot], hi[col]
        for r in range(32):
            if r != col and ((lo[r] >> col) & 1):
                lo[r] ^= lo[col]
                hi[r] ^= hi[col]
    # Convert row form back to column bank.
    inv = np.zeros(32, dtype=np.uint32)
    for j in range(32):
        col = 0
        for i in range(32):
            col |= ((hi[i] >> j) & 1) << i
        inv[j] = col
    return inv


def zero_byte_matrix() -> np.ndarray:
    """Z: the state map of one zero-byte CRC step."""
    tbl = CRC_TABLE

    def step(v):
        return int(tbl[v & 0xFF]) ^ (v >> 8)

    return matrix_of(step)


Z = zero_byte_matrix()
Z_INV = mat_inv(Z)


def shift_matrix(nbytes: int) -> np.ndarray:
    """Z**nbytes — advances a CRC state past nbytes of zeros."""
    return mat_pow(Z, nbytes)


def unshift_pow2_bank(max_bits: int) -> np.ndarray:
    """[max_bits, 32] bank: row j = (Z^-1)**(2**j), for dynamic unwinds."""
    bank = np.zeros((max_bits, 32), dtype=np.uint32)
    cur = Z_INV
    for j in range(max_bits):
        bank[j] = cur
        cur = mat_mul(cur, cur)
    return bank
