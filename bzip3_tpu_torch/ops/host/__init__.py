"""Host passes of the block pipeline: CRC32-C, RLE, LZP and the BWT.

Byte-serial C++ (``csrc/host_stages.cpp``, ``csrc/host_bwt.cpp``) behind
ctypes, on the host on every machine.  Semantics are the JAX package's
oracles (``ops/ref/crc32.py``, ``rle.py``, ``lzp.py``, ``bwt.py``;
reference src/libbz3.c:37-329).  The BWT serves the oversize blocks of
``pipeline.py``, past the device-block cap.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..build import load_host

_c = ctypes.c_void_p
_i = ctypes.c_int32
_ready = False

LZP_LUT_BYTES = 4 << 18  # 2^18 s32 positions


def _lib() -> ctypes.CDLL:
    global _ready
    lib = load_host()
    if not _ready:
        lib.bz3h_crc32.restype = ctypes.c_uint32
        lib.bz3h_crc32.argtypes = [ctypes.c_char_p, _i]
        lib.bz3h_lzp_encode.restype = _i
        lib.bz3h_lzp_encode.argtypes = [ctypes.c_char_p, _i, _c, _c]
        lib.bz3h_lzp_decode.restype = _i
        lib.bz3h_lzp_decode.argtypes = [ctypes.c_char_p, _i, _c, _i, _c]
        lib.bz3h_rle_encode.restype = _i
        lib.bz3h_rle_encode.argtypes = [ctypes.c_char_p, _i, _c, _i]
        lib.bz3h_rle_decode.restype = _i
        lib.bz3h_rle_decode.argtypes = [ctypes.c_char_p, _i, _c, _i]
        lib.bz3h_bwt_forward.restype = _i
        lib.bz3h_bwt_forward.argtypes = [ctypes.c_char_p, _c, _i, _c]
        lib.bz3h_bwt_inverse.restype = _i
        lib.bz3h_bwt_inverse.argtypes = [ctypes.c_char_p, _c, _i, _i, _c, ctypes.c_int64]
        _ready = True
    return lib


def crc32(data: bytes) -> int:
    """CRC32-C with init 1 and no final xor (src/libbz3.c:37-72)."""
    return _lib().bz3h_crc32(data, len(data))


def _buf(n: int) -> np.ndarray:
    """An output buffer of n bytes, left unfilled: the stage writes what
    it returns, and the LZP stages clear their own table.  Only the bytes
    written are copied out (``_out``), so that a pool thread holds the
    interpreter lock for one copy of its result, not for filling and
    copying whole buffers."""
    return np.empty(n, np.uint8)


def _out(buf: np.ndarray, r: int) -> bytes | None:
    return None if r < 0 else buf[:r].tobytes()


def rle_encode(data: bytes) -> bytes:
    """mRLE; the result is longer than the input when the stage expands."""
    # output is bounded by 32 + 2n (worst case: every byte a gated single)
    out = _buf(2 * len(data) + 64)
    r = _lib().bz3h_rle_encode(data, len(data), out.ctypes.data, len(out))
    if r < 0:
        raise RuntimeError("rle_encode overran its 32 + 2n output bound")
    return _out(out, r)


def rle_decode(data: bytes, out_len: int) -> bytes | None:
    """Inverse mRLE to exactly ``out_len`` bytes; None on a bad stream."""
    out = _buf(max(64, out_len))
    return _out(out, _lib().bz3h_rle_decode(data, len(data), out.ctypes.data, out_len))


def lzp_encode(data: bytes) -> bytes | None:
    """LZP; None when the stage does not apply or would not shrink."""
    out, lut = _buf(max(64, len(data))), _buf(LZP_LUT_BYTES)
    return _out(out, _lib().bz3h_lzp_encode(data, len(data), out.ctypes.data, lut.ctypes.data))


def lzp_decode(data: bytes, max_out: int) -> bytes | None:
    """Inverse LZP bounded by ``max_out``; None on a malformed stream."""
    out, lut = _buf(max(64, max_out)), _buf(LZP_LUT_BYTES)
    r = _lib().bz3h_lzp_decode(data, len(data), out.ctypes.data, max_out, lut.ctypes.data)
    return _out(out, r)


def bwt_forward(data: bytes) -> tuple[bytes, int]:
    """SA-IS BWT: (U, primary index) with the libsais_bwt output contract
    of the format (the JAX package's ``ops/ref/bwt.py``)."""
    n = len(data)
    if n <= 1:
        return data, n
    out = np.empty(n, np.uint8)
    # scratch: the suffix array (n + 1 words), then the u8 BWT temp
    scratch = np.empty(2 * (n + 16) + 16, np.int32)
    idx = _lib().bz3h_bwt_forward(data, out.ctypes.data, n, scratch.ctypes.data)
    if idx < 0:
        raise RuntimeError("bwt_forward failed")
    return out.tobytes(), idx


def bwt_inverse(u: bytes, index: int) -> bytes | None:
    """Inverse BWT (quad-merge LF walk); None on an index out of range."""
    n = len(u)
    if n <= 1:
        return u if index == n else None
    if index <= 0 or index > n:
        return None
    out = np.empty(n, np.uint8)
    # scratch: n + 1 packed nodes, u32 below 2^24 bytes and u64 above
    words = 2 * (n + 16)
    scratch = np.empty(words + 16, np.int32)
    r = _lib().bz3h_bwt_inverse(u, out.ctypes.data, n, index, scratch.ctypes.data, words)
    return None if r < 0 else out.tobytes()
