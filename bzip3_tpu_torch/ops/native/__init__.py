"""Native host codec: ctypes bindings of ``csrc/host_codec.cpp``
(counterpart of the JAX package's ``ops/native/__init__.py``).

- ``crc32``, and ``bound`` (of ``container/bound.py``);
- ``encode_blocks`` / ``decode_blocks``: a batch of blocks over a pthread
  pool in C++ (the reference's bz3_encode_blocks / bz3_decode_blocks,
  src/libbz3.c:845), each worker with its own workspace;
- ``NativeCodec(block_size)``: one block at a time on the calling
  thread (bz3_encode_block / bz3_decode_block, src/libbz3.c:585-809),
  raising the JAX package's codes;
- ``cm_encode`` / ``cm_decode``: the CM stage alone, from a fresh model;
- ``rle_encode`` / ``rle_decode``, ``lzp_encode`` / ``lzp_decode``,
  ``bwt_forward`` / ``bwt_inverse``: the other stages, from ``ops/host``;
- ``STAGES``: the single-block stage namespace on the host C++, the
  native engine's counterpart of ``ops.device.BlockStages`` (recover
  mode decodes a damaged block through it).

The library is the port's host library (``ops/build.py``), loaded with
``ctypes.CDLL``, which releases the GIL for the length of each call: a
thread can drive the card while the pool runs.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

from ...container.bound import bound
from ...errors import (
    Bz3Error,
    BZ3_ERR_BWT,
    BZ3_ERR_CRC,
    BZ3_ERR_DATA_SIZE_TOO_SMALL,
    BZ3_ERR_MALFORMED_HEADER,
)
from .. import host
from ..build import load_host

_i = ctypes.c_int32
_c = ctypes.c_void_p
_pp = ctypes.POINTER(ctypes.c_char_p)
_pi = ctypes.POINTER(ctypes.c_int32)
_pv = ctypes.POINTER(ctypes.c_void_p)
_ready = False


def _lib() -> ctypes.CDLL:
    global _ready
    lib = load_host()
    if not _ready:
        lib.bz3h_cm_encode.restype = _i
        lib.bz3h_cm_encode.argtypes = [ctypes.c_char_p, _i, _c]
        lib.bz3h_cm_decode.restype = None
        lib.bz3h_cm_decode.argtypes = [ctypes.c_char_p, _i, _c, _i]
        lib.bz3h_encode_blocks.restype = None
        lib.bz3h_encode_blocks.argtypes = [_pp, _pi, _pv, _pi, _i, _i]
        lib.bz3h_decode_blocks.restype = None
        lib.bz3h_decode_blocks.argtypes = [_pp, _pi, _pi, _i, _pv, _pi, _i, _i]
        lib.bz3h_encode_block.restype = _i
        lib.bz3h_encode_block.argtypes = [ctypes.c_char_p, _i, _c]
        lib.bz3h_decode_block.restype = _i
        lib.bz3h_decode_block.argtypes = [ctypes.c_char_p, _i, _i, _i, _c]
        _ready = True
    return lib


def load() -> None:
    """Build (at first use) and bind the library; raise if it cannot."""
    _lib()


# CRC32-C with init 1 and no final xor (src/libbz3.c:37-72)
crc32 = host.crc32
rle_encode, rle_decode = host.rle_encode, host.rle_decode
lzp_encode, lzp_decode = host.lzp_encode, host.lzp_decode
bwt_forward, bwt_inverse = host.bwt_forward, host.bwt_inverse

# a failed block decode's code (bz3h_decode_block), as the JAX package's
# native codec raises it; any other is a malformed header
_DECODE_CODES = {
    -1: BZ3_ERR_BWT,
    -2: BZ3_ERR_MALFORMED_HEADER,
    -3: BZ3_ERR_CRC,
    -5: BZ3_ERR_DATA_SIZE_TOO_SMALL,
}


class NativeCodec:
    """Block codec on the host C++ for ``block_size`` (cf. bz3_new): one
    block a call on the calling thread, each thread with its own
    workspace inside the library."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._lib = _lib()

    def encode_block(self, data: bytes) -> bytes:
        out = ctypes.create_string_buffer(bound(len(data)) + 64)
        r = self._lib.bz3h_encode_block(data, len(data), out)
        if r < 0:
            raise RuntimeError(f"native encode failed: {r}")
        return out.raw[:r]

    def decode_block(self, block: bytes, orig_size: int) -> bytes:
        out = ctypes.create_string_buffer(bound(self.block_size) + 64)
        r = self._lib.bz3h_decode_block(block, len(block), orig_size, self.block_size, out)
        if r < 0:
            raise Bz3Error(_DECODE_CODES.get(r, BZ3_ERR_MALFORMED_HEADER),
                           f"native decode failed: {r}")
        return out.raw[:r]


def cm_encode(data: bytes) -> bytes:
    """CM-encode ``data`` from a fresh model: the payload."""
    n = len(data)
    out = ctypes.create_string_buffer(n + n // 8 + 64)
    m = _lib().bz3h_cm_encode(data, n, out)
    return out.raw[:m]


def cm_decode(payload: bytes, out_len: int) -> bytes:
    """Decode ``out_len`` bytes from a CM payload; an exhausted payload
    reads as 0xFF bytes, as the kernels' ``(code << 8) - 1``."""
    out = ctypes.create_string_buffer(max(1, out_len))
    _lib().bz3h_cm_decode(payload, len(payload), out, out_len)
    return out.raw[:out_len]


def encode_blocks(blocks: list[bytes], n_threads: int = 0) -> list[bytes]:
    """Encode a batch of blocks on ``n_threads`` workers (0: one a core)."""
    n = len(blocks)
    if n == 0:
        return []
    ins = (ctypes.c_char_p * n)(*blocks)
    lens = (_i * n)(*map(len, blocks))
    bufs = [ctypes.create_string_buffer(bound(len(b)) + 64) for b in blocks]
    outs = (_c * n)(*map(ctypes.addressof, bufs))
    results = (_i * n)()
    _lib().bz3h_encode_blocks(ins, lens, outs, results, n, n_threads)
    out = []
    for i, r in enumerate(results):
        if r < 0:
            raise RuntimeError(f"native batch encode failed at {i}: {r}")
        out.append(bufs[i].raw[:r])
    return out


def decode_blocks(
    blocks: list[tuple[bytes, int]], block_size: int, n_threads: int = 0
) -> list[bytes]:
    """Decode a batch of (block bytes, orig_size) pairs on ``n_threads``
    workers.  The first failed block raises, in block order: a CRC or
    stage failure as BZ3_ERR_CRC, any other as BZ3_ERR_MALFORMED_HEADER,
    the JAX package's native engine's codes."""
    n = len(blocks)
    if n == 0:
        return []
    payloads = [b for b, _ in blocks]
    ins = (ctypes.c_char_p * n)(*payloads)
    in_lens = (_i * n)(*map(len, payloads))
    orig = (_i * n)(*[o for _, o in blocks])
    bufs = [ctypes.create_string_buffer(bound(block_size) + 64) for _ in blocks]
    outs = (_c * n)(*map(ctypes.addressof, bufs))
    results = (_i * n)()
    _lib().bz3h_decode_blocks(ins, in_lens, orig, block_size, outs, results, n, n_threads)
    out = []
    for i, r in enumerate(results):
        if r < 0:
            raise Bz3Error(BZ3_ERR_CRC if r == -3 else BZ3_ERR_MALFORMED_HEADER,
                           f"native batch decode failed at {i}: {r}")
        out.append(bufs[i].raw[:r])
    return out


STAGES = SimpleNamespace(
    crc32=crc32,
    bwt_forward=bwt_forward,
    bwt_inverse=bwt_inverse,
    cm_encode=cm_encode,
    cm_decode=cm_decode,
    rle_encode=rle_encode,
    rle_decode=rle_decode,
    lzp_encode=lzp_encode,
    lzp_decode=lzp_decode,
)
