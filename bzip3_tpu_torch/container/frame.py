"""One-shot frame API: in-memory compress/decompress.

Frame layout (reference: bz3_compress/bz3_decompress,
src/libbz3.c:876-997; doc/bzip3_format.md):

    "BZ3v1" + block_size:u32le + n_blocks:u32le
    then per block: [compressed_size:u32le][orig_size:u32le][payload]
"""

from __future__ import annotations

import struct

from .bound import KiB, bound, validate_block_size
from ..engines import DeviceEngine
from ..errors import (
    Bz3Error,
    BZ3_ERR_DATA_TOO_BIG,
    BZ3_ERR_MALFORMED_HEADER,
    BZ3_ERR_TRUNCATED_DATA,
)

MAGIC = b"BZ3v1"
_U32 = struct.Struct("<I")


def compress(
    data: bytes,
    block_size: int = 16 * 1024 * 1024,
    engine=None,
    batch_size: int = 16,
    device="cuda",
) -> bytes:
    """Compress a whole buffer into a BZ3v1 frame.

    Blocks go through ``engine`` (default: a ``DeviceEngine`` on
    ``device``) ``batch_size`` at a time.
    """
    eng = engine if engine is not None else DeviceEngine(device)
    if block_size > len(data):
        block_size = bound(len(data))
    block_size = max(block_size, 65 * KiB)

    n = len(data)
    n_blocks = (n + block_size - 1) // block_size  # 0 blocks for empty input

    out = bytearray()
    out += MAGIC
    out += _U32.pack(block_size)
    out += _U32.pack(n_blocks)

    # Deliberate divergence: the reference sizes the final block as
    # in_size % block_size (src/libbz3.c:914), which silently DROPS the
    # whole last block when in_size is an exact multiple of block_size.
    # We frame the last block with its true remaining size instead; the
    # stream layout is identical and fully cross-decodable.
    chunks = [data[o : o + block_size] for o in range(0, n, block_size)]
    step = max(1, batch_size)
    for lo in range(0, n_blocks, step):
        batch = chunks[lo : lo + step]
        for chunk, payload in zip(batch, eng.encode_blocks(batch, block_size)):
            out += _U32.pack(len(payload))
            out += _U32.pack(len(chunk))
            out += payload
    return bytes(out)


def decompress(
    data: bytes,
    engine=None,
    batch_size: int = 16,
    device="cuda",
    max_output: int | None = None,
) -> bytes:
    """Decompress a BZ3v1 frame produced by :func:`compress`.

    With ``max_output``, a frame whose blocks' original sizes add up past
    it raises BZ3_ERR_DATA_TOO_BIG while its headers are read, before any
    block is decoded."""
    eng = engine if engine is not None else DeviceEngine(device)
    if len(data) < 13:
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)
    if data[:5] != MAGIC:
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)
    block_size = _U32.unpack_from(data, 5)[0]
    n_blocks = _U32.unpack_from(data, 9)[0]
    if not validate_block_size(block_size):
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)

    out = bytearray()
    pos = 13
    pending: list[tuple[bytes, int]] = []
    total_osize = 0
    for _ in range(n_blocks):
        if len(data) - pos < 8:
            raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)
        csize = _U32.unpack_from(data, pos)[0]
        osize = _U32.unpack_from(data, pos + 4)[0]
        # The reference rejects csize > block_size (src/libbz3.c:966),
        # but a near-incompressible block can legitimately exceed the
        # block size by the coder overhead; accept up to bound().
        if csize > 2**31 - 1 or csize > bound(block_size):
            raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)
        if osize > 2**31 - 1:
            raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)
        if len(data) - pos < csize + 8:
            raise Bz3Error(BZ3_ERR_TRUNCATED_DATA)
        total_osize += osize
        if max_output is not None and total_osize > max_output:
            raise Bz3Error(BZ3_ERR_DATA_TOO_BIG)
        pos += 8
        pending.append((data[pos : pos + csize], osize))
        pos += csize

    step = max(1, batch_size)
    for lo in range(0, len(pending), step):
        for blk in eng.decode_blocks(pending[lo : lo + step], block_size):
            out += blk
    return bytes(out)
