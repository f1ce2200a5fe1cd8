"""Block encode/decode orchestration (counterpart of the JAX package's
``models/block_codec.py``; reference: bz3_encode_block /
bz3_decode_block, src/libbz3.c:585-809).

Encode: the CRC32 of the raw block; a block under 64 bytes is stored
literal.  Otherwise RLE, then LZP, each kept only when it shrinks the
data (model bits 4 and 2), then the BWT and the CM coder.  Decode
inverts the chain with every hardening check of the reference, in its
order: header bounds, the BWT index bound, intermediate sizes against
the buffer bound, then the CRC.

The stages come from an ``engine`` namespace (``ops.device.stages``):
by default ``block_stages("cuda")``, so a block runs stage by stage on
the card; ``block_stages("cpu")`` runs the plain versions.

Block header layout:

    [crc32:u32le][bwt_idx:u32le][model:u8]([lzp_size:u32le])([rle_size:u32le])

A ``bwt_idx`` of -1 marks a literal block (fewer than 64 bytes, stored
with no entropy coding); then the header is the first 8 bytes only.
Model bit 2 means LZP was applied, bit 4 means RLE was applied.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..container.bound import (
    BLOCK_SIZE_MAX,
    BLOCK_SIZE_MIN,
    SMALL_BLOCK_THRESHOLD,
    bound,
    validate_block_size,
)
from ..errors import (
    Bz3Error,
    BZ3_ERR_BWT,
    BZ3_ERR_CRC,
    BZ3_ERR_DATA_SIZE_TOO_SMALL,
    BZ3_ERR_DATA_TOO_BIG,
    BZ3_ERR_INIT,
    BZ3_ERR_MALFORMED_HEADER,
)
from ..ops.device.stages import block_stages

_U32 = struct.Struct("<I")
_S32 = struct.Struct("<i")


@dataclass
class BlockHeader:
    crc32: int
    bwt_idx: int
    model: int = 0
    lzp_size: int = -1
    rle_size: int = -1

    @property
    def is_literal(self) -> bool:
        return self.bwt_idx == -1

    def header_size(self) -> int:
        if self.is_literal:
            return 8
        n = 9
        if self.model & 2:
            n += 4
        if self.model & 4:
            n += 4
        return n


def parse_block_header(block: bytes) -> BlockHeader:
    """Parse and bound-check a block header prefix."""
    if len(block) < 8:
        raise Bz3Error(BZ3_ERR_DATA_SIZE_TOO_SMALL, "block shorter than header")
    crc = _U32.unpack_from(block, 0)[0]
    bwt_idx = _S32.unpack_from(block, 4)[0]
    if bwt_idx == -1:
        return BlockHeader(crc, -1)
    if len(block) < 9:
        raise Bz3Error(BZ3_ERR_DATA_SIZE_TOO_SMALL, "block shorter than header")
    model = block[8]
    hdr = BlockHeader(crc, bwt_idx, model)
    off = 9
    if model & 2:
        if len(block) < off + 4:
            raise Bz3Error(BZ3_ERR_DATA_SIZE_TOO_SMALL, "missing lzp size")
        hdr.lzp_size = _S32.unpack_from(block, off)[0]
        off += 4
    if model & 4:
        if len(block) < off + 4:
            raise Bz3Error(BZ3_ERR_DATA_SIZE_TOO_SMALL, "missing rle size")
        hdr.rle_size = _S32.unpack_from(block, off)[0]
        off += 4
    return hdr


def _stages(engine):
    return block_stages("cuda") if engine is None else engine


def encode_block(data: bytes, engine=None) -> bytes:
    """Encode one block; returns header + payload (no chunk header)."""
    engine = _stages(engine)
    crc = engine.crc32(data)
    if len(data) < SMALL_BLOCK_THRESHOLD:
        return _U32.pack(crc) + _S32.pack(-1) + data

    model, lzp_size, rle_size, cur = 0, -1, -1, data
    rle_out = engine.rle_encode(cur)
    if len(rle_out) < len(cur):
        cur, rle_size, model = rle_out, len(rle_out), model | 4
    lzp_out = engine.lzp_encode(cur)
    if lzp_out is not None and len(lzp_out) < len(cur):
        cur, lzp_size, model = lzp_out, len(lzp_out), model | 2

    bwt_out, bwt_idx = engine.bwt_forward(cur)
    if bwt_idx < 0:
        raise Bz3Error(BZ3_ERR_BWT)
    payload = engine.cm_encode(bwt_out)

    header = bytearray(_U32.pack(crc) + _S32.pack(bwt_idx))
    header.append(model)
    if model & 2:
        header += _S32.pack(lzp_size)
    if model & 4:
        header += _S32.pack(rle_size)
    return bytes(header) + payload


def decode_block(
    block: bytes,
    orig_size: int,
    block_size: int,
    engine=None,
    buffer_size: int | None = None,
) -> bytes:
    """Decode one block (without chunk header) to orig_size bytes.

    ``buffer_size`` models the reference's caller-provided scratch bound
    (default bound(block_size)); every hardening check of
    src/libbz3.c:656-809 is kept, in its order and with its code.
    """
    engine = _stages(engine)
    cap = bound(block_size)
    if buffer_size is None:
        buffer_size = cap
    compressed_size = len(block)
    if buffer_size < 9 or buffer_size < compressed_size:
        raise Bz3Error(BZ3_ERR_DATA_SIZE_TOO_SMALL)
    if compressed_size > cap:
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)
    hdr = parse_block_header(block)

    if hdr.is_literal:
        if compressed_size - 8 > 64:
            raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)
        if compressed_size - 8 > buffer_size:
            raise Bz3Error(BZ3_ERR_DATA_SIZE_TOO_SMALL)
        data = block[8:]
        if engine.crc32(data) != hdr.crc32:
            raise Bz3Error(BZ3_ERR_CRC)
        return data

    if (hdr.model & 2 and not (0 <= hdr.lzp_size <= cap)) or (
        hdr.model & 4 and not (0 <= hdr.rle_size <= cap)
    ):
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)
    if orig_size > cap or orig_size < 0:
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)
    sbb = size_before_bwt(hdr, orig_size)
    # Buffer capacity of every intermediate (libbz3.c:114-122); an
    # absent stage's size is -1.
    for sz in (hdr.lzp_size, hdr.rle_size, orig_size):
        if sz > buffer_size:
            raise Bz3Error(BZ3_ERR_DATA_SIZE_TOO_SMALL)

    bwt_data = engine.cm_decode(block[hdr.header_size() :], sbb)
    if hdr.bwt_idx > sbb:
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)
    cur = engine.bwt_inverse(bwt_data, hdr.bwt_idx)
    if cur is None:
        raise Bz3Error(BZ3_ERR_BWT)
    if hdr.model & 2:
        cur = engine.lzp_decode(cur, cap)
        if cur is None:
            raise Bz3Error(BZ3_ERR_CRC)
        if len(cur) > buffer_size:
            raise Bz3Error(BZ3_ERR_DATA_SIZE_TOO_SMALL)
    if hdr.model & 4:
        cur = engine.rle_decode(cur, orig_size)
        if cur is None:
            raise Bz3Error(BZ3_ERR_CRC)
    if len(cur) > block_size:
        raise Bz3Error(BZ3_ERR_MALFORMED_HEADER)
    if engine.crc32(cur) != hdr.crc32:
        raise Bz3Error(BZ3_ERR_CRC)
    return cur


def size_before_bwt(hdr: BlockHeader, orig_size: int) -> int:
    """Length of the BWT's row: the LZP output, else the RLE output, else
    the block."""
    if hdr.model & 2:
        return hdr.lzp_size
    if hdr.model & 4:
        return hdr.rle_size
    return orig_size


def decode_block_recover(
    block: bytes, orig_size: int, block_size: int, engine=None
) -> tuple[bytes, bool]:
    """Best-effort decode for recover mode (src/main.c:279-299).

    Returns ``(data, ok)``.  On failure ``data`` is what the stage chain
    produced before the failing check (the reference writes the partly
    decoded buffer as it is, "Writing invalid block", main.c:293-296),
    cut or zero-padded to ``orig_size``; the sizes the chain decodes to
    are clamped to bound(block_size).
    """
    engine = _stages(engine)
    try:
        return decode_block(block, orig_size, block_size, engine), True
    except Bz3Error:
        pass

    cap = bound(block_size)
    orig_size = max(0, min(orig_size, cap))
    best = b""
    try:
        hdr = parse_block_header(block)
        if hdr.is_literal:
            best = block[8 : 8 + 64]
        else:
            sbb = max(0, min(size_before_bwt(hdr, orig_size), cap))
            best = engine.cm_decode(block[hdr.header_size() :], sbb)
            if 0 <= hdr.bwt_idx <= len(best):
                cur = engine.bwt_inverse(best, hdr.bwt_idx)
                if cur is not None:
                    best = cur
            if hdr.model & 2:
                cur = engine.lzp_decode(best, cap)
                if cur is not None:
                    best = cur
            if hdr.model & 4:
                cur = engine.rle_decode(best, orig_size)
                if cur is not None:
                    best = cur
    except Bz3Error:
        pass
    data = best[:orig_size]
    return data + b"\x00" * (orig_size - len(data)), False


class Bz3Codec:
    """Reusable block codec bound to a block size (cf. bz3_new), running
    its stages on ``device`` (or through ``engine``, a stage namespace)."""

    def __init__(self, block_size: int, device="cuda", engine=None):
        if not validate_block_size(block_size):
            raise Bz3Error(
                BZ3_ERR_INIT,
                f"block size must be in [{BLOCK_SIZE_MIN}, {BLOCK_SIZE_MAX}]",
            )
        self.block_size = block_size
        self.engine = engine if engine is not None else block_stages(device)

    def encode_block(self, data: bytes) -> bytes:
        if len(data) > self.block_size:
            raise Bz3Error(BZ3_ERR_DATA_TOO_BIG)
        return encode_block(data, self.engine)

    def decode_block(self, block: bytes, orig_size: int, buffer_size=None) -> bytes:
        return decode_block(block, orig_size, self.block_size, self.engine, buffer_size)
