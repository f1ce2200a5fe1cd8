"""BZ3v1 block header (reference: bz3_encode_block / bz3_decode_block,
src/libbz3.c:585-809).

Block header layout:

    [crc32:u32le][bwt_idx:u32le][model:u8]([lzp_size:u32le])([rle_size:u32le])

A ``bwt_idx`` of -1 marks a literal block (fewer than 64 bytes, stored
with no entropy coding); then the header is the first 8 bytes only.
Model bit 2 means LZP was applied, bit 4 means RLE was applied.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..errors import Bz3Error, BZ3_ERR_DATA_SIZE_TOO_SMALL

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
