"""Size bounds and limits for the BZ3v1 format.

Reference semantics: src/libbz3.c:510 (bz3_bound), :536 (block size
limits), :999-1022 (bz3_min_memory_needed), :1025-1055
(bz3_orig_size_sufficient_for_decode), include/common.h:23-25.
"""

import struct

KiB = 1024
MiB = 1024 * 1024

BLOCK_SIZE_MIN = 65 * KiB  # 66,560
BLOCK_SIZE_MAX = 511 * MiB  # 535,822,336

# Blocks shorter than this are stored as literals with no entropy coding
# (src/libbz3.c:596).
SMALL_BLOCK_THRESHOLD = 64

LZP_DICTIONARY_BITS = 18

_S32 = struct.Struct("<i")


def bound(input_size: int) -> int:
    """Worst-case single-block compressed size: n + n/50 + 32 (~2.03%)."""
    return input_size + input_size // 50 + 32


def bwt_bound(input_size: int) -> int:
    """Index-array bound used by the BWT stage (include/common.h:25)."""
    return bound(input_size) + 128


def validate_block_size(block_size: int) -> bool:
    return BLOCK_SIZE_MIN <= block_size <= BLOCK_SIZE_MAX


def min_memory_needed(block_size: int) -> int:
    """Working set of one block codec, 0 for an invalid block size: the
    swap buffer, the int32 suffix-rank array, the LZP hash table and the
    CM model tables (src/libbz3.c:999-1022)."""
    if not validate_block_size(block_size):
        return 0
    return (
        bound(block_size)  # swap buffer
        + bwt_bound(block_size) * 4  # suffix-rank array (int32)
        + (1 << LZP_DICTIONARY_BITS) * 4  # LZP hash table
        # CM model tables: C0 (256 u16) + C1 (256*256 u16) + C2 (512*17 u16)
        + (256 + 256 * 256 + 512 * 17) * 2
    )


def orig_size_sufficient_for_decode(block: bytes, orig_size: int) -> int:
    """Whether an ``orig_size``-byte buffer suffices to decode ``block``:
    1 if it does, 0 if not, -1 on a short or malformed header
    (src/libbz3.c:1025-1055).  Keeps the reference's header length
    ``9 + (model & 2) * 4 + (model & 4) * 4``, 8 and 16 extra bytes
    where the fields take 4 and 4."""
    if len(block) < 9:
        return -1
    if _S32.unpack_from(block, 4)[0] == -1:
        return 1
    model = block[8]
    if len(block) < 9 + (model & 2) * 4 + (model & 4) * 4:
        return -1
    off = 9
    lzp_size = rle_size = -1
    if model & 2:
        lzp_size = _S32.unpack_from(block, off)[0]
        off += 4
    if model & 4:
        rle_size = _S32.unpack_from(block, off)[0]
    return int(all(max(0, v) <= orig_size for v in (lzp_size, rle_size, orig_size)))
