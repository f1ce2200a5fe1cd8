"""Size bounds and limits for the BZ3v1 format.

Reference semantics: src/libbz3.c:510 (bz3_bound), :536 (block size
limits), include/common.h:23-25.
"""

KiB = 1024
MiB = 1024 * 1024

BLOCK_SIZE_MIN = 65 * KiB  # 66,560
BLOCK_SIZE_MAX = 511 * MiB  # 535,822,336

# Blocks shorter than this are stored as literals with no entropy coding
# (src/libbz3.c:596).
SMALL_BLOCK_THRESHOLD = 64


def bound(input_size: int) -> int:
    """Worst-case single-block compressed size: n + n/50 + 32 (~2.03%)."""
    return input_size + input_size // 50 + 32


def validate_block_size(block_size: int) -> bool:
    return BLOCK_SIZE_MIN <= block_size <= BLOCK_SIZE_MAX
