"""Work counts, peaks and rooflines of the port's kernels, as functions
of what an op moved: its rows, payloads and bit steps.  They read the
same whatever implements a stage.

Peaks are NVIDIA's published figures for one H100 SXM (data sheet,
dense rates) at its full 700 W; a card set lower runs slower, so a share
is stated with the card's ``power.limit`` beside it.  The CM coder's work
is integer and logic operations, which issue on the same 32-bit pipes as
the float32 non-tensor rate, so that rate is its peak (an assumption).
"""

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_OPS_PER_S = 67e12  # 32-bit non-tensor
PEAK_WATTS = 700.0

# Integer and logic operations of one CM bit step (predict: 3 counter
# loads, the mix, the SSE index, 2 loads, the interpolation; the range
# split: a 64-bit product and a shift; the branch; the renorm test; four
# counter updates; the context update), counted from the port's
# csrc/cm_kernels.cu: an assumed count, stated here.
OPS_PER_BIT = 40
# K4 a byte: a 16-byte unit takes one load, 16 table loads, 32 index
# operations and 18 xors, and its round shift 4 table loads, 7 index
# operations and 4 xors: 82 a unit, 5 a byte (csrc/crc32_kernels.cu).
OPS_PER_CRC_BYTE = 5
# K5/K6 a byte: the LZP state machine's step (hash, table load and
# store, tests of slot and token, byte load and store, context update,
# loop tests), counted from csrc/lzp_kernels.cu.
OPS_PER_LZP_STEP = 18


def cm_work(rows: list[int], payloads: list[int]) -> tuple[int, int]:
    """(bytes, operations) of one CM encode or decode of ``rows`` (bytes
    a row, the BWT's output) to or from ``payloads``: each row and payload
    byte moved once, the [K] lengths read and written, and 8 bit steps a
    row byte."""
    return sum(rows) + sum(payloads) + 8 * len(rows), OPS_PER_BIT * 8 * sum(rows)


def crc_work(rows: list[int], lanes: int) -> tuple[int, int]:
    """K4 over ``rows`` split in ``lanes`` lanes a row: every byte read
    once, [K, lanes] int32 states and [K] lengths written."""
    return sum(rows) + 4 * len(rows) * lanes + 4 * len(rows), OPS_PER_CRC_BYTE * sum(rows)


def lzp_work(inputs: list[int], outputs: list[int], steps: list[int]) -> tuple[int, int]:
    """K5 or K6: ``inputs`` read, ``outputs`` written, one step a byte of
    ``steps`` (the uncompressed side)."""
    return sum(inputs) + sum(outputs) + 8 * len(inputs), OPS_PER_LZP_STEP * sum(steps)


def least_seconds(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def roofline_pct(nbytes: int, ops: int, seconds: float) -> float | None:
    """Share of the roofline, in %: least time over the time taken."""
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(nbytes, ops)[0] / seconds
