"""mRLE oracle: per-byte-value gated run-length coding.

Semantics (reference: mrlec/mrled, src/libbz3.c:259-329):

Encode is two passes.  Pass 1 computes, for every byte value c, a gain
counter t[c]: +1 for every repeat occurrence inside a run (except each
255th repeat, which would cost a continuation byte), -1 for every
run-start occurrence (the header byte pc + length byte cost).  Pass 2
emits a 32-byte bitmap of which values have t[c] > 0, then re-scans the
input: runs of gated values are collapsed to ``value, [255]*k,
length-1-255k``; everything else is copied verbatim.

Decode re-derives the gate bitmap and expands runs.  A run whose stream
ends inside its length bytes is mrled's terminator rule: each 255 adds
255 and the last byte read adds itself plus one again, so
``b"\\xff" * 32 + b"a\\xff"`` decodes to ``b"a"`` (src/libbz3.c:303-329).
"""

import numpy as np


def _gain_table(buf: np.ndarray) -> np.ndarray:
    """Pass-1 gain counters t[0..255] (vectorized).

    For each position i: if buf[i] == buf[i-1] it is a repeat; a repeat
    increments t unless it is the 255th, 510th, ... consecutive repeat.
    A non-repeat (including i == 0) decrements t.
    """
    t = np.zeros(256, dtype=np.int64)
    n = len(buf)
    if n == 0:
        return t
    b = buf.astype(np.int64)
    is_rep = np.empty(n, dtype=bool)
    is_rep[0] = False
    is_rep[1:] = b[1:] == b[:-1]
    # run position: number of consecutive repeats ending at i (the C
    # code's ++run value), a cumulative count reset at non-repeats.
    idx = np.arange(n)
    last_nonrep = np.maximum.accumulate(np.where(~is_rep, idx, -1))
    runpos = idx - last_nonrep  # 0 at run starts, 1,2,... inside runs
    inc = is_rep & ((runpos % 255) != 0)
    np.add.at(t, b[inc], 1)
    np.subtract.at(t, b[~is_rep], 1)
    return t


def rle_encode(data: bytes) -> bytes:
    buf = np.frombuffer(data, dtype=np.uint8)
    t = _gain_table(buf)

    out = bytearray()
    # 32-byte gate bitmap: bit j of byte i <=> t[i*8+j] > 0.
    gate = t > 0
    for i in range(32):
        byte = 0
        for j in range(8):
            byte |= int(gate[i * 8 + j]) << j
        out.append(byte)

    # Pass 2: walk runs.
    n = len(buf)
    i = 0
    while i < n:
        c = int(buf[i])
        j = i + 1
        while j < n and buf[j] == c:
            j += 1
        run = j - i
        if gate[c]:
            out.append(c)
            while run > 255:
                out.append(255)
                run -= 255
            out.append(run - 1)
        else:
            out.extend(bytes([c]) * run)
        i = j
    return bytes(out)


def rle_decode(data: bytes, out_len: int) -> bytes | None:
    """Expand an mRLE stream to exactly ``out_len`` bytes.

    Returns None on malformed input (the reference returns nonzero from
    mrled, src/libbz3.c:303-329).
    """
    if len(data) < 32:
        return None
    gate = np.zeros(256, dtype=bool)
    for i in range(32):
        b = data[i]
        for j in range(8):
            gate[i * 8 + j] = (b >> j) & 1

    out = bytearray()
    ip, n = 32, len(data)
    while len(out) < out_len and ip < n:
        c = data[ip]
        ip += 1
        if gate[c]:
            run = 0
            pc = -1  # stays -1 if the stream ends here => run == 0
            while ip < n:
                pc = data[ip]
                ip += 1
                if pc != 255:
                    break
                run += 255
            run += pc + 1
            take = min(run, out_len - len(out))
            out.extend(bytes([c]) * take)
        else:
            out.append(c)
    if len(out) != out_len:
        return None
    return bytes(out)
