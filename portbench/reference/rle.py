"""mRLE: per-byte-value gated run-length coding (src/libbz3.c:259-329),
the encoder of the port's ``ops/ref/rle.py`` (frozen copy:
``rle_encode_plain``) and the same encoder with its second pass over
whole runs at once (``rle_encode``).

Pass 1 computes, for every byte value c, a gain counter t[c]: +1 for
every repeat occurrence inside a run (except each 255th repeat), -1 for
every run-start occurrence.  Pass 2 emits a 32-byte bitmap of the values
with t[c] > 0, then the input with runs of gated values collapsed to
``value, [255]*k, length-1-255k``; everything else is copied verbatim.
``rle_size`` gives the length of that output from the runs alone.
"""

import numpy as np


def _gain_table(buf: np.ndarray) -> np.ndarray:
    """Pass-1 gain counters t[0..255]."""
    t = np.zeros(256, dtype=np.int64)
    n = len(buf)
    if n == 0:
        return t
    b = buf.astype(np.int64)
    is_rep = np.empty(n, dtype=bool)
    is_rep[0] = False
    is_rep[1:] = b[1:] == b[:-1]
    idx = np.arange(n)
    last_nonrep = np.maximum.accumulate(np.where(~is_rep, idx, -1))
    runpos = idx - last_nonrep
    inc = is_rep & ((runpos % 255) != 0)
    np.add.at(t, b[inc], 1)
    np.subtract.at(t, b[~is_rep], 1)
    return t


def rle_encode_plain(data: bytes) -> bytes:
    buf = np.frombuffer(data, dtype=np.uint8)
    t = _gain_table(buf)
    out = bytearray()
    gate = t > 0
    for i in range(32):
        byte = 0
        for j in range(8):
            byte |= int(gate[i * 8 + j]) << j
        out.append(byte)
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


def rle_encode(data: bytes) -> bytes:
    """``rle_encode_plain``: a gated run of r bytes of c becomes c, then
    k = (r - 1) // 255 bytes 255, then r - 255k - 1."""
    buf = np.frombuffer(data, dtype=np.uint8)
    gate = _gain_table(buf) > 0
    head = np.packbits(gate.reshape(32, 8), axis=1, bitorder="little").ravel()
    n = len(buf)
    if n == 0:
        return head.tobytes()
    starts = np.flatnonzero(np.concatenate(([True], buf[1:] != buf[:-1])))
    lens = np.diff(np.append(starts, n))
    vals = buf[starts]
    g = gate[vals]
    k = (lens - 1) // 255
    out_len = np.where(g, k + 2, lens)
    out = np.repeat(vals, out_len)
    offs = np.cumsum(out_len) - out_len
    gi = np.flatnonzero(g)
    kg = k[gi]
    fill = np.repeat(offs[gi] + 1, kg) + (np.arange(int(kg.sum())) - np.repeat(np.cumsum(kg) - kg, kg))
    out[fill] = 255
    out[offs[gi] + 1 + kg] = (lens[gi] - 255 * kg - 1).astype(np.uint8)
    return head.tobytes() + out.tobytes()


def rle_size(data: bytes) -> int:
    """``len(rle_encode(data))``: a run of r bytes of c adds
    (r - 1) - (r - 1) // 255 - 1 to t[c], and takes (r - 1) // 255 + 2
    bytes when c is gated, r bytes when not."""
    buf = np.frombuffer(data, dtype=np.uint8)
    n = len(buf)
    if n == 0:
        return 32
    starts = np.flatnonzero(np.concatenate(([True], buf[1:] != buf[:-1])))
    rep = np.diff(np.append(starts, n)) - 1
    vals = buf[starts]
    k = rep // 255
    gate = np.bincount(vals, weights=rep - k - 1, minlength=256) > 0
    return 32 + int(np.where(gate[vals], k + 2, rep + 1).sum())
