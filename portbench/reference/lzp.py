"""LZP oracle: hash-indexed "Lempel-Ziv + Prediction" pre-pass.

Semantics (reference: src/libbz3.c:84-257):

A 32-bit context of the last 4 bytes is hashed into an 18-bit table of
positions.  When the table predicts an earlier position whose bytes
match the upcoming bytes for >= 40 bytes, the match is replaced by the
token byte 0xF2 followed by a base-254 continuation length; a literal
0xF2 that occurs while the table holds a prediction is escaped as
``0xF2 0xFF``.  A literal 0xF2 with no prediction (table slot empty)
needs no escape — the decoder only treats 0xF2 as a token when the
table slot is non-zero.

The encoder scans match lengths 4 bytes at a time and then extends by
at most 3 more bytes, so match lengths are word-granular + 0..3; it also
keeps a high-water mark ("heur") of bytes already known to mismatch to
skip doomed candidates.  Both quirks affect the emitted stream and are
reproduced here exactly so our encoded output is byte-identical to the
reference's.

A frozen copy of the port's ``ops/ref/lzp.py`` (``lzp_encode_plain``,
the byte loop), and ``lzp_encode``: the same loop over precomputed
4-byte words and context hashes, emitting literal runs as slices.
"""

import numpy as np

LZP_BITS = 18
LZP_MASK = (1 << LZP_BITS) - 1
MIN_MATCH = 40
MATCH = 0xF2


def _hash(ctx: int) -> int:
    return ((ctx >> 15) ^ ctx ^ (ctx >> 3)) & LZP_MASK


def _ctx_at(buf, i: int) -> int:
    """Context = last 4 bytes before position i, most recent in low byte."""
    return buf[i - 1] | (buf[i - 2] << 8) | (buf[i - 3] << 16) | (buf[i - 4] << 24)


def lzp_encode_plain(data: bytes) -> bytes | None:
    """Returns the LZP stream, or None when not applicable/expanding.

    Not applicable when the input is shorter than MIN_MATCH + 32
    (src/libbz3.c:244) or when the output would reach within 8 bytes of
    the input length (the encoder's out_eob guard).
    """
    n = len(data)
    if n < MIN_MATCH + 32:
        return None
    buf = data
    lut = [0] * (1 << LZP_BITS)
    out = bytearray()
    out_cap = n - 8  # out_eob: encoding is pointless past this
    scan_end = n - MIN_MATCH - 32  # main-loop horizon

    out += buf[:4]
    i = 4
    ctx = _ctx_at(buf, i)
    heur = 0

    while i < scan_end and len(out) < out_cap:
        idx = _hash(ctx)
        val = lut[idx]
        lut[idx] = i
        matched = False
        if val > 0:
            # Cheap 4-byte probes at offset MIN_MATCH-4 and offset 0.
            if (
                buf[i + MIN_MATCH - 4 : i + MIN_MATCH] == buf[val + MIN_MATCH - 4 : val + MIN_MATCH]
                and buf[i : i + 4] == buf[val : val + 4]
            ):
                reject = False
                if heur > i and buf[heur : heur + 4] != buf[val + heur - i : val + heur - i + 4]:
                    reject = True
                if not reject:
                    ln = 4
                    while i + ln < scan_end:
                        if buf[i + ln : i + ln + 4] != buf[val + ln : val + ln + 4]:
                            break
                        ln += 4
                    if ln < MIN_MATCH:
                        if heur < i + ln:
                            heur = i + ln
                    else:
                        for _ in range(3):
                            if buf[i + ln] == buf[val + ln]:
                                ln += 1
                        i += ln
                        ctx = _ctx_at(buf, i)
                        out.append(MATCH)
                        rem = ln - MIN_MATCH
                        while rem >= 254:
                            rem -= 254
                            out.append(254)
                            if len(out) >= out_cap:
                                break
                        out.append(rem)
                        matched = True
            if not matched:
                b = buf[i]
                i += 1
                out.append(b)
                ctx = ((ctx << 8) | b) & 0xFFFFFFFF
                if b == MATCH:
                    out.append(255)
        else:
            b = buf[i]
            i += 1
            out.append(b)
            ctx = ((ctx << 8) | b) & 0xFFFFFFFF

    ctx = _ctx_at(buf, i)
    while i < n and len(out) < out_cap:
        idx = _hash(ctx)
        val = lut[idx]
        lut[idx] = i
        b = buf[i]
        i += 1
        out.append(b)
        ctx = ((ctx << 8) | b) & 0xFFFFFFFF
        if b == MATCH and val > 0:
            out.append(255)

    if len(out) >= out_cap:
        return None
    return bytes(out)


def lzp_encode(data: bytes) -> bytes | None:
    """``lzp_encode_plain`` over precomputed words: the context before
    position i is the big-endian word at i - 4, and the encoder's 4-byte
    compares are compares of words, so both come from one vectorized
    pass; literal runs are emitted as slices of the input."""
    n = len(data)
    if n < MIN_MATCH + 32:
        return None
    b = np.frombuffer(data, np.uint8).astype(np.uint32)
    w = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    hashes = ((w >> 15) ^ w ^ (w >> 3)) & LZP_MASK
    W = w.tolist()
    H = [0, 0, 0, 0] + hashes.tolist()  # H[i]: hash of the context before i
    del b, w, hashes
    buf = data
    lut = [0] * (1 << LZP_BITS)
    parts = [buf[:4]]
    out_len = 4
    out_cap = n - 8
    scan_end = n - MIN_MATCH - 32
    i = lit = 4
    heur = 0
    m4, tok_byte = MIN_MATCH - 4, MATCH
    while i < scan_end and out_len < out_cap:
        h = H[i]
        val = lut[h]
        lut[h] = i
        if val > 0 and W[i + m4] == W[val + m4] and W[i] == W[val] and not (
            heur > i and W[heur] != W[val + heur - i]
        ):
            ln = 4
            while i + ln < scan_end and W[i + ln] == W[val + ln]:
                ln += 4
            if ln < MIN_MATCH:
                if heur < i + ln:
                    heur = i + ln
            else:
                for _ in range(3):
                    if buf[i + ln] == buf[val + ln]:
                        ln += 1
                parts.append(buf[lit:i])
                tok = bytearray([MATCH])
                out_len += 1
                rem = ln - MIN_MATCH
                while rem >= 254:
                    rem -= 254
                    tok.append(254)
                    out_len += 1
                    if out_len >= out_cap:
                        break
                tok.append(rem)
                out_len += 1
                parts.append(bytes(tok))
                i += ln
                lit = i
                continue
        c = buf[i]
        i += 1
        out_len += 1
        if c == tok_byte and val > 0:
            parts.append(buf[lit:i])
            parts.append(b"\xff")
            out_len += 1
            lit = i
    while i < n and out_len < out_cap:
        h = H[i]
        val = lut[h]
        lut[h] = i
        c = buf[i]
        i += 1
        out_len += 1
        if c == MATCH and val > 0:
            parts.append(buf[lit:i])
            parts.append(b"\xff")
            out_len += 1
            lit = i
    if out_len >= out_cap:
        return None
    parts.append(buf[lit:i])
    return b"".join(parts)
