"""Context-mixing binary arithmetic coder oracle.

Semantics (reference: src/libbz3.c:331-494, a Mahoney-DCE-style coder):

Each byte is coded as 8 binary decisions walking a context tree
(ctx starts at 1; after 8 bits ctx is 256..511 and the low 8 bits are
the byte).  The bit probability mixes three adaptive u16 counters:

    p  = ((C0[ctx] + C1[prev1][ctx]) * 7 + 2 * C1[prev2][ctx]) >> 4

then an SSE/APM stage C2 with 17 interpolation knots refines it; the
coding probability is (ssep * 3 + p) / 2**18.  Counter updates shift
toward 0/65535 with learning rates 2 (C0), 4 (C1) and 6 (C2).  The
range coder is 32-bit with byte renormalization while the top byte of
low and high agree.  A run flag (same byte repeated > 2 times) selects
the odd half of the C2 contexts.

The encoder flushes 4 bytes of ``low`` at the end.  The decoder, when
it exhausts its input, shifts in 0xFF... via ``(code << 8) - 1`` —
matching the reference's ``(code << 8) + (u32)(-1)`` underread.

Implemented with flat Python lists; a frozen copy of the port's
``ops/ref/cm.py`` (numpy-free, standard library only).  The coder never
carries into bytes it has emitted, so the payload of a prefix of the
input, less its 4 flush bytes, is a prefix of the whole input's payload.
"""

M32 = 0xFFFFFFFF
TOP = 1 << 24


def _fresh_tables():
    """C0[256], C1[256*256] flat, C2[512*17] flat (src/libbz3.c:350-358)."""
    C0 = [1 << 15] * 256
    C1 = [1 << 15] * (256 * 256)
    row = [(k << 12) - (1 if k == 16 else 0) for k in range(17)]
    C2 = row * 512
    return C0, C1, C2


def cm_encode(data: bytes) -> bytes:
    C0, C1, C2 = _fresh_tables()
    out = bytearray()
    high, low = M32, 0
    c1 = c2 = 0
    run = 0

    for c in data:
        if c1 == c2:
            run += 1
        else:
            run = 0
        f = 1 if run > 2 else 0
        c1base = c1 << 8
        c2base = c2 << 8

        ctx = 1
        while ctx < 256:
            p0 = C0[ctx]
            p1 = C1[c1base + ctx]
            p2 = C1[c2base + ctx]
            p = ((p0 + p1) * 7 + p2 + p2) >> 4

            j = p >> 12
            sse = (2 * ctx + f) * 17 + j
            x1 = C2[sse]
            x2 = C2[sse + 1]
            ssep = x1 + (((x2 - x1) * (p & 4095)) >> 12)

            step = ((high - low) * (ssep * 3 + p)) >> 18
            if c & 128:
                high = low + step
                while (low ^ high) < TOP:
                    out.append(low >> 24)
                    low = (low << 8) & M32
                    high = ((high << 8) | 0xFF) & M32
                C0[ctx] = p0 + ((p0 ^ 65535) >> 2)
                C1[c1base + ctx] = p1 + ((p1 ^ 65535) >> 4)
                C2[sse] = x1 + ((x1 ^ 65535) >> 6)
                C2[sse + 1] = x2 + ((x2 ^ 65535) >> 6)
                ctx = ctx + ctx + 1
            else:
                low = low + step + 1
                while (low ^ high) < TOP:
                    out.append(low >> 24)
                    low = (low << 8) & M32
                    high = ((high << 8) | 0xFF) & M32
                C0[ctx] = p0 - (p0 >> 2)
                C1[c1base + ctx] = p1 - (p1 >> 4)
                C2[sse] = x1 - (x1 >> 6)
                C2[sse + 1] = x2 - (x2 >> 6)
                ctx = ctx + ctx
            c = (c << 1) & 0xFF

        c2 = c1
        c1 = ctx & 255

    for _ in range(4):
        out.append(low >> 24)
        low = (low << 8) & M32
    return bytes(out)
