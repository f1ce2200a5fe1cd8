"""Parallel-structure CM encoder (algorithm prototype).

The CM coder looks inherently bit-serial: every bit's probability
reads adaptive counters that all earlier bits updated.  But on the
ENCODE side every table index and every update direction is computable
ahead of time — the bits are the plaintext:

  * C0[ctx]'s visit sequence and directions: ctx at bit t is the byte's
    bit-prefix (data), direction is the bit itself.
  * C1[c1][ctx]: row = previous byte (data), same ctx/direction.
  * C2[(2ctx+f)|j]: f comes from byte runs (data); j = p >> 12 where p
    depends only on C0/C1 counter VALUES — available once phase A ran.

So the encoder decomposes into three phases:

  A. group C0/C1 events by table slot; every slot's value sequence is
     an independent chain p <- p ± (update) — chains evaluate in
     parallel across slots, and long chains can additionally be CUT
     into segments evaluated speculatively from a zero start: the
     updates contract (slope 3/4), so two states fed the same
     directions converge *exactly* within a bounded warmup (measured
     worst cases: 65 steps at rate 2, 278 at rate 4, 1221 at rate 6);
     a per-segment equality check against a second candidate certifies
     the result and falls back to sequential only on failure.
  B. combine phase-A values into p per bit, derive j and the C2 slots,
     run the C2 chains the same way.
  C. a final range-coder pass: ~20 ALU ops per bit, NO table state —
     it vectorizes across blocks (lanes) and is the only serial-in-n
     part left.

This module is the NumPy proof of the decomposition: output is
byte-identical to the serial coder (cm.cm_encode) — the test suite
enforces it.  The port's device encoder (``ops/device/cm_parallel.py``)
maps phase A/B onto sorts and the window passes of kernel P1, and phase
C onto kernel P2, one row a warp (``csrc/cm_parallel_kernels.cu``).
"""

import numpy as np

M32 = 0xFFFFFFFF
TOP = 1 << 24


def _chain_values(init, directions, rate):
    """Values of one counter chain BEFORE each event (vector in, out)."""
    out = np.empty(len(directions), dtype=np.int64)
    p = init
    for i, b in enumerate(directions):
        out[i] = p
        if b:
            p = p + ((p ^ 65535) >> rate)
        else:
            p = p - (p >> rate)
    return out


def _chain_values_segmented(init, directions, rate, seg=512, warmup=None):
    """Same as _chain_values but via speculative segments: each segment
    is evaluated from a speculative state obtained by replaying only a
    bounded warmup window before it, then certified by comparing with a
    second candidate start.  Mirrors the parallel evaluation the card
    runs (all segments at once); here sequential for clarity."""
    if warmup is None:
        warmup = {2: 96, 4: 384, 6: 1536}[rate]
    n = len(directions)
    if n <= seg + warmup:
        return _chain_values(init, directions, rate)
    out = np.empty(n, dtype=np.int64)
    # segment starts
    starts = list(range(0, n, seg))
    for s in starts:
        if s == 0:
            state = init
        else:
            w0 = max(0, s - warmup)
            # speculative replay from two candidate states
            a = _replay(0, directions[w0:s], rate)
            b = _replay(65535, directions[w0:s], rate)
            if a != b:
                # contraction not yet complete — certified fallback
                out[:] = _chain_values(init, directions, rate)
                return out
            state = a
        e = min(s + seg, n)
        out[s:e] = _chain_values(state, directions[s:e], rate)
    return out


def _replay(p, directions, rate):
    for b in directions:
        if b:
            p = p + ((p ^ 65535) >> rate)
        else:
            p = p - (p >> rate)
    return p


def cm_encode_parallel(data: bytes, seg: int = 512) -> bytes:
    """Bit-identical to ops.ref.cm.cm_encode via the 3-phase plan."""
    n = len(data)
    if n == 0:
        return b"\x00" * 4  # just the 4 flush bytes of low = 0
    buf = np.frombuffer(data, dtype=np.uint8).astype(np.int64)

    # ---- data-derived per-bit quantities (fully parallel) ----
    # bytes' bits, msb first
    bits = ((buf[:, None] >> np.arange(7, -1, -1)[None, :]) & 1).astype(np.int64)
    # ctx tree path: ctx at bit t = 1<<t | prefix(bits[:t])
    ctx = np.empty((n, 8), dtype=np.int64)
    acc = np.zeros(n, dtype=np.int64)
    for t in range(8):
        ctx[:, t] = (1 << t) | acc
        acc = (acc << 1) | bits[:, t]
    c1 = np.concatenate([[0], buf[:-1]])[:n]
    c2 = np.concatenate([[0, 0], buf[:-2]])[:n]
    run = np.zeros(n, dtype=np.int64)
    r = 0
    for i in range(n):  # run flag (simple linear pass; segmentable too)
        r = r + 1 if c1[i] == c2[i] else 0
        run[i] = r
    f = (run > 2).astype(np.int64)

    # ---- phase A: C0 and C1 chains grouped by slot ----
    # event (i, t) -> flattened time order is (i*8 + t)
    p0 = np.empty((n, 8), dtype=np.int64)
    p1 = np.empty((n, 8), dtype=np.int64)
    p2 = np.empty((n, 8), dtype=np.int64)

    # C0: slot = ctx value (1..255)
    flat_ctx = ctx.reshape(-1)
    flat_bits = bits.reshape(-1)
    order = np.argsort(flat_ctx, kind="stable")  # groups slots, time-sorted
    sorted_slots = flat_ctx[order]
    starts = np.flatnonzero(
        np.concatenate([[True], sorted_slots[1:] != sorted_slots[:-1]])
    )
    vals = np.empty(n * 8, dtype=np.int64)
    for si, s in enumerate(starts):
        e = starts[si + 1] if si + 1 < len(starts) else len(order)
        idxs = order[s:e]
        vals[idxs] = _chain_values_segmented(1 << 15, flat_bits[idxs], 2, seg)
    p0[:] = vals.reshape(n, 8)

    # C1 rows: updates keyed by (c1, ctx); reads of row c2 sample the
    # same chains between updates.
    upd_key = (np.repeat(c1, 8) << 8) | flat_ctx
    read_key = (np.repeat(c2, 8) << 8) | flat_ctx
    # merge reads (kind=0, see the pre-update value) and updates
    # (kind=1) on one timeline per slot
    keys = np.concatenate([upd_key, read_key])
    times = np.concatenate([np.arange(n * 8), np.arange(n * 8)])
    kinds = np.concatenate([np.ones(n * 8, np.int64), np.zeros(n * 8, np.int64)])
    bits2 = np.concatenate([flat_bits, flat_bits])
    order = np.lexsort((kinds, times, keys))
    sk = keys[order]
    starts = np.flatnonzero(np.concatenate([[True], sk[1:] != sk[:-1]]))
    merged_vals = np.empty(2 * n * 8, dtype=np.int64)
    for si, s in enumerate(starts):
        e = starts[si + 1] if si + 1 < len(starts) else len(order)
        idxs = order[s:e]
        p = 1 << 15
        for j in idxs:
            merged_vals[j] = p
            if kinds[j] == 1:  # update event advances the chain
                if bits2[j]:
                    p = p + ((p ^ 65535) >> 4)
                else:
                    p = p - (p >> 4)
    p1[:] = merged_vals[: n * 8].reshape(n, 8)
    p2[:] = merged_vals[n * 8 :].reshape(n, 8)

    # ---- phase B: p, j, C2 chains ----
    p = ((p0 + p1) * 7 + p2 + p2) >> 4
    j = p >> 12
    sse = (2 * ctx + f[:, None]) * 17 + j  # slot of x1; x2 = slot+1

    def c2_init(slot):
        k = slot % 17
        return (k << 12) - (1 if k == 16 else 0)

    # x1 and x2 are ADJACENT slots of one table: slot s is updated by
    # every event with sse == s (as x1) or sse == s-1 (as x2).  Each
    # sub-event reads its slot's pre-value then updates it, so one
    # unified (slot, time)-sorted event stream per slot suffices.
    flat_sse = sse.reshape(-1)
    slots = np.concatenate([flat_sse, flat_sse + 1])
    times2 = np.concatenate([np.arange(n * 8), np.arange(n * 8)])
    bits3 = np.concatenate([flat_bits, flat_bits])
    order = np.lexsort((times2, slots))
    ss = slots[order]
    starts = np.flatnonzero(np.concatenate([[True], ss[1:] != ss[:-1]]))
    vals = np.empty(2 * n * 8, dtype=np.int64)
    for si, s in enumerate(starts):
        e = starts[si + 1] if si + 1 < len(starts) else len(order)
        idxs = order[s:e]
        vals[idxs] = _chain_values_segmented(c2_init(ss[s]), bits3[idxs], 6, seg)
    x1 = vals[: n * 8].reshape(n, 8)
    x2 = vals[n * 8 :].reshape(n, 8)

    ssep = x1 + (((x2 - x1) * (p & 4095)) >> 12)
    width = ssep * 3 + p  # the per-bit coding probability, all parallel

    # ---- phase C: the only serial-in-n pass — no tables, ~15 ops/bit ----
    out = bytearray()
    low, high = 0, M32
    fw = width.reshape(-1)
    fb = flat_bits
    for e in range(n * 8):
        step = ((high - low) * int(fw[e])) >> 18
        if fb[e]:
            high = (low + step) & M32
        else:
            low = (low + step + 1) & M32
        while (low ^ high) < TOP:
            out.append(low >> 24)
            low = (low << 8) & M32
            high = ((high << 8) | 0xFF) & M32
    for _ in range(4):
        out.append(low >> 24)
        low = (low << 8) & M32
    return bytes(out)
