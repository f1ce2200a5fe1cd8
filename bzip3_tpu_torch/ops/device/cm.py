"""Context-mixing binary range coder, plain PyTorch over K rows.

Bit-exact with the reference coder (src/libbz3.c:331-494) and the JAX
package's ``ops/device/cm.py``.  Each row of a [K, N] batch is one
independent block with its own model; the rows advance in lockstep, one
bit step at a time, as [K] tensor operations.  This is the plain
version of the CUDA kernels K1/K2 (``cm_cuda.py``): the tests hold it
against the JAX package, and ``chip_smoke.py`` holds the kernels
against it.

Model state per row (``state`` in src/libbz3.c:333-342):
  C0[256], C1[256*256], C2[512*17]  adaptive 16-bit counters
  low/high 32-bit range, c1/c2 previous bytes, run counter.

Range state is int64 masked to 32 bits.  The range split
``((high - low) * (ssep * 3 + p)) >> 18`` is one int64 product: the
operands are below 2^32 and 2^18.

Rows are coded longest first, and a row leaves the batch once its
bytes are done (the encoder flushes it then), so no step carries masks
for finished rows.
"""

from __future__ import annotations

import torch

TOP = 1 << 24
M32 = 0xFFFFFFFF
C0_SIZE = 256
C1_SIZE = 256 * 256
C2_SIZE = 512 * 17


def cm_fresh_tables(k_dim: int, device=None):
    """Per-row model tables (src/libbz3.c:350-358) as int32 [K, *]."""
    c0 = torch.full((k_dim, C0_SIZE), 1 << 15, dtype=torch.int32, device=device)
    c1 = torch.full((k_dim, C1_SIZE), 1 << 15, dtype=torch.int32, device=device)
    row = torch.tensor(
        [(k << 12) - (1 if k == 16 else 0) for k in range(17)],
        dtype=torch.int32,
        device=device,
    )
    c2 = row.repeat(512).repeat(k_dim, 1)
    return c0, c1, c2


class _Model:
    """The rows' tables in one flat int64 tensor, [C0 | C1 | C2] with
    each row's part contiguous.  A bit step reads its three counters
    with one gather, its two SSE knots with another, and writes all
    four updates with one scatter."""

    def __init__(self, k_dim: int, device):
        c0, c1, c2 = cm_fresh_tables(k_dim, device)
        self.t = torch.cat([c0.view(-1), c1.view(-1), c2.view(-1)]).long()
        rows = torch.arange(k_dim, dtype=torch.int64, device=device)
        self.r0 = rows * C0_SIZE
        self.r1 = k_dim * C0_SIZE + rows * C1_SIZE
        self.r2 = k_dim * (C0_SIZE + C1_SIZE) + rows * C2_SIZE
        self.mix = torch.tensor([[7], [7], [2]], device=device)  # p0, p1, p2
        self.rates = torch.tensor([[2], [4], [6], [6]], device=device)  # src/libbz3.c:347-348
        self.knots = torch.tensor([[0], [1]], device=device)

    def keep(self, k: int) -> None:
        """Drop all rows but the first k."""
        self.r0, self.r1, self.r2 = self.r0[:k], self.r1[:k], self.r2[:k]

    def start_byte(self, c1, c2, f) -> None:
        """Per-byte bases: the C0 table, the C1 rows of the two previous
        bytes (as one [3k] vector) and the SSE row of run flag f."""
        self.base3 = torch.cat([self.r0, self.r1 + (c1 << 8), self.r1 + (c2 << 8)])
        self.sse_base = self.r2 + f * 17

    def predict(self, ctx3):
        """(p, ssep) for context ctx, given as [3k] (ctx three times), and
        the counters the update writes (src/libbz3.c:376-387)."""
        k = ctx3.shape[0] // 3
        i3 = self.base3 + ctx3
        v = self.t.index_select(0, i3)
        p = (v.view(3, k) * self.mix).sum(0) >> 4
        sse = self.sse_base + ctx3[:k] * 34 + (p >> 12)  # (2*ctx + f)*17 + p/4096
        knots = sse + self.knots  # [2, k]
        x = self.t.index_select(0, knots.view(-1)).view(2, k)
        ssep = x[0] + (((x[1] - x[0]) * (p & 4095)) >> 12)
        idx = torch.cat([i3[: 2 * k], knots.view(-1)])  # C0, C1 of c1, both knots
        old = torch.cat([v[: 2 * k], x.view(-1)]).view(4, k)
        return p, ssep, (idx, old)

    def update(self, state, bit) -> None:
        """Counter updates toward the coded bit ([k] bool)."""
        idx, old = state
        r = self.rates
        new = torch.where(bit, old + ((old ^ 65535) >> r), old - (old >> r))
        self.t.index_copy_(0, idx, new.view(-1))


def _next_ctx(ctx3, bit_long):
    """ctx = 2*ctx + bit on the [3k] repeated context."""
    k = bit_long.shape[0]
    return (ctx3.view(3, k) * 2 + bit_long).view(-1)


def cm_encode_batch(data: torch.Tensor, lengths: torch.Tensor, out_width: int | None = None):
    """Encode each row data[k, :lengths[k]] with a fresh model.

    data: [K, N] uint8; lengths: [K] int32.  Returns (out [K, W] uint8,
    out_lens [K] int32), W = ``out_width`` or N + N//8 + 64.  A row whose
    payload exceeds W keeps counting: its length is the true one and
    its writes past W are dropped.  Bytes past a row's length are 0.
    """
    k_dim, n = data.shape
    dev = data.device
    w = out_width if out_width is not None else n + n // 8 + 64
    lens = lengths.long().clamp(0, n)
    order = torch.argsort(lens, descending=True, stable=True)
    ends = lens[order].tolist()  # row j (in coding order) ends after ends[j] bytes
    x = data.index_select(0, order).long()
    model = _Model(k_dim, dev)
    # column w of each row is the sink for dropped writes
    out = torch.zeros(k_dim * (w + 1), dtype=torch.uint8, device=dev)
    orow = torch.arange(k_dim, dtype=torch.int64, device=dev) * (w + 1)
    low = torch.zeros(k_dim, dtype=torch.int64, device=dev)
    high = torch.full((k_dim,), M32, dtype=torch.int64, device=dev)
    optr = torch.zeros_like(low)
    c1 = torch.zeros_like(low)
    c2 = torch.zeros_like(low)
    run = torch.zeros_like(low)
    out_lens = torch.zeros_like(low)
    shifts = torch.arange(7, -1, -1, device=dev)[:, None]

    def emit(byte, orow, optr, do=None):
        ok = optr < w if do is None else do & (optr < w)
        out[orow + torch.where(ok, optr, w)] = byte.to(torch.uint8)
        return optr + 1 if do is None else optr + do.long()

    def flush(lo: int, hi: int):  # src/libbz3.c:426-433
        lw, op = low[lo:hi], optr[lo:hi]
        for _ in range(4):
            op = emit(lw >> 24, orow[lo:hi], op)
            lw = (lw << 8) & M32
        out_lens[lo:hi] = op

    k = k_dim
    for i in range(ends[0] if k_dim else 0):
        if ends[k - 1] <= i:  # rows that are done leave the batch
            k_new = next(j for j in range(k) if ends[j] <= i)
            flush(k_new, k)
            k = k_new
            low, high, optr, c1, c2, run = (a[:k] for a in (low, high, optr, c1, c2, run))
            orow, x = orow[:k], x[:k]
            model.keep(k)
        c = x[:, i]
        run = torch.where(c1 == c2, run + 1, 0)
        model.start_byte(c1, c2, (run > 2).long())
        bits = (c[None, :] >> shifts) & 1  # [8, k], most significant first
        is_one = bits == 1
        ctx3 = torch.ones(3 * k, dtype=torch.int64, device=dev)
        for t in range(8):
            bit = is_one[t]
            p, ssep, state = model.predict(ctx3)
            mid = low + (((high - low) * (ssep * 3 + p)) >> 18)
            high = torch.where(bit, mid, high)
            low = torch.where(bit, low, mid + 1)
            for _ in range(4):  # renorm: at most 4 bytes per bit
                do = (low ^ high) < TOP
                if not bool(do.any()):
                    break
                optr = emit(low >> 24, orow, optr, do)
                low = torch.where(do, (low << 8) & M32, low)
                high = torch.where(do, ((high << 8) & M32) | 0xFF, high)
            model.update(state, bit)
            ctx3 = _next_ctx(ctx3, bits[t])
        c2 = c1
        c1 = ctx3[:k] & 255
    flush(0, k)

    res = torch.empty((k_dim, w), dtype=torch.uint8, device=dev)
    res[order] = out.view(k_dim, w + 1)[:, :w]
    res_lens = torch.empty(k_dim, dtype=torch.int32, device=dev)
    res_lens[order] = out_lens.int()
    return res, res_lens


def cm_decode_batch(
    data: torch.Tensor, in_lens: torch.Tensor, out_lens: torch.Tensor, out_width: int
):
    """Decode out_lens[k] bytes from each row of data [K, M] uint8.

    Returns [K, out_width] uint8 (zero past each row's length).  Input
    past in_lens[k] (clamped to M) reads as -1: an exhausted stream
    shifts in ``(code << 8) - 1`` (src/libbz3.c:346,437-440).
    """
    k_dim, m = data.shape
    dev = data.device
    outl = out_lens.long().clamp(0, out_width)
    order = torch.argsort(outl, descending=True, stable=True)
    ends = outl[order].tolist()
    inl = in_lens.long().clamp(0, m).index_select(0, order)
    flat = torch.cat(
        [data.index_select(0, order), torch.zeros((k_dim, 1), dtype=torch.uint8, device=dev)],
        dim=1,
    ).view(-1)
    irow = torch.arange(k_dim, dtype=torch.int64, device=dev) * (m + 1)
    model = _Model(k_dim, dev)
    out = torch.zeros((k_dim, out_width), dtype=torch.uint8, device=dev)

    def read(ip, irow, inl):
        byte = flat[irow + ip.clamp(max=m)].long()
        return torch.where(ip < inl, byte, M32)

    low = torch.zeros(k_dim, dtype=torch.int64, device=dev)
    high = torch.full((k_dim,), M32, dtype=torch.int64, device=dev)
    code = torch.zeros_like(low)
    ip = torch.zeros_like(low)
    for _ in range(4):
        code = ((code << 8) + read(ip, irow, inl)) & M32
        ip = ip + 1
    c1 = torch.zeros_like(low)
    c2 = torch.zeros_like(low)
    run = torch.zeros_like(low)

    k = k_dim
    for i in range(ends[0] if k_dim else 0):
        if ends[k - 1] <= i:  # rows that are done leave the batch
            k = next(j for j in range(k) if ends[j] <= i)
            low, high, code, ip, c1, c2, run = (
                a[:k] for a in (low, high, code, ip, c1, c2, run)
            )
            irow, inl = irow[:k], inl[:k]
            model.keep(k)
        run = torch.where(c1 == c2, run + 1, 0)
        model.start_byte(c1, c2, (run > 2).long())
        ctx3 = torch.ones(3 * k, dtype=torch.int64, device=dev)
        for _t in range(8):
            p, ssep, state = model.predict(ctx3)
            mid = low + (((high - low) * (ssep * 3 + p)) >> 18)
            bit = code <= mid
            high = torch.where(bit, mid, high)
            low = torch.where(bit, low, mid + 1)
            for _ in range(4):
                do = (low ^ high) < TOP
                if not bool(do.any()):
                    break
                byte = read(ip, irow, inl)
                low = torch.where(do, (low << 8) & M32, low)
                high = torch.where(do, ((high << 8) & M32) | 0xFF, high)
                code = torch.where(do, ((code << 8) + byte) & M32, code)
                ip = ip + do.long()
            model.update(state, bit)
            ctx3 = _next_ctx(ctx3, bit.long())
        c2 = c1
        c1 = ctx3[:k] & 255
        out[:k, i] = c1.to(torch.uint8)

    res = torch.empty_like(out)
    res[order] = out
    return res
