"""Context-mixing binary range coder, plain PyTorch over K rows.

Bit-exact with the reference coder (src/libbz3.c:331-494) and the JAX
package's ``ops/device/cm.py``.  Each row of a [K, N] batch is one
independent block with its own model; the rows advance in lockstep, one
bit step at a time, as [K] tensor operations.  This is the plain
version of the CUDA kernels K1/K2 and of their resumable forms K3a-K3c
(``cm_cuda.py``): the tests hold it against the JAX package, and
``chip_smoke.py`` holds the kernels against it.

Model state per row (``state`` in src/libbz3.c:333-342):
  C0[256], C1[256*256], C2[512*17]  adaptive 16-bit counters
  low/high 32-bit range, c1/c2 previous bytes, run counter.

Range state is int64 masked to 32 bits.  The range split
``((high - low) * (ssep * 3 + p)) >> 18`` is one int64 product: the
operands are below 2^32 and 2^18.  The renorm after a bit takes its
byte count in closed form (``renorm_count``) and shifts once, as the
kernels do; the decoder shifts in that many code bytes from a window of
the next 32 payload bytes gathered at the byte's start (a bit takes at
most 4).

A coder is a state object (``_EncodeState``, ``_DecodeState``) and a
function that runs its rows over the steps (bytes) ``[start, stop)``
of one window.  The one-shot coders run a single window over all
steps; the resumable ones run windows of ``chunk_steps`` with the state
carried between them, as the kernels carry it between launches.  A
row's 4-byte flush happens once, in the window where the row ends (a
row of length 0 in the first window); a row that ended earlier is left
untouched.  Rows are held longest first, so the rows still coding at
any step are a prefix, and a row leaves the batch once its bytes are
done: no step carries masks for finished rows.
"""

from __future__ import annotations

import os

import torch

M32 = 0xFFFFFFFF
C0_SIZE = 256
C1_SIZE = 256 * 256
C2_SIZE = 512 * 17


def default_chunk_steps() -> int:
    """Steps (bytes) a resumable window codes: ``BZ3_TPU_CM_CHUNK_MI``
    MiB, 16 by default, the JAX package's launch chunk."""
    return int(os.environ.get("BZ3_TPU_CM_CHUNK_MI", "16")) << 20


def windows(n: int, chunk_steps: int) -> list[tuple[int, int]]:
    """[start, stop) windows of ``chunk_steps`` over n steps; one empty
    window when n is 0, so that empty rows are still flushed."""
    if chunk_steps <= 0:
        raise ValueError(f"chunk_steps must be positive, got {chunk_steps}")
    return [(s, min(s + chunk_steps, n)) for s in range(0, n, chunk_steps)] or [(0, 0)]


def renorm_count(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Bytes the coder shifts out after a bit: the count of leading zero
    bytes of the 32-bit ``low ^ high``, 4 when they are equal.  The
    reference's renorm loop (src/libbz3.c:331-494) runs while the top
    byte of ``low ^ high`` is 0, and each turn shifts its next byte up."""
    lims = torch.tensor([1 << 24, 1 << 16, 1 << 8, 1], device=low.device)
    return ((low ^ high).unsqueeze(-1) < lims).sum(-1)


def _renorm(low, high, k):
    """low << 8k and (high << 8k) | (2^8k - 1), to 32 bits."""
    sh = k << 3
    return (low << sh) & M32, (((high + 1) << sh) - 1) & M32


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
    each row's part contiguous.

    One byte visits 8 contexts (nodes 1..255 of the bit tree), each once,
    and their counters and SSE knots lie at distinct places, so every
    read of a byte can come before its first update: ``predict`` gathers
    the predictions of a byte's contexts (the encoder knows all 8, the
    decoder takes all 256 nodes and picks as it goes) and ``update``
    writes the 8 visited contexts' counters in one scatter after the
    byte."""

    def __init__(self, k_dim: int, device):
        c0, c1, c2 = cm_fresh_tables(k_dim, device)
        self.t = torch.cat([c0.view(-1), c1.view(-1), c2.view(-1)]).long()
        rows = torch.arange(k_dim, dtype=torch.int64, device=device)
        self.bases = (
            rows * C0_SIZE,
            k_dim * C0_SIZE + rows * C1_SIZE,
            k_dim * (C0_SIZE + C1_SIZE) + rows * C2_SIZE,
        )
        self.keep(k_dim)
        self.mix = torch.tensor([7, 7, 2], device=device)[:, None, None]  # p0, p1, p2
        # src/libbz3.c:347-348: C0, C1, both SSE knots
        self.rates = torch.tensor([2, 4, 6, 6], device=device)[:, None, None]
        self.knots = torch.tensor([0, 1], device=device)[:, None, None]
        self.nodes = torch.arange(256, device=device)[:, None]  # node 0 is never visited

    def keep(self, k: int) -> None:
        """Code the first k rows only."""
        self.r0, self.r1, self.r2 = (b[:k] for b in self.bases)

    def predict(self, c1, c2, f, ctx):
        """``ssep * 3 + p`` (src/libbz3.c:376-387), the range split factor,
        for contexts ctx [T, k] of the next byte after bytes c1, c2 with
        run flag f, and the counters an update of those contexts writes."""
        rows3 = torch.stack([self.r0, self.r1 + (c1 << 8), self.r1 + (c2 << 8)])
        i3 = rows3[:, None, :] + ctx  # [3, T, k]: C0, C1 of c1, C1 of c2
        v = self._gather(i3)
        p = (v * self.mix).sum(0) >> 4
        sse = self.r2 + (ctx * 2 + f) * 17 + (p >> 12)
        knots = sse + self.knots  # [2, T, k]
        x = self._gather(knots)
        ssep = x[0] + (((x[1] - x[0]) * (p & 4095)) >> 12)
        return ssep * 3 + p, (i3, v, knots, x)

    def _gather(self, idx):
        return self.t.index_select(0, idx.reshape(-1)).view(idx.shape)

    def update(self, state, bits) -> None:
        """Counter updates toward the coded bits ([T, k] bool)."""
        i3, v, knots, x = state
        old = torch.cat([v[:2], x])  # C0, C1 of c1, both knots
        r = self.rates
        new = torch.where(bits, old + ((old ^ 65535) >> r), old - (old >> r))
        self.t.index_copy_(0, torch.cat([i3[:2], knots]).view(-1), new.view(-1))


def _byte_path(c):
    """The contexts a byte c [k] visits, most significant bit first, and
    its bits: ([8, k], [8, k] bool)."""
    shifts = torch.arange(8, 0, -1, device=c.device)[:, None]
    return (c + 256) >> shifts, ((c >> (shifts - 1)) & 1) == 1


def _running(ends: list[int], start: int) -> int:
    """Rows (a prefix, longest first) a window from ``start`` codes: those
    not yet done, and in the first window every row."""
    return len(ends) if start == 0 else sum(e > start for e in ends)


class _EncodeState:
    """Encoder of K rows between windows: model tables, the registers
    [low, high, optr, c1, c2, run] as one [6, K] tensor, the output so
    far (each row W + 1 wide; column W is the sink for dropped writes)
    and the lengths of the rows already flushed."""

    def __init__(self, lengths: torch.Tensor, n: int, w: int, device):
        k_dim = lengths.shape[0]
        lens = lengths.long().clamp(0, n)
        self.order = torch.argsort(lens, descending=True, stable=True)
        self.ends = lens[self.order].tolist()  # row j (coding order) ends after ends[j] bytes
        self.w = w
        self.model = _Model(k_dim, device)
        self.out = torch.zeros(k_dim * (w + 1), dtype=torch.uint8, device=device)
        self.orow = torch.arange(k_dim, dtype=torch.int64, device=device) * (w + 1)
        self.regs = torch.zeros((6, k_dim), dtype=torch.int64, device=device)
        self.regs[1] = M32
        self.out_lens = torch.zeros(k_dim, dtype=torch.int64, device=device)

    def result(self):
        k_dim, w = len(self.ends), self.w
        res = torch.empty((k_dim, w), dtype=torch.uint8, device=self.out.device)
        res[self.order] = self.out.view(k_dim, w + 1)[:, :w]
        res_lens = torch.empty(k_dim, dtype=torch.int32, device=self.out.device)
        res_lens[self.order] = self.out_lens.int()
        return res, res_lens


def _encode_window(st: _EncodeState, data: torch.Tensor, start: int, stop: int) -> None:
    """Encode steps [start, stop) of every row still running; flush the
    rows that end by ``stop``."""
    ends, w, model, out = st.ends, st.w, st.model, st.out
    k = _running(ends, start)
    if k == 0:
        return
    low, high, optr, c1, c2, run = st.regs[:, :k].unbind(0)
    orow = st.orow[:k]
    model.keep(k)
    x = data.index_select(0, st.order[:k])[:, start:stop].long()
    j = torch.arange(4, device=x.device)[:, None, None]

    def emit(lows, counts, orow, optr):
        """Bits t of one byte shifted counts[t] bytes out of lows[t]
        ([T, k]); writes past w go to the sink column."""
        pos = optr + counts.cumsum(0) - counts + j  # [4, T, k]
        ok = (j < counts) & (pos < w)
        out[orow + torch.where(ok, pos, w)] = ((lows >> (24 - 8 * j)) & 0xFF).to(torch.uint8)
        return optr + counts.sum(0)

    def flush(lo: int, hi: int):  # src/libbz3.c:426-433
        lw = low[None, lo:hi]
        st.out_lens[lo:hi] = emit(lw, torch.full_like(lw, 4), orow[lo:hi], optr[lo:hi])

    for i in range(start, min(stop, ends[0])):
        if ends[k - 1] <= i:  # rows that are done leave the batch
            k_new = next(j for j in range(k) if ends[j] <= i)
            flush(k_new, k)
            k = k_new
            low, high, optr, c1, c2, run = (a[:k] for a in (low, high, optr, c1, c2, run))
            orow = orow[:k]
            model.keep(k)
        c = x[:k, i - start]
        run = torch.where(c1 == c2, run + 1, 0)
        ctx, bits = _byte_path(c)
        scale, state = model.predict(c1, c2, (run > 2).long(), ctx)
        lows, counts = [], []
        for t in range(8):
            bit = bits[t]
            mid = low + (((high - low) * scale[t]) >> 18)
            high = torch.where(bit, mid, high)
            low = torch.where(bit, low, mid + 1)
            n_out = renorm_count(low, high)
            lows.append(low)
            counts.append(n_out)
            low, high = _renorm(low, high, n_out)
        optr = emit(torch.stack(lows), torch.stack(counts), orow, optr)
        model.update(state, bits)
        c2 = c1
        c1 = c
    live = sum(e > stop for e in ends[:k])
    flush(live, k)
    st.regs[:, :live] = torch.stack([low, high, optr, c1, c2, run])[:, :live]


def shift_in(code, k, w, ip, inl):
    """code shifted left by k bytes with code bytes ip..ip+k-1 shifted
    in; w is the big-endian word of bytes ip..ip+3, 0 past the row's
    input ``inl``.  A byte past the input adds -1 instead
    (src/libbz3.c:346,437-440): for the last m of the k bytes that takes
    0x01..01 (m bytes of 1) off what the zero bytes give."""
    sh = k << 3
    m = (ip + k - inl).clamp(min=0).minimum(k)
    ones = torch.full_like(m, 0x01010101) >> (32 - 8 * m)
    return ((code << sh) + (w >> (32 - sh)) - ones) & M32


class _DecodeState:
    """Decoder of K rows between windows: model tables, the registers
    [low, high, code, ip, c1, c2, run] as one [7, K] tensor and the
    payload rows (longest output first, each with a zero byte after it).
    The first four code bytes are read here, once."""

    def __init__(self, data, in_lens, out_lens, out_width: int):
        k_dim, m = data.shape
        dev = data.device
        outl = out_lens.long().clamp(0, out_width)
        self.order = torch.argsort(outl, descending=True, stable=True)
        self.ends = outl[self.order].tolist()
        self.m = m
        self.inl = in_lens.long().clamp(0, m).index_select(0, self.order)
        self.flat = torch.cat(
            [data.index_select(0, self.order), torch.zeros((k_dim, 1), dtype=torch.uint8, device=dev)],
            dim=1,
        ).view(-1)
        self.irow = torch.arange(k_dim, dtype=torch.int64, device=dev) * (m + 1)
        self.model = _Model(k_dim, dev)
        self.regs = torch.zeros((7, k_dim), dtype=torch.int64, device=dev)
        self.regs[1] = M32
        code, ip = self.regs[2], self.regs[3]  # 0, 0
        four = torch.full_like(ip, 4)
        w = self.words(ip, self.irow, self.inl)[:, 0]
        self.regs[2] = shift_in(code, four, w, ip, self.inl)  # the first four code bytes
        self.regs[3] = four

    def words(self, ip, irow, inl):
        """[k, 29]: the big-endian 4-byte words at code bytes ip + o of
        each row, o < 29, with bytes past the row's input 0.  A byte's 8
        bits shift in at most 32 bytes, so o stays under 29."""
        idx = ip[:, None] + torch.arange(32, device=ip.device)
        b = self.flat[irow[:, None] + idx.clamp(max=self.m)].long()
        b = torch.where(idx < inl[:, None], b, 0)
        return (b[:, :29] << 24) | (b[:, 1:30] << 16) | (b[:, 2:31] << 8) | b[:, 3:32]

    def unsort(self, out: torch.Tensor) -> torch.Tensor:
        res = torch.empty_like(out)
        res[self.order] = out
        return res


def _decode_window(st: _DecodeState, start: int, stop: int, out: torch.Tensor, base: int) -> None:
    """Decode steps [start, stop) of every row still running into
    out[row, i - base] (rows in the state's order)."""
    ends, model = st.ends, st.model
    k = _running(ends, start)
    if k == 0:
        return
    dev = out.device
    low, high, code, ip, c1, c2, run = st.regs[:, :k].unbind(0)
    irow, inl = st.irow[:k], st.inl[:k]
    model.keep(k)
    for i in range(start, min(stop, ends[0])):
        if ends[k - 1] <= i:  # rows that are done leave the batch
            k = next(j for j in range(k) if ends[j] <= i)
            low, high, code, ip, c1, c2, run = (a[:k] for a in (low, high, code, ip, c1, c2, run))
            irow, inl = irow[:k], inl[:k]
            model.keep(k)
        run = torch.where(c1 == c2, run + 1, 0)
        f = (run > 2).long()
        scale, _ = model.predict(c1, c2, f, model.nodes)  # [256, k]
        ctx = torch.ones((1, k), dtype=torch.int64, device=dev)
        words, ip0 = st.words(ip, irow, inl), ip
        for _t in range(8):
            mid = low + (((high - low) * scale.gather(0, ctx)[0]) >> 18)
            bit = code <= mid
            high = torch.where(bit, mid, high)
            low = torch.where(bit, low, mid + 1)
            n_in = renorm_count(low, high)
            w = words.gather(1, (ip - ip0)[:, None])[:, 0]
            code = shift_in(code, n_in, w, ip, inl)
            ip = ip + n_in
            low, high = _renorm(low, high, n_in)
            ctx = ctx * 2 + bit
        c = ctx[0] & 255
        path, bits = _byte_path(c)
        model.update(model.predict(c1, c2, f, path)[1], bits)
        c2 = c1
        c1 = c
        out[:k, i - base] = c.to(torch.uint8)
    live = sum(e > stop for e in ends[:k])
    st.regs[:, :live] = torch.stack([low, high, code, ip, c1, c2, run])[:, :live]


def cm_encode_resumable(
    data: torch.Tensor,
    lengths: torch.Tensor,
    out_width: int | None = None,
    chunk_steps: int | None = None,
):
    """Encode each row data[k, :lengths[k]] with a fresh model, in
    windows of ``chunk_steps`` bytes (default ``default_chunk_steps()``).

    data: [K, N] uint8; lengths: [K] int32.  Returns (out [K, W] uint8,
    out_lens [K] int32), W = ``out_width`` or N + N//8 + 64.  A row whose
    payload exceeds W keeps counting: its length is the true one and
    its writes past W are dropped.  Bytes past a row's length are 0.
    """
    n = data.shape[1]
    w = out_width if out_width is not None else n + n // 8 + 64
    st = _EncodeState(lengths, n, w, data.device)
    for s, e in windows(n, chunk_steps or default_chunk_steps()):
        _encode_window(st, data, s, e)
    return st.result()


def cm_encode_batch(data: torch.Tensor, lengths: torch.Tensor, out_width: int | None = None):
    """``cm_encode_resumable`` in one window over all N steps."""
    return cm_encode_resumable(data, lengths, out_width, max(1, data.shape[1]))


def cm_decode_stream(
    data: torch.Tensor,
    in_lens: torch.Tensor,
    out_lens: torch.Tensor,
    out_width: int,
    chunk_steps: int | None = None,
):
    """Decode out_lens[k] bytes from each row of data [K, M] uint8 in
    windows of ``chunk_steps``, yielding (start, [K, stop - start] uint8)
    for each window in order (zero past each row's length).

    Input past in_lens[k] (clamped to M) reads as -1: an exhausted
    stream shifts in ``(code << 8) - 1`` (src/libbz3.c:346,437-440).
    """
    st = _DecodeState(data, in_lens, out_lens, out_width)
    for s, e in windows(out_width, chunk_steps or default_chunk_steps()):
        piece = torch.zeros((data.shape[0], e - s), dtype=torch.uint8, device=data.device)
        _decode_window(st, s, e, piece, s)
        yield s, st.unsort(piece)


def cm_decode_resumable(
    data: torch.Tensor,
    in_lens: torch.Tensor,
    out_lens: torch.Tensor,
    out_width: int,
    chunk_steps: int | None = None,
) -> torch.Tensor:
    """``cm_decode_stream`` into one [K, out_width] uint8 tensor."""
    st = _DecodeState(data, in_lens, out_lens, out_width)
    out = torch.zeros((data.shape[0], out_width), dtype=torch.uint8, device=data.device)
    for s, e in windows(out_width, chunk_steps or default_chunk_steps()):
        _decode_window(st, s, e, out, 0)
    return st.unsort(out)


def cm_decode_batch(
    data: torch.Tensor, in_lens: torch.Tensor, out_lens: torch.Tensor, out_width: int
) -> torch.Tensor:
    """``cm_decode_resumable`` in one window over all out_width steps:
    [K, out_width] uint8, zero past each row's length."""
    return cm_decode_resumable(data, in_lens, out_lens, out_width, max(1, out_width))
