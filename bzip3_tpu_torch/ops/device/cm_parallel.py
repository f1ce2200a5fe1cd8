"""Parallel CM encoder, tensor code over K rows (counterpart of the JAX
package's ``ops/device/cm_parallel.py``), and the plain versions of its
two CUDA kernels P1 and P2 (``cm_parallel_cuda.py``).

On the encode side every table slot that a bit reads or updates, and
the direction of every update, follows from the data (the bits are the
plaintext; ``docs/parallel_cm.md``).  So the coder splits into:

  A. per-slot counter chains of C0 (rate 2) and C1 (rate 4): the rows'
     bit events sorted by (slot, time), each slot's events a chain
     ``s -> s +- (...) >> rate`` that resets at the slot's first event;
  B. p, j and the two SSE slots of each bit from A's values, then the C2
     chain (rate 6) over those slots the same way;
  C. the range coder over the precomputed split factors, serial in the
     row's bits but free of tables.

A chain over a sorted stream of E events is cut into S = ceil(E / seg)
windows of ``seg`` events, evaluated in lockstep, and made exact by the
JAX package's four moves (``_chain_values_sorted``): a bracket from the
full domain [0, 65535], relax rounds that feed window w-1's exit bracket
into window w (on the host, one synchronise a round, until every row of
the batch certifies or 8 rounds), certification ``b - a < 2**rate``, the
sampled map of every window over its ``2**rate`` entries, a log-depth
scan that composes the maps, and one emitting pass from the exact
entries.  ``speculative=False`` is the same evaluation with one window a
row.  The window scans are P1 (``chain_windows``), the range coder P2
(``range_pass``); the sorts are ``torch.sort`` on one int64 key
``slot << 32 | time``.

Each event is one int32 word: its init value (bits 0-15), its bit (16),
its advance flag (17) and its start flag (18).  Windows lie scan-major,
[K, seg, S], so that the S windows of a row read event i of each as one
contiguous run.  The split factors go to P2 as one int32 word a bit:
``ssep * 3 + p`` (below 2**18) with the bit in bit 31.

``cm_encode_parallel_batch`` runs P1 and P2 through their wrappers: the
kernels on the card, these plain versions on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

from .cm import M32, _renorm, renorm_count
from .launch import check, route

SENT = 1 << 20  # slot key of an inactive event: they sort after every slot
INIT_MASK = 0xFFFF
BIT = 1 << 16
ADV = 1 << 17
START = 1 << 18
MODES = ("pair", "map", "emit")
RELAX_ROUNDS = 8


def chain_windows_plain(ev: torch.Tensor, rate: int, mode: str, in0: torch.Tensor,
                        in1: torch.Tensor | None = None):
    """P1's plain version: every window of ``ev`` [K, seg, S] (packed
    events, scan-major) scanned over its seg events at once.

    - ``pair``: from entries in0, in1 [K, S], the exits (x0, x1) [K, S];
    - ``map``: from the entries min(in0 + s, 65535), s < 2**rate, the
      exits [K, S, 2**rate];
    - ``emit``: from entries in0 [K, S], each event's value before it,
      [K, seg, S].
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    k, seg, s = ev.shape
    # per event: its init value, whether it starts a group, and the step
    # c + ((c ^ mask) >> rate) * coef: mask 65535 toward a 1 (c ^ 65535 is
    # 65535 - c) and 0 toward a 0, coef 1 or -1 when it advances, else 0
    init = (ev & INIT_MASK)[..., None]
    start = ((ev & START) != 0)[..., None]
    one = (ev & BIT) != 0
    mask = (one.int() * 65535)[..., None]
    coef = (((ev & ADV) != 0).int() * (one.int() * 2 - 1))[..., None]
    if mode == "pair":
        st = torch.stack([in0, in1], -1)
    elif mode == "map":
        st = (in0[..., None] + torch.arange(1 << rate, dtype=torch.int32, device=ev.device))
        st = st.clamp(max=65535)
    else:
        st = in0[..., None]
    vals = []
    for s0, i0, m0, k0 in zip(start.unbind(1), init.unbind(1), mask.unbind(1), coef.unbind(1)):
        c = torch.where(s0, i0, st)
        if mode == "emit":
            vals.append(c[..., 0])
        st = c + ((c ^ m0) >> rate) * k0
    if mode == "pair":
        return st[..., 0].contiguous(), st[..., 1].contiguous()
    return st.int() if mode == "map" else torch.stack(vals, 1)


def range_pass_plain(words: torch.Tensor, lengths: torch.Tensor, out_width: int):
    """P2's plain version: the range coder of each row over its first
    8 * lengths[k] words of ``words`` [K, 8N] int32 (split factor in bits
    0-17, the bit in bit 31), one byte step (8 bits) at a time for all
    rows.  Returns (out [K, out_width] uint8, out_lens [K] int32): the
    payload and its 4 flush bytes, writes past out_width dropped and the
    true length reported, zero past it."""
    k, n8 = words.shape
    dev = words.device
    lens = lengths.long().clamp(0, n8 // 8)
    act = (torch.arange(n8, device=dev)[None, :] < 8 * lens[:, None]).T  # [8N, K]
    w = words.T.long()
    scale, ones, zeros = w & 0x3FFFF, act & (w < 0), act & (w >= 0)
    out = torch.zeros(k * (out_width + 1), dtype=torch.uint8, device=dev)
    orow = torch.arange(k, dtype=torch.int64, device=dev) * (out_width + 1)
    low = torch.zeros(k, dtype=torch.int64, device=dev)
    high = torch.full((k,), M32, dtype=torch.int64, device=dev)
    optr = torch.zeros(k, dtype=torch.int64, device=dev)
    j = torch.arange(4, device=dev)[:, None, None]

    def emit(lows, counts):
        pos = optr + counts.cumsum(0) - counts + j  # [4, T, K]
        ok = (j < counts) & (pos < out_width)
        out[orow + torch.where(ok, pos, out_width)] = ((lows >> (24 - 8 * j)) & 0xFF).to(torch.uint8)
        return optr + counts.sum(0)

    for i in range(0, 8 * int(lens.max()) if k else 0, 8):
        lows, counts = [], []
        for e in range(i, i + 8):
            mid = low + (((high - low) * scale[e]) >> 18)  # cm.py's int64 split
            high = torch.where(ones[e], mid, high)
            low = torch.where(zeros[e], mid + 1, low)
            # a row past its length keeps a renormalised range: count 0
            cnt = renorm_count(low, high)
            lows.append(low)
            counts.append(cnt)
            low, high = _renorm(low, high, cnt)
        optr = emit(torch.stack(lows), torch.stack(counts))
    optr = emit(low[None], torch.full_like(low, 4)[None])  # src/libbz3.c:426-433
    return out.view(k, out_width + 1)[:, :out_width], optr.int()


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Window w's entry from window w-1's exit; window 0's is 0 (its
    first event starts a group, so any value serves)."""
    return torch.nn.functional.pad(x[:, :-1], (1, 0))


def _compose_scan(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of the windows' sampled maps m [K, S, nsamp] (base
    a [K, S]) by composition, Hillis-Steele over the window axis: the
    composite of windows [0, w] for every w.  Composition keeps the left
    part's base and gathers the right part's map at clip(left exit -
    right base, 0, nsamp - 1), as the JAX package's ``compose``."""
    nsamp, s = m.shape[2], m.shape[1]
    pa, pm, d = a, m, 1
    while d < s:
        idx = (pm[:, :-d] - pa[:, d:, None]).clamp(0, nsamp - 1).long()
        pm = torch.cat([pm[:, :d], torch.gather(pm[:, d:], 2, idx)], 1)
        pa = torch.cat([pa[:, :d], pa[:, :-d]], 1)
        d *= 2
    return pm


def chain_values(ev: torch.Tensor, rate: int, seg: int, speculative: bool, windows, stage):
    """Pre-event values of the chains of a sorted, packed event stream
    ev [K, E] (start flags set): (vals [K, E] int32, ok [K] bool).
    ``windows`` is P1 (its wrapper); ``stage(name)`` a timer's stage."""
    k, e = ev.shape
    dev = ev.device
    if e == 0:
        return torch.zeros((k, 0), dtype=torch.int32, device=dev), torch.ones(k, dtype=torch.bool, device=dev)
    if not speculative:
        seg = e
    s = -(-e // seg)
    with stage("encode/cm/layout"):
        # padding events start a group (init 0) and never advance
        ev = torch.nn.functional.pad(ev, (0, s * seg - e), value=START)
        evw = ev.view(k, s, seg).transpose(1, 2).contiguous()  # [K, seg, S]
        del ev
    if speculative:
        nsamp = 1 << rate
        with stage("encode/cm/p1_bracket"):
            zero = torch.zeros((k, s), dtype=torch.int32, device=dev)
            x0, x1 = windows(evw, rate, "pair", zero, torch.full_like(zero, 65535))
        rounds = 0
        while True:
            a, b = _shift(x0), _shift(x1)
            if rounds >= RELAX_ROUNDS or bool(((b - a) < nsamp).all()):
                break
            with stage("encode/cm/p1_relax"):
                x0, x1 = windows(evw, rate, "pair", a, b)
            rounds += 1
        ok = ((b - a) < nsamp).all(1)
        with stage("encode/cm/p1_map"):
            m = windows(evw, rate, "map", a)
        with stage("encode/cm/compose"):
            pm = _compose_scan(a, m)
            entry = torch.cat([a[:, :1], pm[:, :-1, 0]], 1).contiguous()
        del m, pm
    else:
        ok = torch.ones(k, dtype=torch.bool, device=dev)
        entry = torch.zeros((k, 1), dtype=torch.int32, device=dev)
    with stage("encode/cm/p1_emit"):
        v = windows(evw, rate, "emit", entry)
    return v.transpose(1, 2).reshape(k, s * seg)[:, :e], ok


def _chain(keys, times, bits, advance, init_vals, rate: int, seg: int, speculative: bool,
           windows, stage):
    """Sort by (slot, time), evaluate, unsort: (vals in event order [K, E]
    int32, ok [K]).  Inputs [K, E]: times int64, keys and init_vals int32
    (init_vals may be one int for all), bits and advance 0/1."""
    with stage("encode/cm/sort"):
        key = (keys.long() << 32) | times
        sk, perm = torch.sort(key, dim=1, stable=True)
        del key
        slots = sk >> 32
        del sk
        packed = init_vals | (bits.int() << 16) | (advance.int() << 17)
        ev = torch.gather(packed, 1, perm)
        del packed
        prev = torch.nn.functional.pad(slots[:, :-1], (1, 0), value=-2)
        ev |= (((slots != prev) | (slots >= SENT)).int() << 18)
        del slots, prev
    vals, ok = chain_values(ev, rate, seg, speculative, windows, stage)
    del ev
    with stage("encode/cm/unsort"):
        out = torch.empty_like(vals)
        out.scatter_(1, perm, vals)
    return out, ok


def cm_encode_parallel_batch(data: torch.Tensor, lengths: torch.Tensor, seg: int = 2048,
                             out_width: int | None = None, speculative: bool = True,
                             kernels=None, timer=None):
    """Parallel CM encode of each row data[k, :lengths[k]] (data [K, N]
    uint8, lengths [K] int32): (out [K, W] uint8, out_lens [K] int32, ok
    [K] bool), W = ``out_width`` or N + N//8 + 64.

    ``ok[k]`` is False when a chain of row k failed certification or its
    payload is longer than W (its true length is reported, its bytes
    past W dropped): the caller must code such a row another way.
    Bytes past a row's length are unspecified.  ``kernels`` holds
    ``chain_windows`` and ``range_pass`` (default: the wrappers of
    ``cm_parallel_cuda``, the CUDA kernels on the card and the plain
    versions on the CPU); ``timer`` a ``StageTimer`` for the phases.
    """
    check(data, "data", torch.uint8, 2)
    check(lengths, "lengths", torch.int32, 1)
    if lengths.shape[0] != data.shape[0]:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, data {data.shape[0]}")
    if seg <= 0:
        raise ValueError(f"seg must be positive, got {seg}")
    route(data, lengths)
    if kernels is None:
        from . import cm_parallel_cuda as kernels
    stage = timer.stage if timer is not None else (lambda name: contextlib.nullcontext())
    windows = kernels.chain_windows
    k, n = data.shape
    dev = data.device
    w = out_width if out_width is not None else n + n // 8 + 64
    n8 = n * 8
    with stage("encode/cm/derive"):
        buf = data.int()
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        lens = lengths.long().clamp(0, n)
        act8 = (pos[None, :] < lens[:, None]).repeat_interleave(8, 1)  # [K, 8N]
        shifts = torch.arange(8, 0, -1, dtype=torch.int32, device=dev)
        ctx = ((buf[:, :, None] | 256) >> shifts).reshape(k, n8)  # (1 << t) | bits above t
        bits = ((buf[:, :, None] >> (shifts - 1)) & 1).reshape(k, n8)
        c1 = torch.nn.functional.pad(buf[:, :-1], (1, 0))
        c2 = torch.nn.functional.pad(buf[:, :-2], (2, 0))[:, :n]
        # run[i]: positions ending at i with c1 == c2; f = run > 2
        last_neq = torch.cummax(torch.where(c1 != c2, pos, -1), 1).values
        rep_f = ((pos - last_neq) > 2).int().repeat_interleave(8, 1)
        times = torch.arange(n8, dtype=torch.int64, device=dev).expand(k, n8)
        del buf, pos, last_neq

    # phase A: C0, then C1 (updates keyed by c1 at time 2t+1, reads by c2 at 2t)
    p0, ok0 = _chain(torch.where(act8, ctx, SENT), times, bits, act8, 1 << 15, 2, seg,
                     speculative, windows, stage)
    with stage("encode/cm/derive"):
        upd = torch.where(act8, (c1.repeat_interleave(8, 1) << 8) | ctx, SENT)
        read = torch.where(act8, (c2.repeat_interleave(8, 1) << 8) | ctx, SENT)
        del c1, c2
        keys1 = torch.cat([upd, read], 1)
        del upd, read
        times1 = torch.cat([times * 2 + 1, times * 2], 1)
        bits2 = torch.cat([bits, bits], 1)
    v1, ok1 = _chain(keys1, times1, bits2, torch.cat([act8, torch.zeros_like(act8)], 1), 1 << 15,
                     4, seg, speculative, windows, stage)
    del keys1, times1

    # phase B: p, j and the SSE slots, then C2 over slots sse and sse + 1
    with stage("encode/cm/derive"):
        p = ((p0 + v1[:, :n8]) * 7 + v1[:, n8:] * 2) >> 4
        del p0, v1
        sse = (2 * ctx + rep_f) * 17 + (p >> 12)
        del ctx, rep_f
        slots2 = torch.cat([sse, sse + 1], 1)
        del sse
        act16 = torch.cat([act8, act8], 1)
        keys2 = torch.where(act16, slots2, SENT)
        kmod = slots2 % 17
        del slots2
        init2 = (kmod << 12) - (kmod == 16).int()
        del kmod
    v2, ok2 = _chain(keys2, torch.cat([times, times], 1), bits2, act16, init2, 6, seg,
                     speculative, windows, stage)
    del keys2, init2, act16, bits2

    # phase C: the range coder over ssep * 3 + p, the bit in bit 31
    with stage("encode/cm/derive"):
        x1, x2 = v2[:, :n8], v2[:, n8:]
        ssep = x1 + (((x2 - x1) * (p & 4095)) >> 12)
        words = (ssep * 3 + p) | (bits << 31)
        del v2, x1, x2, ssep, p, bits
    with stage("encode/cm/p2"):
        out, out_lens = kernels.range_pass(words, lens.int(), w)
    ok = ok0 & ok1 & ok2 & (out_lens <= w)
    return out, out_lens, ok
