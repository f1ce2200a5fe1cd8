"""Batched BWT as PyTorch tensor code.

Output contract (as ``ops/ref/bwt.py`` of the JAX package defines it,
matching libsais_bwt as called from src/libbz3.c:623): for a row T of
length n > 1 with suffix array SA and p the rank of suffix 0,

    U[0] = T[n-1],  U[1..p] = T[SA[0..p-1] - 1],  U[p+1..] = T[SA[p+1..] - 1],
    index = p + 1;

rows of length <= 1 are the identity with index = n.

Forward: prefix doubling (Manber-Myers).  Every round is ONE stable
``torch.sort`` of a packed int64 key over the whole flattened [K, N]
batch: rows never mix because ranks are global (row r's ranks lie in
[r*N, (r+1)*N)), and the rank pair (rank[i], rank[i+k]) packs as
rank[i] * (N+1) + local(rank[i+k]) + 1.  Variable lengths use the
distinct-sentinel trick: positions past a row's length get distinct
keys, increasing with position, below every real key, so they sort to
a contiguous prefix of the row and every real suffix compares as the
non-wrapping suffix with end-of-string smallest.

Inverse: LF from one stable sort of the sentinel-augmented string,
LF^seg by repeated squaring, the row's S = ceil((N+1)/seg) entry points
LF^(s*seg)(0) by pointer doubling over LF^seg (log2 S squarings, no
per-segment loop), then S walkers per row step seg times in lockstep.
A corrupted (length, index) pair gives garbage bytes, never an
out-of-bounds access; the block CRC rejects it.

Working set.  Ranks, LF and its powers are int32 whenever the flattened
batch has fewer than 2^31 positions (the pipeline's groups always do;
int64 otherwise), the symbols int16, and every large temporary is
dropped before the next sort.  What is left at the peak is the sort
itself: ``torch.sort`` of N int64 keys holds the keys, the sorted keys,
an int64 iota and the int64 order, plus the radix sort's alternate
buffers, ~48 bytes a position; the inverse sorts int32 keys.
"""

from __future__ import annotations

import torch

_SEED_SYMBOLS = 4  # leading symbols of the first sort's key, 9 bits each
_WALK_SEG = 256  # chain positions per inverse walker (a power of two)


def _index_dtype(numel: int) -> torch.dtype:
    """int32 for positions of a flattened batch under 2^31, else int64."""
    return torch.int32 if numel < 1 << 31 else torch.int64


def _group_ranks(keys: list, k_dim: int, n: int, idt: torch.dtype):
    """Dense group ids of a flattened key [K, N], in position order.

    ``keys`` holds the key alone and is emptied, so that the key is
    freed as soon as it is sorted.  Returns (rank [K, N] of ``idt``,
    local offset [K, 1], unresolved): equal keys share an id, ids are
    order-preserving, row r's ids minus its offset lie in [0, N), and
    ``unresolved`` says whether any group has more than one member."""
    sk, order = torch.sort(keys.pop().view(-1), stable=True)
    start = torch.ones_like(sk, dtype=torch.bool)
    torch.ne(sk[1:], sk[:-1], out=start[1:])
    del sk
    gid = torch.cumsum(start, 0, dtype=idt)
    del start
    gid -= 1
    rank = torch.empty_like(gid)
    rank[order] = gid
    del order
    base = gid.view(k_dim, n)[:, :1].clone()  # id of each row's smallest key
    # as many groups as positions: every group is a singleton
    unresolved = int(gid[-1]) + 1 < gid.numel()
    return rank.view(k_dim, n), base, unresolved


def bwt_forward_batch(data: torch.Tensor, lengths: torch.Tensor):
    """BWT of each row.  data: [K, N] uint8 (zero-padded), lengths: [K] int32.

    Returns (U [K, N] uint8, index [K] int32).
    """
    k_dim, n = data.shape
    dev = data.device
    if k_dim == 0 or n == 0:
        return data.clone(), lengths.clamp(0, n).int()
    if k_dim * n * (n + 1) >= 1 << 62:
        raise ValueError(f"batch [{k_dim}, {n}] too large for packed int64 sort keys")
    idt = _index_dtype(k_dim * n)
    lens = lengths.long().clamp(0, n)[:, None]
    pos = torch.arange(n, dtype=idt, device=dev)[None, :]

    # Seed key: the first symbols of each suffix, byte+1 with 0 past the
    # row's end; pads get their position (distinct, below every real key).
    seed = torch.zeros((k_dim, n), dtype=torch.int64, device=dev)
    for off in range(_SEED_SYMBOLS):
        seed <<= 9
        if off >= n:
            continue
        sym = data[:, off:].long()
        sym += 1
        sym.masked_fill_(pos[:, : n - off] >= lens - off, 0)
        seed[:, : n - off] |= sym
        del sym
    span = n + (1 << (9 * _SEED_SYMBOLS))
    rows = torch.arange(k_dim, dtype=torch.int64, device=dev)[:, None]
    seed += n
    key = torch.where(pos < lens, seed, pos)
    del seed, pos  # made again after the sorts
    key += rows * span
    keys = [key]
    del key
    rank, base, unresolved = _group_ranks(keys, k_dim, n, idt)

    h = _SEED_SYMBOLS
    while unresolved and h < n:
        # rank[i] * (n + 1) + (local rank + 1 of suffix i+h; 0 past the row)
        key = rank.long()
        key *= n + 1
        nxt = rank[:, h:] - base
        del rank
        nxt += 1
        key[:, : n - h] += nxt
        del nxt
        keys = [key]
        del key
        rank, base, unresolved = _group_ranks(keys, k_dim, n, idt)
        h *= 2

    # All ranks distinct: the pads hold the first n - len local ranks.
    q = rank - base
    del rank
    q -= (n - lens).to(idt)  # rank among the row's real suffixes
    p = q[:, :1].clone()  # rank of suffix 0
    real = torch.arange(n, dtype=idt, device=dev)[None, :] < lens
    valid = real & (q != p)
    q += (q < p).to(idt)  # the slot of each suffix's predecessor in U
    slot = torch.where(valid, q, n).long()
    del q, valid
    pred = torch.cat([data[:, :1], data[:, :-1]], dim=1)  # T[i-1]
    u = torch.zeros((k_dim, n + 1), dtype=torch.uint8, device=dev)  # column n: sink
    u.scatter_(1, slot, pred)
    del slot, pred
    u = u[:, :n]
    u[:, 0] = data.gather(1, (lens - 1).clamp(min=0))[:, 0]
    u = torch.where(real, u, 0).to(torch.uint8)

    idx = p[:, 0].long() + 1
    tiny = lens[:, 0] <= 1
    u = torch.where(tiny[:, None], data, u)
    idx = torch.where(tiny, lens[:, 0], idx)
    return u, idx.int()


def bwt_inverse_batch(u: torch.Tensor, lengths: torch.Tensor, indices: torch.Tensor):
    """Invert the BWT of each row.  u: [K, N] uint8; returns [K, N] uint8
    (zero past each row's length)."""
    k_dim, n = u.shape
    dev = u.device
    if k_dim == 0 or n == 0:
        return u.clone()
    m = n + 1  # one sentinel slot per row
    seg = _WALK_SEG
    n_segs = -(-m // seg)
    idt = _index_dtype(k_dim * n_segs * seg)
    lens = lengths.long().clamp(0, n)[:, None]
    idxs = indices.long()[:, None]
    jj = torch.arange(m, dtype=idt, device=dev)[None, :]

    # Sentinel-augmented string: codes+1, 0 at `index`, 0x1FF past the row.
    b = torch.zeros((k_dim, m), dtype=torch.int16, device=dev)
    b[:, 1:] = u
    b += 1  # column j > index: U[j-1] + 1
    before = torch.zeros((k_dim, m), dtype=torch.int16, device=dev)
    before[:, :n] = u
    before += 1  # column j < index: U[j] + 1
    b = torch.where(jj < idxs, before, b)
    del before
    b.masked_fill_(jj == idxs, 0)
    b.masked_fill_(jj > lens, 0x1FF)
    del jj  # made again for the walk's output

    # LF by one stable sort of (row, symbol): lf[order[r]] = r, global.
    key = b.to(torch.int32)
    key += torch.arange(k_dim, dtype=torch.int32, device=dev)[:, None] * 512
    _, order = torch.sort(key.view(-1), stable=True)
    del key
    lf = torch.empty(k_dim * m, dtype=idt, device=dev)
    lf[order] = torch.arange(k_dim * m, dtype=idt, device=dev)
    del order
    b = b.view(-1)

    jump = lf
    for _ in range(seg.bit_length() - 1):
        jump = jump.index_select(0, jump)  # LF^seg

    # Entry points LF^(s*seg)(0) by doubling: given the first `have`,
    # jump (= LF^(seg*have)) yields the next `have`.
    entries = torch.empty((k_dim, n_segs), dtype=idt, device=dev)
    entries[:, 0] = torch.arange(k_dim, dtype=idt, device=dev) * m
    have = 1
    while have < n_segs:
        take = min(have, n_segs - have)
        entries[:, have : have + take] = jump.index_select(
            0, entries[:, :take].reshape(-1)).view(k_dim, take)
        have += take
        if have < n_segs:
            jump = jump.index_select(0, jump)
    del jump

    # Walk: chain position c = s*seg + t holds b[LF^c(0)].
    chain = torch.empty((k_dim, n_segs, seg), dtype=torch.int16, device=dev)
    cur = entries.view(-1)
    for t in range(seg):
        chain[:, :, t] = b.index_select(0, cur).view(k_dim, n_segs)
        cur = lf.index_select(0, cur)
    del lf, b, cur
    chain = chain.view(k_dim, n_segs * seg)

    # The walk emits right to left: out[j] = chain[len - 1 - j] - 1.
    jj = torch.arange(n, dtype=idt, device=dev)[None, :]
    src = (lens - 1 - jj).clamp(0, n_segs * seg - 1)
    out = chain.gather(1, src)
    del src, chain
    out -= 1
    out &= 0xFF
    inside = jj < lens
    out = torch.where(inside, out, 0).to(torch.uint8)
    return torch.where((lens <= 1) & inside, u, out)
