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
Gathers use int64 indices.  A corrupted (length, index) pair gives
garbage bytes, never an out-of-bounds access; the block CRC rejects it.
"""

from __future__ import annotations

import torch

_SEED_SYMBOLS = 4  # leading symbols of the first sort's key, 9 bits each
_WALK_SEG = 256  # chain positions per inverse walker (a power of two)


def _group_ranks(key: torch.Tensor, n: int):
    """Dense group ids of the flattened ``key`` [K, N], in position order.

    Returns (rank [K, N] int64, local offset [K, 1], unresolved): equal
    keys share an id, ids are order-preserving, row r's ids minus its
    offset lie in [0, N), and ``unresolved`` says whether any group has
    more than one member."""
    k_dim = key.shape[0]
    sk, order = torch.sort(key.reshape(-1), stable=True)
    start = torch.ones_like(sk, dtype=torch.bool)
    start[1:] = sk[1:] != sk[:-1]
    gid = torch.cumsum(start, 0) - 1
    rank = torch.empty_like(gid)
    rank[order] = gid
    base = gid.view(k_dim, n)[:, :1]  # id of each row's smallest key
    single = start.clone()
    single[:-1] &= start[1:]
    return rank.view(k_dim, n), base, not bool(single.all())


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
    lens = lengths.long().clamp(0, n)[:, None]
    pos = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    real = pos < lens
    x = data.long()

    # Seed key: the first symbols of each suffix, byte+1 with 0 past the
    # row's end; pads get their position (distinct, below every real key).
    seed = torch.zeros_like(x)
    for off in range(_SEED_SYMBOLS):
        sym = torch.zeros_like(x)
        sym[:, : n - off] = x[:, off:] + 1
        seed = (seed << 9) | torch.where(pos + off < lens, sym, 0)
    span = n + (1 << (9 * _SEED_SYMBOLS))
    rows = torch.arange(k_dim, dtype=torch.int64, device=dev)[:, None]
    key = torch.where(real, seed + n, pos) + rows * span
    rank, base, unresolved = _group_ranks(key, n)

    h = _SEED_SYMBOLS
    while unresolved and h < n:
        nxt = torch.zeros_like(rank)  # local rank + 1 of suffix i+h; 0 past the row
        nxt[:, : n - h] = rank[:, h:] - base + 1
        rank, base, unresolved = _group_ranks(rank * (n + 1) + nxt, n)
        h *= 2

    # All ranks distinct: the pads hold the first n - len local ranks.
    q = rank - base - (n - lens)  # rank among the row's real suffixes
    p = q[:, :1]  # rank of suffix 0
    slot = q + (q < p).long()
    pred = torch.cat([x[:, :1], x[:, :-1]], dim=1)  # T[i-1]
    valid = real & (q != p)
    u = torch.zeros((k_dim, n + 1), dtype=torch.uint8, device=dev)  # column n: sink
    u.scatter_(1, torch.where(valid, slot, n), pred.to(torch.uint8))
    u = u[:, :n]
    u[:, 0] = data.gather(1, (lens - 1).clamp(min=0))[:, 0]
    u = torch.where(real, u, 0).to(torch.uint8)

    idx = p[:, 0] + 1
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
    lens = lengths.long().clamp(0, n)[:, None]
    idxs = indices.long()[:, None]
    jj = torch.arange(m, dtype=torch.int64, device=dev)[None, :]

    # Sentinel-augmented string: codes+1, 0 at `index`, 0x1FF past the row.
    zero = torch.zeros((k_dim, 1), dtype=torch.int64, device=dev)
    before = torch.cat([u.long(), zero], dim=1)
    after = torch.cat([zero, u.long()], dim=1)
    b = torch.where(jj < idxs, before + 1, torch.where(jj == idxs, 0, after + 1))
    b = torch.where(jj <= lens, b, 0x1FF)

    # LF by one stable sort of (row, symbol): lf[order[r]] = r, global.
    rows = torch.arange(k_dim, dtype=torch.int64, device=dev)[:, None]
    _, order = torch.sort((b + rows * 512).view(-1), stable=True)
    lf = torch.empty_like(order)
    lf[order] = torch.arange(k_dim * m, dtype=torch.int64, device=dev)
    b = b.view(-1).to(torch.int16)

    seg = _WALK_SEG
    n_segs = -(-m // seg)
    jump = lf
    for _ in range(seg.bit_length() - 1):
        jump = jump[jump]  # LF^seg

    # Entry points LF^(s*seg)(0) by doubling: given the first `have`,
    # jump (= LF^(seg*have)) yields the next `have`.
    entries = torch.empty((k_dim, n_segs), dtype=torch.int64, device=dev)
    entries[:, 0] = rows[:, 0] * m
    have = 1
    while have < n_segs:
        take = min(have, n_segs - have)
        entries[:, have : have + take] = jump[entries[:, :take]]
        have += take
        if have < n_segs:
            jump = jump[jump]
    del jump

    # Walk: chain position c = s*seg + t holds b[LF^c(0)].
    chain = torch.empty((k_dim, n_segs, seg), dtype=torch.int16, device=dev)
    cur = entries
    for t in range(seg):
        chain[:, :, t] = b[cur]
        cur = lf[cur]
    chain = chain.view(k_dim, n_segs * seg)

    # The walk emits right to left: out[j] = chain[len - 1 - j] - 1.
    src = (lens - 1 - jj[:, :n]).clamp(0, n_segs * seg - 1)
    out = (chain.gather(1, src).long() - 1) & 0xFF
    inside = jj[:, :n] < lens
    out = torch.where(inside, out, 0).to(torch.uint8)
    return torch.where((lens <= 1) & inside, u, out)
