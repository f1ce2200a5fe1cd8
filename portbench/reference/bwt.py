"""Burrows-Wheeler transform, as libsais_bwt gives it to bzip3
(include/libsais.h, called at src/libbz3.c:623): a frozen copy of the
port's ``ops/ref/bwt.py`` contract.

Let SA be the suffix array of T (n suffixes, no sentinel; a suffix that
is a prefix of another sorts first) and p the position with SA[p] == 0.
Then

    U[0]            = T[n-1]
    U[1 .. p]       = T[SA[0..p-1] - 1]
    U[p+1 .. n-1]   = T[SA[p+1..n-1] - 1]
    index           = p + 1

For n <= 1 the transform is the identity with index = n.

``suffix_array_plain`` is the port's prefix doubling over ``np.lexsort``
(every suffix sorted every round); ``suffix_array`` starts from 7-byte
keys and sorts again only the suffixes whose group is not yet resolved
(Larsson and Sadakane's refinement), one int64 key a round.
"""

import numpy as np


def suffix_array_plain(buf: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (Manber-Myers, vectorized)."""
    n = len(buf)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    rank = buf.astype(np.int64)
    k = 1
    while True:
        rank_k = np.full(n, -1, dtype=np.int64)
        rank_k[: n - k] = rank[k:]
        order = np.lexsort((rank_k, rank))
        r_ord = rank[order]
        rk_ord = rank_k[order]
        new_group = np.empty(n, dtype=np.int64)
        new_group[0] = 0
        new_group[1:] = (r_ord[1:] != r_ord[:-1]) | (rk_ord[1:] != rk_ord[:-1])
        ranks_sorted = np.cumsum(new_group)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = ranks_sorted
        if ranks_sorted[-1] == n - 1:
            return order
        k <<= 1
        if k >= n:
            return np.argsort(rank, kind="stable")


def suffix_array(buf: np.ndarray) -> np.ndarray:
    """The same suffix array.  A suffix's rank is the sorted position of
    the first member of its group; each round sorts the members of groups
    of two or more by (rank, rank of the suffix k further on, -1 past the
    end) and doubles k."""
    n = len(buf)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    t = buf.astype(np.int64) + 1  # 0 stands for "past the end"
    key = np.zeros(n, np.int64)
    for j in range(7):  # 257**7 < 2**63
        key *= 257
        if j < n:
            key[: n - j] += t[j:]
    del t
    sa = np.argsort(key)
    ks = key[sa]
    del key
    head = np.empty(n, bool)
    head[0] = True
    np.not_equal(ks[1:], ks[:-1], out=head[1:])
    del ks
    pos = np.arange(n, dtype=np.int64)
    rank = np.empty(n, np.int64)
    rank[sa] = np.maximum.accumulate(np.where(head, pos, 0))
    k = 7
    while True:
        gid = np.cumsum(head) - 1
        multi = np.bincount(gid)[gid] > 1
        idx = np.flatnonzero(multi)
        if idx.size == 0:
            return sa
        s = sa[idx]
        nxt = s + k
        r2 = np.where(nxt < n, rank[np.minimum(nxt, n - 1)], -1)
        key = rank[s] * (n + 1) + (r2 + 1)
        order = np.argsort(key)  # ties stay in one group: their order is free
        s, key = s[order], key[order]
        sa[idx] = s
        newh = np.empty(idx.size, bool)
        newh[0] = True
        np.not_equal(key[1:], key[:-1], out=newh[1:])
        head[idx] = newh
        rank[s] = np.maximum.accumulate(np.where(newh, idx, 0))
        k <<= 1


def bwt_forward(data: bytes, sa_fn=suffix_array) -> tuple[bytes, int]:
    """(U, index) per the contract above."""
    n = len(data)
    if n <= 1:
        return data, n
    T = np.frombuffer(data, dtype=np.uint8)
    sa = sa_fn(T)
    p = int(np.flatnonzero(sa == 0)[0])
    pred = T[sa - 1]  # wrong only at position p, which is dropped
    U = np.concatenate(([T[n - 1]], pred[:p], pred[p + 1 :]))
    return U.tobytes(), p + 1
