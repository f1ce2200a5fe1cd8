"""Burrows-Wheeler transform oracle (suffix-array based).

Output contract (matching libsais_bwt / libsais_unbwt,
include/libsais.h:4095,5260, as invoked from src/libbz3.c:623,758):

Let SA be the suffix array of T (n suffixes, no sentinel) and p the
position with SA[p] == 0.  Then

    U[0]            = T[n-1]
    U[1 .. p]       = T[SA[0..p-1] - 1]
    U[p+1 .. n-1]   = T[SA[p+1..n-1] - 1]
    index           = p + 1

Equivalently: U is the sentinel-BWT of T + '$' with the virtual
sentinel (which would land at position ``index``) removed.  That view
gives the inverse directly: re-insert a virtual smallest symbol at
position ``index``, invert the standard BWT by LF-walking from row 0,
and drop the sentinel.

For n <= 1 the transform is the identity with index = n.

The oracle suffix array uses prefix doubling over numpy lexsort
(O(n log^2 n), fully array-parallel): the skeleton of the port's tensor
BWT (``ops/device/bwt.py``), not the reference's SA-IS recursion.
"""

import numpy as np


def suffix_array(buf: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (Manber-Myers, vectorized)."""
    n = len(buf)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    rank = buf.astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        # Key: (rank[i], rank[i+k]) with out-of-range treated as -1.
        rank_k = np.full(n, -1, dtype=np.int64)
        rank_k[: n - k] = rank[k:]
        order = np.lexsort((rank_k, rank))
        # Re-rank: positions where either key component differs start a
        # new rank group.
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
            # All ranks distinct is guaranteed once k >= n.
            return np.argsort(rank, kind="stable")


def bwt_forward(data: bytes) -> tuple[bytes, int]:
    """Returns (U, index) per the contract above."""
    n = len(data)
    if n <= 1:
        return data, n
    T = np.frombuffer(data, dtype=np.uint8)
    sa = suffix_array(T)
    p = int(np.nonzero(sa == 0)[0][0])
    pred = T[sa - 1]  # wrong only at position p, which we drop
    U = np.concatenate(([T[n - 1]], pred[:p], pred[p + 1 :]))
    return U.tobytes(), p + 1


def bwt_inverse(U: bytes, index: int) -> bytes | None:
    """Inverse transform; None when ``index`` is out of range."""
    n = len(U)
    if n <= 1:
        return U if index == n else None
    if index <= 0 or index > n:
        return None
    u = np.frombuffer(U, dtype=np.uint8).astype(np.int64)
    # Rebuild the sentinel BWT: codes shifted +1, virtual 0 at `index`.
    b = np.empty(n + 1, dtype=np.int64)
    b[:index] = u[:index] + 1
    b[index] = 0
    b[index + 1 :] = u[index:] + 1
    # LF mapping: rank of (symbol, position) pairs under stable sort.
    order = np.argsort(b, kind="stable")
    lf = np.empty(n + 1, dtype=np.int64)
    lf[order] = np.arange(n + 1, dtype=np.int64)
    # Walk LF from row 0 (the rotation starting with the sentinel),
    # emitting right to left.  Plain lists for scalar-walk speed.
    b_l = b.tolist()
    lf_l = lf.tolist()
    out = bytearray(n)
    i = 0
    for k in range(n - 1, -1, -1):
        # On corrupted input the walk can revisit the sentinel early;
        # emit garbage bytes rather than fail — the block-level CRC
        # check is what rejects such data (src/libbz3.c:803).
        out[k] = (b_l[i] - 1) & 0xFF
        i = lf_l[i]
    return bytes(out)
