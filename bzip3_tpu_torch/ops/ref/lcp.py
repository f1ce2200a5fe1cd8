"""PLCP / LCP array construction (oracle).

The reference's libsais amalgam ships Φ-based PLCP and LCP builders
that bzip3 itself never calls (include/libsais.h:5268-5426).  Provided
here for library parity: Φ-based PLCP (Kärkkäinen/Manzini/Puglisi) and the permuted →
suffix-order LCP.

plcp[i]  = lcp between suffix i and its lexicographic predecessor
lcp[r]   = lcp between SA[r] and SA[r-1]  (lcp[0] = 0)
"""

import numpy as np


def plcp_array(data: bytes, sa: np.ndarray) -> np.ndarray:
    """Φ-based PLCP in O(n) (sequential h-extension, oracle)."""
    n = len(data)
    T = np.frombuffer(data, dtype=np.uint8)
    phi = np.empty(n, dtype=np.int64)
    phi[sa[0]] = -1
    phi[sa[1:]] = sa[:-1]
    plcp = np.zeros(n, dtype=np.int64)
    h = 0
    for i in range(n):
        j = phi[i]
        if j < 0:
            h = 0
            continue
        while i + h < n and j + h < n and T[i + h] == T[j + h]:
            h += 1
        plcp[i] = h
        if h > 0:
            h -= 1
    return plcp


def lcp_array(data: bytes, sa: np.ndarray) -> np.ndarray:
    """Suffix-order LCP from PLCP: lcp[r] = plcp[SA[r]]."""
    plcp = plcp_array(data, np.asarray(sa, dtype=np.int64))
    lcp = plcp[np.asarray(sa, dtype=np.int64)]
    lcp[0] = 0
    return lcp
