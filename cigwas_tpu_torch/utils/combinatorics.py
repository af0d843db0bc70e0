"""Host-side combination enumeration for the level-wise skeleton search.

The reference enumerates l-subsets of each node's neighbour list on the GPU
with per-thread combinatorial unranking (`cuPC-S.cu:6453-6506`, `IthCombination`
/ `BINOM`, int32 arithmetic). This engine instead enumerates combinations
on the host in **colexicographic order** and ships fixed-size chunks of
position tuples to the device:

* the r-th colex combination of ``{0..N-1} choose l`` does not depend on N —
  one chunk is valid for every node simultaneously; a node with degree d simply
  masks chunk rows with rank >= C(d, l),
* ranks are Python bignums, so there is no int32 overflow (the reference's
  BINOM silently overflows for large degrees),
* the device kernel stays free of data-dependent control flow.
"""

from __future__ import annotations

from math import comb

import numpy as np


def binom(n: int, k: int) -> int:
    """Exact binomial coefficient (0 for invalid inputs)."""
    if k < 0 or n < 0 or k > n:
        return 0
    return comb(n, k)


def colex_unrank(r: int, l: int) -> list[int]:
    """Positions of the r-th (0-based) l-combination in colex order.

    Colex order sorts combinations by their largest element, then the next
    largest, etc. The result is increasing: out[0] < out[1] < ... < out[l-1].
    Independent of the size of the ground set.
    """
    out = [0] * l
    for i in range(l, 0, -1):
        # largest c with C(c, i) <= r
        c = i - 1
        while comb(c + 1, i) <= r:
            c += 1
        out[i - 1] = c
        r -= comb(c, i)
    return out


def _colex_next(c: list[int]) -> None:
    """In-place colex successor of an increasing combination."""
    l = len(c)
    for i in range(l):
        nxt = c[i + 1] if i + 1 < l else None
        if nxt is None or c[i] + 1 < nxt:
            c[i] += 1
            for j in range(i):
                c[j] = j
            return


_CHUNK_CACHE: dict = {}
_CHUNK_CACHE_MAX = 64


def colex_combinations_chunk(offset: int, count: int, l: int) -> np.ndarray:
    """(count, l) int32 array of colex combinations with ranks [offset, offset+count).

    Rows are position tuples into a node's (compacted) neighbour list. A node
    with degree d uses only the rows with rank < C(d, l); higher rows must be
    masked by the caller.

    The enumeration is a pure-Python successor loop, so results are memoized:
    the same (offset, count, l) windows recur for every level of every block.
    Returned arrays are read-only views of the cache.
    """
    if l == 0:
        return np.zeros((count, 0), dtype=np.int32)
    key = (offset, count, l)
    hit = _CHUNK_CACHE.get(key)
    if hit is not None:
        return hit
    out = np.empty((count, l), dtype=np.int32)
    c = colex_unrank(offset, l)
    for row in range(count):
        out[row] = c
        _colex_next(c)
    out.setflags(write=False)
    if len(_CHUNK_CACHE) >= _CHUNK_CACHE_MAX:
        _CHUNK_CACHE.pop(next(iter(_CHUNK_CACHE)))
    _CHUNK_CACHE[key] = out
    return out
