"""MashMap's statistics (its map_stats.hpp and Map::setProbs), a frozen
copy for the reference: the Jaccard-distance conversions in MashMap's
mix of float and double, the relaxed minimum of shared sketch hashes a
mapping needs, and the L1 cutoff table of its top-ANI filter.
"""

from __future__ import annotations

import functools
import math

import numpy as np
from scipy import stats as sps

CONFIDENCE_INTERVAL = 0.95
ANI_DIFF = 0.0
ANI_DIFF_CONF = 0.999
SS_TABLE_MAX = 1000


def j2md(j: float, k: int) -> float:
    """Jaccard estimate to Mash distance: ``2j/(1+j)`` in float, the
    power in double, the result rounded to float."""
    j = np.float32(j)
    if j == 0:
        return float(np.float32(1.0))
    if j == 1:
        return float(np.float32(0.0))
    ratio = np.float32(2.0) * j / (np.float32(1.0) + j)
    return float(np.float32(1.0 - np.float64(ratio) ** (1.0 / k)))


def md2j(d: float, k: int) -> float:
    d = np.float32(d)
    simk = np.float64(np.float32(1.0) - d) ** k
    return float(np.float32(simk / (2.0 - simk)))


def md_lower_bound(d: float, s: int, k: int, ci: float) -> float:
    q2 = (1.0 - ci) / 2.0
    j = md2j(d, k)
    x = max(int(math.ceil(s * j)), 1)
    while x <= s:
        if float(sps.binom.sf(x - 1, s, j)) < q2:
            x -= 1
            break
        x += 1
    return j2md(float(np.float32(x) / np.float32(s)), k)


@functools.lru_cache(maxsize=None)
def minimum_hits(s: int, k: int, identity: float) -> int:
    """The fewest shared hashes whose identity's upper confidence bound
    still reaches ``identity``."""
    start = int(math.ceil(1.0 * s * md2j(1.0 - identity, k)))
    relaxed = start
    for i in range(start, -1, -1):
        d = j2md(float(np.float32(1.0) * np.float32(i) / np.float32(s)), k)
        if 1.0 - md_lower_bound(d, s, k, CONFIDENCE_INTERVAL) >= identity:
            relaxed = i
        else:
            break
    return relaxed


@functools.lru_cache(maxsize=None)
def cutoffs(s: int, k: int) -> np.ndarray:
    """``table[c]``: the least L1 intersection a candidate needs where
    the best candidate's is ``c`` (hypergeometric, at ANIDiff 0)."""
    min_p = 1.0 - ANI_DIFF_CONF
    ss = int(min(s, SS_TABLE_MAX))
    ys = np.arange(ss + 1)
    probs = np.zeros((ss + 1, ss + 1))
    for ci in range(ss + 1):
        probs[ci, :ci + 1] = sps.hypergeom.pmf(ys[:ci + 1], 2 * ss - ci,
                                               ss, ci)

    def above(cmax: int, ci: int) -> bool:
        pr = 0.0
        for ymax in range(cmax + 1):
            cut = float(ymax)
            acc = (float(sps.hypergeom.cdf(cut - 1, 2 * ss - ci, ss, ci))
                   if cut - 1 >= 0 else 0.0)
            pr += probs[cmax][ymax] * (1.0 - acc)
            if pr > min_p:
                return True
        return pr > min_p

    table = np.ones(ss + 1, np.int64)
    for cmax in range(1, ss + 1):
        lo, hi = 0, ss
        while lo < hi:
            mid = (lo + hi) // 2
            if above(cmax, mid):
                hi = mid
            else:
                lo = mid + 1
        table[cmax] = max(lo, 1)
    return table
