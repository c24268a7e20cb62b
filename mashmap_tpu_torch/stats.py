"""Statistical model: Jaccard <-> Mash distance, auto sketch size, cutoffs.

Host-side (SciPy) reimplementation of the reference's statistics layer
(reference: src/map/include/map_stats.hpp:45-258 and the hypergeometric
cutoff table at src/map/include/computeMap.hpp:178-258). All of these run
once per process at configuration time; their outputs are small scalars or
tables consumed by the device pipeline.

Floating-point note: the reference computes j2md/md2j in C++ ``float``
(32-bit). We mirror that with numpy float32 where the result feeds
tie-breaking thresholds, to maximize output parity.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np
from scipy import stats as sps


def j2md(j: float, k: int) -> float:
    """Jaccard estimate -> Mash distance. Reference: map_stats.hpp:45-55.

    Bit-exact float mixing: the reference computes ``2*j/(1+j)`` in
    C++ float, promotes through ``std::pow`` in double, subtracts in
    double and rounds the assignment back to float.
    """
    j = np.float32(j)
    if j == 0:
        return float(np.float32(1.0))
    if j == 1:
        return float(np.float32(0.0))
    ratio = np.float32(2.0) * j / (np.float32(1.0) + j)      # f32
    md = np.float32(1.0 - np.float64(ratio) ** (1.0 / k))    # f64 pow
    return float(md)


def md2j(d: float, k: int) -> float:
    """Mash distance -> Jaccard estimate. Reference: map_stats.hpp:63-68.

    ``std::pow(sim, k)`` promotes to double; the division happens in
    double and the result rounds back to float on assignment.
    """
    d = np.float32(d)
    sim = np.float32(1.0) - d
    simk = np.float64(sim) ** k
    return float(np.float32(simk / (2.0 - simk)))


def binom_sf(x: int, p: float, n: int) -> float:
    """P(X > x) for X ~ Binomial(n, p) (== gsl_cdf_binomial_Q(x, p, n))."""
    return float(sps.binom.sf(x, n, p))


def md_lower_bound(d: float, s: int, k: int, ci: float) -> float:
    """Lower bound on distance d within confidence interval.

    Reference: map_stats.hpp:81-113 (GSL branch: upward linear search).
    """
    q2 = (1.0 - ci) / 2.0
    j = md2j(d, k)
    x = max(int(math.ceil(s * j)), 1)
    while x <= s:
        # probability of having x or more shared sketches
        cdf_complement = binom_sf(x - 1, j, s)
        if cdf_complement < q2:
            x -= 1  # last guess was right
            break
        x += 1
    jaccard = np.float32(x) / np.float32(s)
    return j2md(float(jaccard), k)


def estimate_minimum_hits(s: int, k: int, perc_identity: float) -> int:
    """Min shared sketches for the target identity. map_stats.hpp:122-133."""
    mash_dist = 1.0 - perc_identity
    jaccard = md2j(mash_dist, k)
    return int(math.ceil(1.0 * s * jaccard))


def estimate_minimum_hits_relaxed(
    s: int, k: int, perc_identity: float, confidence_interval: float
) -> int:
    """Min shared sketches s.t. CI upper-bound identity >= target.

    Reference: map_stats.hpp:144-169 (downward search from the strict bound).
    """
    start = estimate_minimum_hits(s, k, perc_identity)
    relaxed = start
    for i in range(start, -1, -1):
        jaccard = float(np.float32(1.0) * np.float32(i) / np.float32(s))
        d = j2md(jaccard, k)
        d_lower = md_lower_bound(d, s, k, confidence_interval)
        id_upper = 1.0 - d_lower
        if id_upper >= perc_identity:
            relaxed = i
        else:
            break
    return relaxed


def estimate_pvalue(
    s: int,
    k: int,
    alphabet_size: int,
    identity: float,
    length_query: int,
    length_reference: int,
    confidence_interval: float,
) -> float:
    """P-value of a random match. Reference: map_stats.hpp:181-220."""
    kmer_space = float(alphabet_size) ** k
    p_x = 1.0 / (1.0 + kmer_space / length_query)
    r = p_x * p_x / (p_x + p_x - p_x * p_x)
    x = estimate_minimum_hits_relaxed(s, k, identity, confidence_interval)
    if x == 0:
        cdf_complement = 1.0
    else:
        cdf_complement = binom_sf(x - 1, r, s)
    return length_reference * cdf_complement


def recommended_sketch_size(
    pvalue_cutoff: float,
    confidence_interval: float,
    k: int,
    alphabet_size: int,
    identity: float,
    segment_length: int,
    length_reference: int,
) -> int:
    """Smallest sketch size meeting the p-value cutoff (steps of 10).

    Reference: map_stats.hpp:234-258.
    """
    length_query = segment_length - k
    s = 10
    while s < length_query:
        pval = estimate_pvalue(
            s, k, alphabet_size, identity, length_query, length_reference,
            confidence_interval)
        if pval <= pvalue_cutoff:
            break
        s += 10
    return s


def cutoffs_cache_path(sketch_size: int, kmer_size: int, ANIDiff: float,
                       ANIDiffConf: float,
                       ss_table_max: float = 1000.0) -> str:
    """Where sketch_cutoffs keeps the table of these arguments on disk:
    under $XDG_CACHE_HOME (default ~/.cache)/mashmap_tpu_torch, named as
    the JAX package names its copy."""
    cache_dir = os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "mashmap_tpu_torch")
    return os.path.join(
        cache_dir, f"cutoffs_v1_{sketch_size}_{kmer_size}_{ANIDiff:.6g}_"
                   f"{ANIDiffConf:.6g}_{ss_table_max:.6g}.npy")


@lru_cache(maxsize=8)
def sketch_cutoffs(
    sketch_size: int,
    kmer_size: int,
    ANIDiff: float,
    ANIDiffConf: float,
    ss_table_max: float = 1000.0,
) -> np.ndarray:
    """Hypergeometric L1 cutoff table (``compute_cutoffs``), memoized.

    The table depends only on its arguments and costs seconds to minutes
    of SciPy time (about s^2.2; the reference pays the same via GSL on
    every start, computeMap.hpp:178), so it is memoized for the process
    and on disk (``cutoffs_cache_path``), as the JAX package keeps it. A
    file that cannot be read is computed again; one that cannot be
    written is skipped.
    """
    path = cutoffs_cache_path(sketch_size, kmer_size, ANIDiff, ANIDiffConf,
                              ss_table_max)
    try:
        return np.load(path)
    except (OSError, ValueError, EOFError):
        pass
    table = compute_cutoffs(sketch_size, kmer_size, ANIDiff, ANIDiffConf,
                            ss_table_max)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(tmp, table)
        os.replace(tmp, path)
    except OSError:
        pass
    return table


def compute_cutoffs(
    sketch_size: int,
    kmer_size: int,
    ANIDiff: float,
    ANIDiffConf: float,
    ss_table_max: float = 1000.0,
) -> np.ndarray:
    """Hypergeometric L1 cutoff table.

    ``table[cmax]`` is the minimum L1 intersection size a candidate needs
    when the best candidate's intersection size is ``cmax``.
    Reference: src/map/include/computeMap.hpp:178-258 (Map::setProbs).
    Returns an int array of length ``min(sketch_size, ss_table_max)+1``.
    """
    min_p = 1.0 - ANIDiffConf
    ss = int(min(float(sketch_size), ss_table_max))

    # sketch_probs[ci][y] = HG pmf(y; draws=ci, tagged=ss, untagged=ss-ci)
    # gsl_ran_hypergeometric_pdf(y, n1=ss, n2=ss-ci, t=ci)
    #   == scipy.stats.hypergeom.pmf(y, M=n1+n2, n=n1, N=t)
    ys = np.arange(ss + 1)
    sketch_probs = np.zeros((ss + 1, ss + 1))
    for ci in range(ss + 1):
        sketch_probs[ci, : ci + 1] = sps.hypergeom.pmf(
            ys[: ci + 1], 2 * ss - ci, ss, ci)

    def dist_diff(cmax: int, ci: int) -> bool:
        # True iff Pr(ANI_i >= ANI_max - deltaANI) >= min_p
        pr_above = 0.0
        for ymax in range(cmax + 1):
            pymax = sketch_probs[cmax][ymax]
            if ANIDiff == 0:
                yi_cutoff = float(ymax)
            else:
                yi_cutoff = math.floor(
                    md2j(j2md(ymax / ss, kmer_size) + ANIDiff, kmer_size) * ss)
            if yi_cutoff - 1 >= 0:
                pi_acc = float(sps.hypergeom.cdf(
                    yi_cutoff - 1, 2 * ss - ci, ss, ci))
            else:
                pi_acc = 0.0
            pi_acc = 1.0 - pi_acc
            pr_above += pymax * pi_acc
            if pr_above > min_p:
                return True
        return pr_above > min_p

    table = np.ones(ss + 1, dtype=np.int64)
    for cmax in range(1, ss + 1):
        # binary search for the lowest ci in [0, ss-1] with dist_diff True
        # (reference uses std::upper_bound over [0, ss), computeMap.hpp:232-245)
        lo, hi = 0, ss  # search in range(0, ss); hi = one-past-last
        while lo < hi:
            mid = (lo + hi) // 2
            if dist_diff(cmax, mid):
                hi = mid
            else:
                lo = mid + 1
        table[cmax] = lo
        if table[cmax] == 0:
            table[cmax] = 1
    return table
