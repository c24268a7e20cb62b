"""Stage L2: windowed minhash intersection over an L1 candidate region.

The reference slides a window over position-sorted minmer intervals with a
min-heap plus an incrementally-maintained ordered map (SlideMapper) whose
pivot tracks the bottom-s boundary of S(A u B)
(computeMap.hpp:1275-1451, slidingMap.hpp:28-212).

TPU-shaped closed form used here: for entry step t and interval i,

    active[t, i] = (i <= t) & (wend_i > wpos_t)

and the SlideMapper state is recovered per step with bucketed counting
against the query's sorted sketch hashes:

    rank_j(t)  = (j+1) + #(active non-matching intervals with hash < q_j)
    pivot(t)   = max j with rank_j(t) <= s
    shared(t)  = #(active matching j <= pivot)
    votes(t)   = sum of q_strand_j * ref_strand over those j

All of it is comparisons and (T x T) @ (T x s) counting matmuls. On this
host path they run as float32 BLAS products (``_count``): the operands
are 0/+-1 and every partial sum is an integer below 2^24, so each sum is
exact; integer numpy matmuls take no BLAS and are far slower. The plateau bookkeeping of
the reference (best / in_candidate / l2_vec merging,
computeMap.hpp:1373-1450) reduces to runs of `shared == max(shared)`.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..index.builder import ReferenceIndex


@dataclasses.dataclass
class L2Locus:
    seq_id: int
    mean_optimal_pos: int
    optimal_start: int
    optimal_end: int
    shared_sketch_size: int
    strand: int  # +1 / -1


def _c_div2(a: int) -> int:
    """C++ integer division by 2 (truncation toward zero)."""
    q, r = divmod(a, 2)
    if a < 0 and r:
        q += 1
    return q


def pack_mi_key(seqid: np.ndarray, wpos: np.ndarray) -> np.ndarray:
    """Sortable (seqId, wpos) key for searchsorted over the interval table."""
    return (seqid.astype(np.int64) << np.int64(32)) | wpos.astype(np.int64)


def _count(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as int64 for float32 operands of 0/+-1 whose sums stay
    below 2^24 (so the float32 product is exact)."""
    assert a.shape[1] < 1 << 24, "too many intervals for exact float32"
    return (a @ b).astype(np.int64)


def shared_sketch_trajectory(
    hash_a: np.ndarray,
    wend_a: np.ndarray,
    wpos_main: np.ndarray,
    n_setup: int,
    q_hashes: np.ndarray,
    q_strand: np.ndarray,
    strand_a: np.ndarray,
    window_len: int = 0,
):
    """shared(t) and votes(t) after each main-step insertion.

    Args:
      hash_a/wend_a/strand_a: all considered intervals (setup + main),
        in index order.
      wpos_main: wpos of the main-step entries (len T_m).
      n_setup: number of leading setup entries.
      q_hashes: (s,) ascending query sketch.
      q_strand: (s,) int query minmer strands.
      window_len: L2 window extension (max(0, len - segLength)); with
        window_len > 0, multiple intervals of one hash can be active at
        once and must count once (the reference dedups via hash_to_freq,
        computeMap.hpp:1310,1327-1371 — its bookkeeping leaks opens for
        never-inserted duplicates; we use clean set semantics instead).

    Returns (shared, votes): int arrays of len T_m.
    """
    T_m = len(wpos_main)
    s_q = len(q_hashes)
    if T_m == 0 or s_q == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    b = np.searchsorted(q_hashes, hash_a)
    inb = b < s_q
    match = inb.copy()
    match[inb] = q_hashes[b[inb]] == hash_a[inb]

    t_abs = n_setup + np.arange(T_m)
    M = (np.arange(len(hash_a))[None, :] <= t_abs[:, None]) & \
        (wend_a[None, :].astype(np.int64)
         > (wpos_main[:, None].astype(np.int64) - window_len))
    Mi = M.astype(np.float32)
    rows = np.arange(len(hash_a))
    bc = np.minimum(b, s_q)

    if window_len > 0:
        # dedup per hash: any-active per hash group, then bucket
        _, gid = np.unique(hash_a, return_inverse=True)
        n_g = int(gid.max()) + 1 if len(gid) else 0
        Wg = np.zeros((len(hash_a), n_g), np.float32)
        Wg[rows, gid] = 1
        Gact = _count(Mi, Wg) > 0                       # (T_m, n_g)
        g_b = np.zeros(n_g, np.int64)
        g_b[gid] = bc
        g_match = np.zeros(n_g, bool)
        g_match[gid] = match
        g_in = np.zeros(n_g, bool)
        g_in[gid] = inb
        Wm = np.zeros((n_g, s_q + 1), np.float32)
        Wn = np.zeros((n_g, s_q + 1), np.float32)
        gr = np.arange(n_g)
        Wm[gr[g_match], g_b[g_match]] = 1
        gnm = ~g_match & g_in
        Wn[gr[gnm], g_b[gnm]] = 1
        Gi = Gact.astype(np.float32)
        A = _count(Gi, Wm)
        C = _count(Gi, Wn)
        # vote: sum of active interval strands of the matching hash
        W_vote = np.zeros((len(hash_a), s_q + 1), np.float32)
        W_vote[rows[match], bc[match]] = strand_a[match]
        V = _count(Mi, W_vote)
    else:
        W_match = np.zeros((len(hash_a), s_q + 1), np.float32)
        W_non = np.zeros((len(hash_a), s_q + 1), np.float32)
        W_vote = np.zeros((len(hash_a), s_q + 1), np.float32)
        W_match[rows[match], bc[match]] = 1
        nm = ~match & inb  # non-matching beyond q_max never affects the pivot
        W_non[rows[nm], bc[nm]] = 1
        W_vote[rows[match], bc[match]] = strand_a[match]
        A = _count(Mi, W_match)   # (T_m, s_q+1): active matching per bucket
        C = _count(Mi, W_non)     # active non-matching per gap bucket
        V = _count(Mi, W_vote)    # ref-strand of active matching interval

    rank = np.arange(1, s_q + 1)[None, :] + np.cumsum(C, axis=1)[:, :s_q]
    P = rank <= s_q
    shared = np.sum(np.minimum(A[:, :s_q], 1) * P, axis=1)
    votes = np.sum(V[:, :s_q] * P * q_strand[None, :s_q], axis=1)
    return shared.astype(np.int64), votes.astype(np.int64)


def l2_mapped_regions(
    index: ReferenceIndex,
    mi_key: np.ndarray,
    q_hashes: np.ndarray,
    q_strand: np.ndarray,
    seq_id: int,
    range_start: int,
    range_end: int,
    seg_length: int,
    window_len: int,
    q_are_codes: bool = False,
) -> List[L2Locus]:
    """All optimal-plateau loci of one L1 candidate (computeMap.hpp:1275-1451).

    Comparisons run in the rank-code domain ((rank << 1) | 1 for index
    rows, (insertion_pos << 1) | found for the query sketch) — order-
    isomorphic to the u64 hashes, matching the device kernel exactly.
    ``q_are_codes=True`` means ``q_hashes`` already holds l1_step's
    int32 codes (device host-replay path); otherwise they are raw u64
    sketch hashes and are coded here.
    """
    # reference searches from rangeStart - segLength - 1
    # (computeMap.hpp:1290-1293); negatives clamp to 0 since wpos >= 0
    lo = int(np.searchsorted(
        mi_key, (np.int64(seq_id) << 32) | np.int64(
            max(0, range_start - seg_length - 1))))
    mid = int(np.searchsorted(mi_key, (np.int64(seq_id) << 32)
                              | np.int64(max(0, range_start))))
    hi = int(np.searchsorted(
        mi_key, (np.int64(seq_id) << 32)
        | np.int64(range_end + window_len + 1)))
    T_m = hi - mid
    if T_m <= 0:
        return []

    hash_a = (index.mi_rank[lo:hi].astype(np.int64) << 1) | 1
    wend_a = index.mi_wend[lo:hi]
    strand_a = index.mi_strand[lo:hi].astype(np.int32)
    wpos_main = index.mi_wpos[mid:hi].astype(np.int64)

    if q_are_codes:
        q_cmp = np.asarray(q_hashes).astype(np.int64)
    else:
        U = len(index.uniq_hashes)
        pos = np.searchsorted(index.uniq_hashes, q_hashes)
        if U:
            found = index.uniq_hashes[np.minimum(pos, U - 1)] == q_hashes
        else:
            found = np.zeros(len(q_hashes), bool)
        q_cmp = (pos.astype(np.int64) << 1) | found

    shared, votes = shared_sketch_trajectory(
        hash_a, wend_a, wpos_main, mid - lo, q_cmp, q_strand, strand_a,
        window_len)
    if len(shared) == 0:
        return []

    # next-entry wpos (global table; reference reads the neighbor entry,
    # computeMap.hpp:1386-1390)
    g = np.arange(mid, hi)
    has_next = (g + 1 < len(index.mi_wpos)) & \
        (index.mi_seqid[np.minimum(g + 1, len(index.mi_wpos) - 1)] == seq_id)
    next_wpos = np.where(
        has_next, index.mi_wpos[np.minimum(g + 1, len(index.mi_wpos) - 1)],
        index.mi_wpos[g]).astype(np.int64)

    return plateau_loci(shared, votes, wpos_main, next_wpos, seq_id,
                        seg_length, window_len)


def loci_from_runs(n_runs: int, best: int, starts, ends, strands,
                   seq_id: int, seg_length: int) -> List[L2Locus]:
    """Merge device-extracted plateau runs into loci.

    Host half of the split plateau walk: kernels/mapdev.py extracts the
    (<= L2_RUN_CAP) maximal shared==best runs on device; this merges
    runs closer than segLength (computeMap.hpp:1430-1446 semantics,
    window_len == 0 path). One item at a time: the rule that
    ``loci_arrays`` applies to whole run buffers.
    """
    out: List[L2Locus] = []
    for i in range(int(n_runs)):
        opt_start, opt_end = int(starts[i]), int(ends[i])
        if out and out[-1].optimal_end + seg_length >= opt_start:
            out[-1].optimal_end = opt_end
            out[-1].mean_optimal_pos = _c_div2(
                out[-1].optimal_start + opt_end)
        else:
            out.append(L2Locus(
                seq_id=seq_id,
                mean_optimal_pos=_c_div2(opt_start + opt_end),
                optimal_start=opt_start,
                optimal_end=opt_end,
                shared_sketch_size=int(best),
                strand=int(strands[i]),
            ))
    return out


def loci_arrays(n_runs, best, starts, ends, strands, seg_length: int):
    """``loci_from_runs`` over (R, L) run arrays at once.

    A locus opens at a row's first run and wherever a run starts more
    than seg_length after the previous run's end (the open locus's
    optimal_end is always the previous run's end); it keeps its first
    run's start and strand and its last run's end. Returns the loci's
    (row, optimal_start, optimal_end, mean_optimal_pos, shared, strand),
    by row and then in order.
    """
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    L = starts.shape[1]
    n_runs = np.minimum(np.asarray(n_runs, np.int64), L)
    opens = np.arange(L)[None, :] < n_runs[:, None]
    opens[:, 1:] &= starts[:, 1:] > ends[:, :-1] + seg_length
    row, col = np.nonzero(opens)
    # a locus's last run: the one before the next opening of its row,
    # else the row's last run
    n_open = opens.sum(axis=1)
    last = np.empty(len(row), np.int64)
    last[:-1] = col[1:] - 1
    row_end = np.cumsum(n_open)[n_open > 0] - 1
    last[row_end] = n_runs[row[row_end]] - 1
    o_start = starts[row, col]
    o_end = ends[row, last]
    # C++'s division by 2 truncates toward zero (_c_div2)
    tot = o_start + o_end
    mean = np.where(tot < 0, -((-tot) // 2), tot // 2)
    return (row, o_start, o_end, mean, np.asarray(best, np.int64)[row],
            np.asarray(strands, np.int64)[row, col])


def plateau_loci(shared, votes, wpos_main, next_wpos, seq_id: int,
                 seg_length: int, window_len: int) -> List[L2Locus]:
    """Optimal-plateau bookkeeping (computeMap.hpp:1373-1450).

    The reference's best / in_candidate walk reduces to: candidates are
    the maximal runs of shared == max(1, max(shared)); a run closed by a
    drop extends its optimalEnd to the *closing* step's neighbor wpos;
    runs closer than segLength merge.
    """
    T_m = len(shared)
    final_best = max(1, int(shared.max()))
    eq = shared == final_best
    if not eq.any():
        return []

    starts = np.nonzero(eq & ~np.concatenate(([False], eq[:-1])))[0]
    ends = np.nonzero(eq & ~np.concatenate((eq[1:], [False])))[0]

    out: List[L2Locus] = []
    for run_i, (ta, tb) in enumerate(zip(starts, ends)):
        increase = final_best > 1 and run_i == 0
        opt_start = int(wpos_main[ta]) - (0 if increase else window_len)
        if tb + 1 < T_m:
            opt_end = int(next_wpos[tb + 1]) - window_len
        else:
            opt_end = int(next_wpos[tb]) - window_len
        strand = 1 if votes[tb] >= 0 else -1
        if out and out[-1].optimal_end + seg_length >= opt_start:
            out[-1].optimal_end = opt_end
            out[-1].mean_optimal_pos = _c_div2(
                out[-1].optimal_start + opt_end)
        else:
            out.append(L2Locus(
                seq_id=seq_id,
                mean_optimal_pos=_c_div2(opt_start + opt_end),
                optimal_start=opt_start,
                optimal_end=opt_end,
                shared_sketch_size=final_best,
                strand=strand,
            ))
    return out
