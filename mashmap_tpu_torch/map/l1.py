"""Stage L1: candidate region finding via sorted interval points.

The reference streams OPEN/CLOSE interval points through a heap-merge and
two trailing/leading-iterator sweeps (computeMap.hpp:856-1116). Here the
same math is flat array ops: gather CSR postings for the fragment's
sketch hashes, sort the 2P interval endpoints by (seqId, pos, side) with
CLOSE before OPEN at equal positions, and prefix-sum the +-1 sides — the
running sum after the last event at a position IS the reference's
"overlapCount" at that position. Candidate regions are maximal runs of
positions whose overlap clears `minimumHits`, clustered within a segment
length (computeMap.hpp:1009-1115).

Currently implements the windowLen == 0 case (every split fragment and
every short read: windowLen = max(0, len - segLength), computeMap.hpp:933).
The windowLen > 0 case (--noSplit with long reads) lives in
`l1_candidates_windowed`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..index.builder import ReferenceIndex


@dataclasses.dataclass
class L1Candidate:
    seq_id: int
    range_start: int
    range_end: int
    intersection: int


def gather_postings(index: ReferenceIndex, q_hashes: np.ndarray):
    """CSR gather of all posting rows for the given (sorted) hashes.

    Returns (seqid, wpos, wend, hash_rep) arrays of all intervals, ordered
    by (hash, seqid, wpos) — i.e. CSR row order; hash_rep repeats the
    owning hash per row.
    """
    U = len(index.uniq_hashes)
    if U == 0 or len(q_hashes) == 0:
        z = np.empty(0, np.int64)
        return (z.astype(np.int32), z.astype(np.int32), z.astype(np.int32),
                z.astype(np.uint64))
    idx = np.searchsorted(index.uniq_hashes, q_hashes)
    idx = np.minimum(idx, U - 1)
    found = index.uniq_hashes[idx] == q_hashes
    idx = idx[found]
    starts = index.post_offsets[idx]
    ends = index.post_offsets[idx + 1]
    cnts = ends - starts
    total = int(cnts.sum())
    if total == 0:
        z = np.empty(0, np.int64)
        return (z.astype(np.int32), z.astype(np.int32), z.astype(np.int32),
                z.astype(np.uint64))
    # CSR multi-range gather
    out = np.repeat(starts - np.concatenate(([0], np.cumsum(cnts)[:-1])),
                    cnts) + np.arange(total)
    hash_rep = np.repeat(q_hashes[found], cnts)
    return (index.post_seqid[out], index.post_wpos[out],
            index.post_wend[out], hash_rep)


def l1_candidates(
    seqid: np.ndarray,
    wpos: np.ndarray,
    wend: np.ndarray,
    minimum_hits: int,
    sketch_size: int,
    cluster_len: int,
    use_topANI_filter: bool,
    cutoff_table: Optional[np.ndarray],
    table_scale: float,
    stage2_full_scan: bool = True,
) -> List[L1Candidate]:
    """Candidate regions from a fragment's seed-hit intervals.

    Implements computeMap.hpp:915-1116 for windowLen == 0; the two passes
    of the reference collapse into one cumsum plus a max.
    """
    if len(seqid) == 0 or minimum_hits > len(wpos) * 2:
        return []

    # interval points: CLOSE(-1) sorts before OPEN(+1) at equal (seq, pos)
    ev_seq = np.concatenate([seqid, seqid])
    ev_pos = np.concatenate([wpos, wend])
    ev_side = np.concatenate([np.ones(len(wpos), np.int32),
                              -np.ones(len(wend), np.int32)])
    o = np.lexsort((ev_side, ev_pos, ev_seq))
    ev_seq, ev_pos, ev_side = ev_seq[o], ev_pos[o], ev_side[o]

    overlap = np.cumsum(ev_side)

    # per-(seq,pos) group: overlap after the group's last event
    last = np.ones(len(ev_seq), bool)
    last[:-1] = (ev_seq[1:] != ev_seq[:-1]) | (ev_pos[1:] != ev_pos[:-1])
    g_seq = ev_seq[last]
    g_pos = ev_pos[last]
    g_ov = overlap[last]

    best = int(g_ov.max()) if len(g_ov) else 0
    if use_topANI_filter:
        if best < minimum_hits:
            return []
        ci = int(min(best, sketch_size) / max(1.0, table_scale))
        minimum_hits = max(int(cutoff_table[ci]), minimum_hits)

    m = g_ov >= minimum_hits
    if not m.any():
        return []

    # maximal runs of qualifying positions within one reference sequence
    run_start = m & (~np.concatenate(([False], m[:-1]))
                     | np.concatenate(([True], g_seq[1:] != g_seq[:-1])))
    run_id = np.cumsum(run_start) - 1
    sel = np.nonzero(m)[0]
    rid = run_id[sel]
    n_runs = int(rid[-1]) + 1
    first = np.full(n_runs, np.iinfo(np.int64).max)
    lastp = np.full(n_runs, -1, np.int64)
    inter = np.zeros(n_runs, np.int64)
    np.minimum.at(first, rid, g_pos[sel])
    np.maximum.at(lastp, rid, g_pos[sel])
    np.maximum.at(inter, rid, g_ov[sel])
    rseq = np.zeros(n_runs, np.int64)
    rseq[rid] = g_seq[sel]

    if not stage2_full_scan:
        # keep only the peak position of each run (computeMap.hpp:1081-1085):
        # the FIRST position achieving the run maximum
        first_peak = np.full(n_runs, np.iinfo(np.int64).max)
        is_peak = g_ov[sel] == inter[rid]
        np.minimum.at(first_peak, rid[is_peak], g_pos[sel][is_peak])
        first = first_peak
        lastp = first_peak.copy()

    # cluster runs within cluster_len on the same sequence
    # (computeMap.hpp:1102-1115)
    out: List[L1Candidate] = []
    for i in range(n_runs):
        if out and out[-1].seq_id == rseq[i] \
                and first[i] <= out[-1].range_end + cluster_len:
            out[-1].range_end = int(lastp[i])
            out[-1].intersection = max(out[-1].intersection, int(inter[i]))
        else:
            out.append(L1Candidate(int(rseq[i]), int(first[i]),
                                   int(lastp[i]), int(inter[i])))
    return out


def l1_candidates_windowed(
    seqid: np.ndarray,
    wpos: np.ndarray,
    wend: np.ndarray,
    hashes_rep: np.ndarray,
    window_len: int,
    minimum_hits: int,
    sketch_size: int,
    cluster_len: int,
    use_topANI_filter: bool,
    cutoff_table: Optional[np.ndarray],
    table_scale: float,
    stage2_full_scan: bool = True,
) -> List[L1Candidate]:
    """General windowLen > 0 variant (--noSplit long reads).

    The reference counts, at each position P, the distinct sketch hashes
    with an interval intersecting [P, P+windowLen] (hash_to_freq dedup,
    computeMap.hpp:944-975). Equivalent formulation: extend every CLOSE
    point by windowLen, union overlapping intervals per hash, then run the
    windowLen == 0 sweep; candidate positions shift by -windowLen
    (computeMap.hpp:1071-1084 subtracts windowLen).
    """
    if len(seqid) == 0:
        return []
    # per-hash interval union after extending ends by window_len
    o = np.lexsort((wpos, seqid, hashes_rep))
    h, sq = hashes_rep[o], seqid[o]
    b = wpos[o].astype(np.int64)
    e = wend[o].astype(np.int64) + window_len
    same = np.zeros(len(h), bool)
    same[1:] = (h[1:] == h[:-1]) & (sq[1:] == sq[:-1])
    # merge chains where next begin <= running max end of the group
    # (intervals per hash are begin-sorted; do a simple scan via numpy
    #  maximum.accumulate reset at group starts)
    grp = np.cumsum(~same)
    run_e = np.empty(len(e), np.int64)
    # group-wise cummax of e
    run_e = _grouped_cummax(e, grp)
    new_iv = ~same | (b > np.concatenate(([0], run_e[:-1])))
    iv_id = np.cumsum(new_iv) - 1
    n_iv = iv_id[-1] + 1
    iv_b = np.full(n_iv, np.iinfo(np.int64).max)
    iv_e = np.zeros(n_iv, np.int64)
    np.minimum.at(iv_b, iv_id, b)
    np.maximum.at(iv_e, iv_id, e)
    iv_s = np.zeros(n_iv, np.int64)
    iv_s[iv_id] = sq
    cands = l1_candidates(
        iv_s, iv_b, iv_e, minimum_hits, sketch_size, cluster_len,
        use_topANI_filter, cutoff_table, table_scale, stage2_full_scan)
    for c in cands:
        c.range_start -= window_len
        c.range_end -= window_len
    return cands


def _grouped_cummax(x: np.ndarray, grp: np.ndarray) -> np.ndarray:
    """Cumulative max of x, restarting whenever grp changes."""
    out = x.copy()
    if len(x) < 2:
        return out
    # offset trick: subtract a per-group huge base, cummax, re-add
    base = np.int64(1) << 40
    adj = x + grp.astype(np.int64) * base
    cm = np.maximum.accumulate(adj)
    return cm - grp.astype(np.int64) * base
