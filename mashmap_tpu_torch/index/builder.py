"""Reference index construction.

Counterpart of ``mashmap_tpu/index/builder.py``. The reference's
pointer-based structures become sorted arrays:

- ``skch::Sketch::minmerPosLookupIndex`` (hash -> interval-point postings,
  reference: winSketch.hpp:100-101,379-404) becomes a sorted unique-hash
  array + CSR interval postings => L1 lookup is a batched searchsorted.
- ``skch::Sketch::minmerIndex`` (position-sorted MinmerInfo vector,
  winSketch.hpp:102) becomes parallel arrays sorted by (seqId, wpos, wend).
- frequent-seed filtering (winSketch.hpp:410-509) becomes a histogram over
  CSR row lengths.

Per contig group the device runs hashing -> rank reduction -> theta
(kernels/winnow.py, the hand-written theta kernel) -> membership events
(kernels/events.py) -> their pairing, strand classification and u64
resolution (``classify_group``); one device->host copy brings the
group's final arrays to the host, where a worker thread splits them by
contig while the next group's device phases run, then the host
assembles the CSR. A contig over the rank limit takes the host route
(``_build_group_host``), which classifies on the host.

Known reference bugs deliberately not replicated (as in the JAX build):
- addMinmers' heap refill can insert an expired k-mer after a partial
  cleanup (commonFunc.hpp:487-504); exact set semantics are computed.
- posting-list coalescing ignores seqId (winSketch.hpp:388-396); we
  coalesce per (hash, seqId).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..hostcopy import HostCopy
from ..kernels import events as events_mod
from ..kernels import kmers, winnow
from ..kernels.murmur import UMAX
from ..kernels.theta import RSENT
from ..utils import resolve_device

logger = logging.getLogger("mashmap_tpu_torch.index")

# contigs beyond this many positions use the streaming (chunked + halo)
# events path; module-level so tests can force the chunked path
_EVENTS_CH_MAX = 1 << 24

# default k-mer positions per contig group (each group has its own
# int32 rank domain; ranks must stay below 2^30 for the event packing)
DEFAULT_RANK_LIMIT = 256 * 1024 * 1024

# host seconds of each phase of the last build_index call, by the first
# contig of each group and the phase's label (_group_clock); the labels
# of WORKER_PHASES run on the build's worker thread, the rest on the
# calling thread
GROUP_PHASE_S: dict[int, dict[str, float]] = {}
WORKER_PHASES = ("host-classify", "resolve-u64")

FWD = np.int8(1)
REV = np.int8(-1)

_HASH_SLAB = 1 << 23  # raw bytes hashed per device call


def _slab_step(k: int) -> int:
    return _HASH_SLAB - k + 1


def _sort_by_hash_then_pos(h, W):
    """Sort (h, W) pairs by (h, W) via one packed-uint64 ``np.sort``.

    Requires 0 <= h < 2**31 and 0 <= W < 2**32; (h, W) pairs are
    distinct so tie order is moot.
    """
    key = h.astype(np.uint64)
    key <<= np.uint64(32)
    key |= (W.view(np.uint64) if W.dtype == np.int64
            else W.astype(np.uint64))  # W >= 0: same bits
    key.sort()
    h_out = (key >> np.uint64(32)).astype(h.dtype)
    key &= np.uint64(0xFFFFFFFF)
    return h_out, key.view(np.int64)


def _sorted_groups(x):
    """(group_starts, group_counts) of equal runs in a SORTED array."""
    n = len(x)
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    bnd = np.empty(n, bool)
    bnd[0] = True
    np.not_equal(x[1:], x[:-1], out=bnd[1:])
    starts = np.flatnonzero(bnd)
    return starts, np.diff(np.append(starts, n))


def _pair_begin_end(beg_h, beg_W, end_h, end_W, n_flush):
    """Pair the j-th begin of every hash with its j-th end.

    Inputs need not be sorted. Returns (iv_hash, iv_wb, iv_we,
    unique_begin_hashes); unmatched begins flush at ``n_flush``
    (reference flush value len-k+1, commonFunc.hpp:508-520).
    """
    if len(beg_h) == 0:
        assert len(end_h) == 0, "end event for unknown hash"
        e = np.empty(0, np.int64)
        return beg_h, e, e, np.unique(beg_h)
    assert n_flush < (1 << 32), "contig too long for packed keys"
    uncompress = None
    if int(beg_h.max()) >= (1 << 31):
        # raw u64 hash domain: rank-compress so the packed sort and the
        # dense inverse table stay small (order-isomorphic)
        uncompress = np.unique(np.concatenate([
            beg_h.astype(np.uint64), end_h.astype(np.uint64)]))
        beg_h = np.searchsorted(uncompress, beg_h.astype(np.uint64))
        end_h = np.searchsorted(uncompress, end_h.astype(np.uint64))
    beg_h, beg_W = _sort_by_hash_then_pos(beg_h, beg_W)
    end_h, end_W = _sort_by_hash_then_pos(end_h, end_W)

    b_start, b_cnt = _sorted_groups(beg_h)
    uh = beg_h[b_start]
    e_start_u, e_cnt_u = _sorted_groups(end_h)
    ue = end_h[e_start_u]
    e_cnt = np.zeros(len(uh), np.int64)
    hi_rank = int(uh[-1]) if len(uh) else -1
    if len(ue):
        hi_rank = max(hi_rank, int(ue[-1]))
    inv = np.full(hi_rank + 1, -1, np.int32)
    inv[uh] = np.arange(len(uh), dtype=np.int32)
    pos_in_uh = inv[ue].astype(np.int64)
    assert (pos_in_uh >= 0).all(), "end event for unknown hash"
    e_cnt[pos_in_uh] = e_cnt_u
    assert np.all((b_cnt - e_cnt >= 0) & (b_cnt - e_cnt <= 1)), \
        "begin/end events must alternate per hash"

    # paired part: j-th begin of each hash matches its j-th end
    n_pairs = e_cnt
    rank_b = np.arange(len(beg_h)) - np.repeat(b_start, b_cnt)
    paired_b = rank_b < np.repeat(n_pairs, b_cnt)
    flush_b = ~paired_b

    iv_hash = beg_h
    iv_wb = beg_W
    iv_we = np.empty(len(beg_h), np.int64)
    iv_we[paired_b] = end_W
    iv_we[flush_b] = n_flush
    if uncompress is not None:
        iv_hash = uncompress[iv_hash]
        uh = uncompress[uh]
    return iv_hash, iv_wb, iv_we, uh


def strand_classify(iv_hash, iv_wb, iv_we, mp, mh, md, n_w, s_b, n_k,
                    hash_dtype=np.int32):
    """Strand vote events & sign-class interval splits (host, sparse).

    Consumes the membership intervals plus the member-hash occurrence
    list (position, hash, strand ±1) and classifies every interval
    segment by the sign of the aggregate strand vote (reference:
    commonFunc.hpp:394-437 strand bookkeeping). Event order is
    (hash, W, leave-before-enter, original order), reproduced by one
    packed sort (see the JAX build for the order-equivalence proof).
    """
    has_leave = (mp + 1) < n_w
    SH_H, SH_F = np.uint64(34), np.uint64(2)
    mh = np.asarray(mh)
    iv_hash = np.asarray(iv_hash)
    assert n_k + s_b + 2 < (1 << 32), "contig too long for packed keys"
    if len(mh) and int(mh.max()) >= (1 << 30):
        vals = np.unique(mh)
        mh = np.searchsorted(vals, mh).astype(np.int64)
        iv_hash_c = np.searchsorted(vals, iv_hash)
    else:
        iv_hash_c = iv_hash
    fld = (mp + 1).astype(np.uint64)
    md_ = np.asarray(md)
    key = np.concatenate([
        (np.asarray(mh).astype(np.uint64) << SH_H) | (fld << SH_F)
        | np.uint64(2) | (md_ > 0).astype(np.uint64),        # enter: t=1
        (np.asarray(mh)[has_leave].astype(np.uint64) << SH_H)
        | ((fld[has_leave] + np.uint64(s_b)) << SH_F)
        | (md_[has_leave] < 0).astype(np.uint64),            # leave: t=0
    ])
    key.sort()
    ev_h = (key >> SH_H).astype(np.int64)
    ev_W = np.maximum(
        ((key >> SH_F) & np.uint64(0xFFFFFFFF)).astype(np.int64) - s_b, 0)
    ev_t = ((key >> np.uint64(1)) & np.uint64(1)).astype(np.int8)
    ev_d = ((key & np.uint64(1)) * np.uint64(2)).astype(np.int64) - 1

    # per-hash running vote: global cumsum minus offset at group start
    n_ev = len(ev_h)
    newg = np.empty(n_ev, bool)
    if n_ev:
        newg[0] = True
        np.not_equal(ev_h[1:], ev_h[:-1], out=newg[1:])
    g_start = np.flatnonzero(newg)
    gh = ev_h[g_start]
    cum = np.cumsum(ev_d, dtype=np.int32)
    grp_idx = np.cumsum(newg, dtype=np.int32) - 1
    offs = np.where(g_start > 0, cum[g_start - 1], 0)
    v_after = cum - offs[grp_idx]
    v_before = v_after - ev_d
    class_change = (v_before < 0) != (v_after < 0)

    hr = grp_idx
    BIG = np.int64(2) * (n_k + s_b + 2)
    ev_key = hr.astype(np.int64) * BIG + ev_W * 2 + ev_t

    inv = np.full((int(gh[-1]) + 1) if len(gh) else 0, -1, np.int32)
    inv[gh] = np.arange(len(gh), dtype=np.int32)
    ivr = inv[np.asarray(iv_hash_c).astype(np.int64)].astype(np.int64)
    assert len(ivr) == 0 or (ivr >= 0).all(), \
        "interval hash with no occurrence events"
    # three searchsorted passes as one combined packed sort (markers
    # 0/1 sort before equal event keys (2), marker 3 after)
    q0 = (ivr * BIG + iv_wb * 2 + 1).astype(np.uint64)
    comb = np.concatenate([
        (ivr * BIG + (iv_wb + 1) * 2).astype(np.uint64) << SH_F,  # lo
        ((ivr * BIG + iv_we * 2).astype(np.uint64) << SH_F)
        | np.uint64(1),                                           # hi
        (ev_key.astype(np.uint64) << SH_F) | np.uint64(2),
        (q0 << SH_F) | np.uint64(3),
    ])
    comb.sort()
    mk = (comb & np.uint64(3)).astype(np.int8)
    evcnt = np.cumsum(mk == 2, dtype=np.int32)
    lo = evcnt[mk == 0]
    hi = evcnt[mk == 1]
    i0 = evcnt[mk == 3] - 1
    v0 = v_after[i0]
    cc_cum = np.concatenate((np.zeros(1, np.int32),
                             np.cumsum(class_change, dtype=np.int32)))
    nflag = cc_cum[hi] - cc_cum[lo]

    plain = nflag == 0
    s_hash = [iv_hash[plain]]
    s_wb = [iv_wb[plain]]
    s_we = [iv_we[plain]]
    s_strand = [np.where(v0[plain] < 0, REV, FWD)]

    # sign-class splitting of the flagged intervals
    flagged = np.nonzero(~plain)[0]
    if len(flagged):
        spans = (hi[flagged] - lo[flagged]).astype(np.int64)
        ev_rows = np.repeat(lo[flagged], spans) + (
            np.arange(spans.sum(), dtype=np.int64) - np.repeat(
                np.concatenate(([0], np.cumsum(spans)[:-1])), spans))
        iv_of_row = np.repeat(flagged, spans)
        ccm = class_change[ev_rows]
        r_iv = iv_of_row[ccm]
        r_rows = ev_rows[ccm]
        r_t = ev_W[r_rows]
        r_vb = v_before[r_rows]
        first = np.concatenate(([True], (r_iv[1:] != r_iv[:-1])
                                | (r_t[1:] != r_t[:-1])))
        r_iv, r_t, r_vb = r_iv[first], r_t[first], r_vb[first]
        seg_b = np.where(
            np.concatenate(([-1], r_iv[:-1])) == r_iv,
            np.concatenate(([0], r_t[:-1])), iv_wb[r_iv])
        s_hash.append(iv_hash[r_iv])
        s_wb.append(seg_b)
        s_we.append(r_t)
        s_strand.append(np.where(r_vb < 0, REV, FWD).astype(np.int8))

        lastmask = np.concatenate((r_iv[1:] != r_iv[:-1], [True]))
        lb_iv, lb_t = r_iv[lastmask], r_t[lastmask]
        assert np.array_equal(lb_iv, flagged), \
            "every flagged interval must own at least one boundary"
        v_fin = v_after[hi[flagged] - 1]
        keep_fin = iv_we[flagged] > lb_t
        s_hash.append(iv_hash[flagged][keep_fin])
        s_wb.append(lb_t[keep_fin])
        s_we.append(iv_we[flagged][keep_fin])
        s_strand.append(
            np.where(v_fin[keep_fin] < 0, REV, FWD).astype(np.int8))

    s_hash = np.concatenate(s_hash).astype(hash_dtype)
    s_wb = np.concatenate(s_wb).astype(np.int64)
    s_we = np.concatenate(s_we).astype(np.int64)
    s_strand = np.concatenate(s_strand).astype(np.int8)
    return s_hash, s_wb, s_we, s_strand


def contig_minmer_intervals(h, valid, strand, theta, window_span: int,
                            n_flush: int, sent=winnow.SENTINEL):
    """Minmer membership intervals of one contig from theta (host).

    Membership(h, W) = present(h, W) and h <= theta(W). One k-mer enters
    (position W + span - 1) and one leaves (position W - 1) per window
    step, so membership changes are O(1) per window: the entering hash
    gains membership if it newly became present and clears the
    threshold; when theta rises, the hash at the new threshold gains it;
    symmetric rules for losses (the reference's sequential sweep,
    commonFunc.hpp:376-520, as flat vector ops).

    ``h`` holds int32 ranks (the host route) or raw u64 hashes; ``theta``
    is in the same domain, ``sent`` where a window holds fewer than s.

    Returns ((hash, wb, we), (s_hash, s_wb, s_we, s_strand)): membership
    intervals (postings granularity, ``we`` of open intervals is
    ``n_flush``) and the strand-classified intervals before chunking.
    """
    n_k = len(h)
    s_b = int(window_span)
    n_w = len(theta)
    empty_h = np.empty(0, h.dtype)
    empty_i = np.empty(0, np.int64)
    if n_w <= 0:
        return ((empty_h, empty_i, empty_i),
                (empty_h, empty_i, empty_i, np.empty(0, np.int8)))

    # prev/next valid occurrence of the same hash: one packed-key sort
    # in the rank domain (values < 2^31, positions < 2^32)
    vpos = np.nonzero(valid)[0].astype(np.uint64)
    if h.dtype == np.uint64 or n_k >= (1 << 32):
        order = np.lexsort((vpos, h[vpos]))
        sp = vpos[order].astype(np.int64)
    else:
        key = (h[vpos].astype(np.uint64) << np.uint64(32)) | vpos
        key.sort()
        sp = (key & np.uint64(0xFFFFFFFF)).astype(np.int64)
    sh = h[sp]
    same_prev = np.zeros(len(sp), bool)
    same_prev[1:] = sh[1:] == sh[:-1]
    prev_s = np.where(same_prev, np.concatenate(([0], sp[:-1])), -1)
    same_next = np.zeros(len(sp), bool)
    same_next[:-1] = sh[1:] == sh[:-1]
    next_s = np.where(same_next, np.concatenate((sp[1:], [0])), n_k + s_b)
    prev_occ = np.full(n_k, -1, np.int32)
    prev_occ[sp] = prev_s
    next_occ = np.full(n_k, n_k + s_b, np.int32)
    next_occ[sp] = next_s

    # membership change events over W in [1, n_w); every access indexed
    # by W, W-1 or W+s_b-1 is a slice
    W = np.arange(1, n_w, dtype=np.int32)
    h_in = h[s_b:n_w + s_b - 1]                        # h[W + s_b - 1]
    th_W = theta[1:n_w]
    th_Wm1 = theta[:n_w - 1]
    newly = valid[s_b:n_w + s_b - 1] & (prev_occ[s_b:n_w + s_b - 1] < W)
    # an occurrence exactly s_b after the previous one keeps the hash
    # present: no new interval if it was already a member at W-1
    stayed = (prev_occ[s_b:n_w + s_b - 1] == W - 1) & (h_in <= th_Wm1)
    begin1 = newly & (h_in <= th_W) & ~stayed
    h_out = h[:n_w - 1]                                # h[W - 1]
    lost = valid[:n_w - 1] & \
        (next_occ[:n_w - 1].astype(np.int64) > W.astype(np.int64)
         + (s_b - 1))
    end1 = lost & (h_out <= th_Wm1)
    rose = th_W > th_Wm1
    begin2 = rose & (th_W != sent) & ~(begin1 & (h_in == th_W))
    fell = th_W < th_Wm1
    end2 = fell & (th_Wm1 != sent) & ~(lost & (h_out == th_Wm1))

    # initial members of window 0
    n0 = min(s_b, n_k)
    init_mask = valid[:n0] & (prev_occ[:n0] < 0) & (h[:n0] <= theta[0])

    beg_W = np.concatenate([np.zeros(init_mask.sum(), np.int64),
                            W[begin1].astype(np.int64),
                            W[begin2].astype(np.int64)])
    beg_h = np.concatenate([h[:n0][init_mask], h_in[begin1],
                            th_W[begin2]])
    end_W = np.concatenate([W[end1].astype(np.int64),
                            W[end2].astype(np.int64)])
    end_h = np.concatenate([h_out[end1], th_Wm1[end2]])

    iv_hash, iv_wb, iv_we, uh = _pair_begin_end(
        beg_h, beg_W, end_h, end_W, n_flush)

    # member occurrences: only hashes with membership intervals matter
    member_occ = np.isin(sh, uh)
    mp, mh = sp[member_occ], sh[member_occ]
    md = strand[mp].astype(np.int64)

    s_hash, s_wb, s_we, s_strand = strand_classify(
        iv_hash, iv_wb, iv_we, mp, mh, md, n_w, s_b, n_k, h.dtype)
    return (iv_hash, iv_wb, iv_we), (s_hash, s_wb, s_we, s_strand)


def _chunk_long_intervals(hash_, wb, we, strand, window_size: int):
    """Split intervals spanning more than windowSize into <=windowSize
    chunks (reference: commonFunc.hpp:531-555)."""
    span = we - wb
    long = span > window_size
    if not long.any():
        return hash_, wb, we, strand
    keep = ~long
    n_chunks = (-(-span[long] // window_size)).astype(np.int64)
    rep_h = np.repeat(hash_[long], n_chunks)
    rep_s = np.repeat(strand[long], n_chunks)
    rep_wb = np.repeat(wb[long], n_chunks)
    rep_we = np.repeat(we[long], n_chunks)
    local = np.arange(n_chunks.sum()) - np.repeat(
        np.concatenate(([0], np.cumsum(n_chunks)[:-1])), n_chunks)
    cb = rep_wb + local * window_size
    ce = np.minimum(cb + window_size, rep_we)
    return (np.concatenate([hash_[keep], rep_h]),
            np.concatenate([wb[keep], cb]),
            np.concatenate([we[keep], ce]),
            np.concatenate([strand[keep], rep_s]))


_NPZ_FIELDS = ("lengths", "uniq_hashes", "post_offsets", "post_seqid",
               "post_wpos", "post_wend", "mi_rank", "mi_seqid", "mi_wpos",
               "mi_wend", "mi_strand", "is_frequent")


@dataclasses.dataclass
class ReferenceIndex:
    """Host-side reference index (numpy arrays; see module docstring).
    The Mapper copies what it needs to its device."""

    # contig metadata (winSketch.hpp:79 `metadata`)
    names: List[str]
    lengths: np.ndarray                 # (n_contigs,) int64

    # L1 postings: CSR over sorted unique hashes
    uniq_hashes: np.ndarray             # (U,) uint64 sorted
    post_offsets: np.ndarray            # (U+1,) int64
    post_seqid: np.ndarray              # (P,) int32
    post_wpos: np.ndarray               # (P,) int32
    post_wend: np.ndarray               # (P,) int32

    # L2 intervals sorted by (seqid, wpos, wend); frequent hashes
    # dropped. Rows carry the hash's RANK (its position in uniq_hashes);
    # rank order == hash order.
    mi_rank: np.ndarray                 # (M,) int32, < len(uniq_hashes)
    mi_seqid: np.ndarray                # (M,) int32
    mi_wpos: np.ndarray                 # (M,) int32
    mi_wend: np.ndarray                 # (M,) int32
    mi_strand: np.ndarray               # (M,) int8

    # frequent-seed filtering (winSketch.hpp:410-509)
    freq_threshold: int                 # in interval *points* (2x intervals)
    is_frequent: np.ndarray             # (U,) bool

    kmer_size: int = 19
    window_size: int = 5000             # == segLength
    sketch_size: int = 0

    @property
    def n_contigs(self) -> int:
        return len(self.names)

    @property
    def mi_hash(self) -> np.ndarray:
        """u64 hashes of the interval rows (derived; rows store ranks)."""
        return self.uniq_hashes[self.mi_rank]

    def is_freq_seed(self, hashes: np.ndarray) -> np.ndarray:
        """Vectorized ``Sketch::isFreqSeed`` (winSketch.hpp:506-509)."""
        idx = np.searchsorted(self.uniq_hashes, hashes)
        idx = np.minimum(idx, len(self.uniq_hashes) - 1)
        found = (len(self.uniq_hashes) > 0) & \
            (self.uniq_hashes[idx] == hashes)
        return found & self.is_frequent[idx]

    @classmethod
    def from_numpy(cls, arrays) -> "ReferenceIndex":
        """An index from its arrays: a mapping with the field names (or
        the npz keys, whose build parameters sit in ``meta``), e.g. the
        fields of an index built by the JAX package."""
        if "meta" in arrays:
            k, w, s = (int(x) for x in arrays["meta"])
        else:
            k, w, s = (int(arrays[f]) for f in
                       ("kmer_size", "window_size", "sketch_size"))
        return cls(
            names=[str(x) for x in arrays["names"]],
            freq_threshold=int(arrays["freq_threshold"]),
            kmer_size=k, window_size=w, sketch_size=s,
            **{f: np.asarray(arrays[f]) for f in _NPZ_FIELDS})

    # --- persistence (reference --saveIndex/--loadIndex; the same npz
    #     layout as the JAX package, so either reads the other's) ---
    def save(self, path: str) -> None:
        import os
        final = path if path.endswith(".npz") else path + ".npz"
        tmp = final + ".tmp.npz"    # .npz suffix => savez writes it as-is
        np.savez_compressed(
            tmp, names=np.array(self.names),
            freq_threshold=np.int64(self.freq_threshold),
            meta=np.array([self.kmer_size, self.window_size,
                           self.sketch_size], np.int64),
            **{f: getattr(self, f) for f in _NPZ_FIELDS})
        os.replace(tmp, final)

    @classmethod
    def load(cls, path: str) -> "ReferenceIndex":
        with np.load(path, allow_pickle=False) as z:
            return cls.from_numpy({f: z[f] for f in z.files})


def _freq_threshold(sizes: np.ndarray, kmer_pct_threshold: float) -> int:
    """Frequency cutoff from the histogram of posting sizes.

    Reference: winSketch.hpp:410-453 (computeFreqHist). ``sizes`` are in
    IntervalPoints (2 per coalesced interval).
    """
    if len(sizes) == 0:
        return np.iinfo(np.int64).max
    total_unique = len(sizes)
    to_ignore = int(total_unique * kmer_pct_threshold / 100.0)
    vals, counts = np.unique(sizes, return_counts=True)
    freq_threshold = np.iinfo(np.int64).max
    acc = 0
    for v, c in zip(vals[::-1], counts[::-1]):
        acc += int(c)
        if acc < to_ignore:
            freq_threshold = int(v)
        elif acc == to_ignore:
            freq_threshold = int(v)
            break
        else:
            break
    return freq_threshold


def build_index(
    contigs: Iterable[Tuple[str, str]],
    kmer_size: int,
    window_size: int,
    sketch_size: int,
    kmer_pct_threshold: float = 0.001,
    threads: int = 1,
    device=None,
    rank_limit: int = DEFAULT_RANK_LIMIT,
) -> ReferenceIndex:
    """Build the reference index from (name, sequence) pairs.

    Mirrors Sketch::build + Sketch::index + freq-seed computation
    (winSketch.hpp:122-509): contigs shorter than the window contribute
    nothing; metadata records every contig.

    Contigs are processed in groups of at most ``rank_limit`` k-mer
    positions; each group rank-reduces into its own int32 rank domain
    and resolves back to u64 hashes before the global postings merge.
    A single contig with more than ``rank_limit`` positions forms a
    group of its own and takes the host route (``_build_group_host``).
    ``device`` defaults to CUDA (see utils.resolve_device). ``threads``
    (MashMap's ``-t``) is accepted and unused: the classification runs
    on the device, and one worker thread overlaps the host's part.
    """
    device = resolve_device(device)
    GROUP_PHASE_S.clear()
    if not 0 < rank_limit <= 1 << 30:
        raise ValueError(
            f"rank_limit={rank_limit} out of range (must be in (0, 2^30]: "
            f"the event packing shifts group-local int32 ranks)")

    names: List[str] = []
    lengths: List[int] = []
    acc_hash, acc_wb, acc_we, acc_seq = [], [], [], []
    acc_mh, acc_mb, acc_me, acc_ms, acc_mseq = [], [], [], [], []
    acc_mgid: List[int] = []     # owning group of each acc_mh slot array
    group_vals: List[np.ndarray] = []   # per-group sorted surviving u64s

    def consume(resolved):
        results, vals = resolved
        gid = len(group_vals)
        group_vals.append(vals)
        for seq_id, (ph, pb, pe), (mh, mb, me, ms) in results:
            acc_hash.append(ph)
            acc_wb.append(pb)
            acc_we.append(pe)
            acc_seq.append(np.full(len(ph), seq_id, np.int32))
            acc_mh.append(mh)           # SLOTS into group_vals[gid]
            acc_mgid.append(gid)
            acc_mb.append(mb)
            acc_me.append(me)
            acc_ms.append(ms)
            acc_mseq.append(np.full(len(mh), seq_id, np.int32))

    # Depth-2 group pipeline: group N's host part runs on a worker thread
    # while group N+1's device phases run on this one: a device group's
    # wait for its final arrays' copy and their split by contig; the
    # host route's pairing, classification and resolution (numpy's
    # sorts release the interpreter lock). The reference overlaps the
    # same way with its per-contig thread pool (winSketch.hpp:165). The
    # worker launches no device work, so no device memory outlives its
    # group. Results are consumed strictly in group order; a worker's
    # exception re-raises here through its future.
    from concurrent.futures import ThreadPoolExecutor
    pending = None

    def flush_pending():
        nonlocal pending
        if pending is not None:
            fut, pending = pending, None
            with trace.span("build worker-wait"):
                resolved = fut.result()
            consume(resolved)

    def run_group(ex, group, build=_build_group):
        nonlocal pending
        host = build(group, kmer_size, window_size, sketch_size, device)
        flush_pending()
        pending = ex.submit(host)

    with ThreadPoolExecutor(max_workers=1) as ex:
        group: List[Tuple[int, str]] = []
        group_pos = 0
        for seq_id, (name, seq) in enumerate(
                trace.each("build read", contigs)):
            names.append(name)
            lengths.append(len(seq))
            if len(seq) < window_size:
                # never forms a full window => not indexed
                # (commonFunc.hpp:455)
                continue
            n = len(seq) - kmer_size + 1
            if n > rank_limit:
                # over the limit: a group of its own on the host route
                if group:
                    run_group(ex, group)
                    group, group_pos = [], 0
                logger.info("contig %r has %d positions, over the device "
                            "rank limit %d: host route", name, n,
                            rank_limit)
                run_group(ex, [(seq_id, seq)], _build_group_host)
                continue
            if group and group_pos + n > rank_limit:
                run_group(ex, group)
                group, group_pos = [], 0
            group.append((seq_id, seq))
            group_pos += n
        if group:
            run_group(ex, group)
        flush_pending()

    if not names:
        raise ValueError("No sequences indexed!")

    def _cat(parts, dtype):
        return (np.concatenate(parts).astype(dtype) if parts
                else np.empty(0, dtype))

    with trace.span("build tail-concat"):
        ph = _cat(acc_hash, np.uint64)
        pb = _cat(acc_wb, np.int32)
        pe = _cat(acc_we, np.int32)
        pseq = _cat(acc_seq, np.int32)

    # CSR postings sorted by (hash, seqid, wpos): the accumulators hold
    # one hash-ascending run per contig in ascending seq_id, so one
    # stable argsort on the hash reproduces the 3-key order
    with trace.span("build tail-sort"):
        o = np.argsort(ph, kind="stable")
        ph, pb, pe, pseq = ph[o], pb[o], pe[o], pseq[o]

    with trace.span("build tail-ranks"):
        starts, counts = _sorted_groups(ph)
        uniq_hashes = ph[starts]
        post_offsets = np.concatenate(
            (starts, [len(ph)])).astype(np.int64)

        sizes = counts * 2  # IntervalPoints per hash
        freq_threshold = _freq_threshold(sizes, kmer_pct_threshold)
        is_frequent = sizes >= freq_threshold

        # interval rows: group-local slots -> global ranks
        grank = []
        for vals in group_vals:
            gr = np.searchsorted(uniq_hashes, vals).astype(np.int32)
            if len(gr):
                assert np.array_equal(uniq_hashes[gr], vals), \
                    "interval hash missing from postings hash table"
            grank.append(gr)
        mi_rank = (np.concatenate(
            [grank[g][sl] for g, sl in zip(acc_mgid, acc_mh)])
            if acc_mh else np.empty(0, np.int32)).astype(np.int32)
        mi_wpos = _cat(acc_mb, np.int32)
        mi_wend = _cat(acc_me, np.int32)
        mi_strand = _cat(acc_ms, np.int8)
        mi_seqid = _cat(acc_mseq, np.int32)

    # drop frequent seeds from the L2 interval table
    # (winSketch.hpp:497-504)
    with trace.span("build tail-filter"):
        if is_frequent.any():
            keep = ~is_frequent[mi_rank]
            mi_rank, mi_wpos, mi_wend = (mi_rank[keep], mi_wpos[keep],
                                         mi_wend[keep])
            mi_strand, mi_seqid = mi_strand[keep], mi_seqid[keep]

    logger.info(
        "indexed %d contigs: %d minmer windows, %d unique minmers, "
        "freq threshold %s",
        len(names), len(mi_rank), len(uniq_hashes),
        freq_threshold if freq_threshold < np.iinfo(np.int64).max else "inf")

    return ReferenceIndex(
        names=names,
        lengths=np.asarray(lengths, np.int64),
        uniq_hashes=uniq_hashes,
        post_offsets=post_offsets,
        post_seqid=pseq,
        post_wpos=pb.astype(np.int32),
        post_wend=pe.astype(np.int32),
        mi_rank=mi_rank,
        mi_seqid=mi_seqid,
        mi_wpos=mi_wpos,
        mi_wend=mi_wend,
        mi_strand=mi_strand,
        freq_threshold=freq_threshold,
        is_frequent=is_frequent,
        kmer_size=kmer_size,
        window_size=window_size,
        sketch_size=sketch_size,
    )


def _resolve_group_hashes(results, uniq_host):
    """Map one group's rank-domain outputs out of the group-local domain.

    Looks up the group's u64 values only at the DISTINCT ranks that
    survived into postings / minmer rows, in the host route's
    ``uniq_host`` (u64 by rank; device groups resolve on the device,
    ``classify_group``). Returns ``(rows, vals)``: postings hashes are
    resolved to u64, interval-row hashes stay as SLOTS into ``vals``
    (the group's sorted surviving u64 values).
    """
    u64e = np.empty(0, np.uint64)
    i32e = np.empty(0, np.int32)
    flat = np.concatenate([a for _, (ph, _, _), (mh, _, _, _) in results
                           for a in (ph, mh)]) if results else i32e
    if not len(flat):
        return [(sid, (u64e, pb, pe), (i32e, mb, me, ms))
                for sid, (ph, pb, pe), (mh, mb, me, ms) in results], u64e
    seen = np.zeros(int(flat.max()) + 1, bool)
    seen[flat] = True
    uniq_r = np.flatnonzero(seen)
    slot = np.cumsum(seen, dtype=np.int32) - 1
    vals = uniq_host[uniq_r]
    out = []
    for seq_id, (ph, pb, pe), (mh, mb, me, ms) in results:
        ph_u = vals[slot[ph]] if len(ph) else u64e
        mh_s = slot[mh] if len(mh) else i32e
        out.append((seq_id, (ph_u, pb, pe), (mh_s, mb, me, ms)))
    return out, vals


def _sort_rows(mh, mb, me, ms):
    """Stable (wpos, wend) row sort; stability keeps same-(wb, we) rows
    of different hashes in emission order."""
    o = np.argsort((mb.astype(np.uint64) << np.uint64(32))
                   | me.astype(np.uint64), kind="stable")
    return mh[o], mb[o], me[o], ms[o]


_CLASSIFY_FAULTS = ("end event for unknown hash",
                    "begin/end events must alternate per hash",
                    "interval hash with no occurrence event at or before "
                    "its begin")


def _count(idx: torch.Tensor, n: int) -> torch.Tensor:
    """bincount(idx, minlength=n), idx < n, with no host sync."""
    out = torch.zeros(n, dtype=torch.int64, device=idx.device)
    return out.index_add_(0, idx, torch.ones_like(idx))


def _first_of_runs(*keys) -> torch.Tensor:
    """Mask of the elements that start a run of equal ``keys`` tuples."""
    m = torch.ones(keys[0].shape[0], dtype=torch.bool,
                   device=keys[0].device)
    if m.shape[0] > 1:
        m[1:] = torch.stack([k[1:] != k[:-1] for k in keys]).any(0)
    return m


def gather_lanes(chunks, device):
    """The live lanes of a group's events_chunk calls, ``chunks`` =
    [(contig index, (beg_h, beg_W, end_h, end_W, mem_rankstrand,
    mem_pos))], as one tensor a lane, each pair of lanes with the contig
    index of its elements: (beg contig, beg_h, beg_W, end contig, end_h,
    end_W, mem contig, mem_rankstrand, mem_pos)."""
    out = []
    for j in (0, 2, 4):
        cnt = [x[j].shape[0] for _, x in chunks]
        out.append(torch.repeat_interleave(
            torch.tensor([i for i, _ in chunks], dtype=torch.int32,
                         device=device),
            torch.tensor(cnt, dtype=torch.int64, device=device),
            output_size=sum(cnt)))
        for lane in (j, j + 1):
            out.append(torch.cat([x[lane] for _, x in chunks]) if chunks
                       else torch.empty(0, dtype=torch.int32,
                                        device=device))
    return tuple(out)


def classify_group(lanes, ns, span: int, window_size: int,
                   lut: torch.Tensor) -> torch.Tensor:
    """A device group's membership events to its index arrays, on the
    device: the NumPy chain ``_pair_begin_end`` -> ``strand_classify``
    -> ``_chunk_long_intervals`` -> ``_sort_rows`` ->
    ``_resolve_group_hashes`` of every contig at once, with the contig
    in the keys.

    ``lanes``: ``gather_lanes``'s; ``ns``: the positions of each contig
    of the group, in order; ``lut``: the group's u64 values (int64 bits)
    by rank. A contig's offset in the group is the sum of the positions
    before it, so an offset plus a window index stays below the group's
    positions (at most 2^30) and ranks below 2^30: (rank, offset + W)
    packs into 60 bits. Group-wide orders keep each contig's own order
    as a subsequence: intervals in (rank, contig, W) order; rows emitted
    as plain intervals, split segments, final segments, then the chunks
    of the long ones; one stable (contig, wb, we) sort.

    Returns the tensors that ``split_group`` reads on the host: a fault
    word, per-contig postings and row counts, the group's sorted
    surviving u64 values, the postings (u64, wb, we) and the rows (slot
    into the values, wb, we, strand), contig-major.
    """
    dev = lut.device
    i64 = torch.int64
    C = len(ns)
    n_c = torch.tensor(ns, dtype=i64, device=dev)
    off_c = torch.cumsum(n_c, 0) - n_c
    fb = max(ns).bit_length()      # every W, wb, we and F below < 2^fb
    M30 = (1 << 30) - 1
    bo, bh, bw, eo, eh, ew, mo, mrk, mpos = lanes
    # (each array is dropped once used, so the classify's working set
    # fits in blocks the build's earlier phases reserved)

    def by_rank_then_place(c, h, w):
        """Events sorted by (rank, contig, W): rank, contig, W and the
        (rank, contig) key, rank << 30 | contig offset."""
        key, o = torch.sort((h.to(i64) << 30) | (off_c[c.long()] + w))
        c = c[o].long()
        off = off_c[c]
        return key >> 30, c, (key & M30) - off, (key >> 30 << 30) | off

    # --- pairing: the j-th begin of each (rank, contig) with its j-th
    # end, unmatched begins flushed at the contig's n
    iv_rank, iv_c, iv_wb, gk = by_rank_then_place(bo, bh, bw)
    _, _, e_w, egk = by_rank_then_place(eo, eh, ew)
    B, E = iv_rank.shape[0], e_w.shape[0]
    newg = _first_of_runs(gk)
    iv_g = torch.cumsum(newg, 0) - 1          # dense (rank, contig) id
    starts = torch.nonzero(newg).squeeze(1)
    ukey = gk[starts]
    G = starts.shape[0]
    del newg, gk
    if G == 0:
        if E:
            raise AssertionError(_CLASSIFY_FAULTS[0])
        e = torch.empty(0, dtype=i64, device=dev)
        e32 = e.int()
        return (torch.zeros((), dtype=i64, device=dev),
                torch.zeros(2 * C, dtype=i64, device=dev), e, e, e32, e32,
                e32, e32, e32, e32.to(torch.int8))

    def group_of(key):
        """Dense id of each (rank, contig) key, and whether a begin
        group has it."""
        g = torch.searchsorted(ukey, key).clamp_(max=G - 1)
        return g, ukey[g] == key

    e_g, known = group_of(egk)
    del egk
    faults = (~known).any().long()
    e_cnt = _count(e_g, G)
    slack = torch.diff(starts, append=starts.new_tensor([B])) - e_cnt
    faults |= ((slack < 0) | (slack > 1)).any().long() << 1
    j = torch.arange(B, device=dev) - starts[iv_g]
    e_at = (torch.cumsum(e_cnt, 0) - e_cnt)[iv_g] + j
    iv_we = torch.where(j < e_cnt[iv_g],
                        torch.cat([e_w, e_w.new_zeros(1)])[
                            e_at.clamp_(max=E)],
                        n_c[iv_c])
    del e_g, known, e_cnt, slack, j, e_at, e_w, starts

    # --- strand votes: enter (t = 1) and leave (t = 0) events of the
    # member occurrences of begin groups, in (g, F, t, d) order
    m_g, hit = group_of(((mrk.to(i64) >> 1) << 30) | off_c[mo.long()])
    m_g = m_g[hit]
    up = (mrk[hit] & 1).to(i64)
    f = mpos[hit].to(i64) + 1
    leave = f < n_c[mo[hit].long()] - span + 1
    sh = fb + 2
    ev = torch.sort(torch.cat([
        (m_g << sh) | (f << 2) | 2 | up,
        (m_g[leave] << sh) | ((f[leave] + span) << 2) | (1 - up[leave]),
    ])).values
    del m_g, hit, up, f, leave
    if ev.shape[0] == 0:
        raise AssertionError(_CLASSIFY_FAULTS[2])
    ev_g = ev >> sh
    d = (ev & 1) * 2 - 1
    ev_w = (((ev >> 2) & ((1 << fb) - 1)) - span).clamp_(min=0)
    ev_key = (ev_g << (fb + 1)) | (ev_w << 1) | ((ev >> 1) & 1)
    del ev
    # each group's running vote: the global cumsum less its value
    # before the group's first event
    excl = torch.cumsum(d, 0) - d
    v_before = excl - excl[torch.searchsorted(ev_g, ev_g)]
    v_after = v_before + d
    del excl, d
    cc = (v_before < 0) != (v_after < 0)

    # each interval's events: W in [wb + 1, we); the event before them
    # is its group's last at or before wb
    gpart = iv_g << (fb + 1)
    lo = torch.searchsorted(ev_key, gpart + (iv_wb + 1) * 2)
    hi = torch.searchsorted(ev_key, gpart + iv_we * 2)
    i0 = (lo - 1).clamp_(min=0)
    faults |= ((lo == 0) | (ev_g[i0] != iv_g)).any().long() << 2
    v0 = v_after[i0]
    del gpart, ev_key, ev_g, i0, iv_g
    cc_cum = torch.cat([cc.new_zeros(1, dtype=i64), torch.cumsum(cc, 0)])
    plain = cc_cum[hi] == cc_cum[lo]
    del cc_cum

    # --- sign-class splits: the class changes inside flagged intervals
    # (ranges are disjoint and ascending: an event's interval is the
    # last whose range starts at or before it)
    e = torch.nonzero(cc).squeeze(1)
    own = torch.searchsorted(lo, e, right=True) - 1
    inside = own >= 0
    own.clamp_(min=0)
    inside &= e < hi[own]
    r_iv, e = own[inside], e[inside]
    del cc, own, inside, lo
    r_t, r_vb = ev_w[e], v_before[e]
    first = _first_of_runs(r_iv, r_t)
    r_iv, r_t, r_vb = r_iv[first], r_t[first], r_vb[first]
    lead = _first_of_runs(r_iv)
    seg_b = torch.where(lead, iv_wb[r_iv], torch.roll(r_t, 1))
    last = torch.roll(lead, -1)
    lb_iv, lb_t = r_iv[last], r_t[last]
    v_fin = v_after[hi[lb_iv] - 1]
    keep = iv_we[lb_iv] > lb_t
    fin = lb_iv[keep]
    pl = torch.nonzero(plain).squeeze(1)
    src = torch.cat([pl, r_iv, fin])          # each row's interval
    r_wb = torch.cat([iv_wb[pl], seg_b, lb_t[keep]])
    r_we = torch.cat([iv_we[pl], r_t, iv_we[fin]])
    neg = torch.cat([v0[pl] < 0, r_vb < 0, v_fin[keep] < 0])
    del ev_w, v_before, v_after, e, first, lead, seg_b, last, lb_iv, lb_t
    del v_fin, keep, fin, pl, r_iv, r_t, r_vb, v0, hi, plain

    # --- intervals longer than the window in window-size chunks, after
    # the rest
    long = (r_we - r_wb) > window_size
    if bool(long.any()):
        kp = torch.nonzero(~long).squeeze(1)
        ln = torch.nonzero(long).squeeze(1)
        n_ch = (r_we[ln] - r_wb[ln] + window_size - 1) // window_size
        tot = int(n_ch.sum())
        rep = torch.repeat_interleave(ln, n_ch, output_size=tot)
        local = torch.arange(tot, device=dev) - torch.repeat_interleave(
            torch.cumsum(n_ch, 0) - n_ch, n_ch, output_size=tot)
        cb = r_wb[rep] + local * window_size
        ce = torch.minimum(cb + window_size, r_we[rep])
        src = torch.cat([src[kp], src[rep]])
        neg = torch.cat([neg[kp], neg[rep]])
        r_wb = torch.cat([r_wb[kp], cb])
        r_we = torch.cat([r_we[kp], ce])
        del kp, ln, n_ch, rep, local, cb, ce
    del long

    # --- rows in stable (contig, wb, we) order: offset + wb < 2^30 and
    # we <= n <= 2^30
    r_c = iv_c[src]
    o = torch.sort(((off_c[r_c] + r_wb) << 31) | r_we, stable=True)[1]
    src, r_wb, r_we, neg, r_c = src[o], r_wb[o], r_we[o], neg[o], r_c[o]

    # --- u64 values of the surviving ranks (iv_rank is sorted; rows
    # keep a subset of them); postings contig-major in (rank, W) order
    uniq = torch.unique_consecutive(iv_rank)
    slot = torch.searchsorted(uniq, iv_rank[src])
    po = torch.sort(iv_c, stable=True)[1]
    return (faults, torch.cat([_count(iv_c, C), _count(r_c, C)]),
            lut[uniq], lut[iv_rank[po]], iv_wb[po].int(), iv_we[po].int(),
            slot.int(), r_wb.int(), r_we.int(),
            torch.where(neg, -1, 1).to(torch.int8))


def split_group(arrays, seq_ids):
    """What ``_resolve_group_hashes`` returns, from ``classify_group``'s
    arrays on the host: ([(seq_id, (postings u64, wb, we), (row slots,
    wb, we, strand))] for the group's contigs ``seq_ids``, the group's
    sorted surviving u64 values)."""
    faults, counts, vals, ph, pb, pe, slot, r_wb, r_we, strand = arrays
    f = int(faults)
    if f:
        raise AssertionError("; ".join(
            m for k, m in enumerate(_CLASSIFY_FAULTS) if f >> k & 1))
    C = len(seq_ids)
    p_at = np.concatenate(([0], np.cumsum(counts[:C])))
    r_at = np.concatenate(([0], np.cumsum(counts[C:])))
    ph = ph.view(np.uint64)
    out = []
    for k, seq_id in enumerate(seq_ids):
        p = slice(p_at[k], p_at[k + 1])
        r = slice(r_at[k], r_at[k + 1])
        out.append((seq_id, (ph[p], pb[p], pe[p]),
                    (slot[r], r_wb[r], r_we[r], strand[r])))
    return out, vals.view(np.uint64)


def _pad_to(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    if x.shape[0] >= n:
        return x[:n]
    return torch.cat([x, torch.full((n - x.shape[0],), fill, dtype=x.dtype,
                                    device=x.device)])


def _hash_slabs(seq_u8: np.ndarray, k: int, device):
    """Yield (u64 hashes with UMAX where invalid, strand) of one contig
    as device int64 / int8, slab by slab. Slabs bound the hashing
    temporaries; only the contig's first k-1 bases are exempt from the
    N rule (the tail rule on the first slab, the full-window rule on
    the others)."""
    n = len(seq_u8) - k + 1
    seq = torch.from_numpy(seq_u8).to(device)
    for lo in range(0, n, _slab_step(k)):
        hi = min(lo + _slab_step(k), n)
        ch, cs, cp, has_n, has_n_tail = kmers.canonical_kmer_hashes(
            seq[lo:hi + k - 1], k)
        bad = cp | (has_n_tail if lo == 0 else has_n)
        yield torch.where(bad, UMAX, ch), cs


def _hash_contig(seq_u8: np.ndarray, k: int, device):
    """Rank-domain inputs of one contig on the device (see _hash_slabs)."""
    hs, ss = zip(*_hash_slabs(seq_u8, k, device))
    return torch.cat(hs), torch.cat(ss)


def _contig_events(rv, sv, th, n: int, n_w: int, s: int, span: int):
    """events_chunk arguments of one contig: [(args, caps)], one whole
    chunk up to _EVENTS_CH_MAX positions, else position chunks with an
    s_b halo on each side."""
    if n <= _EVENTS_CH_MAX:
        parts = [(rv, sv, _pad_to(th, n, RSENT), 0, 0, n)]
        chp = n
    else:
        chp = _EVENTS_CH_MAX + 2 * span
        th_full = _pad_to(th, n, RSENT)
        parts = []
        for c0 in range(0, n, _EVENTS_CH_MAX):
            a0 = max(0, c0 - span)
            parts.append((_pad_to(rv[a0:], chp, RSENT),
                          _pad_to(sv[a0:], chp, 0),
                          _pad_to(th_full[a0:], chp, RSENT),
                          a0, c0 - a0, min(_EVENTS_CH_MAX, n - c0)))
    caps = events_mod.events_caps(chp, s, span)
    return [(p, caps) for p in parts]


def _build_group(group: List[Tuple[int, str]], kmer_size: int,
                 window_size: int, sketch_size: int, device):
    """Index-build pipeline for one contig group.

    Device, here: hashing -> LOCAL rank reduction -> theta -> membership
    events (their counts alone come to the host) -> pairing, strand
    classification, chunking, row sort and rank -> u64 resolution
    (``classify_group``), then one device->host copy of the group's
    final arrays, started here. The returned closure waits for that copy
    and splits it by contig (build_index runs it on its worker thread
    while the next group's device phases run); it returns (per-contig
    rows in ascending seq_id, the group's u64 values).
    """
    span = window_size - kmer_size + 1
    mark = _group_clock(group)
    hm, st, spans = [], [], []
    off = 0
    for seq_id, seq in group:
        seq_u8 = kmers.sanitize(seq.encode("ascii"))
        h, s_ = _hash_contig(seq_u8, kmer_size, device)
        hm.append(h)
        st.append(s_)
        spans.append((seq_id, off, h.shape[0]))
        off += h.shape[0]
    mark("hash-dispatch")
    ranks, lut = winnow._rank_reduce(torch.cat(hm))
    st = torch.cat(st)
    del hm
    rank_views = [ranks[a:a + n] for _, a, n in spans]
    thetas = winnow.theta_scan_ranks(rank_views, sketch_size, span)
    mark("rank+theta")

    calls = []                     # (contig index, args, caps)
    for i, (seq_id, a, n) in enumerate(spans):
        n_w = n - span + 1
        if thetas[i] is None or n_w <= 0:
            continue
        for args, caps in _contig_events(rank_views[i], st[a:a + n],
                                         thetas[i], n, n_w, sketch_size,
                                         span):
            calls.append((i, args, caps))

    def run(i, args, caps):
        rv, sv, th, a0, base, n_local = args
        n = spans[i][2]
        return events_mod.events_chunk(
            rv, sv, th, a0, base, n_local, n, n - span + 1, span, *caps)

    bufs = [run(*c) for c in calls]
    # the chunks' counts alone come to the host: they size the live lanes
    heads = (torch.stack([b[-4:] for b in bufs]).cpu().numpy() if bufs
             else np.empty((0, 4), np.int32))
    chunks = []                    # (contig index, live lanes)
    for k, (i, args, caps) in enumerate(calls):
        b, head = bufs[k], heads[k]
        while not events_mod.counts_fit(head, *caps):
            # cap overflow (a heavily repetitive contig): rerun on the
            # device with doubled caps; the output is the same
            caps = (2 * caps[0], 2 * caps[1])
            logger.info("contig %d overflowed the event caps; rerun "
                        "with caps %s", spans[i][0], caps)
            b = run(i, args, caps)
            head = b[-4:].cpu().numpy()
        chunks.append((i, events_mod.live_lanes(b, head, *caps)))
    n_classified = len({i for i, _ in chunks})
    # nothing but the LUT and the live lanes outlives the events
    del st, ranks, rank_views, thetas, calls, bufs
    mark("events+fetch")

    with trace.span("build classify"):
        lanes = gather_lanes(chunks, device)
        del chunks
        fetch = HostCopy(classify_group(
            lanes, [n for _, _, n in spans], span, window_size, lut))
        del lanes, lut
    mark("classify", keep=False)
    trace.add("build classify contigs", 0.0, n_classified)
    seq_ids = [seq_id for seq_id, _, _ in spans]

    def fetch_and_split():
        m = _group_clock(group)
        host = fetch.wait()
        m("host-classify")
        out = split_group(host, seq_ids)
        m("resolve-u64")
        return out

    return fetch_and_split


def _group_clock(group):
    """mark(label): the host seconds since the previous mark (or since
    this call), as a phase of the group that starts at contig
    ``group[0]``, go into ``GROUP_PHASE_S`` and a DEBUG line; a span
    ``build <label>`` while recording (trace.py)."""
    gid = group[0][0]
    phases = GROUP_PHASE_S.setdefault(gid, {})

    def sink(label, seconds):
        phases[label] = seconds
        logger.debug("group %d phase %-14s %.4fs", gid, label, seconds)
    return trace.clock("build ", sink)


def _build_group_host(group: List[Tuple[int, str]], kmer_size: int,
                      window_size: int, sketch_size: int, device):
    """Index-build pipeline for a group whose contig is over the rank
    limit (the JAX build's host route, ``_build_group`` with its hashes
    streamed to the host).

    Device: hashing, slab by slab, each slab copied to the host; then
    theta over the host ranks (the theta kernel on a card). Host: the
    rank reduction (``winnow.rank_reduce_host``) and the membership
    events (``contig_minmer_intervals``) in place of the events kernel,
    whose packing needs ranks below 2^30. Returns what ``_build_group``
    returns: a closure that runs the membership events and what follows
    them.
    """
    span = window_size - kmer_size + 1
    mark = _group_clock(group)
    contig_hv, strands = [], []
    for _, seq in group:
        seq_u8 = kmers.sanitize(seq.encode("ascii"))
        hs, ss = [], []
        for h, s_ in _hash_slabs(seq_u8, kmer_size, device):
            hs.append(h.cpu().numpy().view(np.uint64))
            ss.append(s_.cpu().numpy())
        h = np.concatenate(hs)
        contig_hv.append((h, h != winnow.SENTINEL))
        strands.append(np.concatenate(ss))
    mark("hash-dispatch")
    rank_list, uniq = winnow.rank_reduce_host(contig_hv)
    del contig_hv
    thetas = winnow.theta_scan_ranks(
        [torch.from_numpy(r).to(device) for r in rank_list], sketch_size,
        span)
    thetas = [None if t is None else t.cpu().numpy() for t in thetas]
    mark("rank+theta")

    def one_contig(i):
        r, theta = rank_list[i], thetas[i]
        (ph, pb, pe), (mh, mb, me, ms) = contig_minmer_intervals(
            r, r != RSENT, strands[i], theta, span, n_flush=len(r),
            sent=RSENT)
        mh, mb, me, ms = _chunk_long_intervals(mh, mb, me, ms, window_size)
        return group[i][0], (ph, pb, pe), _sort_rows(mh, mb, me, ms)

    def classify_and_resolve():
        m = _group_clock(group)
        results = [one_contig(i) for i, t in enumerate(thetas)
                   if t is not None]
        m("host-classify")
        out = _resolve_group_hashes(results, uniq)
        m("resolve-u64")
        return out

    return classify_and_resolve
