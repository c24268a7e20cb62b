"""Device-side mapping pipeline: L1 candidates and L2 plateau runs.

Counterpart of ``mashmap_tpu/kernels/mapdev.py``. Two steps replace the
reference's per-thread mapping loop (computeMap.hpp:755-1451):

``l1_step``: for a (B, L) batch of query fragments —
  sketch (bottom-s minhash) -> CSR lookup (searchsorted) -> postings
  gather -> interval-endpoint sort -> prefix-sum sweep -> candidate-run
  extraction + clustering. Rows whose postings or candidates exceed the
  caps are flagged for the host route. Small outputs pack into one
  (B, 4+7C) int32 buffer (one device->host copy).

``l2_step``: for a (W,) batch of L1 candidates —
  gather the candidate's minmer-interval slice, merge insertions and
  expiries into one event stream (one sort), recover the SlideMapper
  state at every snapshot via signed one-hot prefix sums (see map/l2.py
  for the derivation), and extract the optimal-plateau runs. Returns a
  small packed run buffer.

u64 hashes are int64 bits; ordered lookups go through ``flip`` so that
signed order is u64 order. Prefix sums are exact int32 ``cumsum``s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .murmur import UMAX, flip
from .sketch import sketch_fragments

KEY_PAD = int(np.iinfo(np.int64).max)
I32MAX = int(np.iinfo(np.int32).max)
L2_RUN_CAP = 16


class L1Config(NamedTuple):
    k: int
    s: int                 # param sketch size
    seg_length: int
    p_cap: int = 512       # max gathered intervals per fragment
    c_cap: int = 16        # max candidate regions per fragment
    t_cap: int = 512       # max L2 entries per candidate
    table_scale: float = 1.0
    n_groups: int = 1      # reference prefix groups (skip_prefix)


def _sort_payloads(key: torch.Tensor, *payloads):
    """Stable sort along the last axis by ``key``, carrying payloads."""
    skey, perm = torch.sort(key, dim=-1, stable=True)
    return (skey,) + tuple(torch.gather(p, -1, perm) for p in payloads)


def _prev_col(x: torch.Tensor, fill) -> torch.Tensor:
    """x shifted right by one column, ``fill`` in column 0."""
    head = torch.full_like(x[:, :1], fill)
    return torch.cat([head, x[:, :-1]], dim=1)


def _next_col(x: torch.Tensor, fill) -> torch.Tensor:
    tail = torch.full_like(x[:, :1], fill)
    return torch.cat([x[:, 1:], tail], dim=1)


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, [1]), dim=1).values, [1])


def sweep_and_candidates(g_seq, g_wp, g_we, valid_j, s_q, min_hits,
                         ref_group, cutoff_table, cfg: L1Config):
    """Interval-endpoint sweep + candidate clustering over gathered
    postings (computeL1CandidateRegions, computeMap.hpp:915-1116).

    Args:
      g_seq/g_wp/g_we: (B, P) int32 gathered interval points (zero where
        ~valid_j).
      s_q: (B,) post-filter sketch sizes; min_hits: (B,) int32.

    Returns (c_seq, c_first, c_last, c_inter, n_cand, overflow_c).
    """
    B, P = g_seq.shape
    dev = g_seq.device
    i64 = torch.int64
    # key = seqid << 33 | pos << 1 | side  (CLOSE=0 sorts before OPEN=1)
    k_open = (g_seq.to(i64) << 33) | (g_wp.to(i64) << 1) | 1
    k_close = (g_seq.to(i64) << 33) | (g_we.to(i64) << 1)
    keys = torch.cat([torch.where(valid_j, k_open, KEY_PAD),
                      torch.where(valid_j, k_close, KEY_PAD)], dim=1)
    keys = torch.sort(keys, dim=1).values
    ev_valid = keys != KEY_PAD
    side = torch.where((keys & 1) == 1, 1, -1)
    overlap = torch.cumsum(torch.where(ev_valid, side, 0), dim=1,
                           dtype=torch.int32)
    ev_pos = ((keys >> 1) & ((1 << 32) - 1)).to(torch.int32)
    ev_seq = (keys >> 33).to(torch.int32)

    grp = keys >> 1   # (seqid, pos)
    last_of_pos = ev_valid & (grp != _next_col(grp, KEY_PAD))

    # stage-1 gate + hypergeometric cutoff, PER reference prefix group
    # (computeL1CandidateRegions runs per group, computeMap.hpp:1146-1165)
    NG = cfg.n_groups
    nref = ref_group.shape[0]
    ev_grp = ref_group[torch.clamp(ev_seq, 0, nref - 1).long()]
    tgt = torch.where(last_of_pos, ev_grp.long(), NG)
    best_g = torch.zeros((B, NG + 1), dtype=torch.int32, device=dev)
    best_g.scatter_reduce_(1, tgt, overlap, "amax")
    best_g = torch.minimum(best_g[:, :NG], s_q[:, None])
    ci = (best_g.to(torch.float64)
          / max(1.0, cfg.table_scale)).to(torch.int32)
    ci = torch.clamp(ci, 0, cutoff_table.shape[0] - 1).long()
    min_hits2_g = torch.maximum(cutoff_table[ci], min_hits[:, None])
    has_any_g = best_g >= min_hits[:, None]

    # dense per-(seq,pos) group rows: compact the group-last columns
    G = keys.shape[1]
    grank = torch.cumsum(last_of_pos.to(torch.int32), dim=1) - 1
    gkey = torch.where(last_of_pos, grank, G)
    zero = 0
    _, gp, gs, go = _sort_payloads(
        gkey,
        torch.where(last_of_pos, ev_pos, zero),
        torch.where(last_of_pos, ev_seq, zero),
        torch.where(last_of_pos, overlap, zero))

    n_grp = last_of_pos.sum(dim=1)
    gi = torch.arange(G, device=dev)[None, :]
    g_valid = gi < n_grp[:, None]

    gg = ref_group[torch.clamp(gs, 0, nref - 1).long()].long()
    mh2 = torch.gather(min_hits2_g, 1, gg)
    ha = torch.gather(has_any_g, 1, gg)
    m = g_valid & (go >= mh2) & ha
    run_start = m & (~_prev_col(m, False) | (gs != _prev_col(gs, -1)))
    rid = torch.cumsum(run_start.to(torch.int32), dim=1) - 1

    # segment reductions as packed (id << 32 | value) running maxima
    M32 = (1 << 32) - 1

    def latch(ids, vals, mask):
        packed = torch.where(mask, (ids.to(i64) << 32) | vals.to(i64), -1)
        return torch.cummax(packed, dim=1).values

    run_gp = latch(rid, gp, m)
    run_gs = latch(rid, gs, m)
    prev_packed_gp = _prev_col(run_gp, -1)
    prev_packed_gs = _prev_col(run_gs, -1)
    has_prev = prev_packed_gp >= 0
    pr_last = torch.where(has_prev, (prev_packed_gp & M32).to(torch.int32),
                          -(10 ** 9))
    pr_seq = torch.where(has_prev, (prev_packed_gs & M32).to(torch.int32),
                         -1)

    # cluster start decision at each run start (run r vs run r-1)
    cl_new = run_start & ((gs != pr_seq)
                          | (gp > pr_last + cfg.seg_length))
    cid = torch.cumsum(cl_new.to(torch.int32), dim=1) - 1

    cl_first = latch(cid, gp, cl_new)
    cl_go = latch(cid, go, m)

    BIGI = I32MAX
    arr = torch.where(m, cid, BIGI)
    nxt_cid = _next_col(_rev_cummin(arr), BIGI)
    cl_last = m & (nxt_cid != cid)

    C = cfg.c_cap
    ckey = torch.where(cl_last, cid, G)
    _, c_first, c_last, c_inter, c_seq = _sort_payloads(
        ckey,
        torch.where(cl_last, (cl_first & M32).to(torch.int32), BIGI),
        torch.where(cl_last, gp, -1),
        torch.where(cl_last, (cl_go & M32).to(torch.int32), zero),
        torch.where(cl_last, gs, zero))
    c_first, c_last = c_first[:, :C], c_last[:, :C]
    c_inter, c_seq = c_inter[:, :C], c_seq[:, :C]
    if c_first.shape[1] < C:         # fewer event columns than C
        pad = C - c_first.shape[1]

        def padc(x, fill):
            return torch.cat([x, torch.full((B, pad), fill, dtype=x.dtype,
                                            device=dev)], dim=1)
        c_first, c_last = padc(c_first, BIGI), padc(c_last, -1)
        c_inter, c_seq = padc(c_inter, 0), padc(c_seq, 0)

    n_cand = torch.where(m, cid, -1).amax(dim=1) + 1
    overflow_c = n_cand > C
    n_cand = torch.clamp(n_cand, max=C)
    return c_seq, c_first, c_last, c_inter, n_cand, overflow_c


def l2_slice_bounds(mi_key, c_seq, c_first, c_last, seg_length: int):
    """Interval-table slice bounds per L1 candidate.

    ``mi_key`` is the interval table's packed (seqid << 32 | wpos) int64
    key (ascending). Returns (lo, mid, hi) int32 row bounds
    (computeL2MappedRegions's minmerIndex range lookup,
    computeMap.hpp:1283-1294).
    """
    seq64 = c_seq.to(torch.int64) << 32
    lo_k = seq64 | torch.clamp(c_first.to(torch.int64) - seg_length - 1,
                               min=0)
    mid_k = seq64 | torch.clamp(c_first, min=0).to(torch.int64)
    hi_k = seq64 | (c_last.to(torch.int64) + 1)
    allq = torch.stack([lo_k, mid_k, hi_k])
    c = torch.searchsorted(mi_key, allq.reshape(-1)).reshape(
        allq.shape).to(torch.int32)
    return c[0], c[1], c[2]


def l1_step(frags, uniq_flip, post_offsets, post_seqid, post_wpos,
            post_wend, is_frequent, min_hits_table, cutoff_table,
            allowed, ref_group, mi_key, cfg: L1Config):
    """Fragment batch -> sketches + L1 candidate regions.

    Args:
      frags: (B, L) uint8 sanitized fragment bytes ('N'-padded).
      uniq_flip: (U,) int64 ``flip`` of the index's sorted unique
        hashes (signed-ascending).
      post_offsets/(post_*)/is_frequent: the index's CSR postings.
      min_hits_table: (s+1,) int32 — estimateMinimumHitsRelaxed per s_q.
      cutoff_table: (ss+1,) int32 hypergeometric cutoffs (or all-ones).
      allowed: (B, n_contigs) bool — per-fragment admissible reference
        sequences (computeMap.hpp:887-894).
      mi_key: (M,) int64 interval-table keys (see l2_slice_bounds).

    Returns (meta (B, 4+7C) int32, codes (B, s) int32, strands (B, s)
    int8); see unpack_l1_meta.
    """
    B = frags.shape[0]
    dev = frags.device
    s = cfg.s
    U = uniq_flip.shape[0]
    P = cfg.p_cap

    q_hash, q_strand, q_cnt, q_cx = sketch_fragments(frags, cfg.k, s)

    # --- frequent-seed filter + compaction (order-preserving) ---
    pos0 = torch.searchsorted(uniq_flip, flip(q_hash))     # (B, s)
    posc = torch.clamp(pos0, max=max(U - 1, 0))
    found = q_hash != UMAX
    if U > 0:
        found &= flip(uniq_flip[posc]) == q_hash
        freq = found & is_frequent[posc]
    else:
        found &= False
        freq = torch.zeros_like(found)
    keep = (q_hash != UMAX) & ~freq
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    # rank-coded sketch for l2: code = (insertion_pos << 1) | found is
    # order-isomorphic to the u64 hashes against every interval-row
    # code (rank << 1) | 1; pad/dropped lanes get I32MAX
    q_code = (pos0.to(torch.int32) << 1) | found.to(torch.int32)
    q_code_c = torch.gather(torch.where(keep, q_code, I32MAX), 1, order)
    q_strand_c = torch.gather(torch.where(keep, q_strand, 0), 1, order)
    s_q = keep.sum(dim=1, dtype=torch.int32)
    min_hits = min_hits_table[s_q.long()]

    # --- postings ranges (only kept+found sketch hashes) ---
    use = keep & found
    po = post_offsets.to(torch.int64)
    start = torch.where(use, po[posc], 0)
    cnt = torch.where(use, po[torch.clamp(posc + 1, max=U)] - start, 0)
    cum = torch.cumsum(cnt, dim=1)
    base = cum - cnt
    total = cum[:, -1]
    overflow_l1 = total > P

    # gather up to P intervals per row: slot[j] = the sketch hash that
    # owns output position j (scatter-max of range starts + cummax fill)
    j = torch.arange(P, device=dev)[None, :]
    z = torch.full((B, P + 1), -1, dtype=torch.int64, device=dev)
    tgt = torch.clamp(torch.where(cnt > 0, base, P), max=P)
    z.scatter_reduce_(1, tgt, torch.arange(s, device=dev).repeat(B, 1),
                      "amax")
    slot = torch.clamp(torch.cummax(z[:, :P], dim=1).values, 0, s - 1)
    src = torch.gather(start, 1, slot) + (j - torch.gather(base, 1, slot))
    valid_j = j < torch.clamp(total, max=P)[:, None]
    srcc = torch.clamp(src, 0, max(post_seqid.shape[0] - 1, 0))
    g_seq = torch.where(valid_j, post_seqid[srcc], 0)
    g_wp = torch.where(valid_j, post_wpos[srcc], 0)
    g_we = torch.where(valid_j, post_wend[srcc], 0)
    adm = torch.gather(allowed, 1, g_seq.long())
    valid_j = valid_j & adm

    (c_seq, c_first, c_last, c_inter, n_cand,
     overflow_c) = sweep_and_candidates(
        g_seq, g_wp, g_we, valid_j, s_q, min_hits, ref_group,
        cutoff_table, cfg)

    c_lo, c_mid, c_hi = l2_slice_bounds(
        mi_key, c_seq, c_first, c_last, cfg.seg_length)

    meta = torch.cat([
        s_q[:, None], n_cand[:, None].to(torch.int32),
        (overflow_l1 | overflow_c).to(torch.int32)[:, None],
        q_cx.to(torch.float32).view(torch.int32)[:, None],
        c_seq, c_first, c_last, c_inter, c_lo, c_mid, c_hi], dim=1)
    return meta, q_code_c, q_strand_c.to(torch.int8)


def unpack_l1_meta(meta: np.ndarray, c_cap: int):
    """Host-side view splitter for l1_step's packed output buffer."""
    C = c_cap
    return {
        "s_q": meta[:, 0],
        "n_cand": meta[:, 1],
        "overflow": meta[:, 2] != 0,
        "complexity": np.ascontiguousarray(
            meta[:, 3:4]).view(np.float32)[:, 0],
        "cand_seq": meta[:, 4:4 + C],
        "cand_start": meta[:, 4 + C:4 + 2 * C],
        "cand_end": meta[:, 4 + 2 * C:4 + 3 * C],
        "cand_inter": meta[:, 4 + 3 * C:4 + 4 * C],
        "cand_lo": meta[:, 4 + 4 * C:4 + 5 * C],
        "cand_mid": meta[:, 4 + 5 * C:4 + 6 * C],
        "cand_hi": meta[:, 4 + 6 * C:4 + 7 * C],
    }


def l2_step(w_lo, w_mid, w_hi, w_seq, q_code, q_strand, s_q,
            mi_rank, mi_wpos, mi_wend, mi_strand, mi_seqid,
            t_cap: int, s: int):
    """Optimal-plateau runs for a batch of L1 candidates.

    Args:
      w_lo/w_mid/w_hi: (W,) int32 interval-table slice bounds per item.
      w_seq: (W,) candidate reference sequence ids.
      q_code/q_strand: (W, s) the owning fragment's compacted sketch as
        int32 rank codes from l1_step ((pos << 1) | found; I32MAX pad).
      s_q: (W,) int32 sketch sizes.
      mi_*: the interval table.

    Returns a packed (W, 3 + 3*L2_RUN_CAP) int32 buffer (unpack_l2_runs).

    The SlideMapper trajectory (slidingMap.hpp:28-212) evaluates, after
    inserting interval entry t (entries ascend by wpos),
        active(t) = {i : i <= t and wend_i > wpos_t}.
    Insertions and expiries merge into one 2T event stream (one sort;
    expiries apply before same-position snapshots; insertions tie-break
    by entry index). Signed one-hot prefix sums over the event axis give
    per-sketch-bucket active counts at every event; the pivot rule
    (rank_b = b+1 + #active non-matching below b <= s_q,
    slidingMap.hpp:158,204) is a prefix sum over the bucket axis.
    Snapshots are read at main-entry insertion events, and plateau runs
    of shared == best are extracted per row (computeMap.hpp:1373-1450).
    """
    W = w_lo.shape[0]
    dev = w_lo.device
    T = t_cap
    E = 2 * T
    M_len = mi_rank.shape[0]
    BIG = I32MAX
    i64 = torch.int64

    i_idx = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    row = w_lo[:, None] + i_idx
    gidx = torch.clamp(row, max=max(M_len - 1, 0)).long()
    e_valid = row < w_hi[:, None]
    hash_a = torch.where(e_valid, (mi_rank[gidx] << 1) | 1, BIG)
    wend_a = torch.where(e_valid, mi_wend[gidx], BIG)
    strand_a = torch.where(e_valid, mi_strand[gidx].to(torch.int32), 0)
    wpos_a = torch.where(e_valid, mi_wpos[gidx], BIG)

    n_setup = (w_mid - w_lo)[:, None]
    t_is_main = (i_idx >= n_setup) & e_valid

    # next-entry wpos (neighbor read, computeMap.hpp:1386-1390)
    nxt_ok = (row + 1) < M_len
    gnext = torch.clamp(row + 1, max=max(M_len - 1, 0)).long()
    same_seq = nxt_ok & (mi_seqid[gnext] == w_seq[:, None])
    next_wpos = torch.where(same_seq, mi_wpos[gnext],
                            torch.where(e_valid, mi_wpos[gidx], BIG))

    # sketch bucket of each entry: compare-all against the sorted sketch
    b = (q_code[:, None, :] < hash_a[:, :, None]).sum(
        dim=-1, dtype=torch.int32)                          # (W, T)
    eqh = (q_code[:, None, :] == hash_a[:, :, None]).any(dim=-1)
    inb = b < s
    match = eqh & e_valid
    non = inb & ~eqh & e_valid

    # event stream: key = (window position * 2 + type) * (T+1) + entry;
    # type 0 = expiry (applies before same-position snapshots)
    span = T + 1
    ii = i_idx.to(i64)
    key_ins = torch.where(e_valid, (wpos_a.to(i64) * 2 + 1) * span + ii,
                          KEY_PAD)
    key_exp = torch.where(e_valid, (wend_a.to(i64) * 2) * span + ii,
                          KEY_PAD)

    def pack(sign_insert: bool):
        pm = t_is_main if sign_insert else torch.zeros_like(t_is_main)
        return ((b << 7) | (match.to(torch.int32) << 6)
                | (non.to(torch.int32) << 5) | (pm.to(torch.int32) << 4)
                | ((strand_a + 1) << 2) | int(sign_insert))

    keys = torch.cat([key_ins, key_exp], dim=1)               # (W, 2T)
    keys, pay, wp_pay, nw_pay = _sort_payloads(
        keys, torch.cat([pack(True), pack(False)], dim=1),
        torch.cat([wpos_a, wpos_a], dim=1),
        torch.cat([next_wpos, next_wpos], dim=1))

    ev_live = keys != KEY_PAD
    ev_b = torch.where(ev_live, pay >> 7, s)
    ev_match = ev_live & (((pay >> 6) & 1) == 1)
    ev_non = ev_live & (((pay >> 5) & 1) == 1)
    ev_main = ev_live & (((pay >> 4) & 1) == 1)
    ev_strand = torch.where(ev_live, ((pay >> 2) & 3) - 1, 0)
    sign = torch.where(ev_live, (pay & 1) * 2 - 1, 0)

    # bucket-dense active counts at every event, (W, s, E), by exact
    # int32 prefix sums over the event axis
    lane = torch.arange(s, dtype=torch.int32, device=dev)[None, :, None]
    onehot = ev_b[:, None, :] == lane
    sgn = sign[:, None, :]
    cnt_m = torch.cumsum(torch.where(onehot & ev_match[:, None, :], sgn, 0),
                         dim=2, dtype=torch.int32)
    cnt_v = torch.cumsum(torch.where(onehot & ev_match[:, None, :],
                                     sgn * ev_strand[:, None, :], 0),
                         dim=2, dtype=torch.int32)
    dn = torch.where(onehot & ev_non[:, None, :], sgn, 0)
    # pivot rule: rank of bucket b = b+1 + #active non-matching entries
    # in buckets <= b (prefix over the bucket axis, then the event axis)
    rank = (torch.arange(1, s + 1, dtype=torch.int32, device=dev)
            [None, :, None]
            + torch.cumsum(torch.cumsum(dn, dim=1, dtype=torch.int32),
                           dim=2, dtype=torch.int32))
    pmask = rank <= s_q[:, None, None]
    shared = torch.where(pmask, cnt_m, 0).sum(dim=1, dtype=torch.int32)
    votes = (torch.where(pmask, cnt_v, 0)
             * q_strand[:, :s, None].to(torch.int32)).sum(
        dim=1, dtype=torch.int32)

    # optimal-plateau runs over snapshot (main-insert) events;
    # non-snapshot events are transparent
    sh_m = torch.where(ev_main, shared, -1)
    best = torch.clamp(sh_m.amax(dim=1), min=1)
    eq = ev_main & (shared == best[:, None])

    m_id = torch.cumsum(ev_main.to(torch.int32), dim=1)     # 1-based
    last_eq = torch.cummax(torch.where(eq, m_id, 0), dim=1).values
    prev_last_eq = _prev_col(last_eq, 0)
    run_start = eq & ~((m_id > 1) & (prev_last_eq == m_id - 1))
    rid = torch.cumsum(run_start.to(torch.int32), dim=1) - 1

    L = L2_RUN_CAP
    col = torch.arange(E, dtype=torch.int32, device=dev)[None].expand(W, E)
    # run compaction by sort: start_w[r] = wpos at run r's first column
    _, start_w = _sort_payloads(torch.where(run_start, rid, L),
                                torch.where(run_start, wp_pay, BIG))
    start_w = start_w[:, :L]
    # tb[r] = run r's last eq column
    arr_r = torch.where(eq, rid, BIG)
    nxt_rid = _next_col(_rev_cummin(arr_r), BIG)
    run_last = eq & (nxt_rid != rid)
    _, tb = _sort_payloads(torch.where(run_last, rid, L),
                           torch.where(run_last, col, -1))
    tb = tb[:, :L]
    n_runs = torch.where(eq, rid, -1).amax(dim=1) + 1
    run_overflow = n_runs > L

    # opt_end of a run ending at snapshot tb: next_wpos of the NEXT
    # snapshot if one exists, else of tb itself
    nm = _rev_cummin(torch.where(ev_main, col, E))
    nm_after = _next_col(nm, E)
    tbc = torch.clamp(tb, 0, E - 1).long()
    nxt_main_col = torch.gather(nm_after, 1, tbc)
    end_col = torch.where(nxt_main_col < E, nxt_main_col, tbc).long()
    opt_end = torch.gather(nw_pay, 1, end_col)
    vote_tb = torch.gather(votes, 1, tbc)

    return torch.cat([
        n_runs[:, None], best[:, None],
        run_overflow.to(torch.int32)[:, None],
        start_w, opt_end, torch.where(vote_tb >= 0, 1, -1).to(torch.int32)],
        dim=1).to(torch.int32)


def unpack_l2_runs(buf: np.ndarray):
    """(n_runs, best, overflow, starts, ends, strands) views of
    l2_step's packed run buffer."""
    L = L2_RUN_CAP
    return (buf[:, 0], buf[:, 1], buf[:, 2] != 0,
            buf[:, 3:3 + L], buf[:, 3 + L:3 + 2 * L],
            buf[:, 3 + 2 * L:3 + 3 * L])
