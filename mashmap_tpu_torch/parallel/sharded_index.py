"""Hash-range-sharded reference index over a process's devices.

Counterpart of ``mashmap_tpu/parallel/sharded_index.py``. The default
run replicates the index on each device (mesh.py). When the index
outgrows one device, this module splits it instead:

- shard d holds one contiguous unique-hash range and its CSR postings;
- and one contiguous, key-aligned row range of the minmer interval
  table, extended by a ``halo`` of the next shard's rows, so that any
  L2 slice of at most ``halo`` rows lies wholly on its owner.

The JAX package runs the L1 lookup under ``shard_map``, with a ``psum``
for the frequent-seed OR and the global insertion position, and an
``all_gather`` of the per-shard postings. Here the shards are a list of
per-device tensors in one process: a ``psum`` is an integer sum and an
``all_gather`` a concatenation in shard order, after explicit
``.to(device)`` copies (no-ops where two shards share a device). No
collective library is involved: processes meet only at barriers
(distributed.py). The packed output equals the replicated ``l1_step``'s
for every row that does not overflow the postings cap.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..hostcopy import to_device
from ..kernels.mapdev import (I32MAX, L1Config, l2_step,
                              sweep_and_candidates)
from ..kernels.murmur import UMAX, flip
from ..kernels.sketch import sketch_fragments

KEY_MAX = int(np.iinfo(np.int64).max)
KEY_MIN = int(np.iinfo(np.int64).min)

# largest L2 slice the device path handles (the engine's top T bucket);
# the interval-table halo must cover it
L2_T_MAX = 8192


@dataclasses.dataclass
class ShardedIndex:
    """Per-shard tensors (lists, entry d on ``devices[d]``) with the JAX
    package's per-shard layout."""
    n_shards: int
    u_shard: int                  # unique hashes per shard (padded)
    p_shard: int                  # postings per shard (padded, pow2)
    devices: List[torch.device]
    uniq: List[torch.Tensor]      # (u_shard,) int64 flip(u64), pads at
    #                               flip(UMAX) (never below a real query)
    offsets: List[torch.Tensor]   # (u_shard+1,) int64 shard-local CSR
    seqid: List[torch.Tensor]     # (p_shard,) int32
    wpos: List[torch.Tensor]      # (p_shard,) int32
    wend: List[torch.Tensor]      # (p_shard,) int32
    frequent: List[torch.Tensor]  # (u_shard,) bool
    # ---- row-range-sharded minmer interval table (L2) ----
    m_shard: int                  # rows per slab (chunk + halo, padded)
    mi_bounds: np.ndarray         # (n+1,) int64 global row range per shard
    mi_row0: List[int]            # global row of each slab's first row
    key_bounds: np.ndarray        # (n+1,) int64 owned key ranges
    mi_rank: List[torch.Tensor]   # (m_shard,) int32
    mi_wpos: List[torch.Tensor]
    mi_wend: List[torch.Tensor]
    mi_strand: List[torch.Tensor]  # int8
    mi_seqid: List[torch.Tensor]   # int32, -1 pads
    mi_key: List[torch.Tensor]     # int64 (seqid << 32 | wpos), KEY_MAX pads

    def shard_bytes(self) -> List[int]:
        """Device bytes each shard holds."""
        cols = (self.uniq, self.offsets, self.seqid, self.wpos, self.wend,
                self.frequent, self.mi_rank, self.mi_wpos, self.mi_wend,
                self.mi_strand, self.mi_seqid, self.mi_key)
        return [sum(c[d].numel() * c[d].element_size() for c in cols)
                for d in range(self.n_shards)]


def build_sharded_index(idx, devices, halo: int = L2_T_MAX) -> ShardedIndex:
    """Split ``idx`` over ``devices`` (one shard per entry; entries may
    repeat) with nothing replicated:

    - CSR postings (L1): contiguous unique-hash ranges;
    - minmer interval table (L2, the reference's ``minmerIndex``,
      winSketch.hpp:102): contiguous (seqid, wpos)-sorted row ranges,
      each extended by ``halo`` rows of the next. Range boundaries are
      key-aligned (equal (seqid, wpos) keys are never split), so a
      shard-local searchsorted plus the slab's first row equals the
      global searchsorted.
    """
    devices = list(devices)
    n = len(devices)
    U = len(idx.uniq_hashes)
    u_shard = -(-max(U, 1) // n)
    p_shard = 1
    parts = []
    for d in range(n):
        lo = min(d * u_shard, U)
        hi = min(lo + u_shard, U)
        plo = int(idx.post_offsets[lo]) if lo < U else len(idx.post_seqid)
        phi = int(idx.post_offsets[hi]) if hi <= U else len(idx.post_seqid)
        parts.append((lo, hi, plo, phi))
        p_shard = max(p_shard, phi - plo)
    p_shard = 1 << (p_shard - 1).bit_length() if p_shard > 1 else 1

    uniq = np.full((n, u_shard), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    offs = np.zeros((n, u_shard + 1), np.int64)
    seqid = np.zeros((n, p_shard), np.int32)
    wpos = np.zeros((n, p_shard), np.int32)
    wend = np.zeros((n, p_shard), np.int32)
    freq = np.zeros((n, u_shard), bool)
    for d, (lo, hi, plo, phi) in enumerate(parts):
        m = hi - lo
        uniq[d, :m] = idx.uniq_hashes[lo:hi]
        offs[d, :m + 1] = idx.post_offsets[lo:hi + 1] - plo
        offs[d, m + 1:] = offs[d, m]
        seqid[d, :phi - plo] = idx.post_seqid[plo:phi]
        wpos[d, :phi - plo] = idx.post_wpos[plo:phi]
        wend[d, :phi - plo] = idx.post_wend[plo:phi]
        freq[d, :m] = idx.is_frequent[lo:hi]

    # ---- mi slabs: key-aligned row ranges + halo
    key = ((idx.mi_seqid.astype(np.int64) << 32)
           | idx.mi_wpos.astype(np.int64))
    M = len(key)
    chunk_nom = -(-max(M, 1) // n)
    bounds = [0]
    for d in range(1, n):
        b = min(d * chunk_nom, M)
        if b < M:
            b = int(np.searchsorted(key, key[b], side="left"))
        bounds.append(max(b, bounds[-1]))
    bounds.append(M)
    mi_bounds = np.asarray(bounds, np.int64)
    m_shard = max(1, max(
        min(bounds[d + 1] + halo, M) - bounds[d] for d in range(n)))

    mh = np.zeros((n, m_shard), np.int32)    # pads masked by e_valid
    mwp = np.zeros((n, m_shard), np.int32)
    mwe = np.zeros((n, m_shard), np.int32)
    mst = np.zeros((n, m_shard), np.int8)
    msq = np.full((n, m_shard), -1, np.int32)
    mk = np.full((n, m_shard), KEY_MAX, np.int64)
    row0 = []
    kb = np.full(n + 1, KEY_MAX, np.int64)
    kb[0] = KEY_MIN
    for d in range(n):
        lo, hi = bounds[d], min(bounds[d + 1] + halo, M)
        m = hi - lo
        mh[d, :m] = idx.mi_rank[lo:hi]
        mwp[d, :m] = idx.mi_wpos[lo:hi]
        mwe[d, :m] = idx.mi_wend[lo:hi]
        mst[d, :m] = idx.mi_strand[lo:hi]
        msq[d, :m] = idx.mi_seqid[lo:hi]
        mk[d, :m] = key[lo:hi]
        row0.append(int(lo))
        if 0 < d and bounds[d] < M:
            kb[d] = key[bounds[d]]

    def put(a):
        return [to_device(a[d], dev) for d, dev in enumerate(devices)]

    return ShardedIndex(
        n_shards=n, u_shard=u_shard, p_shard=p_shard, devices=devices,
        uniq=[flip(t) for t in put(uniq.view(np.int64))],
        offsets=put(offs), seqid=put(seqid), wpos=put(wpos),
        wend=put(wend), frequent=put(freq),
        m_shard=m_shard, mi_bounds=mi_bounds, mi_row0=row0,
        key_bounds=kb, mi_rank=put(mh), mi_wpos=put(mwp),
        mi_wend=put(mwe), mi_strand=put(mst), mi_seqid=put(msq),
        mi_key=put(mk))


def _sum_on(parts, dev):
    """The JAX package's psum: the shards' tensors summed on ``dev``."""
    out = parts[0].to(dev)
    for x in parts[1:]:
        out = out + x.to(dev)
    return out


def l1_step_sharded(frags, uniq_s, offs_s, pseq_s, pwp_s, pwe_s, freq_s,
                    min_hits_table, cutoff_table, allowed, ref_group,
                    mi_key_s, mi_row0, key_bounds, cfg: L1Config,
                    p_loc: int):
    """Hash-range-sharded ``l1_step``: the same packed output.

    ``*_s`` are per-shard lists (shard d's tensors on its device); the
    other tensors lie on the output device (``frags.device``). Shard d
    gathers at most ``p_loc`` postings per row (the JAX package gathers
    ``p_shard``; any ``p_loc`` >= ``cfg.p_cap`` gives the same rows,
    since a row whose shards hold more than ``p_cap`` postings in all
    overflows to the host route either way). Rows are owned in
    contiguous blocks: block d (rows [d*B/n, (d+1)*B/n)) is swept on
    shard d's device.

    Returns (meta (B, 4+7C) int32, codes (B, s) int32, strands (B, s)
    int8) on ``frags.device``; see mapdev.unpack_l1_meta.
    """
    n = len(uniq_s)
    dev0 = frags.device
    B = frags.shape[0]
    s = cfg.s
    Bl = B // n
    P_loc = p_loc
    devs = [u.device for u in uniq_s]

    q_hash, q_strand, q_cnt, q_cx = sketch_fragments(frags, cfg.k, s)
    q_flip = flip(q_hash)
    live = q_hash != UMAX

    # each shard resolves the sketches against its hash range
    pos0_s, posc_s, found_s, freq_l = [], [], [], []
    for d, dev in enumerate(devs):
        U_s = uniq_s[d].shape[0]
        qf = q_flip.to(dev)
        pos0 = torch.searchsorted(uniq_s[d], qf)
        posc = torch.clamp(pos0, max=U_s - 1)
        found = live.to(dev) & (uniq_s[d][posc] == qf)
        pos0_s.append(pos0)
        posc_s.append(posc)
        found_s.append(found)
        freq_l.append((found & freq_s[d][posc]).to(torch.int32))
    # frequent-seed status lives on exactly one shard: psum > 0 is OR
    freq_g = _sum_on(freq_l, dev0) > 0
    keep = live & ~freq_g
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    # global insertion position: shards hold contiguous ranges of the
    # sorted hash table, so counts-below sum (pads are flip(UMAX) and
    # never counted below a real query)
    pos_g = _sum_on(pos0_s, dev0)
    found_g = _sum_on([f.to(torch.int32) for f in found_s], dev0) > 0
    q_code = (pos_g.to(torch.int32) << 1) | found_g.to(torch.int32)
    q_code_c = torch.gather(torch.where(keep, q_code, I32MAX), 1, order)
    q_strand_c = torch.gather(torch.where(keep, q_strand, 0), 1, order)
    s_q = keep.sum(dim=1, dtype=torch.int32)
    min_hits = min_hits_table[s_q.long()]

    # local postings ranges for kept hashes found on each shard
    g_s, total_s = [], []
    for d, dev in enumerate(devs):
        U_s = uniq_s[d].shape[0]
        use = keep.to(dev) & found_s[d]
        posc = posc_s[d]
        offs = offs_s[d]
        start = torch.where(use, offs[posc], 0)
        cnt = torch.where(use, offs[torch.clamp(posc + 1, max=U_s)] - start,
                          0)
        cum = torch.cumsum(cnt, dim=1)
        base = cum - cnt
        total_l = cum[:, -1]
        total_s.append(total_l)
        j = torch.arange(P_loc, device=dev)[None, :]
        # slot[j]: the sketch lane owning gathered position j (scatter-max
        # of range starts, then cummax fill)
        z = torch.full((B, P_loc + 1), -1, dtype=torch.int64, device=dev)
        tgt = torch.clamp(torch.where(cnt > 0, base, P_loc), max=P_loc)
        z.scatter_reduce_(1, tgt, torch.arange(s, device=dev).repeat(B, 1),
                          "amax")
        slot = torch.clamp(torch.cummax(z[:, :P_loc], dim=1).values, 0,
                           s - 1)
        src = (torch.gather(start, 1, slot)
               + (j - torch.gather(base, 1, slot)))
        valid_j = j < torch.clamp(total_l, max=P_loc)[:, None]
        srcc = torch.clamp(src, 0, pseq_s[d].shape[0] - 1)
        g_s.append((torch.where(valid_j, pseq_s[d][srcc], 0),
                    torch.where(valid_j, pwp_s[d][srcc], 0),
                    torch.where(valid_j, pwe_s[d][srcc], 0), valid_j))
    overflow_l1 = _sum_on(total_s, dev0) > cfg.p_cap    # replicated rule

    # every block gathers all shards' hits for its rows (all_gather),
    # then sweeps them on its own device
    cands, keys3 = [], []
    for i, dev in enumerate(devs):
        rows = slice(i * Bl, (i + 1) * Bl)
        g_seq, g_wp, g_we, valid = (
            torch.cat([g[c][rows].to(dev) for g in g_s], dim=1)
            for c in range(4))
        adm = torch.gather(allowed[rows].to(dev), 1, g_seq.long())
        c = sweep_and_candidates(
            g_seq, g_wp, g_we, valid & adm, s_q[rows].to(dev),
            min_hits[rows].to(dev), ref_group.to(dev),
            cutoff_table.to(dev), cfg)
        c_seq, c_first, c_last = c[0], c[1], c[2]
        seq64 = c_seq.to(torch.int64) << 32
        lo_k = seq64 | torch.clamp(
            c_first.to(torch.int64) - cfg.seg_length - 1, min=0)
        mid_k = seq64 | torch.clamp(c_first, min=0).to(torch.int64)
        hi_k = seq64 | (c_last.to(torch.int64) + 1)
        keys3.append(torch.cat([lo_k, mid_k, hi_k], dim=1).to(dev0))
        cands.append([x.to(dev0) for x in c])
    c_seq, c_first, c_last, c_inter, n_cand, overflow_c = (
        torch.cat(x) for x in zip(*cands))

    # L2 slice bounds against the row-range-sharded key slabs: each
    # shard searches its slab for every row's keys, keeps the keys its
    # range owns, and the sum assembles the global positions (slab
    # position + slab row offset, exact since bounds are key-aligned)
    keys3 = torch.cat(keys3)                              # (B, 3C)
    posg = []
    for d, dev in enumerate(devs):
        k = keys3.to(dev)
        pos = (torch.searchsorted(mi_key_s[d], k).to(torch.int32)
               + mi_row0[d])
        owned = (k >= int(key_bounds[d])) & (k < int(key_bounds[d + 1]))
        posg.append(torch.where(owned, pos, 0))
    posg = _sum_on(posg, dev0)
    C = cfg.c_cap
    c_lo, c_mid, c_hi = posg[:, :C], posg[:, C:2 * C], posg[:, 2 * C:]

    meta = torch.cat([
        s_q[:, None], n_cand[:, None].to(torch.int32),
        (overflow_l1 | overflow_c).to(torch.int32)[:, None],
        q_cx.to(torch.float32).view(torch.int32)[:, None],
        c_seq, c_first, c_last, c_inter, c_lo, c_mid, c_hi], dim=1)
    return meta, q_code_c, q_strand_c.to(torch.int8)


def l2_step_sharded(w_lo, w_mid, w_hi, w_seq, q_code, q_strand, s_q,
                    mi_rank_s, mi_wpos_s, mi_wend_s, mi_strand_s,
                    mi_seqid_s, t_cap: int, s: int):
    """``l2_step`` over the row-range-sharded interval table.

    Work items arrive routed: entry d of each per-shard list holds the
    items whose [lo, hi) slice lives on shard d, with bounds rebased to
    slab-local rows (the engine routes by ``ShardedIndex.mi_bounds``),
    on shard d's device. Every shard runs the standard ``l2_step`` on
    its slab. Returns the per-shard (W_d, buf) outputs, on each shard's
    device.
    """
    return [l2_step(w_lo[d], w_mid[d], w_hi[d], w_seq[d], q_code[d],
                    q_strand[d], s_q[d], mi_rank_s[d], mi_wpos_s[d],
                    mi_wend_s[d], mi_strand_s[d], mi_seqid_s[d], t_cap, s)
            for d in range(len(mi_rank_s))]
