"""Device-side minmer membership-event extraction.

Counterpart of ``mashmap_tpu/kernels/events.py``: one call per position
chunk of a contig finds the membership begin/end events and the member
occurrences, so the only device->host traffic of an index build is the
sparse result. Semantics follow the reference's sequential sweep
(commonFunc.hpp:376-520):

  * membership(h, W) = present(h, W) and h <= theta(W);
  * one k-mer enters / one leaves per window step => O(1) events per
    window: entering-hash gains, theta-rise gains, and their symmetric
    losses — all elementwise over the position/window axes;
  * begins and ends come back unpaired; the build pairs them per hash in
    (hash, W) order on the device (``index/builder.py::classify_group``;
    the host route's ``_pair_begin_end``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .theta import RSENT

I32MAX = int(np.iinfo(np.int32).max)


def events_caps(Np: int, s: int, s_b: int):
    """(iv_cap, mem_cap) for a chunk of Np positions: a power-of-two
    fraction of Np with >= 2.5x headroom over the expected ~2*s/s_b
    event density."""
    shift = max(0, min(6, int(math.floor(
        math.log2(max(1.0, s_b / (5.0 * s)))))))
    cap = max(1 << 12, Np >> shift)
    cap = 1 << (cap - 1).bit_length()
    return cap, cap


def _compact(mask: torch.Tensor, payloads, cap: int):
    """Order-preserving stream compaction into buffers exactly ``cap``
    long. Returns (count, [payload buffers]); rows beyond cap are
    dropped (the caller checks count > cap); contents beyond the count
    are zero. No host sync: rows scatter to their running index, and
    dropped rows to a spare slot."""
    idx = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    cnt = mask.sum(dtype=torch.int32)
    tgt = torch.where(mask & (idx < cap), idx, cap).long()
    outs = []
    for p in payloads:
        buf = torch.zeros(cap + 1, dtype=p.dtype, device=p.device)
        buf.scatter_(0, tgt, p)
        outs.append(buf[:cap])
    return cnt, outs


def _shift_cat(head: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([head, x])[:n]


def events_chunk(ranks, strand, theta, a0: int, base: int, n_local: int,
                 n_k: int, n_w: int, s_b: int, beg_cap: int, mem_cap: int):
    """Membership events for ONE position-chunk of a contig.

    The call sees positions [a0, a0+CHP): the chunk core
    [a0+base, a0+base+n_local) plus an s_b halo on each side, so device
    memory is O(chunk) regardless of contig length. Every rule is exactly
    local given the halo:

      * prev/next same-hash occurrence tests only discriminate within
        +-s_b, so a local sort gives the same begin/end/lost decisions;
      * member occurrences are "rank <= sliding max of theta over the
        position's own windows" (a trailing-window block cummax);
      * begins/ends are emitted UNPAIRED (hash, W).

    Args:
      ranks: (CHP,) int32 group-local ranks, RSENT where invalid.
      strand: (CHP,) int8 strand votes.
      theta: (CHP,) int32 theta of windows a0.., RSENT beyond n_w.

    Returns one packed int32 buffer:
      [beg_h(beg_cap), beg_W(beg_cap), end_h(beg_cap), end_W(beg_cap),
       mem_rankstrand(mem_cap),        # rank<<1 | strand>0
       mem_pos(mem_cap),
       n_beg, n_end, n_mem, overflow]
    """
    CHP = ranks.shape[0]
    dev = ranks.device
    i32 = torch.int32
    shift = int(CHP - 1).bit_length()
    pos_mask = (1 << shift) - 1
    assert 2 * shift + 1 <= 62
    t = torch.arange(CHP, dtype=i32, device=dev)
    pos = a0 + t
    valid = (ranks != RSENT) & (pos < n_k)

    # --- prev/next same-hash occurrence via one LOCAL packed-key sort;
    # invalid rows keep their t under rank RSENT, so sp_t is a
    # permutation of [0, CHP)
    key = ((torch.where(valid, ranks, RSENT).to(torch.int64) << (shift + 1))
           | (t.to(torch.int64) << 1) | (strand > 0).to(torch.int64))
    skey = torch.sort(key).values
    sh = (skey >> (shift + 1)).to(i32)
    svalid = sh != RSENT
    sp_t = ((skey >> 1) & pos_mask).long()
    same = (sh[1:] == sh[:-1])
    f1 = torch.zeros(1, dtype=torch.bool, device=dev)
    same_prev = torch.cat([f1, same & svalid[1:]])
    same_next = torch.cat([same & svalid[:-1], f1])
    z1 = torch.zeros(1, dtype=torch.long, device=dev)
    prev_s = torch.where(same_prev, torch.cat([z1, sp_t[:-1]]), -1)
    next_s = torch.where(same_next, torch.cat([sp_t[1:], z1]), I32MAX)
    prev_t = torch.empty(CHP, dtype=torch.long, device=dev)
    next_t = torch.empty(CHP, dtype=torch.long, device=dev)
    prev_t[sp_t] = prev_s
    next_t[sp_t] = next_s
    # global coordinates; "none in the chunk" stays -1 / I32MAX, which
    # answers every +-s_b test like the true global occurrence would
    prev_occ = torch.where(prev_t >= 0, a0 + prev_t, -1)
    next_occ = torch.where(next_t != I32MAX, a0 + next_t, I32MAX)
    pos_l = pos.long()

    # --- membership-change masks ---
    th0 = theta[:1].expand(s_b - 1)
    thetapad1 = _shift_cat(th0, theta, CHP)          # theta[p - s_b + 1]
    th_prevw = _shift_cat(torch.zeros(s_b, dtype=i32, device=dev),
                          theta, CHP)                # theta[p - s_b]
    begW = torch.clamp(pos - (s_b - 1), min=0)
    stayed = (begW >= 1) & (prev_occ == begW.long() - 1) & \
        (ranks <= th_prevw)
    begin1 = valid & (prev_occ < begW.long()) & (ranks <= thetapad1) & \
        ~stayed
    lost = valid & (pos + 1 < n_w) & (next_occ > pos_l + s_b)
    end1 = lost & (ranks <= theta)

    W = pos
    th_W = theta
    th_Wm1 = torch.cat([theta[:1], theta[:-1]])
    wmask = (W >= 1) & (W < n_w)
    rose = wmask & (th_W > th_Wm1)
    h_in_W = torch.cat([ranks[s_b - 1:], torch.full(
        (s_b - 1,), RSENT, dtype=i32, device=dev)])[:CHP]
    begin1_at = torch.cat([begin1[s_b - 1:], torch.zeros(
        s_b - 1, dtype=torch.bool, device=dev)])[:CHP]
    begin2 = rose & (th_W != RSENT) & ~(begin1_at & (h_in_W == th_W))
    fell = wmask & (th_W < th_Wm1)
    h_out_W = torch.cat([torch.full((1,), RSENT, dtype=i32, device=dev),
                         ranks[:-1]])
    lost_at = torch.cat([f1, lost[:-1]])
    end2 = fell & (th_Wm1 != RSENT) & ~(lost_at & (h_out_W == th_Wm1))

    # --- member occurrences: rank <= trailing sliding max of theta
    # (-1 where the window doesn't exist, RSENT where it holds < s
    # distinct hashes => everything is a member)
    th_m = torch.where((pos >= 0) & (pos < n_w), theta, -1)
    m_len = -(-CHP // s_b) * s_b
    blocks = torch.cat([th_m, torch.full((m_len - CHP,), -1, dtype=i32,
                                         device=dev)]).view(-1, s_b)
    pre = torch.cummax(blocks, dim=1).values.reshape(-1)[:CHP]
    suf = torch.flip(torch.cummax(torch.flip(blocks, [1]), dim=1).values,
                     [1]).reshape(-1)
    suf_shift = _shift_cat(torch.full((s_b - 1,), -1, dtype=i32,
                                      device=dev), suf, CHP)
    smax = torch.where(t >= s_b - 1, torch.maximum(suf_shift, pre), pre)
    member = valid & (ranks <= smax)

    # --- compact (core positions / windows only) ---
    core = (t >= base) & (t < base + n_local)
    n_beg, (bh, bW) = _compact(
        torch.cat([begin1 & core, begin2 & core]),
        (torch.cat([ranks, th_W]), torch.cat([begW, W])), beg_cap)
    n_end, (eh, eW) = _compact(
        torch.cat([end1 & core, end2 & core]),
        (torch.cat([ranks, th_Wm1]), torch.cat([pos + 1, W])), beg_cap)
    mrk = (ranks << 1) | (strand > 0).to(i32)
    n_mem, (m_rk, m_pos) = _compact(member & core, (mrk, pos), mem_cap)

    overflow = ((n_beg > beg_cap) | (n_end > beg_cap)
                | (n_mem > mem_cap)).to(i32)
    return torch.cat([bh, bW, eh, eW, m_rk, m_pos,
                      torch.stack([n_beg, n_end, n_mem, overflow]).to(i32)])


def counts_fit(head, beg_cap: int, mem_cap: int) -> bool:
    """Whether a chunk's four counts (n_beg, n_end, n_mem, overflow:
    the tail of events_chunk's buffer) fit its caps."""
    n_bg, n_en, n_mem, ovf = (int(x) for x in head)
    return not ovf and max(n_bg, n_en) <= beg_cap and n_mem <= mem_cap


def live_lanes(buf, head, beg_cap: int, mem_cap: int):
    """The live lanes (beg_h, beg_W, end_h, end_W, mem_rankstrand,
    mem_pos) of events_chunk's buffer, as slices of it (a host array or
    the device tensor), given the counts ``head`` that fit the caps."""
    n_bg, n_en, n_mem = (int(x) for x in head[:3])
    c1, c2 = beg_cap, mem_cap
    return (buf[0:n_bg], buf[c1:c1 + n_bg],
            buf[2 * c1:2 * c1 + n_en], buf[3 * c1:3 * c1 + n_en],
            buf[4 * c1:4 * c1 + n_mem],
            buf[4 * c1 + c2:4 * c1 + c2 + n_mem])
