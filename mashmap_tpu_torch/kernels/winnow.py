"""Sliding-window bottom-s threshold (theta) for reference winnowing.

Counterpart of ``mashmap_tpu/kernels/winnow.py``. A hash h is in the
bottom-s sketch of window W iff present(h, W) AND h <= theta(W), where
theta(W) is the s-th smallest *distinct* valid hash present in W (or
+inf when fewer than s are present).

theta is computed for all windows with the two-level sliding-window
decomposition: the k-mer position axis is cut into blocks of exactly
S_B = window span; window W = b*S_B + j is the union of block b's suffix
from j and block b+1's prefix up to j, and bottom-s sketches merge. The
per-block-row work is ``kernels/theta.py::theta_chunk`` (a hand-written
CUDA kernel on the card). Hashes are first rank-reduced to dense int32
ranks (``_rank_reduce``), so every comparison is a native int32 one;
rank order equals u64 order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .murmur import UMAX, flip
from .theta import RSENT, theta_chunk, theta_rows_per_launch

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)  # "+inf" hash / invalid marker


def _rank_reduce(hm: torch.Tensor):
    """Dense int32 ranks of a SENTINEL-masked u64 array (int64 bits).

    Returns (ranks, lut): ranks[i] = rank of hm[i] among distinct
    non-SENTINEL values (RSENT where hm is SENTINEL); lut[r] = the u64
    value of rank r (SENTINEL-padded to len(hm)).
    """
    n = hm.shape[0]
    sv, perm = torch.sort(flip(hm), stable=True)
    fsent = flip(torch.tensor(UMAX, dtype=torch.int64))
    newv = torch.ones(n, dtype=torch.bool, device=hm.device)
    newv[1:] = sv[1:] != sv[:-1]
    newv &= sv != fsent
    rank_sorted = torch.cumsum(newv.to(torch.int32), 0,
                               dtype=torch.int32) - 1
    rank_sorted = torch.where(sv == fsent, RSENT, rank_sorted)
    ranks = torch.empty_like(rank_sorted)
    ranks[perm] = rank_sorted
    lut = torch.full((n,), UMAX, dtype=torch.int64, device=hm.device)
    lut[rank_sorted[newv].long()] = flip(sv[newv])
    return ranks, lut


def rank_reduce_host(contigs):
    """Host (numpy) rank reduction over all contigs.

    Args:
      contigs: per contig, (u64 hashes, valid mask) numpy arrays.

    Returns (per-contig int32 rank arrays with RSENT at invalid
    positions, sorted unique u64 value LUT) — the ranks and LUT of the
    JAX package's ``rank_reduce_host``. One argsort over all positions
    gives both (as ``_rank_reduce`` does on the device), instead of a
    binary search per position into the unique values.
    """
    if not contigs:
        return [], np.empty(0, np.uint64)
    hm = np.concatenate([np.where(v, h, SENTINEL) for h, v in contigs])
    order = np.argsort(hm)
    sv = hm[order]
    newv = np.empty(len(sv), bool)
    newv[:1] = True
    np.not_equal(sv[1:], sv[:-1], out=newv[1:])
    live = sv != SENTINEL
    newv &= live
    uniq = sv[newv]
    assert len(uniq) < np.iinfo(np.int32).max
    rank_sorted = np.cumsum(newv, dtype=np.int32) - 1
    rank_sorted[~live] = RSENT
    ranks = np.empty(len(hm), np.int32)
    ranks[order] = rank_sorted
    out, a = [], 0
    for h, _ in contigs:
        out.append(ranks[a:a + len(h)])
        a += len(h)
    return out, uniq


def theta_blocks(rank_list: Sequence[torch.Tensor], s_b: int):
    """The block rows theta_chunk takes for a list of contigs.

    Returns (cur, nxt, spans): cur and nxt are (C, s_b) int32, row c of
    nxt being the block after row c of cur (RSENT past a contig's end);
    spans[i] is (first row, rows, n_w) of contig i, or None where it has
    no full window.
    """
    cur_rows, nxt_rows, spans = [], [], []
    row0 = 0
    for r in rank_list:
        n_k = int(r.shape[0])
        n_w = n_k - s_b + 1
        if n_w <= 0:
            spans.append(None)
            continue
        n_blocks = -(-n_k // s_b)
        pad = n_blocks * s_b - n_k
        if pad:
            r = torch.cat([r, torch.full((pad,), RSENT, dtype=torch.int32,
                                         device=r.device)])
        blocks = r.view(n_blocks, s_b)
        nxt = torch.cat([blocks[1:], torch.full(
            (1, s_b), RSENT, dtype=torch.int32, device=r.device)])
        cur_rows.append(blocks)
        nxt_rows.append(nxt)
        spans.append((row0, n_blocks, n_w))
        row0 += n_blocks
    if not cur_rows:
        return None, None, spans
    return (torch.cat(cur_rows).contiguous(),
            torch.cat(nxt_rows).contiguous(), spans)


def theta_scan_ranks(rank_list: Sequence[torch.Tensor], s: int,
                     window_span: int) -> List[Optional[torch.Tensor]]:
    """theta ranks for every window of every contig.

    Args:
      rank_list: per contig, (n_k,) int32 dense hash ranks with RSENT at
        invalid positions (see `_rank_reduce`), all on one device.

    Returns:
      per contig, (n_w,) int32 theta ranks (RSENT = "window holds < s
      distinct valid hashes"); None where n_w <= 0.
    """
    s_b = int(window_span)
    cur, nxt, spans = theta_blocks(rank_list, s_b)
    if cur is None:
        return [None for _ in spans]
    n_total = cur.shape[0]
    # row chunks bound the kernels' scratch (and the plain version's
    # suffix stack)
    step = theta_rows_per_launch(cur.device, s, s_b)
    theta = torch.cat([
        theta_chunk(cur[c0:c0 + step], nxt[c0:c0 + step], s, s_b)
        for c0 in range(0, n_total, step)])
    out = []
    for sp in spans:
        if sp is None:
            out.append(None)
            continue
        r0, n_blocks, n_w = sp
        out.append(theta[r0:r0 + n_blocks].reshape(-1)[:n_w])
    return out


def window_thresholds_bruteforce(
    hashes: np.ndarray, valid: np.ndarray, s: int, window_span: int
) -> np.ndarray:
    """O(n_w * S_B log) brute-force theta — test oracle only."""
    n_k = len(hashes)
    n_w = n_k - window_span + 1
    out = np.full(max(n_w, 0), SENTINEL, dtype=np.uint64)
    for w in range(max(n_w, 0)):
        vals = np.unique(hashes[w:w + window_span][valid[w:w + window_span]])
        if len(vals) >= s:
            out[w] = vals[s - 1]
    return out
