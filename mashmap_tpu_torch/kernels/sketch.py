"""Batched query fragment sketching (bottom-s MinHash of each fragment).

Reference semantics (``CommonFunc::sketchSequence``, commonFunc.hpp:182-288):
for a query fragment, keep the s smallest *distinct* canonical k-mer
hashes; for each kept hash accumulate a strand vote (+1 forward / -1
reverse) over ALL its occurrences; classify votes >0/==0/<0 as
FWD/AMBIG/REV; output is ascending by hash. K-mers containing 'N'
(full-window rule) and palindromic-hash k-mers are skipped.

Counterpart of ``mashmap_tpu/kernels/sketch.py``: a whole batch of
fragments is sketched at once (hash all windows, sort each row, take the
first s distinct, segment-reduce votes). Fragments shorter than the
batch length are padded with 'N' bytes, which makes the padded windows
invalid without touching real windows. Also computes the k-mer
complexity estimate (reference: computeMap.hpp:830-831).
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import canonical_kmer_hashes
from .murmur import INT64_MIN, UMAX, flip

_TWO64 = float(2.0 ** 64)


def u64_to_f64(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 of u64 bits held in int64: the high 53
    bits and the low 11 bits are each exact in float64, so their sum
    rounds once."""
    hi = (x >> 11) & ((1 << 53) - 1)
    lo = x & 0x7FF
    return hi.to(torch.float64) * 2048.0 + lo.to(torch.float64)


def sketch_fragments(frags: torch.Tensor, k: int, s: int):
    """Sketch a batch of fragments.

    Args:
      frags: (B, L) uint8 sanitized ASCII bytes ('A','C','G','T','N'),
             'N'-padded to a common length L.
      k: k-mer size.
      s: sketch size.

    Returns:
      hashes: (B, s) int64 u64 bits ascending (unsigned), UMAX-padded.
      strand: (B, s) int8 classified votes (FWD 1 / AMBIG 0 / REV -1).
      count:  (B,) int32 — number of kept sketch hashes (min(s, #distinct)).
      complexity: (B,) float64 k-mer complexity estimate; the denominator
             uses the padded window count (see `complexity_rescale`).
    """
    B, L = frags.shape
    n = L - k + 1
    dev = frags.device
    hashes, strand, palin, has_n, _ = canonical_kmer_hashes(frags, k)
    valid = ~palin & ~has_n
    key = flip(torch.where(valid, hashes, UMAX))   # signed == u64 order
    fmax = UMAX ^ INT64_MIN                        # flip(UMAX)
    skey, perm = torch.sort(key, dim=-1, stable=True)
    sstr = torch.gather(strand.to(torch.int32), 1, perm)
    live = skey != fmax

    newh = torch.ones_like(live)
    newh[:, 1:] = skey[:, 1:] != skey[:, :-1]
    newh &= live
    rank = torch.cumsum(newh.to(torch.int32), dim=-1) - 1  # distinct rank

    # column of the r-th distinct hash for r <= s: rank is strictly
    # increasing over newh columns, so a stable sort of (rank or s+1)
    # moves the group starts to the first columns in rank order
    Lk = rank.shape[1]
    keyr = torch.where(newh & (rank <= s), rank, s + 1)
    r_ext = torch.sort(keyr, dim=-1, stable=True).indices.to(torch.int64)
    r_ext = r_ext[:, :s + 1]      # garbage beyond n_distinct (masked)
    if r_ext.shape[1] < s + 1:
        # s >= window count: fewer than s+1 columns exist
        r_ext = torch.cat([r_ext, torch.full(
            (B, s + 1 - r_ext.shape[1]), Lk - 1, dtype=torch.int64,
            device=dev)], dim=1)
    r_idx = r_ext[:, :s]
    r_idx_c = torch.clamp(r_idx, max=L - k)
    out_h = torch.gather(skey, 1, r_idx_c)
    n_distinct = (rank[:, -1] + 1).to(torch.int64)
    got = torch.arange(s, device=dev)[None, :] < n_distinct[:, None]
    out_h = flip(torch.where(got, out_h, fmax))

    # per-distinct strand vote: group r spans [r_idx, next start)
    cs = torch.cumsum(torch.where(live, sstr, 0), dim=-1)
    nxt_idx = torch.where(
        torch.arange(1, s + 1, device=dev)[None, :] < n_distinct[:, None],
        r_ext[:, 1:], Lk)
    cs_ext = torch.cat([torch.zeros((B, 1), dtype=cs.dtype, device=dev), cs],
                       dim=-1)
    votes = (torch.gather(cs_ext, 1, torch.clamp(nxt_idx, max=L - k + 1))
             - torch.gather(cs_ext, 1, r_idx_c))
    votes = torch.where(got, votes, 0)
    is_pad = out_h == UMAX
    out_strand = torch.where(is_pad, 0, torch.sign(votes)).to(torch.int8)

    count = (~is_pad).sum(dim=-1, dtype=torch.int32)
    # largest kept hash (unsigned); 0 when nothing is kept
    max_kept = flip(torch.where(is_pad, flip(torch.zeros_like(out_h)),
                                flip(out_h)).amax(dim=-1))
    max01 = u64_to_f64(max_kept) / _TWO64
    # XLA compiles the JAX package's "/ (2 * n)" by a constant into a
    # multiplication by its reciprocal; the same rounding keeps the kc:f
    # tag bit-identical
    inv_denom = 1.0 / float(2 * n)
    complexity = torch.where(
        count > 0,
        (count.to(torch.float64) / torch.clamp(max01, min=1e-300))
        * inv_denom, 0.0)
    return out_h, out_strand, count, complexity


def complexity_rescale(complexity: np.ndarray, padded_len: int,
                       true_len: np.ndarray, k: int) -> np.ndarray:
    """Fix the complexity denominator for 'N'-padded fragments.

    complexity = (count / max01) / (2*(len-k+1)); padding inflates len.
    """
    return complexity * (padded_len - k + 1) / (true_len - k + 1)


def sketch_sequence_py(seq_u8: np.ndarray, k: int, s: int):
    """Single-fragment sketch, plain numpy (host route / oracle)."""
    from . import murmur, kmers as _k
    n = len(seq_u8) - k + 1
    if n <= 0:
        return (np.empty(0, np.uint64), np.empty(0, np.int8), 0, 0.0)
    h = np.empty(n, np.uint64)
    st = np.empty(n, np.int8)
    ok = np.empty(n, bool)
    rc = _k.revcomp_np(seq_u8)
    is_n = seq_u8 == ord("N")
    cn = np.concatenate(([0], np.cumsum(is_n)))
    for i in range(n):
        f = murmur.murmur128_low64_py(seq_u8[i:i + k].tobytes())
        b = murmur.murmur128_low64_py(rc[len(rc) - i - k: len(rc) - i]
                                      .tobytes())
        h[i] = min(f, b)
        st[i] = 1 if f < b else -1
        ok[i] = (f != b) and (cn[i + k] - cn[i] == 0)
    vh = h[ok]
    if len(vh) == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.int8), 0, 0.0)
    uniq = np.unique(vh)[:s]
    votes = np.array([st[ok][vh == u].sum() for u in uniq])
    strand = np.sign(votes).astype(np.int8)
    count = len(uniq)
    max01 = float(uniq[-1]) / float(2.0 ** 64)
    complexity = (count / max01) / (2 * n)
    return uniq, strand, count, complexity
