"""Exact-match anchor chains inside a mapped region (host side).

The port's copy of ``mashmap_tpu/align/anchors.py`` (numpy, unchanged).
The aligner never runs one giant DP over a mapping (reference edlib does,
src/align/include/computeAlignments.hpp:268-269, with a word-serial
bit-vector — the wrong shape for a batched device). Instead it finds k-mer anchors
that are unique in both the query region and the reference region
(MUM-style), chains the longest collinear subset, and thins the chain so
the gaps between consecutive anchors become small, independent,
fixed-bucket DP pieces — a batch axis for the device kernel.

At mashmap's operating identities (>= 75-85%) unique-21-mer anchors are
dense (an exact 21-mer survives ~0.85^21 ~ 3% of positions => anchors
every ~30 bp), so pieces stay tiny and the device does all the real work.
"""

from __future__ import annotations

import numpy as np

_B2 = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _B2[_b] = _i


def kmer_codes(seq_u8: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """2-bit packed k-mer codes + validity (no N) for every window.

    Returns (codes[u64], valid[bool]) of length len(seq)-k+1 (empty if
    the sequence is shorter than k).
    """
    n = seq_u8.shape[0]
    if n < k:
        return (np.zeros(0, np.uint64), np.zeros(0, bool))
    b = _B2[seq_u8]
    bad = b == 255
    nw = n - k + 1
    codes = np.zeros(nw, dtype=np.uint64)
    for j in range(k):
        codes = (codes << np.uint64(2)) | (b[j:j + nw] & np.uint64(3))
    cbad = np.concatenate(([0], np.cumsum(bad)))
    valid = (cbad[k:] - cbad[:-k]) == 0
    return codes, valid


def _unique_positions(codes: np.ndarray,
                      valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(sorted unique codes occurring exactly once, their positions)."""
    pos = np.flatnonzero(valid)
    c = codes[pos]
    order = np.argsort(c, kind="stable")
    cs, ps = c[order], pos[order]
    uniq_first = np.concatenate(([True], cs[1:] != cs[:-1]))
    uniq_last = np.concatenate((cs[1:] != cs[:-1], [True]))
    single = uniq_first & uniq_last
    return cs[single], ps[single]


def _lis_chain(qpos: np.ndarray, rpos: np.ndarray) -> np.ndarray:
    """Indices of the longest chain with qpos and rpos both increasing.

    qpos must already be strictly increasing (unique anchors sorted by
    query position); patience LIS on rpos, O(n log n) via bisect (an
    array rebuild per step would be quadratic — megabase regions carry
    hundreds of thousands of anchors).
    """
    import bisect

    n = len(rpos)
    if n == 0:
        return np.zeros(0, np.int64)
    rl = rpos.tolist()
    tails: list[int] = []       # index of smallest tail rpos per length
    prev = np.full(n, -1, np.int64)
    tail_r: list[int] = []
    for i, v in enumerate(rl):
        j = bisect.bisect_left(tail_r, v)
        if j == len(tails):
            tails.append(i)
            tail_r.append(v)
        else:
            tails[j] = i
            tail_r[j] = v
        prev[i] = tails[j - 1] if j > 0 else -1
    out = []
    i = tails[-1]
    while i >= 0:
        out.append(i)
        i = prev[i]
    return np.asarray(out[::-1], np.int64)


def find_anchor_chain(
    q_u8: np.ndarray,
    r_u8: np.ndarray,
    k: int = 21,
    spacing: int = 192,
) -> np.ndarray:
    """Thinned collinear chain of unique exact k-mer anchors.

    Returns (A, 2) int64 array of (qpos, rpos) anchor starts, strictly
    increasing on both axes with consecutive anchors >= k apart on both
    (so their k-mer matches never overlap); possibly empty.
    """
    qc, qv = kmer_codes(q_u8, k)
    rc, rv = kmer_codes(r_u8, k)
    if not len(qc) or not len(rc):
        return np.zeros((0, 2), np.int64)
    qcu, qpu = _unique_positions(qc, qv)
    rcu, rpu = _unique_positions(rc, rv)
    common, qi, ri = np.intersect1d(
        qcu, rcu, assume_unique=True, return_indices=True)
    if not len(common):
        return np.zeros((0, 2), np.int64)
    qp, rp = qpu[qi], rpu[ri]
    order = np.argsort(qp, kind="stable")
    qp, rp = qp[order], rp[order]
    keep = _lis_chain(qp, rp)
    qp, rp = qp[keep], rp[keep]
    # thin: keep an anchor only if it advances >= max(k, spacing) on the
    # query axis and >= k on the ref axis (non-overlap), except always
    # keep the first and last chain anchors (they pin the ends).
    step = max(k, spacing)
    out = []
    last_q = last_r = -1 << 60
    for i in range(len(qp)):
        if qp[i] - last_q >= step and rp[i] - last_r >= k:
            out.append(i)
            last_q, last_r = qp[i], rp[i]
    if len(qp) and (not out or out[-1] != len(qp) - 1):
        # try to keep the final anchor to pin the tail
        if out and qp[-1] - qp[out[-1]] >= k and rp[-1] - rp[out[-1]] >= k:
            out.append(len(qp) - 1)
    sel = np.asarray(out, np.int64)
    return np.stack([qp[sel], rp[sel]], axis=1) if len(sel) else \
        np.zeros((0, 2), np.int64)
