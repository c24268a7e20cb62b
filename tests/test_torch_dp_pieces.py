"""The banded DP's test pieces, shared by the port's DP tests and
chip_smoke.py, and the check that they are pieces the aligner could
hand the kernel.

dp_pieces, dp_edge_pieces and free_ends import numpy only, so
chip_smoke.py can take them on a card's machine without JAX.
"""

import types

import numpy as np


def dp_pieces(P, W, B, seed):
    """banded_dp_trace's numpy inputs (q, r, n, m, lo, free_start) for B
    random pieces of bucket (P, W), padded as the aligner pads them
    (R = P + W): query lengths 1..P, target lengths within the band's
    reach of n, the target a copy of the query with a 0-30% share of its
    bases redrawn, free_start alternating, lo as
    align/driver.py::_band_lo sets it."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    half = max(0, (W - 33) // 2)
    n = rng.integers(1, P + 1, B).astype(np.int32)
    m = np.clip(n + rng.integers(-half, half + 1, B), 1,
                P + W - 1).astype(np.int32)
    q = np.zeros((B, P), np.uint8)
    r = np.zeros((B, P + W), np.uint8)
    for b in range(B):
        base = acgt[rng.integers(0, 4, max(n[b], m[b]))]
        q[b, :n[b]] = base[:n[b]]
        t = base[:m[b]].copy()
        hit = rng.random(m[b]) < rng.uniform(0.0, 0.3)
        t[hit] = acgt[rng.integers(0, 4, int(hit.sum()))]
        r[b, :m[b]] = t
    d = m - n
    lo = (np.minimum(0, d) - (W - np.abs(d) - 1) // 2).astype(np.int32)
    return q, r, n, m, lo, np.arange(B) % 2 == 1


def dp_edge_pieces(P, W, seed=1):
    """banded_dp_trace's inputs for the edge pieces of bucket (P, W), each with
    free_start False and True: n = 1; n = P; m = P + W - 1 (the padded
    target's last byte); m < n; m = 0; and lo at its extremes (the band
    wholly at or below the diagonal, starting at j = m, wholly before
    j = 0, wholly past m). Random bases; lo as the aligner sets it where
    the case does not fix it."""
    rng = np.random.default_rng(seed)
    cases = [(1, 1, None), (1, W // 2, None), (P, P, None),
             (P, P + W - 1, None), (P, max(1, P - W // 2), None),
             (P // 2, 0, None), (P, P, -(W - 1)), (P, P, P),
             (P, P, -(P + W)), (P, P, P + W), (P // 2, P // 2, 0)]
    B = 2 * len(cases)
    q = rng.integers(65, 69, (B, P)).astype(np.uint8)
    r = rng.integers(65, 69, (B, P + W)).astype(np.uint8)
    n = np.zeros(B, np.int32)
    m = np.zeros(B, np.int32)
    lo = np.zeros(B, np.int32)
    for i, (nn, mm, ll) in enumerate(cases):
        d = mm - nn
        for b in (2 * i, 2 * i + 1):
            n[b], m[b] = nn, mm
            lo[b] = min(0, d) - (W - abs(d) - 1) // 2 if ll is None else ll
            q[b, nn:] = 0
            r[b, mm:] = 0
    return q, r, n, m, lo, np.arange(B) % 2 == 1


def free_ends(B):
    """banded_dp_trace's free_end for B test pieces: with dp_pieces'
    alternating free_start, every pair of the two flags in turn."""
    return np.arange(B) // 2 % 2 == 1


def _check_piece_shapes(arrays, P, W):
    q, r, n, m, lo, fs = arrays
    B = q.shape[0]
    assert q.shape == (B, P) and r.shape == (B, P + W)
    assert q.dtype == r.dtype == np.uint8
    assert n.dtype == m.dtype == lo.dtype == np.int32
    np.testing.assert_array_equal(fs, np.arange(B) % 2 == 1)
    for b in range(B):
        assert not q[b, n[b]:].any() and not r[b, m[b]:].any()
    return q, r, n, m, lo


def test_random_pieces_are_pieces_the_aligner_sends():
    """At every bucket of the aligner: lengths inside the bucket, the
    padding zero, bases from ACGT, lo as the driver's _band_lo sets it."""
    from mashmap_tpu_torch.align import driver
    for P, W in driver.PIECE_BUCKETS:
        q, r, n, m, lo = _check_piece_shapes(dp_pieces(P, W, 16, 3), P, W)
        assert (n >= 1).all() and (n <= P).all()
        assert (m >= 1).all() and (m <= P + W - 1).all()
        for b in range(q.shape[0]):
            assert set(q[b, :n[b]].tobytes()) <= set(b"ACGT")
            piece = types.SimpleNamespace(q=q[b, :n[b]], r=r[b, :m[b]])
            assert lo[b] == driver._band_lo(piece, W)


def test_edge_pieces_cover_the_listed_edges():
    """n = 1 and n = P, m = 0 and m = P + W - 1, m < n, and lo both
    wholly before j = 0 and wholly past m, at every bucket."""
    from mashmap_tpu_torch.align import driver
    for P, W in driver.PIECE_BUCKETS:
        q, r, n, m, lo = _check_piece_shapes(dp_edge_pieces(P, W), P, W)
        assert n.min() == 1 and n.max() == P
        assert m.min() == 0 and m.max() == P + W - 1
        assert (m < n).any()
        assert (lo + W <= 0).any() and (lo > m).any()
