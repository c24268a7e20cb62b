"""Port membership events (kernels/events.py) vs the JAX events_chunk.

The same packed buffer layout on both sides; contents beyond each
segment's count are unspecified, so only live prefixes are compared.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mashmap_tpu.index import builder as jb
from mashmap_tpu.kernels import events as je
from mashmap_tpu.kernels import winnow as jw
from mashmap_tpu_torch.kernels import events as te

RSENT = int(jw.RSENT)


def _random_case(rng, n, alphabet, s, s_b, n_frac=0.0):
    ranks = rng.integers(0, alphabet, n).astype(np.int32)
    if n_frac:
        ranks[rng.random(n) < n_frac] = RSENT
    strand = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int8)
    theta_u64 = jw.window_thresholds_bruteforce(
        ranks.astype(np.uint64), ranks != RSENT, s, s_b)
    theta = np.where(theta_u64 == jw.SENTINEL, RSENT,
                     theta_u64).astype(np.int32)
    return ranks, strand, theta


def _chunk_inputs(ranks, strand, theta, a0, chp):
    n = len(ranks)
    rv = np.full(chp, RSENT, np.int32)
    sv = np.zeros(chp, np.int8)
    th = np.full(chp, RSENT, np.int32)
    m = min(chp, n - a0)
    rv[:m], sv[:m] = ranks[a0:a0 + m], strand[a0:a0 + m]
    mw = max(0, min(chp, len(theta) - a0))
    th[:mw] = theta[a0:a0 + mw]
    return rv, sv, th


def _both(rv, sv, th, a0, base, n_local, n, n_w, s_b, caps):
    j = np.asarray(je.events_chunk(
        jnp.asarray(rv), jnp.asarray(sv), jnp.asarray(th), np.int32(a0),
        np.int32(base), np.int32(n_local), np.int32(n), np.int32(n_w),
        s_b, caps[0], caps[1]))
    t = te.events_chunk(torch.from_numpy(rv), torch.from_numpy(sv),
                        torch.from_numpy(th), a0, base, n_local, n, n_w,
                        s_b, caps[0], caps[1]).numpy()
    return j, t


def _lanes(buf, caps):
    """The live lanes of events_chunk's buffer, None on overflow."""
    head = buf[-4:]
    return (te.live_lanes(buf, head, *caps) if te.counts_fit(head, *caps)
            else None)


def _assert_same(j, t, caps):
    assert len(j) == len(t) == 4 * caps[0] + 2 * caps[1] + 4
    np.testing.assert_array_equal(j[-4:], t[-4:])
    lj, lt = _lanes(j, caps), _lanes(t, caps)
    assert (lj is None) == (lt is None)
    if lj is not None:
        for a, b in zip(lj, lt):
            np.testing.assert_array_equal(a, b)


# the cases of tests/test_events.py
@pytest.mark.parametrize("seed,n,alphabet,s,s_b,n_frac", [
    (0, 300, 64, 4, 50, 0.0),
    (1, 500, 16, 4, 50, 0.0),        # heavy repeats: many dups
    (2, 500, 1000, 8, 64, 0.1),      # invalid (N) positions
    (3, 2000, 40, 6, 128, 0.02),     # strand churn on repeats
    (4, 64, 8, 3, 64, 0.0),          # exactly one window
    (5, 4096, 2**30, 16, 500, 0.0),  # all-distinct hashes
])
def test_events_chunk_matches_jax(seed, n, alphabet, s, s_b, n_frac):
    rng = np.random.default_rng(seed)
    ranks, strand, theta = _random_case(rng, n, alphabet, s, s_b, n_frac)
    n_w = len(theta)
    # whole contig, exact and padded length
    for chp in (n, n + 7):
        rv, sv, th = _chunk_inputs(ranks, strand, theta, 0, chp)
        caps = te.events_caps(chp, s, s_b)
        _assert_same(*_both(rv, sv, th, 0, 0, n, n, n_w, s_b, caps), caps)
    # streaming: chunk cores with an s_b halo on each side
    ch = max(s_b, n // 3)
    for c0 in range(0, n, ch):
        a0 = max(0, c0 - s_b)
        chp = ch + 2 * s_b
        rv, sv, th = _chunk_inputs(ranks, strand, theta, a0, chp)
        caps = te.events_caps(chp, s, s_b)
        _assert_same(*_both(rv, sv, th, a0, c0 - a0, min(ch, n - c0), n,
                            n_w, s_b, caps), caps)


def test_overflow_flag():
    rng = np.random.default_rng(7)
    n, s_b = 512, 32
    ranks, strand, theta = _random_case(rng, n, 1 << 20, 8, s_b)
    rv, sv, th = _chunk_inputs(ranks, strand, theta, 0, n)
    caps = (8, 8)   # absurdly small: must flag overflow, not corrupt
    j, t = _both(rv, sv, th, 0, 0, n, n, len(theta), s_b, caps)
    assert t[-1] == 1 and j[-1] == 1
    assert _lanes(t, caps) is None
    _assert_same(j, t, caps)


def test_chunk_nonpow2_cap_exceeds_length():
    """Caps larger than the (non-pow2) chunk length keep every packed
    segment at its exact cap offset; the lanes pair and classify to the
    host oracle's intervals."""
    rng = np.random.default_rng(11)
    s, s_b, n = 60, 500, 5000
    ranks, strand, theta = _random_case(rng, n, 300, s, s_b, 0.05)
    n_w = len(theta)
    CHP = 6144                       # 1.5 * 2^12: grid, not pow2
    caps = te.events_caps(CHP, s, s_b)
    assert caps[0] > CHP, "shape must exercise cap > chunk length"
    rv, sv, th = _chunk_inputs(ranks, strand, theta, 0, CHP)
    j, t = _both(rv, sv, th, 0, 0, CHP, n, n_w, s_b, caps)
    _assert_same(j, t, caps)
    bh, bW, eh, eW, m_rk, m_pos = _lanes(t, caps)
    iv_hash, iv_wb, iv_we, _ = jb._pair_begin_end(
        bh, bW.astype(np.int64), eh, eW.astype(np.int64), n)
    sh, sb_, se, ss = jb.strand_classify(
        iv_hash, iv_wb, iv_we, m_pos.astype(np.int64), m_rk >> 1,
        ((m_rk & 1) * 2 - 1).astype(np.int64), n_w, s_b, n, np.int32)
    (hp, hb, he), (hmh, hmb, hme, hms) = jb.contig_minmer_intervals(
        ranks, ranks != RSENT, strand, theta, s_b, n_flush=n, sent=RSENT)
    for a, b in ((hp, iv_hash), (hb, iv_wb), (he, iv_we), (hmh, sh),
                 (hmb, sb_), (hme, se), (hms, ss)):
        np.testing.assert_array_equal(a, b)


def test_events_caps_match_jax():
    for chp, s, s_b in ((4096, 130, 4982), (6144, 60, 500),
                        (1 << 24, 398, 4982), (100, 8, 64)):
        assert te.events_caps(chp, s, s_b) == je.events_caps(chp, s, s_b)
