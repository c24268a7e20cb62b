"""Port theta (kernels/theta.py, kernels/winnow.py) vs the JAX package.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against the same plain version in tests/test_torch_cuda.py.
"""

import functools
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mashmap_tpu.kernels import winnow as jw
from mashmap_tpu.kernels.winnow_pallas import theta_chunk_pallas, C_T
from mashmap_tpu_torch.kernels import theta as tt
from mashmap_tpu_torch.kernels import winnow as tw

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RSENT = tt.RSENT


def _blocks(seed, C, s, s_b, invalid_frac, alphabet=None):
    rng = np.random.default_rng(seed)
    hi = alphabet or 50 * s
    cur = rng.integers(0, hi, (C, s_b)).astype(np.int32)
    nxt = rng.integers(0, hi, (C, s_b)).astype(np.int32)
    cur[rng.random((C, s_b)) < invalid_frac] = RSENT
    nxt[rng.random((C, s_b)) < invalid_frac] = RSENT
    return cur, nxt


# the fast shapes of tests/test_winnow_pallas.py
@pytest.mark.parametrize("seed,s,s_b,invalid_frac", [
    (0, 20, 300, 0.1),
    (1, 30, 513, 0.0),      # s_b not a multiple of any segment length
    (2, 8, 64, 0.5),        # heavy invalidity
])
def test_theta_ref_matches_pallas_and_xla(seed, s, s_b, invalid_frac):
    cur, nxt = _blocks(seed, C_T, s, s_b, invalid_frac)
    ours = tt.theta_chunk(torch.from_numpy(cur), torch.from_numpy(nxt),
                          s, s_b).numpy()
    pallas = np.asarray(theta_chunk_pallas(
        jnp.asarray(cur), jnp.asarray(nxt), s, s_b, interpret=True))
    xla = np.asarray(jw._theta_chunk(jnp.asarray(cur), jnp.asarray(nxt),
                                     s, s_b))
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, xla)


def test_theta_scan_matches_bruteforce():
    """theta of every window of several contigs (block decomposition +
    chunked rows) against the brute-force definition, including a
    contig with fewer than s distinct hashes per window."""
    rng = np.random.default_rng(5)
    s, span = 6, 40
    contigs = [rng.integers(0, 500, n).astype(np.int32)
               for n in (40, 137, 300)]
    contigs.append(rng.integers(0, 4, 90).astype(np.int32))
    contigs[1][rng.random(137) < 0.2] = RSENT
    contigs.append(np.arange(20, dtype=np.int32))       # no full window
    got = tw.theta_scan_ranks([torch.from_numpy(c) for c in contigs],
                              s, span)
    assert got[-1] is None
    for c, g in zip(contigs[:-1], got[:-1]):
        bf = jw.window_thresholds_bruteforce(
            c.astype(np.uint64), c != RSENT, s, span)
        want = np.where(bf == jw.SENTINEL, RSENT, bf).astype(np.int32)
        np.testing.assert_array_equal(g.numpy(), want)


def test_rank_reduce_matches_jax():
    rng = np.random.default_rng(9)
    h = rng.integers(0, 2 ** 63, 3000, dtype=np.uint64) * np.uint64(2)
    h[rng.integers(0, 3000, 500)] = h[rng.integers(0, 3000, 500)]
    h[rng.random(3000) < 0.1] = jw.SENTINEL
    j_r, j_lut = jw._rank_reduce(jnp.asarray(h))
    t_r, t_lut = tw._rank_reduce(torch.from_numpy(h.view(np.int64)))
    np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
    np.testing.assert_array_equal(t_lut.numpy().view(np.uint64),
                                  np.asarray(j_lut))


@pytest.mark.parametrize("s", [5, 600])
def test_cpu_tensor_runs_plain_version_without_launch(s):
    """On a CPU tensor the wrapper runs the plain version at any s: no
    launch count moves (on a CUDA tensor it launches theta.cu, or
    theta_wide.cu above S_MAX)."""
    cur, nxt = _blocks(4, 4, s, 37, 0.3)
    before = (tt.LAUNCHES, tt.WIDE_LAUNCHES)
    got = tt.theta_chunk(torch.from_numpy(cur), torch.from_numpy(nxt),
                         s, 37)
    assert (tt.LAUNCHES, tt.WIDE_LAUNCHES) == before
    ref = tt.theta_chunk_ref(torch.from_numpy(cur), torch.from_numpy(nxt),
                             s, 37)
    assert torch.equal(got, ref)


# sketch sizes above S_MAX (theta_wide.cu's on the card): 680 is the auto
# s of a 6 Mbp reference at --pi 78, 1110 that of a 3.1 Gbp one at --pi 80
@pytest.mark.parametrize("seed,s,s_b,invalid_frac", [
    (30, 513, 700, 0.02),     # the first s above S_MAX
    (31, 600, 1500, 0.5),     # heavy invalidity
    (32, 1100, 1400, 0.0),
    (33, 600, 400, 0.0),      # S_B < s: every window holds fewer than s
])
def test_theta_ref_matches_xla_above_s_max(seed, s, s_b, invalid_frac):
    cur, nxt = _blocks(seed, 8, s, s_b, invalid_frac)
    ours = tt.theta_chunk(torch.from_numpy(cur), torch.from_numpy(nxt),
                          s, s_b).numpy()
    xla = np.asarray(jw._theta_chunk(jnp.asarray(cur), jnp.asarray(nxt),
                                     s, s_b))
    np.testing.assert_array_equal(ours, xla)
    if s_b < s:
        assert (ours == RSENT).all()
    else:
        assert (ours != RSENT).any()


def test_theta_ref_matches_pallas_above_s_max():
    cur, nxt = _blocks(34, C_T, 513, 560, 0.05)
    ours = tt.theta_chunk(torch.from_numpy(cur), torch.from_numpy(nxt),
                          513, 560).numpy()
    pallas = _pallas_theta(34, 513, 560, 128, 0.05, None, None)
    np.testing.assert_array_equal(ours, pallas)


@pytest.mark.parametrize("s", [513, 600, 1100])
def test_theta_scan_above_s_max_matches_bruteforce(s):
    """Every window of a few contigs at s > S_MAX (a contig with RSENT
    runs, one whose windows hold fewer than s distinct ranks, one with no
    full window) against the brute-force definition."""
    rng = np.random.default_rng(s)
    span = s + 150
    contigs = [rng.integers(0, 40 * s, n).astype(np.int32)
               for n in (span, 2 * span + 37, 3 * span)]
    contigs[1][rng.random(len(contigs[1])) < 0.1] = RSENT
    contigs.append(rng.integers(0, s // 2, span + 90).astype(np.int32))
    contigs.append(np.arange(span - 1, dtype=np.int32))
    got = tw.theta_scan_ranks([torch.from_numpy(c) for c in contigs],
                              s, span)
    assert got[-1] is None
    assert (got[-2].numpy() == RSENT).all()
    for c, g in zip(contigs[:-1], got[:-1]):
        bf = jw.window_thresholds_bruteforce(
            c.astype(np.uint64), c != RSENT, s, span)
        want = np.where(bf == jw.SENTINEL, RSENT, bf).astype(np.int32)
        np.testing.assert_array_equal(g.numpy(), want)


# --- CPU model of the CUDA kernel's schedule -------------------------------
#
# kernels/csrc/theta.cu runs two kernels. A walks each row once per
# direction: backward over cur it stores the suffix set at every K-th
# offset and the eviction log ev[j] (what inserting cur[j] pushed out of
# slot s-1, RSENT if the set was not full; -1 where the insert was a
# no-op); forward over nxt it stores the prefix set at every K-th offset.
# B runs one independent chain per (row, segment): from the segment's
# two checkpoints it steps the suffix set forward by removing cur[j] and
# appending ev[j] (the inverse of A's insert) and inserts nxt[j] into the
# prefix set. theta is merged in full at the segment's first offset;
# after that only a change at or below theta can move it, and then by
# one place in the union (to its predecessor or successor; under an
# RSENT theta, to the union's largest once it holds s ranks), except
# where the prefix insert pushed theta itself out of the prefix set:
# there the next offset merges in full. The model below is that schedule
# in plain Python.


def _model_insert(st, v, s):
    """Insert v into the sorted distinct list st (at most s long); returns
    the value pushed out of slot s-1 (RSENT if st was not full), or -1
    where the insert is a no-op."""
    last = st[s - 1] if len(st) == s else RSENT
    if v >= last or v in st:
        return -1
    st.insert(int(np.searchsorted(st, v)), v)
    del st[s:]
    return last


def _model_merge(a, b, s):
    u = sorted(set(a) | set(b))
    return u[s - 1] if len(u) >= s else RSENT


def _model_step_theta(th, ucnt, suf, pre, x, s_low, v, p_low, s_chg, s):
    """(theta, ucnt) after a step whose changes at or below th are s_low
    (x left the suffix set) and p_low (v entered the prefix set), given
    the sets after the step: the union lost x unless the prefix set holds
    it, gained v unless the suffix set held it, and theta moves by the
    net count (or to its predecessor where x was theta and v replaced
    it). Under an RSENT theta neither set is truncated, and ucnt, the
    union's size, tells when it reaches s (theta is then its largest)."""
    rem = s_low and x not in pre
    add = p_low and v not in suf and not (s_chg and v == x)
    net = int(add) - int(rem)
    if th == RSENT:
        ucnt += net
        return (max(suf + pre) if ucnt == s else RSENT), ucnt
    if net == 1 or (net == 0 and rem and x == th):
        return max(y for y in suf + pre if y < th), ucnt
    if net == -1:
        th = min((y for y in suf + pre if y > th), default=RSENT)
        return th, (s - 1 if th == RSENT else ucnt)
    return th, ucnt


def _model_merge_count(suf, pre, s):
    """theta.cu's merge: theta and the distinct union's size."""
    return _model_merge(suf, pre, s), len(set(suf) | set(pre))


def _model_serial_checkpoints(cur, nxt, s, K):
    """theta.cu's kernel A: the serial walks of one row. Returns ck_s,
    ck_p (the sets at every K-th offset) and the suffix walk's ev."""
    s_b = len(cur)
    n_seg = -(-s_b // K)
    ev = np.full(s_b, -1, dtype=np.int64)
    ck_s, ck_p = [None] * n_seg, [None] * n_seg
    st = []
    for j in range(s_b - 1, -1, -1):            # suffix
        ev[j] = _model_insert(st, int(cur[j]), s)
        if j % K == 0:
            ck_s[j // K] = list(st)
    st = []
    for j in range(s_b):                        # prefix
        if j % K == 0:
            ck_p[j // K] = list(st)
        _model_insert(st, int(nxt[j]), s)
    return ck_s, ck_p, ev


def _model_theta_row(cur, nxt, s, K, merge=None, step=None, scan=False,
                     delta=False):
    """theta of one block row by the kernel's schedule; returns (theta,
    counts): full merges, incremental updates, offsets where a set
    changed. merge and step are the set operations (theta.cu's by
    default; a chain that steps two sorted arrays below). scan takes the
    checkpoints from theta_wide.cu's scan over segments and each chain's
    ev from its own backward walk (_model_chain_prologue), in place of
    theta.cu's serial walks. delta is theta_wide.cu's kernel B: the scan's
    checkpoints, then each chain's theta from its base and its delta
    (_model_chain_base, _model_chain_delta); counts are then one row a
    chain of _model_chain_delta's counts."""
    s_b = len(cur)
    n_seg = -(-s_b // K)
    if delta:
        ck_s = _model_scan_checkpoints(cur, s, K, suffix=True)
        ck_p = _model_scan_checkpoints(nxt, s, K, suffix=False)
        out = np.empty(s_b, dtype=np.int64)
        counts = np.zeros((n_seg, 4), dtype=np.int64)
        for m in range(n_seg):
            base = _model_chain_base(ck_s, ck_p, m, s)
            out[m * K:m * K + K], counts[m] = _model_chain_delta(
                cur, nxt, base, m, s, K)
        return out, counts
    merge = merge or _model_merge_count
    step = step or _model_step_theta
    if scan:
        ck_s = _model_scan_checkpoints(cur, s, K, suffix=True)
        ck_p = _model_scan_checkpoints(nxt, s, K, suffix=False)
    else:
        ck_s, ck_p, ev = _model_serial_checkpoints(cur, nxt, s, K)
    out = np.empty(s_b, dtype=np.int64)
    counts = np.zeros(3, dtype=np.int64)        # merges, updates, changed
    for m in range(n_seg):                      # kernel B, one chain each
        if scan:
            suf, ev_m = _model_chain_prologue(cur, ck_s, m, s, K)
        else:
            suf, ev_m = list(ck_s[m]), ev[m * K:m * K + K]
        pre = list(ck_p[m])
        th, ucnt, stale = RSENT, 0, True
        for j in range(m * K, min(m * K + K, s_b)):
            if stale:
                (th, ucnt), stale = merge(suf, pre, s), False
                counts[0] += 1
            out[j] = th
            x, e = int(cur[j]), int(ev_m[j - m * K])
            s_chg = e != -1
            if s_chg:                           # undo A's insert of x
                suf.remove(x)
                if e != RSENT:
                    suf.append(e)
            v = int(nxt[j])
            p_out = _model_insert(pre, v, s)
            p_chg = p_out != -1
            counts[2] += s_chg or p_chg
            s_low, p_low = s_chg and x <= th, p_chg and v <= th
            if not (s_low or p_low):
                continue
            if th != RSENT and p_out == th:
                stale = True
                continue
            th, ucnt = step(th, ucnt, suf, pre, x, s_low, v, p_low, s_chg,
                            s)
            counts[1] += 1
    return out, counts


def _model_theta(cur, nxt, s, K, merge=None, step=None, scan=False,
                 delta=False):
    rows = [_model_theta_row(c, n, s, K, merge, step, scan, delta)
            for c, n in zip(cur, nxt)]
    counts = [r[1] for r in rows]
    return (np.stack([r[0] for r in rows]).astype(np.int32),
            np.concatenate(counts) if delta else sum(counts))


@pytest.mark.parametrize("seed,s,s_b,K,invalid_frac,alphabet", [
    (10, 6, 100, 128, 0.1, None),    # S_B below K (the kernel's K)
    (11, 9, 300, 128, 0.0, None),    # S_B not a multiple of K
    (12, 5, 1, 32, 0.0, None),       # S_B = 1
    (13, 1, 150, 32, 0.2, None),     # s = 1
    (14, 30, 100, 32, 0.0, 20),      # s above the distinct count
    (15, 3, 130, 32, 0.0, 4),        # 4-letter alphabet: long duplicate runs
    (16, 7, 96, 32, 1.0, None),      # all-RSENT rows
    (17, 10, 160, 64, 0.5, None),    # half RSENT
    (18, 16, 256, 64, 0.02, None),   # S_B a multiple of K
    (20, 8, 300, 32, 0.05, 40),      # alphabet near 2s: sets share values
])
def test_schedule_model_matches_ref_and_pallas(seed, s, s_b, K,
                                               invalid_frac, alphabet):
    """The kernel's two-kernel schedule, modelled on the CPU, equals the
    plain version and the Pallas kernel (interpret mode) exactly, and
    merges or updates theta at no more offsets than the segments' first
    plus those where a set changed."""
    cur, nxt = _blocks(seed, C_T, s, s_b, invalid_frac, alphabet)
    got, (merges, updates, changed) = _model_theta(cur, nxt, s, K)
    ref = tt.theta_chunk_ref(torch.from_numpy(cur), torch.from_numpy(nxt),
                             s, s_b).numpy()
    pallas = np.asarray(theta_chunk_pallas(
        jnp.asarray(cur), jnp.asarray(nxt), s, s_b, interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    assert merges + updates <= changed + C_T * -(-s_b // K)


@pytest.mark.parametrize("seed,s,s_b,alphabet,invalid_frac", [
    (0, 12, 60, 1000, 0.8), (0, 6, 40, 40, 0.8), (1, 8, 100, 30, 0.9)])
def test_schedule_model_takes_every_step(monkeypatch, seed, s, s_b,
                                         alphabet, invalid_frac):
    """Sparse windows (about s valid ranks each), where theta's step
    takes every outcome: to the predecessor, to the successor, down to
    RSENT and back up from it, staying, and theta itself replaced."""
    seen, model_step = set(), _model_step_theta

    def step(th, ucnt, suf, pre, x, s_low, v, p_low, s_chg, s):
        new, ucnt2 = model_step(th, ucnt, suf, pre, x, s_low, v, p_low,
                                s_chg, s)
        if th == RSENT:
            seen.add("up from RSENT" if new != RSENT else "RSENT")
        elif new == RSENT:
            seen.add("down to RSENT")
        elif x == th and s_low and x not in pre and new < th:
            seen.add("replaced")
        else:
            seen.add("down" if new < th else "up" if new > th else "stay")
        return new, ucnt2

    monkeypatch.setattr(f"{__name__}._model_step_theta", step)
    cur, nxt = _blocks(seed, C_T, s, s_b, invalid_frac, alphabet)
    got, _ = _model_theta(cur, nxt, s, 32)
    ref = tt.theta_chunk_ref(torch.from_numpy(cur), torch.from_numpy(nxt),
                             s, s_b).numpy()
    pallas = np.asarray(theta_chunk_pallas(
        jnp.asarray(cur), jnp.asarray(nxt), s, s_b, interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    assert seen == {"RSENT", "up from RSENT", "down to RSENT", "replaced",
                    "down", "up", "stay"}


@pytest.mark.parametrize("seed,s,s_b,alphabet", [
    (24, 12, 300, None), (25, 5, 130, 8)])
def test_schedule_model_on_contig_end_rows(seed, s, s_b, alphabet):
    """A contig's last block row has no next block (nxt all RSENT), so
    its last windows hold fewer than s distinct ranks and theta is RSENT
    there: the model steps theta exactly in and out of RSENT."""
    cur, _ = _blocks(seed, C_T, s, s_b, 0.05, alphabet)
    nxt = np.full_like(cur, RSENT)
    got, (merges, updates, changed) = _model_theta(cur, nxt, s, 64)
    ref = tt.theta_chunk_ref(torch.from_numpy(cur), torch.from_numpy(nxt),
                             s, s_b).numpy()
    pallas = np.asarray(theta_chunk_pallas(
        jnp.asarray(cur), jnp.asarray(nxt), s, s_b, interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    assert (ref == RSENT).any()
    assert merges == C_T * -(-s_b // 64)     # segment starts only


@pytest.mark.parametrize("seed,s,alphabet", [
    (19, 20, None), (21, 12, 30), (22, 2, 5), (23, 40, 90)])
def test_schedule_model_on_longer_rows(seed, s, alphabet):
    """Longer rows: on random ranks a set changes at a minority of
    offsets, and full merges are fewer still."""
    cur, nxt = _blocks(seed, 4, s, 2000, 0.02, alphabet)
    got, (merges, updates, changed) = _model_theta(cur, nxt, s, tt.SEG_K)
    ref = tt.theta_chunk_ref(torch.from_numpy(cur), torch.from_numpy(nxt),
                             s, 2000).numpy()
    np.testing.assert_array_equal(got, ref)
    assert merges + updates <= changed + 4 * -(-2000 // tt.SEG_K)
    if alphabet is None:
        assert changed < 0.2 * cur.size
        assert merges < 0.25 * changed


# --- CPU model of a chain that steps two sorted arrays ---------------------
#
# The schedule above with each set as a sorted array of N = wide_set_len(s)
# ints, RSENT past its elements, the set operations done as a warp would
# do them on arrays in memory (theta_wide.cu's chains take theta from a
# base and a delta instead, modelled further down). Membership, positions
# and theta's neighbours are a branch-free binary search (count_lt); the
# merge walks one set's slots 32 at a time (a warp), ranks each live x in
# the distinct union by g + 1 + #(other <= x) - (a ballot's running count
# of x's set's elements that the other holds), and stops at the set's
# first RSENT or once a rank reaches s, leaving the union's size
# incomplete: the kernel reads it only while theta is RSENT, when no rank
# reached s. The model below is those operations in plain Python.


def _wide_array(st, s):
    return np.array(list(st) + [RSENT] * (tt.wide_set_len(s) - len(st)),
                    dtype=np.int64)


def _wide_count_lt(Y, x):
    """count_lt: #(Y < x) by the kernel's probes, and whether x is in Y."""
    pos, step = 0, len(Y) >> 1
    while step:
        pos += step if Y[pos + step - 1] < x else 0
        step >>= 1
    pos += 1 if Y[pos] < x else 0
    return pos, bool(pos < len(Y) and Y[pos] == x)


def _wide_rank_side(X, Y, s):
    best, n_live, n_dup = RSENT, 0, 0
    for base in range(0, s, 32):
        g = np.arange(base, base + 32)
        x = np.where(g < s, X[g], RSENT)
        live = x != RSENT
        lt, in_y = np.zeros(32, np.int64), np.zeros(32, bool)
        for i in np.nonzero(live)[0]:
            lt[i], in_y[i] = _wide_count_lt(Y, x[i])
        dup = live & in_y
        f = g + 1 + lt + in_y - (n_dup + np.cumsum(dup))
        if (live & (f == s)).any():
            best = int(x[live & (f == s)][0])
        n_dup += int(dup.sum())
        n_live += int(live.sum())
        if (live & (f >= s)).any() or not live.all():
            break
    return best, n_live, n_dup


def _wide_merge(suf, pre, s):
    a, b = _wide_array(suf, s), _wide_array(pre, s)
    th_a, n_a, dup_a = _wide_rank_side(a, b, s)
    th_b, n_b, _ = _wide_rank_side(b, a, s)
    return min(th_a, th_b), n_a + n_b - dup_a


def _wide_step_theta(th, ucnt, suf, pre, x, s_low, v, p_low, s_chg, s):
    S, P = _wide_array(suf, s), _wide_array(pre, s)

    def pred(Y, t):
        i, _ = _wide_count_lt(Y, t)
        return int(Y[i - 1]) if i > 0 else -1

    def succ(Y, t):
        i, f = _wide_count_lt(Y, t)
        i += f
        return int(Y[i]) if i < len(Y) else RSENT

    rem = s_low and not _wide_count_lt(P, x)[1]
    add = p_low and not _wide_count_lt(S, v)[1] and not (s_chg and v == x)
    net = int(add) - int(rem)
    if th == RSENT:
        ucnt += net
        return (RSENT if ucnt < s
                else max(pred(S, RSENT), pred(P, RSENT))), ucnt
    if net == 1 or (net == 0 and rem and x == th):
        return max(pred(S, th), pred(P, th)), ucnt
    if net == -1:
        th = min(succ(S, th), succ(P, th))
        return th, (s - 1 if th == RSENT else ucnt)
    return th, ucnt


@pytest.mark.parametrize("seed,s,s_b,K,invalid_frac,alphabet", [
    (40, 40, 300, 32, 0.05, None),    # two warp chunks, the second partial
    (41, 64, 256, 64, 0.0, 150),      # s a multiple of 32, shared ranks
    (42, 33, 100, 32, 0.0, 20),       # fewer distinct ranks than s
    (43, 70, 400, 128, 0.5, None),    # half RSENT
    (44, 45, 200, 32, 0.8, 1000),     # sparse: theta in and out of RSENT
    (45, 100, 130, 32, 0.02, 8),      # 8-letter alphabet
])
def test_wide_model_matches_ref(seed, s, s_b, K, invalid_frac, alphabet):
    """The two-array set operations, modelled on the CPU inside the
    schedule, give the plain version's theta exactly, with the schedule's
    merges and steps (as theta.cu's model counts them)."""
    cur, nxt = _blocks(seed, 6, s, s_b, invalid_frac, alphabet)
    got, counts = _model_theta(cur, nxt, s, K, _wide_merge, _wide_step_theta)
    want, want_counts = _model_theta(cur, nxt, s, K)
    ref = tt.theta_chunk_ref(torch.from_numpy(cur), torch.from_numpy(nxt),
                             s, s_b).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(want, ref)
    np.testing.assert_array_equal(counts, want_counts)


def test_wide_model_at_the_first_wide_s():
    """The two-array model at s = 513 (17 warp chunks, N = 1024), on
    contig end rows too (nxt all RSENT), with theta.cu's serial
    checkpoints and with theta_wide.cu's scan and chain prologues; and
    theta_wide.cu's base and delta on the same rows."""
    cur, nxt = _blocks(46, 2, 513, 700, 0.02)
    nxt[1] = RSENT
    ref = tt.theta_chunk_ref(torch.from_numpy(cur), torch.from_numpy(nxt),
                             513, 700).numpy()
    for scan in (False, True):
        got, _ = _model_theta(cur, nxt, 513, 128, _wide_merge,
                              _wide_step_theta, scan)
        np.testing.assert_array_equal(got, ref)
    got, _ = _model_theta(cur, nxt, 513, 128, delta=True)
    np.testing.assert_array_equal(got, ref)
    _assert_scan_matches_serial(cur, nxt, 513, 128)
    assert (ref[1] == RSENT).any() and (ref != RSENT).any()


# --- CPU model of theta_wide.cu's scan over segments -----------------------
#
# theta_wide.cu's kernel A builds the checkpoints without walking a row
# offset by offset. One block of K threads per (row, direction) visits
# the row's segments in order (backward over cur, forward over nxt) and
# merges each into the running set T, the previous checkpoint: each
# thread loads one rank of the segment (RSENT past S_B) and keeps it if
# it is not RSENT, no thread before it holds it (K broadcast reads) and T
# does not hold it (a binary search of T); each kept rank counts the kept
# ones below it (K more reads) and takes that place in a sorted list of
# them; then T[i] goes to i + #(kept < T[i]) (a binary search of that
# list), a kept u to #(T < u) + #(kept < u), and only what lands below s
# is written. Bottom-s of a union is associative, so each checkpoint is the
# serial walk's. Kernel B then makes its own eviction log: from
# ck_s[m+1] (empty for the row's last segment) it walks its segment
# backward with the serial insert, which ends at ck_s[m]. The model below
# is those steps in plain Python.


def _model_scan_step(T, seg, s):
    """Kernel A's merge of one segment's ranks (K of them, RSENT-padded)
    into the sorted set T (at most s ranks): bottom-s of the distinct
    union, placed by ranks as the block places it."""
    v = np.asarray(seg, dtype=np.int64)
    K = len(v)
    Ta = _wide_array(T, s)
    kept, t_lt = np.zeros(K, bool), np.zeros(K, np.int64)
    for t in range(K):
        if v[t] == RSENT or (v[:t] == v[t]).any():
            continue                            # RSENT, or not the first
        t_lt[t], found = _wide_count_lt(Ta, v[t])
        kept[t] = not found
    kv = np.where(kept, v, RSENT)               # the block's shared array
    ks = np.sort(kv)                            # kept ranks, RSENT-padded
    size = min(s, len(T) + int(kept.sum()))
    new = np.full(size, -1, dtype=np.int64)
    for t in np.nonzero(kept)[0]:
        p = t_lt[t] + int((kv < v[t]).sum())
        if p < s:
            assert new[p] == -1
            new[p] = v[t]
    for i, x in enumerate(T):
        p = i + _wide_count_lt(ks, x)[0]
        if p < s:
            assert new[p] == -1
            new[p] = x
    assert (new != -1).all()                    # every slot written once
    return [int(x) for x in new]


def _model_scan_checkpoints(vals, s, K, suffix):
    """Kernel A's scan over one row's segments: ck[m] is the bottom-s
    distinct ranks of vals[m*K:] (suffix) or of vals[:m*K] (prefix,
    ck[0] empty), each the merge of a segment into the one before."""
    s_b = len(vals)
    n_seg = -(-s_b // K)
    padded = np.full(n_seg * K, RSENT, dtype=np.int64)
    padded[:s_b] = vals
    ck, T = [None] * n_seg, []
    for m in (range(n_seg - 1, -1, -1) if suffix else range(n_seg)):
        if not suffix:
            ck[m] = T
        if suffix or m + 1 < n_seg:
            T = _model_scan_step(T, padded[m * K:m * K + K], s)
        if suffix:
            ck[m] = T
    return ck


def _model_chain_prologue(cur, ck_s, m, s, K):
    """Kernel B's prologue on chain m: from ck_s[m+1] (empty for the
    row's last segment) the serial insert walks the segment backward.
    Returns the set it ends at (S(m*K)) and the segment's ev."""
    j0, j1 = m * K, min(m * K + K, len(cur))
    st = list(ck_s[m + 1]) if m + 1 < len(ck_s) else []
    ev = np.full(j1 - j0, -1, dtype=np.int64)
    for j in range(j1 - 1, j0 - 1, -1):
        ev[j - j0] = _model_insert(st, int(cur[j]), s)
    return st, ev


def _assert_scan_matches_serial(cur, nxt, s, K):
    """Per row: the scan's checkpoints are the serial walks' at every m,
    and each chain's prologue gives the serial ev and ends at ck_s[m]."""
    for c, n in zip(cur, nxt):
        ck_s, ck_p, ev = _model_serial_checkpoints(c, n, s, K)
        scan_s = _model_scan_checkpoints(c, s, K, suffix=True)
        assert scan_s == ck_s
        assert _model_scan_checkpoints(n, s, K, suffix=False) == ck_p
        for m in range(len(ck_s)):
            st, ev_m = _model_chain_prologue(c, scan_s, m, s, K)
            assert st == ck_s[m]
            np.testing.assert_array_equal(ev_m, ev[m * K:m * K + K])


# (seed, s, S_B, K, RSENT fraction, alphabet, blank segment)
SCAN_EDGES = [
    (50, 6, 100, 128, 0.1, None, None),    # S_B below K (the kernel's K)
    (51, 9, 300, 128, 0.0, None, None),    # S_B not a multiple of K
    (52, 5, 1, 32, 0.0, None, None),       # S_B = 1
    (53, 7, 96, 32, 1.0, None, None),      # all-RSENT rows
    (54, 12, 200, 32, 0.02, None, 1),      # an all-RSENT segment mid-row
    (55, 3, 130, 32, 0.0, 4, None),        # 4 letters: segments of duplicates
    (56, 20, 300, 32, 0.05, 40, None),     # alphabet near 2s: T holds the ranks
    (57, 30, 20, 32, 0.0, None, None),     # s above S_B
    (58, 40, 300, 32, 0.02, None, None),   # s above K
    (59, 150, 400, 128, 0.02, None, 3),    # s above K = 128, a blank last one
    (60, 64, 256, 64, 0.0, 150, None),     # S_B a multiple of K, s = K
]


def _scan_blocks(seed, C, s, s_b, K, invalid_frac, alphabet, blank):
    cur, nxt = _blocks(seed, C, s, s_b, invalid_frac, alphabet)
    if blank is not None:
        cur[:, blank * K:blank * K + K] = RSENT
        nxt[:, blank * K:blank * K + K] = RSENT
    return cur, nxt


@functools.lru_cache(maxsize=None)
def _pallas_theta(seed, s, s_b, K, invalid_frac, alphabet, blank):
    """The Pallas kernel (interpret mode) on _scan_blocks' C_T rows, once
    per edge for every test of this module that holds a model to it."""
    cur, nxt = _scan_blocks(seed, C_T, s, s_b, K, invalid_frac, alphabet,
                            blank)
    return np.asarray(theta_chunk_pallas(
        jnp.asarray(cur), jnp.asarray(nxt), s, s_b, interpret=True))


@pytest.mark.parametrize("seed,s,s_b,K,invalid_frac,alphabet,blank",
                         SCAN_EDGES)
def test_scan_checkpoints_match_serial_walk(seed, s, s_b, K, invalid_frac,
                                            alphabet, blank):
    """theta_wide.cu's kernel A (a scan over segments) gives the serial
    walk's suffix and prefix checkpoints at every m, and each chain's
    backward walk from ck_s[m+1] gives the serial eviction log and ends
    at ck_s[m]."""
    cur, nxt = _scan_blocks(seed, 6, s, s_b, K, invalid_frac, alphabet,
                            blank)
    _assert_scan_matches_serial(cur, nxt, s, K)


@pytest.mark.parametrize("seed,s,s_b,K,invalid_frac,alphabet,blank",
                         SCAN_EDGES)
def test_scan_model_matches_ref_and_pallas(seed, s, s_b, K, invalid_frac,
                                           alphabet, blank):
    """The whole wide model with the scan and the chain prologues (and
    theta_wide.cu's set operations) equals the plain version and the
    Pallas kernel (interpret mode) exactly, with the serial schedule's
    merges and steps."""
    cur, nxt = _scan_blocks(seed, C_T, s, s_b, K, invalid_frac, alphabet,
                            blank)
    got, counts = _model_theta(cur, nxt, s, K, _wide_merge,
                               _wide_step_theta, scan=True)
    _, want_counts = _model_theta(cur, nxt, s, K)
    ref = tt.theta_chunk_ref(torch.from_numpy(cur), torch.from_numpy(nxt),
                             s, s_b).numpy()
    pallas = _pallas_theta(seed, s, s_b, K, invalid_frac, alphabet, blank)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(counts, want_counts)


# --- CPU model of theta_wide.cu's kernel B: a base and a delta ------------
#
# For offset j of segment m (j0 = m*K, j1 = min(j0 + K, S_B)) two facts
# make theta a function of one read-only set and at most K ranks: bottom-s
# of a union is associative, and the s-th distinct rank of X U Y is the
# s-th of X U bottom_s(Y). So
#     theta(j) = s-th distinct rank of B_m U D(j),
#     B_m  = bottom_s(ck_s[m+1] U ck_p[m])    (cur[j1:] and nxt[:j0]),
#     D(j) = cur[j:j1] U nxt[j0:j]            (a multiset of j1 - j0 ranks).
# Kernel B builds B_m once per chain by a warp merge of the checkpoints:
# each round takes the next 32 slots of each, whose smallest 32 are the
# merge's next 32 (ck_s[m+1]'s copy first where both hold a rank); a rank
# goes to its lane plus the other window's ranks below it (at or below it
# for ck_p[m]'s), a ck_p[m] rank that the other window or the last
# ck_s[m+1] rank merged holds is dropped, the rest go to their places in
# the distinct union below s; RSENT fills the slots from its size up. Only D(j)'s useful ranks can move theta: v < B_m[s-1] and v not
# in B_m (B_m[s-1] is RSENT when B_m is short, so the one test also drops
# RSENT). D' holds them sorted and distinct, each with its count in D(j)
# and bless = #(B_m < v); its i-th entry has place i + 1 + bless in the
# union, so theta is the entry of place s, or else B_m[s-1-t], t the
# entries of place below s. A step from j to j+1 takes one cur[j] out of
# D(j) and puts nxt[j] in (nothing where the two are equal): a count
# moves, or an entry is deleted or inserted, and only then is theta
# recomputed. The model below is that in plain Python.


def _model_chain_base(ck_s, ck_p, m, s):
    """Kernel B's base B_m of chain m, the N slots of its one set:
    bottom-s of ck_s[m+1] (empty for the row's last segment) U ck_p[m],
    merged as the warp merges them, 32 slots of each checkpoint a round,
    RSENT past the union's size."""
    sp = 32 * -(-s // 32)
    lanes = np.arange(32)

    def slots(ck):
        x = np.full(sp + 32, RSENT, dtype=np.int64)
        x[:len(ck)] = ck
        return x

    A = slots(ck_s[m + 1] if m + 1 < len(ck_s) else [])
    P = slots(ck_p[m])
    out = np.full(tt.wide_set_len(s), -1, dtype=np.int64)
    ia = ip = size = 0
    last_a = RSENT
    while size < s:
        a, p = A[ia + lanes], P[ip + lanes]
        if a[0] == RSENT and p[0] == RSENT:
            break
        ra = np.searchsorted(p, a)              # P's window below a
        c = np.searchsorted(a, p)               # A's window below p
        in_a = (c < 32) & (a[c & 31] == p)
        dup = (p != RSENT) & (in_a | (p == last_a))
        qa, qp = lanes + ra, lanes + c + in_a   # places in this round
        da = size + qa - np.array([dup[:r].sum() for r in ra])
        dp = size + qp - (np.cumsum(dup) - dup)
        ta = (qa < 32) & (a != RSENT)
        tp = (qp < 32) & (p != RSENT) & ~dup
        for q, v in zip(np.r_[da[ta], dp[tp]], np.r_[a[ta], p[tp]]):
            if q < s:
                assert out[q] == -1             # one writer a slot
                out[q] = v
        n_a = int((qa < 32).sum())
        size += int(ta.sum() + tp.sum())
        if n_a:
            last_a = a[n_a - 1]
        ia += n_a
        ip += 32 - n_a
    size = min(size, s)
    assert (out[:size] != -1).all() and (out[size:] == -1).all()
    out[size:] = RSENT
    return out


def _model_delta_theta(D, base, s):
    """theta from D' and the base: the entry of place s, else
    B_m[s-1-t] for the t entries of place below s."""
    t = 0
    for i, (v, _, bless) in enumerate(D):
        r = i + 1 + bless
        if r == s:
            return v
        t += r < s
    return int(base[s - 1 - t])


def _model_chain_delta(cur, nxt, base, m, s, K):
    """Kernel B's walk of segment m from its base (N slots): theta at each
    of its offsets, and the chain's counts (the useful ranks of
    cur[j0:j1], D' inserts, D' deletes, D''s largest length)."""
    j0, j1 = m * K, min(m * K + K, len(cur))
    top = base[s - 1]

    def useful(v):
        bless, member = _wide_count_lt(base, v)
        return bool(v < top and not member), bless

    # D' at j0, as the warp builds it from the segment's useful cur ranks
    # compacted in offset order: a rank's first copy keeps it, its count
    # is its copies, its place the kept ranks below it
    stage = [(int(v), useful(int(v))) for v in cur[j0:j1]]
    stage = [(v, bless) for v, (ok, bless) in stage if ok]
    vals = [v for v, _ in stage]
    D = [None] * len(set(vals))
    for i, (v, bless) in enumerate(stage):
        if v not in vals[:i]:
            rk = len({u for u in vals if u < v})
            assert D[rk] is None
            D[rk] = [v, vals.count(v), bless]
    inserts = deletes = 0
    longest = len(D)
    th = _model_delta_theta(D, base, s)
    out = np.empty(j1 - j0, dtype=np.int64)
    for j in range(j0, j1):
        out[j - j0] = th
        x, v = int(cur[j]), int(nxt[j])
        if j + 1 == j1 or x == v:
            continue
        (x_ok, _), (v_ok, v_bless) = useful(x), useful(v)
        changed = False
        if x_ok:                                # one copy of x leaves
            i = int(np.searchsorted([d[0] for d in D], x))
            assert D[i][0] == x
            D[i][1] -= 1
            if D[i][1] == 0:
                del D[i]
                deletes += 1
                changed = True
        if v_ok:                                # one copy of v enters
            i = int(np.searchsorted([d[0] for d in D], v))
            if i < len(D) and D[i][0] == v:
                D[i][1] += 1
            else:
                D.insert(i, [v, 1, v_bless])
                inserts += 1
                changed = True
        longest = max(longest, len(D))
        if changed:
            th = _model_delta_theta(D, base, s)
    return out, (len(stage), inserts, deletes, longest)


# SCAN_EDGES, and (seed, s, S_B, K, RSENT fraction, alphabet, blank)
DELTA_EDGES = SCAN_EDGES + [
    (61, 100, 110, 32, 0.0, None, None),    # B_m short of s, the union not
    (62, 40, 45, 32, 0.0, 1 << 20, None),   # ... S_B just above s
    (34, 513, 560, 128, 0.05, None, None),  # the first s of theta_wide.cu
]


@pytest.mark.parametrize("seed,s,s_b,K,invalid_frac,alphabet,blank",
                         DELTA_EDGES)
def test_delta_model_matches_ref_and_pallas(seed, s, s_b, K, invalid_frac,
                                            alphabet, blank):
    """theta_wide.cu's kernel B, modelled as a base and a delta on the
    scan's checkpoints, equals the plain version and the Pallas kernel
    (interpret mode) exactly; no D' ever holds more than K entries, and
    each ends with its inserts less its deletes added."""
    cur, nxt = _scan_blocks(seed, C_T, s, s_b, K, invalid_frac, alphabet,
                            blank)
    got, counts = _model_theta(cur, nxt, s, K, delta=True)
    ref = tt.theta_chunk_ref(torch.from_numpy(cur), torch.from_numpy(nxt),
                             s, s_b).numpy()
    pallas = _pallas_theta(seed, s, s_b, K, invalid_frac, alphabet, blank)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    assert counts.shape == (C_T * -(-s_b // K), 4)
    assert (counts[:, 3] <= K).all() and (counts[:, 0] <= K).all()


@pytest.mark.parametrize("seed,s,s_b,K,invalid_frac,alphabet,blank",
                         DELTA_EDGES)
def test_chain_base_is_bottom_s_of_the_rest(seed, s, s_b, K, invalid_frac,
                                            alphabet, blank):
    """Each chain's base, placed by ranks from the two checkpoints, is
    bottom_s(cur[j1:] U nxt[:j0]) computed directly, RSENT past it."""
    cur, nxt = _scan_blocks(seed, 6, s, s_b, K, invalid_frac, alphabet,
                            blank)
    for c, n in zip(cur, nxt):
        ck_s = _model_scan_checkpoints(c, s, K, suffix=True)
        ck_p = _model_scan_checkpoints(n, s, K, suffix=False)
        for m in range(len(ck_s)):
            j0, j1 = m * K, min(m * K + K, s_b)
            rest = np.unique(np.concatenate([c[j1:], n[:j0]]))
            want = np.full(tt.wide_set_len(s), RSENT, dtype=np.int64)
            low = rest[rest != RSENT][:s]
            want[:len(low)] = low
            np.testing.assert_array_equal(
                _model_chain_base(ck_s, ck_p, m, s), want)


@pytest.mark.parametrize("seed,s,s_b,K,invalid_frac,alphabet,blank",
                         DELTA_EDGES)
def test_host_delta_counts_match_model(seed, s, s_b, K, invalid_frac,
                                       alphabet, blank):
    """chip_smoke.py's host count of kernel B's rule (vectorised over
    rows, from the checkpoints) gives the model's D' inserts, deletes and
    largest length a chain."""
    import chip_smoke
    cur, nxt = _scan_blocks(seed, 6, s, s_b, K, invalid_frac, alphabet,
                            blank)
    _, counts = _model_theta(cur, nxt, s, K, delta=True)
    ck = [[], []]
    for c, n in zip(cur, nxt):
        ck[0].append(_model_scan_checkpoints(c, s, K, suffix=True) + [[]])
        ck[1].append(_model_scan_checkpoints(n, s, K, suffix=False))
    ck_s, ck_p = ({m: np.stack([_wide_array(r[m], s)[:s] for r in rows])
                   for m in range(len(rows[0]))} for rows in ck)
    got = chip_smoke.delta_counts(cur, nxt, s, K, ck_s, ck_p)
    assert got["chains"] == len(counts)
    assert (got["delta_ins"], got["delta_del"], got["delta_top"]) == \
        tuple(int(x) for x in counts[:, 1:].sum(axis=0))
    assert got["delta_max"] == counts[:, 3].max()


@pytest.mark.parametrize("s,s_b,extra", [
    (130, 4982, 4982),                      # theta.cu: the eviction log
    (680, 4982, 0),                         # theta_wide.cu: none
    (16400, 17000, 133 * (1 << 15)),        # kernel B's bases in the scratch
])
def test_scratch_per_row_by_route(s, s_b, extra):
    """The kernels' scratch per row: the two sets' checkpoints, plus
    theta.cu's eviction log, or theta_wide.cu's bases (one a chain) where
    they live in the scratch; rows per launch follow from it."""
    sp, _, n_seg = tt.kernel_geometry(s, s_b)
    n = tt.scratch_ints_per_row(s, s_b)
    assert n == 2 * n_seg * sp + extra
    assert tt.theta_rows_per_launch(torch.device("cuda"), s, s_b) == \
        (1 << 30) // (4 * n)


def test_wrapper_rejects_bad_inputs():
    cur, nxt = _blocks(0, 2, 4, 16, 0.0)
    c, n = torch.from_numpy(cur), torch.from_numpy(nxt)
    with pytest.raises(TypeError):
        tt.theta_chunk(c.long(), n.long(), 4, 16)
    with pytest.raises(ValueError):
        tt.theta_chunk(c, n, 4, 17)
    with pytest.raises(ValueError):
        tt.theta_chunk(c, n, 0, 16)
    with pytest.raises(ValueError):
        tt.theta_chunk(c.t(), n.t(), 4, 2)

