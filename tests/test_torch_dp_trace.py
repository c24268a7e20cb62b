"""The aligner's fused DP, end state and traceback (banded_dp_trace) on
the CPU, tolerance 0 throughout:

- the plain version's per-piece results, through the port's
  ``driver._run_bucket``, equal what the JAX package's ``_run_bucket``
  leaves on its pieces (ops, start_j, end_j, edit, the retry set);
- a numpy model of the CUDA kernel (``_model_kernel``: its thread and
  warp decomposition of the row scan, the deferred up move of each warp's
  last column, the 2-bit codes in the kernel's layout, the end state by
  keys, and a walk over the codes alone) writes the plain version's
  records byte for byte and ``traceback_batch``'s paths, at every bucket.
  Change the model first when the kernel's design changes.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from mashmap_tpu.align import driver as jax_driver
from mashmap_tpu_torch.align import driver
from mashmap_tpu_torch.align import kernel as K

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_dp_pieces import (dp_edge_pieces, dp_pieces,  # noqa: E402
                                  free_ends)
from port_fixtures import one_torch_thread  # noqa: E402,F401

BIG = 0x3FFFFFFF
# threads a piece at each kernel width (csrc/banded_dp_trace.cu,
# DP_TRACE_CASES): a warp at 64 and 128, 4 and 8 warps at 256 and 1024
KERNEL_THREADS = {64: 32, 128: 32, 256: 128, 1024: 256}


def _divergent_pieces(P, W, B, seed):
    """Pieces whose target is unrelated to the query: e above the band's
    slack, so the bucket sends them to the retry queue."""
    rng = np.random.default_rng(seed)
    q, r, n, m, lo, fs = dp_pieces(P, W, B, seed)
    for b in range(B):
        q[b, :n[b]] = rng.integers(65, 69, n[b])
        r[b, :m[b]] = rng.integers(65, 69, m[b])
    return q, r, n, m, lo, fs


def _arrays(kind, P, W):
    if kind == "random":
        return dp_pieces(P, W, 24, P + W)
    if kind == "edges":
        return dp_edge_pieces(P, W)
    return _divergent_pieces(P, W, 8, 5)


def _pieces(mod, arrays, fe):
    q, r, n, m, _, fs = arrays
    return [mod._Piece(0, b, q[b, :n[b]].copy(), r[b, :m[b]].copy(),
                       bool(fs[b]), bool(fe[b])) for b in range(len(n))]


@pytest.mark.parametrize("P,W", [(64, 32), (256, 64)])
@pytest.mark.parametrize("kind", ["random", "edges", "divergent"])
def test_run_bucket_matches_jax(P, W, kind):
    """The port's _run_bucket (the plain version's records, unpacked on
    the host) leaves on each piece what the JAX package's leaves, and
    queues the same pieces for the 2W retry."""
    arrays = _arrays(kind, P, W)
    fe = free_ends(len(arrays[2]))
    mine = _pieces(driver, arrays, fe)
    ref = _pieces(jax_driver, arrays, fe)
    st = driver.AlignStats()
    retry = driver._run_bucket(mine, P, W, torch.device("cpu"), st)
    jretry = jax_driver._run_bucket(ref, P, W)
    assert [p.seg_idx for p in retry] == [p.seg_idx for p in jretry]
    assert st.dp_calls == 1 and st.d2h_ms == 0.0
    if kind == "divergent":
        assert len(retry) > 0
    if kind == "random":
        assert len(retry) < len(mine)
    for a, b in zip(mine, ref):
        assert a.min_w == b.min_w
        if b.ops is None:
            assert a.ops is None
            continue
        np.testing.assert_array_equal(a.ops, b.ops)
        assert (a.start_j, a.end_j, a.edit) == (b.start_j, b.end_j, b.edit)


def test_dead_end_record_raises(monkeypatch):
    """A record with the dead-end flag raises traceback_batch's
    AssertionError; nothing traces back on the host instead."""
    P, W = 64, 32
    arrays = dp_pieces(P, W, 8, 3)
    pieces = _pieces(driver, arrays, free_ends(8))
    real = driver._dp_trace

    def dead(*args):
        rec = real(*args)
        res, _ = K.unpack_trace(rec, P, W)
        res[np.nonzero(res[:, K.RES_OK])[0][0], K.RES_DEAD] = 1
        return rec

    monkeypatch.setattr(driver, "_dp_trace", dead)
    with pytest.raises(AssertionError, match="traceback dead end"):
        driver._run_bucket(pieces, P, W, torch.device("cpu"),
                           driver.AlignStats())


def test_model_geometry_is_the_kernels():
    """The model's threads a piece are the kernel's launch table."""
    with open(K._SRC) as fh:
        cases = re.findall(r"^\s*X\((\d+), (\d+), (\d+)\)", fh.read(), re.M)
    assert {int(w): int(nt) for w, nt, _ in cases} == KERNEL_THREADS
    assert tuple(KERNEL_THREADS) == K.WIDTHS


def _model_kernel(q, r, n, m, lo, fs, fe, P, W):
    """numpy model of csrc/banded_dp_trace.cu, one row at a time over all
    pieces. Returns (records (B, bytes) uint8 as the kernel writes them,
    rows (B, P+1, W) int32: row i of piece b where i <= n[b], else -1)."""
    NT = KERNEL_THREADS[W]
    cpt, nw = W // NT, NT // 32
    B, R = r.shape
    c = np.arange(W)
    first = np.arange(nw) * 32 * cpt          # each warp's first column
    last = first + 32 * cpt - 1               # and its last
    # columns whose up move waits for the barrier: each warp's last, but
    # the last warp's (whose prev[c + 1] is prev[W] = INF)
    deferred = np.isin(c, last[:-1])
    in_m = lambda j: (j >= 0) & (j <= m[:, None])  # noqa: E731
    sat = lambda x: np.minimum(x, K.CAP)  # noqa: E731

    j0 = lo[:, None] + c
    prev = np.where(in_m(j0), np.where(fs[:, None], 0, j0), K.INF)
    rows = np.full((B, P + 1, W), -1, np.int64)
    rows[:, 0] = prev
    codes = np.zeros((B, P, W // 32, 2), np.uint64)
    lane_bit = np.uint64(1) << np.arange(32, dtype=np.uint64)
    for i in range(1, int(n.max(initial=0)) + 1):
        live = i <= n
        j = i + lo[:, None] + c
        rj = r[np.arange(B)[:, None], np.clip(j - 1, 0, R - 1)]
        sub = (q[:, i - 1][:, None] != rj).astype(np.int64)
        prev_next = np.concatenate(
            [prev[:, 1:], np.full((B, 1), K.INF)], axis=1)
        d = np.where((j >= 1) & (j <= m[:, None]), prev + sub, K.INF)
        u_pre = np.where(in_m(j), np.where(deferred, K.INF, prev_next) + 1,
                         K.INF)
        M_pre = np.minimum(d, u_pre)
        # a thread's serial scan, then the lanes' inclusive scan
        s_pre = np.minimum.accumulate((M_pre - c).reshape(B, NT, cpt), axis=2)
        incl = np.minimum.accumulate(s_pre[:, :, -1].reshape(B, nw, 32),
                                     axis=2)
        carry = np.concatenate([np.full((B, nw, 1), BIG), incl[:, :, :-1]],
                               axis=2)
        # after the barrier: warp l's total with its last column's up move
        # (row i-1 at warp l+1's first column), carried over warps < w
        jl = i + lo[:, None] + last
        ul = np.concatenate([prev[:, first[1:]] + 1,
                             np.full((B, 1), K.INF + 1)], axis=1)
        tl = np.minimum(incl[:, :, -1], np.where(in_m(jl), ul, K.INF) - last)
        cw = np.concatenate([np.full((B, 1), BIG),
                             np.minimum.accumulate(tl, axis=1)[:, :-1]],
                            axis=1)
        carry = np.minimum(carry, cw[:, :, None]).reshape(B, NT)
        # the deferred column takes its up move, and its thread rescans
        M = np.where(deferred & in_m(j), np.minimum(M_pre, prev_next + 1),
                     M_pre)
        s = np.minimum.accumulate((M - c).reshape(B, NT, cpt), axis=2)
        row = np.minimum(np.minimum(carry[:, :, None], s).reshape(B, W) + c,
                         K.INF)
        row = np.where(in_m(j), row, K.INF)
        # row[c - 1] of a thread's first column, from its carry-in
        c0 = np.arange(NT) * cpt
        left0 = np.where(in_m(j[:, c0] - 1),
                         np.minimum(carry + c0 - 1, K.INF), K.INF)
        left = np.concatenate([np.full((B, 1), K.INF), row[:, :-1]], axis=1)
        left[:, c0] = left0
        v = sat(row)
        diag = (j >= 1) & (sat(prev) + sub == v)
        up = ~diag & (c + 1 < W) & (sat(prev_next) + 1 == v)
        lft = ~diag & ~up & (c >= 1) & (j >= 1) & (sat(left) + 1 == v)
        code = np.where(diag, 1, np.where(up, 2, np.where(lft, 3, 0)))
        # bit planes: (warp, column of the thread) pairs, one bit a lane
        cl = code.reshape(B, nw, 32, cpt).transpose(0, 1, 3, 2)
        for plane in (0, 1):
            bits = ((cl >> plane) & 1).astype(np.uint64)
            words = (bits * lane_bit).sum(axis=3).reshape(B, W // 32)
            codes[live, i - 1, :, plane] = words[live]
        prev = np.where(live[:, None], row, prev)
        rows[live, i] = row[live]

    # end state: the first argmin of row n (free end) or the cell at j = m
    j = n[:, None] + lo[:, None] + c
    v = np.where(in_m(j), sat(prev), K.CAP)
    key = np.where(fe[:, None] | (c == (m - n - lo)[:, None]),
                   (v << 11) | c, BIG).min(axis=1)
    in_band = key != BIG
    e = np.where(in_band, key >> 11, K.CAP)
    d = m - n
    slack = np.minimum(np.minimum(0, d) - lo, (lo + W - 1) - np.maximum(0, d))
    ok = in_band & (e < K.CAP) & (e <= slack)
    end_j = np.where(fe, (key & 2047) + n + lo, m)

    limit, nbytes = K.trace_layout(P, W)
    rec = np.full((B, nbytes), K.OP_PAD, np.uint8)
    res, ops = K.unpack_trace(rec, P, W)
    res[:] = 0
    res[:, K.RES_OK], res[:, K.RES_E], res[:, K.RES_END_J] = ok, e, end_j
    for b in np.nonzero(ok)[0]:
        # the walk reads the codes alone, by the kernel's index
        i, jj, length, dead = int(n[b]), int(end_j[b]), 0, 0
        while i > 0:
            cc = jj - i - lo[b]
            if length >= limit or not 0 <= cc < W:
                dead = 1
                break
            th = cc // cpt
            word = codes[b, i - 1, (th >> 5) * cpt + cc - th * cpt]
            sh = np.uint64(th & 31)
            cd = int((word[0] >> sh) & np.uint64(1)) \
                | int((word[1] >> sh) & np.uint64(1)) << 1
            if cd == 1:
                op = (K.OP_SUB if q[b, i - 1] != r[b, min(max(jj - 1, 0),
                                                          R - 1)]
                      else K.OP_MATCH)
                i, jj = i - 1, jj - 1
            elif cd == 2:
                op, i = K.OP_INS, i - 1
            elif cd == 3:
                op, jj = K.OP_DEL, jj - 1
            else:
                dead = 1
                break
            ops[b, length] = op
            length += 1
        res[b, K.RES_START_J] = jj
        res[b, K.RES_DEAD] = dead
        res[b, K.RES_LEN] = length
    return rec, rows


def _model_case(P, W, kind):
    arrays = (dp_pieces(P, W, 6 if P > 1024 else 12, 7 * P + W)
              if kind == "random" else dp_edge_pieces(P, W))
    fe = free_ends(len(arrays[2]))
    return arrays, fe, _model_kernel(*arrays, fe, P, W)


@pytest.mark.parametrize("P,W", driver.PIECE_BUCKETS)
@pytest.mark.parametrize("kind", ["random", "edges"])
def test_code_model_matches_plain_version(P, W, kind):
    """The model's rows (up to each piece's n) are the plain version's,
    and its records are the plain version's, byte for byte."""
    arrays, fe, (rec, rows) = _model_case(P, W, kind)
    n = arrays[2]
    want_rows = K.banded_dp_rows_host(*arrays, p_len=P, width=W)
    for b in range(len(n)):
        np.testing.assert_array_equal(
            np.minimum(rows[b, :n[b] + 1], K.CAP), want_rows[b, :n[b] + 1])
    want = K.banded_dp_trace(*K.dp_inputs(*arrays, fe, "cpu"), p_len=P,
                             width=W).numpy()
    np.testing.assert_array_equal(rec, want)
    res, _ = K.unpack_trace(rec, P, W)
    assert res[:, K.RES_OK].any() and not res[:, K.RES_DEAD].any()


@pytest.mark.parametrize("P,W", driver.PIECE_BUCKETS)
def test_code_model_gives_traceback_batch(P, W):
    """The walk over the 2-bit codes alone gives traceback_batch's ops
    and start_j (after the host's reversal and free-start prefix)."""
    arrays, fe, (rec, _) = _model_case(P, W, "random")
    q, r, n, m, lo, fs = arrays
    res, ops = K.unpack_trace(rec, P, W)
    sel = np.nonzero(res[:, K.RES_OK])[0]
    assert len(sel) >= 2
    rows = K.banded_dp_rows_host(*arrays, p_len=P, width=W)
    want_ops, want_start = K.traceback_batch(
        rows[sel], q[sel], r[sel], n[sel], m[sel], lo[sel], fs[sel],
        res[sel, K.RES_END_J].astype(np.int64))
    for k, b in enumerate(sel):
        o = ops[b, :res[b, K.RES_LEN]][::-1]
        start = int(res[b, K.RES_START_J])
        if not fs[b] and start > 0:
            o = np.concatenate([np.full(start, K.OP_DEL, np.uint8), o])
            start = 0
        np.testing.assert_array_equal(o, want_ops[k])
        assert start == want_start[k]
