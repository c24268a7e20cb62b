"""Batched banded unit-cost edit-distance DP with its end state and
traceback: the CUDA kernel, its plain version, and the host DP and
tracebacks.

Counterpart of ``mashmap_tpu/align/kernel.py``. The aligner
decomposes every mapping into small independent pieces (inter-anchor
gaps, free-start heads, free-end tails). Each piece is a banded
Needleman-Wunsch/Sellers DP over unit costs.

With unit costs the in-row dependency ``D[i][j] = min(..., D[i][j-1] + 1)``
is a min-plus prefix scan:

    D[i][j] = min_{j' <= j} ( M[i][j'] + (j - j') )

where ``M[i][j] = min(diag, up)`` depends only on row ``i-1``: each row is
elementwise candidates from the previous row, a cumulative minimum of
``M - j``, then ``+ j``. Band coordinates: cell (i, j) lives at band
column ``c = j - i - lo``, so the band covers diagonals ``lo .. lo+W-1``.

``banded_dp_trace`` computes, for a batch of pieces of one bucket, what
the JAX package computes on the host from the DP rows: each piece's end
state (``ok``, the edit distance ``e``, ``end_j``), the start column of
its path and the path's op codes in reverse order (``traceback_batch``'s
preference: diagonal, then up, then left), one record a piece
(``trace_layout``, ``unpack_trace``). On CUDA tensors it launches
``csrc/banded_dp_trace.cu`` (built with nvcc for sm_90a at first use,
loaded with ctypes), which keeps the rows on the card and stores a 2-bit
traceback code a cell instead; on CPU tensors it runs the plain version
``banded_dp_trace_torch``: the rows by ``banded_dp_rows_torch`` (the JAX
function's row loop as torch ops), the end state as torch ops, and the
walk of ``traceback_batch``. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..kernels import nvcc

INF = 1 << 20
# row values saturate at CAP (uint16); anything >= CAP means "unreachable"
CAP = (1 << 16) - 1
WIDTHS = (64, 128, 256, 1024)   # band widths the kernel takes (buckets)

# a piece's record: six int32 (these fields), then its ops in reverse
# order, padded with OP_PAD to a multiple of 8 bytes
RES_OK, RES_E, RES_END_J, RES_START_J, RES_DEAD, RES_LEN = range(6)
RES_BYTES = 24
OP_PAD = 255

LAUNCHES = 0                              # kernel launches (not ref calls)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "banded_dp_trace.cu")
_LIB = None


def ptxas_log_path() -> str:
    """Where load_library keeps nvcc's -Xptxas -v report of this source."""
    return nvcc.ptxas_log_path(_SRC, "banded_dp_trace")


def load_library():
    """Build csrc/banded_dp_trace.cu with nvcc (once per source version)
    and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(nvcc.build(_SRC, "banded_dp_trace"))
    lib.banded_dp_trace_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.banded_dp_trace_launch.restype = ctypes.c_int
    lib.banded_dp_trace_scratch.argtypes = [ctypes.c_int] * 3
    lib.banded_dp_trace_scratch.restype = ctypes.c_longlong
    _LIB = lib
    return lib


def trace_layout(p_len: int, width: int) -> tuple[int, int]:
    """(the longest path a record holds, P + W + 1; the record's bytes)."""
    limit = p_len + width + 1
    return limit, RES_BYTES + -(-limit // 8) * 8


def unpack_trace(rec: np.ndarray, p_len: int, width: int):
    """Views of (B, record bytes) uint8 records: (res (B, 6) int32 with
    the RES_* fields, ops (B, P + W + 1) uint8, reversed and padded)."""
    limit, _ = trace_layout(p_len, width)
    return (rec.view(np.int32)[:, :RES_BYTES // 4],
            rec[:, RES_BYTES:RES_BYTES + limit])


def _check(q, r, n, m, lo, free_start, free_end, p_len):
    B = q.shape[0]
    for name, x, dt, shape in (
            ("q", q, torch.uint8, (B, p_len)), ("r", r, torch.uint8, None),
            ("n", n, torch.int32, (B,)), ("m", m, torch.int32, (B,)),
            ("lo", lo, torch.int32, (B,)),
            ("free_start", free_start, torch.bool, (B,)),
            ("free_end", free_end, torch.bool, (B,))):
        if x.dtype != dt:
            raise TypeError(f"banded_dp_trace: {name} must be {dt}, got "
                            f"{x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"banded_dp_trace: {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"banded_dp_trace: {name} must be contiguous")
        if x.device != q.device:
            raise ValueError(f"banded_dp_trace: {name} is on {x.device}, q "
                             f"on {q.device}")
    if r.dim() != 2 or r.shape[0] != B or r.shape[1] < 1:
        raise ValueError(f"banded_dp_trace: r must be (B, R>=1), got "
                         f"{tuple(r.shape)}")


def banded_dp_trace(q: torch.Tensor, r: torch.Tensor, n: torch.Tensor,
                    m: torch.Tensor, lo: torch.Tensor,
                    free_start: torch.Tensor, free_end: torch.Tensor, *,
                    p_len: int, width: int) -> torch.Tensor:
    """End state and traceback of a batch of banded alignment pieces.

    q (B, P) uint8 query bytes, padded; r (B, R) uint8 target bytes,
    padded; n, m (B,) int32 true lengths (n <= P, m < R); lo (B,) int32
    lowest band diagonal (j - i); free_start (B,) bool: row 0 all zero
    (free target prefix); free_end (B,) bool: the path ends at the first
    argmin of row n, else at j = m. Returns (B, record bytes) uint8 on
    q's device, one record a piece (``unpack_trace``): ok (in band,
    e < CAP and e <= the band's slack), e, end_j, start_j (the path's
    column in row 0; 0 unless ok), a dead-end flag, the path's length,
    and its op codes from the end back to row 0. Pieces that are not ok
    have no path.
    """
    global LAUNCHES
    _check(q, r, n, m, lo, free_start, free_end, p_len)
    if q.device.type == "cpu":
        return banded_dp_trace_torch(q, r, n, m, lo, free_start, free_end,
                                     p_len=p_len, width=width)
    if q.device.type != "cuda":
        raise ValueError(f"banded_dp_trace: unsupported device {q.device}")
    if width not in WIDTHS:
        raise ValueError(f"banded_dp_trace: width {width} not in {WIDTHS}")
    B = q.shape[0]
    limit, nbytes = trace_layout(p_len, width)
    out = torch.empty((B, nbytes), dtype=torch.uint8, device=q.device)
    if B == 0:
        return out
    lib = load_library()
    # the codes' device scratch (W = 256, 1024; the others keep them in
    # shared memory)
    scratch = lib.banded_dp_trace_scratch(B, p_len, width)
    codes = (torch.empty(scratch, dtype=torch.uint8, device=q.device)
             if scratch else None)
    err = lib.banded_dp_trace_launch(
        q.data_ptr(), r.data_ptr(), n.data_ptr(), m.data_ptr(),
        lo.data_ptr(), free_start.data_ptr(), free_end.data_ptr(),
        None if codes is None else codes.data_ptr(), out.data_ptr(), B,
        p_len, r.shape[1], width,
        limit, nbytes, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_dp_trace kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out


def banded_dp_rows_torch(q, r, n, m, lo, free_start, *, p_len: int,
                         width: int) -> torch.Tensor:
    """The DP rows of the plain version: the JAX function's row loop
    (kernel.py:64-104 there), one row after another, in int32 with
    ``torch.gather`` and ``torch.cummin``. Returns (B, P+1, W) uint16:
    rows[b, i, c] = D[i][j=i+lo+c], saturated at CAP; cells outside
    [0, m] or otherwise unreachable hold CAP. All P rows, as the JAX
    function returns them."""
    dev = q.device
    B = q.shape[0]
    R = r.shape[1]
    c = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    lo_ = lo[:, None]
    m_ = m[:, None]
    inf = torch.tensor(INF, dtype=torch.int32, device=dev)
    cap = torch.tensor(CAP, dtype=torch.int32, device=dev)
    rows = torch.empty((B, p_len + 1, width), dtype=torch.uint16,
                       device=dev)
    j0 = lo_ + c
    row = torch.where((j0 >= 0) & (j0 <= m_),
                      torch.where(free_start[:, None],
                                  torch.zeros_like(j0), j0), inf)
    rows[:, 0] = torch.minimum(row, cap).to(torch.uint16)
    rr = r.to(torch.int32)
    inf_col = torch.full((B, 1), INF, dtype=torch.int32, device=dev)
    for i in range(1, p_len + 1):
        j = i + lo_ + c
        rj = torch.gather(rr, 1, torch.clamp(j - 1, 0, R - 1).long())
        sub = (q[:, i - 1].to(torch.int32)[:, None] != rj).to(torch.int32)
        diag = row + sub
        up = torch.cat([row[:, 1:], inf_col], dim=1) + 1
        M = torch.minimum(diag, up)
        at_j0 = j == 0
        M = torch.where(at_j0, up, M)
        M = torch.where(((j >= 1) & (j <= m_)) | at_j0, M, inf)
        t = torch.cummin(M - c, dim=1).values
        row = torch.minimum(t + c, inf)
        row = torch.where((j >= 0) & (j <= m_), row, inf)
        rows[:, i] = torch.minimum(row, cap).to(torch.uint16)
    return rows


def banded_dp_trace_torch(q, r, n, m, lo, free_start, free_end, *,
                          p_len: int, width: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the rows by
    ``banded_dp_rows_torch``, the end state as torch ops (the JAX
    package's host code, mashmap_tpu/align/driver.py:277-293 there), and
    the walk of ``traceback_batch`` over the rows on the host. Same
    arguments and records as ``banded_dp_trace``."""
    dev = q.device
    B = q.shape[0]
    # as int16 bits: CUDA tensors take no advanced indexing in uint16
    rows = banded_dp_rows_torch(q, r, n, m, lo, free_start, p_len=p_len,
                                width=width).view(torch.int16)
    ar = torch.arange(B, device=dev)
    row_n = rows[ar, n.long()].to(torch.int32) & 0xFFFF       # (B, W)
    cc = torch.arange(width, dtype=torch.int32, device=dev)[None, :] \
        + (n + lo)[:, None]                                   # j per column
    row_n = torch.where((cc >= 0) & (cc <= m[:, None]), row_n, CAP)
    c_end = torch.where(free_end, torch.argmin(row_n, dim=1).to(torch.int32),
                        m - n - lo)
    in_band = (c_end >= 0) & (c_end < width)
    e = torch.where(in_band, row_n.gather(
        1, c_end.clamp(0, width - 1).long()[:, None])[:, 0], CAP)
    d = m - n
    slack = torch.minimum(torch.clamp(d, max=0) - lo,
                          (lo + width - 1) - torch.clamp(d, min=0))
    ok = in_band & (e < CAP) & (e <= slack)
    end_j = torch.where(free_end, c_end + n + lo, m)

    limit, nbytes = trace_layout(p_len, width)
    rec = np.full((B, nbytes), OP_PAD, np.uint8)
    res, ops = unpack_trace(rec, p_len, width)
    res[:] = 0
    ok, end_j = ok.cpu().numpy(), end_j.cpu().numpy()
    res[:, RES_OK] = ok
    res[:, RES_E] = e.cpu().numpy()
    res[:, RES_END_J] = end_j
    sel = np.nonzero(ok)[0]
    if len(sel):
        q, r, n, lo = (x.cpu().numpy()[sel] for x in (q, r, n, lo))
        # the walk reads rows 0..n of the pieces that are ok
        rows = rows[torch.from_numpy(sel).to(dev), :int(n.max()) + 1]
        ops_rev, pos, i, j, dead = _walk_rows(
            rows.cpu().numpy().view(np.uint16), q, r, n, lo, end_j[sel],
            limit)
        ops[sel] = ops_rev
        res[sel, RES_START_J] = j
        res[sel, RES_DEAD] = dead | (i > 0)
        res[sel, RES_LEN] = pos
    return torch.from_numpy(rec).to(dev)


def dp_inputs(q, r, n, m, lo, free_start, free_end, device) -> list:
    """``banded_dp_trace``'s tensors on ``device`` from numpy arrays (q, r
    uint8; n, m, lo int32; free_start, free_end bool)."""
    dts = (np.uint8, np.uint8, np.int32, np.int32, np.int32, np.bool_,
           np.bool_)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)
            for a, dt in zip((q, r, n, m, lo, free_start, free_end), dts)]


def banded_dp_rows_host(q, r, n, m, lo, free_start, *, p_len, width):
    """numpy twin of ``banded_dp_rows_torch`` (bit-identical rows); an
    oracle for the tests."""
    B = q.shape[0]
    INF32 = np.int32(INF)
    rows = np.empty((B, p_len + 1, width), np.uint16)
    c = np.arange(width, dtype=np.int32)
    j0 = lo[:, None] + c
    row = np.where((j0 >= 0) & (j0 <= m[:, None]),
                   np.where(free_start[:, None], 0, j0),
                   INF32).astype(np.int32)
    rows[:, 0] = np.minimum(row, CAP)
    bidx = np.arange(B)[:, None]
    rr = r.astype(np.int32)
    for i in range(1, p_len + 1):
        j = i + lo[:, None] + c
        rj = rr[bidx, np.clip(j - 1, 0, r.shape[1] - 1)]
        sub = (q[:, i - 1][:, None] != rj).astype(np.int32)
        diag = row + sub
        up = np.concatenate(
            [row[:, 1:], np.full((B, 1), INF32)], axis=1) + 1
        M = np.minimum(diag, up)
        at_j0 = j == 0
        M = np.where(at_j0, up, M)
        valid = (j >= 1) & (j <= m[:, None])
        M = np.where(valid | at_j0, M, INF32)
        t = np.minimum.accumulate(M - c, axis=1)
        row = np.minimum(t + c, INF32)
        row = np.where((j >= 0) & (j <= m[:, None]), row, INF32)
        rows[:, i] = np.minimum(row, CAP)
    return rows


# ---------------------------------------------------------------------------
# host-side reference DP + traceback
# ---------------------------------------------------------------------------


def full_dp_host(q: np.ndarray, r: np.ndarray,
                 free_start: bool) -> np.ndarray:
    """Unbanded host DP (numpy, O(nm)) — oracle for kernel tests and
    the route for pieces whose band would exceed the largest bucket.

    Uses the same min-plus prefix-scan row update as the device kernel:
    D[i][j] = min_{j'<=j} (cand[j'] + j - j') with cand[0] = D[i][0].
    """
    n, m = len(q), len(r)
    jj = np.arange(m + 1, dtype=np.int32)
    D = np.zeros((n + 1, m + 1), dtype=np.int32)
    D[0, :] = 0 if free_start else jj
    for i in range(1, n + 1):
        prev = D[i - 1]
        sub = (q[i - 1] != r).astype(np.int32)
        cand = np.minimum(prev[:-1] + sub, prev[1:] + 1)   # cols 1..m
        ext = np.concatenate(([prev[0] + 1], cand))        # col 0 = up move
        D[i] = np.minimum.accumulate(ext - jj) + jj
    return D


def _walk_rows(rows, q, r, n, lo, end_j, maxlen):
    """The traceback's walk over DP rows, every piece in lockstep, for at
    most maxlen steps: from (n, end_j) to row 0, preferring the diagonal
    (match/sub), then up (query-only, 'I'), then left (target-only, 'D').

    Returns (ops_rev (B, maxlen) uint8, the ops from the end backwards,
    padded with OP_PAD; pos, the ops each piece wrote; i and j where each
    piece stopped (i = 0 when it reached row 0); dead, the pieces stopped
    at a cell with no predecessor)."""
    B, _, W = rows.shape
    i = n.astype(np.int64).copy()
    j = end_j.astype(np.int64).copy()
    ops_rev = np.full((B, maxlen), OP_PAD, np.uint8)
    pos = np.zeros(B, np.int64)
    dead = np.zeros(B, bool)
    rr = r.astype(np.int16)
    qq = q.astype(np.int16)

    for _ in range(maxlen):
        active = (i > 0) & ~dead
        if not active.any():
            break
        a = np.nonzero(active)[0]
        ia, ja = i[a], j[a]
        c = (ja - ia - lo[a]).astype(np.int64)
        v = rows[a, ia, c].astype(np.int32)
        jpos = np.maximum(ja - 1, 0)
        sub = (qq[a, ia - 1] != rr[a, jpos]).astype(np.int32)
        dv = rows[a, ia - 1, c].astype(np.int32)
        diag = (ja >= 1) & (dv + sub == v)
        cu = np.minimum(c + 1, W - 1)
        uv = rows[a, ia - 1, cu].astype(np.int32)
        up = ~diag & (c + 1 < W) & (uv + 1 == v)
        cl = np.maximum(c - 1, 0)
        lv = rows[a, ia, cl].astype(np.int32)
        left = ~diag & ~up & (c >= 1) & (ja >= 1) & (lv + 1 == v)
        moved = diag | up | left
        dead[a[~moved]] = True
        a, ia, ja, diag, up, left, sub = (
            x[moved] for x in (a, ia, ja, diag, up, left, sub))
        op = np.where(diag, np.where(sub == 1, OP_SUB, OP_MATCH),
                      np.where(up, OP_INS, OP_DEL)).astype(np.uint8)
        ops_rev[a, pos[a]] = op
        pos[a] += 1
        i[a] = ia - (diag | up)
        j[a] = ja - (diag | left)
    return ops_rev, pos, i, j, dead


def traceback_batch(rows, q, r, n, m, lo, free_start, end_j):
    """Vectorized traceback for a whole bucket batch at once.

    Walks every piece's band in lockstep (``_walk_rows``). Preference
    order matches `traceback_band`: diagonal (match/sub), then up
    (query-only, 'I'), then left (target-only, 'D'). A piece that stops at
    a cell with no predecessor raises AssertionError.

    Returns (ops_list, start_j_array): ops in forward order per piece.
    """
    B, _, W = rows.shape
    ops_rev, pos, _, j, dead = _walk_rows(rows, q, r, n, lo, end_j,
                                          rows.shape[1] + W + 1)
    if dead.any():
        raise AssertionError(
            f"traceback dead end in pieces {np.nonzero(dead)[0][:4]} (band "
            f"too narrow?)")
    ops_list = []
    for b in range(B):
        o = ops_rev[b, :pos[b]][::-1]
        if not free_start[b] and j[b] > 0:
            o = np.concatenate(
                [np.full(j[b], OP_DEL, np.uint8), o])
            j[b] = 0
        ops_list.append(np.ascontiguousarray(o))
    return ops_list, j.astype(np.int64)


# op codes, matching edlib's move codes (src/common/edlib.h:69-72).
# Letter semantics verified EMPIRICALLY against the reference binary's
# output (the edlib.h comments invert them): in the emitted CIGAR,
# 'I' consumes the QUERY only and 'D' consumes the TARGET only — the
# standard SAM convention.
OP_MATCH = 0      # consumes query + target
OP_INS = 1        # 'I': consumes QUERY only
OP_DEL = 2        # 'D': consumes TARGET only
OP_SUB = 3        # mismatch, consumes both


def traceback_band(rows: np.ndarray, q: np.ndarray, r: np.ndarray,
                   n: int, m: int, lo: int, free_start: bool,
                   end_j: int) -> tuple[np.ndarray, int]:
    """Trace one piece's path from (n, end_j) back to row 0.

    Args:
      rows: (P+1, W) uint16 band rows from the kernel (piece's slice).
      end_j: target end column to start from (== m for global pieces; the
        argmin over row n for free-end pieces).

    Returns:
      (ops, start_j): ops is the edit path as op codes in forward order;
      start_j is the target column where the path enters row 0 (> 0 only
      meaningful for free_start pieces; global pieces reach j=0).
    """
    W = rows.shape[1]
    ops = []
    i, j = n, end_j
    while i > 0:
        c = j - i - lo
        if not 0 <= c < W:
            raise AssertionError(f"traceback left the band: {(i, j, lo, W)}")
        v = int(rows[i, c])
        # candidate predecessors (preference: diag-match, diag-sub, up, left)
        if j >= 1:
            dv = int(rows[i - 1, c])
            sub = int(q[i - 1] != r[j - 1])
            if dv + sub == v:
                ops.append(OP_MATCH if sub == 0 else OP_SUB)
                i, j = i - 1, j - 1
                continue
        uc = c + 1
        if uc < W and int(rows[i - 1, uc]) + 1 == v:
            ops.append(OP_INS)      # up move: query base, no target base
            i -= 1
            continue
        lc = c - 1
        if lc >= 0 and j >= 1 and int(rows[i, lc]) + 1 == v:
            ops.append(OP_DEL)      # left move: target base, no query base
            j -= 1
            continue
        raise AssertionError(
            f"traceback dead end at i={i} j={j} v={v} (band too narrow?)")
    if not free_start:
        # consume remaining target prefix
        ops.extend([OP_DEL] * j)
        start_j = 0
    else:
        start_j = j
    ops.reverse()
    return np.asarray(ops, dtype=np.uint8), start_j
