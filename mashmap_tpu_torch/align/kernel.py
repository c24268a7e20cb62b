"""Batched banded unit-cost edit-distance DP: the CUDA kernel, its plain
version, and the host DP and tracebacks.

Counterpart of ``mashmap_tpu/align/kernel.py``. The aligner
decomposes every mapping into small independent pieces (inter-anchor
gaps, free-start heads, free-end tails). Each piece is a banded
Needleman-Wunsch/Sellers DP over unit costs. ``banded_dp`` computes, for
a batch of pieces at once, every DP row inside the band so the host can
trace back a path.

With unit costs the in-row dependency ``D[i][j] = min(..., D[i][j-1] + 1)``
is a min-plus prefix scan:

    D[i][j] = min_{j' <= j} ( M[i][j'] + (j - j') )

where ``M[i][j] = min(diag, up)`` depends only on row ``i-1``: each row is
elementwise candidates from the previous row, a cumulative minimum of
``M - j``, then ``+ j``. Band coordinates: cell (i, j) lives at band
column ``c = j - i - lo``, so the band covers diagonals ``lo .. lo+W-1``.

``banded_dp`` launches ``csrc/banded_dp.cu`` on CUDA tensors (one block
per piece, the P dependent rows inside one launch; built with nvcc for
sm_90a at first use, loaded with ctypes) and runs the plain version
``banded_dp_rows_torch`` (the same row loop as torch ops) on CPU tensors.
There is no fallback between the two. ``banded_dp_rows`` is the aligner's
numpy-in, numpy-out form. The JAX function is a ``lax.scan`` that XLA
compiles into one device loop; as torch ops it would launch about 15 ops
per row, which is why the DP has a kernel.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..kernels import nvcc

INF = 1 << 20
# row values are returned as uint16; anything >= CAP means "unreachable"
CAP = (1 << 16) - 1
WIDTHS = (64, 128, 256, 1024)   # band widths the kernel takes (buckets)

LAUNCHES = 0                              # kernel launches (not ref calls)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "banded_dp.cu")
_LIB = None


def ptxas_log_path() -> str:
    """Where load_library keeps nvcc's -Xptxas -v report of this source."""
    return nvcc.ptxas_log_path(_SRC, "banded_dp")


def load_library():
    """Build csrc/banded_dp.cu with nvcc (once per source version) and
    load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(nvcc.build(_SRC, "banded_dp"))
    lib.banded_dp_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.banded_dp_launch.restype = ctypes.c_int
    _LIB = lib
    return lib


def _check(q, r, n, m, lo, free_start, p_len, width):
    B = q.shape[0]
    for name, x, dt, shape in (
            ("q", q, torch.uint8, (B, p_len)), ("r", r, torch.uint8, None),
            ("n", n, torch.int32, (B,)), ("m", m, torch.int32, (B,)),
            ("lo", lo, torch.int32, (B,)),
            ("free_start", free_start, torch.bool, (B,))):
        if x.dtype != dt:
            raise TypeError(f"banded_dp: {name} must be {dt}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"banded_dp: {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"banded_dp: {name} must be contiguous")
        if x.device != q.device:
            raise ValueError(f"banded_dp: {name} is on {x.device}, q on "
                             f"{q.device}")
    if r.dim() != 2 or r.shape[0] != B or r.shape[1] < 1:
        raise ValueError(f"banded_dp: r must be (B, R>=1), got "
                         f"{tuple(r.shape)}")


def banded_dp(q: torch.Tensor, r: torch.Tensor, n: torch.Tensor,
              m: torch.Tensor, lo: torch.Tensor, free_start: torch.Tensor,
              *, p_len: int, width: int) -> torch.Tensor:
    """All DP rows for a batch of banded alignment pieces.

    q (B, P) uint8 query bytes, padded; r (B, R) uint8 target bytes,
    padded; n, m (B,) int32 true lengths (n <= P, m <= R); lo (B,) int32
    lowest band diagonal (j - i); free_start (B,) bool: row 0 all zero
    (free target prefix). Returns (B, P+1, W) torch.uint16 on q's device:
    rows[b, i, c] = D[i][j=i+lo+c], saturated at CAP; cells outside
    [0, m] or otherwise unreachable hold CAP.
    """
    global LAUNCHES
    _check(q, r, n, m, lo, free_start, p_len, width)
    if q.device.type == "cpu":
        return banded_dp_rows_torch(q, r, n, m, lo, free_start,
                                    p_len=p_len, width=width)
    if q.device.type != "cuda":
        raise ValueError(f"banded_dp: unsupported device {q.device}")
    if width not in WIDTHS:
        raise ValueError(f"banded_dp: width {width} not in {WIDTHS}")
    B = q.shape[0]
    out = torch.empty((B, p_len + 1, width), dtype=torch.uint16,
                      device=q.device)
    if B == 0:
        return out
    lib = load_library()
    err = lib.banded_dp_launch(
        q.data_ptr(), r.data_ptr(), m.data_ptr(), lo.data_ptr(),
        free_start.data_ptr(), out.data_ptr(), B, p_len, r.shape[1], width,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_dp kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def banded_dp_rows_torch(q, r, n, m, lo, free_start, *, p_len: int,
                         width: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the JAX function's row loop
    (kernel.py:64-104 there), one row after another, in int32 with
    ``torch.gather`` and ``torch.cummin``. Same arguments and result."""
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


def dp_inputs(q, r, n, m, lo, free_start, device) -> list:
    """``banded_dp``'s tensors on ``device`` from numpy arrays (q, r
    uint8; n, m, lo int32; free_start bool)."""
    dts = (np.uint8, np.uint8, np.int32, np.int32, np.int32, np.bool_)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)
            for a, dt in zip((q, r, n, m, lo, free_start), dts)]


def banded_dp_rows(q: np.ndarray, r: np.ndarray, n: np.ndarray,
                   m: np.ndarray, lo: np.ndarray, free_start: np.ndarray, *,
                   p_len: int, width: int, device) -> np.ndarray:
    """``banded_dp`` on ``device`` for numpy inputs; returns the
    (B, P+1, W) uint16 rows as numpy for the host traceback."""
    t = dp_inputs(q, r, n, m, lo, free_start, torch.device(device))
    return banded_dp(*t, p_len=p_len, width=width).cpu().numpy()


def banded_dp_rows_host(q, r, n, m, lo, free_start, *, p_len, width):
    """numpy twin of ``banded_dp`` (bit-identical rows); an oracle for
    the tests."""
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


def traceback_batch(rows, q, r, n, m, lo, free_start, end_j):
    """Vectorized traceback for a whole bucket batch at once.

    Walks every piece's band in lockstep. Preference order matches
    `traceback_band`: diagonal (match/sub), then up (query-only, 'I'),
    then left (target-only, 'D').

    Returns (ops_list, start_j_array): ops in forward order per piece.
    """
    B, _, W = rows.shape
    maxlen = rows.shape[1] + W + 1
    i = n.astype(np.int64).copy()
    j = end_j.astype(np.int64).copy()
    ops_rev = np.full((B, maxlen), 255, np.uint8)
    pos = np.zeros(B, np.int64)
    rr = r.astype(np.int16)
    qq = q.astype(np.int16)

    for _ in range(maxlen):
        active = i > 0
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
        if not (diag | up | left).all():
            bad = a[~(diag | up | left)]
            raise AssertionError(
                f"traceback dead end in pieces {bad[:4]} (band too "
                f"narrow?)")
        op = np.where(diag, np.where(sub == 1, OP_SUB, OP_MATCH),
                      np.where(up, OP_INS, OP_DEL)).astype(np.uint8)
        ops_rev[a, pos[a]] = op
        pos[a] += 1
        i[a] = ia - (diag | up)
        j[a] = ja - (diag | left)

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
