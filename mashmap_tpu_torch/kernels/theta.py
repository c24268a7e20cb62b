"""theta over block rows: the hand-written CUDA kernel and its plain twin.

``theta_chunk(cur, nxt, s, s_b)`` replaces
``mashmap_tpu/kernels/winnow_pallas.py::theta_chunk_pallas`` (and its XLA
twin ``winnow.py::_theta_chunk``): for (C, S_B) int32 block rows,
``theta[c, j]`` is the s-th smallest DISTINCT rank of
``cur[c, j:] U nxt[c, :j]``, or RSENT when fewer than s are present.

On a CUDA tensor it launches ``csrc/theta.cu`` for s <= S_MAX = 512 (the
sets in registers, 16 slots a lane) and ``csrc/theta_wide.cu`` above it
(kernel B's one set a chain in shared memory, or for s > WIDE_SMEM_S_MAX
in the device scratch); both are built with nvcc for sm_90a at first use
and loaded with ctypes. On a CPU tensor it runs the plain version
``theta_chunk_ref``, at any s. The route follows from s and the device;
nothing falls back from one to another.

Each CUDA source is two kernels with one schedule (see the headers).
Kernel A stores each row's suffix and prefix sets at every K-th offset:
theta.cu walks the row once per direction and also logs what each insert
of the suffix walk pushed out; theta_wide.cu merges one segment of K
ranks at a time into the previous checkpoint (a scan over segments, no
walk). Kernel B runs one independent chain per (row, K-offset segment).
theta.cu's steps both sets forward from its checkpoints, merges them in
full at the segment's first offset and otherwise moves theta by one
place where a change lands at or below it (or, under fewer than s ranks,
counts the union until it holds s). theta_wide.cu's merges the next
suffix checkpoint and its prefix checkpoint once into a read-only base
B_m (bottom-s of the ranks outside the segment) and keeps the segment's
window D(j) as a sorted delta of at most K ranks, those that can move
theta: theta(j) is the s-th distinct rank of B_m U D(j), read off the
delta's ranks in the union. The rows' C * S_B / K chains keep the SMs
busy, where one warp per row would leave each row's dependent chain to
set the time.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import nvcc

RSENT = int(np.iinfo(np.int32).max)  # "+inf" rank
S_MAX = 512                           # theta.cu: 16 register slots a lane
# theta_wide.cu keeps kernel B's base (N ints a chain, N = SP rounded up
# to a power of two) in one block's shared memory up to N = 16384; above
# this s the bases live in the device scratch
WIDE_SMEM_S_MAX = 16384

LAUNCHES = 0                          # theta.cu launches (not ref calls)
WIDE_LAUNCHES = 0                     # theta_wide.cu launches

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SRC = os.path.join(_CSRC, "theta.cu")
_SRC_WIDE = os.path.join(_CSRC, "theta_wide.cu")
_LIB = None
_LIB_WIDE = None


def ptxas_log_path(wide: bool = False) -> str:
    """Where load_library (load_wide_library) keeps nvcc's -Xptxas -v
    report (registers, spills and shared memory of each kernel instance)
    of theta.cu (theta_wide.cu)."""
    if wide:
        return nvcc.ptxas_log_path(_SRC_WIDE, "theta_wide")
    return nvcc.ptxas_log_path(_SRC, "theta")


def load_library():
    """Build csrc/theta.cu with nvcc (once per source version) and load
    it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(nvcc.build(_SRC, "theta"))
    lib.theta_chunk_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.theta_chunk_launch.restype = ctypes.c_int
    lib.theta_occupancy.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.theta_occupancy.restype = ctypes.c_int
    _LIB = lib
    return lib


def load_wide_library():
    """Build csrc/theta_wide.cu with nvcc (once per source version) and
    load it."""
    global _LIB_WIDE
    if _LIB_WIDE is not None:
        return _LIB_WIDE
    lib = ctypes.CDLL(nvcc.build(_SRC_WIDE, "theta_wide"))
    lib.theta_wide_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.theta_wide_launch.restype = ctypes.c_int
    lib.theta_wide_occupancy.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.theta_wide_occupancy.restype = ctypes.c_int
    _LIB_WIDE = lib
    return lib


SEG_K = 128  # offsets per chain of kernel B (theta_wide.cu takes only 128)


def kernel_geometry(s: int, s_b: int):
    """(SP, K, n_seg): padded set width, segment length, segments (and
    checkpoints of each set) per row."""
    return 32 * (-(-s // 32)), SEG_K, -(-s_b // SEG_K)


def wide_set_len(s: int) -> int:
    """N, the length of theta_wide.cu's base, a chain's one set: SP
    rounded up to a power of two (its binary searches' length)."""
    return 1 << max(5, (kernel_geometry(s, 1)[0] - 1).bit_length())


def wide_sets_in_scratch(s: int) -> bool:
    """Whether theta_wide.cu keeps its bases in the device scratch (not
    in shared memory) at sketch size s."""
    return s > WIDE_SMEM_S_MAX


def scratch_ints_per_row(s: int, s_b: int) -> int:
    """Kernel scratch per row: S and P checkpoints; for theta.cu the
    eviction log, and where theta_wide.cu keeps its bases in the scratch,
    kernel B's one base per chain."""
    sp, _, n_seg = kernel_geometry(s, s_b)
    n = 2 * n_seg * sp
    if s <= S_MAX:
        n += s_b
    elif wide_sets_in_scratch(s):
        n += n_seg * wide_set_len(s)
    return n


def resident_warps(s: int):
    """(kernel A, kernel B) resident warps per SM at sketch size s, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current card,
    for the source and route that s takes (theta_wide.cu's kernel A:
    resident blocks of SEG_K threads, times SEG_K / 32)."""
    a, b = ctypes.c_int(0), ctypes.c_int(0)
    if s <= S_MAX:
        err = load_library().theta_occupancy(s, ctypes.byref(a),
                                             ctypes.byref(b))
    else:
        err = load_wide_library().theta_wide_occupancy(
            s, int(wide_sets_in_scratch(s)), ctypes.byref(a),
            ctypes.byref(b))
    if err != 0:
        raise RuntimeError(f"theta_occupancy failed: CUDA error {err}")
    return a.value, b.value


def theta_rows_per_launch(device: torch.device, s: int, s_b: int) -> int:
    """Rows per theta_chunk call: the kernels' scratch (or the plain
    version's suffix stack) stays under a fixed budget."""
    if device.type == "cuda":
        per_row, budget = scratch_ints_per_row(s, s_b) * 4, 1 << 30
    else:
        per_row, budget = s_b * max(s, 1) * 4, 1 << 28
    return max(1, budget // per_row)


def _check(cur: torch.Tensor, nxt: torch.Tensor, s: int, s_b: int):
    for name, x in (("cur", cur), ("nxt", nxt)):
        if x.dtype != torch.int32:
            raise TypeError(f"theta_chunk: {name} must be int32, "
                            f"got {x.dtype}")
        if x.dim() != 2 or x.shape[1] != s_b:
            raise ValueError(f"theta_chunk: {name} must be (C, {s_b}), "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"theta_chunk: {name} must be contiguous")
    if cur.shape != nxt.shape or cur.device != nxt.device:
        raise ValueError("theta_chunk: cur and nxt differ in shape or "
                         "device")
    if s < 1:
        raise ValueError(f"theta_chunk: s={s} must be at least 1")


def theta_chunk(cur: torch.Tensor, nxt: torch.Tensor, s: int,
                s_b: int) -> torch.Tensor:
    """theta ranks (C, S_B) int32 for block rows cur/nxt (C, S_B) int32."""
    global LAUNCHES, WIDE_LAUNCHES
    _check(cur, nxt, s, s_b)
    if cur.device.type == "cpu":
        return theta_chunk_ref(cur, nxt, s, s_b)
    if cur.device.type != "cuda":
        raise ValueError(f"theta_chunk: unsupported device {cur.device}")
    wide = s > S_MAX
    lib = load_wide_library() if wide else load_library()
    C = cur.shape[0]
    out = torch.empty_like(cur)
    scratch = torch.empty(max(1, C * scratch_ints_per_row(s, s_b)),
                          dtype=torch.int32, device=cur.device)
    args = (cur.data_ptr(), nxt.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), C, s_b, s, SEG_K)
    stream = torch.cuda.current_stream(cur.device).cuda_stream
    if wide:
        err = lib.theta_wide_launch(*args, int(wide_sets_in_scratch(s)),
                                    stream)
    else:
        err = lib.theta_chunk_launch(*args, stream)
    if err != 0:
        raise RuntimeError(f"theta_chunk kernel launch failed "
                           f"({'theta_wide.cu' if wide else 'theta.cu'}, "
                           f"s={s}): CUDA error {err}")
    if wide:
        WIDE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


# --- plain version ---------------------------------------------------------


def _insert_bottom_s(state: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Insert v (C,) into each row's sorted distinct bottom-s set
    (C, s), RSENT-padded; RSENT values and duplicates are no-ops."""
    s = state.shape[-1]
    skip = (state == v[:, None]).any(dim=-1) | (v == RSENT)
    pos = (state < v[:, None]).sum(dim=-1, keepdim=True)
    idx = torch.arange(s, device=state.device)[None, :]
    shifted = torch.cat([state[:, :1], state[:, :-1]], dim=-1)
    cand = torch.where(idx < pos, state,
                       torch.where(idx == pos, v[:, None], shifted))
    return torch.where(skip[:, None], state, cand)


def _merge_theta(a: torch.Tensor, b: torch.Tensor, s: int) -> torch.Tensor:
    """s-th smallest distinct value of two sorted RSENT-padded (C, s)
    sets (RSENT when the union holds fewer than s)."""
    m = torch.sort(torch.cat([a, b], dim=-1), dim=-1).values
    newv = torch.ones_like(m, dtype=torch.bool)
    newv[:, 1:] = m[:, 1:] != m[:, :-1]
    newv &= m != RSENT
    hit = newv & (torch.cumsum(newv.to(torch.int32), dim=-1) == s)
    return torch.where(hit, m, RSENT).amin(dim=-1)


def theta_chunk_ref(cur: torch.Tensor, nxt: torch.Tensor, s: int,
                    s_b: int) -> torch.Tensor:
    """Plain PyTorch theta from the definition: the suffix sets of cur
    (built backward and stacked), then a forward pass that merges each
    with the running prefix set of nxt."""
    C = cur.shape[0]
    empty = torch.full((C, s), RSENT, dtype=torch.int32, device=cur.device)
    suf = torch.empty((s_b, C, s), dtype=torch.int32, device=cur.device)
    state = empty
    for j in range(s_b - 1, -1, -1):
        state = _insert_bottom_s(state, cur[:, j])
        suf[j] = state
    out = torch.empty((C, s_b), dtype=torch.int32, device=cur.device)
    pre = empty
    for j in range(s_b):
        out[:, j] = _merge_theta(suf[j], pre, s)
        pre = _insert_bottom_s(pre, nxt[:, j])
    return out
