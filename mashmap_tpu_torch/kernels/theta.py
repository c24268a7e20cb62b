"""theta over block rows: the hand-written CUDA kernel and its plain twin.

``theta_chunk(cur, nxt, s, s_b)`` replaces
``mashmap_tpu/kernels/winnow_pallas.py::theta_chunk_pallas`` (and its XLA
twin ``winnow.py::_theta_chunk``): for (C, S_B) int32 block rows,
``theta[c, j]`` is the s-th smallest DISTINCT rank of
``cur[c, j:] U nxt[c, :j]``, or RSENT when fewer than s are present.

On a CUDA tensor it launches ``csrc/theta.cu`` (built with nvcc for
sm_90a at first use, loaded with ctypes); on a CPU tensor it runs the
plain version ``theta_chunk_ref``. There is no fallback between the two.

What bounds the kernel on an H100: it reads cur and nxt and writes theta
once (12 bytes per offset) and does O(s) int32 compares per offset, so
neither HBM nor the ALUs bound it; the chain of one merge and two
inserts per offset is sequential within a row and is bound by on-chip
latency. The kernel runs one row per warp (many independent chains per
SM), keeps the row's sets in registers and shared memory, checkpoints
suffix sets to global memory only every K offsets, and skips most
inserts with a single compare (see the source's header).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np
import torch

RSENT = int(np.iinfo(np.int32).max)  # "+inf" rank
S_MAX = 512                           # 16 register slots per lane

LAUNCHES = 0                          # kernel launches (not ref calls)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "theta.cu")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    return "nvcc"


def load_library():
    """Build csrc/theta.cu with nvcc (once per source version) and load
    it. The library name carries a hash of the source, so an edited
    source never loads a stale build."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha1(fh.read()).hexdigest()[:12]
    os.makedirs(_BUILD, exist_ok=True)
    so = os.path.join(_BUILD, f"libtheta_{tag}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-o", tmp, _SRC], check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.theta_chunk_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.theta_chunk_launch.restype = ctypes.c_int
    _LIB = lib
    return lib


def kernel_geometry(s: int, s_b: int):
    """(SP, K, n_seg): padded set width, segment length, checkpoints."""
    sp = 32 * (-(-s // 32))
    # about 32 KB of shared memory per row, K a power of two in [16, 64]
    k = max(16, min(64, 1 << ((32768 // (4 * sp)).bit_length() - 1)))
    return sp, k, -(-s_b // k)


def theta_rows_per_launch(device: torch.device, s: int, s_b: int) -> int:
    """Rows per theta_chunk call: the kernel's checkpoint scratch (or
    the plain version's suffix stack) stays under a fixed budget."""
    if device.type == "cuda":
        sp, _, n_seg = kernel_geometry(s, s_b)
        per_row, budget = n_seg * sp * 4, 1 << 30
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
    if not 1 <= s <= S_MAX:
        raise ValueError(f"theta_chunk: s={s} outside [1, {S_MAX}]")


def theta_chunk(cur: torch.Tensor, nxt: torch.Tensor, s: int,
                s_b: int) -> torch.Tensor:
    """theta ranks (C, S_B) int32 for block rows cur/nxt (C, S_B) int32."""
    global LAUNCHES
    _check(cur, nxt, s, s_b)
    if cur.device.type == "cpu":
        return theta_chunk_ref(cur, nxt, s, s_b)
    if cur.device.type != "cuda":
        raise ValueError(f"theta_chunk: unsupported device {cur.device}")
    lib = load_library()
    C = cur.shape[0]
    sp, k, n_seg = kernel_geometry(s, s_b)
    out = torch.empty_like(cur)
    ckpt = torch.empty(max(1, C * n_seg * sp), dtype=torch.int32,
                       device=cur.device)
    err = lib.theta_chunk_launch(
        cur.data_ptr(), nxt.data_ptr(), out.data_ptr(), ckpt.data_ptr(),
        C, s_b, s, k, torch.cuda.current_stream(cur.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"theta_chunk kernel launch failed: CUDA "
                           f"error {err}")
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
