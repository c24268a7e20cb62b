"""The traced run's device side: torch.profiler over one unit of the
window, reduced to the device's busy time, its operations by name, its
idle gaps by the host phase that ran during them, and the time of the
theta kernels (theta.cu's two kernels; the byte bound of their calls is
``theta_bound_s``).

Busy time is the union of the intervals of the device operations
(kernels, copies, sets), clipped to the traced window, so operations
that overlap count once. The host and the trace share a clock: the
window is bracketed by two ``torch.cuda._sleep`` kernels whose trace
start is matched to the host's ``time.time_ns`` at their launch.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # one H100 SXM, NVIDIA's data sheet
THETA_KERNELS = ("theta_ckpt_kernel", "theta_chain_kernel")
MARK = "spin_kernel"               # torch.cuda._sleep's kernel


def theta_bytes(C: int, s_b: int) -> int:
    """Bytes a theta.cu launch cannot do without: its (C, S_B) int32
    rows cur and nxt read once, theta written once."""
    return 3 * C * s_b * 4


def theta_bound_s(calls: Sequence[Tuple[int, int]]) -> float:
    return sum(theta_bytes(C, s_b) for C, s_b in calls) / HBM_BYTES_PER_S


def gaps_ns(iv: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The idle [start, end) gaps that the union of the [start, end)
    intervals ``iv`` ((n, 2) int64) leaves within [lo, hi)."""
    iv = np.clip(iv, lo, hi)
    iv = iv[iv[:, 1] > iv[:, 0]]
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    # before interval i the device is busy up to the largest earlier end
    busy_to = np.concatenate([[lo], np.maximum.accumulate(iv[:, 1])])
    nxt = np.concatenate([iv[:, 0], [hi]])
    g = np.stack([busy_to, nxt], 1)
    return g[g[:, 1] > g[:, 0]]


def union_ns(iv: np.ndarray, lo: int, hi: int) -> int:
    """Length of the union of the intervals ``iv`` within [lo, hi)."""
    g = gaps_ns(iv, lo, hi)
    return int(hi - lo - (g[:, 1] - g[:, 0]).sum())


class Tracer:
    """torch.profiler around a span of host work on one CUDA device."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.device = device
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.marks: List[int] = []

    def _mark(self):
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self.marks.append(time.time_ns())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)

    def __enter__(self):
        self.prof.start()
        self._mark()
        return self

    def __exit__(self, *exc):
        self._mark()
        self.prof.stop()
        return False

    def events(self):
        """(names, (n, 2) start/end ns on the host clock, (start, end) of
        the window) of the device operations inside the window."""
        names, iv = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != self.torch.autograd.DeviceType.CUDA:
                continue
            names.append(e.name())
            iv.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        iv = np.asarray(iv, np.int64).reshape(-1, 2)
        marks = [i for i, n in enumerate(names) if MARK in n]
        offset = 0
        if len(marks) >= 2:
            offset = self.marks[0] - int(iv[marks[0], 0])
            keep = np.ones(len(names), bool)
            keep[marks] = False
            names = [n for n, k in zip(names, keep) if k]
            iv = iv[keep]
        iv = iv + offset
        lo, hi = self.marks[0], self.marks[1]
        inside = (iv[:, 1] > lo) & (iv[:, 0] < hi)
        return [n for n, k in zip(names, inside) if k], \
            np.clip(iv[inside], lo, hi), (lo, hi)


def label_gaps(gaps: np.ndarray, phases) -> Dict[str, int]:
    """Idle ns by the host phase each gap's midpoint fell in. ``phases``
    is a list of groups of (start ns, end ns, label); a group's phases
    do not overlap, and an earlier group wins where groups do."""
    mid = (gaps[:, 0] + gaps[:, 1]) // 2
    label = np.full(len(gaps), -1)
    names: List[str] = []
    for group in phases:
        if not group:
            continue
        group = sorted(group)
        st = np.array([g[0] for g in group], np.int64)
        en = np.array([g[1] for g in group], np.int64)
        i = np.searchsorted(st, mid, side="right") - 1
        hit = (label < 0) & (i >= 0) & (mid < en[np.maximum(i, 0)])
        ids = {}
        for j in np.nonzero(hit)[0]:
            lab = group[i[j]][2]
            label[j] = ids.setdefault(lab, len(names) + len(ids))
        names += list(ids)
    out: Dict[str, int] = {}
    for j, (a, b) in enumerate(gaps):
        lab = names[label[j]] if label[j] >= 0 else "other"
        out[lab] = out.get(lab, 0) + int(b - a)
    return out


def summarize(names, iv, window, phases, top: int = 10) -> Dict:
    """busy_s, window_s, theta_s, the top device operations by time and
    the idle time by host phase (``label_gaps``)."""
    lo, hi = window
    by_name: Dict[str, int] = {}
    for n, (a, b) in zip(names, iv):
        by_name[n] = by_name.get(n, 0) + int(b - a)
    theta_ns = sum(v for n, v in by_name.items()
                   if any(t in n for t in THETA_KERNELS))
    idle = label_gaps(gaps_ns(iv, lo, hi), phases)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": union_ns(iv, lo, hi) / 1e9,
            "window_s": (hi - lo) / 1e9, "theta_s": theta_ns / 1e9,
            "device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": [[n, v / 1e9] for n, v in gaps]}
