"""Copies between the host and a CUDA device that do not stall its stream.

Counterpart of the JAX package's ``_start_host_copy``
(mashmap_tpu/map/engine.py, mashmap_tpu/index/builder.py). A blocking
``.cpu()``, or a ``.to("cuda")`` of pageable numpy memory, ends in
``cudaStreamSynchronize``: the host waits for everything already queued
on the stream, the next batch's work included. Here a device-to-host
copy goes into pinned host memory right behind the op that produced its
source, an event is recorded after it, and the host later waits on that
event alone; a host-to-device copy is staged in pinned memory and queued
with no wait, into a new tensor (``to_device``) or an existing one
(``copy_into``: a CUDA graph's static input). Pinned blocks come from
PyTorch's caching host allocator, which reuses a block only after the
copies queued on it are done.

On a CPU device the same calls hand back the tensors themselves.
"""

from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    """A device-to-host copy of one tensor, or of a tuple of tensors
    behind one event, started when it is made; ``wait()`` returns the
    tensor as a numpy array, or the tuple as a tuple of them."""

    def __init__(self, t):
        self._event = None
        self._one = isinstance(t, torch.Tensor)
        ts = (t,) if self._one else tuple(t)
        if ts and ts[0].device.type == "cuda":
            hosts = tuple(torch.empty(x.shape, dtype=x.dtype,
                                      pin_memory=True) for x in ts)
            for h, x in zip(hosts, ts):
                h.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(ts[0].device))
            ts = hosts
        self._host = ts

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        out = tuple(x.numpy() for x in self._host)
        return out[0] if self._one else out


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``, its host-to-device copy queued on the
    device's current stream without a wait."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def copy_into(dst: torch.Tensor, a: np.ndarray) -> None:
    """Copy ``a`` into the existing tensor ``dst`` (of its shape): on a
    CUDA device staged in pinned memory and queued on the current stream
    without a wait."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dst.device.type == "cuda":
        t = t.pin_memory()
    dst.copy_(t, non_blocking=True)
