"""The devices one process maps on.

Counterpart of ``mashmap_tpu/parallel/mesh.py``. The JAX package's 1-D
``('data',)`` mesh becomes a plain list of torch devices: query
fragments (and L2 work items) are split into one contiguous row block
per entry, each block runs on its entry's device, and the outputs are
concatenated in row order. The index is replicated once per DISTINCT
device (or split across the entries, sharded_index.py).

An entry may repeat (``["cpu"] * 4`` in the CPU tests, ``["cuda:0",
"cuda:0"]`` on one card), which is this port's counterpart of the JAX
package's ``--xla_force_host_platform_device_count``: n blocks or n
shards exist and are checked where there are fewer devices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..utils import resolve_device


def _canonical(device) -> torch.device:
    """``device`` as a torch.device with its index (cuda -> cuda:N)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The device list a Mapper runs on.

    By default every visible CUDA device (raising without one, as every
    entry point does). Every device a torch process sees is local to it,
    so in a multi-process run this is the process's own devices, as the
    JAX package keeps each process's mesh local; give each process its
    own cards with CUDA_VISIBLE_DEVICES, or an explicit list.
    """
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = [_canonical(d) for d in devices]
    if not out:
        raise ValueError("make_mesh needs at least one device")
    return out


def distinct(devices: Sequence[torch.device]) -> List[torch.device]:
    """The distinct entries of a device list, in first-seen order."""
    out: List[torch.device] = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out
