"""The map's device steps as CUDA graphs: one captured launch sequence a
shape, replayed with one host call.

Counterpart of the JAX package's jit cache of ``l1_step`` and ``l2_step``
executables together with ``Mapper.prewarm_async`` and ``_PREWARMED``
(mashmap_tpu/map/engine.py): there a step is compiled once per static
config and argument shapes, and a batch then costs the host one dispatch
a step. Here the first call of a key runs the eager step
(kernels/mapdev.py) once on a side stream (the warm-up) and captures it
into a ``torch.cuda.CUDAGraph``; every call, that first one included,
copies its inputs into the graph's static input tensors, replays the
graph, and copies the static outputs out into fresh tensors on the same
stream, before any other replay of that graph can overwrite them (two row
blocks on one card replay one graph back to back, and the map keeps a
batch's sketches while the next batch's l1 step runs). The warm-up and
the capture both allocate from the device's one pool, so that a device's
peak memory stays that of the eager steps.

Each CUDA device has one cache (``_DeviceCache``) holding:

- one table set: the index's tables and the lookup tables, which every
  step reads in place. A Mapper whose tables have the same names, shapes
  and dtypes as the cached set uploads its contents into them (``tables``)
  and captures nothing new; one whose shapes differ drops the device's
  graphs and their memory pool first. So a device holds one copy of one
  index, however many Mappers have run on it.
- the graphs, keyed by the step, its static config, and each argument's
  shape and dtype (a table argument by its name);
- one memory pool (a ``torch.cuda.MemPool``) that every capture and
  warm-up of the device shares: an L2 call's intermediates take up to
  about 30 GB, and a private pool per shape would hold that many times
  over. Sharing is safe because static inputs are allocated outside the
  pool, every graph's static outputs stay referenced as long as the
  graph, a warm-up keeps none of its outputs, every replay runs on the
  caller's stream, and a warm-up waits for what that stream has queued.

The cache outlives the Mappers, as the JAX package's jit cache does, so
that a later Mapper over an index of the same shapes captures nothing;
``clear`` returns a device's table set, graphs and pool to the driver.

On a CPU device ``call`` runs the eager step: that is the route the
caller asked for. On CUDA a capture or replay that fails raises.
"""

from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch

from .. import trace
from ..hostcopy import copy_into, to_device

CAPTURES: dict = {}        # step name -> graphs captured
REPLAYS: dict = {}         # step name -> calls served by a replay

_CACHES: dict = {}         # torch.device -> _DeviceCache


class _Graph:
    """One captured step: the graph, the static tensor of each argument
    that is not a table (None for a table), and the static outputs."""

    def __init__(self, graph, inputs, outputs):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs

    def replay(self, args):
        for static, a in zip(self.inputs, args):
            if static is None:
                continue
            if isinstance(a, np.ndarray):
                copy_into(static, a)
            else:
                static.copy_(a, non_blocking=True)
        self.graph.replay()
        if isinstance(self.outputs, torch.Tensor):
            return self.outputs.clone()
        return tuple(o.clone() for o in self.outputs)


class _DeviceCache:
    """The table set, the graphs and the memory pool of one device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.sig = None            # (name, shape, dtype) of each table
        self.tables: dict = {}
        self.names: dict = {}      # id(table tensor) -> name
        self.owner = None          # weakref to the owner of the contents
        self.graphs: dict = {}
        self.pool = None
        self.stream = None

    def bind(self, owner, arrays: dict) -> dict:
        """The device's table tensors holding ``arrays`` (name -> numpy
        array): uploaded into the cached tensors when their names, shapes
        and dtypes match, else into new ones after every graph and the
        pool are dropped. ``owner`` (any object a weakref can name, the
        Mapper) marks whose contents the tensors hold, so that the upload
        happens once per owner."""
        sig = tuple((k, a.shape, a.dtype.str) for k, a in arrays.items())
        if sig != self.sig:
            self.drop()
            with trace.span("tables-upload"):
                self.tables = {k: to_device(a, self.device)
                               for k, a in arrays.items()}
            self.names = {id(t): k for k, t in self.tables.items()}
            self.sig = sig
        elif self.owner is None or self.owner() is not owner:
            with trace.span("tables-upload"):
                for k, a in arrays.items():
                    copy_into(self.tables[k], a)
        self.owner = weakref.ref(owner)
        return self.tables

    def drop(self) -> None:
        """Forget the table set, every graph and then the pool (their
        memory returns to the driver at the next ``empty_cache``)."""
        self.graphs.clear()
        self.pool = None
        self.tables, self.names = {}, {}
        self.sig = self.owner = None

    def key(self, step, args, static: tuple):
        """The graph key of ``step(*args, *static)``."""
        sig = []
        for a in args:
            name = self.names.get(id(a))
            sig.append(("table", name) if name is not None
                       else (tuple(a.shape), str(a.dtype)))
        return (step.__module__, step.__qualname__, static, tuple(sig))

    def capture(self, step, args, static: tuple) -> _Graph:
        """Capture ``step`` into the device's pool after one eager
        warm-up on the side stream. The warm-up allocates from the pool
        as well, reusing the memory that earlier graphs' intermediates
        take only during their replays, so that it holds none of its own
        beside them; a pool's first warm-up runs outside it, while it is
        still empty, so that what a step makes once per device and keeps
        (kernels/kmers.py's complement table) does not pin the pool."""
        inputs = [None if id(a) in self.names
                  else to_device(a, self.device) if isinstance(a, np.ndarray)
                  else a.clone() for a in args]
        full = [a if s is None else s for a, s in zip(args, inputs)]
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        first = self.pool is None
        if first:
            self.pool = torch.cuda.MemPool()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream), (
                contextlib.nullcontext() if first
                else torch.cuda.use_mem_pool(self.pool, self.device)):
            step(*full, *static)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self.pool.id, stream=self.stream):
            outputs = step(*full, *static)
        return _Graph(g, inputs, outputs)


def _device(device) -> torch.device:
    """``device`` with its index (a CUDA device without one: the current
    device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _cache(device: torch.device) -> _DeviceCache:
    device = _device(device)
    c = _CACHES.get(device)
    if c is None:
        c = _CACHES[device] = _DeviceCache(device)
    return c


def tables(device, owner, arrays: dict) -> dict:
    """``arrays`` (name -> numpy array) as tensors on ``device``: on CUDA
    the device's cached table set, bound to ``owner`` (``_DeviceCache.
    bind``); on the CPU the arrays themselves."""
    device = torch.device(device)
    if device.type != "cuda":
        with trace.span("tables-upload"):
            return {k: to_device(a, device) for k, a in arrays.items()}
    return _cache(device).bind(owner, arrays)


def call(device, step, args, *static):
    """``step(*args, *static)`` on ``device``. ``args`` are numpy arrays
    (a call's host inputs), tensors on the device, and the device's
    tables from ``tables``; ``static`` are the step's static arguments
    (its config), part of the key. On CUDA the call replays the graph
    captured for its key, capturing it first if there is none."""
    device = torch.device(device)
    if device.type != "cuda":
        return step(*(to_device(a, device) if isinstance(a, np.ndarray)
                      else a for a in args), *static)
    c = _cache(device)
    key = c.key(step, args, static)
    name = step.__name__
    with torch.cuda.device(device):
        g = c.graphs.get(key)
        if g is None:
            with trace.span("graph capture"):
                g = c.graphs[key] = c.capture(step, args, static)
            CAPTURES[name] = CAPTURES.get(name, 0) + 1
        REPLAYS[name] = REPLAYS.get(name, 0) + 1
        return g.replay(args)


def clear(device=None) -> None:
    """Drop the graph cache of ``device`` (of every device when None):
    its table set, its graphs and its pool, whose memory returns to the
    driver."""
    if device is None:
        caches = list(_CACHES.values())
        _CACHES.clear()
    else:
        caches = [c for c in (_CACHES.pop(_device(device), None),)
                  if c is not None]
    for c in caches:
        c.drop()
    if caches and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def reset_counts() -> None:
    """Set every step's CAPTURES and REPLAYS to 0."""
    CAPTURES.clear()
    REPLAYS.clear()
