"""Multi-process launch path.

Counterpart of ``mashmap_tpu/parallel/distributed.py``: the index is
built (or loaded) by every process, the QUERY stream is shared out
across processes, and process 0 gathers the per-process PAF parts in
input order. Within one process the device list (mesh.py) handles the
local devices; across processes the only communication is a barrier
through a ``torch.distributed`` gloo process group. Mapping itself is
embarrassingly parallel over queries.

Launch recipe (one process per host, or several on one host; two
processes on one card work for testing):

    MASHMAP_TPU_COORDINATOR=host0:12345 \\
    MASHMAP_TPU_NUM_PROCS=2 MASHMAP_TPU_PROC_ID=<0..1> \\
    python -m mashmap_tpu_torch.cli -r ref.fa -q q.fa -o out.paf [...]

or the same through ``--coordinator/--numProcesses/--processId``. Every
process reads the whole reference and query files; process p maps the
queries whose input ordinal i has ``i % P == p`` and writes
``out.paf.part<p>``; after the barrier, process 0 merges the parts into
``out.paf``, byte-identical to a single-process run. ``--shardIndex``
combines: each process shards the index over its own devices.
"""

from __future__ import annotations

import datetime
import heapq
import logging
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional

logger = logging.getLogger("mashmap_tpu_torch.dist")

# index builds are legitimately long: every barrier waits up to this
BARRIER_TIMEOUT = datetime.timedelta(hours=1)

_CTX: Optional["DistContext"] = None


@dataclass(frozen=True)
class DistContext:
    process_id: int
    num_processes: int

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0

    def owns_query(self, global_ordinal: int) -> bool:
        """Strided query ownership: deterministic, order-preserving,
        balanced for homogeneous query streams."""
        return global_ordinal % self.num_processes == self.process_id

    def part_path(self, out_file_name: str, pid: int | None = None) -> str:
        p = self.process_id if pid is None else pid
        return f"{out_file_name}.part{p}"


def setup(coordinator: Optional[str] = None,
          num_processes: Optional[int] = None,
          process_id: Optional[int] = None) -> Optional[DistContext]:
    """Join the process group (idempotent).

    Flag values take precedence over the MASHMAP_TPU_COORDINATOR,
    MASHMAP_TPU_NUM_PROCS and MASHMAP_TPU_PROC_ID environment variables.
    Returns None (single-process mode) unless a coordinator ``host:port``
    is configured with >= 2 processes; raises ValueError on a process id
    out of range. Process 0 serves the rendezvous at the coordinator's
    address.
    """
    global _CTX
    if _CTX is not None:
        return _CTX
    coordinator = coordinator or os.environ.get("MASHMAP_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("MASHMAP_TPU_NUM_PROCS", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("MASHMAP_TPU_PROC_ID", "-1"))
    if not coordinator or num_processes < 2:
        return None
    if not (0 <= process_id < num_processes):
        raise ValueError(
            f"processId {process_id} out of range for "
            f"{num_processes} processes")
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=BARRIER_TIMEOUT)
    _CTX = DistContext(process_id, num_processes)
    logger.info("multi-process runtime up: process %d/%d (coordinator %s)",
                process_id, num_processes, coordinator)
    return _CTX


def context() -> Optional[DistContext]:
    return _CTX


def barrier(tag: str) -> None:
    """Block until every process reaches this point (a gloo barrier, on
    the host; ``tag`` names it in the log). All processes run the same
    barrier sequence by construction."""
    if _CTX is None:
        return
    import torch.distributed as dist
    logger.debug("barrier %s", tag)
    dist.barrier()


def merge_paf_parts(out_file_name: str, ctx: DistContext) -> None:
    """Process-0 gather: k-way merge of per-process PAF parts.

    Part lines are ``<query_ordinal>\\t<paf...>``; parts ascend in query
    ordinal (each process keeps input order), so a stable heap merge
    reproduces the single-process output order. All ties live within
    one part (a query maps on exactly one process).
    """
    if not ctx.is_primary:
        return
    paths = [ctx.part_path(out_file_name, p)
             for p in range(ctx.num_processes)]

    def keyed(fh):
        for line in fh:
            ordinal, _, rest = line.partition("\t")
            yield int(ordinal), rest

    handles = [open(p) for p in paths]
    try:
        with open(out_file_name, "w") as out:
            for _, rest in heapq.merge(*[keyed(fh) for fh in handles]):
                out.write(rest)
    finally:
        for fh in handles:
            fh.close()
    for p in paths:
        os.remove(p)


def dump_rows(path: str, rows: List) -> None:
    """Spill one process's buffered one-to-one rows for the gather."""
    with open(path, "wb") as fh:
        pickle.dump(rows, fh, protocol=pickle.HIGHEST_PROTOCOL)


def gather_rows(out_file_name: str, ctx: DistContext) -> List:
    """Process-0 gather of every process's buffered one-to-one rows, in
    the single-process emission order (rows come grouped per query; a
    stable sort on the query ordinal restores the input order)."""
    rows: List = []
    for p in range(ctx.num_processes):
        path = ctx.part_path(out_file_name, p) + ".rows"
        with open(path, "rb") as fh:
            rows.extend(pickle.load(fh))
        os.remove(path)
    rows.sort(key=lambda m: m.query_seq_id)
    return rows
