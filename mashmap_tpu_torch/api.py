"""High-level API: build/load index, map queries, write PAF.

Equivalent of the reference `mashmap` main (src/map/mash_map.cpp:22-57):
index construction then query mapping. Counterpart of
``mashmap_tpu/api.py``: on CUDA unless the caller passes
``device="cpu"``, on a list of ``devices`` (parallel/mesh.py), and in
one of several processes (parallel/distributed.py).
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

from . import trace
from .params import Parameters, FILTER_ONETOONE
from .index.builder import ReferenceIndex, build_index
from .io import for_each_seq_in_file
from .map.engine import Mapper
from .parallel import distributed
from .parallel.mesh import make_mesh

logger = logging.getLogger("mashmap_tpu_torch")


def build_or_load_index(params: Parameters, device=None) -> ReferenceIndex:
    if params.load_index_filename:
        t0 = time.time()
        idx = ReferenceIndex.load(params.load_index_filename)
        logger.info("index loaded in %.2fs", time.time() - t0)
        return idx

    def contigs():
        allowed = None
        if params.target_list:
            with open(params.target_list) as fh:
                allowed = {line.strip() for line in fh if line.strip()}
        for fname in params.ref_sequences:
            yield from for_each_seq_in_file(
                fname, allowed, params.target_prefix)

    t0 = time.time()
    idx = build_index(
        contigs(), params.kmer_size, params.seg_length,
        params.sketch_size, params.kmer_pct_threshold,
        threads=params.threads, device=device)
    logger.info("reference index built in %.2fs", time.time() - t0)
    if params.save_index_filename:
        idx.save(params.save_index_filename)
    return idx


@trace.job
def map_files(params: Parameters,
              index: Optional[ReferenceIndex] = None,
              device=None, devices=None) -> ReferenceIndex:
    """Run the full pipeline; returns the index (reusable).

    Maps on ``devices`` (default: ``[device]`` when a device is named,
    else every visible CUDA device); the index builds on the first. A
    coordinator and >= 2 processes (flags or MASHMAP_TPU_* variables)
    make this one process of a multi-process run. Each call is a job of
    trace.py: its spans carry its ordinal and its totals go to
    ``trace.JOBS``."""
    if devices is None and device is not None:
        devices = [device]
    devices = make_mesh(devices)
    params.finalize()
    ctx = distributed.setup(params.coordinator, params.num_processes,
                            params.process_id)
    if ctx is not None:
        if params.out_file_name == "-":
            raise ValueError(
                "multi-process runs need a file output (-o), not stdout")
        if not ctx.is_primary:
            # concurrent writers would race on --saveIndex; the build is
            # deterministic, so every process gets the same tables
            params.save_index_filename = ""
    # start reading the query stream NOW, so its I/O + decompression
    # overlap the index build/load; a bounded queue caps memory for
    # arbitrarily large query sets
    reader = None
    if params.query_sequences:
        from .io.fasta import PrefetchReader
        reader = PrefetchReader(params.query_sequences)
    # one guarded region from here through mapper.run: ANY failure
    # (index build, device OOM, mapping itself) must close the
    # non-daemon reader thread, or the process hangs at exit blocked on
    # the full queue instead of propagating the error
    try:
        if index is None:
            index = build_or_load_index(params, devices[0])
        if params.load_index_filename and (
                index.kmer_size != params.kmer_size
                or index.window_size != params.seg_length
                or index.sketch_size != params.sketch_size):
            # the npz stores the build parameters; adopt them instead of
            # silently mixing sketch domains
            logger.warning(
                "loaded index was built with k=%d w=%d s=%d; overriding "
                "the CLI-derived k=%d w=%d s=%d",
                index.kmer_size, index.window_size, index.sketch_size,
                params.kmer_size, params.seg_length, params.sketch_size)
            if params.block_length == params.seg_length:
                params.block_length = index.window_size
            if params.chain_gap == params.seg_length:
                params.chain_gap = index.window_size
            params.kmer_size = index.kmer_size
            params.seg_length = index.window_size
            params.sketch_size = index.sketch_size
        mapper = Mapper(params, index, devices=devices)
        t0 = time.time()
        if ctx is not None:
            part = ctx.part_path(params.out_file_name)
            with open(part, "w") as out:
                mapper.run(params.query_sequences, out, reader=reader)
        elif params.out_file_name == "-":
            mapper.run(params.query_sequences, sys.stdout, reader=reader)
        else:
            with open(params.out_file_name, "w") as out:
                mapper.run(params.query_sequences, out, reader=reader)
    except BaseException:
        if reader is not None:
            reader.close()
        raise
    if ctx is not None:
        distributed.barrier("map-parts-done")
        if ctx.is_primary:
            if params.filter_mode == FILTER_ONETOONE:
                # process 0 wrote the whole output already
                os.replace(part, params.out_file_name)
                for pid in range(1, ctx.num_processes):
                    os.remove(ctx.part_path(params.out_file_name, pid))
            else:
                distributed.merge_paf_parts(params.out_file_name, ctx)
        distributed.barrier("map-merged")
    logger.info("mapping done in %.2fs", time.time() - t0)
    return index
