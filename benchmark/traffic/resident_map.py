"""Passes over a resident index: ``map_files(params, index=idx)``, as a
user with a built or saved index maps a query file.

Set-up makes the configuration's reference and assembly from the seed
on the device, builds the whole index on the card from memory with
``build_index`` (the call ``build_or_load_index`` makes, so the
reference is never written), and writes the drawn query contigs to a
FASTA in the run's work directory. Each unit of the window is one pass:
a new Mapper, the query read through the front door, the PAF written.
"""

from __future__ import annotations

import dataclasses
import importlib
import os

import numpy as np

from ..gen import fasta
from ..reference.check import Truth


@dataclasses.dataclass
class State:
    cfg: dict
    device: object
    fa: str
    out: str
    genome: object
    index: object
    query_bp: int
    reference_size: int
    k: int = 0
    s: int = 0
    seg: int = 0


def params(st: State):
    from mashmap_tpu_torch.params import Parameters
    return Parameters(query_sequences=[st.fa], out_file_name=st.out,
                      reference_size=st.reference_size,
                      **st.cfg["parameters"])


def shape(cfg: dict, cell: dict) -> dict:
    """The generator's parameters: the configuration's shape, with the
    cell's traffic parameters (``params``) over it."""
    return dict(cfg["shape"], **cell.get("params", {}))


def setup_inputs(cfg: dict, cell: dict, seed: int, device, workdir: str,
                 scale: float = 1.0) -> State:
    """The pair from the seed and the query FASTA; the program runs
    only in ``Parameters.finalize``, which derives s."""
    import torch
    genome = importlib.import_module(
        f"benchmark.gen.{cfg['generator']}").make(seed, shape(cfg, cell),
                                                  device, scale=scale)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    fa = os.path.join(workdir, "query.fa")
    fasta.write_fasta(fa, genome.query)
    st = State(cfg, device, fa, os.path.join(workdir, "pass.paf"), genome,
               None, sum(len(s) for _, s in genome.query),
               genome.fasta_bytes)
    p = params(st).finalize()
    st.k, st.s, st.seg = p.kmer_size, p.sketch_size, p.seg_length
    return st


def setup(cfg: dict, cell: dict, seed: int, device, workdir: str,
          scale: float = 1.0) -> State:
    """The inputs, then the whole index built on the device."""
    from mashmap_tpu_torch.index.builder import build_index
    st = setup_inputs(cfg, cell, seed, device, workdir, scale)
    p = params(st).finalize()
    st.index = build_index(
        ((name, seq.tobytes().decode("ascii"))
         for name, seq in st.genome.reference),
        p.kmer_size, p.seg_length, p.sketch_size, p.kmer_pct_threshold,
        threads=p.threads, device=device)
    return st


def unit(st: State) -> str:
    from mashmap_tpu_torch.api import map_files
    map_files(params(st), index=st.index, device=st.device)
    with open(st.out) as fh:
        return fh.read()


def release(st: State) -> None:
    st.index = None


def truth(st: State) -> Truth:
    g = st.genome
    seqs = dict(g.reference)
    seqs.update(g.query)
    pairs = [(q, g.origin[q][0]) for q, _ in g.query]

    def place(q, pos, t):
        chrom, start = g.origin[q]
        if t != chrom:
            return None
        return np.minimum(start + np.asarray(pos), len(seqs[t]))
    return Truth(seqs, pairs, place)
