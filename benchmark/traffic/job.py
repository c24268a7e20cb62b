"""Whole jobs: ``map_files(params)`` on one FASTA that is both the
reference and the query, as a user runs ``mashmap -r ref -q ref``.

Set-up makes the configuration's pangenome from the seed and writes it
once to a FASTA in the run's work directory. Each unit of the window is
one job through the program's front door (its FASTA reader, the index
build, the map and the PAF written), from fresh Parameters.
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
    query_bp: int
    k: int = 0
    s: int = 0
    seg: int = 0


def params(st: State):
    from mashmap_tpu_torch.params import Parameters
    p = Parameters(ref_sequences=[st.fa], query_sequences=[st.fa],
                   out_file_name=st.out, **st.cfg["parameters"])
    return p


def shape(cfg: dict, cell: dict) -> dict:
    """The generator's parameters: the configuration's shape, with the
    cell's traffic parameters (``params``) over it."""
    return dict(cfg["shape"], **cell.get("params", {}))


def setup_inputs(cfg: dict, cell: dict, seed: int, device, workdir: str,
                 scale: float = 1.0) -> State:
    """The pangenome from the seed and its FASTA; the program runs
    only in ``Parameters.finalize``, which derives s."""
    genome = importlib.import_module(
        f"benchmark.gen.{cfg['generator']}").make(seed, shape(cfg, cell),
                                                  scale=scale)
    fa = os.path.join(workdir, "job.fa")
    fasta.write_fasta(fa, genome.records)
    st = State(cfg, device, fa, os.path.join(workdir, "job.paf"), genome,
               sum(len(s) for _, s in genome.records))
    p = params(st).finalize()
    st.k, st.s, st.seg = p.kmer_size, p.sketch_size, p.seg_length
    return st


setup = setup_inputs


def unit(st: State) -> str:
    from mashmap_tpu_torch.api import map_files
    map_files(params(st), device=st.device)
    with open(st.out) as fh:
        return fh.read()


def release(st: State) -> None:
    pass


def truth(st: State) -> Truth:
    g = st.genome
    seqs = dict(g.records)
    names = [n for n, _ in g.records]
    pairs = [(q, t) for q in names for t in names
             if g.chrom(q) == g.chrom(t) and g.hap(q) != g.hap(t)]

    def place(q, pos, t):
        if g.chrom(q) != g.chrom(t) or g.hap(q) == g.hap(t):
            return None
        return np.minimum(g.project(q, pos, t), len(seqs[t]))
    return Truth(seqs, pairs, place)
