"""Whole jobs of an assembly placed on a reference: ``map_files(params)``
on a reference FASTA and a separate query FASTA, as a user runs
``mashmap -r ref.fa -q asm.fa``.

Set-up is the resident map's (``resident_map.setup_inputs``: the pair
made from the seed on the device, the query FASTA written) with the
chromosomes written to a reference FASTA beside it. Each unit of the
window is one job through the program's front door (its FASTA reader,
the index build, the map and the PAF written), from fresh Parameters.
The truth is each contig's origin, as in the resident map.

The first unit is the harness's warm unit, which captures the map's
CUDA graphs; a unit after it that captures one more raises, since
nothing may compile inside the measured window.
"""

from __future__ import annotations

import os

from ..gen import fasta
from . import resident_map
from .resident_map import release, truth  # noqa: F401 (the harness calls both)


def params(st):
    from mashmap_tpu_torch.params import Parameters
    return Parameters(ref_sequences=[st.ref], query_sequences=[st.fa],
                      out_file_name=st.out, **st.cfg["parameters"])


def setup_inputs(cfg: dict, cell: dict, seed: int, device, workdir: str,
                 scale: float = 1.0):
    """The resident map's inputs and a FASTA of the chromosomes; the
    program runs only in ``Parameters.finalize``."""
    st = resident_map.setup_inputs(cfg, cell, seed, device, workdir, scale)
    st.ref = os.path.join(workdir, "ref.fa")
    fasta.write_fasta(st.ref, st.genome.reference)
    st.captures = None
    return st


setup = setup_inputs


def unit(st) -> str:
    from mashmap_tpu_torch.api import map_files
    from mashmap_tpu_torch.kernels import graphs
    map_files(params(st), device=st.device)
    captures = sum(graphs.CAPTURES.values())
    if st.captures is not None and captures != st.captures:
        raise RuntimeError(f"{captures - st.captures} CUDA graph(s) "
                           "captured after the warm unit")
    st.captures = captures
    with open(st.out) as fh:
        return fh.read()
