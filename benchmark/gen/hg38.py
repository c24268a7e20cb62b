"""A GRCh38-shaped reference and its assembly, made on the device.

The shape of the repository's human-scale generator
(``scripts/gen_flagship_data.py``): 24 chromosomes of uniform random
bases at GRCh38's lengths, an assembly of the same genome with a share
of single-base substitutions (no indels), cut into contigs of uniform
random length that tile each chromosome from its start. Here every
chromosome is drawn on the device by a ``torch.Generator`` seeded from
the run's seed and the chromosome's index, in three bulk calls, and
only the reference and the contigs a run maps come to the host. A
contig's origin (chromosome and start) is its truth.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from .fasta import record_bytes


def _seed(seed: int, *key: int) -> int:
    ss = np.random.SeedSequence([seed % (1 << 64), *key])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class Human:
    """``reference``: (name, ASCII uint8) chromosomes; ``query``: the
    drawn assembly contigs in draw order; ``origin[contig]``: (chromosome
    name, start); ``fasta_bytes``: the reference's FASTA size."""
    reference: List[Tuple[str, np.ndarray]]
    query: List[Tuple[str, np.ndarray]]
    origin: Dict[str, Tuple[str, int]]
    fasta_bytes: int


def chromosomes(shape: dict, scale: float = 1.0) -> List[Tuple[str, int]]:
    return [(c, max(int(mbp * 1_000_000 * scale), 1))
            for c, mbp in shape["chromosomes_mbp"]]


def tiles(seed: int, chroms, cmin: int, cmax: int):
    """(chromosome index, start, length) of every assembly contig."""
    rng = np.random.default_rng([seed % (1 << 64), 1])
    out = []
    for ci, (_, n) in enumerate(chroms):
        pos = 0
        while pos < n:
            ln = min(int(rng.integers(cmin, cmax + 1)), n - pos)
            out.append((ci, pos, ln))
            pos += ln
    return out


def draw(seed: int, contigs, query_bp: int):
    """Contigs in an order drawn from the seed, each taken while it fits
    within ``query_bp``."""
    order = np.random.default_rng([seed % (1 << 64), 2]).permutation(
        len(contigs))
    got, total = [], 0
    for i in order:
        if total + contigs[i][2] <= query_bp:
            got.append(contigs[i])
            total += contigs[i][2]
    return got


def _ascii(codes: torch.Tensor) -> torch.Tensor:
    """Codes 0..3 to b"ACGT" without an int64 index of the length."""
    return (65 + 2 * codes + 2 * (codes >= 2).to(torch.uint8)
            + 11 * (codes == 3).to(torch.uint8))


def make(seed: int, shape: dict, device, scale: float = 1.0) -> Human:
    """The pair of ``shape``: a configuration's shape block
    (``chromosomes_mbp``, ``snp_rate``, ``contig_bp`` [min, max]) with the
    cell's ``query_bp``; ``scale`` shortens chromosomes, contigs and the
    query alike (tests only)."""
    chroms = chromosomes(shape, scale)
    cmin, cmax = (max(int(x * scale), 1) for x in shape["contig_bp"])
    contigs = tiles(seed, chroms, cmin, cmax)
    picked = draw(seed, contigs, int(shape["query_bp"] * scale))
    index_of = {}
    for ci, start, _ in sorted(picked):
        index_of.setdefault(ci, []).append(start)
    k_of = {}
    per_chrom = {}
    for ci, start, ln in contigs:
        k_of[(ci, start)] = per_chrom.setdefault(ci, 0)
        per_chrom[ci] += 1
    reference, pieces, origin = [], {}, {}
    for ci, (name, n) in enumerate(chroms):
        g = torch.Generator(device=device)
        g.manual_seed(_seed(seed, 3, ci))
        codes = torch.randint(0, 4, (n,), generator=g, device=device,
                              dtype=torch.uint8)
        snp = torch.rand(n, generator=g, device=device) < shape["snp_rate"]
        shift = torch.randint(1, 4, (n,), generator=g, device=device,
                              dtype=torch.uint8)
        reference.append((name, _ascii(codes).cpu().numpy()))
        if ci in index_of:
            asm = torch.where(snp, (codes + shift) % 4, codes)
            del codes, snp, shift
            for start in index_of[ci]:
                ln = next(c[2] for c in picked if c[:2] == (ci, start))
                cname = f"asm_{name}_ctg{k_of[(ci, start)]}"
                pieces[(ci, start)] = (
                    cname, _ascii(asm[start:start + ln]).cpu().numpy())
                origin[cname] = (name, start)
            del asm
    query = [pieces[(ci, start)] for ci, start, _ in picked]
    fasta_bytes = sum(record_bytes(nm, len(s)) for nm, s in reference)
    return Human(reference, query, origin, fasta_bytes)
