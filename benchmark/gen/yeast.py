"""An S. cerevisiae-shaped pangenome: haplotypes mutated from one base
genome, with the map of every haplotype position to the base's.

A vectorised form of the repository's test generator (``pangenome`` and
``mutate`` of its test helpers): a random base genome, then for each
further haplotype a set of distinct positions drawn without replacement,
the first share of them indels (half deletions, half insertions of a
random base before the position) and the rest substitutions. Unlike the
original it builds each haplotype in one pass (no copy per indel), and it
keeps ``base_of``: for every haplotype position (and its end) the base
position it came from, an inserted base taking the position that
follows it. That map is the truth the reference checks placements
against.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .fasta import ACGT


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *key])


def mutate(base: np.ndarray, sub_rate: float, indel_rate: float,
           rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(haplotype codes 0..3, base_of) for base codes 0..3."""
    n = len(base)
    n_indel = int(n * indel_rate)
    n_mut = n_indel + int(n * sub_rate)
    pos = rng.choice(n, size=n_mut, replace=False)
    indel, subs = pos[:n_indel], pos[n_indel:]
    out = base.copy()
    out[subs] = (out[subs] + rng.integers(1, 4, len(subs),
                                          dtype=np.uint8)) % 4
    is_del = rng.random(n_indel) < 0.5
    cnt = np.ones(n, np.int64)
    cnt[indel[is_del]] = 0
    ins = indel[~is_del]
    cnt[ins] = 2
    src = np.repeat(np.arange(n, dtype=np.int64), cnt)
    hap = out[src]
    first = np.cumsum(cnt) - cnt
    hap[first[ins]] = rng.integers(0, 4, len(ins), dtype=np.uint8)
    base_of = np.concatenate([src, [n]])
    return hap, base_of


@dataclasses.dataclass
class Pangenome:
    """``records``: (name, ASCII uint8) in file order, haplotype-major;
    ``base_of[name]``: int64 base position of each position and of the
    end (None for the base haplotype itself)."""
    records: List[Tuple[str, np.ndarray]]
    base_of: Dict[str, np.ndarray]

    @staticmethod
    def chrom(name: str) -> str:
        return name.rsplit("#", 1)[1]

    @staticmethod
    def hap(name: str) -> str:
        return name.split("#", 1)[0]

    def to_base(self, name: str, pos: np.ndarray) -> np.ndarray:
        m = self.base_of[name]
        return np.asarray(pos) if m is None else m[np.asarray(pos)]

    def from_base(self, name: str, bpos: np.ndarray) -> np.ndarray:
        """First position of ``name`` whose base position is >= bpos."""
        m = self.base_of[name]
        if m is None:
            return np.asarray(bpos)
        return np.searchsorted(m, np.asarray(bpos), side="left")

    def project(self, q_name: str, q_pos, t_name: str) -> np.ndarray:
        """Positions of ``q_name`` carried to homologous ``t_name``."""
        return self.from_base(t_name, self.to_base(q_name, q_pos))


def make(seed: int, shape: dict, scale: float = 1.0) -> Pangenome:
    """The pangenome of ``shape`` (a configuration's ``shape``
    block): ``chromosomes`` [[name, bp]], ``haplotypes``, ``sub_rate``,
    ``indel_rate``, ``name`` (a format with {hap} and {chrom}).
    ``scale`` shortens every chromosome (tests only)."""
    chroms = [(c, max(int(bp * scale), 1)) for c, bp in shape["chromosomes"]]
    bases = [_rng(seed, 0, ci).integers(0, 4, n, dtype=np.uint8)
             for ci, (_, n) in enumerate(chroms)]
    records, base_of = [], {}
    for h in range(1, shape["haplotypes"] + 1):
        for ci, (c, _) in enumerate(chroms):
            name = shape["name"].format(hap=h, chrom=c)
            if h == 1:
                codes, m = bases[ci], None
            else:
                codes, m = mutate(bases[ci], shape["sub_rate"],
                                  shape["indel_rate"], _rng(seed, h, ci))
            records.append((name, ACGT[codes]))
            base_of[name] = m
    return Pangenome(records, base_of)
