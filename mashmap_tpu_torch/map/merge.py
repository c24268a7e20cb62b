"""Split-fragment chain merging (reference: Map::mergeMappingsInRange,
computeMap.hpp:1579-1704) with union-find.

Each long query is mapped as independent segLength fragments (the batch
axis on TPU); afterwards, fragment mappings that continue each other on
the same reference/strand within `max_dist` (2D euclidean + colinearity
score) are united and collapsed into one chained mapping whose bounds are
the union and whose identity/complexity are the chain means.
"""

from __future__ import annotations

import math
import numpy as np

from .output import cpp_round

from typing import List

from .results import MappingResult


class DisjointSets:
    """Union-find with union-by-rank (reference: src/common/dset64.hpp).

    Root selection matches dset64::unite exactly (dset64.hpp:87-99):
    the higher-rank root wins; on a rank tie the SMALLER id wins and
    its rank increments. Chain roots become splitMappingId values whose
    std::sort order decides each merged row's surviving head, so the
    tie-break is output-visible.
    """

    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def unite(self, a: int, b: int) -> None:
        r1, r2 = self.find(a), self.find(b)
        if r1 == r2:
            return
        if self.rank[r1] > self.rank[r2] or (
                self.rank[r1] == self.rank[r2] and r1 < r2):
            r1, r2 = r2, r1
        self.parent[r1] = r2
        if self.rank[r1] == self.rank[r2]:
            self.rank[r2] += 1


def merge_mappings_in_range(mappings: List[MappingResult],
                            max_dist: int) -> List[MappingResult]:
    """Chain and collapse fragment mappings (computeMap.hpp:1579-1704)."""
    if len(mappings) < 2:
        return mappings

    mappings.sort(key=lambda m: (m.ref_seq_id, m.ref_start, m.query_start))
    for i, m in enumerate(mappings):
        m.split_mapping_id = i
        m.discard = 0

    ds = DisjointSets(len(mappings))
    for i, a in enumerate(mappings):
        best: tuple | None = None
        for b in mappings[i + 1:]:
            if b.ref_seq_id != a.ref_seq_id \
                    or b.ref_start > a.ref_end + max_dist:
                break
            if b.strand != a.strand:
                continue
            ref_dist = b.ref_start - a.ref_end
            if a.strand == 1 and a.query_start <= b.query_start:
                query_dist = b.query_start - a.query_end
            elif a.strand != 1 and a.query_end >= b.query_end:
                query_dist = a.query_start - b.query_end
            else:
                continue
            dist = math.sqrt(query_dist ** 2 + ref_dist ** 2)
            score = float(query_dist - ref_dist) ** 2
            if dist < max_dist:
                cand = (dist + score, b.split_mapping_id)
                if best is None or cand < best:
                    best = cand
        if best is not None:
            ds.unite(a.split_mapping_id, best[1])

    for m in mappings:
        m.split_mapping_id = ds.find(m.split_mapping_id)

    # the reference sorts by splitMappingId with std::sort — UNSTABLE,
    # so the permutation of each chain's equal keys (and with it the
    # surviving head whose conservedSketches is PAF column 10, plus the
    # float accumulation order of the chain means) is a libstdc++
    # introsort artifact (computeMap.hpp:1646-1652). Replay it exactly.
    from .cxxsort import cxx_sort_perm
    perm = cxx_sort_perm([m.split_mapping_id for m in mappings])
    mappings = [mappings[i] for i in perm]

    out: List[MappingResult] = []
    i = 0
    while i < len(mappings):
        j = i
        while j < len(mappings) \
                and mappings[j].split_mapping_id == mappings[i].split_mapping_id:
            j += 1
        chain = mappings[i:j]
        head = chain[0]
        head.query_start = min(m.query_start for m in chain)
        head.ref_start = min(m.ref_start for m in chain)
        head.query_end = max(m.query_end for m in chain)
        head.ref_end = max(m.ref_end for m in chain)
        head.block_length = max(head.ref_end - head.ref_start,
                                head.query_end - head.query_start)
        head.approx_matches = cpp_round(
            head.nuc_identity * head.block_length / 100.0)
        head.n_merged = len(chain)
        # accumulate in CHAIN order (double adds are not associative;
        # the reference's accumulate iterates the introsort order), then
        # round the identity mean to FLOAT32: MappingResult::nucIdentity
        # is a C++ float member (base_types.hpp:164), so the double mean
        # rounds on assignment — without this, long chains drift in the
        # 6th printed id:f digit (seen on 3 of the 250 flagship rows at
        # chains of hundreds of fragments). kmerComplexity is a long
        # double member (base_types.hpp:173) — no rounding there.
        acc = 0.0
        for m in chain:
            acc += m.nuc_identity
        head.nuc_identity = float(np.float32(acc / len(chain)))
        acc = 0.0
        for m in chain:
            acc += m.kmer_complexity
        head.kmer_complexity = acc / len(chain)
        out.append(head)
        i = j
    return out
