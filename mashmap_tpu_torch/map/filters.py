"""Mapping filters: plane sweeps and row predicates.

Reference: src/map/include/filter.hpp (query- and reference-axis plane
sweeps keeping the best + N secondary mappings at every swept position)
and the row predicates in computeMap.hpp:423-493.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .results import MappingResult

BEGIN = 1
END = 2


def _plane_sweep(mappings: List[MappingResult], secondary_to_keep: int,
                 axis: str, ref_lengths: np.ndarray | None = None) -> None:
    """Shared plane-sweep core; marks survivors via .discard.

    axis='query': events on [queryStart, queryEnd], BST ordered by
      (-identity, queryStart, refSeqId)  (filter.hpp:48-57,103-160).
    axis='ref': events on [(seq, refStart), (seq, refEnd)+1], BST ordered
      by (-identity, refStart)           (filter.hpp:261-270,334-394).
    """
    n = len(mappings)
    for m in mappings:
        m.discard = 1

    events = []
    for i, m in enumerate(mappings):
        if axis == "query":
            events.append((m.query_start, BEGIN, i))
            events.append((m.query_end, END, i))
        else:
            events.append(((m.ref_seq_id, m.ref_start), BEGIN, i))
            # advance end by one position with contig rollover
            # (filter.hpp:312-325)
            seq, pos = m.ref_seq_id, m.ref_end
            if pos == int(ref_lengths[seq]) - 1:
                seq, pos = seq + 1, 0
            else:
                pos += 1
            events.append(((seq, pos), END, i))
    events.sort(key=lambda e: (e[0], e[1], e[2]))

    if axis == "query":
        def bst_key(i):
            m = mappings[i]
            return (-m.nuc_identity, m.query_start, m.ref_seq_id)
    else:
        def bst_key(i):
            m = mappings[i]
            return (-m.nuc_identity, m.ref_start)

    # The reference's sweep status is a std::set ordered by bst_key:
    # key-equal mappings collapse into ONE element (later inserts are
    # no-ops, erase removes by key equivalence). A dict keyed by bst_key
    # reproduces that exactly.
    active: dict[tuple, int] = {}
    e = 0
    while e < len(events):
        e2 = e
        pos = events[e][0]
        while e2 < len(events) and events[e2][0] == pos:
            ev = events[e2]
            if ev[1] == BEGIN:
                active.setdefault(bst_key(ev[2]), ev[2])
            else:
                active.pop(bst_key(ev[2]), None)
            e2 += 1
        if active:
            ordered = [active[k] for k in sorted(active)]
            best_score = mappings[ordered[0]].nuc_identity
            kept = 0
            for i in ordered:
                m = mappings[i]
                worse_or_good = (m.nuc_identity < best_score
                                 or m.discard == 0)
                if axis == "query":
                    # markGood, filter.hpp:77-94: `kept` counts every mark
                    if worse_or_good and kept > secondary_to_keep:
                        break
                    m.discard = 0
                    kept += 1
                else:
                    # ref variant, filter.hpp:289-305: `kept` increments
                    # only on worse-or-already-good entries
                    if worse_or_good:
                        kept += 1
                        if kept > secondary_to_keep:
                            break
                    m.discard = 0
        e = e2

    mappings[:] = [m for m in mappings if m.discard == 0]


def filter_by_query_axis(mappings: List[MappingResult],
                         secondary_to_keep: int) -> None:
    """Filter::query::filterMappings (filter.hpp:225-229)."""
    if len(mappings) <= 1:
        return
    _plane_sweep(mappings, secondary_to_keep, "query")


def filter_by_ref_axis(mappings: List[MappingResult],
                       secondary_to_keep: int,
                       ref_lengths: np.ndarray) -> None:
    """Filter::ref::filterMappings (filter.hpp:334-394)."""
    if len(mappings) <= 1:
        return
    _plane_sweep(mappings, secondary_to_keep, "ref", ref_lengths)


def filter_weak_mappings(mappings: List[MappingResult],
                         min_count: int) -> List[MappingResult]:
    """Drop short merged chains (computeMap.hpp:423-433)."""
    return [m for m in mappings
            if not (m.query_len > m.block_length and m.n_merged < min_count)]


def filter_false_high_identity(mappings: List[MappingResult],
                               percentage_identity: float
                               ) -> List[MappingResult]:
    """Drop mappings whose ref/query spans disagree with the identity
    (computeMap.hpp:441-454)."""
    out = []
    for m in mappings:
        q_l = m.query_end - m.query_start
        r_l = m.ref_end + 1 - m.ref_start
        delta = abs(r_l - q_l)
        len_id_bound = 1.0 - (float(delta) / float(q_l)) if q_l else 0.0
        if len_id_bound >= min(0.7, percentage_identity ** 3):
            out.append(m)
    return out


def sparsify_mappings(mappings: List[MappingResult],
                      sparsity_hash_threshold: int) -> List[MappingResult]:
    """Keep rows hashing under the threshold (computeMap.hpp:482-493)."""
    if sparsity_hash_threshold >= (1 << 64) - 1:
        return mappings
    return [m for m in mappings
            if m.stable_hash() <= sparsity_hash_threshold]


def mapping_boundary_sanity_check(mappings: List[MappingResult],
                                  query_len: int,
                                  ref_lengths: np.ndarray) -> None:
    """Clamp coordinates into sequence bounds (computeMap.hpp:1713-1750)."""
    for m in mappings:
        rlen = int(ref_lengths[m.ref_seq_id])
        if m.ref_start < 0:
            m.ref_start = 0
        if m.ref_start >= rlen:
            m.ref_start = rlen - 1
        if m.ref_end < m.ref_start:
            m.ref_end = m.ref_start
        if m.ref_end >= rlen:
            m.ref_end = rlen - 1
        if m.query_start < 0:
            m.query_start = 0
        if m.query_start >= query_len:
            m.query_start = query_len
        if m.query_end < m.query_start:
            m.query_end = m.query_start
        if m.query_end >= query_len:
            m.query_end = query_len
