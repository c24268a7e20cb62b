"""L2 row assembly of the device route, over whole batches of arrays.

``Mapper._do_l2`` (doL2Mapping, computeMap.hpp:1181-1267) turns one
group's L1 candidates and their L2 loci into rows. Its arithmetic is a
function of small integers: a locus's identity, the identity's upper
bound and the --pi test depend only on (shared, s_q), and the top-ANI
cut only on (the best passing shared so far, s_q), with s_q <= s.
``L2Tables`` holds those values, filled entry by entry on first use by
the scalar expressions below (so every value has their bits) and kept
per configuration in the process (``l2_tables``). ``assemble`` applies
them to every candidate and locus of a batch at once; ``_do_l2`` reads
the same tables one locus at a time.
"""

from __future__ import annotations

import functools
import itertools
import math
import threading

import numpy as np

from .. import stats
from ..params import FIXED
from .results import MappingResult


class L2Tables:
    """Per-(s_q, shared) row values of doL2Mapping for one (k, s, pi,
    keep_low_pct_id, ANIDiff). Arrays are indexed ``[s_q, shared]``;
    ``np.zeros`` leaves the rows no sketch size touches unbacked."""

    def __init__(self, k: int, s: int, pi: float, keep_low: bool,
                 ani_diff: float):
        self.k, self.pi, self.keep_low, self.ani_diff = (
            k, pi, keep_low, ani_diff)
        n = s + 1
        self.nuc = np.zeros((n, n))
        self.ub = np.zeros((n, n))
        self.passes = np.zeros((n, n), bool)
        self.min_inter = np.zeros((n, n), np.int64)
        self._have = np.zeros((n, n), bool)
        self._have_cut = np.zeros((n, n), bool)
        self._lock = threading.Lock()

    # --- the scalar expressions (computeMap.hpp:1196-1201, 1226-1234) ---
    def _fill_identity(self, s_q: int, shared: int) -> None:
        f32 = np.float32
        k = self.k
        mash_dist = stats.j2md(
            float(f32(1.0) * f32(shared) / f32(s_q)), k)
        nuc = float(f32(1) - f32(mash_dist))
        ub = 1.0 - stats.md_lower_bound(
            mash_dist, s_q, k, FIXED.confidence_interval)
        self.nuc[s_q, shared] = nuc
        self.ub[s_q, shared] = ub
        self.passes[s_q, shared] = (
            (self.keep_low and ub >= self.pi) or nuc >= self.pi)

    def _fill_cut(self, s_q: int, best: int) -> None:
        """The least intersection x that ``float(x) / s_q < cutoff_j``
        does not cut, cutoff_j computed from best_jacc_num = best as the
        reference computes it in float32."""
        f32 = np.float32
        k = self.k
        j_best = float(f32(float(best) / s_q))
        cutoff_ani = max(0.0, float(
            f32(f32(1.0) - f32(stats.j2md(j_best, k))
                - f32(self.ani_diff))))
        cutoff_j = float(f32(stats.md2j(1.0 - cutoff_ani, k)))
        x = max(0, math.floor(cutoff_j * s_q) - 1)
        while x > 0 and float(x - 1) / s_q >= cutoff_j:
            x -= 1
        while float(x) / s_q < cutoff_j:
            x += 1
        self.min_inter[s_q, best] = x

    def _ensure(self, have, fill, s_q, a) -> None:
        miss = ~have[s_q, a]
        if miss.any():
            with self._lock:
                for sq, x in set(zip(s_q[miss].tolist(), a[miss].tolist())):
                    if not have[sq, x]:
                        fill(sq, x)
                        have[sq, x] = True

    # --- lookups ---
    def identity(self, shared: np.ndarray, s_q: np.ndarray):
        """(nuc_identity, nuc_identity_ub, passes) of each locus."""
        self._ensure(self._have, self._fill_identity, s_q, shared)
        return (self.nuc[s_q, shared], self.ub[s_q, shared],
                self.passes[s_q, shared])

    def cut(self, best: np.ndarray, s_q: np.ndarray) -> np.ndarray:
        """The least intersection a candidate needs after the passing
        loci of best shared ``best`` (0: none yet)."""
        self._ensure(self._have_cut, self._fill_cut, s_q, best)
        return self.min_inter[s_q, best]

    def identity1(self, shared: int, s_q: int):
        """``identity`` of one locus, as Python scalars."""
        if not self._have[s_q, shared]:
            self.identity(np.array([shared]), np.array([s_q]))
        return (float(self.nuc[s_q, shared]), float(self.ub[s_q, shared]),
                bool(self.passes[s_q, shared]))

    def cut1(self, best: int, s_q: int) -> int:
        if not self._have_cut[s_q, best]:
            self.cut(np.array([best]), np.array([s_q]))
        return int(self.min_inter[s_q, best])


@functools.lru_cache(maxsize=8)
def l2_tables(k: int, s: int, pi: float, keep_low: bool,
              ani_diff: float) -> L2Tables:
    """The process's tables for one configuration."""
    return L2Tables(k, s, pi, keep_low, ani_diff)


def assemble(tab: L2Tables, top_ani: bool, c_frag, c_group, c_inter, c_sq,
             l_cand, l_shared, l_seq, l_pos):
    """doL2Mapping over a batch: which loci become rows, in row order.

    Candidates (``c_*``) belong to segments, one (fragment, group) pair
    each: one ``_do_l2`` call. Loci (``l_*``) name their candidate, those
    of a candidate contiguous and in order. Returns (rows, nuc, ub,
    n_segments): the emitted loci by fragment and then as each
    fragment's stable sort by (ref_seq_id, ref_start) over _do_l2's
    append order leaves them, their identities, and the segment count.
    """
    n_c = len(c_frag)
    # _do_l2's call order: fragment, group; within a call the candidates
    # by descending intersection, stably, under the top-ANI filter
    keys = (np.arange(n_c), c_group, c_frag)
    if top_ani:
        keys = (np.arange(n_c), -c_inter, c_group, c_frag)
    order = np.lexsort(keys)
    f, g = c_frag[order], c_group[order]
    new = np.ones(n_c, bool)
    new[1:] = (f[1:] != f[:-1]) | (g[1:] != g[:-1])
    nuc, ub, emit = tab.identity(l_shared, c_sq[l_cand])
    if top_ani and n_c:
        # best_jacc_num before each candidate: the segment's exclusive
        # running max of the candidates' best passing shared (offset by
        # segment, so that one running max restarts at each segment)
        best = np.zeros(n_c, np.int64)
        np.maximum.at(best, l_cand[emit], l_shared[emit])
        seg = np.cumsum(new) - 1
        off = seg * (int(best.max()) + 1)
        run = np.maximum.accumulate(best[order] + off)
        before = np.zeros(n_c, np.int64)
        before[1:] = run[:-1] - off[1:]
        before[new] = 0
        cut = c_inter[order] < tab.cut(before, c_sq[order])
        # _do_l2's break: a candidate lives while no earlier one of its
        # segment (nor itself) was cut
        fails = np.cumsum(cut)
        alive = np.empty(n_c, bool)
        alive[order] = fails == (fails - cut)[new][seg]
        emit = emit & alive[l_cand]
    rank = np.empty(n_c, np.int64)
    rank[order] = np.arange(n_c)
    rows = np.nonzero(emit)[0]
    c = l_cand[rows]
    # the candidate's rank, then the locus index, is the append order
    rows = rows[np.lexsort((rows, rank[c], l_pos[rows], l_seq[rows],
                            c_frag[c]))]
    return rows, nuc[rows], ub[rows], int(new.sum())


def mapping_results(q_len, ref_start, ref_seq_id, query_seq_id, nuc, ub,
                    s_q, shared, strand, complexity):
    """MappingResults of _do_l2's fields, one a row (arrays alike)."""
    ref_end = ref_start + q_len
    block = np.maximum(ref_end - ref_start, q_len)
    # output.cpp_round: half away from zero
    x = nuc * block / 100.0
    approx = np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))
    return list(map(
        MappingResult, q_len.tolist(), ref_start.tolist(), ref_end.tolist(),
        itertools.repeat(0), q_len.tolist(), ref_seq_id.tolist(),
        query_seq_id.tolist(), block.tolist(), nuc.tolist(), ub.tolist(),
        s_q.tolist(), shared.tolist(), strand.tolist(),
        approx.astype(np.int64).tolist(), complexity.tolist()))
