"""Mapping engine orchestration.

Counterpart of ``mashmap_tpu/map/engine.py``; equivalent of
``skch::Map`` (reference: computeMap.hpp:53-1818):

- query sequences are cut into segLength fragments that form a flat
  batch axis; each batch runs ``l1_step`` and then ``l2_step`` on the
  device (kernels/mapdev.py; on CUDA each call of the replicated path
  is the replay of a CUDA graph captured for its shape, kernels/
  graphs.py) — on a list of devices, one contiguous row
  block each (parallel/mesh.py), over a replicated or a sharded index
  (parallel/sharded_index.py) — with at most two batches in flight
  (``Mapper._run_pipelined``) and every copy queued on the stream
  (hostcopy.py);
- fragments or candidates that overflow the device caps take the host
  routes (map/l1.py, map/l2.py), which give the same rows;
- results are regrouped per query (a query's fragments may span
  batches), chained/merged/filtered on the host, and written in input
  order.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time
from typing import IO, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import stats, trace
from ..hostcopy import HostCopy, to_device
from ..params import FIXED, Parameters, FILTER_MAP, FILTER_ONETOONE
from ..index.builder import ReferenceIndex
from ..kernels import graphs, kmers
from ..kernels.murmur import INT64_MIN
from ..kernels.sketch import sketch_fragments, complexity_rescale
from ..parallel.mesh import distinct, make_mesh
from ..parallel.sharded_index import L2_T_MAX
from . import l1 as l1_mod
from . import l2 as l2_mod
from . import filters, merge, output
from .results import MappingResult
from .rows import assemble, l2_tables, mapping_results

logger = logging.getLogger("mashmap_tpu_torch.map")

# L2 work buckets by interval-slice length; W*T per call stays constant.
# The sharded index keeps a coarser ladder (its routing by owner
# multiplies the calls by the shard count); its top is the slab halo.
T_BUCKETS = (512, 1024, 2048, L2_T_MAX)
T_BUCKETS_SHARDED = (512, 2048, L2_T_MAX)
# bytes that one (W, s, 2T) int32 intermediate of l2_step (its
# per-bucket active counts) may take: an L2 call's width W is cut to stay
# under it. By default W * 2T = l2_batch * l2_entries_cap = 2^20, so each
# such tensor is 4 MiB x s: no call is cut at s <= 1024, and above it a
# call's peak (about seven such tensors) stays near 30 GB, not 106 GB at
# s = 3780. Items are independent, so the width never changes a result.
L2_BYTES = 4 << 30


def _round_up(n: int, m: int) -> int:
    return n + (-n) % m


def _l2_widths(area: int, T: int, s: int, n_dev: int = 1):
    """(W_STEP, W_SMALL): L2 work items per call at bucket T, and the
    quarter width a trailing partial chunk drops to. W_STEP * T stays
    at area, cut so that one (W, s, 2T) int32 intermediate stays under
    L2_BYTES (unless one item a device is already over it); both are
    multiples of n_dev."""
    w_step = _round_up(max(8, area // T), n_dev)
    cut = L2_BYTES // (2 * T * s * 4)
    if w_step > cut:
        w_step = max(n_dev, cut - cut % n_dev)
    return w_step, min(w_step, _round_up(max(8, w_step // 4), n_dev))


def _batch_pad_rows(B: int, batch_fragments: int, n_dev: int = 1) -> int:
    """Padded row count for a B-fragment batch: {2^k, 1.5*2^k} grid,
    quarter-width tail floor, full-batch floor, divisible by the device
    count."""
    Bp = 1 << max(3, (B - 1).bit_length())
    if B <= (Bp * 3) // 4:
        Bp = (Bp * 3) // 4
    b_small = min(batch_fragments, max(64, batch_fragments // 4))
    if B <= b_small:
        Bp = b_small
    else:
        Bp = max(batch_fragments, Bp)
    return _round_up(Bp, n_dev)


def _gather_sketch_rows(qh_dev, qs_dev, indices):
    """Device row gather of sketch codes/strands at ``indices`` (batch
    rows); returns their copies to the host (HostCopy), started."""
    ix = to_device(np.asarray(indices, np.int64), qh_dev.device)
    return HostCopy(qh_dev[ix]), HostCopy(qs_dev[ix])


@dataclasses.dataclass
class _Fragment:
    query_idx: int          # position in the batch's query list
    q_start: int            # fragment offset within the query
    q_len: int              # fragment length (== Q.len)
    window_len: int         # max(0, q_len - seg_length)
    q: object = None        # owning _Query
    ord: int = 0            # ordinal within the query


@dataclasses.dataclass
class _Query:
    name: str
    seq: str
    counter: int            # global sequence counter (file order)
    # pipelined-path state: fragments of one query may land in different
    # device batches, so per-query results accumulate here until every
    # fragment has been delivered
    u8: object = None       # sanitized bytes (np.uint8)
    allowed: object = None  # admissible-reference mask (or None)
    qg: int = -1            # reference prefix group
    n_frags: int = 0
    done: int = 0
    counted: int = 0        # bp already credited to the progress meter
    rows: object = None     # per-ordinal [(fragment, rows)]


@dataclasses.dataclass
class _Batch:
    """One in-flight device batch of fragments."""
    frags: list
    ordinal: int = 0            # the Mapper's batch count at dispatch
    mat: object = None          # (B, L) uint8 host matrix
    out: object = None          # l1_step packed meta, copying (HostCopy)
    qh_dev: object = None       # (B, s) sketch codes (device)
    qs_dev: object = None
    stage: int = 0              # 0 = l1 dispatched, 1 = l2 dispatched
    o: object = None            # unpacked l1 meta (host)
    cx: object = None
    host_frag: object = None    # (B,) bool: the fragment takes host L1
    # the L2 work items, one a candidate (arrays; _collect_l1): frag,
    # cand, lo, mid, hi, seq, inter, sq, and host (replayed on the host)
    work: object = None
    pending: object = None      # [(chunk of work items, nrows)]
    pcat: object = None         # concatenated l2 run buffers (HostCopy)
    # (frag indices, HostCopy pair of their sketch rows), gathered at
    # L2 dispatch for the host replay
    qh_pick: object = None
    loci: object = None         # the device loci (arrays; _collect_l2)
    qh_host: object = None


class Mapper:
    """L1+L2 mapping pipeline against a built ReferenceIndex.

    Runs on ``devices`` (parallel/mesh.py: by default ``[device]`` when
    a device is named, else every visible CUDA device); outputs gather on
    the first. With ``params.shard_index`` and more than one entry the
    index is split across them (parallel/sharded_index.py).
    """

    @trace.span("map setup")
    def __init__(self, params: Parameters, index: ReferenceIndex,
                 device=None, devices=None):
        self.p = params
        self.idx = index
        if devices is None and device is not None:
            devices = [device]
        self.devices = make_mesh(devices)
        self.device = self.devices[0]
        self._n_dev = len(self.devices)
        self._sharded = None
        self._dist = None
        self._mi_key = None
        self._host_tables = None
        self._dev = None
        self._cfg = None
        self.table_scale = max(
            1.0, params.sketch_size / FIXED.ss_table_max)
        self.cutoff_table = None
        if params.stage1_topANI_filter:
            with trace.span("setup-cutoffs"):
                self.cutoff_table = stats.sketch_cutoffs(
                    params.sketch_size, params.kmer_size,
                    params.ANIDiff, params.ANIDiffConf, FIXED.ss_table_max)
        self.ref_groups = self._set_ref_groups() \
            if params.skip_prefix else np.zeros(index.n_contigs, np.int64)
        self._min_hits_cache: dict[int, int] = {}
        # doL2Mapping's per-locus values, shared by the process's Mappers
        self.l2_tab = l2_tables(
            params.kmer_size, params.sketch_size,
            params.percentage_identity, params.keep_low_pct_id,
            params.ANIDiff)
        self._name_arr = np.array(index.names)
        # one-to-one bookkeeping
        self.qmetadata: list[tuple[str, int]] = []
        self._buffered: List[MappingResult] = []
        # counters (reference prints these at the end, computeMap.hpp:409-414)
        self.total_reads_picked = 0
        self.total_reads_mapped = 0
        self.total_seq_counter = 0
        self.total_bp = 0
        # which device/host routes ran
        self.path_stats = {"host_frags": 0, "host_l2": 0,
                           "l2_buckets": {}}
        # host seconds of each map phase, summed over batches (_clock)
        self.phase_s: dict[str, float] = {}
        self._batches = 0

    def _clock(self, batch=None):
        """mark(label): the host seconds since the previous mark (or
        since this call) are logged as a map phase and added to
        ``phase_s[label]``; a span ``map <label>`` of ``batch`` while
        recording (trace.py)."""
        return trace.clock("map ", self._phase, batch)

    def _phase(self, label: str, seconds: float) -> None:
        self.phase_s[label] = self.phase_s.get(label, 0.0) + seconds
        logger.debug("map phase %-13s %.4fs", label, seconds)

    @property
    def mi_key(self) -> np.ndarray:
        """Packed (seqid << 32 | wpos) interval sort keys, host-side
        (host L2 route only)."""
        if self._mi_key is None:
            self._mi_key = l2_mod.pack_mi_key(
                self.idx.mi_seqid, self.idx.mi_wpos)
        return self._mi_key

    # --- prefix grouping (computeMap.hpp:144-177) ---
    @staticmethod
    def _prefix(name: str, delim: str) -> str:
        i = name.rfind(delim)
        return name if i < 0 else name[:i]

    def _set_ref_groups(self) -> np.ndarray:
        groups = np.zeros(self.idx.n_contigs, np.int64)
        group = 0
        i = 0
        while i < self.idx.n_contigs:
            pref = self._prefix(self.idx.names[i], self.p.prefix_delim)
            j = i
            while j < self.idx.n_contigs and \
                    self._prefix(self.idx.names[j],
                                 self.p.prefix_delim) == pref:
                groups[j] = group
                j += 1
            group += 1
            i = j
        return groups

    def _get_ref_group(self, seq_name: str) -> int:
        if not hasattr(self, "_prefix_to_group"):
            self._prefix_to_group = {}
            for i in range(self.idx.n_contigs):
                pref = self._prefix(self.idx.names[i],
                                    self.p.prefix_delim)
                self._prefix_to_group.setdefault(
                    pref, int(self.ref_groups[i]))
        return self._prefix_to_group.get(
            self._prefix(seq_name, self.p.prefix_delim), -1)

    # --- cached statistics ---
    def _minimum_hits(self, s_q: int) -> int:
        v = self._min_hits_cache.get(s_q)
        if v is None:
            v = stats.estimate_minimum_hits_relaxed(
                s_q, self.p.kmer_size, self.p.percentage_identity,
                FIXED.confidence_interval)
            self._min_hits_cache[s_q] = v
        return v

    # ------------------------------------------------------------------
    def _fragment_query(self, qlen: int) -> List[Tuple[int, int]]:
        """(q_start, q_len) per fragment (computeMap.hpp:587-671)."""
        p = self.p
        if not p.split or qlen <= p.seg_length:
            return [(0, qlen)]
        out = []
        n = qlen // p.seg_length
        for i in range(n):
            out.append((i * p.seg_length, p.seg_length))
        if n >= 1 and qlen % p.seg_length != 0:
            out.append((qlen - p.seg_length, p.seg_length))
        return out

    def _sketch_batch(self, seqs: List[np.ndarray]):
        """Device-sketch fragments, bucketed by padded length."""
        p = self.p
        n = len(seqs)
        res_h = [None] * n
        res_s = [None] * n
        res_cnt = [0] * n
        res_cx = [0.0] * n
        buckets: dict[int, list[int]] = {}
        for i, sq in enumerate(seqs):
            pl = max(p.seg_length,
                     -(-len(sq) // p.seg_length) * p.seg_length)
            buckets.setdefault(pl, []).append(i)
        for pl, idxs in buckets.items():
            mat = np.full((len(idxs), pl), ord("N"), np.uint8)
            for r, i in enumerate(idxs):
                mat[r, : len(seqs[i])] = seqs[i]
            h, st, cnt, cx = sketch_fragments(
                torch.from_numpy(mat).to(self.device), p.kmer_size,
                p.sketch_size)
            h = h.cpu().numpy().view(np.uint64)
            st = st.cpu().numpy()
            cnt = cnt.cpu().numpy()
            cx = cx.cpu().numpy()
            for r, i in enumerate(idxs):
                res_h[i] = h[r]
                res_s[i] = st[r]
                res_cnt[i] = int(cnt[r])
                res_cx[i] = float(complexity_rescale(
                    cx[r], pl, np.int64(len(seqs[i])), p.kmer_size))
        return res_h, res_s, res_cnt, res_cx

    # ------------------------------------------------------------------
    def _map_fragment(self, q: _Query, frag: _Fragment,
                      q_hashes: np.ndarray, q_strand: np.ndarray,
                      count: int, complexity: float,
                      allowed: Optional[np.ndarray],
                      q_ref_group: int) -> List[MappingResult]:
        """mapSingleQueryFrag equivalent on the host
        (computeMap.hpp:755-815)."""
        p = self.p
        if count == 0 or complexity < p.kmer_complexity_threshold:
            return []
        hashes = q_hashes[:count]
        strands = q_strand[:count].astype(np.int64)
        # frequent-seed filtering (computeMap.hpp:833-839)
        freq = self.idx.is_freq_seed(hashes)
        if freq.any():
            hashes = hashes[~freq]
            strands = strands[~freq]
        s_q = len(hashes)
        if s_q == 0:
            return []

        minimum_hits = self._minimum_hits(s_q)
        seqid, wpos, wend, hrep = l1_mod.gather_postings(self.idx, hashes)
        if allowed is not None and len(seqid):
            keep = allowed[seqid]
            seqid, wpos, wend, hrep = (seqid[keep], wpos[keep],
                                       wend[keep], hrep[keep])
        if len(seqid) == 0:
            return []

        # group interval points by reference prefix group
        # (doL1Mapping, computeMap.hpp:1146-1165)
        if p.skip_prefix:
            gsel = self.ref_groups[seqid]
            group_vals = np.unique(gsel)
        else:
            gsel = None
            group_vals = np.array([0])

        wl = frag.window_len
        rows: List[MappingResult] = []
        for gv in group_vals:
            if gsel is None:
                sq, wp, we, hr = seqid, wpos, wend, hrep
            else:
                sel = gsel == gv
                sq, wp, we, hr = (seqid[sel], wpos[sel], wend[sel],
                                  hrep[sel])
            if wl == 0:
                cands = l1_mod.l1_candidates(
                    sq, wp, we, minimum_hits, s_q, p.seg_length,
                    p.stage1_topANI_filter, self.cutoff_table,
                    self.table_scale, p.stage2_full_scan)
            else:
                cands = l1_mod.l1_candidates_windowed(
                    sq, wp, we, hr, wl, minimum_hits, s_q,
                    p.seg_length, p.stage1_topANI_filter,
                    self.cutoff_table, self.table_scale,
                    p.stage2_full_scan)
            rows.extend(self._do_l2(q, frag, hashes, strands, s_q,
                                    complexity, cands))
        rows.sort(key=lambda m: (m.ref_seq_id, m.ref_start))
        return rows

    def _do_l2(self, q: _Query, frag: _Fragment, hashes, strands, s_q,
               complexity, cands,
               loci_fn=None) -> List[MappingResult]:
        """doL2Mapping equivalent (computeMap.hpp:1181-1267).

        loci_fn(candidate) -> List[L2Locus] lets the device pipeline
        supply precomputed trajectories. The arithmetic is the tables'
        (rows.L2Tables), which the device route's rows.assemble applies
        to whole batches.
        """
        p = self.p
        tab = self.l2_tab
        if not cands:
            return []
        if p.stage1_topANI_filter:
            cands = sorted(cands, key=lambda c: -c.intersection)
        best_jacc_num = 0
        rows: List[MappingResult] = []
        for c in cands:
            if p.stage1_topANI_filter and \
                    c.intersection < tab.cut1(best_jacc_num, s_q):
                break
            if loci_fn is not None:
                loci = loci_fn(c)
            else:
                loci = l2_mod.l2_mapped_regions(
                    self.idx, self.mi_key, hashes, strands,
                    c.seq_id, c.range_start, c.range_end,
                    p.seg_length, frag.window_len)
            for loc in loci:
                nuc_id, nuc_id_ub, passes = tab.identity1(
                    loc.shared_sketch_size, s_q)
                if passes:
                    best_jacc_num = max(best_jacc_num,
                                        loc.shared_sketch_size)
                    m = MappingResult(
                        query_len=frag.q_len,
                        ref_start=loc.mean_optimal_pos,
                        ref_end=loc.mean_optimal_pos + frag.q_len,
                        query_start=0,
                        query_end=frag.q_len,
                        ref_seq_id=loc.seq_id,
                        query_seq_id=q.counter,
                        nuc_identity=nuc_id,
                        nuc_identity_ub=nuc_id_ub,
                        sketch_size=s_q,
                        conserved_sketches=loc.shared_sketch_size,
                        strand=loc.strand,
                        kmer_complexity=complexity,
                    )
                    m.block_length = max(m.ref_end - m.ref_start,
                                         m.query_end - m.query_start)
                    m.approx_matches = output.cpp_round(
                        m.nuc_identity * m.block_length / 100.0)
                    rows.append(m)
        return rows

    # ------------------------------------------------------------------
    def _allowed_mask(self, q: _Query) -> Optional[np.ndarray]:
        """Per-query admissible reference sequences
        (getSeedIntervalPoints, computeMap.hpp:887-894)."""
        p = self.p
        if not (p.skip_self or p.skip_prefix or p.lower_triangular):
            return None
        allowed = np.ones(self.idx.n_contigs, bool)
        if p.skip_self:
            allowed &= self._name_arr != q.name
        if p.lower_triangular:
            allowed &= q.counter > np.arange(self.idx.n_contigs)
        if p.skip_prefix:
            qg = self._get_ref_group(q.name)
            allowed &= self.ref_groups != qg
        return allowed

    def _fragments_of(self, queries: List[_Query]) -> List[_Fragment]:
        p = self.p
        frags: List[_Fragment] = []
        for qi, q in enumerate(queries):
            for (qs, qlen) in self._fragment_query(len(q.seq)):
                frags.append(_Fragment(
                    qi, qs, qlen, max(0, qlen - p.seg_length)))
        return frags

    def map_queries(self, queries: List[_Query]) -> List[
            Tuple[_Query, List[MappingResult]]]:
        """Map a batch of query sequences."""
        p = self.p
        frags = self._fragments_of(queries)
        all_wl0 = all(fr.window_len == 0 for fr in frags)
        if p.use_device_pipeline and all_wl0 and len(frags):
            rows_by_frag = self._run_fragments_device(queries, frags)
        else:
            rows_by_frag = self._run_fragments_host(queries, frags)
        return self._assemble(queries, frags, rows_by_frag)

    def _run_fragments_host(self, queries, frags):
        p = self.p
        sanitized = [kmers.sanitize(q.seq.encode("ascii"))
                     for q in queries]
        frag_seqs = [
            sanitized[fr.query_idx][fr.q_start:fr.q_start + fr.q_len]
            for fr in frags]
        h, st, cnt, cx = self._sketch_batch(frag_seqs)
        allowed = [self._allowed_mask(q) for q in queries]
        qg = [self._get_ref_group(q.name) if p.skip_prefix else -1
              for q in queries]
        out = []
        for fi, fr in enumerate(frags):
            q = queries[fr.query_idx]
            out.append(self._map_fragment(
                q, fr, h[fi], st[fi], cnt[fi], cx[fi],
                allowed[fr.query_idx], qg[fr.query_idx]))
        return out

    def _assemble(self, queries, frags, rows_by_frag):
        """Per-query post-processing (mapModule, computeMap.hpp:674-712)."""
        results: List[Tuple[_Query, List[MappingResult]]] = []
        fi = 0
        for qi, q in enumerate(queries):
            frag_rows = []
            while fi < len(frags) and frags[fi].query_idx == qi:
                frag_rows.append((frags[fi], rows_by_frag[fi]))
                fi += 1
            results.append((q, self._postprocess_query(q, frag_rows)))
        return results

    def _postprocess_query(self, q: _Query, frag_rows) -> \
            List[MappingResult]:
        """Merge / filter one query's fragment rows (computeMap.hpp:
        674-712). `frag_rows` is [(fragment, rows)] in fragment order."""
        p = self.p
        qlen = len(q.seq)
        unfiltered: List[MappingResult] = []
        split_mapping = p.split and qlen > p.seg_length
        for fr, rows in frag_rows:
            if split_mapping:
                for m in rows:
                    m.query_len = qlen
                    m.query_start = fr.q_start
                    m.query_end = fr.q_start + fr.q_len
            unfiltered.extend(rows)

        n_mappings = (p.num_mappings_for_short_sequence
                      if qlen < p.seg_length
                      else p.num_mappings_for_segment) - 1

        if split_mapping and p.merge_mappings:
            unfiltered = merge.merge_mappings_in_range(
                unfiltered, p.chain_gap)
            unfiltered = filters.filter_weak_mappings(
                unfiltered, p.block_length // p.seg_length)

        if p.filter_mode in (FILTER_MAP, FILTER_ONETOONE):
            unfiltered = self._filter_by_group(
                unfiltered, n_mappings, filter_ref=False)

        if p.filter_length_mismatches:
            unfiltered = filters.filter_false_high_identity(
                unfiltered, p.percentage_identity)

        filters.mapping_boundary_sanity_check(
            unfiltered, qlen, self.idx.lengths)
        return filters.sparsify_mappings(
            unfiltered, p.sparsity_hash_threshold)

    # --- device fragment pipeline ------------------------------------
    def _device_tables(self):
        """The lookup tables and the index on the devices. Replicated:
        one table set per distinct device in ``self._tables``, on CUDA the
        device's graph-cache set (kernels/graphs.py) bound to this Mapper
        at every call, so that another Mapper's use of the device in
        between cannot leave its contents there. With shard_index on more
        than one entry: the index split across the entries and only the
        small tables on the first, made once. Returns the first device's
        tables."""
        if self._host_tables is None:
            self._host_tables = self._make_host_tables()
        if self._sharded is not None:
            if self._dev is None:
                with trace.span("tables-upload"):
                    self._dev = {k: to_device(a, self.device)
                                 for k, a in self._host_tables.items()}
            return self._dev
        self._tables = {d: graphs.tables(d, self, self._host_tables)
                        for d in distinct(self.devices)}
        self._dev = self._tables[self.device]
        return self._dev

    @trace.span("tables-host")
    def _make_host_tables(self):
        """The tables of _device_tables as numpy arrays (name -> array);
        builds the sharded index where one is asked for."""
        p = self.p
        idx = self.idx
        mh_table = np.ones(p.sketch_size + 1, np.int32)
        for sq in range(1, p.sketch_size + 1):
            mh_table[sq] = max(1, self._minimum_hits(sq))
        ct = (self.cutoff_table.astype(np.int32)
              if self.cutoff_table is not None else np.ones(2, np.int32))
        if p.shard_index and self._n_dev > 1:
            from ..parallel.sharded_index import build_sharded_index
            self._sharded = build_sharded_index(idx, self.devices)
        elif p.shard_index:
            logger.warning(
                "shard_index requested but only one device is visible; "
                "falling back to the replicated index")
        t = {"min_hits_table": mh_table, "cutoff_table": ct,
             "ref_group": self.ref_groups.astype(np.int32)}
        if self._sharded is None:
            t.update({
                # flip (kernels/murmur.py) on the host
                "uniq_flip": idx.uniq_hashes.view(np.int64)
                ^ np.int64(INT64_MIN),
                "post_offsets": np.asarray(idx.post_offsets, np.int64),
                "post_seqid": idx.post_seqid,
                "post_wpos": idx.post_wpos,
                "post_wend": idx.post_wend,
                "is_frequent": idx.is_frequent,
                "mi_key": self.mi_key,
                "mi_seqid": idx.mi_seqid,
                "mi_wpos": idx.mi_wpos,
                "mi_rank": idx.mi_rank,
                "mi_wend": idx.mi_wend,
                "mi_strand": idx.mi_strand,
            })
        return t

    def _row_blocks(self, n_rows: int):
        """(device, rows) of each device's contiguous block of ``n_rows``
        rows (a multiple of the device count)."""
        step = n_rows // self._n_dev
        return [(d, slice(i * step, (i + 1) * step))
                for i, d in enumerate(self.devices)]

    def _cat_rows(self, parts):
        """Per-block outputs concatenated in row order on the first
        device."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([x.to(self.device) for x in parts])

    def _l1cfg(self):
        from ..kernels.mapdev import L1Config
        p = self.p
        if self._cfg is not None:
            return self._cfg
        if p.skip_prefix:
            ng = 1 << max(3, int(self.ref_groups.max() + 1).bit_length())
        else:
            ng = 8
        self._cfg = L1Config(
            k=p.kmer_size, s=p.sketch_size, seg_length=p.seg_length,
            p_cap=p.l1_postings_cap, c_cap=p.l1_candidates_cap,
            t_cap=p.l2_entries_cap, table_scale=self.table_scale,
            n_groups=ng)
        return self._cfg

    @trace.span("map prepare")
    def _prepare_query(self, q: _Query) -> None:
        q.u8 = kmers.sanitize(q.seq.encode("ascii"))
        q.allowed = self._allowed_mask(q)
        q.qg = self._get_ref_group(q.name) if self.p.skip_prefix else -1

    def _run_fragments_device(self, queries, frags):
        """One device batch over `frags`, then host post-processing."""
        for q in queries:
            if q.u8 is None:
                self._prepare_query(q)
        for fr in frags:
            fr.q = queries[fr.query_idx]
        ctx = self._dispatch_batch(frags)
        self._collect_l1(ctx)
        self._collect_l2(ctx)
        return [rows for _, rows in self._post_batch(ctx)]

    def _dispatch_batch(self, frags) -> _Batch:
        """Stage 1: host matrix prep + l1_step (one call per device
        block, or the sharded step); the packed meta's copy to the host
        starts behind it."""
        from ..kernels.mapdev import l1_step

        p = self.p
        ordinal = self._batches
        self._batches += 1
        mark = self._clock(ordinal)
        dev = self._device_tables()
        mark("l1-tables")
        cfg = self._l1cfg()
        B = len(frags)
        Bp = _batch_pad_rows(B, p.batch_fragments, self._n_dev)
        L = p.seg_length
        with trace.span("l1-pack"):
            mat = np.full((Bp, L), ord("N"), np.uint8)
            allowed = np.zeros((Bp, self.idx.n_contigs), bool)
            for i, fr in enumerate(frags):
                mat[i, :fr.q_len] = fr.q.u8[fr.q_start:fr.q_start + fr.q_len]
                allowed[i] = True if fr.q.allowed is None else fr.q.allowed
        if self._sharded is not None:
            from ..parallel.sharded_index import l1_step_sharded
            si = self._sharded
            # gather at most p_cap postings a shard: a row with more
            # overflows to the host route however many are gathered
            out, qh_dev, qs_dev = l1_step_sharded(
                to_device(mat, self.device), si.uniq, si.offsets, si.seqid,
                si.wpos, si.wend, si.frequent, dev["min_hits_table"],
                dev["cutoff_table"], to_device(allowed, self.device),
                dev["ref_group"], si.mi_key, si.mi_row0, si.key_bounds,
                cfg, min(si.p_shard, cfg.p_cap))
        else:
            parts = []
            for d, rows in self._row_blocks(Bp):
                t = self._tables[d]
                parts.append(graphs.call(d, l1_step, (
                    mat[rows], t["uniq_flip"], t["post_offsets"],
                    t["post_seqid"], t["post_wpos"], t["post_wend"],
                    t["is_frequent"], t["min_hits_table"],
                    t["cutoff_table"], allowed[rows], t["ref_group"],
                    t["mi_key"]), cfg))
            out, qh_dev, qs_dev = (self._cat_rows(x) for x in zip(*parts))
        ctx = _Batch(frags=frags, ordinal=ordinal, mat=mat[:B],
                     out=HostCopy(out), qh_dev=qh_dev, qs_dev=qs_dev)
        mark("l1-dispatch")
        return ctx

    def _collect_l1(self, ctx: _Batch):
        """Stage 2: pick up the l1 meta, derive the L2 work, dispatch
        the l2 chunks; one copy of their run buffers and of the sketch
        rows of the host-replay items known now starts behind them.

        The wait overlaps whatever is queued behind this batch's l1_step
        on the device (the next batch's l1, earlier l2 chunks)."""
        from ..kernels.mapdev import unpack_l1_meta

        p = self.p
        cfg = self._l1cfg()
        frags = ctx.frags
        B = len(frags)
        L = p.seg_length
        mark = self._clock(ctx.ordinal)
        meta = ctx.out.wait()
        mark("l1-wait")
        o = unpack_l1_meta(meta[:B], cfg.c_cap)
        ctx.out = None
        ctx.o = o

        # complexity rescale for 'N'-padded fragments
        q_len = np.array([fr.q_len for fr in frags], np.int64)
        cx = (o["complexity"].astype(np.float64) * (L - p.kmer_size + 1)
              / np.maximum(1, q_len - p.kmer_size + 1))
        ctx.cx = cx

        # one work item a candidate of every fragment that maps on the
        # device, in (fragment, candidate) order
        ctx.host_frag = o["overflow"].copy()
        self.path_stats["host_frags"] += int(ctx.host_frag.sum())
        live = ~ctx.host_frag & (o["s_q"] != 0) \
            & (cx >= p.kmer_complexity_threshold)
        i, j = np.nonzero(live[:, None] & (
            np.arange(cfg.c_cap)[None, :] < o["n_cand"][:, None]))
        w = {"frag": i, "cand": j, "lo": o["cand_lo"][i, j],
             "mid": o["cand_mid"][i, j], "hi": o["cand_hi"][i, j],
             "seq": o["cand_seq"][i, j], "inter": o["cand_inter"][i, j],
             "sq": o["s_q"][i]}
        mark("l1-fetch")

        # bucket work items by interval-slice length; W*T stays constant;
        # a slice over the top bucket replays on the host
        AREA = p.l2_batch * p.l2_entries_cap // 2
        t_buckets = (T_BUCKETS_SHARDED if self._sharded is not None
                     else T_BUCKETS)
        bucket = np.searchsorted(np.asarray(t_buckets), w["hi"] - w["lo"])
        # largest T first: a device's first L2 capture is then its
        # largest, and the smaller shapes' captures fit in the pool
        # segments it made. Smallest first, a job whose first batch holds
        # a short slice reserved 1.82 GiB more at s = 310. Results are
        # put back in item order, so the order changes no output.
        buckets = {}
        for b, t in reversed(list(enumerate(t_buckets))):
            buckets[t] = np.nonzero(bucket == b)[0]
            if len(buckets[t]):
                self.path_stats["l2_buckets"][t] = \
                    self.path_stats["l2_buckets"].get(t, 0) \
                    + len(buckets[t])
        w["host"] = bucket == len(t_buckets)
        self.path_stats["host_l2"] += int(w["host"].sum())
        ctx.work = w
        if self._sharded is not None:
            pending = self._l2_sharded(ctx, buckets, AREA)
        else:
            pending = self._l2_replicated(ctx, buckets, AREA)
        # every chunk's run buffer has the same width: one concatenation
        # on the device and one copy, which has usually landed by the
        # time _collect_l2 runs (after the next batch's l1 dispatch)
        if pending:
            ctx.pcat = HostCopy(torch.cat([b for _, b in pending])
                                if len(pending) > 1 else pending[0][1])
        ctx.pending = [(chunk, b.shape[0]) for chunk, b in pending]
        # host-replay sketch rows known now: gathered right behind this
        # batch's L2 chunks; a gather started in _collect_l2 would queue
        # behind later batches' l1_step and L2 work and wait for it
        need = np.unique(w["frag"][w["host"]]).tolist()
        ctx.qh_pick = (need, _gather_sketch_rows(
            ctx.qh_dev, ctx.qs_dev, need) if need else None)
        ctx.stage = 1
        mark("l2-dispatch")

    @staticmethod
    def _work_arrays(items, w, Wp: int, row0: int = 0):
        """L2 call inputs of the work items ``items`` (up to Wp): (4, Wp)
        int32 lo, mid, hi (rebased by row0) and seq; owning fragment;
        s_q (pads 1)."""
        n = len(items)
        wa = np.zeros((4, Wp), np.int32)
        fidx = np.zeros(Wp, np.int64)
        sqv = np.ones(Wp, np.int32)
        wa[0, :n] = w["lo"][items] - row0
        wa[1, :n] = w["mid"][items] - row0
        wa[2, :n] = w["hi"][items] - row0
        wa[3, :n] = w["seq"][items]
        fidx[:n] = w["frag"][items]
        sqv[:n] = w["sq"][items]
        return wa, fidx, sqv

    def _l2_replicated(self, ctx: _Batch, buckets, AREA: int):
        """l2_step over chunks of each bucket, each chunk split into one
        block per device; returns [(chunk, run buffer)]."""
        from ..kernels.mapdev import l2_step
        p = self.p
        pending = []
        for T, todo in buckets.items():
            # a trailing partial chunk drops to a quarter-width call
            W_STEP, W_SMALL = _l2_widths(AREA, T, p.sketch_size,
                                         self._n_dev)
            for w0 in range(0, len(todo), W_STEP):
                chunk = todo[w0:w0 + W_STEP]
                Wp = W_SMALL if len(chunk) <= W_SMALL else W_STEP
                wa, fidx, sqv = self._work_arrays(chunk, ctx.work, Wp)
                parts = []
                for d, rows in self._row_blocks(Wp):
                    t = self._tables[d]
                    # sketches stay on the device: a row gather by
                    # fragment index
                    fi = to_device(fidx[rows], self.device)
                    parts.append(graphs.call(d, l2_step, (
                        wa[0, rows], wa[1, rows], wa[2, rows], wa[3, rows],
                        ctx.qh_dev[fi].to(d), ctx.qs_dev[fi].to(d),
                        sqv[rows], t["mi_rank"], t["mi_wpos"], t["mi_wend"],
                        t["mi_strand"], t["mi_seqid"]), T, p.sketch_size))
                pending.append((chunk, self._cat_rows(parts)))
        return pending

    def _l2_sharded(self, ctx: _Batch, buckets, AREA: int):
        """l2_step over the row-range-sharded interval table: each work
        item routes to the shard whose slab holds its slice (bounds
        rebased to slab rows), one round of up to W_STEP items a shard
        per call (a quarter-width call where every shard's share fits);
        pad rows are -1 in the chunk. Returns [(chunk, run buffer)]."""
        from ..parallel.sharded_index import l2_step_sharded
        p = self.p
        si = self._sharded
        n_sh = si.n_shards
        bnds = si.mi_bounds
        w = ctx.work
        pending = []
        for T, todo in buckets.items():
            W_STEP, W_SMALL = _l2_widths(AREA, T, p.sketch_size)
            owner = np.clip(np.searchsorted(bnds, w["lo"][todo],
                                            side="right") - 1, 0, n_sh - 1)
            by_owner = [todo[owner == d] for d in range(n_sh)]
            rounds = max((len(x) + W_STEP - 1) // W_STEP for x in by_owner)
            for r in range(rounds):
                share = [x[r * W_STEP:(r + 1) * W_STEP] for x in by_owner]
                Wp = (W_SMALL if max(len(x) for x in share) <= W_SMALL
                      else W_STEP)
                chunk = np.full(n_sh * Wp, -1, np.int64)
                args = []
                for d, dev in enumerate(si.devices):
                    items = share[d]
                    chunk[d * Wp:d * Wp + len(items)] = items
                    wa, fidx, sqv = self._work_arrays(
                        items, w, Wp, int(bnds[d]))
                    wd = to_device(wa, dev)
                    fi = to_device(fidx, self.device)
                    args.append((wd[0], wd[1], wd[2], wd[3],
                                 ctx.qh_dev[fi].to(dev),
                                 ctx.qs_dev[fi].to(dev),
                                 to_device(sqv, dev)))
                bufs = l2_step_sharded(
                    *(list(a) for a in zip(*args)), si.mi_rank, si.mi_wpos,
                    si.mi_wend, si.mi_strand, si.mi_seqid, T, p.sketch_size)
                pending.append((chunk, self._cat_rows(bufs)))
        return pending

    def _collect_l2(self, ctx: _Batch):
        """Stage 3: pick up the l2 run buffers, decode every chunk's runs
        into loci at once (l2.loci_arrays), and the host-replay sketch
        rows. Rows known at dispatch were gathered in _collect_l1; items
        whose runs overflowed on the device replay on the host too, and
        their fragments' rows need a second small gather here."""
        from ..kernels.mapdev import L2_RUN_CAP, unpack_l2_runs

        p = self.p
        w = ctx.work
        mark = self._clock(ctx.ordinal)
        all_runs = ctx.pcat.wait() if ctx.pending else np.zeros(
            (0, 3 + 3 * L2_RUN_CAP), np.int32)
        need, pick = ctx.qh_pick
        qh_rows = [c.wait() for c in pick] if need else None
        mark("l2-wait")
        item = np.full(sum(n for _, n in ctx.pending), -1, np.int64)
        row0 = 0
        for chunk, nrows in ctx.pending:
            item[row0:row0 + len(chunk)] = chunk
            row0 += nrows
        # rows past a chunk's items, or -1 in it, are padding
        n_runs, best, r_ovf, starts, ends, strands = unpack_l2_runs(all_runs)
        w["host"][item[(item >= 0) & r_ovf]] = True
        keep = np.nonzero((item >= 0) & ~r_ovf)[0]
        row, o_start, o_end, pos, shared, strand = l2_mod.loci_arrays(
            n_runs[keep], best[keep], starts[keep], ends[keep],
            strands[keep], p.seg_length)
        it = item[keep][row]
        by = np.argsort(it, kind="stable")
        ctx.loci = {"item": it[by], "start": o_start[by], "end": o_end[by],
                    "pos": pos[by], "shared": shared[by],
                    "strand": strand[by], "seq": w["seq"][it[by]]}
        ctx.pending = ctx.pcat = None

        # sketch rows only for fragments whose L2 replays on the host
        qh_host = {i: (qh_rows[0][t], qh_rows[1][t])
                   for t, i in enumerate(need)}
        ctx.qh_pick = None
        late = np.setdiff1d(w["frag"][w["host"]], need).tolist()
        if late:
            qh_l, qs_l = (c.wait() for c in _gather_sketch_rows(
                ctx.qh_dev, ctx.qs_dev, late))
            qh_host.update({i: (qh_l[t], qs_l[t])
                            for t, i in enumerate(late)})
        ctx.qh_host = qh_host
        ctx.qh_dev = ctx.qs_dev = None
        mark("l2-fetch")

    def _post_batch(self, ctx: _Batch):
        """Stage 4: row assembly with exact pruning semantics. The
        device route's candidates and loci go through rows.assemble as
        the batch's arrays (total ``post-l2``, counted in segments);
        fragments with a host route, host L1 or an L2 item replayed on
        the host, run _do_l2 a group at a time, where its lazy top-ANI
        break spares host L2 work (total ``post-l2-scalar``, counted in
        fragments). Returns [(fragment, rows)] in batch order."""
        p = self.p
        o, w, loc, frags = ctx.o, ctx.work, ctx.loci, ctx.frags
        B = len(frags)
        mark = self._clock(ctx.ordinal)
        t0 = time.perf_counter_ns()
        scalar = ctx.host_frag.copy()
        scalar[w["frag"][w["host"]]] = True
        out = [[] for _ in range(B)]

        # every work item through the arrays; the rows of the fragments
        # that take _do_l2 are dropped
        li, nuc, ub, n_seg = assemble(
            self.l2_tab, p.stage1_topANI_filter, w["frag"],
            self.ref_groups[w["seq"]] if p.skip_prefix
            else np.zeros(len(w["seq"]), np.int64),
            w["inter"], w["sq"], loc["item"], loc["shared"], loc["seq"],
            loc["pos"])
        r_frag = w["frag"][loc["item"][li]]
        mine = ~scalar[r_frag]
        li, r_frag, nuc, ub = li[mine], r_frag[mine], nuc[mine], ub[mine]
        q_len = np.array([fr.q_len for fr in frags], np.int64)
        counter = np.array([fr.q.counter for fr in frags], np.int64)
        ms = mapping_results(
            q_len[r_frag], loc["pos"][li], loc["seq"][li], counter[r_frag],
            nuc, ub, o["s_q"][r_frag], loc["shared"][li], loc["strand"][li],
            ctx.cx[r_frag])
        cut = np.searchsorted(r_frag, np.arange(B + 1)).tolist()
        for i in np.unique(r_frag).tolist():
            out[i] = ms[cut[i]:cut[i + 1]]
        t1 = time.perf_counter_ns()
        trace.add("post-l2", (t1 - t0) / 1e9, n_seg)

        sc = np.nonzero(scalar)[0].tolist()
        if sc:
            self._post_scalar(ctx, sc, out)
            trace.add("post-l2-scalar",
                      (time.perf_counter_ns() - t1) / 1e9, len(sc))
        mark("post")
        return list(zip(frags, out))

    def _post_scalar(self, ctx: _Batch, sc, out) -> None:
        """Rows of the fragments ``sc`` into ``out``: host L1 fragments
        through _map_fragment, fragments with an L2 item replayed on the
        host through _do_l2 a group at a time, the replay made lazily."""
        from ..kernels.sketch import sketch_sequence_py

        p = self.p
        o, w, cx = ctx.o, ctx.work, ctx.cx
        host = {(i, j) for i, j in zip(w["frag"][w["host"]].tolist(),
                                       w["cand"][w["host"]].tolist())}
        loci_by: dict = {}
        loc = ctx.loci
        mine = np.isin(w["frag"][loc["item"]], sc)
        for it, *f in zip(*(loc[k][mine].tolist() for k in (
                "item", "seq", "pos", "start", "end", "shared", "strand"))):
            loci_by.setdefault(
                (int(w["frag"][it]), int(w["cand"][it])), []).append(
                l2_mod.L2Locus(*f))
        for i in sc:
            fr = ctx.frags[i]
            q = fr.q
            if ctx.host_frag[i]:
                oh, ostr, ocnt, ocx = sketch_sequence_py(
                    ctx.mat[i, :fr.q_len], p.kmer_size, p.sketch_size)
                out[i] = self._map_fragment(
                    q, fr, oh, ostr, ocnt, ocx, q.allowed, q.qg)
                continue
            s_q = int(o["s_q"][i])
            hashes = ctx.qh_host[i][0][:s_q]
            strands = ctx.qh_host[i][1][:s_q].astype(np.int64)
            cands = [
                l1_mod.L1Candidate(
                    int(o["cand_seq"][i, j]), int(o["cand_start"][i, j]),
                    int(o["cand_end"][i, j]), int(o["cand_inter"][i, j]))
                for j in range(int(o["n_cand"][i]))]
            cand_j = {id(c): j for j, c in enumerate(cands)}

            def loci_fn(c, _i=i, _cand_j=cand_j, _h=hashes, _s=strands):
                j = _cand_j[id(c)]
                if (_i, j) in host:
                    return l2_mod.l2_mapped_regions(
                        self.idx, self.mi_key, _h, _s, c.seq_id,
                        c.range_start, c.range_end, p.seg_length, 0,
                        q_are_codes=True)
                return loci_by.get((_i, j), [])

            if p.skip_prefix:
                groups: dict[int, list] = {}
                for c in cands:
                    groups.setdefault(
                        int(self.ref_groups[c.seq_id]), []).append(c)
                parts = [groups[gv] for gv in sorted(groups)]
            else:
                parts = [cands]
            rows = []
            for part in parts:
                rows.extend(self._do_l2(q, fr, hashes, strands, s_q, cx[i],
                                        part, loci_fn))
            rows.sort(key=lambda m: (m.ref_seq_id, m.ref_start))
            out[i] = rows

    def _filter_by_group(self, rows: List[MappingResult], n_mappings: int,
                         filter_ref: bool) -> List[MappingResult]:
        """filterByGroup (computeMap.hpp:504-561)."""
        p = self.p
        rows = sorted(rows, key=lambda m: (m.ref_seq_id, m.ref_start))
        out: List[MappingResult] = []
        i = 0
        while i < len(rows):
            if p.skip_prefix:
                g = self.ref_groups[rows[i].ref_seq_id]
                j = i
                while j < len(rows) and \
                        self.ref_groups[rows[j].ref_seq_id] == g:
                    j += 1
            else:
                j = len(rows)
            sub = sorted(rows[i:j], key=lambda m: (
                m.query_start, m.ref_seq_id, m.ref_start))
            if filter_ref:
                filters.filter_by_ref_axis(sub, n_mappings,
                                           self.idx.lengths)
            else:
                filters.filter_by_query_axis(sub, n_mappings)
            out.extend(sub)
            i = j
        out.sort(key=lambda m: (m.query_start, m.ref_seq_id, m.ref_start))
        return out

    # ------------------------------------------------------------------
    def _run_pipelined(self, queries, out: IO[str], meter=None) -> None:
        """Streaming, depth-2 pipelined device mapping.

        Fragments stream into fixed-size batches and at most two batches
        are in flight: while batch N's l1 meta travels to the host,
        batch N+1's host prep and l1 dispatch and batch N-1's l2 collect
        proceed, so device work, copies and host post-processing
        overlap. The reference overlaps I/O and compute with a thread
        pool (computeMap.hpp:607-637); this is the single-host-thread
        equivalent, driven by the stream's queue and the copies' events
        (hostcopy.py).

        Fragments of one query may land in different batches; per-query
        rows accumulate on the _Query and each query finalizes —
        merge/filter/emit, in input order — once its last fragment is
        delivered. Each delivered fragment credits its bases to the
        meter.
        """
        import collections
        p = self.p
        BF = p.batch_fragments
        inflight: collections.deque = collections.deque()
        finalq: collections.deque = collections.deque()
        cur: list = []

        def credit(q, fr):
            if meter is None:
                return
            inc = min(fr.q_len, len(q.seq) - q.counted)
            if inc > 0:
                meter.increment(inc)
                q.counted += inc

        def finalize_ready():
            while finalq and finalq[0].done == finalq[0].n_frags:
                q = finalq.popleft()
                with trace.span("map finalize"):
                    with trace.span("merge-filter"):
                        rows = self._postprocess_query(q, q.rows)
                    with trace.span("emit"):
                        self._emit(q, rows, out)
                q.rows = q.u8 = q.allowed = None

        def complete(ctx):
            for fr, rows in self._post_batch(ctx):
                q = fr.q
                q.rows[fr.ord] = (fr, rows)
                q.done += 1
                credit(q, fr)
            finalize_ready()

        def submit():
            nonlocal cur
            if not cur:
                return
            inflight.append(self._dispatch_batch(cur))
            cur = []
            # steady state holds [N-1 (l2 in flight), N (l1 in flight)]:
            # every wait below has the next batch's device work already
            # queued behind it
            if len(inflight) >= 2 and inflight[-2].stage == 0:
                self._collect_l1(inflight[-2])
            while len(inflight) >= 3:
                b = inflight[0]
                if b.stage == 0:
                    self._collect_l1(b)
                self._collect_l2(b)
                complete(inflight.popleft())

        for q in queries:
            self._prepare_query(q)
            fl = self._fragment_query(len(q.seq))
            q.n_frags = len(fl)
            q.rows = [None] * len(fl)
            finalq.append(q)
            for o_, (qs, qlen) in enumerate(fl):
                cur.append(_Fragment(
                    0, qs, qlen, max(0, qlen - p.seg_length),
                    q=q, ord=o_))
                if len(cur) == BF:
                    submit()
        submit()
        while inflight:
            b = inflight.popleft()
            if b.stage == 0:
                self._collect_l1(b)
            self._collect_l2(b)
            complete(b)
        assert not finalq, "pipelined path left unfinished queries"

    def run(self, query_files: Sequence[str], out: IO[str],
            progress: Optional[bool] = None, reader=None) -> None:
        """Full mapQuery equivalent: stream files, map, write output.

        ``reader`` (io.fasta.PrefetchReader) supplies the same
        (name, seq) stream as iterating ``query_files`` in order, but
        from a thread that started during the index build. Unless
        ``progress`` is False (default: ``not no_progress``), a meter on
        stderr counts the mapped bases. In a multi-process run
        (parallel/distributed.py) the process maps the queries it owns,
        writes part lines, and credits the meter with the others."""
        from ..io import for_each_seq_in_file, total_seq_stats
        from ..parallel import distributed
        from ..progress import ProgressMeter
        p = self.p
        t0 = time.time()
        self._dist = distributed.context()

        if progress is None:
            # the reference always paints its meter to stderr
            # (progress.hpp:25-38); --noProgress is the opt-out
            progress = not p.no_progress
        meter = None
        if progress:
            # reference sizes its meter from the .fai / a pre-scan
            # (computeMap.hpp:279-304). For non-tty stderr (piped /
            # captured) skip the pre-scan unless .fai files make sizing
            # free; the meter then runs unsized.
            if (sys.stderr.isatty()
                    or all(os.path.exists(f + ".fai") for f in query_files)):
                _, total_bp = total_seq_stats(query_files)
            else:
                total_bp = 0
            meter = ProgressMeter(total_bp, "[mashmap-tpu-torch::map] mapped")

        def name_seq_stream():
            if reader is not None:
                yield from reader
            else:
                for fname in query_files:
                    yield from for_each_seq_in_file(fname)

        def owned_queries():
            """Owned queries in file order, maintaining the global
            counters, the one-to-one metadata and the meter's credit for
            queries another process maps."""
            for name, seq in trace.each("map query-wait",
                                        name_seq_stream()):
                qlen = len(seq)
                if p.filter_mode == FILTER_ONETOONE:
                    self.qmetadata.append((name, qlen))
                if qlen >= p.kmer_size:
                    self.total_reads_picked += 1
                    if self._dist is not None and not \
                            self._dist.owns_query(self.total_seq_counter):
                        # another process maps this query; count its bp
                        # so the meter tracks global progress
                        if meter is not None:
                            meter.increment(qlen)
                    else:
                        yield _Query(name, seq, self.total_seq_counter)
                else:
                    logger.warning(
                        "read %s of %dbp is not long enough for "
                        "mapping", name, qlen)
                self.total_seq_counter += 1
                self.total_bp += qlen

        if p.use_device_pipeline and p.split:
            self._run_pipelined(owned_queries(), out, meter)
        else:
            pending: List[_Query] = []
            pending_frags = 0

            def flush():
                nonlocal pending, pending_frags
                for qq, rows in self.map_queries(pending):
                    self._emit(qq, rows, out)
                    if meter is not None:
                        meter.increment(len(qq.seq))
                pending = []
                pending_frags = 0

            for q in owned_queries():
                pending.append(q)
                pending_frags += max(1, len(q.seq) // p.seg_length)
                if pending_frags >= p.batch_fragments:
                    flush()
            if pending:
                flush()
        if meter is not None:
            meter.finish()

        if p.filter_mode == FILTER_ONETOONE:
            if self._dist is not None:
                # process 0 runs the reference-axis pass over every
                # process's rows
                rows_path = self._dist.part_path(p.out_file_name) + ".rows"
                distributed.dump_rows(rows_path, self._buffered)
                distributed.barrier("one-to-one-rows")
                if self._dist.is_primary:
                    self._buffered = distributed.gather_rows(
                        p.out_file_name, self._dist)
                    self._finish_one_to_one(out)
            else:
                self._finish_one_to_one(out)

        logger.info(
            "count of mapped reads = %d, reads qualified for mapping = %d, "
            "total input reads = %d, total input bp = %d [%.1fs]",
            self.total_reads_mapped, self.total_reads_picked,
            self.total_seq_counter, self.total_bp, time.time() - t0)

    def _emit(self, q: _Query, rows: List[MappingResult],
              out: IO[str]) -> None:
        if rows:
            self.total_reads_mapped += 1
        if self.p.filter_mode == FILTER_ONETOONE:
            self._buffered.extend(rows)
        elif self._dist is not None:
            # part-file line "<query ordinal>\t<paf...>": process 0
            # merges the parts back into input order
            import io
            buf = io.StringIO()
            output.write_mappings(
                buf, rows, lambda m: q.name, self.idx.names,
                self.idx.lengths, self.p.legacy_output,
                self.p.merge_mappings, self.p.report_ANI_percentage)
            pfx = f"{q.counter}\t"
            for ln in buf.getvalue().splitlines(keepends=True):
                out.write(pfx + ln)
        else:
            output.write_mappings(
                out, rows, lambda m: q.name, self.idx.names,
                self.idx.lengths, self.p.legacy_output,
                self.p.merge_mappings, self.p.report_ANI_percentage)

    def _finish_one_to_one(self, out: IO[str]) -> None:
        """Reference-axis global pass (mapQuery, computeMap.hpp:357-405)."""
        p = self.p
        n = p.num_mappings_for_segment - 1
        rows = self._buffered
        result: List[MappingResult] = []
        i = 0
        while i < len(rows):
            if p.skip_prefix:
                g = self._get_ref_group(
                    self.qmetadata[rows[i].query_seq_id][0])
                j = i
                while j < len(rows) and self._get_ref_group(
                        self.qmetadata[rows[j].query_seq_id][0]) == g:
                    j += 1
            else:
                j = len(rows)
            sub = rows[i:j]
            result.extend(self._filter_by_group(sub, n, filter_ref=True))
            i = j
        result.sort(key=lambda m: (m.query_seq_id, m.query_start,
                                   m.ref_seq_id, m.ref_start))
        output.write_mappings(
            out, result,
            lambda m: self.qmetadata[m.query_seq_id][0],
            self.idx.names, self.idx.lengths, p.legacy_output,
            p.merge_mappings, p.report_ANI_percentage)
