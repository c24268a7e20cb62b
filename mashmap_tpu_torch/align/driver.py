"""The aligner's top level: mappings + FASTA -> base-level alignments.

Counterpart of ``mashmap_tpu/align/driver.py`` on one torch device (CUDA
unless the caller passes ``device="cpu"``). Behavioral contract
(reference: src/align/include/computeAlignments.hpp):

- query FASTA records and mashmap rows are consumed in lockstep; rows
  whose qId does not match the current record advance the record
  (computeAlignments.hpp:132-177);
- region slicing uses INCLUSIVE end coordinates (length = end-start+1,
  computeAlignments.hpp:236-241) and '-'-strand query regions are
  reverse-complemented before aligning (:243-248);
- the alignment is semi-global over the reference region (free target
  end-gaps, edlib EDLIB_MODE_HW) with edit-distance limit
  (1 - pi/100) * queryLen (:256-269); rows exceeding the limit produce
  no output;
- output = original row + " " + editDistance/alignmentLength + " " +
  standard CIGAR (:286-296), with SAM letter semantics ('I' consumes the
  query, 'D' consumes the target; matches and mismatches both 'M').

Pipeline per batch of rows: anchor chains (host numpy, anchors.py) ->
DP pieces bucketed by (padded length, band width) -> the banded DP, its
end state and its traceback (kernel.py::banded_dp_trace: the CUDA kernel
on a card, so only each piece's result and edit path come back to the
host; its plain version on the CPU) -> CIGAR stitch through anchors.
Pieces that no bucket fits take the unbanded host DP (``_run_host``), as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
import time
from typing import Iterator, Optional, Sequence, TextIO

import numpy as np
import torch

from ..io.fasta import for_each_seq_in_file
from ..kernels.kmers import sanitize, revcomp_np
from ..utils import resolve_device
from . import kernel as K
from .anchors import find_anchor_chain

logger = logging.getLogger("mashmap_tpu_torch.align")

# bucket shapes: (padded piece length P, band width W). A piece escalates
# to the next wider band when its edit distance indicates the optimum may
# have left the band (same doubling idea as edlib's k search).
PIECE_BUCKETS: tuple[tuple[int, int], ...] = (
    (256, 64), (256, 128), (1024, 256), (4096, 1024),
)
MAX_P = PIECE_BUCKETS[-1][0]
MAX_W = PIECE_BUCKETS[-1][1]
# pieces per device call, by bucket: a one-warp piece of the narrow
# buckets fills little of an SM, so they take more pieces a call; the
# records (not the rows) come back, so memory does not bound them. Each
# piece is independent, so the batch moves no output byte.
BATCH = {(256, 64): 4096, (256, 128): 4096, (1024, 256): 512,
         (4096, 1024): 512}
ANCHOR_K = 21
ANCHOR_SPACING = 192


@dataclasses.dataclass
class AlignStats:
    """What one Aligner's runs did: counts, and where the time went.

    ``dp_ms`` is the fused DP, end state and traceback kernel's device
    time by CUDA events on a card, and its plain version's host time on
    the CPU (the walk included); ``d2h_ms`` the copy of its records (each
    piece's result and edit path) to the host, 0 on the CPU;
    ``traceback_s`` the host's unpacking of the records into the pieces
    (reversing each path, the free-start prefix, the retry queue);
    ``anchor_s`` and ``host_dp_s`` host clocks."""

    rows_in: int = 0
    rows_out: int = 0
    pieces: dict = dataclasses.field(default_factory=dict)  # (P, W) -> n
    dp_calls: int = 0
    host_pieces: int = 0
    dp_ms: float = 0.0
    d2h_ms: float = 0.0
    anchor_s: float = 0.0
    traceback_s: float = 0.0
    host_dp_s: float = 0.0


@dataclasses.dataclass
class MappingRecord:
    """Parsed mashmap row (reference align_types.hpp:17-26)."""

    qid: str
    qstart: int
    qend: int            # inclusive
    strand: str
    rid: str
    rstart: int
    rend: int            # inclusive
    raw_line: str


def parse_mashmap_row(line: str) -> MappingRecord:
    """Whitespace-tokenized, >= 9 fields (computeAlignments.hpp:191-220).

    Works for both PAF and legacy formats: fields 0,2,3,4,5,7,8 coincide.
    """
    t = line.split()
    if len(t) < 9:
        raise ValueError(f"bad mashmap row: {line!r}")
    return MappingRecord(
        qid=t[0], qstart=int(t[2]), qend=int(t[3]), strand=t[4],
        rid=t[5], rstart=int(t[7]), rend=int(t[8]), raw_line=line)


@dataclasses.dataclass
class _Piece:
    """One independent DP problem (a slice of one mapping's alignment)."""

    row_idx: int          # which mapping row it belongs to
    seg_idx: int          # position among the row's segments
    q: np.ndarray         # query bytes
    r: np.ndarray         # target bytes
    free_start: bool      # row-0 zeros (free target prefix)
    free_end: bool        # answer = argmin over last row (tail piece)
    min_w: int = 0        # escalated band requirement (doubles on retry)
    # filled by the DP:
    ops: Optional[np.ndarray] = None
    start_j: int = 0      # target offset where the path enters
    end_j: int = 0        # target offset where the path exits
    edit: int = 0


@dataclasses.dataclass
class _RowWork:
    record: MappingRecord
    segments: list        # of ("ops", np.ndarray) | ("piece", _Piece)
    n_pending: int = 0
    failed: bool = False


def _match_run(k: int) -> np.ndarray:
    return np.zeros(k, dtype=np.uint8)  # OP_MATCH == 0


def _trivial_ops(nq: int, nr: int) -> np.ndarray:
    """Gap piece where one side is empty: all insertions / deletions."""
    if nq == 0:
        return np.full(nr, K.OP_DEL, np.uint8)   # target-only bases
    return np.full(nq, K.OP_INS, np.uint8)       # query-only bases


def build_row_work(row_idx: int, rec: MappingRecord, qseq_u8: np.ndarray,
                   rseq_u8: np.ndarray) -> tuple[_RowWork, list[_Piece]]:
    """Split one mapping into anchor matches + DP pieces."""
    q = qseq_u8[rec.qstart:rec.qend + 1]
    if rec.strand != "+":
        q = revcomp_np(q)
    r = rseq_u8[rec.rstart:rec.rend + 1]
    n, m = len(q), len(r)

    ak = ANCHOR_K
    anchors = find_anchor_chain(q, r, ak, ANCHOR_SPACING)
    if len(anchors) == 0 and min(n, m) >= ANCHOR_K:
        # divergent region: retry with smaller anchor k before resorting
        # to one monolithic DP piece
        for ak in (15, 11):
            anchors = find_anchor_chain(q, r, ak, ANCHOR_SPACING)
            if len(anchors):
                break
    segments: list = []
    pieces: list[_Piece] = []
    work = _RowWork(rec, segments)

    def add_piece(qs: np.ndarray, rs: np.ndarray,
                  free_start: bool = False, free_end: bool = False):
        if len(qs) == 0 or len(rs) == 0:
            if len(qs) or len(rs):
                if free_start or free_end:
                    # unaligned target slack at the ends is NOT part of
                    # the path (HW mode trims it)
                    if len(qs):
                        segments.append(("ops", _trivial_ops(len(qs), 0)))
                else:
                    segments.append(("ops", _trivial_ops(len(qs), len(rs))))
            return
        p = _Piece(row_idx, len(segments), qs, rs, free_start, free_end)
        segments.append(("piece", p))
        pieces.append(p)
        work.n_pending += 1

    if len(anchors) == 0:
        add_piece(q, r, free_start=True, free_end=True)
        return work, pieces

    # head: query prefix ending exactly at anchor 0, free target prefix.
    qa0, ra0 = int(anchors[0, 0]), int(anchors[0, 1])
    slack = max(32, qa0 // 4)
    r_lo = max(0, ra0 - qa0 - slack)
    add_piece(q[:qa0], r[r_lo:ra0], free_start=True)

    prev_q, prev_r = qa0, ra0
    for ai in range(len(anchors)):
        qa, ra = int(anchors[ai, 0]), int(anchors[ai, 1])
        if ai > 0:
            add_piece(q[prev_q:qa], r[prev_r:ra])
        segments.append(("ops", _match_run(ak)))
        prev_q, prev_r = qa + ak, ra + ak

    # tail: free target suffix
    tail_n = n - prev_q
    slack = max(32, tail_n // 4)
    r_hi = min(m, prev_r + tail_n + slack)
    add_piece(q[prev_q:n], r[prev_r:r_hi], free_end=True)
    return work, pieces


# ---------------------------------------------------------------------------
# batched DP execution
# ---------------------------------------------------------------------------


def _bucket_for(piece: _Piece, min_w: int = 0) -> Optional[tuple[int, int]]:
    n, m = len(piece.q), len(piece.r)
    # band must cover diagonals 0 and m-n plus slack for the edit path
    need_w = abs(m - n) + 2 * 16 + 1
    need_w = max(need_w, min_w)
    for P, W in PIECE_BUCKETS:
        if n <= P and need_w <= W:
            return (P, W)
    return None


def _band_lo(piece: _Piece, W: int) -> int:
    n, m = len(piece.q), len(piece.r)
    d = m - n
    return min(0, d) - (W - abs(d) - 1) // 2


def _dp_trace(q, r, n, m, lo, fs, fe, P, W, device, stats):
    """The bucket's records (kernel.py::banded_dp_trace) on the host: the
    kernel on a card (timed by CUDA events, and the records' copy to the
    host), the plain version on the CPU (timed by the host clock)."""
    t = K.dp_inputs(q, r, n, m, lo, fs, fe, device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        rec = K.banded_dp_trace(*t, p_len=P, width=W)
        stats.dp_ms += 1e3 * (time.perf_counter() - t0)
        return rec.numpy()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    rec = K.banded_dp_trace(*t, p_len=P, width=W)
    ev[1].record()
    rec = rec.cpu()
    ev[2].record()
    ev[2].synchronize()
    stats.dp_ms += ev[0].elapsed_time(ev[1])
    stats.d2h_ms += ev[1].elapsed_time(ev[2])
    return rec.numpy()


def _run_bucket(pieces: Sequence[_Piece], P: int, W: int, device,
                stats: AlignStats) -> list[_Piece]:
    """Run one (P, W) bucket; returns pieces needing escalation."""
    retry: list[_Piece] = []
    stats.pieces[(P, W)] = stats.pieces.get((P, W), 0) + len(pieces)
    batch = BATCH.get((P, W), 512)
    for ofs in range(0, len(pieces), batch):
        chunk = pieces[ofs:ofs + batch]
        B = len(chunk)
        q = np.zeros((B, P), np.uint8)
        r = np.zeros((B, P + W), np.uint8)
        n = np.zeros(B, np.int32)
        m = np.zeros(B, np.int32)
        lo = np.zeros(B, np.int32)
        fs = np.zeros(B, bool)
        fe = np.zeros(B, bool)
        for b, p in enumerate(chunk):
            q[b, :len(p.q)] = p.q
            r[b, :len(p.r)] = p.r
            n[b], m[b] = len(p.q), len(p.r)
            lo[b] = _band_lo(p, W)
            fs[b], fe[b] = p.free_start, p.free_end
        rec = _dp_trace(q, r, n, m, lo, fs, fe, P, W, device, stats)
        stats.dp_calls += 1

        t0 = time.perf_counter()
        res, ops = K.unpack_trace(rec, P, W)
        ok = res[:, K.RES_OK] != 0
        # any path cheaper than e deviates < e from the end diagonals, so
        # band slack >= e proves optimality; otherwise widen
        for b in np.nonzero(~ok)[0]:
            chunk[b].min_w = 2 * W
            retry.append(chunk[b])
        dead = np.nonzero(ok & (res[:, K.RES_DEAD] != 0))[0]
        if len(dead):
            raise AssertionError(
                f"traceback dead end in pieces {dead[:4]} (band too "
                f"narrow?)")
        for b in np.nonzero(ok)[0]:
            p = chunk[b]
            o = ops[b, :res[b, K.RES_LEN]][::-1]
            start_j = int(res[b, K.RES_START_J])
            if not p.free_start and start_j > 0:
                # consume the remaining target prefix
                o = np.concatenate([np.full(start_j, K.OP_DEL, np.uint8), o])
                start_j = 0
            p.ops = np.ascontiguousarray(o)
            p.start_j = start_j
            p.end_j = int(res[b, K.RES_END_J])
            p.edit = int(res[b, K.RES_E])
        stats.traceback_s += time.perf_counter() - t0
    return retry


def run_pieces(pieces: list[_Piece], device=None,
               stats: Optional[AlignStats] = None) -> None:
    """Execute all pieces, escalating bands per piece as needed."""
    device = resolve_device(device)
    stats = AlignStats() if stats is None else stats
    todo = list(pieces)
    while todo:
        buckets: dict[tuple[int, int], list[_Piece]] = {}
        host: list[_Piece] = []
        for p in todo:
            bk = _bucket_for(p, p.min_w)
            if bk is None:
                host.append(p)
            else:
                buckets.setdefault(bk, []).append(p)
        retry: list[_Piece] = []
        for (P, W), plist in sorted(buckets.items()):
            retry += _run_bucket(plist, P, W, device, stats)
        t0 = time.perf_counter()
        for p in host:
            _run_host(p)
        stats.host_pieces += len(host)
        stats.host_dp_s += time.perf_counter() - t0
        todo = retry           # pieces whose min_w doubled


HOST_DP_CELL_CAP = 32_000_000   # full-DP budget before giving up


def _run_host(p: _Piece) -> None:
    """Unbanded numpy DP for oversized/over-divergent pieces.

    Pieces only land here when no anchor splits them AND the largest
    device band bucket cannot certify optimality — i.e. highly divergent
    or structurally variant regions. A quadratic blow-up is capped; rows
    whose pieces stay unsolved are dropped (mirrors edlib returning
    NOTFOUND when the edit distance exceeds its k bound).
    """
    n, m = len(p.q), len(p.r)
    if n * m > HOST_DP_CELL_CAP:
        logger.warning(
            "dropping alignment piece (%d x %d exceeds host DP cap; "
            "region too divergent for banded alignment)", n, m)
        p.ops = None
        return
    D = K.full_dp_host(p.q, p.r, p.free_start)
    if p.free_end:
        end_j = int(np.argmin(D[n]))
    else:
        end_j = m
    ops, start_j = _traceback_full(D, p.q, p.r, n, end_j, p.free_start)
    p.ops, p.start_j, p.end_j = ops, start_j, end_j
    p.edit = int(D[n, end_j])


def _traceback_full(D: np.ndarray, q: np.ndarray, r: np.ndarray,
                    n: int, end_j: int, free_start: bool):
    ops = []
    i, j = n, end_j
    while i > 0:
        v = D[i, j]
        if j >= 1:
            sub = int(q[i - 1] != r[j - 1])
            if D[i - 1, j - 1] + sub == v:
                ops.append(K.OP_MATCH if sub == 0 else K.OP_SUB)
                i, j = i - 1, j - 1
                continue
        if D[i - 1, j] + 1 == v:
            ops.append(K.OP_INS)
            i -= 1
            continue
        if not (j >= 1 and D[i, j - 1] + 1 == v):
            raise AssertionError(f"full traceback dead end at i={i} j={j}")
        ops.append(K.OP_DEL)
        j -= 1
    if not free_start:
        ops.extend([K.OP_DEL] * j)
        j = 0
    ops.reverse()
    return np.asarray(ops, np.uint8), j


# ---------------------------------------------------------------------------
# CIGAR assembly + output
# ---------------------------------------------------------------------------

_CIG_STD = np.array([ord("M"), ord("I"), ord("D"), ord("M")], np.uint8)


def ops_to_cigar(ops: np.ndarray) -> str:
    """Run-length encode op codes as a standard CIGAR (M/I/D)."""
    if len(ops) == 0:
        return ""
    letters = _CIG_STD[ops]
    change = np.flatnonzero(np.concatenate(
        ([True], letters[1:] != letters[:-1])))
    runs = np.diff(np.concatenate((change, [len(letters)])))
    return "".join(f"{rl}{chr(letters[i])}"
                   for i, rl in zip(change, runs))


def finish_row(work: _RowWork, limit: int, out: TextIO) -> bool:
    """Stitch segments, apply the edit-distance limit, emit output.
    Returns whether a line was written."""
    all_ops = []
    edit = 0
    for kind, val in work.segments:
        if kind == "ops":
            all_ops.append(val)
            edit += int(np.sum(val != K.OP_MATCH))
        else:
            p: _Piece = val
            if p.ops is None:
                work.failed = True
                return False
            all_ops.append(p.ops)
            edit += p.edit
    if limit >= 0 and edit > limit:
        return False   # like edlib k-bounded NOTFOUND: row is dropped
    ops = np.concatenate(all_ops) if all_ops else np.zeros(0, np.uint8)
    if len(ops) == 0:
        return False   # reference skips alignmentLength == 0 rows
    rate = edit / len(ops)
    out.write(f"{work.record.raw_line} {_fmt_g(rate)} {ops_to_cigar(ops)}\n")
    return True


def _fmt_g(x: float) -> str:
    """C++ ostream default double formatting (6 significant digits)."""
    return f"{x:.6g}"


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


class Aligner:
    """Equivalent of align::Aligner (computeAlignments.hpp:36-301)."""

    def __init__(self, ref_files: Sequence[str],
                 percentage_identity: float, device=None):
        self.pi = percentage_identity
        self.device = resolve_device(device)
        self.stats = AlignStats()
        self.ref: dict[str, np.ndarray] = {}
        for fname in ref_files:
            for name, seq in for_each_seq_in_file(fname):
                if name in self.ref:
                    raise ValueError(f"duplicate ref contig {name}")
                self.ref[name] = sanitize(seq.encode())

    def align(self, query_files: Sequence[str], mapping_file: str,
              out: TextIO) -> None:
        """Lockstep scan of query records x mapping rows.

        Mapping rows stall until a query record with a matching name
        arrives; query records without rows are skipped — the same
        control flow as computeAlignments.hpp:132-177.
        """
        with open(mapping_file) as fh:
            lines: Iterator[str] = (
                line.rstrip("\n") for line in fh if line.strip())
            pending = next(lines, None)
            for qfile in query_files:
                for qname, qseq in for_each_seq_in_file(qfile):
                    if pending is None:
                        break
                    batch: list[MappingRecord] = []
                    while pending is not None:
                        rec = parse_mashmap_row(pending)
                        if rec.qid != qname:
                            break
                        batch.append(rec)
                        pending = next(lines, None)
                    if batch:
                        self._align_batch(batch, sanitize(qseq.encode()),
                                          out)

    def _align_batch(self, records: list[MappingRecord],
                     q_u8: np.ndarray, out: TextIO) -> None:
        st = self.stats
        works: list[_RowWork] = []
        pieces: list[_Piece] = []
        t0 = time.perf_counter()
        for i, rec in enumerate(records):
            rseq = self.ref.get(rec.rid)
            if rseq is None:
                raise ValueError(f"unknown reference contig {rec.rid}")
            w, ps = build_row_work(i, rec, q_u8, rseq)
            works.append(w)
            pieces.extend(ps)
        st.anchor_s += time.perf_counter() - t0
        run_pieces(pieces, self.device, st)
        st.rows_in += len(works)
        for w in works:
            qlen = w.record.qend - w.record.qstart + 1
            limit = (-1 if self.pi == 0
                     else int((1 - self.pi / 100.0) * qlen))
            st.rows_out += finish_row(w, limit, out)


def align_files(ref_files: Sequence[str], query_files: Sequence[str],
                mapping_file: str, percentage_identity: float,
                out_file: str, device=None) -> AlignStats:
    """Align every mapping row; returns the run's AlignStats."""
    aligner = Aligner(ref_files, percentage_identity, device)
    if out_file == "-":
        aligner.align(query_files, mapping_file, sys.stdout)
    else:
        with open(out_file, "w") as out:
            aligner.align(query_files, mapping_file, out)
    st = aligner.stats
    logger.info(
        "aligned %d of %d rows on %s; pieces per bucket %s, host DP %d; "
        "DP %.3f ms in %d calls, records to host %.3f ms; anchors %.3f s, "
        "traceback %.3f s, host DP %.3f s", st.rows_out, st.rows_in,
        aligner.device, st.pieces, st.host_pieces, st.dp_ms, st.dp_calls,
        st.d2h_ms, st.anchor_s, st.traceback_s, st.host_dp_s,
        extra={"align_stats": st})
    return st
