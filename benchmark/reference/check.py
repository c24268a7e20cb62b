"""What decides ``correct``: the window's PAF rows against the truth of
the generated sequences and the plain reference's identities.

Every row of every job or pass in the window is checked for its text
(names, lengths, coordinates, strand) and its place: a row must land on
a target the truth allows, on the truth's strand, with both target ends
within one segment of where the generator put the query's ends
(``misplaced`` counts the rows that do not). Every (query, target)
pair that the truth expects must be covered by such rows end to end,
but for the fragments the reference itself leaves unmapped
(``uncovered_pct`` is the share of expected query bases left over).
A sample of the distinct rows, drawn from the seed, has its identity
worked out again from the two sequences, fragment by fragment as
MashMap splits the query, at the target windows the truth gives
(``identity.py``); ``id_gap`` is the widest distance between a row's
printed identity and the mean of its fragments'.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import identity


@dataclasses.dataclass
class Truth:
    """``seqs``: every sequence by name; ``pairs``: the (query, target)
    pairs that must be mapped; ``place(q, positions, t)``: where query
    positions of ``q`` lie on ``t``, or None where ``t`` is no target
    of ``q``; ``strand``: the strand every row must have."""
    seqs: Dict[str, np.ndarray]
    pairs: List[Tuple[str, str]]
    place: Callable[[str, np.ndarray, str], Optional[np.ndarray]]
    strand: str = "+"


@dataclasses.dataclass
class Row:
    q: str
    qlen: int
    qs: int
    qe: int
    strand: str
    t: str
    tlen: int
    ts: int
    te: int
    ident: float

    @property
    def key(self):
        return (self.q, self.t, self.qs, self.qe)


def parse_paf(text: str) -> Tuple[List[Row], int]:
    """(rows, lines that do not parse as a PAF row with an id:f tag)."""
    rows, bad = [], 0
    for line in text.splitlines():
        f = line.split("\t")
        try:
            ident = float(next(x[5:] for x in f[12:] if x.startswith("id:f:")))
            rows.append(Row(f[0], int(f[1]), int(f[2]), int(f[3]), f[4],
                            f[5], int(f[6]), int(f[7]), int(f[8]), ident))
        except (IndexError, ValueError, StopIteration):
            bad += 1
    return rows, bad


def placed(r: Row, truth: Truth, tol: int) -> bool:
    q, t = truth.seqs.get(r.q), truth.seqs.get(r.t)
    if q is None or t is None or r.qlen != len(q) or r.tlen != len(t):
        return False
    if not (0 <= r.qs < r.qe <= r.qlen and 0 <= r.ts < r.te <= r.tlen):
        return False
    if r.strand != truth.strand:
        return False
    want = truth.place(r.q, np.array([r.qs, r.qe]), r.t)
    if want is None:
        return False
    return abs(r.ts - int(want[0])) <= tol and abs(r.te - int(want[1])) <= tol


def holes(rows: Sequence[Row], truth: Truth,
          seg: int) -> Tuple[List[Tuple[str, str, int, int]], int]:
    """The stretches [a, b) of expected queries that no placed row of
    their target covers, and the expected bases. A query shorter than one
    segment is not expected: from its fewer k-mers MashMap may not reach
    --pi."""
    by_pair: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
    for r in rows:
        by_pair.setdefault((r.q, r.t), []).append((r.qs, r.qe))
    out, total = [], 0
    for q, t in truth.pairs:
        n = len(truth.seqs[q])
        if n < seg:
            continue
        total += n
        end = 0
        for a, b in sorted(by_pair.get((q, t), [])) + [(n, n)]:
            if a > end:
                out.append((q, t, end, a))
            end = max(end, b)
    return out, total


def unexplained(gaps, truth: Truth, k: int, s: int, seg: int, check: dict,
                device) -> int:
    """Bases of the holes that no fragment the reference leaves unmapped
    explains (MashMap maps no fragment whose identity and its upper bound
    are both below --pi, and the chain breaks there). At most
    ``max_fragments`` fragments are looked at; the rest count."""
    left, budget = 0, check["max_fragments"]
    for q, t, a, b in gaps:
        qs = truth.seqs[q]
        offs = [o for o in identity.fragment_offsets(len(qs), seg)
                if o < b and o + seg > a]
        if len(offs) > budget:
            left += b - a
            continue
        budget -= len(offs)
        taus = truth.place(q, np.array(offs), t)
        ids = identity.identities(
            [(qs, truth.seqs[t], o, int(tau)) for o, tau in zip(offs, taus)],
            k, s, seg, check["reach"], check["pi"], device)
        cover = np.zeros(b - a, bool)
        for o, v in zip(offs, ids):
            if v is None:
                cover[max(o, a) - a:min(o + seg, b) - a] = True
        left += int((~cover).sum())
    return left


def row_identities(r: Row, truth: Truth, k: int, s: int, seg: int,
                   check: dict, device) -> List[float]:
    """The identities MashMap can give the row: the mean over its mapped
    fragments (MashMap's split of the query, those inside the row), and,
    where the row ends on an overlapping last fragment, the mean without
    the whole segment before it (MashMap's merge links a fragment to the
    nearest next one by distance and colinearity, so the segment before
    may drop out of the chain). Beside each, the means where one fragment's
    sketch lost one hash as a frequent seed (its count of shared hashes
    the same or one less, of a sketch one smaller): which hashes are
    frequent only the whole index knows (the most posted 0.001%)."""
    q, t = truth.seqs[r.q], truth.seqs[r.t]
    offs = [o for o in identity.fragment_offsets(len(q), seg)
            if o >= r.qs and o + min(seg, len(q)) <= r.qe]
    if not offs:
        return [0.0]
    taus = truth.place(r.q, np.array(offs), r.t)
    counts = identity.shared_counts(
        [(q, t, o, int(tau)) for o, tau in zip(offs, taus)], k, s, seg,
        check["reach"], check["pi"], device)
    pi = check["pi"]
    ids = [identity.mapped_identity(b, n, k, pi) for b, n in counts]
    sets = [list(range(len(ids)))]
    if len(offs) >= 3 and offs[-1] % seg and offs[-1] + seg == len(q):
        sets.append(sets[0][:-2] + sets[0][-1:])
    out = []
    for idx in sets:
        live = [i for i in idx if ids[i] is not None]
        if not live:
            continue
        total = sum(ids[i] for i in live)
        out.append(identity.chain_identity([ids[i] for i in live]))
        for i in live:
            b, n = counts[i]
            for v in (identity.mapped_identity(b, n - 1, k, pi),
                      identity.mapped_identity(b - 1, n - 1, k, pi)):
                if v is not None and n > 1:
                    out.append(float(np.float32(
                        (total - ids[i] + v) / len(live))))
    return out or [0.0]


def sample_rows(rows: Sequence[Row], seed: int, max_fragments: int,
                seg: int) -> List[Row]:
    """Distinct rows in an order drawn from the seed, the longest first,
    taken while their fragments fit ``max_fragments``."""
    uniq = list({r.key: r for r in rows}.values())
    if not uniq:
        return []
    order = np.random.default_rng([seed % (1 << 64), 7]).permutation(
        len(uniq))
    longest = max(range(len(uniq)), key=lambda i: uniq[i].qe - uniq[i].qs)
    got, n = [], 0
    for i in [longest] + [i for i in order if i != longest]:
        f = max(1, (uniq[i].qe - uniq[i].qs) // seg)
        if got and n + f > max_fragments:
            continue
        got.append(uniq[i])
        n += f
    return got


def judge(paf_texts: Sequence[str], truth: Truth, seed: int, check: dict,
          k: int, s: int, seg: int, device,
          limits: Dict[str, float]) -> Dict[str, float]:
    """The compared numbers of a window's PAFs (one text a job or pass):
    ``misplaced`` (rows off the truth, and lines that do not parse),
    ``uncovered_pct`` (the worst unit's), ``id_gap`` (widest over the
    sample); beside them ``checked_rows``, ``checked_fragments`` and
    ``failed_units``, the units with a number over its limit."""
    units, explained = [], {}
    for text in paf_texts:
        rows, bad = parse_paf(text)
        ok = [r for r in rows if placed(r, truth, seg)]
        gaps, total = holes(ok, truth, seg)
        key = tuple(gaps)
        if key not in explained:
            explained[key] = unexplained(gaps, truth, k, s, seg, check,
                                         device)
        units.append((bad + len(rows) - len(ok),
                      100.0 * explained[key] / max(total, 1), ok))
    picked = sample_rows([r for u in units for r in u[2]], seed,
                         check["max_fragments"], seg)
    ref = {r.key: row_identities(r, truth, k, s, seg, check, device)
           for r in picked}
    gaps = [max([min(abs(r.ident - v) for v in ref[r.key])
                 for r in u[2] if r.key in ref], default=0.0)
            for u in units]
    failed = sum(m > limits["misplaced"] or c > limits["uncovered_pct"]
                 or g > limits["id_gap"] for (m, c, _), g in zip(units, gaps))
    return {"misplaced": sum(u[0] for u in units),
            "uncovered_pct": max((u[1] for u in units), default=100.0),
            "id_gap": max(gaps, default=0.0) if picked else 1.0,
            "checked_rows": len(picked),
            "checked_fragments": sum(max(1, (r.qe - r.qs) // seg)
                                     for r in picked),
            "failed_units": failed}


def control(truth: Truth, seed: int, check: dict, k: int, s: int, seg: int,
            device, limits: Dict[str, float],
            one_fragment: bool = False) -> Dict[str, float]:
    """The control in the program's place: the reference's own rows (every
    expected pair, end to end at the truth) with the identity of a sketch
    of ``s // 2``; judged as a window's PAF is. It must come out not
    correct (``id_gap`` over its limit). With ``one_fragment`` its rows
    are single fragments of every pair, where ``row_identities`` allows
    one frequent seed: its ``id_gap`` shows what that allowance lets
    pass (no pair is expected whole, so ``uncovered_pct`` reads 0)."""
    rows = []
    for q, t in truth.pairs:
        n, m = len(truth.seqs[q]), len(truth.seqs[t])
        spans = ([(o, min(o + seg, n)) for o in
                  identity.fragment_offsets(n, seg)] if one_fragment
                 else [(0, n)])
        for a, b in spans:
            ends = truth.place(q, np.array([a, b]), t)
            rows.append(Row(q, n, a, b, truth.strand, t, m, int(ends[0]),
                            min(int(ends[1]), m), 0.0))
    picked = sample_rows(rows, seed, check["max_fragments"], seg)
    lines = []
    for r in picked:
        r.ident = row_identities(r, truth, k, s // 2, seg, check,
                                 device)[0]
        lines.append("\t".join(map(str, [
            r.q, r.qlen, r.qs, r.qe, r.strand, r.t, r.tlen, r.ts, r.te, 0,
            0, 0, f"id:f:{r.ident:.6g}"])))
    pairs = [] if one_fragment else [(r.q, r.t) for r in picked]
    return judge(["\n".join(lines)], dataclasses.replace(
        truth, pairs=pairs), seed, check, k, s, seg, device, limits)
