"""MashMap's identity of a query fragment at a target locus, worked out
from the two sequences alone.

MashMap sketches a query fragment of ``seg_length`` bases as Q, the s
smallest distinct canonical k-mer hashes. Its index holds, for every
window of ``span = seg_length - k + 1`` k-mers of a target, R_t, the s
smallest distinct hashes of window t. Its L2 stage slides over the
windows of a candidate region and counts, at each, the hashes of Q that
are in R_t and among the s smallest of Q | R_t; the best count over the
region is the fragment's shared sketch, and its identity is one minus
the Mash distance of shared / |Q| (``nuc_identity``).

Here every window t within ``reach`` windows of the locus the generator
says the fragment came from is looked at; the candidate region is found
among them as L1 finds it (``best_shared``). By the min-hash property,
the s smallest of Q | R_t are the s smallest of Q | W_t, W_t all of
window t's distinct hashes, so only hashes no larger than Q's largest
matter: those of the region and Q, sorted, give each window's ranks by
one cumulative sum. A sketch size below the configuration's gives the
control (a smaller sketch of the same sequences).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import stats
from .murmur import canonical, ukey

BIG = torch.iinfo(torch.int64).max


def nuc_identity(shared: int, s_q: int, k: int) -> float:
    j = float(np.float32(1.0) * np.float32(shared) / np.float32(s_q))
    return float(np.float32(1) - np.float32(stats.j2md(j, k)))


def mapped_identity(shared: int, s_q: int, k: int, pi: float):
    """The fragment's identity, or None where MashMap maps it nowhere:
    no shared hash, or both the identity and its upper confidence bound
    below --pi."""
    if shared <= 0:
        return None
    ident = nuc_identity(shared, s_q, k)
    md = stats.j2md(float(np.float32(1.0) * np.float32(shared)
                          / np.float32(s_q)), k)
    upper = 1.0 - stats.md_lower_bound(md, s_q, k, stats.CONFIDENCE_INTERVAL)
    return ident if upper >= pi or ident >= pi else None


def chain_identity(ids: Sequence[float]) -> float:
    """A merged row's identity: the mean of its fragments', rounded to
    float (MashMap keeps it in a float member)."""
    return float(np.float32(sum(ids) / len(ids)))


def query_sketch(q: torch.Tensor, k: int, s: int):
    """(Q, s_q): each row's s smallest distinct valid hashes as ``ukey``
    values ascending, BIG-padded, (F, s); and how many there are."""
    h, _, valid = canonical(q, k)
    key = torch.sort(torch.where(valid, ukey(h), BIG), -1).values
    new = torch.ones_like(key, dtype=torch.bool)
    new[:, 1:] = key[:, 1:] != key[:, :-1]
    new &= key != BIG
    keep = new & (torch.cumsum(new.to(torch.int32), -1) <= s)
    qs = torch.sort(torch.where(keep, key, BIG), -1).values[:, :s]
    return qs, keep.sum(-1)


def best_shared(q: torch.Tensor, region: torch.Tensor, n_t: torch.Tensor,
                at_start: torch.Tensor, k: int, s: int, span: int,
                pi: float):
    """The shared sketch MashMap's L1 and L2 stages give each query
    fragment at its region.

    q: (F, seg_length) uint8 fragments; region: (F, T + span + k - 2)
    uint8 target bytes from window a of the target on ('N' past its
    end); n_t: (F,) windows of the region that exist; at_start: (F,)
    whether a is the target's first window.

    L1: the overlap at window t is how many of Q are in R_t; its events
    are the windows where one of Q enters or leaves R_t. The candidate
    runs from the first to the last event whose overlap reaches the
    minimum (the relaxed minimum, raised by the top-ANI cutoff table at
    the best overlap). L2: the best shared count over the candidate's
    windows. At a target's first window the index's rows all begin
    together, and L2 steps through them one by one in the order they
    end, so those partial states count too.
    Returns (best (F,), s_q (F,)).
    """
    Q, s_q = query_sketch(q, k, s)
    F = q.shape[0]
    dev = q.device
    ar = torch.arange(F, device=dev)
    theta = Q[ar, (s_q - 1).clamp(min=0)]
    rh, _, rv = canonical(region, k)
    rkey = torch.where(rv & (ukey(rh) <= theta[:, None]), ukey(rh), BIG)
    allv = torch.sort(torch.cat([Q, rkey], -1), -1).values
    new = torch.ones_like(allv, dtype=torch.bool)
    new[:, 1:] = allv[:, 1:] != allv[:, :-1]
    new &= allv != BIG
    M = max(int(new.sum(-1).max()), 1)
    G = torch.sort(torch.where(new, allv, BIG), -1).values[:, :M]
    G = G.contiguous()
    pos = torch.searchsorted(Q.contiguous(), G).clamp(max=Q.shape[1] - 1)
    inq = (Q.gather(1, pos) == G) & (G != BIG)

    T = region.shape[1] - k + 1 - span + 1
    live = rkey != BIG
    f_i, p_i = torch.nonzero(live, as_tuple=True)
    g_i = torch.searchsorted(G, rkey.contiguous())[f_i, p_i]
    t0 = (p_i - span + 1).clamp(min=0)
    t1 = p_i + 1
    diff = torch.zeros((F, T + 1, M), dtype=torch.int32, device=dev)
    flat = diff.view(-1)
    one = torch.ones_like(f_i, dtype=torch.int32)
    ok = t0 < T
    flat.index_add_(0, ((f_i * (T + 1) + t0) * M + g_i)[ok], one[ok])
    ok = t1 < T
    flat.index_add_(0, ((f_i * (T + 1) + t1) * M + g_i)[ok], -one[ok])
    present = torch.cumsum(diff, 1, dtype=torch.int32)[:, :T] > 0
    del diff, flat
    tt = torch.arange(T, device=dev)[None, :]
    valid = tt < n_t[:, None]

    # L1: R_t is the s smallest of window t; Q's members of it
    member = present & (torch.cumsum(present, 2, dtype=torch.int32) <= s)
    qm = member & inq[:, None, :]
    overlap = torch.where(valid, qm.sum(2), 0)
    event = torch.zeros_like(valid)
    event[:, 1:] = (qm[:, 1:] != qm[:, :-1]).any(2)
    event[:, 0] = at_start & qm[:, 0].any(-1)
    best_ov = overlap.max(1).values
    table = torch.from_numpy(stats.cutoffs(s, k)).to(dev)
    relaxed = torch.tensor([stats.minimum_hits(int(n), k, pi) if n else 0
                            for n in s_q.tolist()], device=dev)
    need = torch.maximum(table[torch.minimum(best_ov, s_q).clamp(
        max=len(table) - 1)], relaxed)
    qual = event & valid & (overlap >= need[:, None])
    mapped = qual.any(1) & (best_ov >= relaxed) & (s_q > 0)
    big = torch.full_like(tt.expand(F, T), T)
    rs = torch.where(qual, tt, big).min(1).values
    re = torch.where(qual, tt, -1).max(1).values
    in_range = (tt >= rs[:, None]) & (tt <= re[:, None]) & valid

    # L2: the s_q smallest of Q | W_t (the same as of Q | R_t)
    rank = torch.cumsum(present | inq[:, None, :], 2, dtype=torch.int32)
    shared = (present & inq[:, None, :] & (rank <= s_q[:, None, None])).sum(2)
    best = torch.where(in_range, shared, -1).max(1).values
    for f in torch.nonzero(mapped & at_start & (rs == 0)).flatten().tolist():
        best[f] = max(int(best[f]), _first_window_steps(
            member[f], inq[f], int(s_q[f])))
    return torch.where(mapped, best, 0), s_q


def _first_window_steps(member: torch.Tensor, inq: torch.Tensor,
                        s_q: int) -> int:
    """The best shared count of the partial states at a target's first
    window: its members (those no larger than Q's largest) taken one by
    one in the order they leave the sketch."""
    cols = torch.nonzero(member[0]).flatten()
    if len(cols) == 0:
        return 0
    gone = ~member[1:, cols]
    leave = torch.where(gone.any(0), gone.to(torch.int8).argmax(0),
                        member.shape[0])
    order = cols[torch.sort(leave, stable=True).indices]
    m = len(order)
    steps = torch.zeros((m, member.shape[1]), dtype=torch.bool,
                        device=member.device)
    ar = torch.arange(m, device=member.device)
    steps[:, order] = ar[:, None] >= ar[None, :]
    rank = torch.cumsum(steps | inq[None, :], 1, dtype=torch.int32)
    return int((steps & inq[None, :] & (rank <= s_q)).sum(1).max())


def fragment_offsets(qlen: int, seg_length: int):
    """MashMap's split of a query into fragments: every whole segment,
    and one more ending at the query's end where a part is left."""
    if qlen <= seg_length:
        return [0]
    n = qlen // seg_length
    out = [i * seg_length for i in range(n)]
    if qlen % seg_length:
        out.append(qlen - seg_length)
    return out


def identities(jobs, k: int, s: int, seg_length: int, reach: int, pi: float,
               device):
    """Identity of each fragment job (see ``shared_counts``); None where
    it does not map (``mapped_identity``)."""
    return [mapped_identity(b, n, k, pi) for b, n in shared_counts(
        jobs, k, s, seg_length, reach, pi, device)]


def shared_counts(jobs, k: int, s: int, seg_length: int, reach: int,
                  pi: float, device, chunk: int = 16):
    """(best shared count, sketch size) of each fragment job (query
    bytes, target bytes, query offset, target window the generator puts
    it at) at sketch size s, over the target windows [a, a + 2 reach],
    a = max(0, window - reach). A query shorter than a segment is one
    fragment of its own length ('N'-padded: its sketch takes only its
    own k-mers)."""
    span = seg_length - k + 1
    width = 2 * reach + seg_length
    out = []
    for c0 in range(0, len(jobs), chunk):
        part = jobs[c0:c0 + chunk]
        qb = np.full((len(part), seg_length), ord("N"), np.uint8)
        for i, (q, _, off, _) in enumerate(part):
            piece = q[off:off + seg_length]
            qb[i, :len(piece)] = piece
        rb = np.full((len(part), width), ord("N"), np.uint8)
        n_t = np.zeros(len(part), np.int64)
        at0 = np.zeros(len(part), bool)
        for i, (_, t, _, tau) in enumerate(part):
            n_w = len(t) - seg_length + 1
            a = max(0, tau - reach)
            b = min(n_w - 1, a + 2 * reach)
            at0[i] = a == 0
            if b >= a:
                rb[i, :b - a + seg_length] = t[a:b + seg_length]
                n_t[i] = b - a + 1
        best, s_q = best_shared(
            torch.from_numpy(qb).to(device), torch.from_numpy(rb).to(device),
            torch.from_numpy(n_t).to(device), torch.from_numpy(at0).to(device),
            k, s, span, pi)
        out += list(zip(best.tolist(), s_q.tolist()))
    return out
