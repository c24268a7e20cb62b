"""Port mapping kernels (kernels/sketch.py, kernels/mapdev.py) vs the JAX
package on the same index and the same fragments; exact comparisons of
the sketches and of the packed L1 / L2 buffers."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mashmap_tpu import stats
from mashmap_tpu.params import FIXED
from mashmap_tpu.index.builder import build_index
from mashmap_tpu.kernels import mapdev as jmd
from mashmap_tpu.kernels import sketch as jsk
from mashmap_tpu_torch.kernels import mapdev as tmd
from mashmap_tpu_torch.kernels import sketch as tsk
from mashmap_tpu_torch.kernels.murmur import flip

sys.path.insert(0, os.path.dirname(__file__))
from genomes import mutate, pangenome, random_genome, revcomp  # noqa: E402

K, W, S = 11, 500, 24


def _u8(seq, L):
    a = np.full(L, ord("N"), np.uint8)
    b = np.frombuffer(seq.encode(), np.uint8)[:L]
    a[:len(b)] = b
    return a


@pytest.mark.parametrize("L,k,s", [
    (500, 11, 24),
    (300, 19, 40),
    (40, 11, 60),       # s >= L-k+1: more sketch slots than windows
    (16, 11, 8),        # s >= L-k+1 at a tiny fragment
])
def test_sketch_fragments_matches_jax(L, k, s):
    rng = np.random.default_rng(L + s)
    base = random_genome(4 * L, seed=L)
    rows = [_u8(base[i:], L) for i in range(0, 3 * L, L // 2 or 1)][:6]
    rows.append(_u8(base[:L // 3], L))                  # N-padded tail
    rows.append(_u8(("ACGT" * L)[:L], L))               # low complexity
    frags = np.stack(rows)
    frags[rng.random(frags.shape) < 0.01] = ord("N")
    ours = tsk.sketch_fragments(torch.from_numpy(frags), k, s)
    ref = jsk.sketch_fragments(jnp.asarray(frags), k, s)
    np.testing.assert_array_equal(ours[0].numpy().view(np.uint64),
                                  np.asarray(ref[0]))
    for name, o, r in zip(("strand", "count", "complexity"), ours[1:],
                          ref[1:]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r),
                                      err_msg=name)


@pytest.fixture(scope="module")
def index_and_frags():
    recs = pangenome(3, 30_000, 0.05, seed=31)
    unit = random_genome(250, seed=32)
    recs.append(("rep", random_genome(5_000, seed=33) + unit * 60
                 + random_genome(5_000, seed=34)))
    idx = build_index(recs, K, W, S)
    g = recs[0][1]
    seqs = [mutate(g[i:i + W], 0.02, seed=i) for i in (0, 4_000, 17_500)]
    seqs.append(revcomp(g[9_000:9_000 + W]))
    seqs.append(random_genome(W, seed=35))               # no hits
    seqs.append(recs[3][1][5_200:5_200 + W])             # the repeat
    seqs.append(g[20_000:20_300])                        # short, N-padded
    seqs.append(recs[2][1][100:100 + W])
    frags = np.stack([_u8(s, W) for s in seqs])
    return idx, frags


def _tables(s):
    mh = np.ones(s + 1, np.int32)
    for sq in range(1, s + 1):
        mh[sq] = max(1, stats.estimate_minimum_hits_relaxed(
            sq, K, 0.85, FIXED.confidence_interval))
    ct = stats.sketch_cutoffs(s, K, 0.0, 0.999).astype(np.int32)
    return mh, ct


def _run_l1(idx, frags, ref_group, allowed, cfg):
    mh, ct = _tables(cfg.s)
    j_out = jmd.l1_step(
        jnp.asarray(frags), jnp.asarray(idx.uniq_hashes),
        jnp.asarray(idx.post_offsets.astype(np.int32)),
        jnp.asarray(idx.post_seqid), jnp.asarray(idx.post_wpos),
        jnp.asarray(idx.post_wend), jnp.asarray(idx.is_frequent),
        jnp.asarray(mh), jnp.asarray(ct), jnp.asarray(allowed),
        jnp.asarray(ref_group), jnp.asarray(idx.mi_seqid),
        jnp.asarray(idx.mi_wpos), cfg)
    mi_key = (idx.mi_seqid.astype(np.int64) << 32) | idx.mi_wpos
    t_out = tmd.l1_step(
        torch.from_numpy(frags),
        flip(torch.from_numpy(idx.uniq_hashes.view(np.int64))),
        torch.from_numpy(idx.post_offsets), torch.from_numpy(idx.post_seqid),
        torch.from_numpy(idx.post_wpos), torch.from_numpy(idx.post_wend),
        torch.from_numpy(idx.is_frequent), torch.from_numpy(mh),
        torch.from_numpy(ct), torch.from_numpy(allowed),
        torch.from_numpy(ref_group), torch.from_numpy(mi_key),
        tmd.L1Config(*cfg))
    return [np.asarray(x) for x in j_out], [x.numpy() for x in t_out]


@pytest.mark.parametrize("grouped,p_cap", [(False, 1024), (True, 1024),
                                           (False, 16)])
def test_l1_step_matches_jax(index_and_frags, grouped, p_cap):
    idx, frags = index_and_frags
    B = len(frags)
    if grouped:     # two reference prefix groups, self-group excluded
        ref_group = np.array([0, 0, 1, 1], np.int32)
        allowed = np.ones((B, idx.n_contigs), bool)
        allowed[:4, :2] = False
    else:
        ref_group = np.zeros(idx.n_contigs, np.int32)
        allowed = np.ones((B, idx.n_contigs), bool)
    cfg = jmd.L1Config(k=K, s=S, seg_length=W, p_cap=p_cap, c_cap=8,
                       t_cap=512, table_scale=1.0, n_groups=8)
    (jm, jc, js), (tm, tc, ts) = _run_l1(idx, frags, ref_group, allowed,
                                         cfg)
    np.testing.assert_array_equal(tm, jm)        # packed meta
    np.testing.assert_array_equal(tc, jc)        # rank-coded sketches
    np.testing.assert_array_equal(ts, js)        # strands
    o = tmd.unpack_l1_meta(tm, cfg.c_cap)
    assert o["n_cand"].sum() > 0
    if p_cap == 16:
        assert o["overflow"].any(), "the repeat must overflow p_cap"


@pytest.mark.parametrize("t_cap", [512, 1024])
def test_l2_step_matches_jax(index_and_frags, t_cap):
    idx, frags = index_and_frags
    B = len(frags)
    cfg = jmd.L1Config(k=K, s=S, seg_length=W, p_cap=1024, c_cap=8,
                       t_cap=t_cap, table_scale=1.0, n_groups=8)
    (jm, jc, js), _ = _run_l1(idx, frags, np.zeros(idx.n_contigs, np.int32),
                              np.ones((B, idx.n_contigs), bool), cfg)
    o = jmd.unpack_l1_meta(jm, cfg.c_cap)
    items = [(i, j) for i in range(B) for j in range(int(o["n_cand"][i]))
             if o["cand_hi"][i, j] - o["cand_lo"][i, j] <= t_cap]
    assert len(items) >= 4
    Wn = 16
    items = (items * Wn)[:Wn]
    ii = np.array([i for i, _ in items])
    jj = np.array([j for _, j in items])
    w = [o[f][ii, jj].astype(np.int32)
         for f in ("cand_lo", "cand_mid", "cand_hi", "cand_seq")]
    sq = o["s_q"][ii].astype(np.int32)
    mi = (idx.mi_rank, idx.mi_wpos, idx.mi_wend, idx.mi_strand,
          idx.mi_seqid)
    ref = np.asarray(jmd.l2_step(
        *(jnp.asarray(x) for x in w), jnp.asarray(jc[ii]),
        jnp.asarray(js[ii]), jnp.asarray(sq),
        *(jnp.asarray(x) for x in mi), t_cap=t_cap, s=S))
    ours = tmd.l2_step(
        *(torch.from_numpy(x) for x in w), torch.from_numpy(jc[ii]),
        torch.from_numpy(js[ii]), torch.from_numpy(sq),
        *(torch.from_numpy(x) for x in mi), t_cap=t_cap, s=S).numpy()
    n_runs, best, ovf, starts, ends, strands = tmd.unpack_l2_runs(ours)
    r_n, r_best, r_ovf, r_starts, r_ends, r_strands = \
        jmd.unpack_l2_runs(ref)
    np.testing.assert_array_equal(n_runs, r_n)
    np.testing.assert_array_equal(best, r_best)
    np.testing.assert_array_equal(ovf, r_ovf)
    assert (n_runs > 0).any()
    for r in range(Wn):       # live runs only: slots beyond are unused
        n = min(int(n_runs[r]), tmd.L2_RUN_CAP)
        np.testing.assert_array_equal(starts[r, :n], r_starts[r, :n])
        np.testing.assert_array_equal(ends[r, :n], r_ends[r, :n])
        np.testing.assert_array_equal(strands[r, :n], r_strands[r, :n])


# --- the device route's L2 row assembly over whole batches
# (map/rows.py, Mapper._collect_l2 and _post_batch) against the scalar
# rule (l2.loci_from_runs, Mapper._do_l2) ---

import dataclasses  # noqa: E402

from mashmap_tpu_torch.index import builder as tb  # noqa: E402
from mashmap_tpu_torch.map import l1 as tl1  # noqa: E402
from mashmap_tpu_torch.map import l2 as tl2  # noqa: E402
from mashmap_tpu_torch.map import rows as trows  # noqa: E402
from mashmap_tpu_torch.map.engine import (  # noqa: E402
    Mapper, _Batch, _Fragment, _Query)
from mashmap_tpu_torch.params import Parameters  # noqa: E402


@pytest.mark.parametrize("k,s,keep_low", [(19, 130, True), (11, 24, True),
                                          (11, 24, False)])
def test_l2_tables_equal_scalar_stats(k, s, keep_low):
    """Every (s_q, shared) entry of the identity tables and every
    (s_q, best) entry of the top-ANI cut, filled lazily by batch lookups,
    equals doL2Mapping's scalar value (the JAX package's stats): same
    bits, and the cut is the least intersection the float32 cutoff
    keeps."""
    pi, ani_diff = 0.85, 0.0
    f32 = np.float32
    tab = trows.L2Tables(k, s, pi, keep_low, ani_diff)
    sq, sh = np.array([(q, x) for q in range(1, s + 1)
                       for x in range(q + 1)]).T
    nuc, ub, ok = tab.identity(sh, sq)
    cut = tab.cut(sh, sq)
    for e, (q, x) in enumerate(zip(sq.tolist(), sh.tolist())):
        md = stats.j2md(float(f32(1.0) * f32(x) / f32(q)), k)
        want_nuc = float(f32(1) - f32(md))
        want_ub = 1.0 - stats.md_lower_bound(
            md, q, k, FIXED.confidence_interval)
        assert nuc[e] == want_nuc and ub[e] == want_ub, (q, x)
        assert ok[e] == ((keep_low and want_ub >= pi) or want_nuc >= pi)
        assert tab.identity1(x, q) == (want_nuc, want_ub, bool(ok[e]))
        # best = x: the cut of _do_l2 (computeMap.hpp:1196-1201)
        j_best = float(f32(float(x) / q))
        cutoff_ani = max(0.0, float(f32(f32(1.0) - f32(stats.j2md(
            j_best, k)) - f32(ani_diff))))
        cutoff_j = float(f32(stats.md2j(1.0 - cutoff_ani, k)))
        least = next(y for y in range(q + 2)
                     if not float(y) / q < cutoff_j)
        assert cut[e] == least == tab.cut1(x, q), (q, x)


@pytest.fixture(scope="module")
def grouped_index():
    """Five contigs in three PanSN groups (A#1, B#1, C#1)."""
    names = ("A#1#c0", "A#1#c1", "B#1#c0", "C#1#c0", "C#1#c1")
    return tb.build_index(
        [(n, random_genome(2_000, seed=60 + i)) for i, n in enumerate(names)],
        K, W, S, device="cpu")


def _mapper(idx, top_ani=True, keep_low=True, skip_prefix=True):
    p = Parameters(kmer_size=K, seg_length=W, sketch_size=S,
                   percentage_identity=0.85, skip_prefix=skip_prefix,
                   prefix_delim="#", keep_low_pct_id=keep_low,
                   stage1_topANI_filter=top_ani, no_progress=True).finalize()
    return Mapper(p, idx, device="cpu")


def _synthetic_batch(m, seed, n_frag=60):
    """A batch as _collect_l2 leaves it, every fragment on the device
    route: several s_q, candidates with equal intersections, loci with
    0 shared, ties in (seq, pos). Returns (ctx, per-fragment candidates
    and their loci lists) for the scalar rule."""
    rng = np.random.default_rng(seed)
    C = 16
    frags, s_q, n_cand = [], np.zeros(n_frag, np.int32), np.zeros(
        n_frag, np.int32)
    o = {f: np.zeros((n_frag, C), np.int32) for f in (
        "cand_seq", "cand_start", "cand_end", "cand_inter")}
    work = {f: [] for f in ("frag", "cand", "seq", "inter", "sq")}
    loci = {f: [] for f in ("item", "seq", "pos", "start", "end",
                            "shared", "strand")}
    scalar = []
    for i in range(n_frag):
        sq = int(rng.choice([S, S - 1, S - 5, 9]))
        nc = int(rng.integers(0, 9))
        s_q[i], n_cand[i] = sq, nc
        frags.append(_Fragment(0, 0, int(rng.choice([W, W, 317])), 0,
                               q=_Query(f"q{i // 3}", "", i // 3)))
        cands, lists = [], []
        for j in range(nc):
            seq = int(rng.integers(0, m.idx.n_contigs))
            inter = int(rng.choice([sq, sq, sq - 1, sq // 2, 3]))
            start = int(rng.integers(0, 1_000))
            o["cand_seq"][i, j], o["cand_inter"][i, j] = seq, inter
            o["cand_start"][i, j], o["cand_end"][i, j] = start, start + 99
            item = len(work["frag"])
            for f, v in zip(work, (i, j, seq, inter, sq)):
                work[f].append(v)
            cands.append(tl1.L1Candidate(seq, start, start + 99, inter))
            lst = []
            for _ in range(int(rng.integers(0, 4))):
                shared = int(rng.choice([0, 1, 2, sq, sq, sq - 1, sq // 2]))
                pos = int(rng.choice([100, 100, 700, 1_500]))
                a = int(rng.integers(0, 2_000))
                loc = tl2.L2Locus(seq, pos, a, a + 50, shared,
                                  int(rng.choice([-1, 1])))
                lst.append(loc)
                for f, v in zip(loci, (item, seq, pos, a, a + 50, shared,
                                       loc.strand)):
                    loci[f].append(v)
            lists.append(lst)
        scalar.append((cands, lists))
    o.update(s_q=s_q, n_cand=n_cand)
    work = {f: np.asarray(v, np.int64) for f, v in work.items()}
    work["host"] = np.zeros(len(work["frag"]), bool)
    ctx = _Batch(frags=frags, o=o, cx=rng.uniform(0, 1, n_frag),
                 host_frag=np.zeros(n_frag, bool), work=work,
                 loci={f: np.asarray(v, np.int64) for f, v in loci.items()},
                 qh_host={})
    return ctx, scalar


def _bits(m):
    return tuple(np.float64(v).tobytes() if isinstance(v, float) else v
                 for v in dataclasses.astuple(m))


@pytest.mark.parametrize("skip_prefix", [True, False])
@pytest.mark.parametrize("keep_low", [True, False])
@pytest.mark.parametrize("top_ani", [True, False])
def test_array_post_equals_scalar_do_l2(grouped_index, monkeypatch, tmp_path,
                                        top_ani, keep_low, skip_prefix):
    """_post_batch's array path gives, fragment by fragment, the rows of
    the scalar _do_l2 over each group's candidates (sorted by ref_seq_id,
    ref_start, stably): same fields, floats by their bits, same order;
    the top-ANI filter cuts candidates mid-segment."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    m = _mapper(grouped_index, top_ani, keep_low, skip_prefix)
    ctx, scalar = _synthetic_batch(m, seed=7)
    got = m._post_batch(ctx)
    n_rows = n_passing = 0
    for i, ((fr, rows), (cands, lists)) in enumerate(zip(got, scalar)):
        assert fr is ctx.frags[i]
        j_of = {id(c): j for j, c in enumerate(cands)}
        groups: dict = {}
        for c in cands:
            g = int(m.ref_groups[c.seq_id]) if skip_prefix else 0
            groups.setdefault(g, []).append(c)
        want = []
        for g in sorted(groups):
            want += m._do_l2(fr.q, fr, None, None, int(ctx.o["s_q"][i]),
                             ctx.cx[i], groups[g],
                             lambda c: lists[j_of[id(c)]])
        want.sort(key=lambda r: (r.ref_seq_id, r.ref_start))
        assert [_bits(r) for r in rows] == [_bits(r) for r in want], i
        n_rows += len(rows)
        n_passing += sum(m.l2_tab.identity1(loc.shared_sketch_size,
                                            int(ctx.o["s_q"][i]))[2]
                         for lst in lists for loc in lst)
    assert n_rows > 50
    # the cut drops passing loci only under the top-ANI filter
    assert (n_rows < n_passing) == top_ani


def _runs_buffer(rng, R, seg):
    """A packed l2_step run buffer (kernels/mapdev.py::unpack_l2_runs) of
    R random rows: n_runs from 0 to L2_RUN_CAP, gaps of exactly seg and
    seg + 1 among others, junk in unused slots."""
    L = tmd.L2_RUN_CAP
    buf = rng.integers(-9, 10_000, (R, 3 + 3 * L)).astype(np.int32)
    for r in range(R):
        n = int(rng.choice([0, L, 1, 2, int(rng.integers(0, L + 1))]))
        buf[r, 0], buf[r, 1], buf[r, 2] = n, rng.integers(0, S + 1), 0
        end = int(rng.integers(0, 3_000))
        for c in range(n):
            gap = int(rng.choice([seg, seg + 1, seg - 1, 0, 37, 9_000]))
            start = end + gap if c else end
            end = start + int(rng.integers(0, 600))
            buf[r, 3 + c], buf[r, 3 + L + c] = start, end
            buf[r, 3 + 2 * L + c] = rng.choice([-1, 1])
    return buf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loci_arrays_equal_loci_from_runs(seed):
    """The array run decode gives loci_from_runs's loci, row by row."""
    rng = np.random.default_rng(seed)
    buf = _runs_buffer(rng, 400, W)
    n_runs, best, _, starts, ends, strands = tmd.unpack_l2_runs(buf)
    row, o_start, o_end, pos, shared, strand = tl2.loci_arrays(
        n_runs, best, starts, ends, strands, W)
    got = [tl2.L2Locus(7, *v) for v in zip(pos.tolist(), o_start.tolist(),
                                          o_end.tolist(), shared.tolist(),
                                          strand.tolist())]
    want, want_row = [], []
    for r in range(len(buf)):
        lst = tl2.loci_from_runs(n_runs[r], best[r], starts[r], ends[r],
                                 strands[r], 7, W)
        want += lst
        want_row += [r] * len(lst)
    assert row.tolist() == want_row
    assert got == want
    assert (n_runs == 0).any() and (n_runs == tmd.L2_RUN_CAP).any()


class _Landed:
    """A copy that has landed (hostcopy.HostCopy's wait)."""

    def __init__(self, a):
        self.a = a

    def wait(self):
        return self.a


def test_collect_l2_decodes_chunks_with_pads(grouped_index, monkeypatch,
                                             tmp_path):
    """_collect_l2 decodes a replicated chunk (pad rows past its items)
    and a sharded one (-1 pad rows among them) in one go: each item's
    loci are loci_from_runs's, in order; items whose runs overflowed
    turn to the host replay, their sketch rows gathered late."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    m = _mapper(grouped_index)
    rng = np.random.default_rng(5)
    buf = _runs_buffer(rng, 16, W)
    buf[[2, 11, 12], 2] = 1          # overflowed runs (row 11 a pad)
    chunk_a = np.array([4, 0, 7, 1, 9])          # rows 0-4; 5-7 pad
    chunk_b = np.array([-1, 3, 2, -1, 8, 5, -1, 6])
    n_items = 10
    work = {"frag": np.arange(n_items) // 2, "cand": np.arange(n_items) % 2,
            "seq": rng.integers(0, 5, n_items),
            "host": np.zeros(n_items, bool)}
    ctx = _Batch(frags=[None] * 5, work=work,
                 pending=[(chunk_a, 8), (chunk_b, 8)], pcat=_Landed(buf),
                 qh_pick=([], None),
                 qh_dev=torch.zeros((5, S), dtype=torch.int32),
                 qs_dev=torch.zeros((5, S), dtype=torch.int32))
    m._collect_l2(ctx)
    rows_of = {int(it): r for r, it in enumerate(
        np.concatenate([chunk_a, [-1] * 3, chunk_b])) if it >= 0}
    assert work["host"].tolist() == [it in (7, 8) for it in range(n_items)]
    assert sorted(ctx.qh_host) == [3, 4]
    loc = ctx.loci
    for it in range(n_items):
        r = rows_of[it]
        sel = loc["item"] == it
        got = [tl2.L2Locus(*v) for v in zip(*(loc[f][sel].tolist() for f in (
            "seq", "pos", "start", "end", "shared", "strand")))]
        want = [] if work["host"][it] else tl2.loci_from_runs(
            buf[r, 0], buf[r, 1], buf[r, 3:3 + tmd.L2_RUN_CAP],
            buf[r, 3 + tmd.L2_RUN_CAP:3 + 2 * tmd.L2_RUN_CAP],
            buf[r, 3 + 2 * tmd.L2_RUN_CAP:], int(work["seq"][it]), W)
        assert got == want, it
    assert len(loc["item"]) > 10
