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
