"""The port's parallel layer on the CPU, held against the JAX package
(whose conftest gives JAX 8 virtual CPU devices): the sharded index
layout, the sharded L1 and L2 steps, and the PAF of a Mapper on a device
list, sharded or replicated. Device lists repeat "cpu", so n shards or
blocks exist on one host. Every comparison is exact."""

import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from mashmap_tpu import stats as jax_stats
from mashmap_tpu.api import map_files as jax_map_files
from mashmap_tpu.index.builder import build_index as jax_build_index
from mashmap_tpu.kernels import mapdev as jmd
from mashmap_tpu.params import FIXED, Parameters as JaxParameters
from mashmap_tpu.parallel import mesh as jax_mesh
from mashmap_tpu.parallel import sharded_index as jsi
from mashmap_tpu_torch.api import map_files
from mashmap_tpu_torch.index.builder import ReferenceIndex
from mashmap_tpu_torch.kernels import mapdev as tmd
from mashmap_tpu_torch.kernels.murmur import flip
from mashmap_tpu_torch.map.engine import Mapper, _batch_pad_rows
from mashmap_tpu_torch.params import Parameters
from mashmap_tpu_torch.parallel import mesh, sharded_index as tsi

sys.path.insert(0, os.path.dirname(__file__))
from genomes import mutate, pangenome, write_fasta  # noqa: E402
from port_fixtures import jax_native_reader, one_torch_thread  # noqa

K, W, S = 11, 500, 24
B = 24                      # divisible by both shard counts
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    recs = pangenome(3, 12_000, divergence=0.05, seed=23)
    jidx = jax_build_index(recs, kmer_size=K, window_size=W, sketch_size=S)
    idx = ReferenceIndex.from_numpy(
        {f: getattr(jidx, f) for f in (
            "names", "lengths", "uniq_hashes", "post_offsets", "post_seqid",
            "post_wpos", "post_wend", "mi_rank", "mi_seqid", "mi_wpos",
            "mi_wend", "mi_strand", "is_frequent", "freq_threshold",
            "kmer_size", "window_size", "sketch_size")})
    rng = np.random.default_rng(5)
    frags = np.zeros((B, W), np.uint8)
    cat = "".join(sq for _, sq in recs).encode()
    for i in range(B):
        o = int(rng.integers(0, len(cat) - W))
        frags[i] = np.frombuffer(cat[o:o + W], np.uint8)
    mh = np.ones(S + 1, np.int32)
    for sq in range(1, S + 1):
        mh[sq] = max(1, jax_stats.estimate_minimum_hits_relaxed(
            sq, K, 0.8, FIXED.confidence_interval))
    ct = jax_stats.sketch_cutoffs(S, K, 0.0, 0.999).astype(np.int32)
    return dict(recs=recs, jidx=jidx, idx=idx, frags=frags, mh=mh, ct=ct,
                allowed=np.ones((B, idx.n_contigs), bool),
                groups=np.zeros(idx.n_contigs, np.int32))


def _both_sharded(setup, n):
    jsidx = jsi.build_sharded_index(setup["jidx"], jax_mesh.make_mesh(n))
    return jsidx, tsi.build_sharded_index(setup["idx"], [CPU] * n)


def _stack(parts):
    return np.stack([t.numpy() for t in parts])


@pytest.mark.parametrize("n", [8, 3])
def test_sharded_index_layout_matches_jax(setup, n):
    j, t = _both_sharded(setup, n)
    assert (t.n_shards, t.u_shard, t.p_shard, t.m_shard) == \
        (j.n_shards, j.u_shard, j.p_shard, j.m_shard)
    np.testing.assert_array_equal(
        _stack([flip(u) for u in t.uniq]).view(np.uint64),
        np.asarray(j.uniq))
    for f in ("offsets", "seqid", "wpos", "wend", "frequent", "mi_rank",
              "mi_wpos", "mi_wend", "mi_strand", "mi_seqid", "mi_key"):
        np.testing.assert_array_equal(_stack(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    np.testing.assert_array_equal(t.mi_bounds, j.mi_bounds)
    np.testing.assert_array_equal(t.mi_row0, np.asarray(j.mi_row0)[:, 0])
    np.testing.assert_array_equal(t.key_bounds, np.asarray(j.key_bounds))
    assert len(t.shard_bytes()) == n and min(t.shard_bytes()) > 0


def _l1_both(setup, n, p_cap):
    j, t = _both_sharded(setup, n)
    jm = jax_mesh.make_mesh(n)
    cfg_j = jmd.L1Config(k=K, s=S, seg_length=W, p_cap=p_cap, c_cap=8,
                         t_cap=128, table_scale=1.0, n_groups=8)
    cfg_t = tmd.L1Config(*cfg_j)
    a = jsi.l1_step_sharded(
        jnp.asarray(setup["frags"]), j.uniq, j.offsets, j.seqid, j.wpos,
        j.wend, j.frequent, jnp.asarray(setup["mh"]),
        jnp.asarray(setup["ct"]), jnp.asarray(setup["allowed"]),
        jnp.asarray(setup["groups"]), j.mi_key, j.mi_row0, j.key_bounds,
        cfg_j, jm, j.p_shard)
    tt_ = torch.from_numpy
    b = tsi.l1_step_sharded(
        tt_(setup["frags"]), t.uniq, t.offsets, t.seqid, t.wpos, t.wend,
        t.frequent, tt_(setup["mh"]), tt_(setup["ct"]),
        tt_(setup["allowed"]), tt_(setup["groups"]), t.mi_key, t.mi_row0,
        t.key_bounds, cfg_t, min(t.p_shard, p_cap))
    return [np.asarray(x) for x in a], [x.numpy() for x in b], t, cfg_t


@pytest.mark.parametrize("n", [8, 3])
def test_l1_step_sharded_matches_jax(setup, n):
    (ja, jq, js), (ta, tq, ts), _, cfg = _l1_both(setup, n, 512)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    o = tmd.unpack_l1_meta(ta, cfg.c_cap)
    assert o["n_cand"].sum() > 0 and not o["overflow"].any()
    # and the port's replicated l1_step
    idx = setup["idx"]
    tt_ = torch.from_numpy
    rep = tmd.l1_step(
        tt_(setup["frags"]), flip(tt_(idx.uniq_hashes.view(np.int64))),
        tt_(idx.post_offsets), tt_(idx.post_seqid), tt_(idx.post_wpos),
        tt_(idx.post_wend), tt_(idx.is_frequent), tt_(setup["mh"]),
        tt_(setup["ct"]), tt_(setup["allowed"]), tt_(setup["groups"]),
        tt_((idx.mi_seqid.astype(np.int64) << 32)
            | idx.mi_wpos.astype(np.int64)), cfg)
    np.testing.assert_array_equal(rep[0].numpy(), ta)


def test_l1_step_sharded_capped_gather(setup):
    """A gather cap of p_cap per shard (the engine's choice) flags the
    same rows for the host route as JAX's p_shard-wide gather, and
    equals it on every other row."""
    (ja, jq, js), (ta, tq, ts), t, cfg = _l1_both(setup, 3, 64)
    assert t.p_shard > 64
    over = ja[:, 2] != 0
    assert over.any() and not over.all()
    np.testing.assert_array_equal(ta[:, 2], ja[:, 2])
    np.testing.assert_array_equal(ta[~over], ja[~over])
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)


def test_l2_step_sharded_matches_jax(setup):
    """Work items routed to the shard whose slab holds their slice."""
    n, T = 3, 128
    j, t = _both_sharded(setup, n)
    (ja, jq, js), _, _, cfg = _l1_both(setup, n, 512)
    a = jmd.unpack_l1_meta(ja, cfg.c_cap)
    work = [(i, jj) for i in range(B) for jj in range(int(a["n_cand"][i]))
            if a["cand_hi"][i, jj] - a["cand_lo"][i, jj] <= T]
    assert len(work) > 4
    Wp = len(work)
    bnds = t.mi_bounds
    arrs = {k: np.zeros((n, Wp), np.int32) for k in ("lo", "mid", "hi",
                                                       "seq")}
    qh = np.full((n, Wp, S), np.int32(2**31 - 1), np.int32)
    qs = np.zeros((n, Wp, S), np.int8)
    sq = np.ones((n, Wp), np.int32)
    slot, fill = {}, [0] * n
    for r, (i, jj) in enumerate(work):
        lo = int(a["cand_lo"][i, jj])
        d = min(max(int(np.searchsorted(bnds, lo, side="right")) - 1, 0),
                n - 1)
        rr = fill[d]
        fill[d] += 1
        for k in ("lo", "mid", "hi"):
            arrs[k][d, rr] = int(a[f"cand_{k}"][i, jj]) - int(bnds[d])
        arrs["seq"][d, rr] = a["cand_seq"][i, jj]
        qh[d, rr], qs[d, rr], sq[d, rr] = jq[i], js[i], a["s_q"][i]
        slot[r] = (d, rr)
    assert len({d for d, _ in slot.values()}) > 1, "one shard took all"
    shp = NamedSharding(jax_mesh.make_mesh(n), PartitionSpec("data"))
    import jax
    want = np.asarray(jsi.l2_step_sharded(
        *(jax.device_put(x, shp) for x in (
            arrs["lo"], arrs["mid"], arrs["hi"], arrs["seq"], qh, qs, sq)),
        j.mi_rank, j.mi_wpos, j.mi_wend, j.mi_strand, j.mi_seqid, T, S,
        jax_mesh.make_mesh(n)))
    per = [[torch.from_numpy(np.ascontiguousarray(x[d])) for d in range(n)]
           for x in (arrs["lo"], arrs["mid"], arrs["hi"], arrs["seq"], qh,
                     qs, sq)]
    got = tsi.l2_step_sharded(*per, t.mi_rank, t.mi_wpos, t.mi_wend,
                              t.mi_strand, t.mi_seqid, T, S)
    for r, (d, rr) in slot.items():
        np.testing.assert_array_equal(got[d][rr].numpy(), want[d, rr],
                                      err_msg=f"l2 row {r}")


def test_make_mesh_and_pad_rows():
    assert mesh.make_mesh(["cpu"] * 3) == [CPU] * 3
    assert mesh.distinct([CPU, CPU]) == [CPU]
    with pytest.raises(ValueError):
        mesh.make_mesh([])
    for b in (1, 7, 64, 100, 511, 512, 700):
        one = _batch_pad_rows(b, 512)
        assert _batch_pad_rows(b, 512, 1) == one
        three = _batch_pad_rows(b, 512, 3)
        assert three % 3 == 0 and one <= three < one + 3


@pytest.fixture(scope="module")
def files(tmp_path_factory, setup):
    """The pangenome and a query set: mutated pieces of every haplotype,
    both strands' worth of reads, and a read shorter than the segment."""
    d = tmp_path_factory.mktemp("torch_parallel")
    ref = str(d / "ref.fa")
    write_fasta(ref, setup["recs"])
    qs = []
    for i, (_, seq) in enumerate(setup["recs"] * 2):
        lo = (i * 1_700) % 6_000
        qs.append((f"q{i}", mutate(seq[lo:lo + 5_500], 0.03, seed=60 + i)))
    qs.append(("short", setup["recs"][1][1][300:700]))
    qf = str(d / "q.fa")
    write_fasta(qf, qs)
    jax_paf = str(d / "jax.paf")
    jax_map_files(JaxParameters(
        ref_sequences=[ref], query_sequences=[qf], out_file_name=jax_paf,
        kmer_size=K, seg_length=W, sketch_size=S, percentage_identity=0.8,
        batch_fragments=16, no_progress=True))
    with open(jax_paf) as fh:
        return d, ref, qf, fh.read()


def _port_paf(files, tag, devices, shard=False, **kw):
    d, ref, qf, _ = files
    out = str(d / f"{tag}.paf")
    p = Parameters(ref_sequences=[ref], query_sequences=[qf],
                   out_file_name=out, kmer_size=K, seg_length=W,
                   sketch_size=S, percentage_identity=0.8,
                   batch_fragments=16, no_progress=True, shard_index=shard,
                   **kw)
    map_files(p, devices=devices)
    with open(out) as fh:
        return fh.read()


def test_sharded_mapper_paf_matches_jax(files, monkeypatch):
    want = files[3]
    assert want.count("\n") >= 7
    made = []
    real = Mapper._device_tables

    def spy(self):
        t = real(self)
        made.append(self)
        return t
    monkeypatch.setattr(Mapper, "_device_tables", spy)
    got = _port_paf(files, "sharded4", ["cpu"] * 4, shard=True)
    m = made[0]
    assert m._sharded is not None and m._sharded.n_shards == 4
    # no O(index) array is replicated in sharded mode
    assert set(m._dev) == {"min_hits_table", "cutoff_table", "ref_group"}
    assert m.path_stats["l2_buckets"], m.path_stats
    assert got == want
    assert _port_paf(files, "replicated1", ["cpu"]) == want


def test_sharded_mapper_low_caps_take_the_host_routes(files, monkeypatch):
    """Caps low enough that rows overflow the postings cap and L2 slices
    leave the top bucket: the sharded Mapper's host routes give the same
    PAF."""
    import mashmap_tpu_torch.map.engine as eng
    monkeypatch.setattr(eng, "T_BUCKETS_SHARDED", (64,))
    made = []
    real = Mapper._collect_l1

    def spy(self, ctx):
        made.append(self)
        return real(self, ctx)
    monkeypatch.setattr(Mapper, "_collect_l1", spy)
    got = _port_paf(files, "sharded_low", ["cpu"] * 3, shard=True,
                    l1_postings_cap=40)
    st = made[0].path_stats
    assert st["host_frags"] > 0 and st["host_l2"] > 0, st
    assert got == files[3]


def test_replicated_device_list_paf_matches_single(files):
    assert _port_paf(files, "rep3", ["cpu"] * 3) == files[3]


def test_shard_index_on_one_device_warns_and_maps(files, caplog):
    with caplog.at_level(logging.WARNING, "mashmap_tpu_torch.map"):
        got = _port_paf(files, "shard1", ["cpu"], shard=True)
    assert "only one device" in caplog.text
    assert got == files[3]
