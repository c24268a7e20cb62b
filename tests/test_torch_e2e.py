"""The port's map_files writes PAF byte-identical to the JAX package's,
on CPU tensors, across the mapping modes and both host routes."""

import io
import os
import sys

import numpy as np
import pytest

from mashmap_tpu.api import map_files as jax_map_files
from mashmap_tpu.index.builder import build_index as jax_build_index
from mashmap_tpu.map.engine import Mapper as JaxMapper
from mashmap_tpu.params import Parameters as JaxParameters
from mashmap_tpu_torch.api import map_files
from mashmap_tpu_torch.index.builder import build_index
from mashmap_tpu_torch.map.engine import Mapper
from mashmap_tpu_torch.params import Parameters, FILTER_ONETOONE

sys.path.insert(0, os.path.dirname(__file__))
from genomes import (mutate, pangenome, random_genome, revcomp,  # noqa
                     write_fasta)
from port_fixtures import jax_native_reader, one_torch_thread  # noqa

SMALL = dict(kmer_size=11, seg_length=500, sketch_size=30,
             percentage_identity=0.80, no_progress=True)


def _both(tmp_path, recs, queries=None, **kw):
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, recs)
    extra = {}
    if queries is not None:
        qf = str(tmp_path / "q.fa")
        write_fasta(qf, queries)
        extra["query_sequences"] = [qf]
    out = {}
    for tag, P, run in (("jax", JaxParameters, jax_map_files),
                        ("port", Parameters, None)):
        path = str(tmp_path / f"{tag}.paf")
        p = P(ref_sequences=[ref], out_file_name=path, **extra,
              **{**SMALL, **kw})
        if run is None:
            map_files(p, device="cpu")
        else:
            run(p)
        with open(path) as fh:
            out[tag] = fh.read()
    return out["jax"], out["port"]


@pytest.mark.parametrize("mode", [
    "selfmap_prefix", "n3", "batch8", "onetoone", "nosplit"])
def test_selfmap_modes_paf_identical(tmp_path, mode):
    recs = pangenome(4, 20_000, divergence=0.05, seed=7)
    kw = {
        "selfmap_prefix": dict(skip_prefix=True, prefix_delim="#",
                               num_mappings_for_segment=1),
        "n3": dict(num_mappings_for_segment=3),
        "batch8": dict(skip_prefix=True, prefix_delim="#",
                       batch_fragments=8),
        "onetoone": dict(filter_mode=FILTER_ONETOONE, skip_prefix=True,
                         prefix_delim="#"),
        "nosplit": dict(split=False),
    }[mode]
    if mode == "nosplit":
        # long queries without splitting take the windowed host route
        base = recs[0][1]
        queries = [("q_long", mutate(base[2_000:4_300], 0.03, seed=3)),
                   ("q_short", base[9_000:9_400])]
        a, b = _both(tmp_path, recs[:2], queries, **kw)
    else:
        a, b = _both(tmp_path, recs, **kw)
    assert a, "no mappings produced"
    assert a == b


def test_query_vs_reference_paf_identical(tmp_path):
    base = random_genome(30_000, seed=1)
    queries = [("q1", mutate(base, 0.05, seed=2)),
               ("rc", revcomp(base[3_000:11_000])),
               ("short", base[1_000:1_300]),
               ("tiny", "ACGT")]
    a, b = _both(tmp_path, [("ref1", base)], queries)
    assert a.count("\n") >= 3
    assert a == b


def _repeat_workload():
    """The repeat workload of __graft_entry__.dryrun_multichip: tandem
    arrays escalate L2 slices through the buckets and past them (host L2
    route); a low postings cap sends fragments to the host L1 route."""
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    def rand(n):
        return rng.choice(bases, size=n).tobytes().decode()

    def mut(s, d):
        a = np.frombuffer(s.encode(), np.uint8).copy()
        pos = rng.choice(len(a), size=int(len(a) * d), replace=False)
        a[pos] = bases[(np.searchsorted(bases, a[pos])
                        + rng.integers(1, 4, len(pos))) % 4]
        return a.tobytes().decode()

    u1, u2, u3 = rand(250), rand(250), rand(250)
    genome = (rand(30_000) + u1 * 40 + rand(20_000) + u2 * 200
              + rand(20_000) + u3 * 1200 + rand(30_000))
    off_u1 = 30_000
    off_u2 = 30_000 + 10_000 + 20_000
    off_u3 = off_u2 + 50_000 + 20_000
    queries = [
        ("q_unique", mut(genome[5_000:11_000], 0.02)),
        ("q_rep1", mut(genome[off_u1:off_u1 + 2_000], 0.02)),
        ("q_rep2", mut(genome[off_u2:off_u2 + 2_000], 0.02)),
        ("q_rep3", mut(genome[off_u3:off_u3 + 2_000], 0.02)),
        ("q_mix", mut(genome[28_000:34_000], 0.02)),
    ]
    return [("chr1", genome)], queries


def test_host_routes_paf_identical(tmp_path):
    contigs, queries = _repeat_workload()
    q_fa = str(tmp_path / "q.fa")
    write_fasta(q_fa, queries)
    k, w, s = 11, 500, 24
    kw = dict(ref_sequences=[q_fa], query_sequences=[q_fa],
              out_file_name="-", kmer_size=k, seg_length=w,
              sketch_size=s, percentage_identity=0.85,
              num_mappings_for_segment=3, no_progress=True)

    jidx = jax_build_index(contigs, kmer_size=k, window_size=w,
                           sketch_size=s)
    jm = JaxMapper(JaxParameters(**kw).finalize(), jidx)
    want = io.StringIO()
    jm.run([q_fa], want, progress=False)
    want = want.getvalue()
    assert want.count("\n") > 5

    idx = build_index(contigs, k, w, s, device="cpu")
    got = {}
    for p_cap in (8192, 16):
        m = Mapper(Parameters(l1_postings_cap=p_cap, **kw).finalize(), idx,
                   device="cpu")
        out = io.StringIO()
        m.run([q_fa], out)
        got[p_cap] = (out.getvalue(), m.path_stats)
    paf, st = got[8192]
    paf_low, st_low = got[16]
    assert paf == want
    assert paf_low == want
    assert st["host_l2"] > 0, st
    assert len(st["l2_buckets"]) >= 2, st
    assert st_low["host_frags"] > 0, st_low


def test_l2_buckets_dispatch_largest_slice_first(tmp_path, monkeypatch):
    """Each batch calls l2_step for its buckets largest T first, so that
    a device's first L2 capture is its largest, whichever buckets the
    job's first batch holds."""
    from mashmap_tpu_torch.kernels import graphs
    contigs, queries = _repeat_workload()
    q_fa = str(tmp_path / "q.fa")
    write_fasta(q_fa, queries)
    calls = []
    call = graphs.call

    def record(device, step, args, *static):
        calls.append(static[0] if step.__name__ == "l2_step" else None)
        return call(device, step, args, *static)
    monkeypatch.setattr(graphs, "call", record)
    idx = build_index(contigs, 11, 500, 24, device="cpu")
    m = Mapper(Parameters(ref_sequences=[q_fa], query_sequences=[q_fa],
                          out_file_name="-", kmer_size=11, seg_length=500,
                          sketch_size=24, percentage_identity=0.85,
                          num_mappings_for_segment=3,
                          no_progress=True).finalize(), idx, device="cpu")
    m.run([q_fa], io.StringIO())
    assert len(m.path_stats["l2_buckets"]) >= 2, m.path_stats
    batches = "".join("|" if t is None else f"{t}," for t in calls)
    runs = [[int(t) for t in b.split(",") if t] for b in batches.split("|")]
    assert any(len(set(r)) >= 2 for r in runs), runs
    assert all(r == sorted(r, reverse=True) for r in runs), runs


def test_sketch_size_above_512_paf_identical(tmp_path):
    """A self-map at s = 520, above theta.cu's S_MAX (a 6 Mbp reference
    at --pi 78 gets s = 680), with the cutoff table off on both sides
    (it costs minutes at such s) and a postings cap that keeps every
    fragment on the device route."""
    recs = pangenome(3, 6_000, divergence=0.05, seed=7)
    a, b = _both(tmp_path, recs, kmer_size=15, seg_length=800,
                 sketch_size=520, percentage_identity=0.85,
                 skip_prefix=True, prefix_delim="#",
                 num_mappings_for_segment=1, stage1_topANI_filter=False,
                 l2_batch=64, l2_entries_cap=256, l1_postings_cap=8192)
    assert a.count("\n") >= 3
    assert a == b


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_l2_widths_cut_only_above_the_budget(n_dev):
    """At the default area and s <= 1024 the L2 call widths are those
    without a byte budget; at s = 3780 one (W, s, 2T) int32 intermediate
    stays under it."""
    from mashmap_tpu_torch.map import engine
    area = Parameters().l2_batch * Parameters().l2_entries_cap // 2
    for T in engine.T_BUCKETS:
        old = engine._round_up(max(8, area // T), n_dev)
        want = (old, engine._round_up(max(8, old // 4), n_dev))
        for s in (130, 256, 680, 1024):
            assert engine._l2_widths(area, T, s, n_dev) == want
        w_step, w_small = engine._l2_widths(area, T, 3780, n_dev)
        assert w_small <= w_step < old and w_step % n_dev == 0
        assert w_step * 2 * T * 3780 * 4 <= engine.L2_BYTES


def test_small_l2_budget_keeps_paf_and_path_stats(tmp_path, monkeypatch):
    """Calls cut to a few items by a small L2 byte budget give the same
    PAF and path_stats as the default widths."""
    from mashmap_tpu_torch.kernels import mapdev
    from mashmap_tpu_torch.map import engine
    from mashmap_tpu_torch.io import for_each_seq_in_file
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, pangenome(4, 20_000, divergence=0.05, seed=7))
    kw = dict(ref_sequences=[ref], out_file_name="-", skip_prefix=True,
              prefix_delim="#", **SMALL)
    idx = build_index(list(for_each_seq_in_file(ref)), kw["kmer_size"],
                      kw["seg_length"], kw["sketch_size"], device="cpu")
    widths = []
    l2_step = mapdev.l2_step

    def counted(w_lo, *a):
        widths.append(w_lo.shape[0])
        return l2_step(w_lo, *a)
    monkeypatch.setattr(mapdev, "l2_step", counted)
    runs = []
    for budget in (engine.L2_BYTES, 3 * 2 * 512 * 30 * 4):
        monkeypatch.setattr(engine, "L2_BYTES", budget)
        widths.clear()
        m = Mapper(Parameters(**kw).finalize(), idx, device="cpu")
        out = io.StringIO()
        m.run([ref], out)
        runs.append((out.getvalue(), m.path_stats, list(widths)))
    (paf, st, w_default), (paf_cut, st_cut, w_cut) = runs
    assert paf.count("\n") > 3
    assert paf_cut == paf and st_cut == st
    assert max(w_cut) <= 3 < max(w_default) and len(w_cut) > len(w_default)
