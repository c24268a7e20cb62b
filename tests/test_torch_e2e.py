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
