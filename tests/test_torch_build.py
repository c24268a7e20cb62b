"""Port index build (index/builder.py) vs the JAX build: every
ReferenceIndex array must be equal."""

import os
import sys

import numpy as np
import pytest

from mashmap_tpu.index import builder as jb
from mashmap_tpu_torch.index import builder as tb
from mashmap_tpu_torch.kernels import events as te

sys.path.insert(0, os.path.dirname(__file__))
from genomes import pangenome, random_genome  # noqa: E402
from port_fixtures import one_torch_thread  # noqa: E402,F401

FIELDS = ("lengths", "uniq_hashes", "post_offsets", "post_seqid",
          "post_wpos", "post_wend", "mi_rank", "mi_seqid", "mi_wpos",
          "mi_wend", "mi_strand", "is_frequent")
K, W, S = 11, 500, 24


def assert_same_index(a, b):
    assert a.names == b.names
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.freq_threshold == b.freq_threshold
    assert (a.kmer_size, a.window_size, a.sketch_size) == \
        (b.kmer_size, b.window_size, b.sketch_size)


def _port(contigs, **kw):
    return tb.build_index(contigs, K, W, S, device="cpu", **kw)


def test_one_contig():
    contigs = [("c0", random_genome(30_000, seed=1))]
    a = jb.build_index(contigs, K, W, S)
    b = _port(contigs)
    assert_same_index(a, b)
    assert len(b.mi_rank) > 0


def test_several_contigs_with_short_and_n_runs():
    contigs = pangenome(3, 40_000, 0.05, seed=5)
    # a contig shorter than the window (metadata only) and one with N runs
    contigs.append(("short", random_genome(300, seed=2)))
    seq = random_genome(20_000, seed=3)
    contigs.append(("withN", seq[:5_000] + "N" * 700 + seq[5_700:]))
    assert_same_index(jb.build_index(contigs, K, W, S), _port(contigs))


def test_tandem_repeat_frequent_seed_drop():
    unit = random_genome(300, seed=8)
    contigs = [("rep", random_genome(10_000, seed=9) + unit * 120
                + random_genome(10_000, seed=10)),
               ("plain", random_genome(20_000, seed=11))]
    # ignore the top 1% most frequent minmers (the default 0.001% keeps
    # every seed of an index this small)
    a = jb.build_index(contigs, K, W, S, kmer_pct_threshold=1.0)
    b = _port(contigs, kmer_pct_threshold=1.0)
    assert b.is_frequent.any(), "the repeat must trigger the drop"
    assert len(b.mi_rank) < len(_port(contigs).mi_rank)
    assert_same_index(a, b)


def test_streaming_events_path(monkeypatch):
    """Contigs longer than _EVENTS_CH_MAX run the chunk + halo events
    path in both packages, including a tandem repeat across chunk
    boundaries."""
    contigs = pangenome(2, 50_000, 0.05, seed=17)
    unit = random_genome(1_332, seed=18)
    contigs.append(("rep", random_genome(10_000, seed=19) + unit * 15
                    + random_genome(10_000, seed=20)))
    monkeypatch.setattr(jb, "_EVENTS_CH_MAX", 16_384)
    monkeypatch.setattr(tb, "_EVENTS_CH_MAX", 12_000)
    a = jb.build_index(contigs, K, W, S)
    b = _port(contigs)
    assert_same_index(a, b)


def test_grouping_under_rank_limit():
    contigs = pangenome(3, 30_000, 0.05, seed=21)
    a = jb.build_index(contigs, K, W, S)
    # each group holds one contig: its own rank domain and theta launch
    b = _port(contigs, rank_limit=35_000)
    assert_same_index(a, b)
    # every contig over the limit: each takes the host route
    assert_same_index(a, _port(contigs, rank_limit=20_000))


def test_event_cap_overflow_reruns_with_doubled_caps(monkeypatch):
    contigs = pangenome(2, 30_000, 0.05, seed=23)
    calls = []

    def tiny_caps(np_, s, s_b):
        calls.append(np_)
        return 64, 64
    monkeypatch.setattr(te, "events_caps", tiny_caps)
    assert_same_index(jb.build_index(contigs, K, W, S), _port(contigs))
    assert calls


def test_npz_written_by_jax_loads_in_port(tmp_path):
    contigs = pangenome(2, 25_000, 0.05, seed=29)
    a = jb.build_index(contigs, K, W, S)
    path = str(tmp_path / "jax_index")
    a.save(path)
    b = tb.ReferenceIndex.load(path + ".npz")
    assert_same_index(a, b)
    import dataclasses
    assert_same_index(a, tb.ReferenceIndex.from_numpy(
        dataclasses.asdict(a)))
    # and the port's save is readable by the JAX package
    b.save(str(tmp_path / "port_index"))
    assert_same_index(a, jb.ReferenceIndex.load(
        str(tmp_path / "port_index.npz")))


def test_sketch_size_above_512():
    """build_index at k=19, w=5000, s=600, above theta.cu's S_MAX (a
    6 Mbp reference at --pi 78 gets s = 680): the plain version runs on
    the CPU at any s."""
    contigs = pangenome(2, 24_000, 0.05, seed=31)
    a = jb.build_index(contigs, 19, 5000, 600)
    b = tb.build_index(contigs, 19, 5000, 600, device="cpu")
    assert_same_index(a, b)
    assert len(b.mi_rank) > 0
