"""Port index build (index/builder.py) vs the JAX build: every
ReferenceIndex array must be equal."""

import os
import sys

import numpy as np
import pytest

from mashmap_tpu.index import builder as jb
from mashmap_tpu_torch.hostcopy import HostCopy
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


def _group_events(rng, ns, span, n_ranks, *, breaks=6, p_flush=0.3,
                  p_mixed=0.5, extra=6, p_tie=0.0, empty=()):
    """Membership events of one group in events_chunk's lanes, a tuple
    (beg_h, beg_W, end_h, end_W, mem_rankstrand, mem_pos) a contig: per
    hash alternating begins and ends at sorted distinct windows (the
    last begin unmatched with ``p_flush``; with ``p_tie`` the windows of
    the hash before, so equal (wb, we) across hashes), an occurrence in
    the window of every begin (as the events kernel's are), ``extra``
    more at random, strands mixed with ``p_mixed`` (sign changes), and
    a few hashes with occurrences alone. Contigs in ``empty`` have
    none."""
    out = []
    for c, n in enumerate(ns):
        n_w = n - span + 1
        lanes = [[] for _ in range(6)]
        if c not in empty:
            hashes = rng.choice(n_ranks, size=int(rng.integers(
                2, max(3, n_w // 6))), replace=False)
            bp = None
            for k, h in enumerate(hashes):
                members_only = k % 5 == 4
                if bp is None or rng.random() >= p_tie:
                    bp = np.sort(rng.choice(n_w, size=min(n_w, int(
                        rng.integers(1, breaks + 1))), replace=False))
                b = bp if len(bp) % 2 or rng.random() >= p_flush \
                    else bp[:-1]
                pos = rng.integers(0, n, extra)
                if not members_only:
                    lanes[0].append(np.full(len(b[0::2]), h))
                    lanes[1].append(b[0::2])
                    lanes[2].append(np.full(len(b[1::2]), h))
                    lanes[3].append(b[1::2])
                    pos = np.concatenate(
                        (pos, b[0::2] + rng.integers(0, span, len(b[0::2]))))
                pos = np.unique(pos)
                up = (rng.integers(0, 2, len(pos)) if rng.random() < p_mixed
                      else np.full(len(pos), rng.integers(0, 2)))
                lanes[4].append((h << 1) | up)
                lanes[5].append(pos)
        out.append(tuple(np.concatenate(x).astype(np.int32) if x
                         else np.empty(0, np.int32) for x in lanes))
    return out


def _numpy_chain(events, ns, span, window_size, lut):
    """The JAX package's host chain over a group's events: pairing,
    strand classification, chunking, the stable (wb, we) row sort (a
    closure of its _build_group, so written out here) and resolution."""
    results = []
    for seq_id, ((bh, bW, eh, eW, mrk, mpos), n) in enumerate(
            zip(events, ns)):
        iv_rank, iv_wb, iv_we, _ = jb._pair_begin_end(
            bh, bW.astype(np.int64), eh, eW.astype(np.int64), n)
        mh, mb, me, ms = jb.strand_classify(
            iv_rank, iv_wb, iv_we, mpos.astype(np.int64), mrk >> 1,
            ((mrk & 1) * 2 - 1).astype(np.int64), n - span + 1, span, n,
            np.int32)
        mh, mb, me, ms = jb._chunk_long_intervals(mh, mb, me, ms,
                                                  window_size)
        o = np.lexsort((me, mb))
        results.append((seq_id, (iv_rank, iv_wb, iv_we),
                        (mh[o], mb[o], me[o], ms[o])))
    return jb._resolve_group_hashes(results, None, lut)


EVENT_SETS = {
    # name: (contig positions, span, window size, generator arguments)
    "random": ([400], 16, 60, {}),
    "flushed_begins": ([300, 250], 16, 60, {"p_flush": 1.0}),
    "many_sign_changes": ([300], 24, 60, {"extra": 40, "p_mixed": 1.0}),
    "equal_wb_we_across_hashes": ([260, 300], 16, 60, {"p_tie": 0.8}),
    "longer_than_window": ([500], 16, 12, {"breaks": 3}),
    "empty_contig": ([200, 180, 220], 16, 60, {"empty": (1,)}),
    "several_contigs": ([150, 310, 90, 270, 40, 200], 16, 30,
                        {"extra": 12}),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(EVENT_SETS))
def test_device_classify_equals_numpy_chain(name, seed):
    """classify_group on CPU tensors gives the JAX package's NumPy
    chain's arrays, row order included, for every contig of the group;
    a contig's events split over two events calls change nothing."""
    import torch
    ns, span, window_size, kw = EVENT_SETS[name]
    rng = np.random.default_rng([seed, sorted(EVENT_SETS).index(name)])
    n_ranks = sum(ns)
    lut = np.unique(rng.integers(0, 2**64, 2 * n_ranks, dtype=np.uint64,
                                 endpoint=False))[:n_ranks]
    events = _group_events(rng, ns, span, n_ranks, **kw)
    want, want_vals = _numpy_chain(events, ns, span, window_size, lut)
    chunks = []
    for i, lanes in enumerate(events):
        cut = [int(rng.integers(0, len(x) + 1)) for x in lanes[::2]]
        halves = [tuple(torch.from_numpy(x[:cut[j // 2]])
                        for j, x in enumerate(lanes)),
                  tuple(torch.from_numpy(x[cut[j // 2]:])
                        for j, x in enumerate(lanes))]
        chunks += [(i, h) for h in halves]
    arrays = tb.classify_group(tb.gather_lanes(chunks, "cpu"), ns, span,
                               window_size,
                               torch.from_numpy(lut.view(np.int64)))
    got, got_vals = tb.split_group(HostCopy(arrays).wait(),
                                   list(range(len(ns))))
    assert got_vals.dtype == np.uint64
    np.testing.assert_array_equal(got_vals, want_vals)
    assert [r[0] for r in got] == [r[0] for r in want]
    rows = 0
    for (_, gp, gm), (_, wp, wm) in zip(got, want):
        for g, w, what in zip(gp + gm, wp + wm, ("postings u64",
                              "postings wb", "postings we", "row slot",
                              "row wb", "row we", "row strand")):
            np.testing.assert_array_equal(g, w, err_msg=what)
        rows += len(wm[0])
    assert rows > 0


def test_inconsistent_events_raise(monkeypatch):
    """An end event with no begin of its hash before it (the first begin
    of every events call dropped) fails the device classify's checks:
    build_index raises, as the NumPy chain's asserts did."""
    real = te.live_lanes

    def drop_first_begin(buf, head, beg_cap, mem_cap):
        bh, bW, *rest = real(buf, head, beg_cap, mem_cap)
        return (bh[1:], bW[1:], *rest)
    monkeypatch.setattr(te, "live_lanes", drop_first_begin)
    with pytest.raises(AssertionError, match="begin/end events|unknown"):
        _port(pangenome(2, 20_000, 0.05, seed=37))
