"""The port on a CUDA card: the hand-written theta and banded DP trace
kernels against their plain versions, and the card's index build (the
over-limit host route included), its pipelined map, its sharded and
data-parallel maps (the card listed twice) and its alignments against the
CPU's.

These tests need a card and skip without one. The card's machine has no
JAX, so run them there without the JAX-importing conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from mashmap_tpu_torch.align import kernel as dp
from mashmap_tpu_torch.align.driver import PIECE_BUCKETS
from mashmap_tpu_torch.index import builder
from mashmap_tpu_torch.kernels import theta as tt

sys.path.insert(0, os.path.dirname(__file__))
from genomes import mutate, pangenome, random_genome, write_fasta  # noqa
from test_torch_dp_pieces import (dp_edge_pieces, dp_pieces,  # noqa
                                  free_ends)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("C,s_b,s,invalid_frac,alphabet", [
    (64, 4982, 130, 0.02, None), (64, 513, 30, 0.0, None),
    (32, 4982, 398, 0.5, None),
    (7, 100, 200, 0.0, None),      # s above the distinct count: all RSENT
    (64, 4982, 130, 0.02, 4),      # 4-letter alphabet: duplicate runs
    (64, 4982, 130, 0.02, 300),    # alphabet near 2s: the sets share ranks
    (64, 100, 30, 0.1, None),      # S_B below the segment length (128)
    (64, 1000, 130, 0.02, None),   # S_B not a multiple of it
    (64, 4982, 1, 0.02, None),     # s = 1
    (32, 4982, 512, 0.02, None),   # s = S_MAX
    (1208, 4982, 310, 0.02, None),  # s of a human-scale reference
    (64, 300, 40, 0.85, 5000),     # sparse windows: theta in and out of RSENT
])
def test_kernel_matches_plain_version(cuda, C, s_b, s, invalid_frac,
                                      alphabet):
    rng = np.random.default_rng(C + s)
    hi = alphabet or 4 * s_b
    cur = rng.integers(0, hi, (C, s_b)).astype(np.int32)
    nxt = rng.integers(0, hi, (C, s_b)).astype(np.int32)
    cur[rng.random((C, s_b)) < invalid_frac] = tt.RSENT
    nxt[rng.random((C, s_b)) < invalid_frac] = tt.RSENT
    c = torch.from_numpy(cur).to(cuda)
    n = torch.from_numpy(nxt).to(cuda)
    before = tt.LAUNCHES
    got = tt.theta_chunk(c, n, s, s_b)
    torch.cuda.synchronize()
    assert tt.LAUNCHES == before + 1
    assert torch.equal(got, tt.theta_chunk_ref(c, n, s, s_b))


@pytest.mark.parametrize("C,s_b,s,invalid_frac,alphabet", [
    (64, 4982, 513, 0.02, None),     # the first s of theta_wide.cu
    (64, 4982, 680, 0.02, None),     # a 6 Mbp reference at --pi 78
    (32, 4982, 1110, 0.5, None),     # a 3.1 Gbp reference at --pi 80
    (16, 4982, 3780, 0.02, None),    # ... and at --pi 75
    (16, 4982, 680, 0.02, 1400),     # alphabet near 2s: the sets share ranks
    (64, 1000, 600, 0.02, None),     # S_B not a multiple of the segment
    (8, 400, 600, 0.0, None),        # S_B < s: every theta RSENT
    (2, 17000, 16400, 0.0, 1 << 30),  # the sets in the device scratch
    (64, 4982, 680, 0.02, 4),        # 4 letters: the scan's dedupe
    (64, 4096, 680, 0.0, None),      # S_B a multiple of the segment
    (16, 700, 600, 0.0, 1 << 30),    # the union just above s: short bases
    (16, 4982, 3780, 0.02, 9000),    # alphabet near 2s: ranks in the base
])
def test_wide_kernel_matches_plain_version(cuda, C, s_b, s, invalid_frac,
                                           alphabet):
    """Above S_MAX the wrapper launches theta_wide.cu (and not theta.cu),
    which equals the plain version exactly, on both of its set routes."""
    rng = np.random.default_rng(C + s)
    hi = alphabet or 4 * s_b
    cur = rng.integers(0, hi, (C, s_b)).astype(np.int32)
    nxt = rng.integers(0, hi, (C, s_b)).astype(np.int32)
    cur[rng.random((C, s_b)) < invalid_frac] = tt.RSENT
    nxt[rng.random((C, s_b)) < invalid_frac] = tt.RSENT
    c = torch.from_numpy(cur).to(cuda)
    n = torch.from_numpy(nxt).to(cuda)
    before = (tt.LAUNCHES, tt.WIDE_LAUNCHES)
    got = tt.theta_chunk(c, n, s, s_b)
    torch.cuda.synchronize()
    assert (tt.LAUNCHES, tt.WIDE_LAUNCHES) == (before[0], before[1] + 1)
    want = tt.theta_chunk_ref(c, n, s, s_b)
    assert torch.equal(got, want)
    assert (want != tt.RSENT).any() == (s_b >= s and hi >= s)
    assert tt.wide_sets_in_scratch(s) == (s > tt.WIDE_SMEM_S_MAX)


@pytest.mark.parametrize("s", [30, 130, 310, 680, 3780])
def test_kernel_on_contig_end_rows(cuda, s):
    """A contig's last block row has no next block (nxt all RSENT): its
    last windows hold fewer than s ranks and theta steps in and out of
    RSENT."""
    rng = np.random.default_rng(s)
    cur = rng.integers(0, 20000, (64, 4982)).astype(np.int32)
    cur[rng.random(cur.shape) < 0.05] = tt.RSENT
    c = torch.from_numpy(cur).to(cuda)
    n = torch.full_like(c, tt.RSENT)
    got = tt.theta_chunk(c, n, s, 4982)
    want = tt.theta_chunk_ref(c, n, s, 4982)
    assert (want == tt.RSENT).any()
    assert torch.equal(got, want)


def test_card_index_equals_cpu_index(cuda):
    contigs = pangenome(3, 40_000, 0.05, seed=5)
    before = tt.LAUNCHES
    a = builder.build_index(contigs, 11, 500, 24, device=cuda)
    assert tt.LAUNCHES > before
    b = builder.build_index(contigs, 11, 500, 24, device="cpu")
    for f in builder._NPZ_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.freq_threshold == b.freq_threshold


def test_card_index_equals_cpu_index_above_s_max(cuda):
    contigs = pangenome(2, 60_000, 0.05, seed=6)
    before = tt.WIDE_LAUNCHES
    a = builder.build_index(contigs, 19, 5000, 680, device=cuda)
    assert tt.WIDE_LAUNCHES > before
    b = builder.build_index(contigs, 19, 5000, 680, device="cpu")
    for f in builder._NPZ_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.freq_threshold == b.freq_threshold


@pytest.mark.parametrize("P,W", PIECE_BUCKETS)
@pytest.mark.parametrize("kind", ["random", "edges"])
def test_dp_kernel_matches_plain_version(cuda, P, W, kind):
    """The fused DP, end state and traceback kernel writes the plain
    version's records byte for byte (every per-piece result and every op
    byte) at each of the aligner's buckets."""
    arrays = (dp_pieces(P, W, 64, P + W) if kind == "random"
              else dp_edge_pieces(P, W))
    t = dp.dp_inputs(*arrays, free_ends(len(arrays[2])), cuda)
    before = dp.LAUNCHES
    got = dp.banded_dp_trace(*t, p_len=P, width=W)
    torch.cuda.synchronize()
    assert dp.LAUNCHES == before + 1
    assert got.dtype == torch.uint8 and got.device.type == "cuda"
    want = dp.banded_dp_trace_torch(*t, p_len=P, width=W)
    assert torch.equal(got, want)
    res, _ = dp.unpack_trace(got.cpu().numpy(), P, W)
    assert res[:, dp.RES_OK].any()


def test_aligner_without_kernel_raises(cuda, tmp_path, monkeypatch):
    """On a card the aligner has no host route for the DP: when the
    kernel cannot be built it raises."""
    from mashmap_tpu_torch.align.driver import align_files
    from mashmap_tpu_torch.kernels import nvcc

    def no_nvcc(src, stem):
        raise RuntimeError("nvcc failed")

    ref, qf = str(tmp_path / "ref.fa"), str(tmp_path / "q.fa")
    base = random_genome(3000, seed=8)
    write_fasta(ref, [("c", base)])
    write_fasta(qf, [("z", mutate(base, 0.05, seed=9))])
    mp = str(tmp_path / "map.out")
    with open(mp, "w") as fh:
        fh.write("z 3000 0 2999 + c 3000 0 2999 95.0\n")
    monkeypatch.setattr(dp, "_LIB", None)
    monkeypatch.setattr(nvcc, "build", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        align_files([ref], [qf], mp, 80.0, str(tmp_path / "out.aln"),
                    device=cuda)


def test_aligner_card_equals_cpu(cuda, tmp_path):
    from mashmap_tpu_torch.align.driver import align_files
    from mashmap_tpu_torch.cli import main as map_main
    base = random_genome(30000, seed=5)
    ref, qf = str(tmp_path / "ref.fa"), str(tmp_path / "q.fa")
    write_fasta(ref, [("chr1", base)])
    write_fasta(qf, [("q1", mutate(base, 0.05, seed=6))])
    mp = str(tmp_path / "map.out")
    assert map_main(["-r", ref, "-q", qf, "-o", mp, "-k", "15", "-s",
                     "1000", "-J", "60", "--pi", "80", "--legacy",
                     "--noProgress"], device=cuda) == 0
    before = dp.LAUNCHES
    outs = []
    for dev in (cuda, "cpu"):
        out = str(tmp_path / f"{dev}.aln")
        align_files([ref], [qf], mp, 80.0, out, device=dev)
        outs.append(open(out).read())
    assert dp.LAUNCHES > before
    assert outs[0] and outs[0] == outs[1]


def _small_map(tmp_path, devices, shard):
    """A small pangenome's self-map through map_files on `devices`;
    returns the PAF and the Mapper's theta launches."""
    from mashmap_tpu_torch.api import map_files
    from mashmap_tpu_torch.params import Parameters
    ref = str(tmp_path / "ref.fa")
    if not os.path.exists(ref):
        write_fasta(ref, pangenome(3, 60_000, 0.05, seed=13))
    tag = "-".join(str(d) for d in devices) + f"-{shard}"
    out = str(tmp_path / f"{tag}.paf")
    p = Parameters(ref_sequences=[ref], out_file_name=out, kmer_size=15,
                   seg_length=2000, sketch_size=60, percentage_identity=0.85,
                   skip_prefix=True, prefix_delim="#", batch_fragments=64,
                   no_progress=True, shard_index=shard)
    map_files(p, devices=devices)
    return open(out).read()


def test_pipelined_map_on_card_equals_cpu(cuda, tmp_path):
    """The pipelined map at 4 fragments a batch (queries spanning
    batches, copies in flight behind the next batch's work) writes the
    CPU's PAF on the card."""
    from mashmap_tpu_torch.api import map_files
    from mashmap_tpu_torch.params import Parameters
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, pangenome(3, 60_000, 0.05, seed=17))
    outs = []
    for dev in (cuda, "cpu"):
        out = str(tmp_path / f"{dev}.paf")
        map_files(Parameters(ref_sequences=[ref], out_file_name=out,
                             kmer_size=15, seg_length=2000, sketch_size=60,
                             percentage_identity=0.85, skip_prefix=True,
                             prefix_delim="#", batch_fragments=4,
                             no_progress=True), device=dev)
        outs.append(open(out).read())
    assert outs[0].count("\n") > 3 and outs[0] == outs[1]


@pytest.mark.parametrize("shard", [True, False])
def test_two_entries_on_one_card_equal_cpu(cuda, tmp_path, shard):
    """The sharded index and the replicated data-parallel path with the
    card listed twice write the CPU's single-device PAF."""
    want = _small_map(tmp_path, ["cpu"], False)
    got = _small_map(tmp_path, [cuda, cuda], shard)
    assert want.count("\n") > 3 and got == want


def test_over_limit_host_route_on_card_equals_cpu(cuda):
    """A contig over the rank limit: its host route on the card (theta
    kernel launched) equals the CPU's host route and the card's device
    route."""
    contigs = [("big", random_genome(400_000, seed=41)),
               ("small", random_genome(30_000, seed=42))]
    before = tt.LAUNCHES
    a = builder.build_index(contigs, 15, 2000, 60, rank_limit=100_000,
                            device=cuda)
    assert tt.LAUNCHES > before
    b = builder.build_index(contigs, 15, 2000, 60, rank_limit=100_000,
                            device="cpu")
    c = builder.build_index(contigs, 15, 2000, 60, device=cuda)
    for f in builder._NPZ_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(a, f), getattr(c, f),
                                      err_msg=f)
    assert a.freq_threshold == b.freq_threshold == c.freq_threshold


@pytest.fixture
def fresh_graphs():
    """An empty graph cache and zero counts (kernels/graphs.py)."""
    from mashmap_tpu_torch.kernels import graphs
    graphs.clear()
    graphs.reset_counts()
    yield graphs
    graphs.clear()
    graphs.reset_counts()


class _Owner:
    """Stands for a Mapper as the owner of a table set."""


@pytest.fixture(scope="module")
def step_inputs():
    """The replicated path's host tables for a small pangenome's index
    (built on the CPU), the L1 config, and three batches of fragments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs capture on the card only")
    from mashmap_tpu_torch.map.engine import Mapper
    from mashmap_tpu_torch.params import Parameters
    recs = pangenome(3, 30_000, 0.05, seed=31)
    idx = builder.build_index(recs, 11, 500, 24, device="cpu")
    p = Parameters(ref_sequences=["-"], out_file_name="-", kmer_size=11,
                   seg_length=500, sketch_size=24, percentage_identity=0.85,
                   no_progress=True)
    m = Mapper(p, idx, device="cpu")
    host = m._make_host_tables()
    batches = []
    for b in range(3):
        g = recs[b][1]
        rows = [mutate(g[i:i + 500], 0.02, seed=i + b)
                for i in range(b * 700, 24_000, 1_500)][:16]
        mat = np.full((len(rows), 500), ord("N"), np.uint8)
        for r, seq in enumerate(rows):
            mat[r, :min(500, len(seq))] = np.frombuffer(
                seq.encode(), np.uint8)[:500]
        batches.append(mat)
    allowed = np.ones((16, idx.n_contigs), bool)
    return host, m._l1cfg(), batches, allowed


def _l1_args(t, frags, allowed):
    return (frags, t["uniq_flip"], t["post_offsets"], t["post_seqid"],
            t["post_wpos"], t["post_wend"], t["is_frequent"],
            t["min_hits_table"], t["cutoff_table"], allowed, t["ref_group"],
            t["mi_key"])


def _on(args, dev):
    return tuple(torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                 else a for a in args)


def test_l1_step_replay_equals_eager(cuda, fresh_graphs, step_inputs):
    """The first call captures and replays; two replays in a row on other
    fragments, neither read before the other ran, each equal the eager
    step on their own inputs, as does the first."""
    from mashmap_tpu_torch.kernels.mapdev import l1_step
    graphs = fresh_graphs
    host, cfg, batches, allowed = step_inputs
    owner = _Owner()
    t = graphs.tables(cuda, owner, host)
    got = [graphs.call(cuda, l1_step, _l1_args(t, f, allowed), cfg)
           for f in batches]
    assert graphs.CAPTURES == {"l1_step": 1}
    assert graphs.REPLAYS == {"l1_step": 3}
    for f, g in zip(batches, got):
        want = l1_step(*_on(_l1_args(t, f, allowed), cuda), cfg=cfg)
        for a, b in zip(g, want):
            assert torch.equal(a, b)
    assert int(got[1][0][:, 1].sum()) > 0         # candidates found


@pytest.mark.parametrize("T", [512, 1024])
@pytest.mark.parametrize("width", ["step", "small"])
def test_l2_step_replay_equals_eager(cuda, fresh_graphs, step_inputs, T,
                                     width):
    """l2_step at two T buckets and both of the map's call widths: the
    capture call (captured, then replayed), then two replays on other
    work items before either is read, each equal to the eager step."""
    from mashmap_tpu_torch.kernels.mapdev import (l1_step, l2_step,
                                                  unpack_l1_meta)
    from mashmap_tpu_torch.map.engine import _l2_widths
    graphs = fresh_graphs
    host, cfg, batches, allowed = step_inputs
    owner = _Owner()
    t = graphs.tables(cuda, owner, host)
    meta, q_code, q_strand = l1_step(
        *_on(_l1_args(t, batches[0], allowed), cuda), cfg=cfg)
    o = unpack_l1_meta(meta.cpu().numpy(), cfg.c_cap)
    items = [(i, j) for i in range(len(batches[0]))
             for j in range(int(o["n_cand"][i]))
             if o["cand_hi"][i, j] - o["cand_lo"][i, j] <= T]
    assert len(items) >= 4
    area = 512 * 2048 // 2
    W = _l2_widths(area, T, cfg.s)[0 if width == "step" else 1]
    calls = []
    for shift in range(3):
        it = (items[shift:] + items[:shift]) * (W // len(items) + 1)
        ii = np.array([i for i, _ in it[:W]])
        jj = np.array([j for _, j in it[:W]])
        w = [o[f][ii, jj].astype(np.int32)
             for f in ("cand_lo", "cand_mid", "cand_hi", "cand_seq")]
        fi = torch.from_numpy(ii).to(cuda)
        calls.append((*w, q_code[fi], q_strand[fi],
                      o["s_q"][ii].astype(np.int32), t["mi_rank"],
                      t["mi_wpos"], t["mi_wend"], t["mi_strand"],
                      t["mi_seqid"]))
    got = [graphs.call(cuda, l2_step, a, T, cfg.s) for a in calls]
    assert graphs.CAPTURES == {"l2_step": 1}
    assert graphs.REPLAYS == {"l2_step": 3}
    for a, g in zip(calls, got):
        assert torch.equal(g, l2_step(*_on(a, cuda), t_cap=T, s=cfg.s))
    assert int(got[2][:, 0].max()) > 0             # runs found


def _card_map(tmp_path, ref, tag, devices):
    """ref's self-map on `devices` through a Mapper over an index built
    on the card; returns the PAF."""
    from mashmap_tpu_torch.api import build_or_load_index
    from mashmap_tpu_torch.map.engine import Mapper
    from mashmap_tpu_torch.params import Parameters
    out = str(tmp_path / f"{tag}.paf")
    p = Parameters(ref_sequences=[ref], out_file_name=out, kmer_size=15,
                   seg_length=2000, sketch_size=60, percentage_identity=0.85,
                   skip_prefix=True, prefix_delim="#", batch_fragments=64,
                   no_progress=True).finalize()
    idx = build_or_load_index(p, devices[0])
    with open(out, "w") as fh:
        Mapper(p, idx, devices=devices).run(p.query_sequences, fh)
    with open(out) as fh:
        return fh.read()


def test_second_mapper_captures_nothing_other_index_drops(cuda, tmp_path,
                                                         fresh_graphs):
    """A second Mapper over the same index (built again) captures nothing
    and replays into the same table tensors; a Mapper over an index of
    other shapes drops the device's graphs and table set and captures
    anew; each PAF equals the CPU's."""
    graphs = fresh_graphs
    a, b = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    write_fasta(a, pangenome(3, 60_000, 0.05, seed=13))
    write_fasta(b, pangenome(2, 90_000, 0.05, seed=14))
    want_a = _card_map(tmp_path, a, "a-cpu", ["cpu"])
    want_b = _card_map(tmp_path, b, "b-cpu", ["cpu"])
    assert _card_map(tmp_path, a, "a1", [cuda]) == want_a
    cache = graphs._cache(cuda)
    first = dict(graphs.CAPTURES)
    tables = dict(cache.tables)
    sig = cache.sig
    assert first["l1_step"] >= 1 and first["l2_step"] >= 1
    replays = dict(graphs.REPLAYS)
    assert _card_map(tmp_path, a, "a2", [cuda]) == want_a
    assert graphs.CAPTURES == first
    assert graphs.REPLAYS["l1_step"] > replays.get("l1_step", 0)
    assert all(cache.tables[k] is v for k, v in tables.items())
    assert _card_map(tmp_path, b, "b1", [cuda]) == want_b
    assert cache.sig != sig
    assert all(cache.tables[k] is not v for k, v in tables.items())
    captured_b = sum(graphs.CAPTURES.values()) - sum(first.values())
    assert captured_b >= 2 and len(cache.graphs) == captured_b


def test_two_blocks_on_one_card_replay_one_graph(cuda, tmp_path,
                                                 fresh_graphs):
    """[cuda:0, cuda:0] replays each shape's graph for both row blocks
    back to back (the copy-out keeps the first block's result) and
    writes the single-device PAF."""
    graphs = fresh_graphs
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, pangenome(3, 60_000, 0.05, seed=13))
    want = _card_map(tmp_path, ref, "one", [cuda])
    graphs.reset_counts()
    got = _card_map(tmp_path, ref, "two", [cuda, cuda])
    assert want.count("\n") > 3 and got == want
    calls = {k: graphs.REPLAYS.get(k, 0) for k in ("l1_step", "l2_step")}
    assert calls["l1_step"] % 2 == 0 and calls["l2_step"] % 2 == 0
    # the second block of each call replays the graph the first captured
    assert calls["l1_step"] >= 2
    assert all(graphs.CAPTURES.get(k, 0) <= calls[k] // 2 for k in calls)


def test_clear_returns_the_cache_to_the_driver(cuda, tmp_path, fresh_graphs):
    """After a map the device's cache holds its table set and graph pool;
    graphs.clear returns both, and the device's reserved memory falls
    back to what it was before the map."""
    import gc
    graphs = fresh_graphs
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, pangenome(3, 60_000, 0.05, seed=13))
    _card_map(tmp_path, ref, "warm", [cuda])     # lazy per-device set-up
    graphs.clear(cuda)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(cuda)
    _card_map(tmp_path, ref, "map", [cuda])
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(cuda) > before
    assert graphs._cache(cuda).graphs
    graphs.clear(cuda)
    assert graphs._device(cuda) not in graphs._CACHES
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(cuda) <= before
