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
