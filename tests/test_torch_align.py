"""The port's aligner against the JAX package's, on CPU tensors: the
banded DP's plain version, the anchors, the tracebacks, and alignment
output byte for byte (tolerance 0 throughout)."""

import os
import sys

import numpy as np
import pytest

from mashmap_tpu.align import anchors as jax_anchors
from mashmap_tpu.align import driver as jax_driver
from mashmap_tpu.align import kernel as JK
from mashmap_tpu.kernels.kmers import sanitize as jax_sanitize
from mashmap_tpu_torch.align import anchors, driver
from mashmap_tpu_torch.align import kernel as K
from mashmap_tpu_torch.align.cli import main as align_main
from mashmap_tpu_torch.cli import main as map_main

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)
from genomes import mutate, random_genome, revcomp, write_fasta  # noqa
from test_torch_dp_pieces import (dp_edge_pieces, dp_pieces,  # noqa
                                  free_ends)
from port_fixtures import jax_native_reader, one_torch_thread  # noqa


@pytest.mark.parametrize("P,W", [(64, 32), (256, 64)])
@pytest.mark.parametrize("kind", ["random", "edges"])
def test_plain_dp_matches_jax_and_host(P, W, kind):
    """The plain version's rows (banded_dp_rows_torch on CPU tensors) ==
    JAX banded_dp_rows == banded_dp_rows_host over the whole
    (B, P+1, W)."""
    arrays = (dp_pieces(P, W, 24, P + W) if kind == "random"
              else dp_edge_pieces(P, W))
    t = K.dp_inputs(*arrays, free_ends(len(arrays[2])), "cpu")
    got = K.banded_dp_rows_torch(*t[:6], p_len=P, width=W)
    assert got.dtype.itemsize == 2
    got = got.numpy()
    want = np.asarray(JK.banded_dp_rows(*arrays, p_len=P, width=W))
    assert got.dtype == np.uint16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, K.banded_dp_rows_host(*arrays, p_len=P, width=W))


def test_dp_wrapper_rejects_bad_inputs():
    import torch
    t = K.dp_inputs(*dp_pieces(64, 32, 4, 1), free_ends(4), "cpu")
    with pytest.raises(TypeError, match="int32"):
        K.banded_dp_trace(t[0], t[1], t[2].long(), *t[3:], p_len=64,
                          width=32)
    with pytest.raises(TypeError, match="free_end must be torch.bool"):
        K.banded_dp_trace(*t[:6], t[6].to(torch.uint8), p_len=64,
                          width=32)
    with pytest.raises(ValueError, match="q must be"):
        K.banded_dp_trace(*t, p_len=63, width=32)
    with pytest.raises(ValueError, match="contiguous"):
        K.banded_dp_trace(t[0], torch.zeros((96, 4), dtype=torch.uint8).t(),
                          *t[2:], p_len=64, width=32)


def _genome_pair(seed, div):
    base = random_genome(20_000, seed=seed)
    return (jax_sanitize(base.encode()),
            jax_sanitize(mutate(base, div, seed=seed + 1).encode()))


@pytest.mark.parametrize("seed,div", [(3, 0.0), (3, 0.05), (11, 0.15)])
def test_anchors_match_jax(seed, div):
    q, r = _genome_pair(seed, div)
    for k in (21, 15, 11):
        c1, v1 = anchors.kmer_codes(q, k)
        c2, v2 = jax_anchors.kmer_codes(q, k)
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(v1, v2)
        a1 = anchors.find_anchor_chain(q, r, k, 192)
        np.testing.assert_array_equal(
            a1, jax_anchors.find_anchor_chain(q, r, k, 192))
    assert len(a1) > 0


def _rand_piece(rng, n, m, div):
    q = rng.integers(65, 69, size=n, dtype=np.uint8)
    r = q.copy()[:m] if m <= n else np.concatenate(
        [q, rng.integers(65, 69, size=m - n, dtype=np.uint8)])
    at = rng.choice(m, size=int(div * m), replace=False)
    r[at] = rng.integers(65, 69, size=len(at), dtype=np.uint8)
    return q, r


def test_tracebacks_match_jax():
    """traceback_batch on the DP rows of random pieces, traceback_band on
    each piece, and _traceback_full on the unbanded DP give the JAX
    package's paths."""
    rng = np.random.default_rng(4)
    P, W = 64, 32
    arrays = dp_pieces(P, W, 16, 5)
    q, r, n, m, lo, fs = arrays
    rows = K.banded_dp_rows_host(*arrays, p_len=P, width=W)
    end_j = m.astype(np.int64)
    ok = (rows[np.arange(16), n, m - n - lo] < K.CAP)
    sel = np.nonzero(ok)[0]
    assert len(sel) >= 4
    args = (rows[sel], q[sel], r[sel], n[sel], m[sel], lo[sel], fs[sel],
            end_j[sel])
    ops, start = K.traceback_batch(*args)
    jops, jstart = JK.traceback_batch(*args)
    np.testing.assert_array_equal(start, jstart)
    for a, b in zip(ops, jops):
        np.testing.assert_array_equal(a, b)
    for k, b in enumerate(sel):
        o, s = K.traceback_band(rows[b], q[b], r[b], int(n[b]), int(m[b]),
                                int(lo[b]), bool(fs[b]), int(end_j[b]))
        jo, js = JK.traceback_band(rows[b], q[b], r[b], int(n[b]),
                                   int(m[b]), int(lo[b]), bool(fs[b]),
                                   int(end_j[b]))
        np.testing.assert_array_equal(o, jo)
        assert s == js
    for trial in range(10):
        nn = int(rng.integers(10, 60))
        mm = int(np.clip(nn + rng.integers(-5, 6), 5, 90))
        qq, rr = _rand_piece(rng, nn, mm, 0.15)
        free = bool(trial % 2)
        D = K.full_dp_host(qq, rr, free)
        np.testing.assert_array_equal(D, JK.full_dp_host(qq, rr, free))
        end = int(np.argmin(D[nn])) if free else mm
        o, s = driver._traceback_full(D, qq, rr, nn, end, free)
        jo, js = jax_driver._traceback_full(D, qq, rr, nn, end, free)
        np.testing.assert_array_equal(o, jo)
        assert s == js


@pytest.fixture(scope="module")
def aligned_setup(tmp_path_factory):
    """tests/test_align.py's genomes, mapped with the port's own mapper
    (--legacy, the reference aligner's input format) on the CPU."""
    d = tmp_path_factory.mktemp("torch_align")
    base = random_genome(30000, seed=5)
    q1 = mutate(base, 0.05, seed=6)
    q2 = revcomp(mutate(base[4000:12000], 0.03, seed=7))
    ref, qf = str(d / "ref.fa"), str(d / "q.fa")
    write_fasta(ref, [("chr1", base)])
    write_fasta(qf, [("q1", q1), ("q2", q2)])
    mp = str(d / "map.out")
    assert map_main(["-r", ref, "-q", qf, "-o", mp, "-k", "15", "-s",
                     "1000", "-J", "60", "--pi", "80", "--legacy",
                     "--noProgress"], device="cpu") == 0
    assert os.path.getsize(mp) > 0
    return d, ref, qf, mp


@pytest.mark.parametrize("pi", [80.0, 0.0])
def test_align_files_byte_identical_to_jax(aligned_setup, pi):
    d, ref, qf, mp = aligned_setup
    want, got = str(d / f"jax_{pi}.aln"), str(d / f"port_{pi}.aln")
    jax_driver.align_files([ref], [qf], mp, pi, want)
    st = driver.align_files([ref], [qf], mp, pi, got, device="cpu")
    with open(want) as a, open(got) as b:
        want_s, got_s = a.read(), b.read()
    assert want_s and got_s == want_s
    assert st.rows_out == want_s.count("\n") and st.rows_in >= st.rows_out
    assert sum(st.pieces.values()) > 0 and st.d2h_ms == 0.0
    if pi == 0.0:
        with open(mp) as fh:
            assert got_s.count("\n") == sum(1 for ln in fh if ln.strip())


def test_edit_limit_drops_rows(aligned_setup):
    """A divergent mapping row beyond the pi bound produces no output."""
    d = aligned_setup[0]
    ref2, qf2 = str(d / "r2.fa"), str(d / "q2.fa")
    write_fasta(ref2, [("c", random_genome(2000, seed=8))])
    write_fasta(qf2, [("z", random_genome(2000, seed=9))])
    fake = str(d / "fake.map")
    with open(fake, "w") as fh:
        fh.write("z 2000 0 1999 + c 2000 0 1999 85.0\n")
    st = driver.align_files([ref2], [qf2], fake, 90.0, str(d / "z.aln"),
                            device="cpu")
    assert open(d / "z.aln").read() == ""
    assert (st.rows_in, st.rows_out) == (1, 0)
    jax_driver.align_files([ref2], [qf2], fake, 90.0, str(d / "zj.aln"))
    assert open(d / "zj.aln").read() == ""


def test_align_cli(aligned_setup, capsys):
    d, ref, qf, mp = aligned_setup
    out = str(d / "cli.aln")
    assert align_main(["-s", ref, "-q", qf, "--mappingFile", mp, "--pi",
                       "80", "-o", out], device="cpu") == 0
    jax_driver.align_files([ref], [qf], mp, 80.0, str(d / "cli_jax.aln"))
    assert open(out).read() == open(d / "cli_jax.aln").read() != ""
    with open(d / "list", "w") as fh:
        fh.write(ref + "\n")
    out2 = str(d / "cli2.aln")
    assert align_main(["--sl", str(d / "list"), "--ql", str(d / "list"),
                       "--mappingFile", mp, "--pi", "80", "-o", out2],
                      device="cpu") == 0
    assert align_main(["-q", qf, "--mappingFile", mp, "--pi", "80"],
                      device="cpu") == 1
    assert "provide reference file(s) with -s/--sl" in capsys.readouterr().err
    assert align_main(["-s", ref, "-q", qf, "--mappingFile", mp, "--pi",
                       "101"], device="cpu") == 1
    assert "--pi must be in [0, 100]" in capsys.readouterr().err


def test_host_dp_route_matches_jax():
    """A piece that no bucket fits (n above the largest P) takes the
    unbanded host DP in both packages, with the same path."""
    rng = np.random.default_rng(9)
    n = driver.MAX_P + 100
    q, r = _rand_piece(rng, n, n + 40, 0.02)
    mine = driver._Piece(0, 0, q, r, True, True)
    ref = jax_driver._Piece(0, 0, q, r, True, True)
    assert driver._bucket_for(mine) is None
    st = driver.AlignStats()
    driver.run_pieces([mine], "cpu", st)
    jax_driver.run_pieces([ref])
    assert st.host_pieces == 1 and st.dp_calls == 0
    np.testing.assert_array_equal(mine.ops, ref.ops)
    assert (mine.start_j, mine.end_j, mine.edit) == \
        (ref.start_j, ref.end_j, ref.edit)
