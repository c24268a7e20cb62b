"""The over-limit contig route of the port's index build (a contig with
more k-mer positions than the rank limit) against the JAX package's host
route: rank_reduce_host, contig_minmer_intervals and whole builds, every
comparison exact."""

import os
import sys

import numpy as np
import pytest
import torch

from mashmap_tpu.index import builder as jb
from mashmap_tpu.kernels import winnow as jw
from mashmap_tpu_torch.index import builder as tb
from mashmap_tpu_torch.kernels import theta as tt
from mashmap_tpu_torch.kernels import winnow as tw

sys.path.insert(0, os.path.dirname(__file__))
from genomes import pangenome, random_genome  # noqa: E402
from test_torch_build import assert_same_index  # noqa: E402
from port_fixtures import one_torch_thread  # noqa: E402,F401

K, W, S = 11, 500, 24


def _hashes(n, alphabet, invalid, seed):
    """Random u64 hashes drawn from `alphabet` distinct values (repeats),
    a share `invalid` of positions invalid."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2**63, alphabet, dtype=np.int64).astype(
        np.uint64) * np.uint64(2) + np.uint64(1)
    h = vals[rng.integers(0, alphabet, n)]
    valid = rng.random(n) >= invalid
    return h, valid


@pytest.mark.parametrize("alphabet,invalid", [(50, 0.0), (3000, 0.1),
                                              (100000, 0.5)])
def test_rank_reduce_host_matches_jax(alphabet, invalid):
    contigs = [_hashes(n, alphabet, invalid, seed=n)
               for n in (7_000, 1, 13_000, 0)]
    # a valid position may carry the sentinel's value: it is invalid too
    contigs[0][0][5] = jw.SENTINEL
    want_r, want_u = jw.rank_reduce_host(contigs)
    got_r, got_u = tw.rank_reduce_host(contigs)
    np.testing.assert_array_equal(got_u, want_u)
    assert got_u.dtype == want_u.dtype
    assert len(got_r) == len(want_r)
    for a, b in zip(got_r, want_r):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert tw.rank_reduce_host([])[1].dtype == np.uint64


def _same_intervals(got, want):
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("alphabet,invalid,s,span", [
    (400, 0.02, 8, 60), (40, 0.1, 5, 30), (5000, 0.3, 12, 97)])
def test_contig_minmer_intervals_matches_jax(alphabet, invalid, s, span):
    """On raw u64 hashes (SENTINEL theta, the lexsort route) and on their
    int32 ranks (RSENT theta from the port's theta scan)."""
    n = 6_000
    h, valid = _hashes(n, alphabet, invalid, seed=alphabet + s)
    strand = np.where(np.random.default_rng(s).random(n) < 0.5, 1,
                      -1).astype(np.int8)
    theta = jw.window_thresholds_bruteforce(h, valid, s, span)
    want = jb.contig_minmer_intervals(h, valid, strand, theta, span,
                                      n_flush=n)
    got = tb.contig_minmer_intervals(h, valid, strand, theta, span,
                                     n_flush=n)
    _same_intervals(got, want)
    assert len(got[0][0]) > 0

    (r,), uniq = tw.rank_reduce_host([(h, valid)])
    th_r = tw.theta_scan_ranks([torch.from_numpy(r)], s, span)[0].numpy()
    lut = np.concatenate([uniq, [jw.SENTINEL]])
    np.testing.assert_array_equal(lut[np.minimum(th_r, len(uniq))], theta)
    want = jb.contig_minmer_intervals(r, r != jw.RSENT, strand, th_r, span,
                                      n_flush=n, sent=jw.RSENT)
    got = tb.contig_minmer_intervals(r, r != tt.RSENT, strand, th_r, span,
                                     n_flush=n, sent=tt.RSENT)
    _same_intervals(got, want)


def test_contig_minmer_intervals_without_windows():
    h, valid = _hashes(40, 10, 0.0, seed=1)
    st = np.ones(40, np.int8)
    (ph, pb, pe), (mh, mb, me, ms) = tb.contig_minmer_intervals(
        h, valid, st, np.empty(0, np.uint64), 60, n_flush=40)
    assert len(ph) == len(mb) == 0 and ms.dtype == np.int8


@pytest.fixture
def jax_rank_limit(monkeypatch):
    def set_limit(n):
        monkeypatch.setenv("MASHMAP_TPU_DEVICE_RANK_LIMIT", str(n))
    return set_limit


def test_every_contig_over_the_limit(jax_rank_limit, monkeypatch):
    """Every contig takes the host route in both packages; the port's
    host route also equals its device route, and it launches theta."""
    contigs = pangenome(4, 60_000, 0.05, seed=11)
    jax_rank_limit(20_000)
    a = jb.build_index(contigs, 19, 5000, 40)
    routes = []
    real = tb._build_group_host

    def spy(group, *args):
        routes.append(len(group))
        return real(group, *args)
    monkeypatch.setattr(tb, "_build_group_host", spy)
    theta_calls = []
    real_theta = tw.theta_scan_ranks
    monkeypatch.setattr(tw, "theta_scan_ranks", lambda *a: (
        theta_calls.append(1), real_theta(*a))[1])
    b = tb.build_index(contigs, 19, 5000, 40, rank_limit=20_000,
                       device="cpu")
    assert routes == [1, 1, 1, 1]
    assert len(theta_calls) == 4
    assert_same_index(a, b)
    c = tb.build_index(contigs, 19, 5000, 40, rank_limit=2**30,
                       device="cpu")
    assert routes == [1, 1, 1, 1], "2^30 keeps every contig on the device"
    assert_same_index(c, b)
    assert len(b.mi_rank) > 0 and b.freq_threshold == a.freq_threshold


def test_mixed_limit_some_groups_host(jax_rank_limit, monkeypatch):
    """Short contigs group on the device route, long ones go host, and a
    contig shorter than the window and an N run ride along; the index
    equals JAX's at the same limit and at the default one."""
    contigs = [("a", random_genome(9_000, seed=31)),
               ("long1", random_genome(30_000, seed=32)),
               ("b", random_genome(8_000, seed=33)),
               ("tiny", random_genome(200, seed=34)),
               ("c", random_genome(7_000, seed=35))]
    seq = random_genome(26_000, seed=36)
    contigs.append(("long2", seq[:9_000] + "N" * 600 + seq[9_600:]))
    contigs.append(("d", random_genome(12_000, seed=37)))
    limit = 20_000
    routes = {"host": 0, "device": 0}
    for name, real in (("host", tb._build_group_host),
                       ("device", tb._build_group)):
        def spy(group, *args, _n=name, _r=real):
            routes[_n] += 1
            return _r(group, *args)
        monkeypatch.setattr(tb, "_build_group_host" if name == "host"
                            else "_build_group", spy)
    got = tb.build_index(contigs, K, W, S, rank_limit=limit, device="cpu")
    assert routes["host"] == 2 and routes["device"] == 3, routes
    jax_rank_limit(limit)
    assert_same_index(jb.build_index(contigs, K, W, S), got)
    monkeypatch.delenv("MASHMAP_TPU_DEVICE_RANK_LIMIT")
    assert_same_index(jb.build_index(contigs, K, W, S), got)
