"""The plain reference on hand-made cases, the trace arithmetic, and the
control (the reference at half the sketch in the program's place),
which must come out not correct."""

import os

import numpy as np
import pytest
import torch

from benchmark import devtrace, run
from benchmark.reference import check, identity, murmur, stats
from benchmark.traffic import job

K = 19
SEG = 5000


def _u8(s: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(s, np.uint8).copy())[None]


@pytest.mark.parametrize("key, want", [
    (b"ACGTACGTACGTACGTACG", 0x272053CD152323BC),
    (b"ACGTACGTACGTACGT", 0x4152541EAC055887),
    (b"TTA", 0x0FF7042790004E11),
])
def test_murmur_known_values(key, want):
    got = murmur.murmur_windows(_u8(key), len(key))[0, 0].item()
    assert got & ((1 << 64) - 1) == want


def test_canonical_strand_palindrome_and_n():
    # ACGT is its own reverse complement: its two hashes are equal
    assert not murmur.canonical(_u8(b"ACGT"), 4)[2].any()
    h, fwd, valid = murmur.canonical(_u8(b"CGTACGTACGTACGTACGT" + b"N"), K)
    rh, rfwd, rvalid = murmur.canonical(_u8(b"ACGTACGTACGTACGTACG"), K)
    assert valid[0, 0] and not valid[0, 1] and rvalid[0, 0]
    assert h[0, 0] == rh[0, 0] == 0x272053CD152323BC
    assert not fwd[0, 0] and rfwd[0, 0]


def _random(n, seed):
    return np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(seed).integers(0, 4, n)]


def test_identical_fragment_shares_its_whole_sketch():
    t = _random(40_000, 1)
    jobs = [(t, t, off, off) for off in (0, 12_000, 35_000)]
    assert identity.identities(jobs, K, 50, SEG, 3000, 0.85, "cpu") == \
        [1.0, 1.0, 1.0]


def test_identity_does_not_depend_on_where_the_reach_starts():
    t = _random(60_000, 2)
    q = t.copy()
    snp = np.random.default_rng(3).choice(len(q), 600, replace=False)
    q[snp] = np.frombuffer(b"CGTA", np.uint8)[
        np.searchsorted(np.frombuffer(b"ACGT", np.uint8), q[snp])]
    base = identity.identities([(q, t, 20_000, 20_000)], K, 60, SEG, 6000,
                               0.85, "cpu")[0]
    moved = identity.identities([(q, t, 20_000, 20_007), (q, t, 20_000,
                                 19_990)], K, 60, SEG, 6000, 0.85, "cpu")
    assert moved == [base, base]
    assert 0.95 < base < 1.0
    # a smaller sketch is a coarser estimate of the same identity
    half = identity.identities([(q, t, 20_000, 20_000)], K, 30, SEG, 6000,
                               0.85, "cpu")[0]
    assert half != base and abs(half - base) < 0.02


def test_no_mapping_where_the_target_is_another_sequence():
    t, q = _random(30_000, 4), _random(30_000, 5)
    assert identity.identities([(q, t, 0, 0)], K, 50, SEG, 3000, 0.85,
                               "cpu") == [None]


def test_statistics_copy():
    assert stats.j2md(0.0, K) == 1.0 and stats.j2md(1.0, K) == 0.0
    assert abs(stats.md2j(stats.j2md(0.5, K), K) - 0.5) < 1e-6
    table = stats.cutoffs(40, K)
    assert len(table) == 41 and table[0] == 1
    assert np.all(np.diff(table) >= 0) and table[40] <= 40
    assert stats.minimum_hits(40, K, 0.95) == 6
    assert identity.fragment_offsets(12_345, SEG) == [0, 5000, 7345]
    assert identity.fragment_offsets(4000, SEG) == [0]


def _truth():
    seqs = {"q": _random(23_000, 6), "t": _random(30_000, 7), "u": None}
    seqs["t"][1000:24_000] = seqs["q"]

    def place(q, pos, t):
        return np.asarray(pos) + 1000 if (q, t) == ("q", "t") else None
    return check.Truth({k: v for k, v in seqs.items() if v is not None},
                       [("q", "t")], place)


def _paf(*rows):
    return "\n".join("\t".join(map(str, r)) for r in rows)


LIMITS = {"misplaced": 0, "uncovered_pct": 0.0, "id_gap": 1e-5}
HOW = {"reach": 3000, "max_fragments": 100, "pi": 0.85}


def test_judge_hand_made_rows():
    tr = _truth()
    good = ["q", 23000, 0, 23000, "+", "t", 30000, 1000, 24000, 50, 23000,
            255, "id:f:1", "kc:f:1"]
    got = check.judge([_paf(good)], tr, 1, HOW, K, 50, SEG, "cpu", LIMITS)
    assert (got["misplaced"], got["uncovered_pct"], got["id_gap"]) == \
        (0, 0.0, 0.0)
    assert got["checked_rows"] == 1 and got["failed_units"] == 0
    far = good[:7] + [9000, 23000 + 8000] + good[9:]
    minus = good[:4] + ["-"] + good[5:]
    half = good[:3] + [11500] + good[4:8] + [12500] + good[9:]
    low = good[:12] + ["id:f:0.999"] + good[13:]
    for rows, field in (([far], "misplaced"), ([minus], "misplaced"),
                        (["q\tbroken"], "misplaced"),
                        ([half], "uncovered_pct"), ([low], "id_gap")):
        got = check.judge([_paf(*rows)], tr, 1, HOW, K, 50, SEG, "cpu",
                          LIMITS)
        assert got[field] > LIMITS[field], field
        assert got["failed_units"] == 1


def test_trace_union_gaps_and_theta_bound():
    iv = np.array([[0, 10], [5, 20], [30, 40], [35, 36], [50, 60]])
    assert devtrace.union_ns(iv, 0, 100) == 40
    assert devtrace.gaps_ns(iv, 0, 100).tolist() == [[20, 30], [40, 50],
                                                     [60, 100]]
    assert devtrace.union_ns(iv, 32, 55) == 13
    assert devtrace.union_ns(np.zeros((0, 2), np.int64), 0, 5) == 0
    labels = devtrace.label_gaps(
        devtrace.gaps_ns(iv, 0, 100),
        [[(15, 35, "map post")], [(0, 100, "build host-classify")]])
    assert labels == {"map post": 10, "build host-classify": 50}
    assert devtrace.theta_bytes(1208, 4982) == 3 * 1208 * 4982 * 4
    assert devtrace.theta_bound_s([(1208, 4982)]) == pytest.approx(
        3 * 1208 * 4982 * 4 / 3.35e12)


def test_control_comes_out_not_correct(tmp_path):
    cfg = run.load_json(os.path.join(run.HERE, "configs",
                                     "yeast8-pi85.json"))
    cell = run.load_json(os.path.join(run.HERE, "workloads",
                                      "yeast8-pi85.selfmap-job.json"))
    shape = dict(cfg["shape"], haplotypes=3,
                 chromosomes=[["chrII", 813184], ["chrXII", 1078177]])
    st = job.setup_inputs(dict(cfg, shape=shape), cell, 17, "cpu",
                          str(tmp_path), scale=0.05)
    how = dict(cfg["check"], max_fragments=60, pi=0.85)
    got = check.control(job.truth(st), 17, how, K, st.s, SEG, "cpu",
                        cell["limits"])
    assert got["misplaced"] == 0 and got["uncovered_pct"] == 0.0
    assert got["id_gap"] > cell["limits"]["id_gap"]
    assert got["failed_units"] == 1


def test_control_of_one_fragment_rows_comes_out_not_correct(tmp_path):
    """Rows of one fragment, where the reference allows one frequent
    seed: half the sketch still reads over the limit."""
    cfg = run.load_json(os.path.join(run.HERE, "configs",
                                     "yeast8-pi85.json"))
    cell = run.load_json(os.path.join(run.HERE, "workloads",
                                      "yeast8-pi85.selfmap-job.json"))
    shape = dict(cfg["shape"], haplotypes=3,
                 chromosomes=[["chrII", 813184], ["chrXII", 1078177]])
    st = job.setup_inputs(dict(cfg, shape=shape), cell, 17, "cpu",
                          str(tmp_path), scale=0.05)
    how = dict(cfg["check"], max_fragments=60, pi=0.85)
    got = check.control(job.truth(st), 17, how, K, st.s, SEG, "cpu",
                        cell["limits"], one_fragment=True)
    assert got["checked_rows"] == got["checked_fragments"] == 60
    assert got["misplaced"] == 0 and got["uncovered_pct"] == 0.0
    assert got["id_gap"] > cell["limits"]["id_gap"]
