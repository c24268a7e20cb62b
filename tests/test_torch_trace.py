"""The port's span recorder (mashmap_tpu_torch/trace.py): spans nest
under the right parent with their thread, job and batch on the exported
clock; a CPU ``map_files`` job under ``recording()`` yields every span
the program marks, its top-level spans cover the job, and its map phase
spans are ``Mapper.phase_s``; with recording off nothing is kept and the
phase labels are those ``tests/test_torch_pipeline.py`` pins; a batch's
``l1-pack`` span lies inside its ``l1-dispatch`` phase and changes no
phase; a graph capture on a card is a span; the CLI's ``--traceDir``
trace shows the spans."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mashmap_tpu_torch import cli, trace
from mashmap_tpu_torch.api import map_files
from mashmap_tpu_torch.index import builder
from mashmap_tpu_torch.kernels import graphs
from mashmap_tpu_torch.map import engine
from mashmap_tpu_torch.params import Parameters

sys.path.insert(0, os.path.dirname(__file__))
from genomes import pangenome, write_fasta  # noqa

SPANS = {"build read", "build worker-wait", "build tail-concat",
         "build tail-sort", "build tail-ranks", "build tail-filter",
         "map setup", "setup-cutoffs", "tables-host", "tables-upload",
         "map query-wait", "map prepare", "map finalize", "merge-filter",
         "emit"}
MAP_PHASES = {"l1-tables", "l1-dispatch", "l1-wait", "l1-fetch",
              "l2-dispatch", "l2-wait", "l2-fetch", "post"}
GROUP_PHASES = ["hash-dispatch", "rank+theta", "events+fetch",
                "classify", "host-classify", "resolve-u64"]


def _params(fa, out):
    return Parameters(ref_sequences=[fa], query_sequences=[fa],
                      out_file_name=out, kmer_size=11, seg_length=500,
                      sketch_size=24, percentage_identity=0.80,
                      batch_fragments=8, no_progress=True)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """One self-map job of a small pangenome (after a warm one) under
    ``recording()``: (record, the job's host seconds on the exported
    clock, its Mapper, its entry in ``trace.JOBS``)."""
    d = tmp_path_factory.mktemp("trace")
    fa = str(d / "pan.fa")
    write_fasta(fa, pangenome(3, 12_000, divergence=0.05, seed=31))
    map_files(_params(fa, str(d / "warm.paf")), device="cpu")
    mappers = []
    run = engine.Mapper.run

    def kept(self, *a, **kw):
        mappers.append(self)
        return run(self, *a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine.Mapper, "run", kept)
        with trace.recording() as rec:
            t0 = time.time_ns()
            map_files(_params(fa, str(d / "job.paf")), device="cpu")
            t1 = time.time_ns()
    return rec, (t0, t1), mappers[0], trace.JOBS[-1]


def test_spans_nest_with_parent_thread_job_and_batch():
    phases = {}

    def sink(label, seconds):
        phases[label] = seconds

    @trace.job
    def work():
        with trace.span("outer"):
            mark = trace.clock("c ", sink, batch=3)
            with trace.span("inner"):
                pass
            mark("one")
            mark("two")
            mark("three", keep=False)       # a span of its own
        t = threading.Thread(target=trace.add, args=("other", 0.5))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with trace.span("worker-free"):
            pass

    before = time.time_ns()
    with trace.recording() as rec:
        work()

        def side():
            with trace.span("side"):
                pass
        t = threading.Thread(target=side, name="side-thread")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    after = time.time_ns()
    sp = rec.spans()
    by = {s[0]: (i, s) for i, s in enumerate(sp)}
    assert set(by) == {"outer", "c one", "inner", "c two", "worker-free",
                       "side"}
    ordinal = trace.JOBS[-1][0]
    outer = by["outer"][0]
    assert by["outer"][1][1:2] == (None,)
    assert by["c one"][1][1] == outer and by["c two"][1][1] == outer
    assert by["inner"][1][1] == by["c one"][0]
    assert by["worker-free"][1][1] is None
    assert by["side"][1][1] is None and by["side"][1][2] == "side-thread"
    assert all(s[2] == rec.main for n, (_, s) in by.items() if n != "side")
    assert by["c one"][1][6] == by["c two"][1][6] == 3
    assert by["outer"][1][6] is None and by["inner"][1][6] is None
    assert all(s[5] == ordinal for n, (_, s) in by.items() if n != "side")
    assert all(before <= s[3] <= s[4] <= after for s in sp)
    assert [s[3] for s in sp] == sorted(s[3] for s in sp)
    assert set(phases) == {"one", "two", "three"}
    assert rec.totals["other"] == (0.5, 1)
    assert trace.JOBS[-1][1]["outer"][1] == 1
    assert "c one" not in rec.totals        # clock phases go to their sink


def test_job_records_every_span_of_the_program(job):
    rec, _, _, (ordinal, totals) = job
    sp = rec.spans()
    names = {s[0] for s in sp}
    assert SPANS <= names, SPANS - names
    assert {f"map {p}" for p in MAP_PHASES} <= names
    assert {f"build {p}" for p in GROUP_PHASES} <= names
    # the device classify: one span a group (the one group of three
    # contigs), kept once though it is a phase of the group's clock too
    assert [s[0] for s in sp].count("build classify") == 1
    assert rec.totals["build classify"][1] == 1
    assert rec.totals["build classify contigs"] == (0.0, 3)
    assert rec.totals["post-l2"][1] > 0
    assert all(s[5] == ordinal for s in sp)
    # children where the program puts them
    parent = {"setup-cutoffs": "map setup", "tables-host": "map l1-tables",
              "tables-upload": "map l1-tables",
              "merge-filter": "map finalize", "emit": "map finalize"}
    for s in sp:
        if s[0] in parent:
            assert sp[s[1]][0] == parent[s[0]], s
    # the worker's phases on their own thread, the rest on the main one
    for s in sp:
        on_main = s[2] == rec.main
        assert on_main == (s[0] not in ("build host-classify",
                                        "build resolve-u64")), s
    # batch ordinals join the phases of one map batch
    batches = {}
    for s in sp:
        if s[0].startswith("map ") and s[0][4:] in MAP_PHASES:
            batches.setdefault(s[6], set()).add(s[0][4:])
    assert len(batches) >= 3 and None not in batches
    assert all(v == MAP_PHASES for v in batches.values()), batches
    assert totals == rec.totals


def test_top_level_spans_cover_the_job(job):
    rec, (t0, t1), _, _ = job
    top = np.array([(s[3], s[4]) for s in rec.spans()
                    if s[1] is None and s[2] == rec.main], np.int64)
    # top-level spans of one thread do not overlap: their sum is their
    # union
    order = np.argsort(top[:, 0])
    assert (top[order[1:], 0] >= top[order[:-1], 1]).all()
    covered = (top[:, 1] - top[:, 0]).sum()
    assert covered >= 0.95 * (t1 - t0), (covered, t1 - t0)


def test_map_phase_spans_sum_to_phase_s(job):
    rec, _, mapper, _ = job
    got = {}
    for s in rec.spans():
        if s[0].startswith("map ") and s[0][4:] in MAP_PHASES:
            got[s[0][4:]] = got.get(s[0][4:], 0) + (s[4] - s[3]) / 1e9
    assert set(got) == set(mapper.phase_s) == MAP_PHASES
    for label, sec in mapper.phase_s.items():
        assert abs(got[label] - sec) < 1e-3, (label, got[label], sec)


def test_l1_pack_nests_in_l1_dispatch(job):
    rec, _, _, (_, totals) = job
    sp = rec.spans()
    packs = [s for s in sp if s[0] == "l1-pack"]
    dispatches = [s for s in sp if s[0] == "map l1-dispatch"]
    assert len(packs) == len(dispatches) >= 3
    assert all(sp[s[1]][0] == "map l1-dispatch" for s in packs)
    assert {sp[s[1]][6] for s in packs} == {s[6] for s in dispatches}
    assert totals["l1-pack"][1] == len(packs)


def test_l1_pack_leaves_the_phases_as_they_were(job):
    """``l1-pack`` is a span, not a phase: ``Mapper.phase_s`` keeps its
    labels, and its ``l1-dispatch`` seconds hold the pack's."""
    rec, _, mapper, _ = job
    assert set(mapper.phase_s) == MAP_PHASES
    sec = {}
    for s in rec.spans():
        sec[s[0]] = sec.get(s[0], 0.0) + (s[4] - s[3]) / 1e9
    assert 0 < sec["l1-pack"] <= mapper.phase_s["l1-dispatch"]
    assert abs(sum(sec[f"map {p}"] for p in MAP_PHASES)
               - sum(mapper.phase_s.values())) < 1e-3


@pytest.mark.cuda
def test_graph_capture_is_a_span():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CPU graphs.call captures "
                    "nothing")
    device = torch.device("cuda", torch.cuda.current_device())

    def step(a, k):
        return a * 2 + k
    graphs.clear(device)
    try:
        with trace.recording() as rec:
            first = graphs.call(device, step, (np.arange(8),), 1)
            again = graphs.call(device, step, (np.arange(8),), 1)
        assert [s[0] for s in rec.spans()].count("graph capture") == 1
        assert rec.totals["graph capture"][1] == 1
        assert first.tolist() == again.tolist() == list(range(1, 17, 2))
    finally:
        graphs.clear(device)


def test_off_path_keeps_no_span_and_the_labels_stay(tmp_path):
    fa = str(tmp_path / "pan.fa")
    write_fasta(fa, pangenome(2, 8_000, divergence=0.05, seed=32))
    with trace.recording() as closed:
        pass
    mappers = []
    run = engine.Mapper.run

    def kept(self, *a, **kw):
        mappers.append(self)
        return run(self, *a, **kw)
    n_jobs = trace.JOBS[-1][0] if trace.JOBS else 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine.Mapper, "run", kept)
        map_files(_params(fa, str(tmp_path / "off.paf")), device="cpu")
    assert trace._rec is None and closed.spans() == []
    assert set(mappers[0].phase_s) == MAP_PHASES
    assert [list(ph) for ph in builder.GROUP_PHASE_S.values()] == [
        GROUP_PHASES]
    ordinal, totals = trace.JOBS[-1]
    assert ordinal == n_jobs + 1
    assert SPANS <= set(totals) and totals["post-l2"][1] > 0


def test_totals_under_contending_threads():
    """Adds from more threads than cores lose no update."""
    name = "stress"
    s0, n0 = trace.totals.get(name, (0.0, 0))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2_000):
                trace.add(name, 1.0)
        threads = [threading.Thread(target=work)
                   for _ in range(2 * (os.cpu_count() or 1) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    s, n = trace.totals[name]
    assert n - n0 == 2_000 * len(threads) and s - s0 == n - n0


def test_each_times_every_wait():
    with trace.recording() as rec:
        got = list(trace.each("wait", iter([1, 2, 3])))
    assert got == [1, 2, 3]
    assert [s[0] for s in rec.spans()] == ["wait"] * 4   # and the end
    assert rec.totals["wait"][1] == 4


def test_cli_trace_dir_shows_the_spans(tmp_path):
    fa = str(tmp_path / "pan.fa")
    write_fasta(fa, pangenome(2, 8_000, divergence=0.05, seed=33))
    out = tmp_path / "trace"
    assert cli.main(["-r", fa, "-q", fa, "--noProgress", "-k", "11",
                     "-s", "500", "--pi", "80", "--traceDir", str(out),
                     "-o", str(tmp_path / "traced.paf")],
                    device="cpu") == 0
    with open(out / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert SPANS <= names, SPANS - names
