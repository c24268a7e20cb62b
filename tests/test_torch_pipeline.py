"""The port's depth-2 overlaps, on CPU tensors, held to the JAX package:
the pipelined map (``Mapper._run_pipelined``: at most two batches in
flight, queries spanning batches, the host routes and both sketch-row
gathers inside it) writes the JAX package's PAF bytes, and the
overlapped group build (group N's host work on a worker thread while
group N+1's device phases run) gives the JAX package's index arrays."""

import io
import logging
import os
import sys
import threading

import numpy as np
import pytest
import torch

from mashmap_tpu.api import map_files as jax_map_files
from mashmap_tpu.index import builder as jb
from mashmap_tpu.index.builder import build_index as jax_build_index
from mashmap_tpu.map.engine import Mapper as JaxMapper
from mashmap_tpu.params import Parameters as JaxParameters
from mashmap_tpu_torch import hostcopy, trace
from mashmap_tpu_torch.api import map_files
from mashmap_tpu_torch.index import builder as tb
from mashmap_tpu_torch.map import engine
from mashmap_tpu_torch.map.engine import Mapper
from mashmap_tpu_torch.params import (Parameters, FILTER_MAP, FILTER_NONE,
                                      FILTER_ONETOONE)

sys.path.insert(0, os.path.dirname(__file__))
from genomes import mutate, pangenome, random_genome, write_fasta  # noqa
from port_fixtures import jax_native_reader, one_torch_thread  # noqa
from test_torch_e2e import _repeat_workload  # noqa

K, W, S = 11, 500, 30
BATCH = 4
SMALL = dict(kmer_size=K, seg_length=W, sketch_size=S,
             percentage_identity=0.80, batch_fragments=BATCH,
             no_progress=True)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A small pangenome and queries of several lengths cut from it
    (shorter than a fragment, a few fragments, a dozen): at 4 fragments
    a batch most queries span batches."""
    d = tmp_path_factory.mktemp("pipeline")
    recs = pangenome(3, 12_000, divergence=0.05, seed=21)
    base = recs[0][1]
    queries = [("q_short", base[1_000:1_400]),
               ("q_mid", mutate(base[2_000:4_700], 0.03, seed=22)),
               ("q_long", mutate(base[3_000:9_100], 0.02, seed=23)),
               ("q_two", mutate(recs[1][1][500:1_600], 0.02, seed=24)),
               ("q_last", mutate(recs[2][1][6_000:11_900], 0.04, seed=25))]
    ref, qf = str(d / "ref.fa"), str(d / "q.fa")
    write_fasta(ref, recs)
    write_fasta(qf, queries)
    return ref, qf, sum(len(q) for _, q in queries)


def _schedule(n):
    """The JAX package's _run_pipelined order of stage calls for n
    batches: D = dispatch, L1 / L2 = collect, P = post."""
    ev = []
    for k in range(n):
        ev.append(("D", k))
        if k >= 1:
            ev.append(("L1", k - 1))
        if k >= 2:
            ev += [("L2", k - 2), ("P", k - 2)]
    if n >= 2:
        ev += [("L2", n - 2), ("P", n - 2)]
    ev += [("L1", n - 1), ("L2", n - 1), ("P", n - 1)]
    return ev


@pytest.mark.parametrize("mode", [FILTER_MAP, FILTER_ONETOONE, FILTER_NONE])
def test_pipelined_map_paf_identical(pair, tmp_path, monkeypatch, mode):
    """At 4 fragments a batch (queries spanning batches) the pipelined
    map writes the JAX package's PAF in each filter mode, and runs its
    stages in the JAX package's depth-2 order."""
    ref, qf, _ = pair
    for tag, P in (("jax", JaxParameters), ("port", Parameters)):
        path = str(tmp_path / f"{tag}.paf")
        p = P(ref_sequences=[ref], query_sequences=[qf], out_file_name=path,
              filter_mode=mode, **SMALL)
        if tag == "jax":
            jax_map_files(p)
            continue
        trace, batches = [], []
        for name, stage in (("_dispatch_batch", "D"), ("_collect_l1", "L1"),
                            ("_collect_l2", "L2"), ("_post_batch", "P")):
            real = getattr(Mapper, name)

            def spy(self, arg, _real=real, _stage=stage):
                r = _real(self, arg)
                if _stage == "D":
                    batches.append(r)
                ctx = r if _stage == "D" else arg
                trace.append((_stage, next(i for i, b in enumerate(batches)
                                           if b is ctx)))
                return r
            monkeypatch.setattr(Mapper, name, spy)
        map_files(p, device="cpu")
        monkeypatch.undo()
    with open(tmp_path / "jax.paf") as fh:
        want = fh.read()
    with open(tmp_path / "port.paf") as fh:
        got = fh.read()
    assert want.count("\n") >= 5
    assert got == want
    n = sum(1 for st, _ in trace if st == "D")
    assert n >= 8, n
    assert trace == _schedule(n)


def test_pipelined_host_routes_and_gathers(tmp_path, monkeypatch):
    """Inside the pipeline: fragments over a small postings cap take the
    host L1 route, L2 slices over a lowered top bucket replay on the
    host (their sketch rows gathered early, in _collect_l1), and a run
    cap of 1 makes items overflow on the device (their rows gathered
    late, in _collect_l2). The PAF is the JAX package's at its defaults
    (the repeat workload without its slowest query for the JAX side)."""
    contigs, queries = _repeat_workload()
    q_fa = str(tmp_path / "q.fa")
    write_fasta(q_fa, [q for q in queries if q[0] != "q_rep3"])
    k, w, s = 11, 500, 24
    kw = dict(ref_sequences=[q_fa], query_sequences=[q_fa],
              out_file_name="-", kmer_size=k, seg_length=w, sketch_size=s,
              percentage_identity=0.85, num_mappings_for_segment=3,
              no_progress=True)
    jm = JaxMapper(JaxParameters(**kw).finalize(),
                   jax_build_index(contigs, kmer_size=k, window_size=w,
                                   sketch_size=s))
    want = io.StringIO()
    jm.run([q_fa], want, progress=False)
    want = want.getvalue()
    assert want.count("\n") > 5

    from mashmap_tpu_torch.kernels import mapdev
    monkeypatch.setattr(mapdev, "L2_RUN_CAP", 1)
    monkeypatch.setattr(engine, "T_BUCKETS", (512,))
    gathers = []
    real = engine._gather_sketch_rows

    def spy(qh, qs, indices):
        gathers.append(sys._getframe(1).f_code.co_name)
        return real(qh, qs, indices)
    monkeypatch.setattr(engine, "_gather_sketch_rows", spy)
    idx = tb.build_index(contigs, k, w, s, device="cpu")
    m = Mapper(Parameters(l1_postings_cap=40, batch_fragments=BATCH,
                          **kw).finalize(), idx, device="cpu")
    out = io.StringIO()
    with trace.recording() as rec:
        m.run([q_fa], out)
    st = m.path_stats
    assert out.getvalue() == want
    assert st["host_frags"] > 0 and st["host_l2"] > 0, st
    # the host-route fragments took the scalar _do_l2, the others the
    # array path
    assert rec.totals["post-l2-scalar"][1] > 0
    assert rec.totals["post-l2"][1] > 0
    assert {"_collect_l1", "_collect_l2"} <= set(gathers), gathers
    assert set(m.phase_s) == {"l1-tables", "l1-dispatch", "l1-wait",
                              "l1-fetch", "l2-dispatch", "l2-wait",
                              "l2-fetch", "post"}


def test_plain_pipelined_map_takes_no_scalar_post(pair):
    """Without a host route the pipelined map's rows all come from the
    array path: ``post-l2`` counts its segments, ``post-l2-scalar`` no
    fragment."""
    ref, qf, _ = pair
    p = Parameters(ref_sequences=[ref], query_sequences=[qf],
                   out_file_name=os.devnull, **SMALL)
    with trace.recording() as rec:
        map_files(p, device="cpu")
    assert rec.totals["post-l2"][1] > 0
    assert rec.totals.get("post-l2-scalar", (0.0, 0))[1] == 0


def test_meter_credits_every_base_once(pair, monkeypatch):
    """Each query's bases are credited once, fragment by fragment, as
    its fragments are delivered from batches in flight."""
    from mashmap_tpu_torch import progress
    ref, qf, total = pair
    credited = []

    class Meter:
        def __init__(self, total_bp, banner):
            pass

        def increment(self, n):
            credited.append(n)

        def finish(self):
            credited.append("finish")

    monkeypatch.setattr(progress, "ProgressMeter", Meter)
    p = Parameters(ref_sequences=[ref], query_sequences=[qf],
                   out_file_name=os.devnull, **SMALL).finalize()
    m = Mapper(p, tb.build_index(
        [("c", random_genome(12_000, seed=3))], K, W, S, device="cpu"),
        device="cpu")
    with open(os.devnull, "w") as out:
        m.run([qf], out, progress=True)
    assert credited[-1] == "finish"
    assert all(0 < n <= W for n in credited[:-1])
    assert sum(credited[:-1]) == total


def _contigs_around_an_over_limit_one():
    """Device groups at a rank limit of 20k positions: [a, b], [c], then
    the over-limit contig alone on the host route, then [d], [e, f]."""
    seq = random_genome(30_000, seed=56)
    return [("a", random_genome(9_000, seed=51)),
            ("b", random_genome(8_000, seed=52)),
            ("c", random_genome(7_000, seed=53)),
            ("long", seq[:9_000] + "N" * 500 + seq[9_500:]),
            ("tiny", random_genome(300, seed=54)),
            ("d", random_genome(12_000, seed=55)),
            ("e", random_genome(9_000, seed=57)),
            ("f", mutate(random_genome(6_000, seed=51), 0.02, seed=58))]


def test_overlapped_build_equals_jax(monkeypatch, caplog):
    """Four device groups and one over-limit contig between them: the
    index equals the JAX package's at the same limit; every group's host
    part (the host route's resolution, a device group's split of its
    classified arrays) ran on the build's one worker thread, in group
    order, and each group logs and records its phases (device ones, the
    device classify included, on the main thread)."""
    contigs = _contigs_around_an_over_limit_one()
    limit = 20_000
    built, hosted = [], []
    for name in ("_build_group", "_build_group_host"):
        real = getattr(tb, name)

        def spy(group, *args, _real=real):
            built.append(group[0][0])
            return _real(group, *args)
        monkeypatch.setattr(tb, name, spy)
    real_rh, real_split = tb._resolve_group_hashes, tb.split_group

    def resolve_spy(results, *args):
        hosted.append(([r[0] for r in results],
                       threading.current_thread().name))
        return real_rh(results, *args)

    def split_spy(arrays, seq_ids):
        hosted.append((list(seq_ids), threading.current_thread().name))
        return real_split(arrays, seq_ids)
    monkeypatch.setattr(tb, "_resolve_group_hashes", resolve_spy)
    monkeypatch.setattr(tb, "split_group", split_spy)
    with caplog.at_level(logging.DEBUG, "mashmap_tpu_torch.index"):
        got = tb.build_index(contigs, 15, 2_000, 60, rank_limit=limit,
                             device="cpu")
    monkeypatch.setenv("MASHMAP_TPU_DEVICE_RANK_LIMIT", str(limit))
    want = jb.build_index(contigs, 15, 2_000, 60)
    for f in tb._NPZ_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.names, got.freq_threshold) == (want.names,
                                               want.freq_threshold)
    assert built == [0, 2, 3, 5, 6]
    assert [h[0] for h in hosted] == [[0, 1], [2], [3], [5], [6, 7]]
    main = threading.main_thread().name
    assert all(name != main for _, name in hosted), hosted
    phases = {}
    for r in caplog.records:
        if " phase " in r.getMessage():
            gid, label = r.getMessage().split()[1:4:2]
            phases.setdefault(int(gid), []).append(
                (label, r.threadName == main))
    dev = [("hash-dispatch", True), ("rank+theta", True),
           ("events+fetch", True), ("classify", True),
           ("host-classify", False), ("resolve-u64", False)]
    host = [("hash-dispatch", True), ("rank+theta", True),
            ("host-classify", False), ("resolve-u64", False)]
    assert phases == {0: dev, 2: dev, 3: host, 5: dev, 6: dev}, phases
    # the same phases in the build's record, the worker's labels those
    # that ran off the main thread
    assert {g: list(ph) for g, ph in tb.GROUP_PHASE_S.items()} == {
        g: [label for label, _ in v] for g, v in phases.items()}
    assert all((label in tb.WORKER_PHASES) != on_main
               for v in phases.values() for label, on_main in v)
    assert all(t >= 0 for ph in tb.GROUP_PHASE_S.values()
               for t in ph.values())


def test_worker_exception_propagates(monkeypatch):
    """The split of a device group's classified arrays (split_group)
    failing on the worker for the second group raises out of
    build_index; nothing falls back to a serial path."""
    contigs = [(f"c{i}", random_genome(9_000, seed=60 + i))
               for i in range(3)]
    calls = []
    real = tb.split_group

    class Boom(RuntimeError):
        pass

    def fail_second(*args):
        calls.append(threading.current_thread() is threading.main_thread())
        if len(calls) == 2:
            raise Boom("group 2")
        return real(*args)
    monkeypatch.setattr(tb, "split_group", fail_second)
    with pytest.raises(Boom, match="group 2"):
        tb.build_index(contigs, 15, 2_000, 60, rank_limit=10_000,
                       device="cpu")
    assert calls[:2] == [False, False]


def test_host_copy_and_to_device_on_the_cpu():
    """On a CPU device the copy helpers hand back the same values with
    no copy; a sketch-row gather picks the asked rows."""
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    t = hostcopy.to_device(a[:, 1:], torch.device("cpu"))
    assert t.device.type == "cpu" and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), a[:, 1:])
    src = torch.from_numpy(a)
    np.testing.assert_array_equal(hostcopy.HostCopy(src).wait(), a)
    qh, qs = engine._gather_sketch_rows(src, -src, [0, 2])
    np.testing.assert_array_equal(qh.wait(), a[[0, 2]])
    np.testing.assert_array_equal(qs.wait(), -a[[0, 2]])
