"""The port's mapper CLI against the JAX package's: the same parser, the
same validation messages, and byte-identical output files on the CPU;
the port's progress meter."""

import gzip
import io
import os
import sys
import time

import pytest

from mashmap_tpu import cli as jax_cli
from mashmap_tpu import native as jax_native
from mashmap_tpu_torch import cli
from mashmap_tpu_torch.progress import ProgressMeter

sys.path.insert(0, os.path.dirname(__file__))
from genomes import mutate, pangenome, write_fasta  # noqa: E402
from port_fixtures import jax_native_reader, one_torch_thread  # noqa


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    """Every option of the JAX CLI has the same option strings, dest,
    default, type, choices and nargs in the port's, and no other."""
    want, got = _actions(jax_cli.build_parser()), _actions(cli.build_parser())
    assert sorted(got) == sorted(want)
    for dest, a in want.items():
        b = got[dest]
        assert b.option_strings == a.option_strings, dest
        assert (b.default, b.choices, b.nargs, b.required, b.const) == \
            (a.default, a.choices, a.nargs, a.required, a.const), dest
        assert getattr(b.type, "__name__", b.type) == \
            getattr(a.type, "__name__", a.type), dest


@pytest.mark.parametrize("argv,msg", [
    (["-s", "50"], "segment length"),
    (["--pi", "30"], "identity"),
    (["-n", "0"], "mappings to retain"),
    (["-l", "-5"], "block length"),
    (["-c", "-1"], "chain gap"),
    (["--hgFilterAniDiff", "101"], "ANI difference"),
    (["--hgFilterConf", "-1"], "hypergeometric confidence"),
    (["-q", "/nonexistent.fa"], "Could not open"),
])
def test_validation_messages_match_jax(tmp_path, argv, msg, capsys):
    ref = tmp_path / "r.fa"
    ref.write_text(">a\nACGTACGT\n")
    errs = []
    for mod in (jax_cli, cli):
        a = mod.build_parser().parse_args(["-r", str(ref)] + argv)
        with pytest.raises(SystemExit):
            mod.args_to_params(a)
        errs.append(capsys.readouterr().err)
    assert msg in errs[0]
    assert errs[1] == errs[0]


def test_no_reference_message_matches_jax(capsys):
    errs = []
    for mod in (jax_cli, cli):
        with pytest.raises(SystemExit):
            mod.args_to_params(mod.build_parser().parse_args([]))
        errs.append(capsys.readouterr().err)
    assert "provide reference file(s) with -r/--rl" in errs[1]
    assert errs[1] == errs[0]


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A 100 kbp two-haplotype pangenome, a FASTA query set and the same
    reads as gzipped FASTQ."""
    d = tmp_path_factory.mktemp("torch_cli")
    recs = pangenome(2, 50_000, 0.05, seed=3)
    ref = str(d / "ref.fa")
    write_fasta(ref, recs)
    reads = [(f"read{i}", mutate(recs[i % 2][1][i * 7_000:i * 7_000 + 9_000],
                                 0.03, seed=20 + i)) for i in range(5)]
    reads.append(("short", recs[0][1][100:400]))
    qfa = str(d / "q.fa")
    write_fasta(qfa, reads)
    fq = str(d / "q.fq.gz")
    with gzip.open(fq, "wt") as fh:
        for name, seq in reads:
            fh.write(f"@{name} desc\n{seq}\n+\n{'I' * len(seq)}\n")
    return d, ref, qfa, fq


CASES = {
    "default": [],
    "legacy": ["--legacy"],
    "one_to_one": ["-f", "one-to-one", "-Y", "#"],
    "nosplit": ["-q", "QFA", "--noSplit"],
    "skipself_percentage": ["-X", "--reportPercentage"],
    "fastq_gz": ["-q", "FQ", "-n", "2"],
}


def _run_both(d, argv, tag):
    """argv through the JAX CLI and the port's (on the CPU); returns the
    two output files' bytes."""
    outs = []
    for name, run in (("jax", jax_cli.main),
                      ("port", lambda a: cli.main(a, device="cpu"))):
        out = str(d / f"{tag}.{name}")
        assert run(argv + ["-o", out]) == 0
        with open(out, "rb") as fh:
            outs.append(fh.read())
    return outs


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_output_byte_identical_to_jax(genome, case):
    d, ref, qfa, fq = genome
    argv = ["-r", ref, "--noProgress"] + [
        {"QFA": qfa, "FQ": fq}.get(x, x) for x in CASES[case]]
    want, got = _run_both(d, argv, case)
    assert want and got == want


def test_first_jax_run_independent_of_the_cache(genome, tmp_path,
                                                monkeypatch):
    """On an empty cache the fixture's single-threaded load builds the
    JAX reader, and the first JAX CLI run (the default case) then writes
    the port's bytes."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    monkeypatch.setattr(jax_native, "_lib", None)
    jax_native._load_fastaread()
    assert jax_native.native_available()
    assert [f for f in os.listdir(cache / "mashmap_tpu")
            if f.endswith(".so")]
    d, ref, _, _ = genome
    want, got = _run_both(d, ["-r", ref, "--noProgress"], "cold_cache")
    assert want and got == want


def test_cli_save_then_load_index_byte_identical_to_jax(genome):
    """--saveIndex then --loadIndex: each package's saved index maps to
    the same bytes, and the port maps the same from the JAX package's
    npz."""
    d, ref, qfa, _ = genome
    base = ["-r", ref, "-q", qfa, "--noProgress"]
    runs = {"jax": jax_cli.main,
            "port": lambda a: cli.main(a, device="cpu")}
    outs = {}
    for name, run in runs.items():
        out = str(d / f"save.{name}")
        assert run(base + ["--saveIndex", str(d / f"{name}.npz"),
                           "-o", out]) == 0
        outs[name, "save"] = open(out, "rb").read()
    for name, idx in (("jax", "jax"), ("port", "port"), ("port", "jax")):
        out = str(d / f"load.{name}.{idx}")
        assert runs[name](base + ["--loadIndex", str(d / f"{idx}.npz"),
                                  "-o", out]) == 0
        outs[name, idx] = open(out, "rb").read()
    assert outs["jax", "save"]
    assert len(set(outs.values())) == 1, sorted(outs)


def test_meter_paints_and_leaves_paf_unchanged(genome, capsys):
    """With the meter on (the default), the port paints to stderr and
    writes the same PAF as with --noProgress; with a .fai beside the
    query the meter is sized and ends at 100%."""
    d, ref, qfa, _ = genome
    quiet, loud = str(d / "quiet.paf"), str(d / "loud.paf")
    from mashmap_tpu_torch.io import for_each_seq_in_file
    recs = list(for_each_seq_in_file(qfa))
    total = sum(len(s) for _, s in recs)
    for extra in (["--noSplit"], []):   # the host route; device batches
        argv = ["-r", ref, "-q", qfa] + extra
        assert cli.main(argv + ["--noProgress", "-o", quiet],
                        device="cpu") == 0
        assert "::map] mapped" not in capsys.readouterr().err
        assert cli.main(argv + ["-o", loud], device="cpu") == 0
        err = capsys.readouterr().err
        # unsized (no terminal, no .fai): the last paint counts every
        # mapped base, credited as the queries finish
        assert f"[mashmap-tpu-torch::map] mapped {total} bp @" in err
        assert open(loud).read() == open(quiet).read() != ""
    # sized: a .fai beside the query makes sizing free on a non-tty
    sized_q = str(d / "sized.fa")
    write_fasta(sized_q, recs)
    with open(sized_q + ".fai", "w") as fh:
        for name, seq in recs:
            fh.write(f"{name}\t{len(seq)}\t0\t80\t81\n")
    sized = str(d / "sized.paf")
    assert cli.main(["-r", ref, "-q", sized_q, "-o", sized],
                    device="cpu") == 0
    assert "100.00%" in capsys.readouterr().err
    assert open(sized).read() == open(quiet).read()


@pytest.mark.parametrize("flag", [
    ["--shardIndex"], ["--coordinator", "localhost:1234"],
    ["--numProcesses", "2"], ["--processId", "1"]])
def test_parallel_flags_parse_and_run(genome, flag):
    """Each flag alone parses as the JAX CLI's and runs single-process
    (--shardIndex on one device falls back to the replicated index; a
    coordinator, a process count or an id alone start no multi-process
    run), writing the JAX CLI's bytes."""
    d, ref, _, _ = genome
    argv = ["-r", ref, "--noProgress"] + flag
    a = cli.build_parser().parse_args(argv)
    ja = jax_cli.build_parser().parse_args(argv)
    assert vars(a) == vars(ja)
    want, got = _run_both(d, argv, "par" + flag[0])
    assert want and got == want


@pytest.mark.parametrize("flag", [
    ["--numProcesses", "2", "--processId", "2"],
    ["--numProcesses", "3", "--processId", "-1"]])
def test_process_id_out_of_range_raises_like_jax(genome, flag):
    d, ref, _, _ = genome
    argv = ["-r", ref, "--noProgress", "--coordinator", "127.0.0.1:1",
            "-o", str(d / "range.paf")] + flag
    for run in (jax_cli.main, lambda a: cli.main(a, device="cpu")):
        with pytest.raises(ValueError, match="out of range"):
            run(argv)


def test_version_and_trace_dir(genome, capsys):
    d, ref, qfa, _ = genome
    assert cli.main(["-v"]) == 0
    assert "(mashmap-tpu-torch)" in capsys.readouterr().err
    trace = d / "trace"
    assert cli.main(["-r", ref, "-q", qfa, "--noProgress", "--traceDir",
                     str(trace), "-o", str(d / "traced.paf")],
                    device="cpu") == 0
    assert (trace / "trace.json").stat().st_size > 0


# --- the progress meter (tests/test_cli_utils.py's cases, on the port's) --


def test_progress_meter():
    buf = io.StringIO()
    m = ProgressMeter(1000, "[x] mapped", stream=buf, interval=0.01)
    m.increment(500)
    time.sleep(0.05)
    m.finish()
    out = buf.getvalue()
    assert "100.00%" in out
    assert "bp/s" in out


def test_progress_meter_unsized():
    # total<=0 => unsized meter (non-tty, no .fai): counts, no percent
    buf = io.StringIO()
    m = ProgressMeter(0, "[x] mapped", stream=buf, interval=0.01)
    m.increment(1234)
    time.sleep(0.05)
    m.finish()
    out = buf.getvalue()
    assert "%" not in out
    assert "1234 bp" in out


def test_progress_meter_rises_during_run():
    # the meter must move with increments, not only at finish
    # (reference increments per sequence: computeMap.hpp:638,
    # progress.hpp:25-55)
    buf = io.StringIO()
    m = ProgressMeter(1000, "[x] mapped", stream=buf, interval=0.01)
    m.increment(250)
    deadline = time.time() + 2.0     # poll: fixed sleeps are flaky
    mid = ""
    while time.time() < deadline and "25.00%" not in mid:
        time.sleep(0.02)
        mid = buf.getvalue()
    m.increment(750)
    m.finish()
    assert "25.00%" in mid
    assert "100.00%" in buf.getvalue()
