"""The port's native C++ FASTA/FASTQ reader against its Python parser and
the JAX package's reader; the prefetching reader thread; a failing run
that must not hang on it. The Python parser is reached by patching the
reader's loader to report no library."""

import gzip
import logging
import os
import subprocess
import sys
import threading

import pytest

from mashmap_tpu.io.fasta import for_each_seq_in_file as jax_read
from mashmap_tpu_torch import native
from mashmap_tpu_torch.io import fasta
from mashmap_tpu_torch.kernels.kmers import sanitize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(__file__))
from port_fixtures import jax_native_reader  # noqa: E402,F401


@pytest.fixture(scope="module")
def have_native():
    if not native.native_available():
        pytest.skip("no C++ toolchain for the native reader")


def _sanitized(records):
    return [(n, sanitize(s.encode()).tobytes().decode() if s else "")
            for n, s in records]


def _write(path, text, gz=False):
    with (gzip.open(path, "wt") if gz else open(path, "w")) as fh:
        fh.write(text)
    return str(path)


CASES = {
    "fasta": ("t.fa", ">one desc here\nACGTacgtNNxy\nACGT\n>two\n\n"
              ">three\nTTTT\n", False,
              [("one", "ACGTACGTNNNN" + "ACGT"), ("two", ""),
               ("three", "TTTT")]),
    "fastq_gz": ("t.fq.gz", "@r1 extra\nACGTN\n+\n!!!!!\n@r2\nttgg\n+r2\n"
                 "####\n", True, [("r1", "ACGTN"), ("r2", "TTGG")]),
    "fasta_gz": ("t.fa.gz", ">a\nAC\nGT\n>b x\nNNac\n", True,
                 [("a", "ACGT"), ("b", "NNAC")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_equals_python_and_jax(tmp_path, have_native, monkeypatch,
                                      case):
    name, text, gz, want = CASES[case]
    p = _write(tmp_path / name, text, gz)
    nat = list(native.read_records(p))
    assert nat == want
    assert list(fasta.for_each_seq_in_file(p)) == nat
    assert _sanitized(jax_read(p)) == nat
    monkeypatch.setattr(native, "_load_fastaread", lambda: None)
    assert _sanitized(fasta.for_each_seq_in_file(p)) == nat


def test_multiline_quality_fastq(tmp_path, have_native):
    p = _write(tmp_path / "m.fq",
               "@a\nACGTACGT\n+\n!!!!\n!!!!\n@b\nGG\n+\n!!\n")
    want = [("a", "ACGTACGT"), ("b", "GG")]
    assert list(native.read_records(p)) == want
    assert list(fasta.for_each_seq_in_file(p)) == want
    assert list(jax_read(p)) == want


def test_keep_set_and_prefix_yield_empty(tmp_path, have_native,
                                         monkeypatch):
    """Non-kept records still come, with an empty sequence, on both
    parsers and in the JAX package."""
    p = _write(tmp_path / "k.fa", ">x#1\nAAAA\n>y#1\nCCCC\n>x#2\nGGGG\n")
    for kw in ({"keep_seq": {"y#1", "x#2"}}, {"keep_prefix": "x#"}):
        want = list(jax_read(p, **kw))
        assert list(fasta.for_each_seq_in_file(p, **kw)) == want
        with monkeypatch.context() as mp:
            mp.setattr(native, "_load_fastaread", lambda: None)
            assert list(fasta.for_each_seq_in_file(p, **kw)) == want
    assert [s for _, s in fasta.for_each_seq_in_file(
        p, keep_prefix="x#")] == ["AAAA", "", "GGGG"]


def test_unbuildable_native_falls_back_with_a_warning(tmp_path, monkeypatch,
                                                      caplog):
    """Without a compiler the reader logs a warning once and the Python
    parser reads the file."""
    def no_compiler(*a, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    p = _write(tmp_path / "f.fa", ">a\nACGT\n")
    with caplog.at_level(logging.WARNING, "mashmap_tpu_torch.native"):
        assert list(fasta.for_each_seq_in_file(p)) == [("a", "ACGT")]
        assert not native.native_available()
    assert sum("native reader build unavailable" in r.message
               for r in caplog.records) == 1


@pytest.mark.parametrize("max_bytes", [1, 1 << 20])
def test_prefetch_reader_yields_the_same_stream(tmp_path, max_bytes):
    files = [_write(tmp_path / f"{i}.fa",
                    "".join(f">s{i}_{j}\n{'ACGT' * (j + 1)}\n"
                            for j in range(40))) for i in range(3)]
    want = [rec for f in files for rec in fasta.for_each_seq_in_file(f)]
    r = fasta.PrefetchReader(files, maxsize=4, max_bytes=max_bytes)
    assert list(r) == want
    assert not r._t.is_alive()


def test_prefetch_reader_close_joins_a_half_read_thread(tmp_path):
    f = _write(tmp_path / "big.fa",
               "".join(f">s{j}\nACGTACGT\n" for j in range(500)))
    r = fasta.PrefetchReader([f], maxsize=2)
    it = iter(r)
    assert next(it) == ("s0", "ACGTACGT")
    r.close()
    assert not r._t.is_alive()


def test_prefetch_reader_surfaces_a_read_error(tmp_path):
    bad = _write(tmp_path / "bad.txt", "not a sequence file\n")
    with pytest.raises(ValueError, match="unknown file format"):
        list(fasta.PrefetchReader([bad]))


@pytest.mark.parametrize("ref", ["missing", "malformed"])
def test_map_files_failing_build_raises_without_hanging(tmp_path, ref):
    """The reference cannot be read while the query reader thread holds a
    full queue: map_files raises and the process exits (the reader is
    closed), well inside the time limit."""
    q = _write(tmp_path / "q.fa",
               "".join(f">q{j}\n{'ACGT' * 30}\n" for j in range(1000)))
    r = str(tmp_path / "r.fa")
    if ref == "malformed":
        _write(r, "not a sequence file\n")
    code = (
        "import sys\n"
        "from mashmap_tpu_torch.api import map_files\n"
        "from mashmap_tpu_torch.params import Parameters\n"
        f"p = Parameters(ref_sequences=[{r!r}], query_sequences=[{q!r}],\n"
        f"    out_file_name={str(tmp_path / 'o.paf')!r}, kmer_size=11,\n"
        "    seg_length=500, sketch_size=8, reference_size=1000,\n"
        "    no_progress=True)\n"
        "try:\n"
        "    map_files(p, device='cpu')\n"
        "except (FileNotFoundError, ValueError) as e:\n"
        "    print('raised', type(e).__name__)\n"
        "    sys.exit(3)\n")
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 3, res.stderr[-2000:]
    assert "raised" in res.stdout


def test_concurrent_first_use_builds_once(tmp_path, have_native,
                                          monkeypatch):
    """The query reader thread and the index build reach the reader at
    once on a fresh build directory: both get the library."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        native.native_available())) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert got == [True] * 4
    assert len(os.listdir(tmp_path / "build")) == 1
