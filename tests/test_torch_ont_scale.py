"""The reads mode of scripts/flagship_torch.py (BASELINE.json's
configuration 3, ONT-shaped reads against one reference at MashMap's
defaults): the read generator, the origin each read's name carries, the
truth gate, and the mode end to end on the CPU against the JAX
package's PAF."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from mashmap_tpu.api import map_files as jax_map_files
from mashmap_tpu.params import Parameters as JaxParameters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import flagship_torch  # noqa: E402
from gen_flagship_data import write_record  # noqa: E402
from genomes import revcomp  # noqa: E402
from port_fixtures import jax_native_reader, one_torch_thread  # noqa

# chromosome lengths of the small reference: one too short for any read,
# one that holds exactly the longest, and three longer
CHROMS = (("chrA", 120_000), ("chrShort", 9_000), ("chrB", 29_999),
          ("chrC", 260_000), ("chrD", 200_000))


def _write_ref(path, chroms=CHROMS, seed=5):
    """A reference in gen_flagship_data.py's layout (80-column records of
    random bases); returns {name: sequence}."""
    rng = np.random.default_rng(seed)
    seqs = {}
    with open(path, "wb") as fh:
        for name, n in chroms:
            idx = rng.integers(0, 4, size=n, dtype=np.uint8)
            write_record(fh, name, idx)
            seqs[name] = np.frombuffer(b"ACGT", np.uint8)[idx].tobytes() \
                .decode()
    return seqs


def _read_fasta(path):
    recs, name = {}, None
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                name = line[1:]
                recs[name] = []
            else:
                recs[name].append(line)
    return {n: "".join(v) for n, v in recs.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ont_ref") / "ref.fa")
    return path, _write_ref(path)


@pytest.mark.parametrize("width", [80, 60, 7])
def test_fasta_layout_and_window_match_the_parsed_file(tmp_path, width):
    """fasta_layout finds each record's name, first base and length, and
    window slices bases out of it, as a parse of the whole file gives
    them, at line widths that do and do not divide the lengths."""
    rng = np.random.default_rng(width)
    seqs = {f"c{i} desc": "".join(rng.choice(list("ACGT"), n))
            for i, n in enumerate((1, width, width + 1, 3 * width - 1,
                                   1000))}
    path = str(tmp_path / "x.fa")
    with open(path, "w") as fh:
        for name, seq in seqs.items():
            fh.write(f">{name}\n")
            fh.write("".join(seq[j:j + width] + "\n"
                             for j in range(0, len(seq), width)))
    layout = flagship_torch.fasta_layout(path)
    assert [(r[0], r[2]) for r in layout] == \
        [(n.split()[0], len(s)) for n, s in seqs.items()]
    with open(path, "rb") as fh:
        mm = fh.read()
    for rec, seq in zip(layout, seqs.values()):
        n = len(seq)
        for a, b in ((0, n), (0, 1), (n - 1, n), (n // 3, n - n // 4)):
            if a < b:
                assert flagship_torch.window(mm, rec, a, b) == seq[a:b]


def test_write_reads_deterministic_inside_chromosomes_half_minus(ref,
                                                                 tmp_path):
    """The same seed writes the same bytes, another seed others; every
    read lies inside one chromosome that can hold it, is 10-30 kb long
    at its origin, comes from there (most of its 15-mers are the
    origin's, on its strand) and exactly half are reverse-complemented."""
    path, seqs = ref
    n = 40
    outs = [str(tmp_path / f"r{i}.fa") for i in range(3)]
    for out, seed in zip(outs, (7, 7, 8)):
        bp = flagship_torch.write_reads(path, n, seed, out)
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b, \
            open(outs[2], "rb") as c:
        first, second, other = a.read(), b.read(), c.read()
    assert first == second and first != other
    reads = _read_fasta(outs[2])
    assert len(reads) == n and sum(map(len, reads.values())) == bp
    strands = []
    for i, (name, seq) in enumerate(reads.items()):
        assert name.startswith(f"read{i}:")
        chrom, a, b, strand = flagship_torch.read_origin(name)
        assert chrom in ("chrA", "chrC", "chrD")
        assert 0 <= a and b <= len(seqs[chrom])
        assert flagship_torch.READ_LEN[0] <= b - a < \
            flagship_torch.READ_LEN[1]
        # 5% divergence: within 1% of the window's length, and most
        # 15-mers shared with the origin on the read's strand
        assert abs(len(seq) - (b - a)) <= 0.01 * (b - a)
        fwd = seq if strand == "+" else revcomp(seq)
        kmers = {fwd[j:j + 15] for j in range(len(fwd) - 14)}
        origin = seqs[chrom][a:b]
        shared = sum(origin[j:j + 15] in kmers
                     for j in range(0, len(origin) - 14, 7))
        assert shared > 0.3 * (len(origin) - 14) / 7
        strands.append(strand)
    assert strands.count("-") == n // 2 and strands.count("+") == n - n // 2


def test_write_reads_needs_a_chromosome_that_holds_a_read(tmp_path):
    """A reference whose chromosomes are all shorter than the read raises
    instead of reading across an end."""
    path = str(tmp_path / "short.fa")
    _write_ref(path, (("c1", 9_000), ("c2", 9_999)))
    with pytest.raises(ValueError, match="no chromosome holds"):
        flagship_torch.write_reads(path, 3, 1, str(tmp_path / "r.fa"))


@pytest.mark.parametrize("name,want", [
    ("read0:chr1:0-10000:+", ("chr1", 0, 10000, "+")),
    ("read17:chrX:123456-150000:-", ("chrX", 123456, 150000, "-")),
    ("read3:HLA:A:1-25000:+", ("HLA:A", 1, 25000, "+")),
])
def test_read_origin_parses_back(name, want):
    """The origin in a read's name parses back, chromosome names with a
    colon included."""
    assert flagship_torch.read_origin(name) == want


def _paf(q, strand, t, ts, te):
    return "\t".join([q, "20000", "0", "20000", strand, t, "999999",
                      str(ts), str(te), "10", "20000", "60"])


def test_truth_gate_counts_a_hand_made_paf():
    """A read counts for the truth gate when one of its rows is on its
    origin chromosome and strand and overlaps its origin interval (half
    open, so touching is not overlapping); any row counts it mapped."""
    names = [f"read{i}:chr1:1000-21000:{'+' if i % 2 else '-'}"
             for i in range(7)]
    rows = [
        _paf(names[0], "-", "chr1", 20_999, 40_000),   # right, 1 bp in
        _paf(names[1], "-", "chr1", 1000, 21_000),     # wrong strand
        _paf(names[2], "-", "chr2", 1000, 21_000),     # wrong chromosome
        _paf(names[3], "+", "chr1", 21_000, 41_000),   # touches the end
        _paf(names[3], "+", "chr1", 0, 1000),          # touches the start
        _paf(names[4], "-", "chr2", 1000, 21_000),     # one wrong row ...
        _paf(names[4], "-", "chr1", 5000, 9000),       # ... one right
        _paf(names[5], "+", "chr1", 0, 1001),          # right, 1 bp in
    ]                                                  # read6: no row
    truth, mapped = flagship_torch.truth_shares(names, rows)
    assert truth == pytest.approx(3 / 7)
    assert mapped == pytest.approx(6 / 7)
    assert flagship_torch.truth_shares(names[:1], rows[:1]) == (1.0, 1.0)


def test_theta_check_record_on_cpu(capsys):
    """theta_check's record on small rows: both routes are the plain
    version on the CPU, so they agree; the bound is the larger of the
    rows' byte and operation times; nothing goes to stdout, which holds
    the script's JSON lines."""
    rng = np.random.default_rng(3)
    cur, nxt = (torch.from_numpy(rng.integers(0, 2000, (4, 500))
                                 .astype(np.int32)) for _ in range(2))
    rec = flagship_torch.theta_check(
        torch.device("cpu"), {"cur": cur, "nxt": nxt, "s": 30, "s_b": 500})
    assert (rec["rows"], rec["S_B"], rec["s"]) == (4, 500, 30)
    assert rec["max_abs_err"] == 0 and rec["library_ms"] is None
    assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes",
                                                       "operations")
    assert rec["ms"] > 0 and rec["plain_ms"] > 0
    assert capsys.readouterr().out == ""


def test_reads_mode_paf_identical_to_jax(ref, tmp_path, monkeypatch,
                                         capsys):
    """flagship_torch.py --reads 20 -J 64 --device cpu: the reads file,
    the resident build, the cutoff table (cold), the map and the truth
    gate; its PAF is the JAX package's map_files PAF on the same files,
    byte for byte."""
    path, _ = ref
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("MASHMAP_TPU_FLAGSHIP_REF", path)
    monkeypatch.setenv("MASHMAP_TPU_FLAGSHIP_OUT", str(tmp_path / "o.paf"))
    reads = flagship_torch.reads_path(path, 20, flagship_torch.READS_SEED)
    if os.path.exists(reads):
        os.remove(reads)
    rc = flagship_torch.main(["--device", "cpu", "--reads", "20", "-J",
                              "64"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert [r["phase"] for r in recs] == ["reads", "build", "cutoff table",
                                          "map"]
    got, build, table, mapped = recs
    assert got["count"] == 20 and os.path.exists(reads)
    assert (build["k"], build["w"], build["s"], build["pi"]) == \
        (19, 5000, 64, 0.85)
    assert "save_s" not in build and "theta_check" not in build
    assert build["theta_rows"] == sum(c[0] for c in
                                      build["theta_calls_rows_s_ms"]) > 0
    assert build["theta_bytes_bound_ms"] == pytest.approx(
        1e3 * 12 * build["theta_rows"] * 4982 / 3.35e12)
    assert not table["on_disk_before"] and table["s"] == 64
    assert mapped["reads"] == 20 and mapped["query_bp"] == got["bp"]
    assert mapped["filter_mode"] == 1
    assert mapped["truth"] >= flagship_torch.MIN_TRUTH
    assert mapped["path_stats"]["host_frags"] == 0
    assert mapped["host_route_s_a_fragment"] is None
    out = str(tmp_path / "jax.paf")
    jax_map_files(JaxParameters(
        ref_sequences=[path], query_sequences=[reads], out_file_name=out,
        percentage_identity=0.85, sketch_size=64, no_progress=True))
    with open(out) as a, open(tmp_path / "o.paf") as b:
        want = a.read()
        assert b.read() == want
    assert want.count("\n") == mapped["paf_rows"] >= 20


def test_reads_mode_flags():
    """--pi and -J belong to the reads mode."""
    with pytest.raises(SystemExit):
        flagship_torch.main(["--device", "cpu", "--pi", "0.9"])
