"""The generators: deterministic per seed, with the stated shapes."""

import json
import os

import numpy as np
import torch

from benchmark import run
from benchmark.gen import fasta, hg38, yeast

YEAST = run.load_json(os.path.join(run.HERE, "configs", "yeast8-pi85.json"))
HG38 = run.load_json(os.path.join(run.HERE, "configs", "hg38-asm-pi95.json"))
HG38_CELL = run.load_json(os.path.join(run.HERE, "workloads",
                                       "hg38-asm-pi95.resident-map.json"))


def test_yeast_shape_and_truth_map():
    shape = YEAST["shape"]
    assert sum(n for _, n in shape["chromosomes"]) == 12_071_326
    g = yeast.make(2**31 + 11, shape, scale=0.01)
    again = yeast.make(2**31 + 11, shape, scale=0.01)
    other = yeast.make(5, shape, scale=0.01)
    assert len(g.records) == 8 * 16
    assert all(np.array_equal(a[1], b[1])
               for a, b in zip(g.records, again.records))
    assert not np.array_equal(g.records[0][1], other.records[0][1])
    base = dict(g.records)
    for name, seq in g.records:
        assert set(np.unique(seq).tobytes()) <= set(b"ACGT")
        m = g.base_of[name]
        if g.hap(name) == "S1":
            assert m is None
            continue
        b = base[f"S1#1#{g.chrom(name)}"]
        assert len(m) == len(seq) + 1 and np.all(np.diff(m) >= 0)
        assert m[-1] == len(b)
        # the truth map carries each haplotype base to its base position:
        # they agree but for the substitutions (0.9%) and inserted bases
        same = np.mean(seq == b[np.minimum(m[:-1], len(b) - 1)])
        assert 0.97 < same < 0.999
        assert abs(len(seq) - len(b)) <= 0.002 * len(b) + 5


def test_yeast_projection_between_haplotypes():
    g = yeast.make(9, YEAST["shape"], scale=0.01)
    q, t = "S3#1#chrIV", "S5#1#chrIV"
    pos = np.arange(0, len(dict(g.records)[q]), 997)
    got = g.project(q, pos, t)
    assert np.all(np.diff(got) >= 0)
    assert np.max(np.abs(got - pos)) < 200


def test_hg38_shape_and_determinism():
    shape = dict(HG38["shape"], **HG38_CELL["params"])
    assert sum(m for _, m in shape["chromosomes_mbp"]) == 3085
    scale = 0.0005
    h = hg38.make(2**31 + 7, shape, torch.device("cpu"), scale=scale)
    h2 = hg38.make(2**31 + 7, shape, torch.device("cpu"), scale=scale)
    assert [n for n, _ in h.query] == [n for n, _ in h2.query]
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(h.query, h2.query))
    ref = dict(h.reference)
    assert [n for n, _ in h.reference][:2] == ["chr1", "chr2"]
    assert len(ref["chr1"]) == int(248e6 * scale)
    total = sum(len(s) for _, s in h.query)
    assert total <= shape["query_bp"] * scale
    assert total > 0.9 * shape["query_bp"] * scale
    assert len({h.origin[n][0] for n, _ in h.query}) > 12
    for name, seq in h.query:
        chrom, start = h.origin[name]
        piece = ref[chrom][start:start + len(seq)]
        assert len(piece) == len(seq)
        snp = np.mean(piece != seq)
        assert snp < 0.06
        assert len(seq) <= shape["contig_bp"][1] * scale
    assert h.fasta_bytes == sum(fasta.record_bytes(n, len(s))
                                for n, s in h.reference)


def test_hg38_tiles_cover_each_chromosome():
    chroms = hg38.chromosomes(HG38["shape"], 0.001)
    tiles = hg38.tiles(3, chroms, 2000, 8000)
    for ci, (_, n) in enumerate(chroms):
        mine = [t for t in tiles if t[0] == ci]
        assert mine[0][1] == 0
        assert sum(t[2] for t in mine) == n
        assert all(a[1] + a[2] == b[1] for a, b in zip(mine, mine[1:]))


def test_fasta_bytes_match_what_is_written(tmp_path):
    recs = [("a", np.frombuffer(b"ACGT" * 41, np.uint8)),
            ("bb", np.frombuffer(b"A" * 160, np.uint8))]
    path = tmp_path / "x.fa"
    n = fasta.write_fasta(str(path), recs)
    assert n == os.path.getsize(path) == sum(
        fasta.record_bytes(nm, len(s)) for nm, s in recs)
    lines = path.read_text().splitlines()
    assert lines[0] == ">a" and len(lines[1]) == 80 and lines[3] == "ACGT"
    assert json.dumps(lines[-1]) == json.dumps("A" * 80)
