"""The ALTs mode of scripts/flagship_torch.py (BASELINE.json's
configuration 5: a human assembly against a --rl list of the reference
and its alternate contigs, the index sharded): the ALT generator, the
whole-contig cut from a named contig, and, on a small list, the JAX
package's build and PAF against the port's replicated, 2-shard and
4-shard maps, its CLI with a --rl file and the mode end to end on the
CPU."""

import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import pytest

from mashmap_tpu.api import map_files as jax_map_files
from mashmap_tpu.params import Parameters as JaxParameters
from mashmap_tpu_torch import api, cli
from mashmap_tpu_torch.api import build_or_load_index, map_files
from mashmap_tpu_torch.index.builder import ReferenceIndex
from mashmap_tpu_torch.params import Parameters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import flagship_torch  # noqa: E402
from gen_flagship_data import write_record  # noqa: E402
from genomes import mutate  # noqa: E402
from port_fixtures import jax_native_reader, one_torch_thread  # noqa

FIELDS = ("lengths", "uniq_hashes", "post_offsets", "post_seqid",
          "post_wpos", "post_wend", "mi_rank", "mi_seqid", "mi_wpos",
          "mi_wend", "mi_strand", "is_frequent")
# the small list's ALTs: 0.3% of GRCh38's 109 Mbp (327 kbp, 9 bp to 7.9
# kbp each); the query is the assembly and a contig of the haplotype of
# the longest ALT (HAP_DIVERGENCE from it), whose rows are on that ALT;
# the maps run at MashMap's --pi 85 with a narrow sketch
MAP_SCALE = 0.003
HAP_DIVERGENCE = 0.002
S = 64
PI = 0.85


def _write_pair(tmp, chroms=(150_000, 200_000, 120_000), seed=16):
    """A reference in gen_flagship_data.py's layout and its assembly
    (2.5% SNPs, whole contigs of 60-120 kbp); returns (reference,
    assembly, {chromosome: sequence}, [(contig, bases)])."""
    rng = np.random.default_rng(seed)
    ref, asm = str(tmp / "ref.fa"), str(tmp / "asm.fa")
    seqs, contigs = {}, []
    with open(ref, "wb") as rf, open(asm, "wb") as af:
        for c, n in enumerate(chroms):
            idx = rng.integers(0, 4, size=n, dtype=np.uint8)
            write_record(rf, f"chr{c + 1}", idx)
            seqs[f"chr{c + 1}"] = np.frombuffer(b"ACGT", np.uint8)[idx] \
                .tobytes().decode()
            mut = rng.random(n) < 0.025
            a = idx.copy()
            a[mut] = (a[mut] + rng.integers(1, 4, size=int(mut.sum()),
                                            dtype=np.uint8)) % 4
            pos = k = 0
            while pos < n:
                clen = min(int(rng.integers(60_000, 120_001)), n - pos)
                write_record(af, f"asm_chr{c + 1}_ctg{k}", a[pos:pos + clen])
                contigs.append((f"asm_chr{c + 1}_ctg{k}", clen))
                pos += clen
                k += 1
    return ref, asm, seqs, contigs


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


def _edit_distance(a, b):
    """Levenshtein distance of two strings, one numpy row at a time (the
    left move as a running minimum of cost - column)."""
    a = np.frombuffer(a.encode(), np.uint8)
    b = np.frombuffer(b.encode(), np.uint8)
    col = np.arange(len(b) + 1)
    prev = col.copy()
    for i in range(1, len(a) + 1):
        x = np.minimum(prev[:-1] + (b != a[i - 1]), prev[1:] + 1)
        prev = np.minimum.accumulate(np.concatenate([[i], x]) - col) + col
    return int(prev[-1])


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _write_pair(tmp_path_factory.mktemp("alt_pair"))


def test_write_alts_deterministic_shaped_and_one_percent_off(pair,
                                                             tmp_path):
    """The same seed writes the same bytes, another seed others; 261
    contigs summing to 109 Mbp x scale (within 1%), each named after an
    interval that lies inside its chromosome, its length that of the
    interval within the indels, and about 1% from it (edit distance)."""
    ref, _, seqs, _ = pair
    scale = 0.01
    outs = [str(tmp_path / f"a{i}.fa") for i in range(3)]
    for out, seed in zip(outs, (261, 261, 262)):
        bp = flagship_torch.write_alts(ref, seed, out, scale)
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b, \
            open(outs[2], "rb") as c:
        first, second, other = a.read(), b.read(), c.read()
    assert first == second and first != other
    alts = _read_fasta(outs[2])
    assert len(alts) == flagship_torch.ALTS_COUNT == 261
    assert sum(map(len, alts.values())) == bp
    assert abs(bp - 109e6 * scale) <= 0.01 * 109e6 * scale
    checked = 0
    for i, (name, seq) in enumerate(alts.items()):
        chrom, a, b = flagship_torch.alt_origin(name)
        assert name.startswith(f"{chrom}_alt{i}:")
        assert 0 <= a < b <= len(seqs[chrom])
        assert abs(len(seq) - (b - a)) <= max(2, 0.002 * (b - a))
        if 4_000 <= b - a <= 12_000 and checked < 4:
            d = _edit_distance(seqs[chrom][a:b], seq) / (b - a)
            assert 0.005 <= d <= 0.015, (name, d)
            checked += 1
    assert checked == 4


@pytest.mark.parametrize("name,want", [
    ("chr1_alt0:0-5000", ("chr1", 0, 5000)),
    ("chrX_alt260:123-4567", ("chrX", 123, 4567)),
    ("HLA_alt_x_alt3:10-20", ("HLA_alt_x", 10, 20)),
])
def test_alt_origin_parses_back(name, want):
    """The interval in an ALT's name parses back, chromosome names that
    hold "_alt" included."""
    assert flagship_torch.alt_origin(name) == want


@pytest.mark.parametrize("first,mbp", [
    (None, 0.05),
    ("asm_chr1_ctg1", 0.05),
    ("asm_chr2_ctg0", 0.2),
    ("asm_chr2_ctg0", 10.0),
    ("no_such_contig", 10.0),
])
def test_subset_from_a_named_contig(pair, tmp_path, first, mbp):
    """The cut is the assembly's contigs byte for byte, in file order, from
    the one named (the first by default) until their bases reach the size
    (all the rest when the size is over them; none when the name is not
    in the file)."""
    _, asm, _, contigs = pair
    src = str(tmp_path / "asm.fa")
    with open(asm, "rb") as a, open(src, "wb") as b:
        b.write(a.read())
    names = [n for n, _ in contigs]
    start = names.index(first) if first in names else len(names)
    if first is None:
        start = 0
    gbp = mbp / 1e3
    cum = np.cumsum([n for _, n in contigs[start:]])
    want = min(int(np.searchsorted(cum, gbp * 1e9)) + 1, len(cum))
    out, n_ctg, n_bp = flagship_torch.write_subset(src, gbp, first)
    assert out == str(tmp_path / f"asm_{first + '_' if first else ''}"
                                 f"{gbp:g}g.fa")
    assert (n_ctg, n_bp) == (want, int(cum[want - 1]) if want else 0)
    with open(out, "rb") as a, open(src, "rb") as b:
        assert a.read().split(b">")[1:] == \
            b.read().split(b">")[1:][start:start + want]


@pytest.fixture(scope="module")
def rl(pair, tmp_path_factory):
    """The small --rl list (the reference, then its ALTs at MAP_SCALE) and
    its file; the query (the assembly, then the longest ALT's haplotype
    contig) and the names of the ALTs; the JAX package's map_files PAF of
    the query against the list at --pi 85 -J S and the index that run
    built; the port's build of the list on the CPU."""
    ref, asm, _, _ = pair
    tmp = tmp_path_factory.mktemp("alt_rl")
    alts = str(tmp / "alts.fa")
    flagship_torch.write_alts(ref, flagship_torch.ALTS_SEED, alts,
                              MAP_SCALE)
    rl_file = str(tmp / "refs.txt")
    with open(rl_file, "w") as fh:
        fh.write(f"{ref}\n{alts}\n")
    alt_seqs = _read_fasta(alts)
    longest = max(alt_seqs, key=lambda n: len(alt_seqs[n]))
    query = str(tmp / "asm_hap.fa")
    with open(asm) as a, open(query, "w") as q:
        q.write(a.read())
        q.write(f">asm_althap_ctg0\n"
                f"{mutate(alt_seqs[longest], HAP_DIVERGENCE, seed=2)}\n")
    out = str(tmp / "jax.paf")
    kw = dict(ref_sequences=[ref, alts], percentage_identity=PI,
              sketch_size=S, no_progress=True)
    jax_idx = jax_map_files(JaxParameters(query_sequences=[query],
                                          out_file_name=out, **kw))
    with open(out) as fh:
        paf = fh.read()
    return {"refs": [ref, alts], "file": rl_file, "query": query,
            "alt_names": set(alt_seqs), "longest": longest, "paf": paf,
            "jax_index": jax_idx,
            "index": build_or_load_index(Parameters(**kw).finalize(),
                                         "cpu")}


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_rl_maps_replicated_and_sharded_equal_jax(pair, rl, tmp_path,
                                                  shards):
    """The port's map_files with its index of the list, replicated on
    ["cpu"] and split by shard_index over ["cpu"] * 2 and * 4 (the shard
    count asserted), writes the JAX package's PAF byte for byte: a row
    for each query contig, the haplotype contig's on its ALT."""
    _, _, _, contigs = pair
    want = rl["paf"]
    out = str(tmp_path / "o.paf")
    p = Parameters(ref_sequences=rl["refs"], query_sequences=[rl["query"]],
                   out_file_name=out, percentage_identity=PI,
                   sketch_size=S, shard_index=shards > 1, no_progress=True)
    got = []
    real = api.Mapper.run

    def run(self, *a, **kw):
        got.append(self)
        return real(self, *a, **kw)
    api.Mapper.run = run
    try:
        map_files(p, index=rl["index"], devices=["cpu"] * shards)
    finally:
        api.Mapper.run = real
    si = got[0]._sharded
    assert (si.n_shards if si is not None else 1) == shards
    with open(out) as fh:
        assert fh.read() == want
    rows = [ln.split("\t") for ln in want.splitlines()]
    assert {r[0] for r in rows} == {n for n, _ in contigs} | \
        {"asm_althap_ctg0"}
    assert {r[5] for r in rows if r[5] in rl["alt_names"]} == \
        {rl["longest"]}


def test_rl_cli_list_file_equals_jax(pair, rl, tmp_path):
    """The port's CLI with --rl naming the list file writes the JAX
    package's PAF."""
    out = str(tmp_path / "cli.paf")
    assert cli.main(["--rl", rl["file"], "-q", rl["query"], "--pi", "85",
                     "-J", str(S), "-o", out], device="cpu") == 0
    with open(out) as fh:
        assert fh.read() == rl["paf"]


def test_jax_build_of_the_list_equals_port_build(rl):
    """The JAX package's build of the list, taken into the port's
    ReferenceIndex through from_numpy, equals the port's build array for
    array: the reference's contigs, then the ALTs'."""
    a = ReferenceIndex.from_numpy(dataclasses.asdict(rl["jax_index"]))
    b = rl["index"]
    assert a.names == b.names
    assert len(b.names) == 3 + flagship_torch.ALTS_COUNT
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert (a.freq_threshold, a.kmer_size, a.window_size, a.sketch_size) \
        == (b.freq_threshold, b.kmer_size, b.window_size, b.sketch_size)


def _alts_env(ref, asm, tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("MASHMAP_TPU_FLAGSHIP_REF", ref)
    monkeypatch.setenv("MASHMAP_TPU_FLAGSHIP_ASM", asm)
    monkeypatch.setenv("MASHMAP_TPU_FLAGSHIP_OUT", str(tmp_path / "o.paf"))


def test_alts_mode_end_to_end_on_cpu(pair, rl, tmp_path, monkeypatch,
                                     capsys):
    """flagship_torch.py --alts --device cpu: the ALTs, the resident build
    of the list (the reference's contigs and the 261 ALTs), the cutoff
    table, and the replicated, 2-shard and 4-shard maps, each the JAX
    package's PAF and the shards it asked for; exit 0."""
    _alts_env(pair[0], rl["query"], tmp_path, monkeypatch)
    rc = flagship_torch.main(["--alts", "--device", "cpu", "--alts-scale",
                              str(MAP_SCALE), "-J", str(S)])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert [r["phase"] for r in recs] == [
        "alts", "build", "build host memory", "cutoff table",
        "map shards=1", "map shards=2", "map shards=4", "alts gates"]
    alts, build = recs[:2]
    assert (alts["count"], alts["scale"]) == (261, MAP_SCALE)
    assert (build["k"], build["w"], build["s"], build["pi"]) == \
        (19, 5000, S, PI)
    assert build["contigs"] == 3 + 261 and build["int32_room"]["fits"]
    want = hashlib.sha256(rl["paf"].encode()).hexdigest()
    for n, rec in zip((1, 2, 4), recs[4:7]):
        assert rec["n_shards"] == n and rec["devices"] == ["cpu"] * n
        assert rec["paf_sha256"] == want and not rec["coverage_below_gate"]
        assert rec["alt_rows"] >= 1
        assert rec["peak_rss_in_phase"] > 0
        assert ("shard_bytes" in rec) == (n > 1)
        if n > 1:
            assert len(rec["shard_bytes"]) == n
            assert sum(rec["postings_a_shard"]) == len(
                rl["index"].post_seqid)
            assert max(rec["postings_a_shard"]) <= rec["p_shard"]
    assert recs[-1] == {"phase": "alts gates", "pafs_identical": True,
                        "contigs": 264, "primary_contigs": 3,
                        "contigs_ok": True}


def test_alts_mode_exits_1_when_a_sharded_map_ran_replicated(
        pair, tmp_path, monkeypatch, capsys):
    """When the device list reaches the Mapper with one entry, the map
    asked for 2 shards warns and runs replicated: the mode says so and
    exits 1."""
    _alts_env(pair[0], pair[1], tmp_path, monkeypatch)
    real = api.make_mesh
    monkeypatch.setattr(api, "make_mesh", lambda d: real(d)[:1])
    rc = flagship_torch.main(["--alts", "--device", "cpu", "--alts-scale",
                              str(MAP_SCALE), "-J", str(S), "--shards",
                              "2"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 1
    assert recs[-2]["phase"] == "map shards=2"
    assert recs[-2]["n_shards"] == 1 and "shard_bytes" not in recs[-2]


def test_alts_mode_needs_a_card_or_cpu(monkeypatch):
    """Without a card and without --device cpu the mode does not run."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship_torch.main(["--alts"])
