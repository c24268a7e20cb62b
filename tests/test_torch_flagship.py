"""The human-scale path of the port at a small size, against the JAX
package: the auto sketch size across the binary's int32 wrap of the
reference size, --saveIndex then --loadIndex on a pair in the shape of
scripts/gen_flagship_data.py's (chromosomes, 2.5% SNPs, whole contigs of
an assembly), and scripts/flagship_torch.py end to end on the CPU."""

import json
import os
import sys

import numpy as np
import pytest

from mashmap_tpu.api import map_files as jax_map_files
from mashmap_tpu.index.builder import ReferenceIndex as JaxReferenceIndex
from mashmap_tpu.params import Parameters as JaxParameters
from mashmap_tpu_torch.api import map_files
from mashmap_tpu_torch.index.builder import ReferenceIndex, _NPZ_FIELDS
from mashmap_tpu_torch.params import Parameters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import flagship_torch  # noqa: E402
from gen_flagship_data import write_record  # noqa: E402
from port_fixtures import jax_native_reader, one_torch_thread  # noqa

# the generator's full-scale reference: chromosome lengths (Mbp) and
# 80-column lines, so its file size is what finalize() sees
GEN_CHR_MBP = (248, 242, 198, 190, 182, 171, 159, 145, 138, 134, 135, 133,
               114, 107, 102, 90, 83, 80, 59, 64, 47, 51, 156, 57)


def _fasta_bytes(lengths, names):
    return sum(len(f">{nm}\n") + n + -(-n // 80)
               for nm, n in zip(names, lengths))


HG3G_BYTES = _fasta_bytes(
    [int(m * 1e6) for m in GEN_CHR_MBP],
    [f"chr{i + 1}" for i in range(22)] + ["chrX", "chrY"])


@pytest.mark.parametrize("size", [
    (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
    (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
    3_080_000_000, HG3G_BYTES])
@pytest.mark.parametrize("exact", [False, True])
def test_auto_params_across_the_int32_wrap(size, exact):
    """finalize() gives the JAX package's k, w and s at reference sizes
    around 2^31 and 2^32 and at the human-scale one, with the binary's
    int32 wrap (the default) and without it (--exactRefSize)."""
    got = [P(reference_size=size, percentage_identity=0.95,
             exact_ref_size=exact).finalize()
           for P in (Parameters, JaxParameters)]
    port, jax = ((p.kmer_size, p.seg_length, p.sketch_size) for p in got)
    assert port == jax
    if size in (3_080_000_000, HG3G_BYTES) and not exact:
        assert port == (19, 5000, 40)


def _write_pair(tmp, n_chr=3, seed=11):
    """A reference of n_chr chromosomes of 200-400 kbp and its assembly:
    2.5% SNPs, cut into contigs of 80-160 kbp (gen_flagship_data.py's
    shape at a small size)."""
    rng = np.random.default_rng(seed)
    ref, asm = str(tmp / "ref.fa"), str(tmp / "asm.fa")
    contigs = []
    with open(ref, "wb") as rf, open(asm, "wb") as af:
        for c in range(n_chr):
            n = int(rng.integers(200_000, 400_001))
            idx = rng.integers(0, 4, size=n, dtype=np.uint8)
            write_record(rf, f"chr{c + 1}", idx)
            mut = rng.random(n) < 0.025
            a = idx.copy()
            a[mut] = (a[mut] + rng.integers(1, 4, size=int(mut.sum()),
                                            dtype=np.uint8)) % 4
            pos = k = 0
            while pos < n:
                clen = min(int(rng.integers(80_000, 160_001)), n - pos)
                name = f"asm_chr{c + 1}_ctg{k}"
                write_record(af, name, a[pos:pos + clen])
                contigs.append((name, clen))
                pos += clen
                k += 1
    return ref, asm, contigs


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _write_pair(tmp_path_factory.mktemp("flagship"))


@pytest.fixture(scope="module")
def save_load_runs(pair, tmp_path_factory):
    """Each package's map_files at --pi 95 with --saveIndex, then with
    --loadIndex of its own npz: {(package, save|load): PAF}, and the two
    npz paths."""
    ref, asm, _ = pair
    tmp = tmp_path_factory.mktemp("save_load")
    pafs, npz = {}, {}
    for tag, P in (("jax", JaxParameters), ("port", Parameters)):
        npz[tag] = str(tmp / f"{tag}.idx.npz")
        for mode in ("save", "load"):
            out = str(tmp / f"{tag}_{mode}.paf")
            kw = ({"save_index_filename": npz[tag]} if mode == "save"
                  else {"load_index_filename": npz[tag]})
            p = P(ref_sequences=[ref], query_sequences=[asm],
                  out_file_name=out, percentage_identity=0.95,
                  batch_fragments=2048, no_progress=True, **kw)
            if tag == "jax":
                jax_map_files(p)
            else:
                map_files(p, device="cpu")
            with open(out) as fh:
                pafs[tag, mode] = fh.read()
    return pafs, npz


@pytest.mark.parametrize("run", [("jax", "load"), ("port", "save"),
                                 ("port", "load")])
def test_save_then_load_paf_identical_to_jax(save_load_runs, pair, run):
    """Built and saved, or loaded from the npz, the port's PAF is the
    JAX package's built-and-saved PAF, byte for byte; every contig of
    the assembly maps."""
    pafs, _ = save_load_runs
    want = pafs["jax", "save"]
    assert want.count("\n") >= len(pair[2])
    assert pafs[run] == want
    assert {ln.split("\t")[0] for ln in want.splitlines()} == \
        {name for name, _ in pair[2]}


def test_port_npz_loads_into_the_jax_index(save_load_runs):
    """The port's npz, read by the JAX package's ReferenceIndex.load,
    has the arrays and parameters of the JAX package's own npz."""
    _, npz = save_load_runs
    a = JaxReferenceIndex.load(npz["port"])
    b = JaxReferenceIndex.load(npz["jax"])
    c = ReferenceIndex.load(npz["jax"])
    for f in _NPZ_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert np.array_equal(getattr(c, f), getattr(b, f)), f
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert (a.names, a.freq_threshold, a.kmer_size, a.window_size,
            a.sketch_size) == (b.names, b.freq_threshold, b.kmer_size,
                               b.window_size, b.sketch_size)


def _records(fa):
    with open(fa, "rb") as fh:
        return fh.read().split(b">")[1:]


@pytest.mark.parametrize("gbp", [1e-9, 0.0003, 0.0005, 1.0])
def test_subset_keeps_whole_contigs_in_file_order(pair, tmp_path, gbp):
    """The subset is the assembly's first contigs, byte for byte, up to
    the first whose bases reach the target (all of them when the target
    is over the assembly)."""
    _, asm, contigs = pair
    src = str(tmp_path / "asm.fa")
    with open(asm, "rb") as a, open(src, "wb") as b:
        b.write(a.read())
    out, n_ctg, n_bp = flagship_torch.write_subset(src, gbp)
    assert out == str(tmp_path / f"asm_{gbp:g}g.fa")
    cum = np.cumsum([n for _, n in contigs])
    want = min(int(np.searchsorted(cum, gbp * 1e9)) + 1, len(contigs))
    assert (n_ctg, n_bp) == (want, int(cum[want - 1]))
    assert _records(out) == _records(src)[:want]


def test_flagship_script_end_to_end_on_cpu(pair, tmp_path, monkeypatch,
                                           capsys):
    """scripts/flagship_torch.py --device cpu: build with save (a valid
    npz, the group's main-thread and worker seconds), a subset, the map
    with --loadIndex past the coverage gate, and two resident runs with
    the same PAF."""
    ref, asm, contigs = pair
    monkeypatch.setenv("MASHMAP_TPU_FLAGSHIP_REF", ref)
    monkeypatch.setenv("MASHMAP_TPU_FLAGSHIP_ASM", asm)
    monkeypatch.setenv("MASHMAP_TPU_FLAGSHIP_IDX", str(tmp_path / "i.npz"))
    monkeypatch.setenv("MASHMAP_TPU_FLAGSHIP_OUT", str(tmp_path / "o.paf"))
    rc = flagship_torch.main(["--device", "cpu", "--subset-gbp", "0.0003",
                              "--map-twice"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert [r["phase"] for r in recs] == [
        "build", "subset", "map", "resident run 1", "resident run 2"]
    build, subset, mapped = recs[:3]
    assert build["npz_ok"] and build["card"] is None
    assert build["theta_launches"] == {"theta.cu": 0, "theta_wide.cu": 0}
    calls = build["theta_calls_rows_s_ms"]
    assert calls and all(c[0] > 0 and c[1] == build["s"] for c in calls)
    assert build["minmers"] > 0 and build["interval_rows"] > 0
    # one contig group: its device part on the main thread, its host
    # part on the build's worker thread, both timed
    groups = build["groups_main_worker_s"]
    assert list(groups) == ["0"] and min(groups["0"]) > 0, groups
    assert build["main_s"] > 0 and build["worker_s"] > 0
    assert "jax_build" not in build
    assert subset["contigs"] < len(contigs)
    assert mapped["query_sequences"] == subset["contigs"]
    assert mapped["query_bp"] == subset["bp"]
    assert mapped["paf_rows"] >= subset["contigs"]
    assert mapped["coverage_below_gate"] == []
    assert mapped["path_stats"]["host_frags"] == 0
    for r in recs[3:]:
        assert r["paf_equal_to_load_index_paf"]
        assert r["path_stats"] == mapped["path_stats"]
    with open(tmp_path / "o.paf") as fh:
        names = {ln.split("\t")[0] for ln in fh}
    assert names == {n for n, _ in contigs[:subset["contigs"]]}


def test_flagship_script_needs_a_card_or_cpu(monkeypatch):
    """Without a card and without --device cpu the script raises rather
    than running on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship_torch.main(["--build-only"])
