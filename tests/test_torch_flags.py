"""The port's mapper CLI against the JAX package's under the flags that
the other CLI tests leave out: each combination writes the same bytes
through both, with at least one row (on tests/test_torch_cli.py's
genome, on the CPU)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from genomes import write_fasta  # noqa: E402
from port_fixtures import jax_native_reader, one_torch_thread  # noqa
from test_torch_cli import _run_both, genome  # noqa: E402,F401


@pytest.fixture(scope="module")
def lists(genome):
    """The reference split into one file a haplotype, with a --rl list of
    them, a --ql list of the query file and a --targetList of one name."""
    from mashmap_tpu_torch.io import for_each_seq_in_file
    d, ref, qfa, _ = genome
    refs = []
    for i, rec in enumerate(for_each_seq_in_file(ref)):
        refs.append(str(d / f"ref{i}.fa"))
        write_fasta(refs[-1], [rec])
    files = {"RL": (refs, "rl.txt"), "QL": ([qfa], "ql.txt"),
             "TL": (["hap#0#chr1"], "targets.txt")}
    out = {}
    for key, (lines, name) in files.items():
        out[key] = str(d / name)
        with open(out[key], "w") as fh:
            fh.write("".join(f"{x}\n" for x in lines))
    return out


# argv after the reference and the query (REF is -r ref.fa, QFA the query
# set; none is a self-map of the reference). --dense is at --pi 90, the
# sweep's s = 298 (bench_extra.py): at --pi 85 its s = 398 costs each
# package about a minute of SciPy for the cutoff table on a cold cache.
FLAGS = {
    "dense": ["REF", "--dense", "--pi", "90"],
    "sketch60_droplow": ["REF", "-J", "60", "-K"],
    "kmer_complexity": ["REF", "QFA", "--kmerComplexity", "0.5"],
    "nohg_nomerge_n2": ["REF", "--noHgFilter", "-M", "-n", "2"],
    "sparsify_nomerge": ["REF", "-x", "0.5", "-M"],
    "filter_none": ["REF", "QFA", "-f", "none"],
    "ref_and_query_lists": ["--rl", "RL", "--ql", "QL"],
    "lower_triangular": ["REF", "--lowerTriangular"],
    "target_prefix": ["REF", "QFA", "--targetPrefix", "hap#1"],
    "target_list": ["REF", "QFA", "--targetList", "TL"],
    "hg_filter_ani_conf": ["REF", "--hgFilterAniDiff", "2",
                           "--hgFilterConf", "90"],
    "length_mismatches_block_chain": ["REF", "QFA",
                                      "--filterLengthMismatches", "-l",
                                      "10000", "-c", "2000"],
    "short_seq_kmer_threshold": ["REF", "QFA", "--numMappingsForShortSeq",
                                 "2", "--kmerThreshold", "0.01"],
    "exact_ref_size": ["REF", "--exactRefSize"],
}


@pytest.mark.parametrize("case", sorted(FLAGS))
def test_flags_byte_identical_to_jax(genome, lists, case):
    d, ref, qfa, _ = genome
    subst = {"REF": ["-r", ref], "QFA": ["-q", qfa]}
    argv = ["--noProgress"]
    for x in FLAGS[case]:
        argv += subst.get(x, [lists.get(x, x)])
    want, got = _run_both(d, argv, f"flags_{case}")
    assert want.count(b"\n") >= 1
    assert got == want
