#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: query Mbp/s of an all-vs-all
pangenome self-map on one CUDA card.

The port's counterpart of bench.py (which drives the JAX package): the
same workload (data/generated/bench_pan4x1500000.fa, 4 haplotypes of
1.5 Mbp at 5% divergence, seed 2024) and the same Parameters (--pi 85
-Y '#' -n 1, batch_fragments 1024), through ``map_files`` on "cuda":
theta.cu and the native reader built first (their first-use builds are
not in a run), one cold run (the process's first: the cutoff table and
the first launches and the capture of the map steps' CUDA graphs), then
``--reps`` warm runs, every run's seconds and graph captures on stderr
(a warm run captures none). The cutoff table goes to a fresh
$XDG_CACHE_HOME, removed at the end, so the cold run computes it
whatever earlier runs left.

    python3 bench_torch.py [--reps N] [--root DIR]

``--root DIR`` imports mashmap_tpu_torch from DIR, so that two checkouts
can take turns on one card, one process each. The last line is one JSON
object with bench.py's four keys (``value``: query Mbp/s of the best warm
run, index build + mapping) and the card's name and power limit
(``device``), the cold and warm seconds, the PAF's sha256 and rows, and
the smallest per-sequence coverage (the reference CI's gate, >= 0.92,
which must hold). vs_baseline is the ratio to the C++ MashMap built by
tests/oracle/build_ref.sh on the same workload where its sources exist,
else to the published CPU MashMap envelope (3200 query Mbp a minute on
8 threads, BASELINE.md). Without a CUDA card it prints bench.py's error
line and exits 2: nothing runs on the CPU.
"""

import argparse
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "generated")
N_HAP = 4
HAP_LEN = 1_500_000
DIVERGENCE = 0.05
PI = 85
MIN_COVERAGE = 0.92
METRIC = "pangenome self-map query throughput (1 chip)"


def ensure_dataset() -> str:
    """bench.py's pangenome, written once."""
    os.makedirs(DATA, exist_ok=True)
    path = os.path.join(DATA, f"bench_pan{N_HAP}x{HAP_LEN}.fa")
    if not os.path.exists(path):
        sys.path.insert(0, os.path.join(HERE, "tests"))
        from genomes import pangenome, write_fasta
        write_fasta(path + ".tmp",
                    pangenome(N_HAP, HAP_LEN, DIVERGENCE, seed=2024))
        os.replace(path + ".tmp", path)
    return path


def make_params(fasta, out):
    """bench.py:49-57's Parameters."""
    from mashmap_tpu_torch.params import Parameters
    return Parameters(
        ref_sequences=[fasta],
        out_file_name=out,
        percentage_identity=PI / 100.0,
        skip_prefix=True, prefix_delim="#",
        num_mappings_for_segment=1,
        batch_fragments=1024,
    )


def run_ours(fasta, out, reps):
    """One cold and `reps` warm runs of map_files on the card; returns
    their seconds (cold first)."""
    import torch
    from mashmap_tpu_torch.api import map_files
    from mashmap_tpu_torch.kernels import graphs
    times = []
    for _ in range(1 + reps):
        graphs.reset_counts()
        t0 = time.perf_counter()
        map_files(make_params(fasta, out), device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        print(f"[bench_torch] run {len(times) - 1}: {times[-1]} s, "
              f"map step graphs captured {dict(graphs.CAPTURES)}",
              file=sys.stderr)
    return times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2,
                    help="warm runs after the cold one [default: 2]")
    ap.add_argument("--root", default=HERE,
                    help="directory to import mashmap_tpu_torch from")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "Mbp/s",
                          "vs_baseline": 0.0, "error": "no CUDA device"}))
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from bench_extra_torch import fresh_cache
    with fresh_cache():
        return run_all(args)


def run_all(args):
    from bench_extra_torch import build_kernels, card_name, oracle, time_ref
    from check_coverage import coverage_by_sequence
    from mashmap_tpu_torch.io import for_each_seq_in_file
    card = card_name()
    fasta = ensure_dataset()
    out = os.path.join(DATA, "bench_torch.paf")
    query_mbp = N_HAP * HAP_LEN / 1e6

    build_s = build_kernels()
    times = run_ours(fasta, out, max(1, args.reps))
    ours_mbps = query_mbp / min(times[1:])
    with open(out, "rb") as fh:
        paf = fh.read()
    rows = paf.count(b"\n")
    lengths = {n: len(s) for n, s in for_each_seq_in_file(fasta)}
    cov = coverage_by_sequence(lengths, paf.decode().splitlines())
    # the C++ MashMap on 8 threads, best of two (bench.py:83-102), else
    # the published envelope: a human assembly in about a minute
    ref_bin = oracle()
    ref_s = ref_bin and time_ref(ref_bin, [
        "-r", fasta, "--pi", str(PI), "-Y", "#", "-n", "1", "-t", "8",
        "-o", os.path.join(DATA, "bench_ref.paf")])
    if ref_s:
        vs = ours_mbps / (query_mbp / ref_s)
    else:
        vs = ours_mbps / (3200.0 / 60.0)
    print(json.dumps({
        "metric": METRIC,
        "value": round(ours_mbps, 3),
        "unit": "Mbp/s",
        "vs_baseline": round(vs, 3),
        "device": card,
        "kernel_build_s": build_s,
        "cold_s": times[0],
        "warm_s": times[1:],
        "paf_sha256": hashlib.sha256(paf).hexdigest(),
        "paf_rows": rows,
        "coverage_min": min(cov.values()),
    }))
    if rows == 0 or min(cov.values()) < MIN_COVERAGE:
        print(f"[bench_torch] FAILED: {rows} PAF rows, "
              f"coverage {cov}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
