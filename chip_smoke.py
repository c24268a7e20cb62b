#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mashmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure propagates and exits non-zero:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the theta kernels (kernels/csrc/theta.cu for s <= 512,
   kernels/csrc/theta_wide.cu above), the banded DP trace kernel
   (align/csrc/banded_dp_trace.cu) and the native FASTA reader, all
   started together; each kernel instance's registers and spills from
   ptxas, and which FASTA reader loaded (native or Python);
3. kernel against plain version: theta_chunk on the card equals
   theta_chunk_ref exactly at the listed shapes and invalid fractions
   and at the schedule's edges (CHECK_EDGES, the wide kernel's sketch
   sizes and both of its set routes included), then on the block rows of
   the main path's own input, where both are also timed (and the kernel
   on the first 64 of those rows), and the same at --pi 78 (s = 680,
   the wide kernel); each [theta] line is followed by the
   segment length K, the chains, the resident warps per SM, the share
   of offsets where a set changed, and what kernel B's rule needs (host
   counts from the rows and the kernel's output, not counts taken in
   the kernel): for theta.cu the shares where it merges in full and
   moves theta by one place, for theta_wide.cu the largest delta D' a
   chain (mean, largest) and its inserts plus deletes a chain;
   the record carries the bound from the bytes and int32 operations
   these rows need;
4. [dp-check]: banded_dp_trace (the DP, its end state and its traceback
   in one kernel) on the card equals banded_dp_trace_torch exactly, every
   byte of every piece's record (result fields and ops), at each of the
   aligner's four buckets, on random pieces (B=64, 0-30% divergence, both
   free_start and free_end values) and the edge pieces
   (tests/test_torch_dp_pieces.py); [dp-time]: per bucket at B=512 and at
   the aligner's batch, the kernel's ms (median of 20, CUDA events), the
   records' device-to-host ms, the plain version's ms, and the bound from
   these pieces' rows and paths;
5. main path: build_or_load_index + map_files on "cuda" with bench.py's
   parameters on its 6 Mbp pangenome (4 x 1.5 Mbp), theta launches
   counted, and the reference's CI coverage gate (every sequence >= 0.92);
   then four warm runs with the same PAF, alternately reading through
   the native reader and the Python parser, and the two readers' time
   on the FASTA alone; then one run under torch.profiler (device busy
   time and the top kernels of the build and the map; the map's batches,
   its CUDA runtime calls that block the host (no cudaStreamSynchronize),
   its kernel and graph launches a batch, and its host seconds by map
   phase, Mapper.phase_s). Every map's l1_step and l2_step calls are
   counted (kernels/graphs.py, step_counts): each call is a graph
   replay, the steps' eager Python runs only to warm up and capture, the
   cold run captures at most one graph a shape, and the warm and
   profiled runs (each over the index built again: the same shapes)
   capture none; the cold map is then run again from an empty cache,
   through the graphs and with the steps run eagerly, and the graphs'
   peak reserved memory may exceed the eager steps' by at most 10%
   (peak_vs_eager);
6. card against CPU: on a small pangenome the card's index arrays and PAF
   bytes equal the port's own CPU run; [pipeline] (a): the same pangenome
   mapped on the card at PIPELINE_BATCH fragments a batch (15 batches
   through Mapper._run_pipelined, queries spanning them), its PAF the
   CPU's, once to capture its graphs and once under torch.profiler with
   no cudaStreamSynchronize and every step call a replay;
7. [cli]: `python -m mashmap_tpu_torch.cli` in a subprocess with
   bench.py's flags gives the main path's PAF byte for byte; once more
   with --legacy for the aligner;
8. [align]: the aligner's main path, `align.cli.main` on the pangenome and
   that legacy mapping at --pi 85 on "cuda", DP launches counted: rows,
   pieces per bucket and to the host DP, the DP kernel's device ms, the
   records' copy ms, host ms (anchors, the records' unpacking, host DP),
   wall s and aligned query Mbp/s; at least one output row per query
   haplotype, and the output's sha256 equal to ALIGN_SHA256; then once
   more under torch.profiler;
   [align-small]: on the small pangenome, its legacy mapping aligned on
   the card and on the CPU gives the same bytes;
9. the parallel layer, on the card listed twice: [shard] the main path's
   pangenome through a Mapper with shard_index and devices
   [cuda:0, cuda:0] (two shards asserted), PAF == the main path's,
   build and map s, bytes per shard, path_stats, peak device memory,
   no step through the graph cache (the sharded steps stay eager);
   [mesh] the same with the replicated index, PAF == the main path's,
   both row blocks replaying one graph a shape;
   [dist] two processes of the CLI meeting at a coordinator on
   127.0.0.1, in the default mode and in -f one-to-one, the merged PAF
   == the single-process CLI's, no part files left, wall s;
10. [overlimit]: one random contig of OVERLIMIT_BP (just over the default
   rank limit of 2^28 positions) built through the host route at the
   default limit and through the device route at 2^30: every index
   array equal; both build times, peak device memory, and the host
   route's theta launches;
11. [wide-s]: sketch sizes above 512 through build_or_load_index and
   map_files on the card, the index the whole pangenome's: (a) the main
   path's flags at --pi 78 (auto s = 680, the cutoff filter on, its
   table timed; a child process computes it from phase 3 on, beside the
   card's phases) with the postings cap lifted so the device map runs for
   every fragment; (a') a cut of the queries at the default cap (the
   host L1 route) and at the lifted one, the same PAF; (b) -J 3780
   --pi 75 --noHgFilter (the auto s of a 3.1 Gbp reference at --pi 75)
   on a cut of the queries; (c) -J 1790 --pi 78 --noHgFilter (the auto s
   of that reference at --pi 78) on a cut of the queries, L2 calls on
   the device cut by the L2 byte budget; (a) and (c) mapped again with
   the budget lifted and at it, and (c) on the CPU, each the same PAF;
   (a) mapped again with the steps eager and through the graphs, and
   (c)'s L2 call widened to the budget's full call width and its
   quarter width run both ways, each from an empty cache: the same
   PAF, equal outputs, and the graphs' peak reserved memory at most 10%
   over the eager steps' (peak_vs_eager, l2_peak_gate);
   for each: build and map s, theta_wide.cu's
   launches (> 0, and none of theta.cu), path_stats, peak device memory,
   and the coverage gate; [small-pi78]: the small pangenome at --pi 78,
   card (the lifted cap: the device route) == CPU (the default cap: the
   host route);
12. [flagship-ont]: BASELINE.json's configuration 3 (ONT reads against
   one reference, -f map) at MashMap's default --pi 85:
   scripts/gen_flagship_data.py --scale 0.02 writes the [flagship] pair
   (the reference: 24 chromosomes, 62 Mbp) into data/generated/, and
   scripts/flagship_torch.py's write_reads FLAGSHIP_ONT_READS reads of it
   (10-30 kb, 5% divergence, half from the minus strand, each read's
   origin in its name); build_or_load_index (the index resident) and
   map_files with it on "cuda", -J pinned to FLAGSHIP_ONT_S (the auto s
   of the 3.08 Gbp reference at --pi 85), its cutoff table made by the
   [configs] child process from phase 3 on; theta.cu's launches counted
   (> 0, none of theta_wide.cu); the PAF's sha256 must equal
   FLAGSHIP_ONT_SHA256 (the JAX package's PAF on the same files) and at
   least flagship_torch.MIN_TRUTH of the reads must have a row on their
   origin chromosome and strand that overlaps their origin; build s, map
   s, query Mbp/s, path_stats and peak device memory allocated and
   reserved; then theta.cu on the build's block rows timed, and on the
   first FLAGSHIP_CHECK_ROWS timed beside its plain version and its bound
   and equal to the plain version. The reads and the PAF are removed;
13. [flagship-rl]: BASELINE.json's configuration 5 (a --rl list of a
   reference and its ALT contigs, the index sharded) at --pi 85 -J
   FLAGSHIP_ONT_S: flagship_torch.py's write_alts writes 261 ALT-shaped
   contigs of the [flagship] reference (1% divergence, 2.18 Mbp), the
   index of the list is built resident, and the assembly's whole contigs
   from FLAGSHIP_RL_QUERY_FIRST up to FLAGSHIP_RL_QUERY_GBP are mapped
   with it by map_files three times: replicated on "cuda", then with
   --shardIndex on the card listed twice and four times (the shard
   counts asserted, the sharded steps eager); theta.cu's launches counted
   (> 0, none of theta_wide.cu); each PAF's sha256 must equal
   FLAGSHIP_RL_SHA256 (the JAX package's PAF on the same list and query),
   each map must span two batches or more and give a row on an ALT;
   the contigs must be
   the reference's and the 261 ALTs; build s, map s, query Mbp/s,
   path_stats, each shard's bytes and peak device memory; then theta.cu
   on the build's block rows timed, and on the first
   FLAGSHIP_CHECK_ROWS timed beside its plain version and its bound and
   equal to it. The ALTs, the cut and the PAF are removed;
14. [flagship]: the human-scale path at 62 Mbp: scripts/gen_flagship_data.py
   --scale 0.02 writes a reference of 24 chromosomes and its assembly
   (2.5% SNPs, whole contigs) into data/generated/; build_or_load_index
   with --saveIndex, then map_files with --loadIndex of that npz at
   --pi 95 (every other parameter at its default) on "cuda", theta.cu's
   launches counted (> 0); the PAF's sha256 must equal
   FLAGSHIP_S002_SHA256 (the JAX package's PAF on that pair), and every
   assembly contig must pass the coverage gate; build s, map s, query
   Mbp/s, PAF rows, path_stats and peak device memory; then theta.cu on
   the build's block rows (one contig group) timed, and equal to its
   plain version on the first FLAGSHIP_CHECK_ROWS of them; [pipeline]
   (b): the reference built again at rank limit PIPELINE_RANK_LIMIT (5
   contig groups, each group's host part on build_index's worker thread
   while the next group's device phases run), every index array equal to
   the one-group build's, each group's main-thread and worker seconds and
   the build's wall. The pair and the npz are removed at the end;
15. [configs]: BASELINE.json's other mapping configurations through
   bench_extra_torch.py's functions on "cuda", at bench_extra.py's sizes
   (its data and its cutoff tables at s = 20, 60, 120, 200 and 298, and
   [flagship-ont]'s at 310, made by a child process from phase 3 on):
   -f one-to-one at --pi 95 (the coverage gate), 200 ONT-shaped reads
   against a 5 Mbp reference (the mapped fraction), the --dense/-J sweep
   at --pi 90 (s = 298, 60, 120, 200; the ANI error of each) and two
   reference files (--rl); each run
   is one map_files call and must pass bench_extra_torch.check (its
   PAF's sha256 == EXTRA_SHA256, the JAX package's; bench_extra.py's
   gates), each step's theta.cu launches are counted (> 0, none of
   theta_wide.cu); the call's and its build's seconds, PAF rows,
   path_stats and peak device memory; then theta.cu on
   each build's block rows timed beside its bound, and it and its plain
   version timed on the first CONFIG_CHECK_ROWS, where they must be
   equal.

Each path's theta launches are counted from 0 just before it is driven
and read just after; a path that launched none fails the run. The line
before the last is the kernels' JSON record (theta's "launches" are the
main path's, the wide kernel's those of [wide-s] (a); "launches_by_path"
those of every path; theta's "configs" the [configs] rows' times and
bounds, "flagship_ont" [flagship-ont]'s, "flagship_rl" [flagship-rl]'s);
the last line is
{"ok": true, "device": {...}}.
The cutoff tables go to a fresh $XDG_CACHE_HOME that the run removes,
so every cold number is cold. Without a CUDA device, or without the
rest of the repository beside it, the script fails before printing
either.
"""

import contextlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "generated")

# bench.py's workload and flags: -Y '#', -n 1, --pi 85, self-map
N_HAP, HAP_LEN, DIVERGENCE, SEED = 4, 1_500_000, 0.05, 2024
SMALL = (3, 200_000, 0.05, 7)
PI = 0.85
BATCH = 1024
# [wide-s]: --pi 78 gives this pangenome s = 680; -J 3780 is the auto s
# of a 3.1 Gbp reference at --pi 75
PI_WIDE = 0.78
S_HUMAN, PI_HUMAN = 3780, 0.75
# at s = 680 a fragment's sketch gathers about 1400 postings of this
# pangenome, over the default cap of 1024, and every fragment takes the
# host route (about 0.5 s each): (a) lifts the cap so that the device map
# runs, and (a') maps WIDE_CUT_BP of queries at both caps. At s = 3780
# a fragment takes the host route (tens of seconds), so (b) maps
# HUMAN_CUT_BP of queries.
WIDE_P_CAP = 8192
WIDE_CUT_BP = 200_000
HUMAN_CUT_BP = 5_000
# (c): the auto s of a 3.1 Gbp reference at --pi 78, where about half
# the L2 slices still fit L2_T_MAX and run on the device, each of those
# calls cut by the L2 byte budget (uncut: 64 items, 7.5 GB an
# intermediate at T = 8192); a fragment's sketch gathers more postings
# than WIDE_P_CAP there
S_HUMAN78, PI_HUMAN78 = 1790, 0.78
L2_CUT_P_CAP = 16384
L2_CUT_BP = 20_000
# an L2 byte budget that cuts no call
NO_L2_BUDGET = 1 << 62
# one contig just over the default rank limit of 2^28 k-mer positions
OVERLIMIT_BP = 270_000_000

# [flagship]: scripts/gen_flagship_data.py's pair at this scale (seed 314,
# 62.47 MB each), mapped at --pi 95 (k = 19, w = 5000, auto s = 20)
FLAGSHIP_SCALE = 0.02
PI_FLAGSHIP = 0.95
# sha256 of the JAX package's PAF on that pair, on the CPU:
#   python scripts/gen_flagship_data.py --scale 0.02
#   JAX_PLATFORMS=cpu python -m mashmap_tpu.cli -r hg3g_s0.02.fa \
#       -q hg3g_asm_s0.02.fa --pi 95 --saveIndex jax_s002 -o jax.paf
# (33 rows; the port's CPU run of the same flags writes the same bytes
# and the same npz arrays)
FLAGSHIP_S002_SHA256 = ("d7956da3ea56ac49541adf7ca1c1c723"
                        "15219053711c2baa5d74f376b56a1920")
# theta.cu against its plain version on this many of the build's rows
FLAGSHIP_CHECK_ROWS = 1024
# [flagship-ont]: this many ONT-shaped reads (scripts/flagship_torch.py's
# write_reads, this seed: 8.07 Mbp) of the [flagship] reference, mapped
# at MashMap's default --pi 85 -f map with -J pinned to the auto s of the
# 3.08 Gbp reference at --pi 85 (310, through the int32 wrap; the
# full-scale run's theta.cu template and L2 widths)
FLAGSHIP_ONT_READS = 400
FLAGSHIP_ONT_SEED = 31
FLAGSHIP_ONT_S = 310
PI_ONT = 0.85
# sha256 of the JAX package's PAF on those files, on the CPU:
#   python scripts/gen_flagship_data.py --scale 0.02
#   python -c "import sys; sys.path.insert(0, 'scripts');
#       import flagship_torch as f; f.write_reads(
#       'data/generated/hg3g_s0.02.fa', 400, 31,
#       'data/generated/hg3g_s0.02_ont400_seed31.fa')"
#   JAX_PLATFORMS=cpu python -m mashmap_tpu.cli -r hg3g_s0.02.fa \
#       -q hg3g_s0.02_ont400_seed31.fa --pi 85 -J 310 -o jax.paf
# (438 rows, every read on its origin chromosome and strand; the CPU
# run takes about 25 minutes)
FLAGSHIP_ONT_SHA256 = ("9dba7774a8eb1deaba1436cdcc6738af"
                       "52f33d325a3071cee70f0e3fd0215fc3")
# [flagship-rl]: BASELINE.json's configuration 5 at the [flagship] pair's
# scale: a --rl list of that reference and its ALTs at FLAGSHIP_SCALE
# (scripts/flagship_torch.py's write_alts, seed 261: 261 contigs, 2.18
# Mbp), the assembly's whole contigs from FLAGSHIP_RL_QUERY_FIRST until
# they reach FLAGSHIP_RL_QUERY_GBP (its last 5, chr20 to chrY, 7.5 Mbp:
# more than one batch of fragments, and asm_chrX_ctg0 holds a row on an
# ALT), mapped at --pi 85 -J FLAGSHIP_ONT_S replicated and split into
# each count of flagship_torch.SHARDS (--shardIndex, the card listed that
# many times)
FLAGSHIP_RL_QUERY_FIRST = "asm_chr20_ctg0"
FLAGSHIP_RL_QUERY_GBP = 0.0075
# sha256 of the JAX package's PAF on those files, on the CPU:
#   python scripts/gen_flagship_data.py --scale 0.02
#   python -c "import sys; sys.path.insert(0, 'scripts');
#       import flagship_torch as f; r = 'data/generated/hg3g_s0.02.fa';
#       f.write_alts(r, 261, f.alts_path(r, 261, 0.02), 0.02);
#       f.write_subset('data/generated/hg3g_asm_s0.02.fa', 0.0075,
#                      'asm_chr20_ctg0')"
#   JAX_PLATFORMS=cpu python -c "from mashmap_tpu.api import map_files;
#       from mashmap_tpu.params import Parameters; d = 'data/generated/';
#       map_files(Parameters(ref_sequences=[d + 'hg3g_s0.02.fa',
#           d + 'hg3g_s0.02_alts261_x0.02_seed261.fa'],
#           query_sequences=[d + 'hg3g_asm_s0.02_asm_chr20_ctg0_0.0075g.fa'],
#           out_file_name='jax.paf', percentage_identity=0.85,
#           sketch_size=310, no_progress=True))"
# (6 rows, a contig each and asm_chrX_ctg0's second on chrX_alt106; the
# CPU run takes about 30 minutes)
FLAGSHIP_RL_SHA256 = ("1b44169ad21b2a2496020dd72f428570"
                      "8ecc8bfe4bb2c052ca4a948f5e3be2b8")
# [pipeline]: the small pangenome (120 fragments) mapped this many
# fragments a batch (15 batches, queries spanning them), and the
# [flagship] reference (62.47 M positions) built with this rank limit
# (5 contig groups)
PIPELINE_BATCH = 8
PIPELINE_RANK_LIMIT = 14_000_000
# CUDA runtime calls that block the host
BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize",
            "cudaDeviceSynchronize")
# [configs]: the same on this many rows of each configuration's build
CONFIG_CHECK_ROWS = 256

# theta kernel against its plain version: (C, S_B, s) x RSENT fraction,
# on ranks drawn from [0, 4 * S_B)
CHECK_SHAPES = ((64, 4982, 130), (64, 513, 30), (32, 4982, 398))
CHECK_INVALID = (0.0, 0.02, 0.5)
# and the edges of the two-kernel schedule (segments of 128 offsets):
# (C, S_B, s, RSENT fraction, rank alphabet)
CHECK_EDGES = (
    (64, 4982, 130, 0.02, 4),       # 4-letter alphabet: duplicate runs
    (64, 4982, 130, 0.02, 300),     # alphabet near 2s: the sets share ranks
    (64, 100, 30, 0.1, None),       # S_B below the segment length
    (64, 1000, 130, 0.02, None),    # S_B not a multiple of it
    (64, 4982, 1, 0.02, None),      # s = 1
    (32, 4982, 512, 0.02, None),    # s = S_MAX
    (1208, 4982, 310, 0.02, None),  # s of a human-scale reference
    (64, 300, 40, 0.85, 5000),      # sparse windows: RSENT thetas
    # theta_wide.cu (s > 512)
    (64, 4982, 513, 0.02, None),    # its first s
    (64, 4982, 680, 0.02, None),    # a 6 Mbp reference at --pi 78
    (32, 4982, 1110, 0.02, None),   # a 3.1 Gbp reference at --pi 80
    (16, 4982, 3780, 0.02, None),   # ... and at --pi 75
    (8, 400, 600, 0.0, None),       # S_B < s: every theta RSENT
    (2, 17000, 16400, 0.0, 1 << 30),  # the sets in the device scratch
    (64, 4982, 680, 0.02, 4),       # 4 letters: the scan's dedupe
    (64, 4096, 680, 0.0, None),     # S_B a multiple of K: a full last one
    (16, 700, 600, 0.0, 1 << 30),   # the union just above s: short bases
    (16, 4982, 3780, 0.02, 9000),   # alphabet near 2s: ranks in the base
)

# one H100 SXM: HBM rate (NVIDIA's data sheet), and the int32 compare
# rate: 132 SMs x 64 int32 lanes x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

DP_CHECK_B = 64
DP_TIME_B = 512
# int32 operations per DP cell that the recurrence needs, done one cell
# after another: the substitution compare, the diag and up adds, their
# min, the left move's add, its min, and the CAP saturation. The band's
# and the row's masks are intervals of each row, fixed by loop bounds;
# the scan's M - c and + c belong to one parallel form, not to the work.
DP_OPS_PER_CELL = 7
# and per step of the traceback: the substitution compare and the move
DP_OPS_PER_STEP = 2

# sha256 of the [align] output (the pangenome's legacy self-map aligned
# at --pi 85) as the aligner wrote it on the card while the traceback ran
# on the host over the DP rows (scripts/align_bench.py on the parent
# design; PERF.md): the kernel must not move a byte
ALIGN_SHA256 = ("2f38cf26095840eab8b8ffeb58a286a4"
                "b37f6fb691a23113c94dbe532601c212")
# that design's [align] split on an H100 80GB HBM3 at 700 W (PERF.md, §5):
# the rows' copy to the host and the host traceback, seconds
ROWS_DESIGN_S = {"copy": 2.31, "traceback": 9.21}


def coverage(paf_lines):
    """Per-query covered fraction of its length (tests/test_e2e.py's
    gate, a bedtools-merge equivalent)."""
    spans, lens = {}, {}
    for line in paf_lines:
        f = line.split("\t")
        spans.setdefault(f[0], []).append((int(f[2]), int(f[3])))
        lens[f[0]] = int(f[1])
    cov = {}
    for name, iv in spans.items():
        iv.sort()
        total, (a0, b0) = 0, iv[0]
        for a, b in iv[1:]:
            if a > b0:
                total += b0 - a0
                a0, b0 = a, b
            else:
                b0 = max(b0, b)
        cov[name] = (total + b0 - a0) / lens[name]
    return cov


def fasta(n_hap, length, divergence, seed):
    from genomes import pangenome, write_fasta
    os.makedirs(DATA, exist_ok=True)
    path = os.path.join(DATA, f"smoke_pan{n_hap}x{length}_{seed}.fa")
    if not os.path.exists(path):
        write_fasta(path + ".tmp", pangenome(n_hap, length, divergence,
                                             seed=seed))
        os.replace(path + ".tmp", path)
    return path


def params(fa, out, pi=PI, **kw):
    from mashmap_tpu_torch.params import Parameters
    return Parameters(ref_sequences=[fa], out_file_name=out,
                      percentage_identity=pi, skip_prefix=True,
                      prefix_delim="#", num_mappings_for_segment=1,
                      batch_fragments=BATCH, no_progress=True,
                      **kw).finalize()


def time_ms(fn, reps, warmup=1):
    """Median milliseconds of fn() on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def max_abs_err(got, want):
    return int((got.long() - want.long()).abs().max())


def theta_schedule_counts(cur, nxt, s, K, theta=None):
    """What theta over these block rows needs, counted on the host.

    Walks each row's suffix set (backward over cur) and prefix set
    (forward over nxt) one offset at a time and returns a dict: ins_s and
    ins_p, the effective inserts into each set; changed, the offsets
    where either set changed (the bound uses these three). Given the
    theta the rows produce at s <= 512, also what theta.cu's kernel B
    rule predicts: merged, the offsets merged in full (every segment's
    first, and those after a prefix insert that pushed theta out of the
    prefix set), and updated, the steps where a change at or below theta
    moves it instead. Above 512, what theta_wide.cu's kernel B rule
    needs (delta_counts). These are host counts of the rules, as the
    kernel sources and the CPU models in tests/test_torch_theta.py state
    them, not counts the kernels made.
    """
    import numpy as np
    from mashmap_tpu_torch.kernels.theta import RSENT, S_MAX
    cur, nxt = np.asarray(cur), np.asarray(nxt)
    C, s_b = cur.shape
    n_seg = -(-s_b // K)
    ar = np.arange(s)
    wide = s > S_MAX

    def walk(vals, order, snap_after):
        """Which offsets changed the set, what each change pushed out of
        slot s-1, and (above S_MAX) the set at each segment start, after
        (suffix) or before (prefix) its offset's insert."""
        st = np.full((C, s), RSENT, dtype=np.int32)
        chg = np.zeros((C, s_b), dtype=bool)
        pushed = np.zeros((C, s_b), dtype=np.int32)
        snaps = {}
        for j in order:
            if wide and j % K == 0 and not snap_after:
                snaps[j // K] = st.copy()
            v = vals[:, j]
            rows = np.nonzero(v < st[:, -1])[0]
            if rows.size:
                sr, vr = st[rows], v[rows, None]
                new = ~(sr == vr).any(axis=1)
                rows, sr, vr = rows[new], sr[new], vr[new]
                pos = (sr < vr).sum(axis=1, keepdims=True)
                shifted = np.concatenate([sr[:, :1], sr[:, :-1]], axis=1)
                st[rows] = np.where(ar < pos, sr,
                                    np.where(ar == pos, vr, shifted))
                chg[rows, j] = True
                pushed[rows, j] = sr[:, -1]
            if wide and j % K == 0 and snap_after:
                snaps[j // K] = st.copy()
        return chg, pushed, snaps

    s_chg, _, ck_s = walk(cur, range(s_b - 1, -1, -1), True)
    p_chg, p_out, ck_p = walk(nxt, range(s_b), False)
    out = {"ins_s": int(s_chg.sum()), "ins_p": int(p_chg.sum()),
           "changed": int((s_chg | p_chg).sum()), "offsets": C * s_b}
    if wide:
        ck_s[n_seg] = np.full((C, s), RSENT, dtype=np.int32)
        out.update(delta_counts(cur, nxt, s, K, ck_s, ck_p))
    elif theta is not None:
        th = np.asarray(theta)
        low = (s_chg & (cur <= th)) | (p_chg & (nxt <= th))
        full = low & (th != RSENT) & p_chg & (p_out == th)
        out["updated"] = int((low & ~full).sum())
        full = full[:, :-1]
        full[:, K - 1::K] = False       # the next offset starts a segment
        out["merged"] = int(full.sum()) + C * n_seg
    return out


def delta_counts(cur, nxt, s, K, ck_s, ck_p):
    """theta_wide.cu's kernel B rule on these rows, per chain (row,
    segment m): the base B_m = bottom-s of ck_s[m+1] U ck_p[m] (the walks'
    sets at the segment's ends), the segment's useful ranks (below
    B_m[s-1], not in B_m), and D', the distinct useful ranks of
    D(j) = cur[j:j1] U nxt[j0:j]. A useful rank v is in D(j) for j0 + k
    with k below a (one past its last offset in cur's segment) or from b
    (one past its first in nxt's) on; where b <= a it never leaves. So
    it is deleted at a and inserted at b when a < b, inside the offsets
    the chain steps. Returns delta_ins, delta_del, delta_top (each
    chain's largest D', summed), delta_max (the largest) and chains."""
    import numpy as np
    from mashmap_tpu_torch.kernels.theta import RSENT
    C, s_b = cur.shape
    rows = np.arange(C, dtype=np.int64)[:, None]
    got = {"delta_ins": 0, "delta_del": 0, "delta_top": 0, "delta_max": 0,
           "chains": 0}
    for m in range(len(ck_p)):
        j0, j1 = m * K, min(m * K + K, s_b)
        w = j1 - j0
        u = np.sort(np.concatenate([ck_s[m + 1], ck_p[m]], axis=1), axis=1)
        u[:, 1:][u[:, 1:] == u[:, :-1]] = RSENT
        base = np.sort(u, axis=1)[:, :s]
        flat = ((rows << 32) + base).ravel()

        def useful(seg):
            key = (rows << 32) + seg
            i = np.minimum(np.searchsorted(flat, key), flat.size - 1)
            return key, (seg < base[:, -1:]) & (flat[i] != key)

        kc, uc = useful(cur[:, j0:j1])
        kn, un = useful(nxt[:, j0:j1])
        pos = np.broadcast_to(np.arange(w), (C, w))
        kc, pc, kn, pn = kc[uc], pos[uc], kn[un], pos[un]
        o = np.lexsort((pc, kc))
        kc, pc = kc[o], pc[o]
        last = np.ones(kc.size, dtype=bool)
        last[:-1] = kc[1:] != kc[:-1]
        o = np.lexsort((pn, kn))
        kn, pn = kn[o], pn[o]
        first = np.ones(kn.size, dtype=bool)
        first[1:] = kn[1:] != kn[:-1]
        keys = np.union1d(kc[last], kn[first])
        a = np.zeros(keys.size, dtype=np.int64)
        a[np.searchsorted(keys, kc[last])] = pc[last] + 1
        b = np.full(keys.size, w, dtype=np.int64)
        b[np.searchsorted(keys, kn[first])] = pn[first] + 1
        stays = b <= a
        got["delta_del"] += int((~stays & (a > 0) & (a < w)).sum())
        got["delta_ins"] += int((~stays & (b < w)).sum())
        row = keys >> 32
        diff = np.zeros((C, w + 1), dtype=np.int64)
        np.add.at(diff, (row, 0), 1)
        np.add.at(diff, (row, np.where(stays, w, a)), -1)
        np.add.at(diff, (row, np.where(stays, w, b)), 1)
        np.add.at(diff, (row, np.full(row.size, w)), -1)
        top = np.cumsum(diff, axis=1)[:, :w].max(axis=1)
        got["delta_top"] += int(top.sum())
        got["delta_max"] = max(got["delta_max"], int(top.max()))
        got["chains"] += C
    return got


def theta_bound_ms(C, s_b, s, counts):
    """The least time the card could take for theta over these rows:
    cur and nxt read once and theta written once, over the HBM rate;
    the int32 operations these inputs need, over the int32 rate: one
    compare per offset per set (does the rank enter it), ceil(log2 s) + 1
    per effective insert into either set (a balanced or indexed set of s
    places the rank and evicts its largest in that many steps; a sorted
    array's shift of up to s is a cost of the layout, not of the
    function), and 2 per offset where a set changed (the change against
    theta, and theta's neighbour in the union, which a position kept per
    set finds in O(1); no merge is needed).
    Returns (ms, "bytes" or "operations")."""
    n_bytes = 3 * C * s_b * 4
    per_insert = (s - 1).bit_length() + 1
    n_ops = (per_insert * (counts["ins_s"] + counts["ins_p"])
             + 2 * counts["changed"] + 2 * C * s_b)
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / INT32_OPS_PER_S
    print(f"[theta]   bound: bytes {n_bytes} ({t_bytes} ms), int32 "
          f"operations {n_ops} ({t_ops} ms)")
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def theta_schedule_line(C, s_b, s, counts):
    """The kernels' geometry at this shape, the share of offsets where a
    set changed, and what kernel B's rule needs (host counts): for
    theta.cu the shares where it merges in full and moves theta by one
    place; for theta_wide.cu D''s largest length a chain (mean and
    largest) and its inserts plus deletes a chain."""
    from mashmap_tpu_torch.kernels import theta
    _, k, n_seg = theta.kernel_geometry(s, s_b)
    warps_a, warps_b = theta.resident_warps(s)
    wide = s > theta.S_MAX
    a, b = (("theta_wide_scan_kernel", "theta_wide_chain_kernel") if wide
            else ("theta_ckpt_kernel", "theta_chain_kernel"))
    n = counts["offsets"]
    if wide:
        ch = counts["chains"]
        rule = (f"largest D' a chain mean {counts['delta_top'] / ch} max "
                f"{counts['delta_max']}, inserts + deletes a chain "
                f"{(counts['delta_ins'] + counts['delta_del']) / ch}")
    else:
        rule = (f"merged share {counts['merged'] / n}, stepped share "
                f"{counts['updated'] / n}")
    print(f"[theta]   K={k} chains={C * n_seg} resident warps/SM: "
          f"A ({a}) {warps_a} B ({b}) {warps_b}; changed share "
          f"{counts['changed'] / n}; host count of B's rule: {rule}")


def random_rows(C, s_b, s, frac, alphabet=None):
    """(cur, nxt) int32 block rows of random ranks from [0, alphabet)
    (default 4 * S_B), a share frac of them RSENT, seeded by the shape."""
    import numpy as np
    rng = np.random.default_rng(C + s_b + s)
    hi = alphabet or 4 * s_b
    cur = rng.integers(0, hi, (C, s_b)).astype(np.int32)
    nxt = rng.integers(0, hi, (C, s_b)).astype(np.int32)
    cur[rng.random((C, s_b)) < frac] = np.iinfo(np.int32).max
    nxt[rng.random((C, s_b)) < frac] = np.iinfo(np.int32).max
    return cur, nxt


def check_theta(device):
    """theta_chunk against theta_chunk_ref, exactly, on random ranks at
    CHECK_SHAPES x CHECK_INVALID and at CHECK_EDGES; returns the largest
    absolute difference (0)."""
    import torch
    from mashmap_tpu_torch.kernels import theta
    cases = [(C, s_b, s, frac, None) for (C, s_b, s) in CHECK_SHAPES
             for frac in CHECK_INVALID] + list(CHECK_EDGES)
    worst = 0
    for (C, s_b, s, frac, alphabet) in cases:
        hi = alphabet or 4 * s_b
        cur, nxt = random_rows(C, s_b, s, frac, hi)
        c = torch.from_numpy(cur).to(device)
        n = torch.from_numpy(nxt).to(device)
        got = theta.theta_chunk(c, n, s, s_b)
        err = max_abs_err(got, theta.theta_chunk_ref(c, n, s, s_b))
        ms = time_ms(lambda: theta.theta_chunk(c, n, s, s_b),
                     reps=5, warmup=0)
        print(f"[theta] C={C} S_B={s_b} s={s} invalid={frac} "
              f"alphabet={hi}: max_abs_err={err} kernel {ms} ms")
        theta_schedule_line(C, s_b, s, theta_schedule_counts(
            cur, nxt, s, theta.SEG_K, got.cpu().numpy()))
        if err != 0:
            raise AssertionError(
                f"theta kernel disagrees with its plain version at "
                f"C={C} S_B={s_b} s={s} invalid={frac} alphabet={hi}")
        worst = max(worst, err)
    return worst


def print_ptxas(log):
    """Registers, spill bytes and shared memory of each kernel instance,
    from nvcc's -Xptxas -v report of this build."""
    import re
    if not os.path.exists(log):
        print(f"[build] no ptxas report at {log} (library built earlier)")
        return
    with open(log) as fh:
        text = fh.read()
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\w*?"
                      r"(theta_\w+?_kernel|banded_dp_trace_kernel)"
                      r"(?:IL[ib](\d+)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            spill = "spills not read"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"spill st/ld {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"[build] {name}: {m.group(1)} registers, {spill}")
            name = None


def main_path_blocks(p, device):
    """The (cur, nxt) block rows that the build hands to theta_chunk for
    p's reference files (one contig group): hashing, rank reduction and
    the block cut of the index build, stopped before theta."""
    import torch
    from mashmap_tpu_torch.index import builder
    from mashmap_tpu_torch.io import for_each_seq_in_file
    from mashmap_tpu_torch.kernels import kmers, winnow
    hs = [builder._hash_contig(kmers.sanitize(seq.encode("ascii")),
                               p.kmer_size, device)[0]
          for fa in p.ref_sequences
          for _, seq in for_each_seq_in_file(fa)]
    ranks, _ = winnow._rank_reduce(torch.cat(hs))
    views = list(torch.split(ranks, [h.shape[0] for h in hs]))
    cur, nxt, _ = winnow.theta_blocks(views, p.seg_length - p.kmer_size + 1)
    return cur, nxt


def theta_record(p, device, kernel_reps=20, plain_reps=3):
    """The kernel against its plain version on the main path's own block
    rows, exactly; the times of both there, and the least time the card
    could take for them."""
    import torch
    from mashmap_tpu_torch.kernels import theta
    cur, nxt = main_path_blocks(p, device)
    C, s_b = cur.shape
    s = p.sketch_size
    out = {}
    ms = time_ms(
        lambda: out.update(got=theta.theta_chunk(cur, nxt, s, s_b)),
        kernel_reps)
    plain_ms = time_ms(
        lambda: out.update(want=theta.theta_chunk_ref(cur, nxt, s, s_b)),
        plain_reps, warmup=0)
    err = max_abs_err(out["got"], out["want"])
    if not torch.equal(out["got"], out["want"]):
        raise AssertionError(
            f"theta kernel disagrees with its plain version on the main "
            f"path's block rows (C={C} S_B={s_b} s={s}): max_abs_err={err}")
    c64, n64 = cur[:64].contiguous(), nxt[:64].contiguous()
    ms64 = time_ms(lambda: theta.theta_chunk(c64, n64, s, s_b),
                   kernel_reps)
    print(f"[theta] main-path block rows C={C} S_B={s_b} s={s}: "
          f"max_abs_err={err} kernel {ms} ms (first 64 rows {ms64} ms), "
          f"plain {plain_ms} ms")
    counts = theta_schedule_counts(cur.cpu().numpy(), nxt.cpu().numpy(), s,
                                   theta.SEG_K, out["got"].cpu().numpy())
    theta_schedule_line(C, s_b, s, counts)
    bound_ms, bound_by = theta_bound_ms(C, s_b, s, counts)
    wide = s > theta.S_MAX
    return {"name": "theta_chunk_wide" if wide else "theta_chunk",
            "route": "cuda",
            "source": "mashmap_tpu_torch/kernels/csrc/"
                      + ("theta_wide.cu" if wide else "theta.cu"),
            "replaces": "mashmap_tpu/kernels/winnow_pallas.py:136"
                        + (" (at s > 512)" if wide else ""),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "s": s}


@contextlib.contextmanager
def python_reader():
    """io.fasta with its native route off: the pure-Python parser it
    falls back to when the C++ reader cannot be built."""
    from mashmap_tpu_torch import native
    load = native._load_fastaread
    native._load_fastaread = lambda: None
    try:
        yield
    finally:
        native._load_fastaread = load


def reader_times(fa, reps=3):
    """Seconds to read fa alone with the native reader and with the
    Python parser, alternated; prints the median of reps each."""
    from mashmap_tpu_torch.io import for_each_seq_in_file
    times = {"native": [], "python": []}
    for _ in range(reps):
        for name, ctx in (("native", contextlib.nullcontext),
                          ("python", python_reader)):
            with ctx():
                t0 = time.perf_counter()
                bp = sum(len(seq) for _, seq in for_each_seq_in_file(fa))
                times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        print(f"[main] reader {name}: {bp} bp in {sorted(ts)[reps // 2]} s "
              f"(median of {reps}: {ts})")


def main_path(fa, device):
    """bench.py's build + self-map through the port's entry points: the
    first run (cold: each CUDA kernel's first launch loads it) goes
    through map_files and is the one whose theta launches are counted and
    whose PAF is gated; then warm runs (the steady state bench.py
    reports) drive the Mapper that map_files builds, to read which device
    and host routes ran, alternately with the native reader and the
    Python parser, and must each give the same PAF. Returns the theta
    launches of the first run and its PAF."""
    import torch
    from mashmap_tpu_torch.api import build_or_load_index, map_files
    from mashmap_tpu_torch.io import for_each_seq_in_file
    from mashmap_tpu_torch.kernels import theta
    from mashmap_tpu_torch.map.engine import Mapper
    names, bp = [], 0
    for name, seq in for_each_seq_in_file(fa):
        names.append(name)
        bp += len(seq)

    def peak():
        """Peak device bytes since the last call."""
        v = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        return v

    def run(tag, reader=contextlib.nullcontext):
        with reader():
            return run_once(tag)

    def run_once(tag):
        out = os.path.join(DATA, f"smoke_main_{tag}.paf")
        p = params(fa, out)
        peak()
        t0 = time.perf_counter()
        idx = build_or_load_index(p, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        build_peak = peak()
        path_stats = "not read (map_files)"
        batches = [0]
        with step_counts() as steps, count_batches(batches):
            if tag == "cold":
                map_files(p, index=idx, device=device)
            else:
                mapper = Mapper(p, idx, device)
                with open(out, "w") as fh:
                    mapper.run(p.query_sequences, fh)
                path_stats = mapper.path_stats
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        with open(out) as fh:
            paf = fh.read()
        print(f"[main] {tag}: s={p.sketch_size} k={p.kmer_size} "
              f"w={p.seg_length} query_bp={bp} build_s={t1 - t0} "
              f"map_s={t2 - t1} query_mbp_per_s={bp / 1e6 / (t2 - t0)}")
        reserved = torch.cuda.max_memory_reserved(device)
        print(f"[main] {tag}: paf_rows={paf.count(chr(10))} "
              f"path_stats={path_stats} max_memory_allocated build="
              f"{build_peak} map={peak()} (reserved {reserved})")
        # the first map of the process captures the steps' graphs; a
        # warm map over an index of the same shapes replays them all
        check_steps(f"[main] {tag}:", steps, batches[0], tag != "cold")
        return paf

    theta.LAUNCHES = 0
    paf = run("cold")
    launches = theta.LAUNCHES
    print(f"[main] theta_launches={launches}")
    if launches <= 0:
        raise AssertionError("the main path launched no theta kernel")
    cov = coverage(paf.splitlines())
    print(f"[main] coverage min={min(cov.values()) if cov else 0.0} "
          f"of {len(cov)}/{len(names)} sequences")
    bad = {n: cov.get(n, 0.0) for n in names if cov.get(n, 0.0) < 0.92}
    if bad:
        raise AssertionError(f"coverage gate failed: {bad}")
    for tag, reader in (("warm", contextlib.nullcontext),
                        ("warm-python", python_reader),
                        ("warm-2", contextlib.nullcontext),
                        ("warm-python-2", python_reader)):
        if run(tag, reader) != paf:
            raise AssertionError(f"the {tag} run's PAF differs from the "
                                 f"cold's")
    # the cold map's memory against the eager steps'; [profile] then
    # replays the graphs this leaves cached
    peak_vs_eager("[main]", params(fa, os.path.join(DATA,
                                                   "smoke_main_peak.paf")),
                  device, paf)
    reader_times(fa)
    # the cold run's one-off host set-up: the L1 cutoff table, which
    # the Mapper computes with SciPy and the process memoizes
    from mashmap_tpu_torch import stats
    from mashmap_tpu_torch.params import FIXED
    p = params(fa, os.devnull)
    t0 = time.perf_counter()
    stats.compute_cutoffs(p.sketch_size, p.kmer_size, p.ANIDiff,
                          p.ANIDiffConf, FIXED.ss_table_max)
    print(f"[main] set-up: cutoff table {time.perf_counter() - t0} s")
    return launches, paf


def profile_main_path(fa, device, top=12):
    """The main path once more under torch.profiler: wall time of the
    build and the map, the device's busy time in each (kernels and
    copies, one stream), and the kernels that take the most device
    time. The profiler's own cost inflates the wall times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mashmap_tpu_torch.api import build_or_load_index, map_files
    p = params(fa, os.path.join(DATA, "smoke_profile.paf"))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    mappers, batches = [], [0]
    for phase in ("build", "map"):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if phase == "build":
                idx = build_or_load_index(p, device)
            else:
                with grab_mappers(mappers), count_batches(batches), \
                        step_counts() as steps:
                    map_files(p, index=idx, device=device)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        print_profile("[profile]", phase, prof, wall_ms, top, "theta_")
    calls = runtime_calls(prof)
    print(f"[profile] map: {batches[0]} batches; CUDA runtime calls "
          f"{calls}; a batch {per_batch(calls, batches[0])}")
    print(f"[profile] map: host s by map phase "
          f"{dict(sorted(mappers[0].phase_s.items()))}")
    check_steps("[profile] map:", steps, batches[0], warm=True)
    # every copy of the pipelined map waits on its own event
    # (hostcopy.py), never on the whole stream
    if calls["cudaLaunchKernel"] == 0:
        raise AssertionError("[profile] map: no CUDA runtime call traced")
    if calls["cudaStreamSynchronize"]:
        raise AssertionError(f"[profile] map: "
                             f"{calls['cudaStreamSynchronize']} stream "
                             f"synchronizations for {batches[0]} batches")


def runtime_calls(prof):
    """Counts, in a torch.profiler window, of the CUDA runtime calls that
    block the host and of the kernel and graph launches (the check that
    runtime calls were traced at all)."""
    counts = {e.key: e.count for e in prof.key_averages()}
    return {k: counts.get(k, 0)
            for k in ("cudaLaunchKernel", "cudaGraphLaunch") + BLOCKING}


def per_batch(calls, batches):
    """The kernel and graph launches of a profiled map a batch."""
    return {k: calls[k] / max(1, batches)
            for k in ("cudaLaunchKernel", "cudaGraphLaunch")}


STEPS = ("l1_step", "l2_step")


@contextlib.contextmanager
def step_counts():
    """Counts, for the map steps of the block (kernels/graphs.py's
    counters set to 0 first): the calls the map makes through
    graphs.call on the card, the argument shapes of those calls, and
    the times each step's eager Python ran (a warm-up and a capture for
    each graph, nothing else); "last" holds each step's last call on the
    card, (args, static)."""
    import functools
    import torch
    from mashmap_tpu_torch.kernels import graphs, mapdev
    got = {"calls": dict.fromkeys(STEPS, 0), "eager": dict.fromkeys(STEPS, 0),
           "shapes": {k: set() for k in STEPS}, "last": {}}
    real_call = graphs.call
    real = {k: getattr(mapdev, k) for k in STEPS}

    def call(device, step, args, *static):
        if torch.device(device).type == "cuda":
            got["calls"][step.__name__] += 1
            got["shapes"][step.__name__].add((tuple(
                tuple(a.shape) for a in args), static))
            got["last"][step.__name__] = (args, static)
        return real_call(device, step, args, *static)

    def eager(name):
        @functools.wraps(real[name])
        def f(*a, **kw):
            got["eager"][name] += 1
            return real[name](*a, **kw)
        return f
    graphs.reset_counts()
    graphs.call = call
    for k in STEPS:
        setattr(mapdev, k, eager(k))
    try:
        yield got
    finally:
        graphs.call = real_call
        for k in STEPS:
            setattr(mapdev, k, real[k])
        got["captures"] = {k: graphs.CAPTURES.get(k, 0) for k in STEPS}
        got["replays"] = {k: graphs.REPLAYS.get(k, 0) for k in STEPS}


def check_steps(tag, got, l1_calls, warm, l2=True):
    """Gates on step_counts' counts of a replicated map on the card:
    l1_step was called l1_calls times (batches x row blocks) and, with
    l2, l2_step at least once; every call of each step was a replay,
    captures at most the shapes used, and the step's eager Python ran
    only to warm up and capture (twice a capture); with warm, nothing
    was captured."""
    calls, eager = got["calls"], got["eager"]
    caps, reps = got["captures"], got["replays"]
    shapes = {k: len(v) for k, v in got["shapes"].items()}
    print(f"{tag} map steps: calls {calls}, replays {reps}, captures "
          f"{caps} (shapes used {shapes}), eager runs {eager}")
    if calls["l1_step"] != l1_calls or (l2 and calls["l2_step"] == 0):
        raise AssertionError(f"{tag} step calls {calls}, expected "
                             f"{l1_calls} of l1_step")
    for k in STEPS:
        if reps[k] != calls[k] or caps[k] > shapes[k]:
            raise AssertionError(f"{tag} {k}: {calls[k]} calls, "
                                 f"{reps[k]} replays, {caps[k]} captures "
                                 f"for {shapes[k]} shapes")
        if eager[k] != 2 * caps[k]:
            raise AssertionError(f"{tag} {k} ran eagerly {eager[k]} times "
                                 f"for {caps[k]} captures")
        if warm and caps[k]:
            raise AssertionError(f"{tag} {k}: a warm map captured "
                                 f"{caps[k]} graphs")


@contextlib.contextmanager
def eager_steps():
    """graphs.call runs each step eagerly on the card, as the map did
    before the graph cache: peak_vs_eager's memory baseline."""
    import numpy as np
    import torch
    from mashmap_tpu_torch.hostcopy import to_device
    from mashmap_tpu_torch.kernels import graphs
    real = graphs.call

    def call(device, step, args, *static):
        return step(*(to_device(a, torch.device(device))
                      if isinstance(a, np.ndarray) else a for a in args),
                    *static)
    graphs.call = call
    try:
        yield
    finally:
        graphs.call = real


def reserved_peak(device, run):
    """run() from an empty graph cache and an emptied allocator; returns
    (peak reserved, peak allocated, reserved before) in bytes."""
    import torch
    from mashmap_tpu_torch.kernels import graphs
    graphs.clear(device)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_reserved(device)
    run()
    torch.cuda.synchronize(device)
    return (torch.cuda.max_memory_reserved(device),
            torch.cuda.max_memory_allocated(device), before)


def check_peaks(tag, peaks):
    """Prints both routes' peaks; fails if the graphs' peak reserved
    memory exceeds the eager steps' by more than 10%."""
    print(f"{tag} peak device memory from an empty cache (reserved, "
          f"allocated, reserved before), eager steps {peaks['eager']}, "
          f"graphs {peaks['graphs']}: reserved ratio "
          f"{peaks['graphs'][0] / peaks['eager'][0]}")
    if peaks["graphs"][0] > 1.10 * peaks["eager"][0]:
        raise AssertionError(f"{tag} the graphs' peak reserved memory is "
                             f"over 1.10 x the eager steps': {peaks}")


def peak_vs_eager(tag, p, device, want_paf, idx=None):
    """p mapped against idx (built when None) on the card, each time from
    an empty graph cache and an emptied allocator: with every step run
    eagerly, then through the graph cache (every shape captured, as in a
    cold map, whose graphs stay cached). Both PAFs must be want_paf, and
    the graphs' peak reserved memory at most 10% over the eager steps'."""
    from mashmap_tpu_torch.api import build_or_load_index, map_files
    if idx is None:
        idx = build_or_load_index(p, device)
    peaks = {}
    for route, steps in (("eager", eager_steps),
                         ("graphs", contextlib.nullcontext)):
        def run():
            with steps():
                map_files(p, index=idx, device=device)
        peaks[route] = reserved_peak(device, run)
        with open(p.out_file_name) as fh:
            if fh.read() != want_paf:
                raise AssertionError(f"{tag} the {route} map's PAF differs")
    check_peaks(tag, peaks)


def l2_peak_gate(tag, p, device, m, last):
    """The map's last l2_step call on the card (last: step_counts' "last",
    emptied here, so that the call's device tensors can be freed; m: its
    Mapper), its work items repeated to the full call width at the
    L2 byte budget and then to the quarter width, as a bucket's full
    chunks and its tail come: both calls run eagerly and then through the
    graph cache, each time from an empty cache and an emptied allocator.
    The outputs must be equal, and the graphs' peak reserved memory at
    most 10% over the eager steps'. Clears the cache after."""
    import numpy as np
    import torch
    from mashmap_tpu_torch.hostcopy import to_device
    from mashmap_tpu_torch.kernels import graphs
    from mashmap_tpu_torch.kernels.mapdev import l2_step
    from mashmap_tpu_torch.map import engine
    args, (T, s) = last.pop("l2_step")
    last.clear()
    # the rows of the 7 per-item arguments, on the host; the 5 tables
    # are the device's cached mi_* set, bound anew after each clear
    rows = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            for a in args[:7]]
    del args
    mi = ("mi_rank", "mi_wpos", "mi_wend", "mi_strand", "mi_seqid")
    w_step, w_small = engine._l2_widths(
        p.l2_batch * p.l2_entries_cap // 2, T, s)
    print(f"{tag} full-width L2 call: T={T} s={s} widths {w_step}, "
          f"{w_small} from the map's {len(rows[0])} rows; one (W, s, 2T) "
          f"int32 intermediate {w_step * s * 2 * T * 4} bytes")

    def inputs(n, t):
        ix = np.arange(n) % len(rows[0])
        a = [r[ix] for r in rows]
        a[4], a[5] = (torch.from_numpy(x).to(device) for x in a[4:6])
        return (*a, *(t[k] for k in mi))

    peaks, outs = {}, {}
    for route in ("eager", "graphs"):
        got = []

        def run():
            t = graphs.tables(device, m, m._host_tables)
            for n in (w_step, w_small):
                a = inputs(n, t)
                if route == "eager":
                    got.append(l2_step(*(
                        to_device(x, device) if isinstance(x, np.ndarray)
                        else x for x in a), T, s))
                else:
                    got.append(graphs.call(device, l2_step, a, T, s))
        peaks[route] = reserved_peak(device, run)
        outs[route] = [g.cpu() for g in got]
        del got
    if not all(torch.equal(a, b) for a, b in zip(outs["eager"],
                                                 outs["graphs"])):
        raise AssertionError(f"{tag} the full-width L2 call's replay "
                             f"differs from the eager step")
    print(f"{tag} full-width L2 call: replay == eager step, "
          f"{int((outs['eager'][0][:, 0] > 0).sum())} of {w_step} rows "
          f"with runs")
    check_peaks(f"{tag} full-width L2 call", peaks)
    graphs.clear(device)


@contextlib.contextmanager
def count_batches(n):
    """Mapper._dispatch_batch adds one to n[0] for each batch."""
    from mashmap_tpu_torch.map import engine
    real = engine.Mapper._dispatch_batch

    def spy(self, frags):
        n[0] += 1
        return real(self, frags)
    engine.Mapper._dispatch_batch = spy
    try:
        yield
    finally:
        engine.Mapper._dispatch_batch = real


def print_profile(tag, phase, prof, wall_ms, top, mark):
    """Device busy time and idle share of a torch.profiler window, its
    top kernels by device time, and the kernels whose name holds mark."""
    # device-side events only (kernels, copies): the host ops that
    # launched them carry the same time again
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows = sorted(r for r in rows if r[0] > 0)[::-1]
    busy_ms = sum(r[0] for r in rows)
    print(f"{tag} {phase}: wall {wall_ms} ms, device busy {busy_ms} ms, "
          f"idle share {1 - busy_ms / wall_ms if rows else 'not measured'}")
    for ms, n, key in rows[:top]:
        print(f"{tag} {phase}:   {ms} ms x{n} {key[:90]}")
    for ms, n, key in rows:
        if mark in key:
            print(f"{tag} {phase}: {mark} {ms} ms x{n} {key[:40]}")


def small_paf(pi, dev_type):
    """Where card_vs_cpu writes the small pangenome's PAF."""
    return os.path.join(DATA, f"smoke_small_{pi}_{dev_type}.paf")


def pipeline_phase(fa, device):
    """[pipeline] (a): the small pangenome built and mapped on the card
    at PIPELINE_BATCH fragments a batch, so that many batches pass two at
    a time and queries span them; the map under torch.profiler. Gates:
    the PAF == the port's CPU PAF that card_vs_cpu wrote (the PAF does
    not depend on the batch size), more than 9 batches, the runtime
    calls traced, no cudaStreamSynchronize in the map (the profiler's
    own synchronize at the window's end is a cudaDeviceSynchronize), and
    theta launched. Returns theta.cu's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mashmap_tpu_torch.api import build_or_load_index, map_files
    from mashmap_tpu_torch.kernels import theta
    out = os.path.join(DATA, "smoke_pipeline.paf")
    p = params(fa, out)
    p.batch_fragments = PIPELINE_BATCH
    theta.LAUNCHES = theta.WIDE_LAUNCHES = 0
    idx = build_or_load_index(p, device)
    # the first map captures the steps' graphs at this index's shapes;
    # the profiled one replays them
    batches = [0]
    with count_batches(batches), step_counts() as steps:
        map_files(p, index=idx, device=device)
    check_steps("[pipeline] (a) first map:", steps, batches[0], warm=False)
    mappers, batches = [], [0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with grab_mappers(mappers), count_batches(batches), \
                step_counts() as steps:
            map_files(p, index=idx, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = theta.LAUNCHES
    calls = runtime_calls(prof)
    m = mappers[0]
    print(f"[pipeline] (a) batch_fragments={p.batch_fragments}: "
          f"{batches[0]} batches, map {wall} s (profiled), theta.cu "
          f"launches {launches}, path_stats {m.path_stats}")
    print(f"[pipeline] (a) CUDA runtime calls {calls}; a batch "
          f"{per_batch(calls, batches[0])}")
    print(f"[pipeline] (a) host s by map phase "
          f"{dict(sorted(m.phase_s.items()))}")
    check_steps("[pipeline] (a) profiled map:", steps, batches[0], warm=True)
    with open(out, "rb") as fh:
        got = fh.read()
    with open(small_paf(PI, "cpu"), "rb") as fh:
        want = fh.read()
    if got != want:
        raise AssertionError("[pipeline] (a) PAF differs from the CPU's")
    if batches[0] < 10:
        raise AssertionError(f"[pipeline] (a) {batches[0]} batches")
    if calls["cudaLaunchKernel"] == 0:
        raise AssertionError("[pipeline] (a) no CUDA runtime call traced")
    syncs = calls["cudaStreamSynchronize"]
    if syncs:
        raise AssertionError(f"[pipeline] (a) {syncs} stream "
                             f"synchronizations for {batches[0]} batches")
    if launches <= 0:
        raise AssertionError("[pipeline] (a) launched no theta kernel")
    rows = got.count(b"\n")
    print(f"[pipeline] (a) PAF == the CPU's, {rows} rows; {syncs} stream "
          f"synchronizations for {batches[0]} batches")
    return launches


def pipeline_groups(pb, idx, device):
    """[pipeline] (b): the [flagship] reference built again through
    build_index at rank limit PIPELINE_RANK_LIMIT, so that several contig
    groups pass with each group's host part on the build's worker thread
    while the next group's device phases run. Gates: at least 4 groups,
    every index array == idx's (the default one-group build), theta
    launched. Prints the main thread's and the worker's seconds per
    group (index/builder.py's GROUP_PHASE_S) and the build's wall against
    their sum. Returns theta.cu's launches."""
    import numpy as np
    import torch
    from mashmap_tpu_torch.index.builder import _NPZ_FIELDS, build_index
    from mashmap_tpu_torch.io import for_each_seq_in_file
    from mashmap_tpu_torch.kernels import theta
    from flagship_torch import group_seconds
    theta.LAUNCHES = 0
    t0 = time.perf_counter()
    got = build_index(
        (rec for fa in pb.ref_sequences for rec in for_each_seq_in_file(fa)),
        pb.kmer_size, pb.seg_length, pb.sketch_size, pb.kmer_pct_threshold,
        threads=pb.threads, device=device, rank_limit=PIPELINE_RANK_LIMIT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per = group_seconds()
    launches = theta.LAUNCHES
    for gid, (m_s, w_s) in per.items():
        print(f"[pipeline] (b) group from contig {gid}: main thread "
              f"{m_s} s, worker {w_s} s")
    total = sum(m_s + w_s for m_s, w_s in per.values())
    print(f"[pipeline] (b) rank_limit={PIPELINE_RANK_LIMIT}: {len(per)} "
          f"groups, build wall {wall} s against main + worker {total} s "
          f"(main {sum(v[0] for v in per.values())} s); theta.cu "
          f"launches {launches}")
    if len(per) < 4 or not all(w_s > 0 for _, w_s in per.values()):
        raise AssertionError(f"[pipeline] (b) groups {per}")
    for f in _NPZ_FIELDS:
        if not np.array_equal(getattr(got, f), getattr(idx, f)):
            raise AssertionError(f"[pipeline] (b) index array {f} differs "
                                 f"from the one-group build's")
    if (got.names, got.freq_threshold) != (idx.names, idx.freq_threshold):
        raise AssertionError("[pipeline] (b) index metadata differs")
    if launches <= 0:
        raise AssertionError("[pipeline] (b) launched no theta kernel")
    print(f"[pipeline] (b) {len(_NPZ_FIELDS)} index arrays == the "
          f"one-group build's")
    return launches


def card_vs_cpu(fa, device, pi=PI, tag="[small]", card_kw=None):
    """The index arrays and PAF bytes of `device` equal the CPU's at
    --pi `pi` (the card's run with Parameters card_kw); returns the card
    run's theta launches (theta.cu's, theta_wide.cu's)."""
    import numpy as np
    import torch
    from mashmap_tpu_torch.api import build_or_load_index, map_files
    from mashmap_tpu_torch.index.builder import _NPZ_FIELDS
    from mashmap_tpu_torch.kernels import theta
    cpu = torch.device("cpu")
    runs = {}
    for dev in (device, cpu):
        out = small_paf(pi, dev.type)
        kw = (card_kw or {}) if dev == device else {}
        p = params(fa, out, pi, **kw)
        theta.LAUNCHES = theta.WIDE_LAUNCHES = 0
        t0 = time.perf_counter()
        idx = build_or_load_index(p, dev)
        map_files(p, index=idx, device=dev)
        if dev == device:
            launches = (theta.LAUNCHES, theta.WIDE_LAUNCHES)
        print(f"{tag} {dev.type}: s={p.sketch_size} l1_postings_cap="
              f"{p.l1_postings_cap} build + map {time.perf_counter() - t0} s")
        with open(out, "rb") as fh:
            runs[dev.type] = (idx, fh.read())
    (a, pa), (b, pb) = runs[device.type], runs["cpu"]
    for f in _NPZ_FIELDS:
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"index array {f} differs from the CPU's")
    if (a.names, a.freq_threshold) != (b.names, b.freq_threshold):
        raise AssertionError("index metadata differs from the CPU's")
    if pa != pb:
        raise AssertionError("PAF differs from the CPU's")
    rows = pa.count(b"\n")
    print(f"{tag} {device.type} == cpu: {len(_NPZ_FIELDS)} index arrays, "
          f"{rows} PAF rows, {len(pa)} bytes; theta launches (theta.cu, "
          f"theta_wide.cu) {launches}")
    if rows == 0:
        raise AssertionError("the small workload mapped nothing")
    if sum(launches) <= 0:
        raise AssertionError(f"{tag} launched no theta kernel")
    return launches


def check_dp(device):
    """banded_dp_trace against banded_dp_trace_torch on the card, exactly:
    every byte of every piece's record (its result fields and its ops), at
    each bucket, on random and edge pieces; returns the largest absolute
    difference of a result field or an op byte (0)."""
    import numpy as np
    import torch
    from mashmap_tpu_torch.align import kernel as K
    from mashmap_tpu_torch.align.driver import PIECE_BUCKETS
    from test_torch_dp_pieces import dp_edge_pieces, dp_pieces, free_ends
    worst = 0
    for P, W in PIECE_BUCKETS:
        for kind, arrays in (("random", dp_pieces(P, W, DP_CHECK_B, P + W)),
                             ("edges", dp_edge_pieces(P, W))):
            B = len(arrays[2])
            t = K.dp_inputs(*arrays, free_ends(B), device)
            got = K.banded_dp_trace(*t, p_len=P, width=W)
            want = K.banded_dp_trace_torch(*t, p_len=P, width=W)
            torch.cuda.synchronize()
            (gr, go), (wr, wo) = (K.unpack_trace(x.cpu().numpy(), P, W)
                                  for x in (got, want))
            err = max(int(np.abs(g.astype(np.int64) - w).max())
                      for g, w in ((gr, wr), (go, wo)))
            ok = wr[:, K.RES_OK] != 0
            print(f"[dp-check] P={P} W={W} {kind} B={B}: max_abs_err={err} "
                  f"over {got.numel()} record bytes; {int(ok.sum())} pieces "
                  f"ok, {int(wr[:, K.RES_LEN].sum())} path bytes")
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(
                    f"banded_dp_trace kernel disagrees with its plain version "
                    f"at P={P} W={W} on {kind} pieces")
            if not ok.any():
                raise AssertionError(f"[dp-check] no walk at P={P} W={W}")
            worst = max(worst, err)
    return worst


def dp_bound_ms(n, path_len, P, W, R, rec_bytes):
    """The least time the card could take for banded_dp_trace on these
    pieces: the inputs read once (q, r, n, m, lo and both flags) and the
    records written once, over the HBM rate; DP_OPS_PER_CELL int32
    operations per cell of rows 1..n of each piece, one compare per cell
    of row n (the end state), and DP_OPS_PER_STEP per step of the paths
    these pieces took, over the int32 rate. Returns (ms, "bytes" or
    "operations", bytes, operations)."""
    B = len(n)
    n_bytes = B * (P + R) + B * (3 * 4 + 2) + B * rec_bytes
    n_ops = (DP_OPS_PER_CELL * W * int(n.sum()) + W * B
             + DP_OPS_PER_STEP * int(path_len.sum()))
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, n_ops)


def dp_time(device, kernel_reps=20, plain_reps=3, copy_reps=3):
    """Per bucket, on random pieces at B = DP_TIME_B and at the aligner's
    batch for the bucket: the kernel's ms (median of kernel_reps by CUDA
    events), the records' device-to-host ms, the plain version's ms and
    the bound. Returns {(P, W, B): record}."""
    import torch
    from mashmap_tpu_torch.align import driver
    from mashmap_tpu_torch.align import kernel as K
    from test_torch_dp_pieces import dp_pieces, free_ends
    recs = {}
    for P, W in driver.PIECE_BUCKETS:
        for B in sorted({DP_TIME_B, driver.BATCH[(P, W)]}):
            arrays = dp_pieces(P, W, B, 7 * P + W)
            t = K.dp_inputs(*arrays, free_ends(B), device)
            out = {}
            ms = time_ms(lambda: out.update(
                got=K.banded_dp_trace(*t, p_len=P, width=W)), kernel_reps)
            d2h_ms = time_ms(lambda: out["got"].cpu(), copy_reps, warmup=0)
            plain_ms = time_ms(lambda: K.banded_dp_trace_torch(
                *t, p_len=P, width=W), plain_reps, warmup=0)
            res, _ = K.unpack_trace(out["got"].cpu().numpy(), P, W)
            bound_ms, bound_by, n_bytes, n_ops = dp_bound_ms(
                arrays[2], res[:, K.RES_LEN], P, W, t[1].shape[1],
                out["got"].shape[1])
            print(f"[dp-time] P={P} W={W} B={B}: kernel {ms} ms, records "
                  f"to host {d2h_ms} ms, plain {plain_ms} ms; bound "
                  f"{bound_ms} ms by {bound_by} (bytes {n_bytes}, int32 "
                  f"operations {n_ops}); kernel/bound {ms / bound_ms}; "
                  f"rows {int(arrays[2].sum())}, ok "
                  f"{int(res[:, K.RES_OK].sum())}, path steps "
                  f"{int(res[:, K.RES_LEN].sum())}")
            recs[(P, W, B)] = {"P": P, "W": W, "B": B, "ms": ms,
                               "plain_ms": plain_ms, "d2h_ms": d2h_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by}
            del out, t
            torch.cuda.empty_cache()
    return recs


def cli_phase(fa, api_paf):
    """`python -m mashmap_tpu_torch.cli` in a subprocess with bench.py's
    flags must write the API path's PAF byte for byte; then the same with
    --legacy. Returns the legacy mapping's path."""
    env = {**os.environ, "PYTHONPATH": HERE + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    outs = {}
    for tag, extra in (("paf", []), ("legacy", ["--legacy"])):
        out = os.path.join(DATA, f"smoke_cli.{tag}")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "mashmap_tpu_torch.cli", "-r", fa,
             "-s", "5000", "-k", "19", "--pi", "85", "-Y", "#", "-n", "1",
             "-o", out, *extra], cwd=HERE, env=env, capture_output=True,
            text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"the CLI ({tag}) failed:\n{r.stderr[-3000:]}")
        meter = [ln for ln in r.stderr.splitlines() if "::map] mapped" in ln]
        with open(out) as fh:
            outs[tag] = fh.read()
        print(f"[cli] {tag}: {time.perf_counter() - t0} s, "
              f"{outs[tag].count(chr(10))} rows, meter lines {len(meter)}: "
              f"{meter[-1] if meter else 'none'}")
    if outs["paf"] != api_paf:
        raise AssertionError("the CLI's PAF differs from the API path's")
    print("[cli] PAF == the API path's PAF, byte for byte")
    return os.path.join(DATA, "smoke_cli.legacy")


def _align_run(fa, mapping, out, device):
    """align.cli.main at --pi 85; returns (AlignStats, wall s), the stats
    read from align_files' summary log record."""
    import logging
    from mashmap_tpu_torch.align import cli as align_cli
    got = []

    class Grab(logging.Handler):
        def emit(self, record):
            if hasattr(record, "align_stats"):
                got.append(record.align_stats)

    log = logging.getLogger("mashmap_tpu_torch.align")
    h = Grab()
    log.addHandler(h)
    level = log.level
    log.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        rc = align_cli.main(["-s", fa, "-q", fa, "--mappingFile", mapping,
                             "--pi", "85", "-o", out], device=device)
        wall = time.perf_counter() - t0
    finally:
        log.removeHandler(h)
        log.setLevel(level)
    if rc != 0 or len(got) != 1:
        raise AssertionError(f"align.cli.main returned {rc} with "
                             f"{len(got)} summaries")
    return got[0], wall


def sha256(path):
    import hashlib
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def align_phase(fa, mapping, device, names):
    """The aligner's main path on the card, DP launches counted; its
    output must be the bytes ALIGN_SHA256 fingerprints. Returns
    (launches, stats)."""
    from mashmap_tpu_torch.align import kernel as K
    out = os.path.join(DATA, "smoke_align.aln")
    with open(mapping) as fh:
        rows = [ln.split() for ln in fh if ln.strip()]
    q_bp = sum(int(f[3]) - int(f[2]) + 1 for f in rows)
    K.LAUNCHES = 0
    st, wall = _align_run(fa, mapping, out, device)
    launches = K.LAUNCHES
    host_ms = 1e3 * (st.anchor_s + st.traceback_s + st.host_dp_s)
    print(f"[align] rows in {st.rows_in}, rows out {st.rows_out}, pieces "
          f"per bucket {st.pieces}, pieces to the host DP "
          f"{st.host_pieces}, DP launches {launches} (calls "
          f"{st.dp_calls})")
    print(f"[align] DP kernel device {st.dp_ms} ms, records to host "
          f"{st.d2h_ms} ms, host {host_ms} ms (anchors "
          f"{1e3 * st.anchor_s}, traceback {1e3 * st.traceback_s}, host DP "
          f"{1e3 * st.host_dp_s}), wall {wall} s, aligned query "
          f"{q_bp} bp, {q_bp / 1e6 / wall} Mbp/s")
    print(f"[align] copy to host {st.d2h_ms / 1e3} s and host traceback "
          f"{st.traceback_s} s; with the rows on the host (PERF.md): "
          f"{ROWS_DESIGN_S['copy']} s and {ROWS_DESIGN_S['traceback']} s")
    if launches <= 0:
        raise AssertionError("the aligner's main path launched no DP kernel")
    with open(out) as fh:
        got = {ln.split()[0] for ln in fh if ln.strip()}
    missing = [n for n in names if n not in got]
    if missing:
        raise AssertionError(f"no alignment row for queries {missing}")
    digest = sha256(out)
    print(f"[align] output sha256 {digest}, expected {ALIGN_SHA256}")
    if digest != ALIGN_SHA256:
        raise AssertionError("the alignment output differs from the bytes "
                             "the rows design wrote on the card")
    return launches, st


def profile_align(fa, mapping, device, top=12):
    """The aligner's main path once more under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _align_run(fa, mapping, os.path.join(DATA, "smoke_align_prof.aln"),
                   device)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    print_profile("[align-profile]", "align", prof, wall_ms, top,
                  "banded_dp")


def align_small(fa, device):
    """The small pangenome's legacy mapping (on the card) aligned on the
    card and on the CPU: the same bytes, at least one row."""
    import torch
    from mashmap_tpu_torch import cli
    mapping = os.path.join(DATA, "smoke_small.legacy")
    cli.main(["-r", fa, "--pi", "85", "-Y", "#", "-n", "1", "--legacy",
              "--noProgress", "-o", mapping], device=device)
    outs = {}
    for dev in (device, torch.device("cpu")):
        out = os.path.join(DATA, f"smoke_small_{dev.type}.aln")
        st, wall = _align_run(fa, mapping, out, dev)
        with open(out, "rb") as fh:
            outs[dev.type] = fh.read()
        print(f"[align-small] {dev.type}: {st.rows_out} of {st.rows_in} "
              f"rows, pieces {st.pieces}, host DP {st.host_pieces}, wall "
              f"{wall} s")
    if outs[device.type] != outs["cpu"]:
        raise AssertionError("the card's alignment differs from the CPU's")
    rows = outs["cpu"].count(b"\n")
    if rows == 0:
        raise AssertionError("the small workload aligned nothing")
    print(f"[align-small] {device.type} == cpu: {rows} rows, "
          f"{len(outs['cpu'])} bytes")


def peak_bytes(device):
    """Peak device bytes since the last call."""
    import torch
    v = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return v


def two_entry_phase(tag, fa, device, want_paf, shard, reps=2):
    """The main path's pangenome through a Mapper on [device, device]:
    the index split in two shards (shard=True) or replicated with the
    batches split in two blocks. Each run's PAF must equal the main
    path's; returns the theta launches of the build."""
    import torch
    from mashmap_tpu_torch.api import build_or_load_index
    from mashmap_tpu_torch.kernels import theta
    from mashmap_tpu_torch.map.engine import Mapper
    devices = [device, device]
    for rep in range(reps):
        out = os.path.join(DATA, f"smoke_{tag[1:-1]}_{rep}.paf")
        p = params(fa, out)
        p.shard_index = shard
        peak_bytes(device)
        theta.LAUNCHES = 0
        t0 = time.perf_counter()
        idx = build_or_load_index(p, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = theta.LAUNCHES
        build_peak = peak_bytes(device)
        mapper = Mapper(p, idx, devices=devices)
        batches = [0]
        with count_batches(batches), step_counts() as steps, \
                open(out, "w") as fh:
            mapper.run(p.query_sequences, fh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if shard:
            # the sharded steps stay eager, as the JAX package's prewarm
            # leaves them out
            if any(steps["calls"].values()):
                raise AssertionError(f"{tag} a sharded step ran through "
                                     f"the graph cache: {steps}")
        else:
            check_steps(f"{tag} run {rep}:", steps, 2 * batches[0],
                        warm=rep > 0)
        if shard:
            si = mapper._sharded
            if si is None or si.n_shards != 2:
                raise AssertionError(f"{tag} the index was not split in "
                                     f"two shards")
            layout = (f"n_shards={si.n_shards} p_shard={si.p_shard} "
                      f"gather cap a shard={min(si.p_shard, p.l1_postings_cap)} "
                      f"bytes per shard={si.shard_bytes()}")
        else:
            if mapper._sharded is not None or len(mapper.devices) != 2:
                raise AssertionError(f"{tag} not the replicated 2-block path")
            layout = f"devices={[str(d) for d in mapper.devices]}"
        with open(out) as fh:
            paf = fh.read()
        print(f"{tag} run {rep}: build_s={t1 - t0} map_s={t2 - t1} "
              f"theta_launches={launches} {layout}")
        print(f"{tag} run {rep}: path_stats={mapper.path_stats} "
              f"max_memory_allocated build={build_peak} "
              f"map={peak_bytes(device)}")
        if launches <= 0:
            raise AssertionError(f"{tag} the build launched no theta kernel")
        if paf != want_paf:
            raise AssertionError(f"{tag} PAF differs from the main path's")
    print(f"{tag} PAF == the main path's PAF, byte for byte")
    return launches


# one process of the port's CLI; reports its theta launches on stderr
DIST_RUN = ("import sys; from mashmap_tpu_torch import cli; "
            "from mashmap_tpu_torch.kernels import theta; "
            "rc = cli.main(sys.argv[1:]); "
            "print(f'[dist-proc] theta_launches={theta.LAUNCHES}', "
            "file=sys.stderr); sys.exit(rc)")


def dist_phase(fa, cli_paf, device):
    """Two processes of the CLI on the card, meeting at a coordinator on
    127.0.0.1, in the default mode and in -f one-to-one: the merged PAF
    equals the single-process CLI's (the [cli] phase's for the default
    mode, cli.main in this process for one-to-one), and no part file is
    left. Returns each process's theta launches."""
    from mashmap_tpu_torch import cli
    env = {**os.environ, "PYTHONPATH": HERE + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    flags = ["-r", fa, "-s", "5000", "-k", "19", "--pi", "85", "-Y", "#",
             "-n", "1", "--noProgress"]
    launches = []
    for mode, extra in (("map", []), ("one-to-one", ["-f", "one-to-one"])):
        if mode == "map":
            want = cli_paf
        else:
            single = os.path.join(DATA, "smoke_dist_single.o2o")
            cli.main(flags + extra + ["-o", single], device=device)
            with open(single) as fh:
                want = fh.read()
        out = os.path.join(DATA, f"smoke_dist.{mode}")
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{sk.getsockname()[1]}"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", DIST_RUN, *flags, *extra, "-o", out,
             "--coordinator", coord, "--numProcesses", "2",
             "--processId", str(pid)], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(2)]
        try:
            errs = [pr.communicate(timeout=600)[1] for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        wall = time.perf_counter() - t0
        for pid, (pr, err) in enumerate(zip(procs, errs)):
            if pr.returncode != 0:
                raise RuntimeError(f"[dist] {mode} process {pid} failed:\n"
                                   f"{err[-3000:]}")
            n = [int(ln.split("=")[1]) for ln in err.splitlines()
                 if ln.startswith("[dist-proc] theta_launches=")]
            if not n or n[0] <= 0:
                raise AssertionError(f"[dist] {mode} process {pid} "
                                     f"launched no theta kernel")
            launches.append(n[0])
        with open(out) as fh:
            got = fh.read()
        parts = [f for f in os.listdir(DATA) if ".part" in f]
        print(f"[dist] {mode}: 2 processes, wall {wall} s, "
              f"{got.count(chr(10))} rows, theta launches "
              f"{launches[-2:]}, part files left {parts}")
        if parts:
            raise AssertionError(f"[dist] part files left: {parts}")
        if got != want:
            raise AssertionError(f"[dist] {mode}: merged PAF differs from "
                                 f"the single-process CLI's")
        print(f"[dist] {mode}: merged PAF == the single-process CLI's, "
              f"byte for byte")
    return launches


def overlimit_phase(device, n_bp=OVERLIMIT_BP):
    """One random contig of n_bp bases, over the default rank limit:
    built through the host route at the default limit (theta launches
    counted) and through the device route at 2^30, at the sketch size
    the CLI derives for a reference of that size at --pi 85. Every
    index array must be equal. Returns the host route's theta
    launches."""
    import numpy as np
    import torch
    from genomes import random_genome
    from mashmap_tpu_torch.index import builder
    from mashmap_tpu_torch.kernels import theta
    from mashmap_tpu_torch.params import Parameters
    p = Parameters(ref_sequences=[], percentage_identity=PI,
                   reference_size=n_bp + n_bp // 80 + 10).finalize()
    k, w, s = p.kmer_size, p.seg_length, p.sketch_size
    t0 = time.perf_counter()
    contigs = [("overlimit", random_genome(n_bp, seed=SEED))]
    n = n_bp - k + 1
    print(f"[overlimit] contig {n_bp} bp, {n} positions (default rank "
          f"limit {builder.DEFAULT_RANK_LIMIT}), k={k} w={w} s={s}; "
          f"made in {time.perf_counter() - t0} s")
    if n <= builder.DEFAULT_RANK_LIMIT:
        raise AssertionError("[overlimit] the contig is not over the limit")
    built = {}
    for route, limit in (("host", builder.DEFAULT_RANK_LIMIT),
                         ("device", 2 ** 30)):
        peak_bytes(device)
        theta.LAUNCHES = 0
        t0 = time.perf_counter()
        built[route] = builder.build_index(contigs, k, w, s,
                                           rank_limit=limit, device=device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        built[route + "_launches"] = theta.LAUNCHES
        idx = built[route]
        print(f"[overlimit] {route} route (rank_limit={limit}): build_s="
              f"{t1 - t0} theta_launches={theta.LAUNCHES} "
              f"max_memory_allocated={peak_bytes(device)} "
              f"minmer rows={len(idx.mi_rank)} unique="
              f"{len(idx.uniq_hashes)} postings={len(idx.post_seqid)}")
    a, b = built["host"], built["device"]
    for f in builder._NPZ_FIELDS:
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"[overlimit] index array {f}: host route "
                                 f"!= device route")
    if (a.names, a.freq_threshold) != (b.names, b.freq_threshold):
        raise AssertionError("[overlimit] index metadata differs")
    if built["host_launches"] <= 0:
        raise AssertionError("[overlimit] the host route launched no theta "
                             "kernel")
    if len(a.mi_rank) == 0:
        raise AssertionError("[overlimit] empty index")
    print(f"[overlimit] host route == device route: "
          f"{len(builder._NPZ_FIELDS)} index arrays equal")
    return built["host_launches"]


@contextlib.contextmanager
def grab_mappers(got):
    """Mapper.run appends its Mapper to got (to read path_stats and the
    cutoff table of a map_files run)."""
    from mashmap_tpu_torch.map import engine
    run = engine.Mapper.run

    def grab(self, *a, **kw):
        got.append(self)
        return run(self, *a, **kw)
    engine.Mapper.run = grab
    try:
        yield
    finally:
        engine.Mapper.run = run


def cut_fasta(fa, n_bp, tag):
    """The first n_bp of fa's first record, under its own name, as a
    FASTA of its own (a cut of the query set; the reference stays
    whole)."""
    from mashmap_tpu_torch.io import for_each_seq_in_file
    from genomes import write_fasta
    name, seq = next(iter(for_each_seq_in_file(fa)))
    path = os.path.join(DATA, f"smoke_cut_{tag}.fa")
    write_fasta(path, [(name, seq[:n_bp])])
    return path


def wide_map(tag, p, device, idx=None):
    """build_or_load_index (unless idx is given) and map_files on the
    card with theta launches counted from 0; prints and returns (index,
    PAF, theta_wide.cu launches, Mapper, map s, step_counts' counts)."""
    import torch
    from mashmap_tpu_torch.api import build_or_load_index, map_files
    from mashmap_tpu_torch.kernels import theta
    peak_bytes(device)
    theta.LAUNCHES = theta.WIDE_LAUNCHES = 0
    t0 = time.perf_counter()
    if idx is None:
        idx = build_or_load_index(p, device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    build_peak = peak_bytes(device)
    mappers, batches = [], [0]
    with grab_mappers(mappers), count_batches(batches), \
            step_counts() as steps:
        map_files(p, index=idx, device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with open(p.out_file_name) as fh:
        paf = fh.read()
    reserved = torch.cuda.max_memory_reserved(device)
    print(f"[wide-s] {tag} s={p.sketch_size} pi={p.percentage_identity} "
          f"l1_postings_cap={p.l1_postings_cap}: build_s={t1 - t0} "
          f"map_s={t2 - t1} theta launches: theta_wide.cu "
          f"{theta.WIDE_LAUNCHES}, theta.cu {theta.LAUNCHES}; "
          f"paf_rows={paf.count(chr(10))} path_stats={mappers[0].path_stats} "
          f"max_memory_allocated build={build_peak} map={peak_bytes(device)} "
          f"(reserved {reserved})")
    check_steps(f"[wide-s] {tag}", steps, batches[0], warm=False,
                l2=bool(mappers[0].path_stats["l2_buckets"]))
    if theta.LAUNCHES != 0:
        raise AssertionError(f"[wide-s] {tag} launched theta.cu")
    return idx, paf, theta.WIDE_LAUNCHES, mappers[0], t2 - t1, steps


@contextlib.contextmanager
def l2_budget(n_bytes):
    """map/engine.py's L2 byte budget set to n_bytes for the block."""
    from mashmap_tpu_torch.map import engine
    old = engine.L2_BYTES
    engine.L2_BYTES = n_bytes
    try:
        yield
    finally:
        engine.L2_BYTES = old


def budget_maps(tag, p, device, idx, want_paf):
    """p mapped against idx on the card with the L2 byte budget lifted,
    then at the module's budget again: each run's PAF must equal
    want_paf (the run at the budget before these)."""
    from mashmap_tpu_torch.map import engine
    for what, n_bytes in (("lifted", NO_L2_BUDGET),
                          ("default", engine.L2_BYTES)):
        with l2_budget(n_bytes):
            paf = wide_map(f"{tag} L2 budget {what} ({n_bytes} B)", p,
                           device, idx)[1]
        if paf != want_paf:
            raise AssertionError(f"[wide-s] {tag} the PAF with the L2 "
                                 f"budget {what} differs")
    print(f"[wide-s] {tag} L2 budget lifted == default: the same PAF")


def coverage_gate(tag, paf, names):
    cov = coverage(paf.splitlines())
    print(f"[wide-s] {tag} coverage min="
          f"{min(cov.values()) if cov else 0.0} of {len(cov)}/{len(names)} "
          f"sequences")
    bad = {n: cov.get(n, 0.0) for n in names if cov.get(n, 0.0) < 0.92}
    if bad:
        raise AssertionError(f"[wide-s] {tag} coverage gate failed: {bad}")


def wide_phase(fa, device, names, table_job):
    """[wide-s]: sketch sizes above 512 on the card, through
    build_or_load_index and map_files, the index always the whole
    pangenome's. (a) --pi 78 (auto s = 680, cutoff filter on; its table
    from table_job, the child of start_cutoff_table) with l1_postings_cap
    lifted to WIDE_P_CAP, so that the device map runs for every
    fragment; (a') a cut of the queries mapped
    against (a)'s index at the default cap (every fragment takes the host
    route) and at WIDE_P_CAP: the same PAF; (b) -J 3780 --pi 75
    --noHgFilter on a cut of the queries (its one fragment overflows the
    postings cap and takes the host route); (c) -J 1790 --pi 78
    --noHgFilter on a cut of the queries, the cap lifted, so that L2
    calls at a human-scale s run on the device, cut by the L2 byte budget
    (the slices longer than L2_T_MAX replay on the host). (a) and (c) are
    mapped again with the budget lifted and at it: the same PAF; (c) also
    on the CPU: the same PAF. Each builds through theta_wide.cu alone and
    passes the coverage gate. Returns the wide launches of (a), (b) and
    (c)."""
    import torch
    from mashmap_tpu_torch import stats
    from mashmap_tpu_torch.api import map_files
    from mashmap_tpu_torch.kernels import graphs
    from mashmap_tpu_torch.params import FIXED, Parameters
    # the earlier phases' table set and graph pool go back to the driver
    graphs.clear(device)
    print(f"[wide-s] card memory "
          f"{torch.cuda.get_device_properties(device).total_memory} bytes")
    # (a) the whole pangenome at s = 680
    p = params(fa, os.path.join(DATA, "smoke_wide_a.paf"), PI_WIDE,
               l1_postings_cap=WIDE_P_CAP)
    job_out, _ = table_job.communicate()
    if table_job.returncode != 0:
        raise AssertionError(f"[wide-s] (a) the cutoff table's process "
                             f"exited {table_job.returncode}")
    t0 = time.perf_counter()
    tbl = stats.sketch_cutoffs(p.sketch_size, p.kmer_size, p.ANIDiff,
                               p.ANIDiffConf, FIXED.ss_table_max)
    print(f"[wide-s] (a) cutoff table s={len(tbl) - 1} computed in "
          f"{job_out.strip()} s by a child process, beside the card's "
          f"phases; read back in {time.perf_counter() - t0} s")
    idx, paf, launches_a, m, _, _ = wide_map("(a)", p, device)
    coverage_gate("(a)", paf, names)
    peak_vs_eager("[wide-s] (a)", params(
        fa, os.path.join(DATA, "smoke_wide_a_peak.paf"), PI_WIDE,
        l1_postings_cap=WIDE_P_CAP), device, paf, idx)
    if launches_a <= 0:
        raise AssertionError("[wide-s] (a) launched no theta_wide.cu")
    l2_widths_line("(a)", p, m)
    budget_maps("(a)", p, device, idx, paf)
    # (a') a cut of the queries at the default cap and at WIDE_P_CAP
    cut = cut_fasta(fa, WIDE_CUT_BP, "a")
    pafs = []
    for cap in (Parameters.l1_postings_cap, WIDE_P_CAP):
        pc = params(fa, os.path.join(DATA, f"smoke_wide_cut_{cap}.paf"),
                    PI_WIDE, query_sequences=[cut], l1_postings_cap=cap)
        _, paf_c, _, m, map_s, _ = wide_map(f"(a') cap {cap}", pc, device,
                                            idx)
        n_frag = -(-WIDE_CUT_BP // pc.seg_length)
        print(f"[wide-s] (a') cap {cap}: {m.path_stats['host_frags']} of "
              f"{n_frag} fragments to the host L1 route, "
              f"{map_s / n_frag} s a fragment")
        pafs.append(paf_c)
    if pafs[0] != pafs[1] or not pafs[0]:
        raise AssertionError("[wide-s] (a') the host route's PAF differs "
                             "from the device route's")
    print("[wide-s] (a') host route PAF == device route PAF, byte for byte")
    del idx
    graphs.clear(device)
    # (b) the whole pangenome's index at s = 3780, a cut of the queries
    cut = cut_fasta(fa, HUMAN_CUT_BP, "b")
    p = params(fa, os.path.join(DATA, "smoke_wide_b.paf"), PI_HUMAN,
               sketch_size=S_HUMAN, stage1_topANI_filter=False,
               query_sequences=[cut])
    _, paf, launches_b, _, _, _ = wide_map("(b)", p, device)
    coverage_gate("(b)", paf, names[:1])
    if launches_b <= 0:
        raise AssertionError("[wide-s] (b) launched no theta_wide.cu")
    # (c) the whole pangenome's index at s = 1790, a cut of the queries:
    # device L2 calls cut by the byte budget, then lifted, then the CPU
    cut = cut_fasta(fa, L2_CUT_BP, "c")
    kw = dict(sketch_size=S_HUMAN78, stage1_topANI_filter=False,
              query_sequences=[cut], l1_postings_cap=L2_CUT_P_CAP)
    p = params(fa, os.path.join(DATA, "smoke_wide_c.paf"), PI_HUMAN78, **kw)
    idx, paf, launches_c, m, _, steps = wide_map("(c)", p, device)
    coverage_gate("(c)", paf, names[:1])
    if launches_c <= 0:
        raise AssertionError("[wide-s] (c) launched no theta_wide.cu")
    if not l2_widths_line("(c)", p, m):
        raise AssertionError("[wide-s] (c) cut no L2 call on the card")
    budget_maps("(c)", p, device, idx, paf)
    pc = params(fa, os.path.join(DATA, "smoke_wide_c_cpu.paf"), PI_HUMAN78,
                **kw)
    t0 = time.perf_counter()
    map_files(pc, index=idx, device=torch.device("cpu"))
    with open(pc.out_file_name) as fh:
        if fh.read() != paf:
            raise AssertionError("[wide-s] (c) card PAF differs from the "
                                 "CPU's")
    print(f"[wide-s] (c) cpu map_s={time.perf_counter() - t0}; card PAF "
          f"== CPU PAF")
    # (c)'s one device L2 call widened to the budget's full call width
    l2_peak_gate("[wide-s] (c)", p, device, m, steps.pop("last"))
    return {"a": launches_a, "b": launches_b, "c": launches_c}


def l2_widths_line(tag, p, m):
    """Prints, for each L2 bucket the Mapper m filled, its items and the
    call width (W_STEP, W_SMALL) at the L2 byte budget and without it;
    returns whether the budget cut a call width of those buckets."""
    from mashmap_tpu_torch.map import engine
    area = p.l2_batch * p.l2_entries_cap // 2
    cut = False
    for T, n in sorted(m.path_stats["l2_buckets"].items()):
        w = engine._l2_widths(area, T, p.sketch_size)
        with l2_budget(NO_L2_BUDGET):
            full = engine._l2_widths(area, T, p.sketch_size)
        print(f"[wide-s] {tag} T={T}: {n} items, call width {w} "
              f"(without the budget {full})")
        cut |= w != full
    return cut


def flagship_pair():
    """scripts/gen_flagship_data.py's pair at FLAGSHIP_SCALE in
    data/generated/, written unless both files are there: (reference,
    assembly)."""
    ref = os.path.join(DATA, f"hg3g_s{FLAGSHIP_SCALE:g}.fa")
    asm = os.path.join(DATA, f"hg3g_asm_s{FLAGSHIP_SCALE:g}.fa")
    if not (os.path.exists(ref) and os.path.exists(asm)):
        t0 = time.perf_counter()
        subprocess.run([sys.executable,
                        os.path.join(HERE, "scripts", "gen_flagship_data.py"),
                        "--scale", f"{FLAGSHIP_SCALE:g}"], check=True,
                       capture_output=True)
        print(f"[flagship] generated {os.path.getsize(ref)} + "
              f"{os.path.getsize(asm)} bytes in {time.perf_counter() - t0} s")
    return ref, asm


def flagship_ont_phase(device):
    """[flagship-ont]: FLAGSHIP_ONT_READS ONT-shaped reads of the
    [flagship] reference through the entry points a user calls,
    build_or_load_index (the index resident) and map_files with it, at
    --pi 85 -f map and -J FLAGSHIP_ONT_S on the card; theta launches
    counted from 0 before the build and read after the map. Gates: the
    PAF's sha256 == FLAGSHIP_ONT_SHA256 (the JAX package's PAF on the
    same files), the truth gate (flagship_torch.truth_shares: at least
    MIN_TRUTH of the reads have a row on their origin chromosome and
    strand overlapping their origin), theta.cu launched and theta_wide.cu
    not. Then theta.cu on the build's block rows, timed, and on the
    first FLAGSHIP_CHECK_ROWS timed beside its plain version and its
    bound, and equal to it. Returns (theta.cu's launches, the record)."""
    import torch
    import flagship_torch as ft
    from mashmap_tpu_torch import stats
    from mashmap_tpu_torch.api import build_or_load_index, map_files
    from mashmap_tpu_torch.io import for_each_seq_in_file
    from mashmap_tpu_torch.kernels import graphs, theta
    from mashmap_tpu_torch.params import FIXED, Parameters
    t_phase = time.perf_counter()
    # the earlier phases' graph pools go, so the peaks reserved are this
    # phase's own
    graphs.clear(device)
    ref, _ = flagship_pair()
    reads = ft.reads_path(ref, FLAGSHIP_ONT_READS, FLAGSHIP_ONT_SEED)
    out = os.path.join(DATA, "smoke_flagship_ont.paf")
    try:
        t0 = time.perf_counter()
        q_bp = ft.write_reads(ref, FLAGSHIP_ONT_READS, FLAGSHIP_ONT_SEED,
                              reads)
        print(f"[flagship-ont] {FLAGSHIP_ONT_READS} reads, {q_bp} bp "
              f"(seed {FLAGSHIP_ONT_SEED}) written in "
              f"{time.perf_counter() - t0} s")
        p = Parameters(ref_sequences=[ref], query_sequences=[reads],
                       out_file_name=out, percentage_identity=PI_ONT,
                       sketch_size=FLAGSHIP_ONT_S, no_progress=True)
        p.finalize()
        table = stats.cutoffs_cache_path(p.sketch_size, p.kmer_size,
                                         p.ANIDiff, p.ANIDiffConf,
                                         FIXED.ss_table_max)
        on_disk = os.path.exists(table)
        ft.peak_device_bytes(device, reset=True)
        theta.LAUNCHES = theta.WIDE_LAUNCHES = 0
        t0 = time.perf_counter()
        idx = build_or_load_index(p, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        build_peaks = ft.peak_device_bytes(device, reset=True)
        n_minmers, n_rows = len(idx.uniq_hashes), len(idx.mi_rank)
        mappers = []
        with grab_mappers(mappers):
            map_files(p, index=idx, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        map_peaks = ft.peak_device_bytes(device, reset=True)
        launches = theta.LAUNCHES
        del idx
        graphs.clear(device)
        with open(out) as fh:
            paf = fh.read().splitlines()
        names = [n for n, _ in for_each_seq_in_file(reads)]
        truth, mapped = ft.truth_shares(names, paf)
        print(f"[flagship-ont] k={p.kmer_size} w={p.seg_length} "
              f"s={p.sketch_size} pi={p.percentage_identity} "
              f"filter_mode={p.filter_mode}: {n_minmers} unique "
              f"minmers, {n_rows} interval rows; build_s "
              f"{t1 - t0} map_s {t2 - t1} query_bp={q_bp} "
              f"query_mbp_per_s={q_bp / 1e6 / (t2 - t1)} "
              f"paf_rows={len(paf)} path_stats={mappers[0].path_stats} "
              f"cutoff table on disk before the map (the child process): "
              f"{on_disk}; theta launches: theta.cu {launches}, "
              f"theta_wide.cu {theta.WIDE_LAUNCHES}; peak device bytes "
              f"build={build_peaks} map={map_peaks}")
        print(f"[flagship-ont] truth {truth} (gate {ft.MIN_TRUTH}), "
              f"mapped {mapped} of {len(names)} reads")
        got = sha256(out)
        if got != FLAGSHIP_ONT_SHA256:
            raise AssertionError(f"[flagship-ont] PAF sha256 {got} != the "
                                 f"JAX package's {FLAGSHIP_ONT_SHA256}")
        print("[flagship-ont] PAF sha256 == FLAGSHIP_ONT_SHA256 (the JAX "
              "package's PAF)")
        if truth < ft.MIN_TRUTH:
            raise AssertionError(f"[flagship-ont] truth gate failed: "
                                 f"{truth} < {ft.MIN_TRUTH}")
        if launches <= 0 or theta.WIDE_LAUNCHES != 0:
            raise AssertionError(f"[flagship-ont] launched theta.cu "
                                 f"{launches} times and theta_wide.cu "
                                 f"{theta.WIDE_LAUNCHES}")
        rec = flagship_ont_theta(p, device)
        rec.update(build_s=t1 - t0, map_s=t2 - t1,
                   query_mbp_per_s=q_bp / 1e6 / (t2 - t1), truth=truth)
    finally:
        for path in (reads, out):
            if os.path.exists(path):
                os.remove(path)
    print(f"[flagship-ont] {time.perf_counter() - t_phase} s")
    return launches, rec


def flagship_ont_theta(p, device, tag="[flagship-ont]"):
    """theta.cu on the block rows of the build of ``tag``'s phase: the
    kernel's median ms over all of them (in the build's launches) and
    their byte bound; on the first FLAGSHIP_CHECK_ROWS the kernel held
    to its plain version (flagship_torch.theta_check: both timed, the
    bound from their bytes and the int32 operations they need). Returns
    the record."""
    import torch
    import flagship_torch as ft
    from mashmap_tpu_torch.kernels import theta
    cur, nxt = main_path_blocks(p, device)
    C, s_b = cur.shape
    s = p.sketch_size
    step = theta.theta_rows_per_launch(device, s, s_b)
    ms = time_ms(lambda: [theta.theta_chunk(cur[c:c + step],
                                            nxt[c:c + step], s, s_b)
                          for c in range(0, C, step)], 5)
    bytes_ms = 1e3 * 3 * C * s_b * 4 / HBM_BYTES_PER_S
    rows = {"cur": cur[:FLAGSHIP_CHECK_ROWS].contiguous(),
            "nxt": nxt[:FLAGSHIP_CHECK_ROWS].contiguous(), "s": s,
            "s_b": s_b}
    del cur, nxt
    torch.cuda.empty_cache()
    check = ft.theta_check(device, rows)
    print(f"{tag} theta.cu on the build's block rows C={C} "
          f"S_B={s_b} s={s} in {-(-C // step)} launch(es): {ms} ms (byte "
          f"bound {bytes_ms} ms); on the first {check['rows']}: "
          f"{check['ms']} ms, plain {check['plain_ms']} ms, bound "
          f"{check['bound_ms']} ms ({check['bound_by']}), "
          f"max_abs_err={check['max_abs_err']}")
    if check["max_abs_err"] != 0:
        raise AssertionError(f"{tag} theta.cu disagrees with its plain "
                             f"version")
    return {"path": tag[1:-1], "C": C, "S_B": s_b, "s": s, "ms": ms,
            "bytes_bound_ms": bytes_ms, "check_rows": check["rows"],
            "check_ms": check["ms"], "check_plain_ms": check["plain_ms"],
            "check_bound_ms": check["bound_ms"],
            "check_bound_by": check["bound_by"],
            "max_abs_err": check["max_abs_err"]}


def flagship_rl_phase(device):
    """[flagship-rl]: BASELINE.json's configuration 5 at the [flagship]
    pair's scale through the entry points a user calls: a --rl list of
    the reference and its ALTs (flagship_torch.write_alts at
    FLAGSHIP_SCALE: 261 contigs), build_or_load_index (the index
    resident), then map_files of a whole-contig cut of the assembly with
    that index at --pi 85 -J FLAGSHIP_ONT_S, once for each count of
    flagship_torch.SHARDS: replicated on the card, and split by
    --shardIndex on the card listed that many times. theta launches
    counted from 0 before the build and read after the last map. Gates:
    each PAF's sha256 == FLAGSHIP_RL_SHA256 (the JAX package's), each map
    ran the shards it asked for (the sharded steps eager) over two
    batches or more with a row on an ALT, the contigs the
    reference's and the ALTs', theta.cu launched and theta_wide.cu not,
    and theta.cu equal to its plain version on the build's first
    FLAGSHIP_CHECK_ROWS block rows. Returns (theta.cu's launches, the
    record)."""
    import torch
    import flagship_torch as ft
    from mashmap_tpu_torch.api import build_or_load_index, map_files
    from mashmap_tpu_torch.kernels import graphs, theta
    from mashmap_tpu_torch.params import Parameters
    t_phase = time.perf_counter()
    graphs.clear(device)
    ref, asm = flagship_pair()
    alts = ft.alts_path(ref, ft.ALTS_SEED, FLAGSHIP_SCALE)
    out = os.path.join(DATA, "smoke_flagship_rl.paf")
    query = None
    try:
        t0 = time.perf_counter()
        alt_bp = ft.write_alts(ref, ft.ALTS_SEED, alts, FLAGSHIP_SCALE)
        query, n_ctg, q_bp = ft.write_subset(asm, FLAGSHIP_RL_QUERY_GBP,
                                             FLAGSHIP_RL_QUERY_FIRST)
        print(f"[flagship-rl] {ft.ALTS_COUNT} ALTs, {alt_bp} bp (seed "
              f"{ft.ALTS_SEED}), and a cut of {n_ctg} whole contigs, {q_bp} "
              f"bp, written in {time.perf_counter() - t0} s")
        refs = [ref, alts]
        p = Parameters(ref_sequences=refs, percentage_identity=PI_ONT,
                       sketch_size=FLAGSHIP_ONT_S, no_progress=True)
        p.finalize()
        ft.peak_device_bytes(device, reset=True)
        theta.LAUNCHES = theta.WIDE_LAUNCHES = 0
        t0 = time.perf_counter()
        idx = build_or_load_index(p, device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_primary = len(ft.fasta_layout(ref))
        print(f"[flagship-rl] k={p.kmer_size} w={p.seg_length} "
              f"s={p.sketch_size}: {idx.n_contigs} contigs, "
              f"{len(idx.uniq_hashes)} unique minmers, {len(idx.mi_rank)} "
              f"interval rows; build_s {build_s}; peak device bytes "
              f"{ft.peak_device_bytes(device, reset=True)}")
        if idx.n_contigs != n_primary + ft.ALTS_COUNT:
            raise AssertionError(f"[flagship-rl] {idx.n_contigs} contigs, "
                                 f"not {n_primary} + {ft.ALTS_COUNT}")
        alt_names = {r[0] for r in ft.fasta_layout(alts)}
        maps = {}
        for n in ft.SHARDS:
            pm = Parameters(ref_sequences=refs, query_sequences=[query],
                            out_file_name=out, percentage_identity=PI_ONT,
                            sketch_size=FLAGSHIP_ONT_S, shard_index=n > 1,
                            no_progress=True)
            graphs.clear(device)
            mappers, batches = [], [0]
            t0 = time.perf_counter()
            with grab_mappers(mappers), step_counts() as steps, \
                    count_batches(batches):
                map_files(pm, index=idx, devices=[device] * n)
            torch.cuda.synchronize()
            map_s = time.perf_counter() - t0
            m = mappers[0]
            si = m._sharded
            got = sha256(out)
            with open(out) as fh:
                rows = fh.read().splitlines()
            alt_rows = sum(ln.split("\t")[5] in alt_names for ln in rows)
            layout = ("replicated" if si is None else
                      f"p_shard={si.p_shard} u_shard={si.u_shard} "
                      f"m_shard={si.m_shard} bytes per shard="
                      f"{si.shard_bytes()} postings per shard="
                      f"{ft.postings_a_shard(idx, si)}")
            print(f"[flagship-rl] shards={n}: map_s {map_s} query_mbp_per_s "
                  f"{q_bp / 1e6 / map_s} path_stats={m.path_stats} "
                  f"{layout}; {batches[0]} batches; step calls through the "
                  f"graph cache {steps['calls']}; peak device bytes "
                  f"{ft.peak_device_bytes(device, reset=True)}; {len(rows)} "
                  f"rows, {alt_rows} on ALTs; sha256 {got}")
            if (si.n_shards if si is not None else 1) != n:
                raise AssertionError(f"[flagship-rl] asked for {n} shards, "
                                     f"ran {layout}")
            # the cut spans batches, and rows on the list's second file
            # take the ALTs' ids through the (sharded) lookup
            if batches[0] < 2 or alt_rows < 1:
                raise AssertionError(f"[flagship-rl] shards={n}: "
                                     f"{batches[0]} batches, {alt_rows} "
                                     f"rows on ALTs")
            # the sharded steps stay eager, as the JAX package's prewarm
            # leaves them out; the replicated steps replay graphs
            if (n > 1) == any(steps["calls"].values()):
                raise AssertionError(f"[flagship-rl] shards={n}: step calls "
                                     f"through the graph cache "
                                     f"{steps['calls']}")
            if got != FLAGSHIP_RL_SHA256:
                raise AssertionError(f"[flagship-rl] shards={n}: PAF sha256 "
                                     f"{got} != the JAX package's "
                                     f"{FLAGSHIP_RL_SHA256}")
            maps[n] = {"map_s": map_s, "batches": batches[0],
                       "alt_rows": alt_rows, "shard_bytes": (
                           si.shard_bytes() if si is not None else None)}
            del m, si, mappers
        launches = theta.LAUNCHES
        graphs.clear(device)
        del idx
        print(f"[flagship-rl] every PAF sha256 == FLAGSHIP_RL_SHA256 (the JAX "
              f"package's), shards {list(ft.SHARDS)}; theta "
              f"launches: theta.cu {launches}, theta_wide.cu "
              f"{theta.WIDE_LAUNCHES}")
        if launches <= 0 or theta.WIDE_LAUNCHES != 0:
            raise AssertionError(f"[flagship-rl] launched theta.cu "
                                 f"{launches} times and theta_wide.cu "
                                 f"{theta.WIDE_LAUNCHES}")
        rec = flagship_ont_theta(p, device, "[flagship-rl]")
        rec.update(build_s=build_s, maps=maps)
    finally:
        for path in (alts, query, out):
            if path is not None and os.path.exists(path):
                os.remove(path)
    print(f"[flagship-rl] {time.perf_counter() - t_phase} s")
    return launches, rec


def flagship_phase(device):
    """[flagship]: the human-scale path at 62 Mbp through the entry
    points a user calls: build_or_load_index with --saveIndex, then
    map_files with --loadIndex on the card, theta launches counted from
    0 before the build and read after the map. Gates: the PAF's sha256
    == FLAGSHIP_S002_SHA256, theta.cu launched, every assembly contig's
    coverage >= 0.92. Then theta.cu on the build's block rows, timed and
    held to its plain version. Returns theta.cu's launches."""
    import torch
    from mashmap_tpu_torch.api import build_or_load_index, map_files
    from mashmap_tpu_torch.io import for_each_seq_in_file
    from mashmap_tpu_torch.kernels import theta
    from mashmap_tpu_torch.params import Parameters
    ref, asm = flagship_pair()
    npz = os.path.join(DATA, "smoke_flagship.idx.npz")
    out = os.path.join(DATA, "smoke_flagship.paf")
    try:
        lens = {n: len(q) for n, q in for_each_seq_in_file(asm)}
        q_bp = sum(lens.values())
        peak_bytes(device)
        theta.LAUNCHES = theta.WIDE_LAUNCHES = 0
        t0 = time.perf_counter()
        pb = Parameters(ref_sequences=[ref], percentage_identity=PI_FLAGSHIP,
                        save_index_filename=npz, no_progress=True).finalize()
        idx = build_or_load_index(pb, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        build_peak = peak_bytes(device)
        pm = Parameters(ref_sequences=[ref], query_sequences=[asm],
                        out_file_name=out, load_index_filename=npz,
                        percentage_identity=PI_FLAGSHIP, no_progress=True)
        mappers = []
        with grab_mappers(mappers):
            map_files(pm, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = theta.LAUNCHES
        with open(out) as fh:
            paf = fh.read()
        print(f"[flagship] k={pm.kmer_size} w={pm.seg_length} "
              f"s={pm.sketch_size}: {len(idx.uniq_hashes)} unique minmers, "
              f"{len(idx.mi_rank)} interval rows; build_s (with the save) "
              f"{t1 - t0} map_s (with the load) {t2 - t1} query_bp={q_bp} "
              f"query_mbp_per_s={q_bp / 1e6 / (t2 - t1)} "
              f"paf_rows={paf.count(chr(10))} "
              f"path_stats={mappers[0].path_stats} theta launches: theta.cu "
              f"{launches}, theta_wide.cu {theta.WIDE_LAUNCHES}; "
              f"max_memory_allocated build={build_peak} "
              f"map={peak_bytes(device)}")
        got = sha256(out)
        if got != FLAGSHIP_S002_SHA256:
            raise AssertionError(f"[flagship] PAF sha256 {got} != the JAX "
                                 f"package's {FLAGSHIP_S002_SHA256}")
        print("[flagship] PAF sha256 == FLAGSHIP_S002_SHA256 (the JAX "
              "package's PAF)")
        if launches <= 0:
            raise AssertionError("[flagship] launched no theta.cu")
        cov = coverage(paf.splitlines())
        print(f"[flagship] coverage min="
              f"{min(cov.values()) if cov else 0.0} of "
              f"{len(cov)}/{len(lens)} assembly contigs")
        bad = {n: cov.get(n, 0.0) for n in lens if cov.get(n, 0.0) < 0.92}
        if bad:
            raise AssertionError(f"[flagship] coverage gate failed: {bad}")
        flagship_theta(pb, device)
        groups_launches = pipeline_groups(pb, idx, device)
    finally:
        for path in (ref, asm, npz, out):
            if os.path.exists(path):
                os.remove(path)
    return launches, groups_launches


def flagship_theta(p, device):
    """theta.cu on the block rows of the flagship build (its one contig
    group): the kernel's median ms over them, and the kernel equal to
    its plain version on the first FLAGSHIP_CHECK_ROWS."""
    import torch
    from mashmap_tpu_torch.kernels import theta
    cur, nxt = main_path_blocks(p, device)
    C, s_b = cur.shape
    s = p.sketch_size
    step = theta.theta_rows_per_launch(device, s, s_b)
    ms = time_ms(lambda: [theta.theta_chunk(cur[c:c + step],
                                            nxt[c:c + step], s, s_b)
                          for c in range(0, C, step)], 5)
    c, n = (x[:FLAGSHIP_CHECK_ROWS].contiguous() for x in (cur, nxt))
    got = theta.theta_chunk(c, n, s, s_b)
    err = max_abs_err(got, theta.theta_chunk_ref(c, n, s, s_b))
    print(f"[flagship] theta.cu on the group's block rows C={C} S_B={s_b} "
          f"s={s} in {-(-C // step)} launch(es): {ms} ms; max_abs_err="
          f"{err} on the first {len(c)} rows")
    if err != 0:
        raise AssertionError("[flagship] theta.cu disagrees with its plain "
                             "version on the flagship rows")
    del cur, nxt
    torch.cuda.empty_cache()


def cutoff_table_job(fa, pi):
    """Compute the cutoff table of `fa` at --pi `pi` into
    $XDG_CACHE_HOME (the disk memo of stats.sketch_cutoffs) and print
    the seconds it took."""
    from mashmap_tpu_torch import stats
    from mashmap_tpu_torch.params import FIXED
    p = params(fa, os.devnull, pi)
    t0 = time.perf_counter()
    stats.sketch_cutoffs(p.sketch_size, p.kmer_size, p.ANIDiff,
                         p.ANIDiffConf, FIXED.ss_table_max)
    print(time.perf_counter() - t0)


def start_cutoff_table(fa, pi):
    """Start cutoff_table_job in a child process (host SciPy only, no
    card), so that minutes of host time overlap the card's phases; the
    caller reads its output and stops it."""
    return start_child(f"cutoff_table_job({fa!r}, {pi!r})")


def start_child(call):
    """Run chip_smoke.<call> in a child process with its stdout piped."""
    return subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
        cwd=HERE, stdout=subprocess.PIPE, text=True)


def configs_prep_job():
    """Write bench_extra_torch's data at bench_extra.py's sizes, then
    compute the cutoff tables of [flagship-ont] (s = FLAGSHIP_ONT_S) and
    of [configs]' one-to-one run and dense sweep into $XDG_CACHE_HOME
    (the ONT and --rl runs share s = 130 with the main path, which
    computes that table cold); print the seconds of each step."""
    import bench_extra_torch as bext
    from mashmap_tpu_torch import stats
    from mashmap_tpu_torch.params import FIXED, Parameters
    t0 = time.perf_counter()
    data = bext.make_data(DATA, bext.FULL)
    print(f"data {time.perf_counter() - t0}", flush=True)
    ont = Parameters(reference_size=1, percentage_identity=PI_ONT,
                     sketch_size=FLAGSHIP_ONT_S)
    for p in [ont, bext.oto_params(data, os.devnull)] + [
            bext.dense_params(data, os.devnull, s) for s in bext.SWEEP]:
        p.finalize()
        t0 = time.perf_counter()
        stats.sketch_cutoffs(p.sketch_size, p.kmer_size, p.ANIDiff,
                             p.ANIDiffConf, FIXED.ss_table_max)
        print(f"s={p.sketch_size} {time.perf_counter() - t0}", flush=True)


def configs_phase(device, prep_job):
    """[configs]: bench_extra_torch's configurations (BASELINE.json's
    one-to-one, ONT reads, --dense/-J sweep and --rl) on the card at
    bench_extra.py's sizes, each held by bench_extra_torch.check (its
    PAF's sha256 the JAX package's, EXTRA_SHA256; the coverage gate; the
    sweep's ANI error), theta.cu's launches counted from 0 for each; then
    theta.cu on each configuration's build rows timed and equal to its
    plain version on the first CONFIG_CHECK_ROWS. Returns the launches
    by configuration and config_theta's records."""
    import bench_extra_torch as bext
    from mashmap_tpu_torch.kernels import theta
    t0 = time.perf_counter()
    job_out, _ = prep_job.communicate()
    if prep_job.returncode != 0:
        raise RuntimeError(f"[configs] the data and cutoff table job "
                           f"exited {prep_job.returncode}")
    print(f"[configs] data and cutoff tables (a child process since "
          f"phase 3), seconds: {job_out.split(chr(10))[:-1]}")
    data = bext.make_data(DATA, bext.FULL)
    steps = [(bext.one_to_one, ()), (bext.ont_reads, ())] + [
        (bext.dense_step, (s,)) for s in bext.SWEEP] + [
        (bext.multiref_rl, ())]
    by_path, params_by_key = {}, {}
    for fn, args in steps:
        peak_bytes(device)
        theta.LAUNCHES = theta.WIDE_LAUNCHES = 0
        mappers = []
        with grab_mappers(mappers):
            r = fn(data, device, *args)
        by_path[r.key] = theta.LAUNCHES
        params_by_key[r.key] = mappers[0].p
        print(f"[configs] {r.key} s={r.sketch_size}: map_files "
              f"{r.seconds} s (build {r.build_s} s) paf_rows={r.rows} "
              f"path_stats={mappers[0].path_stats} theta launches: "
              f"theta.cu {theta.LAUNCHES}, theta_wide.cu "
              f"{theta.WIDE_LAUNCHES}; max_memory_allocated "
              f"{peak_bytes(device)}")
        if r.key == "oto":
            print(f"[configs] oto coverage min="
                  f"{bext.coverage_min(data, r)[0]}")
        elif r.key == "ont":
            print(f"[configs] ont reads mapped "
                  f"{bext.mapped_fraction(data, r)}")
        elif r.key.startswith("dense"):
            print(f"[configs] {r.key} |ANI error| {bext.ani_error(r)} pp")
        bad = bext.check(data, r)
        if bad:
            raise AssertionError(f"[configs] {bad}")
        if theta.LAUNCHES <= 0 or theta.WIDE_LAUNCHES != 0:
            raise AssertionError(f"[configs] {r.key} launched theta.cu "
                                 f"{theta.LAUNCHES} times and theta_wide.cu "
                                 f"{theta.WIDE_LAUNCHES}")
    print(f"[configs] every PAF sha256 == EXTRA_SHA256 (the JAX "
          f"package's): {sorted(by_path)}")
    recs = [config_theta(key, p, device) for key, p in params_by_key.items()]
    print(f"[configs] {time.perf_counter() - t0} s")
    return by_path, recs


def config_theta(key, p, device):
    """theta.cu on the block rows of a [configs] build: the kernel's
    median ms over all of them and the bound for them; the kernel and its
    plain version timed on the first CONFIG_CHECK_ROWS, and equal there.
    Returns the record."""
    import torch
    from mashmap_tpu_torch.kernels import theta
    cur, nxt = main_path_blocks(p, device)
    C, s_b = cur.shape
    s = p.sketch_size
    ms = time_ms(lambda: theta.theta_chunk(cur, nxt, s, s_b), 5)
    counts = theta_schedule_counts(cur.cpu().numpy(), nxt.cpu().numpy(), s,
                                   theta.SEG_K)
    bound_ms, bound_by = theta_bound_ms(C, s_b, s, counts)
    c, n = (x[:CONFIG_CHECK_ROWS].contiguous() for x in (cur, nxt))
    out = {}
    check_ms = time_ms(
        lambda: out.update(got=theta.theta_chunk(c, n, s, s_b)), 5)
    plain_ms = time_ms(
        lambda: out.update(want=theta.theta_chunk_ref(c, n, s, s_b)), 1,
        warmup=0)
    err = max_abs_err(out["got"], out["want"])
    print(f"[configs] {key} theta.cu on the build's rows C={C} S_B={s_b} "
          f"s={s}: {ms} ms (bound {bound_ms} ms, {bound_by}); on the first "
          f"{len(c)}: {check_ms} ms, plain {plain_ms} ms, max_abs_err={err}")
    if err != 0:
        raise AssertionError(f"[configs] {key} theta.cu disagrees with its "
                             f"plain version")
    del cur, nxt
    torch.cuda.empty_cache()
    return {"path": key, "C": C, "S_B": s_b, "s": s, "ms": ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "check_rows": len(c), "check_ms": check_ms,
            "check_plain_ms": plain_ms, "max_abs_err": err}


def build_all():
    """Build the theta kernels (both sources), the banded DP kernel and
    the native FASTA reader, all started together (each build is its own
    nvcc or g++ process); print the time, each kernel instance's
    registers and spills, and which reader loaded."""
    from concurrent.futures import ThreadPoolExecutor
    from mashmap_tpu_torch import native
    from mashmap_tpu_torch.align import kernel as dp
    from mashmap_tpu_torch.kernels import theta
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        jobs = [ex.submit(theta.load_library),
                ex.submit(theta.load_wide_library),
                ex.submit(dp.load_library),
                ex.submit(native.native_available)]
        have_native = [j.result() for j in jobs][-1]
    print(f"[build] theta.cu, theta_wide.cu, banded_dp_trace.cu and the "
          f"native reader built and loaded in {time.perf_counter() - t0} s")
    print_ptxas(theta.ptxas_log_path())
    print_ptxas(theta.ptxas_log_path(wide=True))
    print_ptxas(dp.ptxas_log_path())
    print(f"[build] FASTA reader: "
          f"{'native (C++)' if have_native else 'Python'}")


def main():
    """Run every phase with the cutoff tables in a fresh cache directory,
    removed at the end."""
    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["XDG_CACHE_HOME"] = cache
    try:
        return run()
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def run():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    device = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"devices {torch.cuda.device_count()}")

    # 2. build
    build_all()

    fa_main = fasta(N_HAP, HAP_LEN, DIVERGENCE, SEED)
    fa_small = fasta(*SMALL)
    jobs = [start_cutoff_table(fa_main, PI_WIDE), start_child(
        "configs_prep_job()")]
    try:
        return phases(device, fa_main, fa_small, *jobs, t_start)
    finally:
        for job in jobs:
            if job.poll() is None:
                job.kill()
            job.wait()


def phases(device, fa_main, fa_small, table_job, prep_job, t_start):
    """Phases 3 to 15 and the last two lines."""
    import torch
    from mashmap_tpu_torch.io import for_each_seq_in_file
    # 3. theta against its plain version, then times on the main path's
    # rows, at s = 130 (theta.cu) and at --pi 78, s = 680 (theta_wide.cu)
    err = check_theta(device)
    rec = theta_record(params(fa_main, os.devnull), device)
    wide_rec = theta_record(params(fa_main, os.devnull, PI_WIDE), device)

    # 4. the banded DP against its plain version, then times per bucket
    dp_err = check_dp(device)
    dp_recs = dp_time(device)

    # 5. main path, then once more under the profiler
    launches, paf = main_path(fa_main, device)
    profile_main_path(fa_main, device)

    # 6. card against CPU, then the pipelined map at many batches
    card_vs_cpu(fa_small, device)
    pipeline_launches = pipeline_phase(fa_small, device)

    # 7. the mapper's CLI
    legacy = cli_phase(fa_main, paf)

    # 8. the aligner's main path, its profile, and card against CPU
    names = [name for name, _ in for_each_seq_in_file(fa_main)]
    dp_launches, st = align_phase(fa_main, legacy, device, names)
    profile_align(fa_main, legacy, device)
    align_small(fa_small, device)

    # 9. the parallel layer: two shards, two blocks, two processes
    by_path = {"main": launches, "pipeline": pipeline_launches}
    by_path["shard"] = two_entry_phase("[shard]", fa_main, device, paf,
                                       shard=True)
    by_path["mesh"] = two_entry_phase("[mesh]", fa_main, device, paf,
                                      shard=False)
    with open(os.path.join(DATA, "smoke_cli.paf")) as fh:
        by_path["dist"] = dist_phase(fa_main, fh.read(), device)

    # 10. a contig over the rank limit: host route == device route
    by_path["overlimit"] = overlimit_phase(device)

    # 11. sketch sizes above 512: the pangenome at s = 680 and 3780, and
    # the small one at s = 680 on the card and the CPU
    wide_by_path = {f"wide-{k}": v for k, v in wide_phase(
        fa_main, device, names, table_job).items()}
    # (the card maps on its device route, the CPU on the host route)
    wide_by_path["small-pi78"] = card_vs_cpu(
        fa_small, device, PI_WIDE, "[small-pi78]",
        dict(l1_postings_cap=WIDE_P_CAP))[1]

    # 12. ONT-shaped reads of the 62 Mbp reference at --pi 85, -J 310,
    # held to the JAX package's PAF
    by_path["flagship-ont"], ont_rec = flagship_ont_phase(device)

    # 13. the 62 Mbp reference and its ALTs in a --rl list at --pi 85,
    # -J 310, replicated and in 2 and 4 shards, held to the JAX package's
    # PAF
    by_path["flagship-rl"], rl_rec = flagship_rl_phase(device)

    # 14. the human-scale path at 62 Mbp, held to the JAX package's PAF
    by_path["flagship"], by_path["pipeline-groups"] = flagship_phase(device)

    # 15. bench_extra_torch's configurations, held to the JAX package's PAFs
    config_by_path, config_recs = configs_phase(device, prep_job)
    by_path.update(config_by_path)

    rec = {"name": rec.pop("name"), "route": rec.pop("route"),
           "source": rec.pop("source"), "replaces": rec.pop("replaces"),
           "launches": launches,
           "max_abs_err": max(err, rec.pop("max_abs_err")), **rec,
           "launches_by_path": by_path, "configs": config_recs,
           "flagship_ont": ont_rec, "flagship_rl": rl_rec}
    wide_rec = {"name": wide_rec.pop("name"), "route": wide_rec.pop("route"),
                "source": wide_rec.pop("source"),
                "replaces": wide_rec.pop("replaces"),
                "launches": wide_by_path["wide-a"],
                "max_abs_err": max(err, wide_rec.pop("max_abs_err")),
                **wide_rec, "launches_by_path": wide_by_path}
    # the DP's top-level times are those of the bucket that took the most
    # pieces on the aligner's main path, at the aligner's batch there;
    # "buckets" has every bucket at B=512 and at that batch
    from mashmap_tpu_torch.align.driver import BATCH
    P, W = max(BATCH, key=lambda b: st.pieces.get(b, 0))
    top = (P, W, BATCH[(P, W)])
    dp_rec = {"name": "banded_dp_trace", "route": "cuda",
              "source": "mashmap_tpu_torch/align/csrc/banded_dp_trace.cu",
              "replaces": "mashmap_tpu/align/kernel.py:48 (jit lax.scan, "
                          "not Pallas), with the host end state and "
                          "traceback_batch (:171) that read its rows",
              "launches": dp_launches, "max_abs_err": dp_err,
              "ms": dp_recs[top]["ms"],
              "plain_ms": dp_recs[top]["plain_ms"],
              "bound_ms": dp_recs[top]["bound_ms"],
              "bound_by": dp_recs[top]["bound_by"], "library_ms": None,
              "bucket": list(top), "buckets": list(dp_recs.values())}
    print(f"[done] {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": [rec, dp_rec, wide_rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
