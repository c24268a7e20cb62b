#!/usr/bin/env python3
"""Human-scale assembly-to-reference run of the PyTorch/CUDA port.

The port's counterpart of scripts/bench_flagship.py (which drives the
JAX package): a 3.08 Gbp reference of 24 chromosomes and its mutated
assembly, both written by scripts/gen_flagship_data.py into
data/generated/, mapped at --pi 95 with the auto k, w and s
(k = 19, w = 5000, s = 40 at full scale, through the binary's int32
wrap of the reference size). Phases, each printing one JSON line:

1. build: ``build_or_load_index`` on the reference, then
   ``ReferenceIndex.save`` (what --saveIndex runs) and a zip check of
   the npz;
2. subset (``--subset-gbp X``): the whole-contig subset of the assembly,
   contigs in file order until their bases reach X Gbp, written beside
   it as ``<assembly>_<X>g.fa``; the map phases then map the subset;
3. map: ``map_files`` with ``load_index_filename`` (--loadIndex) and
   ``batch_fragments=2048``, the coverage gate of
   scripts/check_coverage.py (0.92 for every query sequence);
4. resident (``--map-twice``): the same queries mapped twice through one
   ``Mapper`` holding the index (the second run is the steady state of
   a mapping service); both PAFs must equal the --loadIndex PAF.

Reads mode (``--reads N``, BASELINE.json's configuration 3, "ONT
long-read set vs single reference, -f map", at MashMap's defaults:
``--pi`` 0.85 unless given, auto s = 310 at full scale): N ONT-shaped
reads (``write_reads``: 10-30 kb, 5% divergence, half of them from the
minus strand, each read's origin in its name) drawn from the reference
with READS_SEED into ``<reference>_ont<N>_seed<S>.fa`` beside it, then
phases

1. reads: their count, bases and the seconds to write them (skipped
   when the file exists);
2. build: ``build_or_load_index`` with the index kept resident (no
   --saveIndex), theta.cu checked against its plain version on the first
   THETA_CHECK_ROWS block rows of the build's first theta call, timed
   there beside its bound;
3. cutoff table: ``stats.sketch_cutoffs`` at the build's s, and whether
   it was on disk already (cold when it was not);
4. map: ``map_files`` with that index (-f map, every other parameter at
   its default), path_stats and the host route's seconds a fragment,
   then the truth gate: at least MIN_TRUTH of the reads have a PAF row
   on their origin chromosome and strand whose reference interval
   overlaps the origin's.

ALTs mode (``--alts``, BASELINE.json's configuration 5, "multi-reference
--rl list mapping (human assembly vs hg38 + alt contigs, sharded index)",
at MashMap's defaults: -f map, ``--pi`` 0.85 unless given, auto k, w, s =
19, 5000, 310 at full scale): ALTS_COUNT contigs shaped like GRCh38's
alternate loci (``write_alts``: copies of primary intervals at 1%
divergence, ALTS_BP x ``--alts-scale`` bases in all, each one's origin in
its name) written beside the reference, a --rl list naming the reference
and then them, and phases

1. alts: their count, bases and the seconds to write them;
2. subset (``--subset-gbp X``), as above;
3. build: ``build_or_load_index`` on the list with the index resident,
   theta.cu checked as in the reads mode; the contigs, and the unique
   minmers and interval rows against the int32 positions of the sharded
   steps;
4. cutoff table, as in the reads mode;
5. one map for each count in ``--shards`` (default 1,2,4), each
   ``map_files`` with that index on the device listed that many times
   (``--shardIndex`` above one), the graph cache cleared before each:
   seconds, query Mbp/s, ``Mapper.phase_s``, path_stats, the shard
   layout, each shard's device bytes and the postings it holds before
   the padding, device peaks, resident set and
   pinned host bytes at its start and end, PAF rows, rows on ALT contigs
   and the sha256; the 2-shard map's kernel launches a batch under
   torch.profiler over two batches;
6. gates: every PAF the same bytes, every map that asked for n shards
   ran n, theta.cu equal to its plain version, every query sequence's
   coverage at least MIN_COVERAGE, and the contigs the reference's plus
   ALTS_COUNT.

Usage:
    python3 scripts/flagship_torch.py [--build-only | --map-only]
        [--map-twice] [--subset-gbp X] [--device cpu]
    python3 scripts/flagship_torch.py --reads N [--pi 0.85] [-J S]
        [--device cpu]
    python3 scripts/flagship_torch.py --alts [--subset-gbp X]
        [--shards 1,2,4] [--alts-scale F] [--alts-seed N] [--pi 0.85]
        [-J S] [--device cpu]

Without ``--map-only`` the build runs when ``--build-only`` is given or
no valid npz exists; without ``--build-only`` the map runs. Paths follow
bench_flagship.py's environment overrides: MASHMAP_TPU_FLAGSHIP_REF,
_ASM, _IDX and _OUT. Runs on the CUDA card; ``--device cpu`` runs the
plain versions on the CPU (the tests' small pairs). Without a card and
without ``--device cpu`` it fails. Exits 1 when a gate fails.
"""

import argparse
import contextlib
import copy
import hashlib
import json
import logging
import mmap
import os
import resource
import subprocess
import sys
import time
import zipfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))
sys.path.insert(0, os.path.join(HERE, "tests"))

DATA = os.path.join(HERE, "data", "generated")
PI = 0.95
BATCH_FRAGMENTS = 2048
MIN_COVERAGE = 0.92
# the JAX package's build of the generator's pairs (seed 314) at --pi 95:
# full scale from NOTES.md (round 5, on its TPU), scale 0.02 from its
# CPU run of `python -m mashmap_tpu.cli -r hg3g_s0.02.fa -q
# hg3g_asm_s0.02.fa --pi 95 --saveIndex ...`
JAX_BUILD = {
    "hg3g.fa": {"k": 19, "w": 5000, "s": 40, "minmers": 28_847_460,
                "interval_rows": 49_325_684},
    "hg3g_s0.02.fa": {"k": 19, "w": 5000, "s": 20, "minmers": 309_688,
                      "interval_rows": 494_450},
}
# reads mode: ONT-shaped reads as bench_extra_torch.py makes them,
# lengths uniform in [10 kb, 30 kb) and 5% divergence through
# tests/genomes.py's mutate (10% of it indels); the truth gate's least
# share
READ_LEN = (10_000, 30_000)
READ_DIVERGENCE = 0.05
READS_SEED = 85
# MashMap's default identity (--pi 85), the reads and ALTs modes' default
PI_MASHMAP = 0.85
MIN_TRUTH = 0.95
# theta.cu against its plain version on this many rows of the build's
# first theta call
THETA_CHECK_ROWS = 1024
I32_MAX = (1 << 31) - 1
# the resident set is sampled this often in each phase of the ALTs mode,
# which stops when the host's available memory falls below this
RSS_EVERY_S = 0.1
MIN_AVAILABLE_BYTES = 3 << 30
# ALTs mode: contigs shaped like GRCh38's alternate loci (the Genome
# Reference Consortium's GRCh38: 261 ALT contigs, about 109 Mbp), lengths
# log-uniform in ALT_LEN before they are scaled to that sum, each a copy
# of a primary interval at 1% divergence; mapped with the reference in a
# --rl list at MashMap's defaults, replicated and split into each count
# of SHARDS
ALTS_COUNT = 261
ALTS_BP = 109_000_000
ALT_LEN = (5_000, 5_000_000)
ALT_DIVERGENCE = 0.01
ALTS_SEED = 261
SHARDS = (1, 2, 4)


def paths():
    """(reference, assembly, npz, PAF) from the environment."""
    env = os.environ.get
    return (env("MASHMAP_TPU_FLAGSHIP_REF", os.path.join(DATA, "hg3g.fa")),
            env("MASHMAP_TPU_FLAGSHIP_ASM",
                os.path.join(DATA, "hg3g_asm.fa")),
            env("MASHMAP_TPU_FLAGSHIP_IDX",
                os.path.join(DATA, "hg3g_torch.idx.npz")),
            env("MASHMAP_TPU_FLAGSHIP_OUT",
                os.path.join(DATA, "flagship_torch.paf")))


def card(device):
    """The card's name and power limit as nvidia-smi prints them (None
    on the CPU)."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def peak_device_bytes(device, reset=False):
    """{"allocated", "reserved"}: torch.cuda.max_memory_allocated and
    max_memory_reserved since the last reset (None on the CPU); with
    reset, the cache's free blocks are released and a new window starts."""
    import torch
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    peak = {"allocated": torch.cuda.max_memory_allocated(device),
            "reserved": torch.cuda.max_memory_reserved(device)}
    if reset:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return peak


def peak_rss_bytes():
    """This process's peak resident set so far (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def rss_bytes():
    """This process's resident set now (Linux's /proc/self/statm)."""
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def available_bytes():
    """The host's available memory (Linux's MemAvailable)."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return None


@contextlib.contextmanager
def watch_rss(phase, got):
    """Samples this process's resident set every RSS_EVERY_S seconds on a
    thread while the block runs and puts the largest in got["peak"]; when
    the host's available memory falls below MIN_AVAILABLE_BYTES it prints
    a JSON line with the phase and the last sample and ends the process
    with exit code 1, before the kernel's out-of-memory killer would."""
    import threading
    got["peak"] = rss_bytes()
    done = threading.Event()

    def sample():
        while not done.wait(RSS_EVERY_S):
            now = rss_bytes()
            got["peak"] = max(got["peak"], now)
            avail = available_bytes()
            if avail is not None and avail < MIN_AVAILABLE_BYTES:
                emit({"phase": phase, "stopped": "host memory",
                      "rss_bytes": now, "peak_rss_in_phase": got["peak"],
                      "available_bytes": avail})
                os._exit(1)
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield got
    finally:
        done.set()
        t.join()


def sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def emit(rec):
    print(json.dumps(rec), flush=True)


def npz_ok(path):
    """The npz opens as a zip and every member's CRC checks."""
    try:
        with zipfile.ZipFile(path) as z:
            return z.testzip() is None
    except (OSError, zipfile.BadZipFile):
        return False


@contextlib.contextmanager
def timed_theta(device, calls, first=None):
    """Each theta_chunk call of the build appends (rows, s, ms) to calls:
    on the card, CUDA events around the call. With ``first`` (a dict),
    the first call's first THETA_CHECK_ROWS rows are kept there."""
    import torch
    from mashmap_tpu_torch.kernels import winnow
    chunk = winnow.theta_chunk

    def timed(cur, nxt, s, s_b):
        if first is not None and not first:
            first.update(cur=cur[:THETA_CHECK_ROWS].clone(),
                         nxt=nxt[:THETA_CHECK_ROWS].clone(), s=s, s_b=s_b)
        if device.type == "cuda":
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = chunk(cur, nxt, s, s_b)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            out = chunk(cur, nxt, s, s_b)
            ms = 1e3 * (time.perf_counter() - t0)
        calls.append((int(cur.shape[0]), s, ms))
        return out
    winnow.theta_chunk = timed
    try:
        yield
    finally:
        winnow.theta_chunk = chunk


def theta_check(device, rows):
    """The kernel that theta_chunk launches for these rows against its
    plain version, theta_chunk_ref: {rows, s, S_B, kernel ms (median of
    5), plain ms (one call), max_abs_err, bound ms and what bounds it
    (chip_smoke.theta_bound_ms: these rows' bytes, and the int32
    operations their inserts and changed offsets need)}. On the CPU
    both are the plain version, timed by the host clock."""
    import torch
    import chip_smoke
    from mashmap_tpu_torch.kernels import theta
    cur, nxt, s, s_b = rows["cur"], rows["nxt"], rows["s"], rows["s_b"]
    out = {}

    def clock(fn, reps):
        if device.type == "cuda":
            return chip_smoke.time_ms(fn, reps, warmup=int(reps > 1))
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    ms = clock(lambda: out.update(got=theta.theta_chunk(cur, nxt, s, s_b)),
               5)
    plain_ms = clock(
        lambda: out.update(want=theta.theta_chunk_ref(cur, nxt, s, s_b)), 1)
    err = int((out["got"].long() - out["want"].long()).abs().max())
    counts = chip_smoke.theta_schedule_counts(
        cur.cpu().numpy(), nxt.cpu().numpy(), s, theta.SEG_K)
    # stdout carries only the JSON lines; the bound's own line goes to
    # stderr
    with contextlib.redirect_stdout(sys.stderr):
        bound_ms, bound_by = chip_smoke.theta_bound_ms(cur.shape[0], s_b, s,
                                                       counts)
    del out
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"rows": int(cur.shape[0]), "S_B": s_b, "s": s, "ms": ms,
            "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def group_seconds():
    """{first contig of a group: [main thread s, worker s]} of the last
    index build: the device part of each contig group runs on the main
    thread, its host part on the build's worker thread
    (index/builder.py's GROUP_PHASE_S and WORKER_PHASES)."""
    from mashmap_tpu_torch.index import builder
    return {gid: [sum(s for k, s in ph.items()
                      if k not in builder.WORKER_PHASES),
                  sum(s for k, s in ph.items()
                      if k in builder.WORKER_PHASES)]
            for gid, ph in builder.GROUP_PHASE_S.items()}


def build_phase(ref, idx_path, device, smi, pi=PI, sketch_size=None):
    """build_or_load_index on ``ref`` (a file, or a list of them as --rl
    names them) at ``pi`` (and -J ``sketch_size`` when given), then, with
    an ``idx_path``, the save and the npz's zip check; without one the
    index stays resident and theta.cu is checked on the first call's rows
    (theta_check). Returns (gates held, index)."""
    import torch
    from mashmap_tpu_torch.api import build_or_load_index
    from mashmap_tpu_torch.kernels import theta
    from mashmap_tpu_torch.params import Parameters
    from mashmap_tpu_torch.native import native_available
    refs = ref if isinstance(ref, list) else [ref]
    p = Parameters(ref_sequences=refs, percentage_identity=pi,
                   sketch_size=sketch_size, no_progress=True).finalize()
    # the theta kernel's nvcc build and the native reader's g++ build
    # happen once per checkout, at first use: outside the build's time
    t0 = time.perf_counter()
    if device.type == "cuda":
        if p.sketch_size <= theta.S_MAX:
            theta.load_library()
        else:
            theta.load_wide_library()
    native_available()
    first_use_s = time.perf_counter() - t0
    peak_device_bytes(device, reset=True)
    rss_before = rss_bytes()
    theta.LAUNCHES = theta.WIDE_LAUNCHES = 0
    # on the card, a resident build's kernel is checked on its own rows
    resident_card = idx_path is None and device.type == "cuda"
    calls, first = [], ({} if resident_card else None)
    t0 = time.perf_counter()
    with timed_theta(device, calls, first):
        idx = build_or_load_index(p, device)
    groups = group_seconds()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    launches = {"theta.cu": theta.LAUNCHES,
                "theta_wide.cu": theta.WIDE_LAUNCHES}
    got = {"k": idx.kmer_size, "w": idx.window_size, "s": idx.sketch_size,
           "minmers": int(len(idx.uniq_hashes)),
           "interval_rows": int(len(idx.mi_rank))}
    # the sharded L1 step's int32 code (position << 1 | found) and the
    # interval rows' int32 positions stay below 2^31
    int32_room = {"l1_code_max": 2 * got["minmers"] + 1,
                  "interval_rows": got["interval_rows"],
                  "int32_max": I32_MAX,
                  "fits": max(2 * got["minmers"] + 1,
                              got["interval_rows"]) <= I32_MAX}
    rec = {"phase": "build", "card": smi, "device": str(device),
           "reference": ref, "reference_bytes": p.reference_size,
           "pi": pi, "first_use_builds_s": first_use_s, "build_s": build_s}
    ok = True
    if idx_path is not None:
        t0 = time.perf_counter()
        idx.save(idx_path)
        rec.update(save_s=time.perf_counter() - t0,
                   npz_bytes=os.path.getsize(idx_path),
                   npz_ok=npz_ok(idx_path))
        ok = rec["npz_ok"]
    rec.update(got)
    rec.update({"theta_launches": launches,
                "theta_calls_rows_s_ms": calls,
                **theta_totals(calls, idx.window_size - idx.kmer_size + 1),
                "groups_main_worker_s": groups,
                "main_s": sum(m for m, _ in groups.values()),
                "worker_s": sum(w for _, w in groups.values()),
                "contigs": idx.n_contigs, "int32_room": int32_room,
                "index_host_bytes": index_bytes(idx),
                "peak_device_bytes": peak_device_bytes(device),
                "rss_bytes_start_end": [rss_before, rss_bytes()],
                "peak_host_rss_bytes": peak_rss_bytes()})
    ok = ok and int32_room["fits"]
    want = JAX_BUILD.get(os.path.basename(refs[0])) if len(refs) == 1 \
        else None
    if want is not None and pi == PI and sketch_size is None:
        rec["jax_build"] = want
        rec["jax_build_equal"] = got == want
        ok = ok and rec["jax_build_equal"]
    if resident_card:
        # the build launched the kernel of its s and not the other one
        used, other = (("theta.cu", "theta_wide.cu")
                       if idx.sketch_size <= theta.S_MAX
                       else ("theta_wide.cu", "theta.cu"))
        ok = ok and launches[used] > 0 and launches[other] == 0
        rec["theta_check"] = theta_check(device, first)
        ok = ok and rec["theta_check"]["max_abs_err"] == 0
    emit(rec)
    return ok, idx


def theta_totals(calls, s_b):
    """The build's theta calls in all: rows, ms, and the byte bound of
    those rows (cur and nxt read once, theta written once, over the
    card's memory rate, chip_smoke.HBM_BYTES_PER_S)."""
    from chip_smoke import HBM_BYTES_PER_S
    rows = sum(c[0] for c in calls)
    return {"theta_rows": rows, "theta_ms": sum(c[2] for c in calls),
            "theta_bytes_bound_ms": 1e3 * 3 * rows * s_b * 4
            / HBM_BYTES_PER_S}


def index_bytes(idx):
    """Bytes of the index's arrays on the host."""
    import numpy as np
    return sum(v.nbytes for v in vars(idx).values()
               if isinstance(v, np.ndarray))


def write_subset(asm, gbp, first=None):
    """The whole contigs of ``asm`` in file order, from the one named
    ``first`` (by default the file's first), until their bases reach
    ``gbp`` Gbp, written byte for byte to ``<asm>_<gbp>g.fa`` (or
    ``<asm>_<first>_<gbp>g.fa``); returns (path, contigs, bases)."""
    stem = asm[:-3] if asm.endswith(".fa") else asm
    out = f"{stem}_{first + '_' if first else ''}{gbp:g}g.fa"
    target = gbp * 1e9
    keep = first is None
    n_ctg = n_bp = 0
    with open(asm, "rb") as src, open(out + ".tmp", "wb") as dst:
        for line in src:
            if line.startswith(b">"):
                keep = keep or line[1:].split()[0].decode() == first
                if n_bp >= target:
                    break
                n_ctg += keep
            elif keep:
                n_bp += len(line.rstrip(b"\r\n"))
            if keep:
                dst.write(line)
    os.replace(out + ".tmp", out)
    return out, n_ctg, n_bp


def fasta_layout(path):
    """[(name, byte offset of its first base, bases, bases a line)] of
    each record of a FASTA file whose lines are as long as the record's
    first, but the last (gen_flagship_data.py's layout), found by
    scanning a memory map for headers, so the file is never read whole."""
    recs = []
    with open(path, "rb") as fh, \
            mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        at = mm.find(b">")
        while at >= 0:
            start = mm.find(b"\n", at) + 1
            name = mm[at + 1:start - 1].split()[0].decode()
            nxt = mm.find(b"\n>", start - 1)
            end = nxt + 1 if nxt >= 0 else len(mm)
            n_bytes = end - start
            width = (mm.find(b"\n", start) - start) if n_bytes else 1
            if n_bytes and mm[end - 1:end] != b"\n":
                raise ValueError(f"{path}: record {name} ends without a "
                                 f"newline")
            full, rem = divmod(n_bytes, width + 1)
            recs.append((name, start, full * width + max(rem - 1, 0),
                         width))
            at = nxt + 1 if nxt >= 0 else -1
    return recs


def window(mm, rec, a, b):
    """Bases [a, b) of the fasta_layout record ``rec`` from the memory
    map (or bytes) ``mm`` of its file."""
    _, off, _, width = rec
    lo, hi = off + a + a // width, off + b - 1 + (b - 1) // width
    return mm[lo:hi + 1].replace(b"\n", b"").decode()


def reads_path(ref, n, seed):
    """Where write_reads puts N reads of ``ref`` drawn with ``seed``:
    beside the reference."""
    stem = ref[:-3] if ref.endswith(".fa") else ref
    return f"{stem}_ont{n}_seed{seed}.fa"


def write_reads(ref, n, seed, out):
    """Write ``n`` ONT-shaped reads of the reference ``ref`` to ``out``:
    each a window of READ_LEN bases (uniform) at a start uniform over the
    chromosomes' bases where the window fits (never across a
    chromosome's end), mutated to READ_DIVERGENCE by tests/genomes.py's
    mutate with a seed of its own, and for n // 2 of them (a random
    half) reverse-complemented. Read i is named
    ``read<i>:<chromosome>:<start>-<end>:<strand>`` (0-based, end
    exclusive, the reference interval it came from). Deterministic from
    ``seed``; the windows are sliced from a memory map of ``ref``.
    Returns the reads' bases."""
    import numpy as np
    from genomes import mutate, revcomp
    layout = fasta_layout(ref)
    lens = np.array([r[2] for r in layout], np.int64)
    rng = np.random.default_rng(seed)
    minus = np.zeros(n, bool)
    minus[rng.permutation(n)[:n // 2]] = True
    n_bp = 0
    with open(ref, "rb") as fh, \
            mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm, \
            open(out + ".tmp", "w") as dst:
        for i in range(n):
            m = int(rng.integers(*READ_LEN))
            room = np.maximum(lens - m + 1, 0)
            cum = np.cumsum(room)
            if cum[-1] == 0:
                raise ValueError(f"{ref}: no chromosome holds {m} bases")
            u = int(rng.integers(0, cum[-1]))
            c = int(np.searchsorted(cum, u, side="right"))
            a = u - int(cum[c] - room[c])
            name = layout[c][0]
            seq = mutate(window(mm, layout[c], a, a + m), READ_DIVERGENCE,
                         seed=int(rng.integers(1 << 31)))
            strand = "-" if minus[i] else "+"
            if minus[i]:
                seq = revcomp(seq)
            dst.write(f">read{i}:{name}:{a}-{a + m}:{strand}\n")
            dst.write("".join(seq[j:j + 80] + "\n"
                              for j in range(0, len(seq), 80)))
            n_bp += len(seq)
    os.replace(out + ".tmp", out)
    return n_bp


def alts_path(ref, seed, scale=1.0):
    """Where write_alts puts the ALT contigs of ``ref``: beside it."""
    stem = ref[:-3] if ref.endswith(".fa") else ref
    return f"{stem}_alts{ALTS_COUNT}_x{scale:g}_seed{seed}.fa"


def write_alts(ref, seed, out, scale=1.0):
    """Write ALTS_COUNT contigs shaped like GRCh38's alternate loci to
    ``out``: lengths drawn log-uniformly from ALT_LEN, then scaled so that
    they sum to ALTS_BP x ``scale``; each one a copy of an interval of a
    chromosome of ``ref`` at a start uniform over the bases where it fits
    (never across a chromosome's end), mutated to ALT_DIVERGENCE by
    tests/genomes.py's mutate with a seed of its own, forward strand.
    Contig i is named ``<chromosome>_alt<i>:<start>-<end>`` (0-based, end
    exclusive). Deterministic from ``seed``; the intervals are sliced from
    a memory map of ``ref``. Returns the ALTs' bases."""
    import numpy as np
    from genomes import mutate
    layout = fasta_layout(ref)
    lens = np.array([r[2] for r in layout], np.int64)
    rng = np.random.default_rng(seed)
    raw = np.exp(rng.uniform(np.log(ALT_LEN[0]), np.log(ALT_LEN[1]),
                             ALTS_COUNT))
    sizes = np.maximum(np.rint(raw * (ALTS_BP * scale / raw.sum())),
                       1).astype(np.int64)
    n_bp = 0
    with open(ref, "rb") as fh, \
            mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm, \
            open(out + ".tmp", "w") as dst:
        for i, m in enumerate(sizes.tolist()):
            room = np.maximum(lens - m + 1, 0)
            cum = np.cumsum(room)
            if cum[-1] == 0:
                raise ValueError(f"{ref}: no chromosome holds {m} bases")
            u = int(rng.integers(0, cum[-1]))
            c = int(np.searchsorted(cum, u, side="right"))
            a = u - int(cum[c] - room[c])
            seq = mutate(window(mm, layout[c], a, a + m), ALT_DIVERGENCE,
                         seed=int(rng.integers(1 << 31)))
            dst.write(f">{layout[c][0]}_alt{i}:{a}-{a + m}\n")
            dst.write("".join(seq[j:j + 80] + "\n"
                              for j in range(0, len(seq), 80)))
            n_bp += len(seq)
    os.replace(out + ".tmp", out)
    return n_bp


def alt_origin(name):
    """(chromosome, start, end) that write_alts put in an ALT's name."""
    head, span = name.rsplit(":", 1)
    start, end = span.split("-")
    return head.rsplit("_alt", 1)[0], int(start), int(end)


def read_origin(name):
    """(chromosome, start, end, strand) that write_reads put in a read's
    name."""
    _, rest = name.split(":", 1)
    chrom, span, strand = rest.rsplit(":", 2)
    start, end = span.split("-")
    return chrom, int(start), int(end), strand


def truth_shares(names, paf_lines):
    """(truth, mapped): the shares of the reads ``names`` with a PAF row
    on their origin chromosome and strand whose reference interval
    overlaps the origin interval, and with any PAF row."""
    hit, mapped = set(), set()
    for line in paf_lines:
        f = line.split("\t")
        mapped.add(f[0])
        chrom, start, end, strand = read_origin(f[0])
        if (f[5], f[4]) == (chrom, strand) and int(f[7]) < end \
                and int(f[8]) > start:
            hit.add(f[0])
    names = set(names)
    return len(hit & names) / len(names), len(mapped & names) / len(names)


@contextlib.contextmanager
def host_route_timer(got):
    """Adds to got["s"] the host seconds of the map's host L1 route: the
    fragment's sketch on the host (sketch_sequence_py) and its map
    (Mapper._map_fragment), which the device pipeline runs only for the
    fragments whose postings exceed l1_postings_cap."""
    from mashmap_tpu_torch.kernels import sketch
    from mashmap_tpu_torch.map import engine
    fns = (sketch.sketch_sequence_py, engine.Mapper._map_fragment)
    got["s"] = 0.0

    def timed(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                got["s"] += time.perf_counter() - t0
        return run
    sketch.sketch_sequence_py = timed(fns[0])
    engine.Mapper._map_fragment = timed(fns[1])
    try:
        yield
    finally:
        sketch.sketch_sequence_py, engine.Mapper._map_fragment = fns


def reads_run(ref, n, seed, pi, sketch_size, out, device, smi):
    """The reads mode's phases (module docstring); True when every gate
    held."""
    import torch
    from mashmap_tpu_torch.api import map_files
    from mashmap_tpu_torch.params import Parameters
    reads = reads_path(ref, n, seed)
    if not os.path.exists(reads):
        t0 = time.perf_counter()
        n_bp = write_reads(ref, n, seed, reads)
        emit({"phase": "reads", "reads": reads, "count": n, "seed": seed,
              "bp": n_bp, "s": time.perf_counter() - t0})
    ok, idx = build_phase(ref, None, device, smi, pi, sketch_size)
    lengths = query_lengths(reads)
    q_bp = sum(lengths.values())
    p = Parameters(ref_sequences=[ref], query_sequences=[reads],
                   out_file_name=out, percentage_identity=pi,
                   sketch_size=idx.sketch_size, no_progress=True).finalize()
    cutoff_phase(p)
    peak_device_bytes(device, reset=True)
    runs, host = [], {}
    t0 = time.perf_counter()
    with recorded_runs(runs), host_route_timer(host):
        map_files(p, index=idx, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    map_s = time.perf_counter() - t0
    m = runs[0][0]
    with open(out) as fh:
        paf = fh.read().splitlines()
    truth, mapped = truth_shares(lengths, paf)
    path = stats_since(m)
    emit({"phase": "map", "card": smi, "device": str(device),
          "query": reads, "reads": len(lengths), "query_bp": q_bp,
          "pi": pi, "filter_mode": p.filter_mode,
          "k": p.kmer_size, "w": p.seg_length, "s": p.sketch_size,
          "map_s": map_s, "query_mbp_per_s": q_bp / 1e6 / map_s,
          "paf_rows": len(paf), "paf_sha256": sha256(out),
          "path_stats": path, "host_route_s": host["s"],
          "host_route_s_a_fragment": (host["s"] / path["host_frags"]
                                      if path["host_frags"] else None),
          "phase_s": m.phase_s, "truth": truth, "mapped": mapped,
          "min_truth": MIN_TRUTH,
          "peak_device_bytes": peak_device_bytes(device),
          "peak_host_rss_bytes": peak_rss_bytes()})
    return ok and truth >= MIN_TRUTH


def cutoff_phase(p):
    """The cutoff table at p's s, timed, and whether it was on disk
    already (cold when it was not)."""
    from mashmap_tpu_torch import stats
    from mashmap_tpu_torch.params import FIXED
    table_args = (p.sketch_size, p.kmer_size, p.ANIDiff, p.ANIDiffConf,
                  FIXED.ss_table_max)
    on_disk = os.path.exists(stats.cutoffs_cache_path(*table_args))
    t0 = time.perf_counter()
    stats.sketch_cutoffs(*table_args)
    emit({"phase": "cutoff table", "s": p.sketch_size,
          "on_disk_before": on_disk, "seconds": time.perf_counter() - t0})


def host_pinned_bytes(reset=False):
    """{"current", "peak"}: the pinned host bytes PyTorch's caching host
    allocator holds (handed out and cached) now and at most since the
    last reset (None on the CPU); with reset, a new window starts."""
    import torch
    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.host_memory_stats()
    if reset:
        torch.cuda.reset_peak_host_memory_stats()
    return {"current": stats.get("allocated_bytes.current"),
            "peak": stats.get("allocated_bytes.peak")}


def launches_a_batch(m, query, device):
    """cudaLaunchKernel and cudaGraphLaunch a batch of the Mapper ``m``
    (its index already on the card) over the first two batches' worth of
    ``query``'s first record, under torch.profiler (None on the CPU)."""
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from genomes import write_fasta
    from mashmap_tpu_torch.io import for_each_seq_in_file
    if device.type != "cuda":
        return None
    name, seq = next(iter(for_each_seq_in_file(query)))
    cut = f"{query}.cut.fa"
    write_fasta(cut, [(name, seq[:2 * m.p.batch_fragments
                                 * m.p.seg_length])])
    batches = [0]
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                chip_smoke.count_batches(batches), open(os.devnull, "w") as fh:
            m.run([cut], fh)
    finally:
        os.remove(cut)
    calls = chip_smoke.runtime_calls(prof)
    return {"batches": batches[0], "calls": calls,
            "a_batch": chip_smoke.per_batch(calls, batches[0])}


def postings_a_shard(idx, si):
    """The postings each shard of the sharded index ``si`` holds before
    p_shard pads them: shard d takes unique hashes [d u_shard, (d + 1)
    u_shard) and their postings."""
    U = len(idx.uniq_hashes)
    cut = [min(d * si.u_shard, U) for d in range(si.n_shards + 1)]
    return [int(idx.post_offsets[b] - idx.post_offsets[a])
            for a, b in zip(cut, cut[1:])]


def alts_run(ref, asm, subset_gbp, shards, seed, scale, pi, sketch_size,
             out, device, smi):
    """The ALTs mode's phases (module docstring); True when every gate
    held."""
    import torch
    from mashmap_tpu_torch.api import map_files
    from mashmap_tpu_torch.kernels import graphs
    from mashmap_tpu_torch.params import Parameters
    alts = alts_path(ref, seed, scale)
    t0 = time.perf_counter()
    n_bp = write_alts(ref, seed, alts, scale)
    emit({"phase": "alts", "alts": alts, "count": ALTS_COUNT, "seed": seed,
          "scale": scale, "bp": n_bp, "s": time.perf_counter() - t0})
    # the primary first, then the ALTs; <out>.rl names them for the CLI's
    # --rl, and the maps below take the same list
    refs = [ref, alts]
    with open(f"{out}.rl", "w") as fh:
        fh.write("".join(f"{r}\n" for r in refs))
    query = asm
    if subset_gbp is not None:
        t0 = time.perf_counter()
        query, n_ctg, q_bp = write_subset(asm, subset_gbp)
        emit({"phase": "subset", "assembly": asm, "subset": query,
              "contigs": n_ctg, "bp": q_bp, "s": time.perf_counter() - t0})
    with watch_rss("build", {}) as watch:
        ok, idx = build_phase(refs, None, device, smi, pi, sketch_size)
    emit({"phase": "build host memory", "peak_rss_in_phase": watch["peak"],
          "rss_bytes": rss_bytes(), "available_bytes": available_bytes(),
          "host_pinned_bytes": host_pinned_bytes(reset=True)})
    n_primary = len(fasta_layout(ref))
    alt_names = {r[0] for r in fasta_layout(alts)}
    contigs_ok = idx.n_contigs == n_primary + ALTS_COUNT
    p = Parameters(ref_sequences=refs, percentage_identity=pi,
                   sketch_size=idx.sketch_size, no_progress=True).finalize()
    cutoff_phase(p)
    lengths = query_lengths(query)
    q_bp = sum(lengths.values())
    shas = []
    for n in shards:
        path = f"{out}.shards{n}"
        pm = Parameters(ref_sequences=refs, query_sequences=[query],
                        out_file_name=path, percentage_identity=pi,
                        sketch_size=sketch_size, shard_index=n > 1,
                        no_progress=True)
        # the earlier map's graphs, their pool and tables leave the card
        graphs.clear(device)
        peak_device_bytes(device, reset=True)
        rss0, avail0 = rss_bytes(), available_bytes()
        pinned0 = host_pinned_bytes(reset=True)
        runs = []
        t0 = time.perf_counter()
        with recorded_runs(runs), watch_rss(f"map shards={n}", {}) as watch:
            map_files(pm, index=idx, devices=[device] * n)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        map_s = time.perf_counter() - t0
        m = runs[0][0]
        si = m._sharded
        n_got = si.n_shards if si is not None else 1
        peaks = peak_device_bytes(device)
        with open(path) as fh:
            paf = fh.read().splitlines()
        low_cov, low = coverage_gate(lengths, path)
        shas.append(sha256(path))
        rec = {"phase": f"map shards={n}", "card": smi,
               "device": str(device), "devices": [str(d) for d in m.devices],
               "query": query, "query_sequences": len(lengths),
               "query_bp": q_bp, "pi": pi, "filter_mode": pm.filter_mode,
               "k": pm.kmer_size, "w": pm.seg_length, "s": pm.sketch_size,
               "map_s": map_s, "query_mbp_per_s": q_bp / 1e6 / map_s,
               "phase_s": m.phase_s, "path_stats": stats_since(m),
               "n_shards": n_got, "paf_rows": len(paf),
               "alt_rows": sum(ln.split("\t")[5] in alt_names
                               for ln in paf),
               "paf_sha256": shas[-1], "coverage_min": low_cov,
               "coverage_below_gate": low, "peak_device_bytes": peaks,
               "rss_bytes_start_end": [rss0, rss_bytes()],
               "peak_rss_in_phase": watch["peak"],
               "available_bytes_at_start": avail0,
               "host_pinned_bytes_start_end": [pinned0,
                                               host_pinned_bytes()],
               "peak_host_rss_bytes": peak_rss_bytes()}
        if si is not None:
            rec.update(p_shard=si.p_shard, u_shard=si.u_shard,
                       m_shard=si.m_shard, shard_bytes=si.shard_bytes(),
                       postings_a_shard=postings_a_shard(idx, si))
        if n == 2:
            rec["launches_a_batch"] = launches_a_batch(m, query, device)
        emit(rec)
        ok = ok and n_got == n and not low and len(paf) > 0
        del m, si, runs
    if device.type == "cuda":
        graphs.clear(device)
    same = len(set(shas)) == 1
    emit({"phase": "alts gates", "pafs_identical": same,
          "contigs": idx.n_contigs, "primary_contigs": n_primary,
          "contigs_ok": contigs_ok})
    return ok and same and contigs_ok


def query_lengths(fa):
    from mashmap_tpu_torch.io import for_each_seq_in_file
    return {name: len(seq) for name, seq in for_each_seq_in_file(fa)}


def coverage_gate(lengths, paf):
    """scripts/check_coverage.py's gate over the query sequences: (lowest
    coverage, names below MIN_COVERAGE)."""
    from check_coverage import coverage_by_sequence
    with open(paf) as fh:
        cov = coverage_by_sequence(lengths, fh)
    low = sorted(n for n, c in cov.items() if c < MIN_COVERAGE)
    return (min(cov.values()) if cov else 0.0), low


@contextlib.contextmanager
def recorded_runs(got):
    """Each Mapper.run appends (Mapper, run seconds) to got."""
    from mashmap_tpu_torch.map import engine
    run = engine.Mapper.run

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        run(self, *a, **kw)
        got.append((self, time.perf_counter() - t0))
    engine.Mapper.run = timed
    try:
        yield
    finally:
        engine.Mapper.run = run


def stats_since(m, before=None):
    """m.path_stats minus the snapshot ``before`` (runs of one Mapper
    add up); all of them without one."""
    now = m.path_stats
    before = before or {"host_frags": 0, "host_l2": 0, "l2_buckets": {}}
    b = before["l2_buckets"]
    return {"host_frags": now["host_frags"] - before["host_frags"],
            "host_l2": now["host_l2"] - before["host_l2"],
            "l2_buckets": {str(t): n - b.get(t, 0)
                           for t, n in sorted(now["l2_buckets"].items())
                           if n != b.get(t, 0)}}


def map_phase(ref, query, idx_path, out, device, smi, twice):
    import torch
    from mashmap_tpu_torch.api import map_files
    from mashmap_tpu_torch.map.engine import Mapper
    from mashmap_tpu_torch.params import Parameters
    lengths = query_lengths(query)
    q_bp = sum(lengths.values())
    p = Parameters(ref_sequences=[ref], query_sequences=[query],
                   out_file_name=out, load_index_filename=idx_path,
                   percentage_identity=PI, batch_fragments=BATCH_FRAGMENTS,
                   no_progress=True)
    peak_device_bytes(device, reset=True)
    runs = []
    t0 = time.perf_counter()
    with recorded_runs(runs):
        idx = map_files(p, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    total_s = time.perf_counter() - t0
    m, run_s = runs[0]
    with open(out) as fh:
        rows = sum(1 for _ in fh)
    low_cov, low = coverage_gate(lengths, out)
    want = sha256(out)
    emit({"phase": "map", "card": smi, "device": str(device),
          "query": query, "query_sequences": len(lengths), "query_bp": q_bp,
          "k": p.kmer_size, "w": p.seg_length, "s": p.sketch_size,
          "total_s": total_s, "map_s": run_s,
          "query_mbp_per_s": q_bp / 1e6 / total_s, "paf_rows": rows,
          "paf_sha256": want, "path_stats": stats_since(m),
          "coverage_min": low_cov, "coverage_below_gate": low,
          "peak_device_bytes": peak_device_bytes(device),
          "peak_host_rss_bytes": peak_rss_bytes()})
    ok = not low and rows > 0
    if not twice:
        return ok
    # the index resident: one Mapper, two runs (the first pays the
    # tables' upload to the card), each PAF == the --loadIndex PAF
    p2 = Parameters(ref_sequences=[ref], query_sequences=[query],
                    out_file_name=out, kmer_size=idx.kmer_size,
                    seg_length=idx.window_size, sketch_size=idx.sketch_size,
                    percentage_identity=PI,
                    batch_fragments=BATCH_FRAGMENTS,
                    no_progress=True).finalize()
    m = Mapper(p2, idx, device=device)
    for run in (1, 2):
        path = f"{out}.resident{run}"
        peak_device_bytes(device, reset=True)
        before = copy.deepcopy(m.path_stats)
        t0 = time.perf_counter()
        with open(path, "w") as fh:
            m.run([query], fh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        run_s = time.perf_counter() - t0
        same = sha256(path) == want
        emit({"phase": f"resident run {run}", "card": smi,
              "device": str(device), "query_bp": q_bp, "map_s": run_s,
              "query_mbp_per_s": q_bp / 1e6 / run_s,
              "paf_equal_to_load_index_paf": same,
              "path_stats": stats_since(m, before),
              "peak_device_bytes": peak_device_bytes(device),
              "peak_host_rss_bytes": peak_rss_bytes()})
        ok = ok and same
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--map-only", action="store_true")
    ap.add_argument("--map-twice", action="store_true")
    ap.add_argument("--subset-gbp", type=float, default=None)
    ap.add_argument("--reads", type=int, default=None, metavar="N",
                    help="reads mode: map N ONT-shaped reads of the "
                         "reference with the index resident")
    ap.add_argument("--pi", type=float, default=None,
                    help=f"identity, a fraction (default {PI} for the "
                         f"assembly, {PI_MASHMAP} for reads and ALTs)")
    ap.add_argument("-J", "--sketch-size", type=int, default=None,
                    help="sketch size (default: the auto s)")
    ap.add_argument("--alts", action="store_true",
                    help="ALTs mode: map the assembly against a --rl list "
                         "of the reference and its ALT contigs, "
                         "replicated and sharded")
    ap.add_argument("--alts-seed", type=int, default=ALTS_SEED)
    ap.add_argument("--alts-scale", type=float, default=1.0,
                    help="the ALTs' bases as a share of ALTS_BP")
    ap.add_argument("--shards", default=",".join(map(str, SHARDS)),
                    help="shard counts of the ALTs mode's maps, in order "
                         "(1: replicated)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from mashmap_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)
    smi = card(device)
    ref, asm, idx_path, out = paths()
    if args.reads is not None:
        pi = PI_MASHMAP if args.pi is None else args.pi
        return 0 if reads_run(ref, args.reads, READS_SEED, pi,
                              args.sketch_size, out, device, smi) else 1
    if args.alts:
        pi = PI_MASHMAP if args.pi is None else args.pi
        shards = [int(n) for n in args.shards.split(",")]
        return 0 if alts_run(ref, asm, args.subset_gbp, shards,
                             args.alts_seed, args.alts_scale, pi,
                             args.sketch_size, out, device, smi) else 1
    if (args.pi, args.sketch_size) != (None, None):
        ap.error("--pi and -J go with --reads or --alts")
    ok = True
    if not args.map_only and (args.build_only or not npz_ok(idx_path)):
        ok = build_phase(ref, idx_path, device, smi)[0] and ok
    if args.build_only:
        return 0 if ok else 1
    query = asm
    if args.subset_gbp is not None:
        t0 = time.perf_counter()
        query, n_ctg, n_bp = write_subset(asm, args.subset_gbp)
        emit({"phase": "subset", "assembly": asm, "subset": query,
              "contigs": n_ctg, "bp": n_bp,
              "s": time.perf_counter() - t0})
    ok = map_phase(ref, query, idx_path, out, device, smi,
                   args.map_twice) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    # the build's and the map's own log lines, timestamped, on stderr
    logging.basicConfig(format="%(asctime)s %(name)s %(message)s")
    logging.getLogger("mashmap_tpu_torch").setLevel(logging.INFO)
    sys.exit(main())
