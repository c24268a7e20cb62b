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

Usage:
    python3 scripts/flagship_torch.py [--build-only | --map-only]
        [--map-twice] [--subset-gbp X] [--device cpu]

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
import os
import resource
import subprocess
import sys
import time
import zipfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

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
    """torch.cuda.max_memory_allocated since the last reset (None on the
    CPU); with reset, starts a new window."""
    import torch
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


def peak_rss_bytes():
    """This process's peak resident set so far (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


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
def timed_theta(device, calls):
    """Each theta_chunk call of the build appends (rows, s, ms) to calls:
    on the card, CUDA events around the call."""
    import torch
    from mashmap_tpu_torch.kernels import winnow
    chunk = winnow.theta_chunk

    def timed(cur, nxt, s, s_b):
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


def build_phase(ref, idx_path, device, smi):
    import torch
    from mashmap_tpu_torch.api import build_or_load_index
    from mashmap_tpu_torch.kernels import theta
    from mashmap_tpu_torch.params import Parameters
    from mashmap_tpu_torch.native import native_available
    p = Parameters(ref_sequences=[ref], percentage_identity=PI,
                   no_progress=True).finalize()
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
    theta.LAUNCHES = theta.WIDE_LAUNCHES = 0
    calls = []
    t0 = time.perf_counter()
    with timed_theta(device, calls):
        idx = build_or_load_index(p, device)
    groups = group_seconds()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    launches = {"theta.cu": theta.LAUNCHES,
                "theta_wide.cu": theta.WIDE_LAUNCHES}
    t0 = time.perf_counter()
    idx.save(idx_path)
    save_s = time.perf_counter() - t0
    got = {"k": idx.kmer_size, "w": idx.window_size, "s": idx.sketch_size,
           "minmers": int(len(idx.uniq_hashes)),
           "interval_rows": int(len(idx.mi_rank))}
    want = JAX_BUILD.get(os.path.basename(ref))
    rec = {"phase": "build", "card": smi, "device": str(device),
           "reference": ref, "reference_bytes": p.reference_size,
           "first_use_builds_s": first_use_s,
           "build_s": build_s, "save_s": save_s,
           "npz_bytes": os.path.getsize(idx_path),
           "npz_ok": npz_ok(idx_path), **got,
           "theta_launches": launches,
           "theta_calls_rows_s_ms": calls,
           "groups_main_worker_s": groups,
           "main_s": sum(m for m, _ in groups.values()),
           "worker_s": sum(w for _, w in groups.values()),
           "peak_device_bytes": peak_device_bytes(device),
           "peak_host_rss_bytes": peak_rss_bytes()}
    if want is not None:
        rec["jax_build"] = want
        rec["jax_build_equal"] = got == want
    emit(rec)
    return rec["npz_ok"] and rec.get("jax_build_equal", True)


def write_subset(asm, gbp):
    """The whole contigs of ``asm`` in file order until their bases reach
    ``gbp`` Gbp, written byte for byte to ``<asm>_<gbp>g.fa``; returns
    (path, contigs, bases)."""
    stem = asm[:-3] if asm.endswith(".fa") else asm
    out = f"{stem}_{gbp:g}g.fa"
    target = gbp * 1e9
    n_ctg = n_bp = 0
    with open(asm, "rb") as src, open(out + ".tmp", "wb") as dst:
        for line in src:
            if line.startswith(b">"):
                if n_bp >= target:
                    break
                n_ctg += 1
            else:
                n_bp += len(line.rstrip(b"\r\n"))
            dst.write(line)
    os.replace(out + ".tmp", out)
    return out, n_ctg, n_bp


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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from mashmap_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)
    smi = card(device)
    ref, asm, idx_path, out = paths()
    ok = True
    if not args.map_only and (args.build_only or not npz_ok(idx_path)):
        ok = build_phase(ref, idx_path, device, smi) and ok
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
