#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mashmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure propagates and exits non-zero:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the theta kernels (kernels/csrc/theta.cu) with nvcc for
   sm_90a, and each instance's registers and spills from ptxas;
3. kernel against plain version: theta_chunk on the card equals
   theta_chunk_ref exactly at the listed shapes and invalid fractions
   and at the schedule's edges (CHECK_EDGES), then on the block rows of
   the main path's own input, where both are also timed (and the kernel
   on the first 64 of those rows); each [theta] line is followed by the
   segment length K, the chains, the resident warps per SM, the share
   of offsets where a set changed, and the shares where kernel B's rule
   merges in full and moves theta by one place (host predictions from
   the rows and the kernel's output, not counts taken in the kernel);
   the record carries the bound from the bytes and int32 operations
   these rows need;
4. main path: build_or_load_index + map_files on "cuda" with bench.py's
   parameters on its 6 Mbp pangenome (4 x 1.5 Mbp), theta launches
   counted, and the reference's CI coverage gate (every sequence >= 0.92);
   then a warm run with the same PAF, and one under torch.profiler
   (device busy time and the top kernels of the build and the map);
5. card against CPU: on a small pangenome the card's index arrays and PAF
   bytes equal the port's own CPU run.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
rest of the repository beside it, the script fails before printing
either.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "generated")

# bench.py's workload and flags: -Y '#', -n 1, --pi 85, self-map
N_HAP, HAP_LEN, DIVERGENCE, SEED = 4, 1_500_000, 0.05, 2024
SMALL = (3, 200_000, 0.05, 7)
PI = 0.85
BATCH = 1024

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
)

# one H100 SXM: HBM rate (NVIDIA's data sheet), and the int32 compare
# rate: 132 SMs x 64 int32 lanes x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


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


def params(fa, out):
    from mashmap_tpu_torch.params import Parameters
    return Parameters(ref_sequences=[fa], out_file_name=out,
                      percentage_identity=PI, skip_prefix=True,
                      prefix_delim="#", num_mappings_for_segment=1,
                      batch_fragments=BATCH, no_progress=True).finalize()


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
    (forward over nxt) as kernel A does and returns a dict: ins_s and
    ins_p, the effective inserts into each set; changed, the offsets
    where either set changed (the bound uses these three). Given the
    theta the rows produce, also what kernel B's rule predicts, as the
    kernel source and the CPU model in tests/test_torch_theta.py state
    it: merged, the offsets merged in full (every segment's first, and
    those after a prefix insert that pushed theta out of the prefix
    set), and updated, the steps where a change at or below theta moves
    it instead. These two are predictions, not counts the kernel made.
    """
    import numpy as np
    from mashmap_tpu_torch.kernels.theta import RSENT
    cur, nxt = np.asarray(cur), np.asarray(nxt)
    C, s_b = cur.shape
    ar = np.arange(s)

    def walk(vals, order):
        """Which offsets changed the set, and what each change pushed
        out of slot s-1."""
        st = np.full((C, s), RSENT, dtype=np.int32)
        chg = np.zeros((C, s_b), dtype=bool)
        pushed = np.zeros((C, s_b), dtype=np.int32)
        for j in order:
            v = vals[:, j]
            rows = np.nonzero(v < st[:, -1])[0]
            if rows.size == 0:
                continue
            sr, vr = st[rows], v[rows, None]
            new = ~(sr == vr).any(axis=1)
            rows, sr, vr = rows[new], sr[new], vr[new]
            pos = (sr < vr).sum(axis=1, keepdims=True)
            shifted = np.concatenate([sr[:, :1], sr[:, :-1]], axis=1)
            st[rows] = np.where(ar < pos, sr,
                                np.where(ar == pos, vr, shifted))
            chg[rows, j] = True
            pushed[rows, j] = sr[:, -1]
        return chg, pushed

    s_chg, _ = walk(cur, range(s_b - 1, -1, -1))
    p_chg, p_out = walk(nxt, range(s_b))
    out = {"ins_s": int(s_chg.sum()), "ins_p": int(p_chg.sum()),
           "changed": int((s_chg | p_chg).sum()), "offsets": C * s_b}
    if theta is not None:
        th = np.asarray(theta)
        low = (s_chg & (cur <= th)) | (p_chg & (nxt <= th))
        full = low & (th != RSENT) & p_chg & (p_out == th)
        out["updated"] = int((low & ~full).sum())
        full = full[:, :-1]
        full[:, K - 1::K] = False       # the next offset starts a segment
        out["merged"] = int(full.sum()) + C * -(-s_b // K)
    return out


def theta_bound_ms(C, s_b, s, counts):
    """The least time the card could take for theta over these rows:
    cur and nxt read once and theta written once, over the HBM rate;
    the int32 operations these inputs need, over the int32 rate: one
    compare per offset per set (does the rank enter it), s per
    effective insert into either set (placing it in a sorted set of s
    and shifting the rest; a binary search would compare fewer, the
    shift moves up to s), and 2 per offset where a set changed (the
    change against theta, and theta's neighbour in the union, which
    a position kept per set finds in O(1); no merge is needed).
    Returns (ms, "bytes" or "operations")."""
    n_bytes = 3 * C * s_b * 4
    n_ops = (s * (counts["ins_s"] + counts["ins_p"])
             + 2 * counts["changed"] + 2 * C * s_b)
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / INT32_OPS_PER_S
    print(f"[theta]   bound: bytes {n_bytes} ({t_bytes} ms), int32 "
          f"operations {n_ops} ({t_ops} ms)")
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def theta_schedule_line(C, s_b, s, counts):
    """The kernels' geometry at this shape, the share of offsets where a
    set changed, and the shares where kernel B's rule merges in full and
    moves theta by one place (host predictions)."""
    from mashmap_tpu_torch.kernels import theta
    _, k, n_seg = theta.kernel_geometry(s, s_b)
    warps_a, warps_b = theta.resident_warps(s)
    n = counts["offsets"]
    print(f"[theta]   K={k} chains={C * n_seg} resident warps/SM: "
          f"A {warps_a} B {warps_b}; changed share "
          f"{counts['changed'] / n}; host prediction of B: merged share "
          f"{counts['merged'] / n}, stepped share {counts['updated'] / n}")


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
        m = re.search(r"Compiling entry function '_Z\d+(theta_\w+?_kernel)"
                      r"ILi(\d+)E", line)
        if m:
            name, spill = f"{m.group(1)}<{m.group(2)}>", "spills not read"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"spill st/ld {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"[build] {name}: {m.group(1)} registers, {spill}")
            name = None


def main_path_blocks(fa, p, device):
    """The (cur, nxt) block rows that the main path's build hands to
    theta_chunk for this FASTA: hashing, rank reduction and the block
    cut of the index build, stopped before theta."""
    import torch
    from mashmap_tpu_torch.index import builder
    from mashmap_tpu_torch.io import for_each_seq_in_file
    from mashmap_tpu_torch.kernels import kmers, winnow
    hs = [builder._hash_contig(kmers.sanitize(seq.encode("ascii")),
                               p.kmer_size, device)[0]
          for _, seq in for_each_seq_in_file(fa)]
    ranks, _ = winnow._rank_reduce(torch.cat(hs))
    views = list(torch.split(ranks, [h.shape[0] for h in hs]))
    cur, nxt, _ = winnow.theta_blocks(views, p.seg_length - p.kmer_size + 1)
    return cur, nxt


def theta_record(fa, p, device, kernel_reps=20, plain_reps=3):
    """The kernel against its plain version on the main path's own block
    rows, exactly; the times of both there, and the least time the card
    could take for them."""
    import torch
    from mashmap_tpu_torch.kernels import theta
    cur, nxt = main_path_blocks(fa, p, device)
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
    return {"name": "theta_chunk", "route": "cuda",
            "source": "mashmap_tpu_torch/kernels/csrc/theta.cu",
            "replaces": "mashmap_tpu/kernels/winnow_pallas.py:136",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def main_path(fa, device):
    """bench.py's build + self-map through the port's entry points, twice:
    the first run (cold: each CUDA kernel's first launch loads it) goes
    through map_files and is the one whose theta launches are counted and
    whose PAF is gated; the second (warm, the steady state bench.py
    reports) drives the Mapper that map_files builds, to read which
    device and host routes ran, and must give the same PAF. Returns the
    theta launches of the first run."""
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

    def run(tag):
        out = os.path.join(DATA, f"smoke_main_{tag}.paf")
        p = params(fa, out)
        peak()
        t0 = time.perf_counter()
        idx = build_or_load_index(p, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        build_peak = peak()
        path_stats = "not read (map_files)"
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
        print(f"[main] {tag}: paf_rows={paf.count(chr(10))} "
              f"path_stats={path_stats} max_memory_allocated build="
              f"{build_peak} map={peak()}")
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
    if run("warm") != paf:
        raise AssertionError("the warm run's PAF differs from the cold's")
    # the cold run's one-off host set-up: the L1 cutoff table, which
    # the Mapper computes with SciPy and the process memoizes
    from mashmap_tpu_torch import stats
    from mashmap_tpu_torch.params import FIXED
    p = params(fa, os.devnull)
    stats.sketch_cutoffs.cache_clear()
    t0 = time.perf_counter()
    stats.sketch_cutoffs(p.sketch_size, p.kmer_size, p.ANIDiff,
                         p.ANIDiffConf, FIXED.ss_table_max)
    print(f"[main] set-up: cutoff table {time.perf_counter() - t0} s")
    return launches


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
    for phase in ("build", "map"):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if phase == "build":
                idx = build_or_load_index(p, device)
            else:
                map_files(p, index=idx, device=device)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        # device-side events only (kernels, copies): the host ops that
        # launched them carry the same time again
        rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
        rows = sorted(r for r in rows if r[0] > 0)[::-1]
        busy_ms = sum(r[0] for r in rows)
        print(f"[profile] {phase}: wall {wall_ms} ms, device busy "
              f"{busy_ms} ms, idle share "
              f"{1 - busy_ms / wall_ms if rows else 'not measured'}")
        for ms, n, key in rows[:top]:
            print(f"[profile] {phase}:   {ms} ms x{n} {key[:90]}")
        for ms, n, key in rows:
            if "theta_" in key:
                print(f"[profile] {phase}: theta {ms} ms x{n} {key[:40]}")


def card_vs_cpu(fa, device):
    """The index arrays and PAF bytes of `device` equal the CPU's."""
    import numpy as np
    import torch
    from mashmap_tpu_torch.api import build_or_load_index, map_files
    from mashmap_tpu_torch.index.builder import _NPZ_FIELDS
    cpu = torch.device("cpu")
    runs = {}
    for dev in (device, cpu):
        out = os.path.join(DATA, f"smoke_small_{dev.type}.paf")
        p = params(fa, out)
        idx = build_or_load_index(p, dev)
        map_files(p, index=idx, device=dev)
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
    print(f"[small] {device.type} == cpu: {len(_NPZ_FIELDS)} index arrays, "
          f"{rows} PAF rows, {len(pa)} bytes")
    if rows == 0:
        raise AssertionError("the small workload mapped nothing")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from mashmap_tpu_torch.kernels import theta
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
    t0 = time.perf_counter()
    theta.load_library()
    print(f"[build] theta.cu built and loaded in "
          f"{time.perf_counter() - t0} s")
    print_ptxas(theta.ptxas_log_path())

    # 3. kernel against plain version, then times on the main path's rows
    fa_main = fasta(N_HAP, HAP_LEN, DIVERGENCE, SEED)
    fa_small = fasta(*SMALL)
    err = check_theta(device)
    rec = theta_record(fa_main, params(fa_main, os.devnull), device)

    # 4. main path, then once more under the profiler
    launches = main_path(fa_main, device)
    profile_main_path(fa_main, device)

    # 5. card against CPU
    card_vs_cpu(fa_small, device)

    rec = {"name": rec.pop("name"), "route": rec.pop("route"),
           "source": rec.pop("source"), "replaces": rec.pop("replaces"),
           "launches": launches,
           "max_abs_err": max(err, rec.pop("max_abs_err")), **rec}
    print(f"[done] {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": [rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
