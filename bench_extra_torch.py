#!/usr/bin/env python3
"""Secondary benchmarks of the PyTorch/CUDA port: BASELINE.json's other
mapping configurations on one CUDA card.

The port's counterpart of bench_extra.py (which drives the JAX package):
the same deterministic synthetic data under data/generated/extra_*, the
same Parameters for each configuration, and the same JSON lines (metric
names and units), each with the card's name and power limit:

  one-to-one   4 x 1 Mbp pangenome (4% divergence, seed 77) self-map,
               --pi 95 -f one-to-one -Y '#' -n 1
  coverage     the reference CI's gate (>= 0.92 for every sequence) on
               the one-to-one PAF
  ONT reads    200 reads of 10-30 kb at 5% divergence against a 5 Mbp
               reference, --pi 85 -f map (Mbp/s and the mapped fraction)
  dense sweep  a 2 Mbp genome against its copy at 3% substitutions (true
               ANI 97%), --pi 90 with --dense (s = 298), then -J 60, 120,
               200: the largest |median reported ANI - 97| in percentage
               points
  --rl         two 1.5 Mbp reference files, two queries at 4%, --pi 85

    python3 bench_extra_torch.py

Each timed configuration runs once cold and twice warm (as bench_extra.py
times it); a run is one ``map_files`` call, as a user makes it (the query
reader overlaps the index build), with the build inside it timed apart.
The cutoff tables go to a fresh $XDG_CACHE_HOME, so the cold runs
compute theirs. ``check`` holds every run: its PAF's sha256 must equal
the JAX package's in EXTRA_SHA256, and bench_extra.py's gates hold
(coverage >= 0.92, ANI error <= 1 point). vs_baseline is the ratio to
the C++ MashMap built by tests/oracle/build_ref.sh where its sources
exist, else -1 (accuracy rows as bench_extra.py reports them). Without a
CUDA card it prints an error line and exits 2; a failed check exits 1
after the rows. The configuration functions take a ``device``, and the
tests call them with ``"cpu"`` on smaller data.
"""

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "generated")
for _d in (HERE, os.path.join(HERE, "tests"), os.path.join(HERE, "scripts")):
    if _d not in sys.path:
        sys.path.insert(0, _d)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Lengths of the generated data; bench_extra.py's by default. The
    tests cut them; seeds, divergences and read lengths stay."""
    pan_len: int = 1_000_000      # each of the 4 haplotypes
    ref_len: int = 5_000_000      # the ONT reads' reference
    n_reads: int = 200
    dense_len: int = 2_000_000
    rl_len: int = 1_500_000       # each of the two reference files


FULL = Sizes()
# the --dense/-J sweep: None is --dense with its own sketch size
SWEEP = (None, 60, 120, 200)
MIN_COVERAGE = 0.92
TRUE_ANI = 97.0
MAX_ANI_ERROR = 1.0
BATCH = 2048

# sha256 of the JAX package's PAF for each configuration at FULL sizes,
# on the CPU, with the Parameters of the functions below:
#   JAX_PLATFORMS=cpu python -c "from mashmap_tpu.params import \
#       Parameters; from mashmap_tpu.api import map_files; \
#       map_files(Parameters(**kw))"
# where kw is oto_params(...), ont_params(...), dense_params(..., s) or
# rl_params(...)'s arguments on the files make_data() writes (the
# arguments of bench_extra.py's calls). The port's CPU run of the same
# configuration writes the same bytes.
EXTRA_SHA256 = {
    # 254 rows, s = 20; the smallest coverage 0.9955911675356336
    "oto": "b4b8ea2598fdc861070592f4a74fcb0fd44bdebf97a5fea76da876753dbd37d2",
    # 249 rows, s = 130; 200 of 200 reads mapped
    "ont": "10d55ea89d13533590cd744010d38cd42e02e0ede86d2fdcacf18e08adfff072",
    # one row each
    "dense-298":
        "0f5442a633544d7455d90be4423125928e5ef3e130ea97bfd084cc48fe1beccc",
    "dense-60":
        "d54cd289bfe68dfdda1d9104377cb79da6d67d3226c6be151e584e494994046f",
    "dense-120":
        "bde0d6e0e4a6679c96a75afb7eca91153672c963cd6d2ec1d9f641386e800d06",
    "dense-200":
        "dcf4a5b966b0c191dbd9595572d727dd5895a038f27bb71d6c656a3b1630d016",
    # 2 rows, s = 130
    "rl": "c484d86db9b3e05bd229677b42d001040338c388fef55e6ec0c5e112501fbf62",
}


def _write(path, recs):
    """Write recs to path unless it exists (through a temporary file)."""
    from genomes import write_fasta
    if not os.path.exists(path):
        write_fasta(path + ".tmp", recs)
        os.replace(path + ".tmp", path)


def make_data(directory=DATA, sizes=FULL):
    """Write bench_extra.py's data (its generators and seeds, at `sizes`)
    into `directory` where missing; returns the paths by name."""
    import numpy as np
    from genomes import mutate, pangenome, random_genome
    os.makedirs(directory, exist_ok=True)
    d = {k: os.path.join(directory, f"extra_{k}.fa") for k in (
        "pan4", "ref5m", "ont", "da", "db", "r1", "r2", "q4")}
    d["dir"] = directory
    d["n_reads"] = sizes.n_reads
    _write(d["pan4"], pangenome(4, sizes.pan_len, 0.04, seed=77))
    if not os.path.exists(d["ont"]):
        base = random_genome(sizes.ref_len, seed=88)
        _write(d["ref5m"], [("chr1", base)])
        rng = np.random.default_rng(89)
        reads = []
        for i in range(sizes.n_reads):
            n = int(rng.integers(10_000, 30_000))
            lo = int(rng.integers(0, len(base) - n))
            reads.append((f"read{i}",
                          mutate(base[lo:lo + n], 0.05, seed=1000 + i)))
        _write(d["ont"], reads)
    if not os.path.exists(d["db"]):
        g = random_genome(sizes.dense_len, seed=90)
        _write(d["da"], [("gA", g)])
        _write(d["db"], [("gB", mutate(g, 0.03, seed=91, indel_frac=0.0))])
    if not os.path.exists(d["q4"]):
        a = random_genome(sizes.rl_len, seed=95)
        b = random_genome(sizes.rl_len, seed=96)
        _write(d["r1"], [("refA", a)])
        _write(d["r2"], [("refB", b)])
        _write(d["q4"], [("qA", mutate(a, 0.04, seed=97)),
                         ("qB", mutate(b, 0.04, seed=98))])
    return d


def out_path(data, key):
    return os.path.join(data["dir"], f"extra_{key}_torch.paf")


# bench_extra.py's Parameters, one function a configuration (its lines)
def oto_params(data, out):
    """bench_extra.py:93-99."""
    from mashmap_tpu_torch.params import Parameters
    return Parameters(ref_sequences=[data["pan4"]], out_file_name=out,
                      percentage_identity=0.95, filter_mode=2,
                      skip_prefix=True, prefix_delim="#",
                      num_mappings_for_segment=1,
                      batch_fragments=BATCH, no_progress=True)


def ont_params(data, out):
    """bench_extra.py:142-146."""
    from mashmap_tpu_torch.params import Parameters
    return Parameters(ref_sequences=[data["ref5m"]],
                      query_sequences=[data["ont"]], out_file_name=out,
                      percentage_identity=0.85, filter_mode=1,
                      batch_fragments=BATCH, no_progress=True)


def dense_params(data, out, s):
    """bench_extra.py:161-165; s None is --dense."""
    from mashmap_tpu_torch.params import Parameters
    return Parameters(ref_sequences=[data["da"]],
                      query_sequences=[data["db"]], out_file_name=out,
                      percentage_identity=0.9, dense=s is None,
                      sketch_size=s, batch_fragments=BATCH,
                      no_progress=True)


def rl_params(data, out):
    """bench_extra.py:193-197: the two files of its --rl list."""
    from mashmap_tpu_torch.params import Parameters
    return Parameters(ref_sequences=[data["r1"], data["r2"]],
                      query_sequences=[data["q4"]], out_file_name=out,
                      percentage_identity=0.85, batch_fragments=BATCH,
                      no_progress=True)


@dataclasses.dataclass
class Run:
    """One configuration's run: its PAF bytes, the seconds of its
    map_files call and of the index build inside it."""
    key: str
    sketch_size: int
    paf: bytes
    seconds: float
    build_s: float

    @property
    def map_s(self):
        """The call's seconds after the build (the mapping, and the
        query reading that the build did not overlap)."""
        return self.seconds - self.build_s

    @property
    def sha256(self):
        return hashlib.sha256(self.paf).hexdigest()

    @property
    def rows(self):
        return self.paf.count(b"\n")


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def build_timer(device, got):
    """The index build that map_files calls (api.build_or_load_index),
    timed to its end on `device`, for the block; its seconds go to got."""
    from mashmap_tpu_torch import api
    build = api.build_or_load_index

    def timed_build(p, dev=None):
        t0 = time.perf_counter()
        idx = build(p, dev)
        _sync(device)
        got.append(time.perf_counter() - t0)
        return idx
    api.build_or_load_index = timed_build
    try:
        yield
    finally:
        api.build_or_load_index = build


def run(key, p, device):
    """One `map_files` call on `device`, timed to its end on the device,
    with the index build inside it timed apart."""
    import torch
    from mashmap_tpu_torch.api import map_files
    device = torch.device(device)
    builds = []
    p.finalize()
    t0 = time.perf_counter()
    with build_timer(device, builds):
        map_files(p, device=device)
    _sync(device)
    seconds = time.perf_counter() - t0
    with open(p.out_file_name, "rb") as fh:
        paf = fh.read()
    return Run(key, p.sketch_size, paf, seconds, builds[0])


def one_to_one(data, device):
    return run("oto", oto_params(data, out_path(data, "oto")), device)


def ont_reads(data, device):
    return run("ont", ont_params(data, out_path(data, "ont")), device)


def dense_step(data, device, s):
    """One step of the sweep; its key is dense-<sketch size>."""
    p = dense_params(data, out_path(data, f"dense{s or ''}"), s).finalize()
    return run(f"dense-{p.sketch_size}", p, device)


def multiref_rl(data, device):
    return run("rl", rl_params(data, out_path(data, "rl")), device)


def build_kernels():
    """Build theta.cu and the native FASTA reader (each builds at its
    first use otherwise) before any run is timed; returns the seconds."""
    from mashmap_tpu_torch import native
    from mashmap_tpu_torch.kernels import theta
    t0 = time.perf_counter()
    theta.load_library()
    native.native_available()
    return time.perf_counter() - t0


def seq_lengths(path):
    from mashmap_tpu_torch.io import for_each_seq_in_file
    return {n: len(s) for n, s in for_each_seq_in_file(path)}


def coverage_min(data, r):
    """The reference CI's per-sequence coverage (scripts/check_coverage.py)
    of the one-to-one PAF: the smallest, and the whole map."""
    from check_coverage import coverage_by_sequence
    cov = coverage_by_sequence(seq_lengths(data["pan4"]),
                               r.paf.decode().splitlines())
    return min(cov.values()), cov


def mapped_fraction(data, r):
    """Share of the ONT reads with at least one PAF row."""
    names = {ln.split(b"\t")[0] for ln in r.paf.splitlines()}
    return len(names) / data["n_reads"]


def ani_error(r):
    """|median reported ANI - TRUE_ANI| in percentage points (the id:f
    tag, PAF column 13), as bench_extra.py takes it."""
    anis = sorted(float(ln.split(b"\t")[12].split(b":")[-1])
                  for ln in r.paf.splitlines())
    return abs(anis[len(anis) // 2] * 100 - TRUE_ANI)


def check(data, r):
    """What every run must hold: its PAF's sha256 is the JAX package's
    (EXTRA_SHA256), and bench_extra.py's gates hold: the coverage gate on
    the one-to-one PAF, at most MAX_ANI_ERROR points of ANI error on each
    sweep step. Returns the failures."""
    bad = []
    if r.sha256 != EXTRA_SHA256[r.key]:
        bad.append(f"{r.key}: PAF sha256 {r.sha256} != the JAX package's "
                   f"{EXTRA_SHA256[r.key]}")
    if r.key == "oto":
        cov, by_seq = coverage_min(data, r)
        if cov < MIN_COVERAGE:
            bad.append(f"oto: coverage gate failed: {by_seq}")
    elif r.key.startswith("dense") and ani_error(r) > MAX_ANI_ERROR:
        bad.append(f"{r.key}: ANI error {ani_error(r)} points")
    return bad


@contextlib.contextmanager
def fresh_cache():
    """A new, empty $XDG_CACHE_HOME (under $TMPDIR) for the block, removed
    after it: a cold run then computes its cutoff table (the disk memo of
    stats.sketch_cutoffs) whatever earlier runs left on the machine."""
    old = os.environ.get("XDG_CACHE_HOME")
    path = tempfile.mkdtemp(prefix="bench_cache_")
    os.environ["XDG_CACHE_HOME"] = path
    try:
        yield path
    finally:
        if old is None:
            os.environ.pop("XDG_CACHE_HOME", None)
        else:
            os.environ["XDG_CACHE_HOME"] = old
        shutil.rmtree(path, ignore_errors=True)


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def oracle():
    """The C++ MashMap built by tests/oracle/build_ref.sh (into
    data/generated/mashmap_ref), or None where its sources are missing."""
    r = subprocess.run(
        [os.path.join(HERE, "tests", "oracle", "build_ref.sh")],
        capture_output=True, text=True,
        env={**os.environ, "OUT": os.path.join(DATA, "mashmap_ref")})
    return r.stdout.strip().splitlines()[-1] if r.returncode == 0 else None


def time_ref(ref_bin, args):
    """Best seconds of two runs of the C++ MashMap, None if it fails."""
    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        r = subprocess.run([ref_bin] + args, capture_output=True,
                           text=True, timeout=3600)
        if r.returncode != 0:
            return None
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def timed(fn, data, device):
    """One cold run, then two warm ones (bench_extra.py's time_ours);
    every run's seconds on stderr. Returns the runs."""
    out = [fn(data, device) for _ in range(3)]
    print(f"[bench_extra_torch] {out[0].key}: s={out[0].sketch_size} "
          f"seconds={[r.seconds for r in out]} "
          f"build_s={[r.build_s for r in out]}", file=sys.stderr)
    return out


def emit(card, name, value, unit, vs, **extra):
    print(json.dumps({"metric": name, "value": round(value, 3),
                      "unit": unit, "vs_baseline": round(vs, 3),
                      "device": card, **extra}), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print(json.dumps({"metric": "bench_extra_torch", "value": 0.0,
                          "unit": "", "vs_baseline": 0.0,
                          "error": "no CUDA device"}))
        return 2
    with fresh_cache():
        return run_all()


def run_all():
    card = card_name()
    device = "cuda"
    print(f"[bench_extra_torch] theta.cu and the reader built in "
          f"{build_kernels()} s", file=sys.stderr)
    data = make_data()
    ref_bin = oracle()
    bad = []

    def checked(runs):
        for r in runs:
            bad.extend(check(data, r))
        return {"sha256": runs[-1].sha256, "paf_rows": runs[-1].rows,
                "s": runs[-1].sketch_size, "cold_s": runs[0].seconds,
                "warm_s": [r.seconds for r in runs[1:]],
                "build_s": [r.build_s for r in runs]}

    def rate(mbp, runs, ref_args):
        ours = min(r.seconds for r in runs[1:])
        refs = time_ref(ref_bin, ref_args) if ref_bin else None
        return mbp / ours, (refs / ours if refs else -1.0)

    # one-to-one, and the coverage gate on its PAF
    pan_mbp = sum(seq_lengths(data["pan4"]).values()) / 1e6
    runs = timed(one_to_one, data, device)
    info = checked(runs)
    value, vs = rate(pan_mbp, runs, [
        "-r", data["pan4"], "--pi", "95", "-f", "one-to-one", "-Y", "#",
        "-n", "1", "-t", "8", "-o", out_path(data, "oto") + ".ref"])
    emit(card, "one-to-one --pi 95 (pangenome self-map)", value, "Mbp/s",
         vs, **info)
    cov, _ = coverage_min(data, runs[-1])
    emit(card, "per-sequence coverage gate (min, >=0.92 required)", cov,
         "fraction", cov / MIN_COVERAGE)

    # ONT-shaped reads against one reference, -f map
    read_mbp = sum(seq_lengths(data["ont"]).values()) / 1e6
    runs = timed(ont_reads, data, device)
    info = checked(runs)
    value, vs = rate(read_mbp, runs, [
        "-r", data["ref5m"], "-q", data["ont"], "--pi", "85", "-f", "map",
        "-t", "8", "-o", out_path(data, "ont") + ".ref"])
    emit(card, "ONT long reads -f map", value, "Mbp/s", vs, **info)
    mapped = mapped_fraction(data, runs[-1])
    emit(card, "ONT reads mapped", mapped, "fraction", mapped)

    # --dense and the -J sweep: ANI accuracy against the true 97%
    errs, steps = [], {}
    for s in SWEEP:
        r = dense_step(data, device, s)
        bad.extend(check(data, r))
        errs.append(ani_error(r))
        steps[r.key] = {"ani_error": errs[-1], "sha256": r.sha256,
                        "paf_rows": r.rows, "s": r.sketch_size,
                        "seconds": r.seconds}
    emit(card, "--dense/-J sweep max |ANI error| (true 97%)", max(errs),
         "percentage points", 1.0 if max(errs) <= MAX_ANI_ERROR else -1.0,
         steps=steps)

    # two reference files (--rl)
    runs = timed(multiref_rl, data, device)
    info = checked(runs)
    rl = os.path.join(data["dir"], "extra_rl.txt")
    with open(rl, "w") as fh:
        fh.write(data["r1"] + "\n" + data["r2"] + "\n")
    value, vs = rate(2 * FULL.rl_len / 1e6, runs, [
        "--rl", rl, "-q", data["q4"], "--pi", "85", "-t", "8", "-o",
        out_path(data, "rl") + ".ref"])
    emit(card, "multi-reference --rl mapping", value, "Mbp/s", vs, **info)
    for msg in bad:
        print(f"[bench_extra_torch] FAILED {msg}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
