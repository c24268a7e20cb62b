#!/usr/bin/env python3
"""Host seconds of each stage of the port's map on one CUDA card, and the
stream synchronizations of its copies.

    python3 scripts/map_stages.py [--root DIR] [--reps N]

Maps bench_torch.py's workload (bench.py's 6 Mbp pangenome and
Parameters, batch_fragments 1024) with the index resident: one warm-up
``Mapper.run``, then ``--reps`` runs with the host seconds of each Mapper
stage timed around its calls (``_dispatch_batch``, ``_collect_l1``,
``_collect_l2``, ``_post_batch``, and the per-query ``_postprocess_query``
and ``_emit``; "other" is the rest of the run's wall: reading and cutting
the queries, the loop; and the Mapper's own ``phase_s``, host seconds by
map phase), then one run under torch.profiler: its wall, the
device's busy time and idle share, the count of CUDA runtime calls
that block the host (``cudaStreamSynchronize``, ``cudaEventSynchronize``,
``cudaDeviceSynchronize``) against the count of batches, and the kernel
and graph launches (``cudaLaunchKernel``, ``cudaGraphLaunch``). Every
run's record has the map steps' graph captures and replays
(kernels/graphs.py). The warm-up captures the steps' graphs; the later
runs should capture none.
The stages are
methods of both the serial and the pipelined Mapper, so ``--root DIR``
(a checkout to import mashmap_tpu_torch from) compares two trees on one
card, one process each, in turns. One JSON line a run, with the card's
name and power limit; the PAF of every run must be the warm-up's. Exits 2
without a CUDA card.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("_dispatch_batch", "_collect_l1", "_collect_l2", "_post_batch",
          "_postprocess_query", "_emit")
BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize",
            "cudaDeviceSynchronize")


def timed_stages(Mapper, seconds, calls):
    """Wrap each stage of Mapper to add its host seconds and calls."""
    def wrap(name, real):
        def f(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return real(self, *a, **kw)
            finally:
                seconds[name] = (seconds.get(name, 0.0)
                                 + time.perf_counter() - t0)
                calls[name] = calls.get(name, 0) + 1
        return f
    for name in STAGES:
        setattr(Mapper, name, wrap(name, getattr(Mapper, name)))


def map_once(Mapper, p, idx, out):
    import torch
    t0 = time.perf_counter()
    m = Mapper(p, idx, device="cuda")
    with open(out, "w") as fh:
        m.run(p.query_sequences, fh)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, m.phase_s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="directory to import mashmap_tpu_torch from")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed runs before the profiled one [default: 3]")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("map_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)
    from bench_extra_torch import card_name, fresh_cache
    with fresh_cache():
        return run(args, card_name())


def run(args, card):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bench_torch import DATA, ensure_dataset, make_params
    import mashmap_tpu_torch
    from mashmap_tpu_torch.api import build_or_load_index
    from mashmap_tpu_torch.map.engine import Mapper
    fasta = ensure_dataset()
    out = os.path.join(DATA, "map_stages.paf")
    p = make_params(fasta, out)
    p.no_progress = True
    p.finalize()
    idx = build_or_load_index(p, "cuda")
    base = {"root": os.path.abspath(args.root),
            "package": os.path.dirname(mashmap_tpu_torch.__file__),
            "device": card}
    from mashmap_tpu_torch.kernels import graphs

    def step_graphs():
        return {"captures": dict(graphs.CAPTURES),
                "replays": dict(graphs.REPLAYS)}

    warm_s, _ = map_once(Mapper, p, idx, out)
    with open(out, "rb") as fh:
        want = fh.read()
    print(json.dumps({**base, "run": "warm-up", "wall_s": warm_s,
                      **step_graphs()}))
    seconds, calls = {}, {}
    timed_stages(Mapper, seconds, calls)
    for rep in range(args.reps + 1):
        seconds.clear()
        calls.clear()
        graphs.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        if rep < args.reps:
            wall, phase_s = map_once(Mapper, p, idx, out)
            rec = {"run": rep}
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall, phase_s = map_once(Mapper, p, idx, out)
            ev = prof.key_averages()
            busy_ms = sum(e.self_device_time_total for e in ev
                          if str(e.device_type).endswith("CUDA")) / 1e3
            counts = {e.key: e.count for e in ev}
            rec = {"run": "profiled", "device_busy_ms": busy_ms,
                   "idle_share": 1 - busy_ms / (1e3 * wall),
                   "cudaLaunchKernel": counts.get("cudaLaunchKernel", 0),
                   "cudaGraphLaunch": counts.get("cudaGraphLaunch", 0),
                   **{k: counts.get(k, 0) for k in BLOCKING}}
        with open(out, "rb") as fh:
            if fh.read() != want:
                raise AssertionError(f"run {rep}: PAF differs from the "
                                     f"warm-up's")
        stage_s = {k.lstrip("_"): v for k, v in seconds.items()}
        stage_s["other"] = wall - sum(seconds.values())
        print(json.dumps({**base, **rec, "wall_s": wall,
                          "batches": calls.get("_dispatch_batch", 0),
                          "stage_s": stage_s, "phase_s": phase_s,
                          **step_graphs(),
                          "peak_bytes": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
