#!/usr/bin/env python3
"""One benchmark cell's reference index, built by the port on the card:
the build's seconds, the device's reserved and allocated peaks over the
builds, each group's phase seconds, and the index arrays in an .npz.

    python3 scripts/build_check.py --cell CELL --seed N --out F.npz \
        [--root DIR] [--builds 2]
    python3 scripts/build_check.py --compare A.npz B.npz

The inputs are the cell's (``benchmark/``'s generator and traffic
module at the seed, read through the port's front door,
``api.build_or_load_index``).
``--root DIR`` builds with the ``mashmap_tpu_torch`` under DIR (another
checkout's, e.g. ``git archive <commit> mashmap_tpu_torch`` unpacked
there) in place of this checkout's. The peaks are read after the
builds, from a reset after the inputs are made. One JSON line on
standard output (the card's name and power limit in it). ``--compare``
exits 1 unless both files hold the same arrays, equal element by
element. Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compare(a: str, b: str) -> int:
    import numpy as np
    with np.load(a) as za, np.load(b) as zb:
        keys = sorted(set(za.files) | set(zb.files))
        differ = [k for k in keys if k not in za.files or k not in zb.files
                  or za[k].dtype != zb[k].dtype
                  or not np.array_equal(za[k], zb[k])]
        sizes = {k: int(za[k].size) for k in za.files}
    print(json.dumps({"compare": [a, b], "arrays": len(keys),
                      "differ": differ, "sizes": sizes}))
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--out")
    ap.add_argument("--root")
    ap.add_argument("--builds", type=int, default=2)
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)

    sys.path[:0] = [os.path.abspath(args.root)] if args.root else []
    sys.path.insert(1, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("build_check.py: no CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    from benchmark import run as bench
    from mashmap_tpu_torch import api, trace
    from mashmap_tpu_torch.index import builder

    device = torch.device("cuda", 0)
    _, cell, cfg = bench.cell_files(args.cell)
    traffic = __import__(f"benchmark.traffic.{cell['driver']}",
                         fromlist=["setup_inputs"])
    work = os.path.join(ROOT, "_scratch", f"build_check_{os.getpid()}")
    os.makedirs(work)
    try:
        st = traffic.setup_inputs(cfg, cell, args.seed, device, work)
        p = traffic.params(st).finalize()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        secs = []
        for _ in range(args.builds):
            before = dict(trace.totals)
            t0 = time.perf_counter()
            idx = api.build_or_load_index(p, device)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            got = trace.totals.get("build classify contigs")
            classified = (None if got is None else
                          got[1] - before.get("build classify contigs",
                                              (0.0, 0))[1])
        reserved = torch.cuda.max_memory_reserved(device)
        allocated = torch.cuda.max_memory_allocated(device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    np.savez(args.out, names=np.array(idx.names),
             freq_threshold=np.int64(idx.freq_threshold),
             **{f: getattr(idx, f) for f in builder._NPZ_FIELDS})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "cell": args.cell, "seed": args.seed,
        "port": os.path.abspath(args.root) if args.root else ROOT,
        "card": card.strip(), "k_w_s": [p.kmer_size, p.seg_length,
                                        p.sketch_size],
        "build_s": secs, "reserved_gib": reserved / 2**30,
        "allocated_gib": allocated / 2**30,
        "contigs": len(idx.names), "classified_contigs": classified,
        "postings": int(len(idx.post_seqid)), "rows": int(len(idx.mi_rank)),
        "group_phase_s": builder.GROUP_PHASE_S}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
