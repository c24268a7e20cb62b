#!/usr/bin/env python3
"""Time the port's theta_chunk kernels on a CUDA card at given shapes.

    python3 scripts/theta_bench.py [--root DIR] {C,S_B,s | main} ...

Imports mashmap_tpu_torch from DIR (default: the checkout that holds
this script), so that two checkouts of the package can be timed in turns
on one card, one process each: parent, change, change, parent. Rows are
chip_smoke.py's random ranks (from [0, 4 * S_B), 2% RSENT, seeded by the
shape), so every checkout sees the same rows; "main" stands for the
block rows that the main path's build hands theta (chip_smoke.py's
main_path_blocks, C=1208, S_B=4982, s=130). Prints one JSON line per
shape with the card's name and power limit, the median milliseconds of
theta_chunk over REPS calls by CUDA events, and each kernel's mean device
time over REPS calls under torch.profiler. Fails without a card. That
the kernel equals its plain version is chip_smoke.py's and
tests/test_torch_cuda.py's to check.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def kernel_split(fn, reps):
    """Mean device milliseconds per call of each kernel that fn launches,
    by name, over reps calls under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0]: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("shapes", nargs="+")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("theta_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path += [REPO, os.path.join(REPO, "tests")]
    import chip_smoke as cs
    from mashmap_tpu_torch.kernels import theta
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    for shape in args.shapes:
        if shape == "main":
            fa = cs.fasta(cs.N_HAP, cs.HAP_LEN, cs.DIVERGENCE, cs.SEED)
            p = cs.params(fa, os.devnull)
            c, n = cs.main_path_blocks(fa, p, dev)
            s = p.sketch_size
        else:
            C, s_b, s = (int(x) for x in shape.split(","))
            cur, nxt = cs.random_rows(C, s_b, s, 0.02)
            c = torch.from_numpy(cur).to(dev)
            n = torch.from_numpy(nxt).to(dev)
        C, s_b = c.shape

        def run():
            return theta.theta_chunk(c, n, s, s_b)

        rec = {"root": os.path.abspath(args.root), "rows": shape, "C": C,
               "S_B": s_b, "s": s, "ms": cs.time_ms(run, REPS),
               "card": card, "kernels_ms": kernel_split(run, REPS)}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
