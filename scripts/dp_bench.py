#!/usr/bin/env python3
"""Check and time the aligner's DP trace kernel on a CUDA card.

    python3 scripts/dp_bench.py [--root DIR] [--plain-reps N]

Imports mashmap_tpu_torch from DIR (default: the checkout that holds
this script), so that two versions of the kernel can be run in turns on
one card, one process each: parent, change, change, parent. Runs
chip_smoke.py's [dp-check] (the kernel's records against the plain
version's, byte for byte, at every bucket) and [dp-time] (per bucket at
B=512 and at the aligner's batch: the kernel's median ms of 20 by CUDA
events, the records' copy, the plain version's ms, the bound), then
prints one JSON line with the card's name and power limit and every
[dp-time] record. Fails without a card.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--plain-reps", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dp_bench: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path += [REPO, os.path.join(REPO, "tests")]
    import chip_smoke as cs
    from mashmap_tpu_torch.align import kernel
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernel.load_library()
    cs.print_ptxas(kernel.ptxas_log_path())
    dev = torch.device("cuda")
    err = cs.check_dp(dev)
    recs = cs.dp_time(dev, plain_reps=args.plain_reps)
    print(json.dumps({"root": root, "card": card, "max_abs_err": err,
                      "dp_time": list(recs.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
