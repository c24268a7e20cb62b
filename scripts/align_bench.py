#!/usr/bin/env python3
"""Time the port's aligner on a CUDA card and fingerprint its output.

    python3 scripts/align_bench.py [--root DIR] [--reps N]

Imports mashmap_tpu_torch from DIR (default: the checkout that holds this
script), so that two checkouts of the package can be run in turns on one
card, one process each: parent, change, change, parent. The workload is
chip_smoke.py's [align]: bench.py's 6 Mbp pangenome (4 x 1.5 Mbp, 5%
divergence, seed 2024), its `--legacy` self-map by the port's mapper CLI
(`-s 5000 -k 19 --pi 85 -Y '#' -n 1`; made once, by the first run, and
shared), aligned by `align_files` at `--pi 85`. Prints one JSON line per
rep with the card's name and power limit, the wall seconds, the
AlignStats fields (DP device ms, the copy to the host, anchors,
traceback and host DP seconds, pieces per bucket, DP calls), and the
sha256 of the mapping and of the alignment output. Fails without a card.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sha256(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("align_bench: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path += [REPO, os.path.join(REPO, "tests")]
    import chip_smoke as cs
    from mashmap_tpu_torch import cli
    from mashmap_tpu_torch.align.driver import align_files
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    fa = cs.fasta(cs.N_HAP, cs.HAP_LEN, cs.DIVERGENCE, cs.SEED)
    mapping = os.path.join(cs.DATA, "align_bench.legacy")
    if not os.path.exists(mapping):
        tmp = f"{mapping}.{os.getpid()}"
        cli.main(["-r", fa, "-s", "5000", "-k", "19", "--pi", "85", "-Y",
                  "#", "-n", "1", "--legacy", "--noProgress", "-o", tmp],
                 device=dev)
        os.replace(tmp, mapping)
    with open(mapping) as fh:
        q_bp = sum(int(f[3]) - int(f[2]) + 1
                   for f in (ln.split() for ln in fh if ln.strip()))
    for rep in range(args.reps):
        out = os.path.join(cs.DATA, f"align_bench.{os.getpid()}.aln")
        t0 = time.perf_counter()
        st = align_files([fa], [fa], mapping, 85.0, out, device=dev)
        wall = time.perf_counter() - t0
        stats = dataclasses.asdict(st)
        stats["pieces"] = {f"{p},{w}": k for (p, w), k in
                           sorted(stats["pieces"].items())}
        print(json.dumps({
            "root": root, "card": card, "rep": rep, "wall_s": wall,
            "query_bp": q_bp, "aligned_mbp_per_s": q_bp / 1e6 / wall,
            **stats, "mapping_sha256": sha256(mapping),
            "output_sha256": sha256(out)}), flush=True)
        os.remove(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
