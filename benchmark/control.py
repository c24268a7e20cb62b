#!/usr/bin/env python3
"""The control of a cell, at the cell's own size: the plain reference in
the program's place with half the configuration's sketch, judged as a
run's PAF is. It has to come out not correct; its ``id_gap`` is the
upper reading that the cell's limit is set below.

    python3 benchmark/control.py --workload CELL --seed N [--seed M ...]
        [--one-fragment] [--max-fragments F]

``--one-fragment`` judges rows of one fragment each (a sample of F
fragments, by default the cell's check size), where the reference
allows one frequent seed.

One JSON line a seed. The benchmark's own runs do not run it. Without a
CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import run  # noqa: E402


def control(name: str, seed: int, device, workdir: str, scale: float = 1.0,
            one_fragment: bool = False, max_fragments: int = 0):
    from benchmark.reference import check
    _, cell, cfg = run.cell_files(name)
    driver = importlib.import_module(f"benchmark.traffic.{cell['driver']}")
    st = driver.setup_inputs(cfg, cell, seed, device, workdir, scale)
    how = dict(cfg["check"], pi=cfg["parameters"]["percentage_identity"])
    if max_fragments:
        how["max_fragments"] = max_fragments
    t0 = time.perf_counter()
    got = check.control(driver.truth(st), seed, how, st.k, st.s, st.seg,
                        device, cell["limits"], one_fragment)
    got.update(seed=seed, seconds=time.perf_counter() - t0,
               one_fragment=one_fragment,
               correct=all(got[n] <= lim
                           for n, lim in cell["limits"].items()))
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--one-fragment", action="store_true")
    ap.add_argument("--max-fragments", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seed:
        with tempfile.TemporaryDirectory() as work:
            print(json.dumps(control(
                args.workload, seed, torch.device("cuda", 0), work,
                one_fragment=args.one_fragment,
                max_fragments=args.max_fragments)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
