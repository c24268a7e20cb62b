#!/usr/bin/env python3
"""Benchmark of mashmap_tpu_torch on CUDA: one cell, one run.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Everything is found by name: the cell's file ``workloads/CELL.json``
names its configuration (``configs/<config>.json``: the deployment's
Parameters, generator and shape, and how its output is checked), its
traffic driver (``traffic/<driver>.py``) and the limits of the compared
numbers; ``BENCHMARK.json`` at the root of the checkout says which
end-to-end and per-layer metrics the cell reports, and each per-layer
metric is read by ``metrics/<metric>.py``.

A run makes its inputs from the seed, sets up (the driver's set-up and
one warm unit, so every kernel is built, every graph captured and the
cutoff table on disk before the window), then runs units back to back
(a whole job or a pass of the map, through ``map_files``) until
``--seconds`` have passed; the window ends with the unit running then.
Rates are the query bases of all the window's units over their seconds.
Both peaks are read when the window closes. Then the program's state is
freed and the plain reference judges every unit's PAF (see
``reference/check.py``). With ``--trace 1`` the first unit of the
window runs under torch.profiler and the program's DEBUG records are
kept: the result carries the per-layer metrics, the device's busy and
window seconds and a breakdown, in place of the end-to-end metrics.

The last line of standard output is the result; the last lines of
standard error, and the result's last key ``compared``, give each
compared number beside its limit. Without a CUDA card (or with fewer
than the cell asks for) it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "mashmap_tpu")
GIB = float(1 << 30)


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def cell_files(name: str):
    """(BENCHMARK.json, the cell's file, its configuration's file)."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    cfg = load_json(os.path.join(HERE, "configs", f"{cell['config']}.json"))
    return bench, cell, cfg


def metrics_of(bench: dict, name: str):
    """The cell's end-to-end and per-layer metric entries."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in names]
    return e2e, per_layer


def reader(metric: str):
    """``read(rec)`` of metrics/<metric>.py, or where there is none, of
    the file named by the metric's name before its first dot: one reader
    serves ``device_idle_share.job`` and ``device_idle_share.map``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Records(logging.Handler):
    """The program's log records, with the host clock (ns) at emit."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.got = []

    def emit(self, record):
        self.got.append((time.time_ns(), record.msg, record.args))

    def since(self, t_ns: int):
        return [r for r in self.got if r[0] >= t_ns]


def unit_record(recs, t_ns: int, builder) -> dict:
    """One unit's build seconds, worker seconds, map phase seconds, and
    its host phases as (start ns, end ns, label) for the trace."""
    out = {"build_s": None, "worker_s": None, "phases": {},
           "spans_main": [], "spans_worker": []}
    for t, msg, args in recs.since(t_ns):
        if msg.startswith("reference index built in"):
            out["build_s"] = float(args[0])
        elif msg.startswith("map phase"):
            lab, sec = args[0].strip(), float(args[1])
            out["phases"][lab] = out["phases"].get(lab, 0.0) + sec
            out["spans_main"].append((t - int(sec * 1e9), t, f"map {lab}"))
        elif msg.startswith("group ") and " phase " in msg:
            lab, sec = args[1].strip(), float(args[2])
            span = (t - int(sec * 1e9), t, f"build {lab}")
            (out["spans_worker"] if lab in builder.WORKER_PHASES
             else out["spans_main"]).append(span)
    if out["build_s"] is not None:
        out["worker_s"] = sum(
            sec for ph in builder.GROUP_PHASE_S.values()
            for lab, sec in ph.items() if lab in builder.WORKER_PHASES)
    return out


def cpu_seconds() -> float:
    """This process's CPU seconds, all threads: beside a unit's wall
    seconds it tells a unit that did more work from one that waited."""
    t = os.times()
    return t.user + t.system


def say(text: str) -> None:
    print(f"[bench] {text}", file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(name: str, seed: int, seconds: float, trace: bool, device,
        workdir: str, t0: float, scale: float = 1.0, files=None):
    """One run of cell ``name``; returns (result dict, compared lines).
    ``scale`` shortens the generated sequences and ``files`` stands in
    for ``cell_files(name)`` (tests only)."""
    import torch
    from mashmap_tpu_torch.index import builder
    from mashmap_tpu_torch.kernels import graphs, winnow
    from mashmap_tpu_torch.map import engine
    from benchmark import devtrace
    from benchmark.reference import check

    bench, cell, cfg = files or cell_files(name)
    e2e, per_layer = metrics_of(bench, name)
    cuda = device.type == "cuda"
    driver = importlib.import_module(f"benchmark.traffic.{cell['driver']}")
    st = driver.setup(cfg, cell, seed, device, workdir, scale)
    say(f"inputs made and set up at {time.perf_counter() - t0:.1f} s")
    driver.unit(st)                                 # the warm unit
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    say(f"warm unit done: set-up {setup_s:.1f} s")
    host_frags, mapper_s = [], []
    mapper_run = engine.Mapper.run

    def counted(self, *a, **kw):
        try:
            return mapper_run(self, *a, **kw)
        finally:
            host_frags.append(self.path_stats["host_frags"])
            mapper_s.append(sum(self.phase_s.values()))
    engine.Mapper.run = counted

    recs = Records()
    log = logging.getLogger("mashmap_tpu_torch")
    if trace:
        log.addHandler(recs)
        log.setLevel(logging.DEBUG)
    units, pafs, theta_calls, summary = [], [], [], None
    try:
        w0 = time.perf_counter()
        while True:
            first = trace and not units
            chunk = winnow.theta_chunk
            if first:
                def timed(cur, nxt, s, s_b):
                    theta_calls.append((int(cur.shape[0]), int(s_b)))
                    return chunk(cur, nxt, s, s_b)
                winnow.theta_chunk = timed
            tracer = devtrace.Tracer(device) if first and cuda else None
            cpu0 = cpu_seconds()
            u_ns, u0 = time.time_ns(), time.perf_counter()
            try:
                if tracer is not None:
                    with tracer:
                        pafs.append(driver.unit(st))
                else:
                    pafs.append(driver.unit(st))
                if cuda:
                    torch.cuda.synchronize(device)
            finally:
                winnow.theta_chunk = chunk
            u1 = time.perf_counter()
            unit = {"seconds": u1 - u0, "query_bp": st.query_bp,
                    "cpu_s": cpu_seconds() - cpu0,
                    "mapper_s": mapper_s[-1] if mapper_s else None}
            if trace:
                unit.update(unit_record(recs, u_ns, builder))
            units.append(unit)
            if tracer is not None:
                names, iv, window = tracer.events()
                summary = devtrace.summarize(
                    names, iv, window,
                    [unit["spans_main"], unit["spans_worker"]])
                summary["theta_bound_s"] = devtrace.theta_bound_s(
                    theta_calls)
                summary["theta_calls"] = len(theta_calls)
                del tracer, names, iv
            say(f"unit {len(units)}: {unit['seconds']:.2f} s (cpu "
                f"{unit['cpu_s']:.2f} s, Mapper.run "
                f"{unit['mapper_s'] or 0:.2f} s)")
            if u1 - w0 >= seconds:
                break
    finally:
        log.removeHandler(recs)
        engine.Mapper.run = mapper_run
    window_s = sum(u["seconds"] for u in units)
    bp = sum(u["query_bp"] for u in units)
    peak_dev = torch.cuda.max_memory_reserved(device) if cuda else 0
    peak_host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    values = {"setup_s": setup_s, cell["rate"]: bp / 1e6 / window_s,
              "peak_device_gib": peak_dev / GIB,
              "peak_host_gib": peak_host / GIB}
    metrics = {}
    if trace:
        rec = {"units": units, "trace": summary}
        for m in per_layer:
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    k, s, seg = st.k, st.s, st.seg
    driver.release(st)
    if cuda:
        graphs.clear(device)
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    truth = driver.truth(st)
    how = dict(cfg["check"], pi=cfg["parameters"]["percentage_identity"])
    got = check.judge(pafs, truth, seed, how, k, s, seg, device,
                      cell["limits"])
    say(f"checked {got['checked_rows']} rows, {got['checked_fragments']} "
        f"fragments in {time.perf_counter() - c0:.1f} s")
    limits = cell["limits"]
    correct = all(got[n] <= lim for n, lim in limits.items())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak_dev),
           "power": power_limit() if cuda else "none"}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {"correct": correct, "attempted": len(units),
              "failed": got["failed_units"], "metrics": metrics,
              "device": dev}
    if trace and summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["window"] = {"seconds": window_s, "units": len(units),
                        "query_bp": bp, "k": k, "s": s,
                        "host_route_fragments": host_frags,
                        "unit_s": [u["seconds"] for u in units],
                        "unit_cpu_s": [u["cpu_s"] for u in units],
                        "unit_mapper_s": [u["mapper_s"] for u in units],
                        "checked_rows": got["checked_rows"],
                        "checked_fragments": got["checked_fragments"]}
    result["compared"] = {n: {"value": got[n], "limit": lim}
                          for n, lim in limits.items()}
    lines = [f"compared {n} {got[n]!r} limit {lim!r}"
             for n, lim in limits.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = os.path.join(HERE, "cache")
    os.environ["XDG_CACHE_HOME"] = os.path.join(cache, "xdg")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    _, cell, _ = cell_files(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    workdir = os.path.join(tempfile.gettempdir(),
                           f"mashmap-bench-{args.workload}")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        result, lines = run(args.workload, args.seed, args.seconds,
                            bool(args.trace), device, workdir, T0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        print(f"run.py: the process loaded {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
