"""The port's multi-process launch on the CPU: two processes, each running
``cli.main(argv, device="cpu")`` and meeting through a gloo process
group, write the same PAF as one process of the port and as the JAX
CLI, and leave no part files."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from mashmap_tpu import cli as jax_cli
from mashmap_tpu_torch import cli
from mashmap_tpu_torch.parallel import distributed

HERE = os.path.dirname(__file__)
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from genomes import mutate, pangenome, write_fasta  # noqa: E402
from port_fixtures import jax_native_reader, one_torch_thread  # noqa

# one process of the port's CLI on the CPU; argv and devices as JSON
RUN = ("import json, sys; from mashmap_tpu_torch import cli; "
       "a = json.loads(sys.argv[1]); "
       "sys.exit(cli.main(a['argv'], device='cpu', devices=a['devices']))")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dist")
    ref = pangenome(3, 30_000, 0.04, seed=31)
    ref_fa = str(d / "ref.fa")
    write_fasta(ref_fa, ref)
    # several queries per process, so the stride interleaves
    rng = np.random.default_rng(9)
    qs = []
    for i, (_, seq) in enumerate(ref * 2):
        lo = int(rng.integers(0, len(seq) // 2))
        qs.append((f"q{i}", mutate(seq[lo:lo + 9_000], 0.03, seed=50 + i)))
    q_fa = str(d / "q.fa")
    write_fasta(q_fa, qs)
    return d, ["-r", ref_fa, "-q", q_fa, "--pi", "85", "-s", "2000",
               "-k", "15", "--noProgress"]


def _launch(argv, devices=None, env_extra=None):
    # one CPU thread a process: the test workers already share the cores
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1",
           **(env_extra or {})}
    return subprocess.Popen(
        [sys.executable, "-c", RUN,
         json.dumps({"argv": argv, "devices": devices})],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _two_processes(argv, devices=None, by_env=False):
    """Run argv as processes 0 and 1; returns their (rc, stderr)."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(2):
        if by_env:
            procs.append(_launch(argv, devices, {
                "MASHMAP_TPU_COORDINATOR": coord,
                "MASHMAP_TPU_NUM_PROCS": "2",
                "MASHMAP_TPU_PROC_ID": str(pid)}))
        else:
            procs.append(_launch(argv + [
                "--coordinator", coord, "--numProcesses", "2",
                "--processId", str(pid)], devices))
    out = []
    for pr in procs:
        _, err = pr.communicate(timeout=600)
        out.append((pr.returncode, err))
    return out


@pytest.mark.parametrize("case,extra,devices,by_env", [
    ("default", [], None, False),
    ("one_to_one", ["-f", "one-to-one"], None, True),
    ("shard", ["--shardIndex"], ["cpu", "cpu"], False),
])
def test_two_processes_match_one_and_jax(inputs, case, extra, devices,
                                         by_env):
    d, base = inputs
    argv = base + extra
    single = str(d / f"{case}.single.paf")
    assert cli.main(argv + ["-o", single], device="cpu") == 0
    jax_out = str(d / f"{case}.jax.paf")
    assert jax_cli.main(argv + ["-o", jax_out]) == 0
    multi = str(d / f"{case}.multi.paf")
    for rc, err in _two_processes(argv + ["-o", multi], devices, by_env):
        assert rc == 0, err[-3000:]
    want = open(single).read()
    assert want.count("\n") >= 6, "too few mappings to interleave"
    assert open(jax_out).read() == want
    assert open(multi).read() == want
    assert not [f for f in os.listdir(d) if ".part" in f]


def test_stdout_output_raises_in_a_multi_process_run(inputs):
    _, base = inputs
    for rc, err in _two_processes(base + ["-o", "-"]):
        assert rc != 0
        assert "ValueError" in err and "not stdout" in err


@pytest.mark.parametrize("pid", ["2", "-1"])
def test_process_id_out_of_range_raises(inputs, monkeypatch, pid):
    d, base = inputs
    with pytest.raises(ValueError, match="out of range"):
        cli.main(base + ["--coordinator", "127.0.0.1:1", "--numProcesses",
                         "2", "--processId", pid, "-o", str(d / "x.paf")],
                 device="cpu")
    # the launch variables, when the flags are absent
    monkeypatch.setenv("MASHMAP_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("MASHMAP_TPU_NUM_PROCS", "2")
    monkeypatch.setenv("MASHMAP_TPU_PROC_ID", pid)
    with pytest.raises(ValueError, match="out of range"):
        distributed.setup()
    assert distributed.context() is None


def test_single_process_unless_coordinator_and_two_processes(monkeypatch):
    for k in ("MASHMAP_TPU_COORDINATOR", "MASHMAP_TPU_NUM_PROCS",
              "MASHMAP_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.setup() is None
    assert distributed.setup("127.0.0.1:1") is None
    assert distributed.setup(None, 2, 1) is None
    assert distributed.setup("127.0.0.1:1", 1, 0) is None
    ctx = distributed.DistContext(1, 3)
    assert [ctx.owns_query(i) for i in range(6)] == [
        False, True, False, False, True, False]
    assert ctx.part_path("o.paf") == "o.paf.part1"
    assert not ctx.is_primary
