"""The port's benchmark programs, bench_torch.py and bench_extra_torch.py,
against the JAX package's bench.py and bench_extra.py on the CPU: the
same Parameters field for field, the configuration functions' PAF bytes
equal to the JAX package's map_files on the same (shorter) data, and
neither program runs without a CUDA card."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from mashmap_tpu.api import map_files as jax_map_files
from mashmap_tpu.params import Parameters as JaxParameters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(__file__))
import bench_extra_torch as bext  # noqa: E402
import bench_torch  # noqa: E402
from port_fixtures import jax_native_reader, one_torch_thread  # noqa

# bench_extra.py's data cut in length only: a 200 kbp pangenome, 20 reads
# against 300 kbp, a 200 kbp pair and two 150 kbp references
SMALL = bext.Sizes(pan_len=50_000, ref_len=300_000, n_reads=20,
                   dense_len=200_000, rl_len=150_000)
CASES = ("oto", "ont", "dense", "dense60", "dense120", "dense200", "rl")


def _sweep_s(case):
    return int(case[5:]) if case[5:] else None


def _jax_params(case, d, out):
    """bench_extra.py's Parameters for the JAX package, as its lines
    write them."""
    if case == "oto":       # bench_extra.py:93-99
        return JaxParameters(ref_sequences=[d["pan4"]], out_file_name=out,
                             percentage_identity=0.95, filter_mode=2,
                             skip_prefix=True, prefix_delim="#",
                             num_mappings_for_segment=1,
                             batch_fragments=2048, no_progress=True)
    if case == "ont":       # :142-146
        return JaxParameters(ref_sequences=[d["ref5m"]],
                             query_sequences=[d["ont"]], out_file_name=out,
                             percentage_identity=0.85, filter_mode=1,
                             batch_fragments=2048, no_progress=True)
    if case == "rl":        # :193-197
        return JaxParameters(ref_sequences=[d["r1"], d["r2"]],
                             query_sequences=[d["q4"]], out_file_name=out,
                             percentage_identity=0.85,
                             batch_fragments=2048, no_progress=True)
    ss = _sweep_s(case)     # :159-165
    return JaxParameters(ref_sequences=[d["da"]], query_sequences=[d["db"]],
                         out_file_name=out, percentage_identity=0.9,
                         dense=ss is None, sketch_size=ss,
                         batch_fragments=2048, no_progress=True)


def _port_params(case, d, out):
    if case == "oto":
        return bext.oto_params(d, out)
    if case == "ont":
        return bext.ont_params(d, out)
    if case == "rl":
        return bext.rl_params(d, out)
    return bext.dense_params(d, out, _sweep_s(case))


def _port_run(case, d):
    if case == "oto":
        return bext.one_to_one(d, "cpu")
    if case == "ont":
        return bext.ont_reads(d, "cpu")
    if case == "rl":
        return bext.multiref_rl(d, "cpu")
    return bext.dense_step(d, "cpu", _sweep_s(case))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return bext.make_data(str(tmp_path_factory.mktemp("bench_extra")),
                          SMALL)


def test_small_data_matches_full_generators(data):
    """The cut data keeps bench_extra.py's shapes: 4 haplotypes, reads of
    10-30 kb, one record a reference file, two queries."""
    lens = {k: bext.seq_lengths(data[k]) for k in (
        "pan4", "ont", "da", "db", "r1", "r2", "q4")}
    assert list(lens["pan4"]) == [f"hap#{i}#chr1" for i in range(4)]
    assert len(lens["ont"]) == SMALL.n_reads
    assert all(10_000 <= n < 30_000 for n in lens["ont"].values())
    assert lens["da"] == {"gA": SMALL.dense_len}
    assert lens["db"] == {"gB": SMALL.dense_len}
    assert list(lens["r1"]) == ["refA"] and list(lens["r2"]) == ["refB"]
    assert list(lens["q4"]) == ["qA", "qB"]


@pytest.mark.parametrize("case", CASES)
def test_params_equal_bench_extra(data, case, tmp_path):
    out = str(tmp_path / "o.paf")
    got = _port_params(case, data, out).finalize()
    want = _jax_params(case, data, out).finalize()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_params_equal_bench(data, tmp_path):
    """bench_torch.make_params against bench.py:49-57's arguments."""
    fa, out = data["pan4"], str(tmp_path / "o.paf")
    want = JaxParameters(
        ref_sequences=[fa], out_file_name=out,
        percentage_identity=85 / 100.0, skip_prefix=True,
        prefix_delim="#", num_mappings_for_segment=1,
        batch_fragments=1024).finalize()
    got = bench_torch.make_params(fa, out).finalize()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("case", CASES)
def test_config_paf_byte_identical_to_jax(data, case):
    """Each configuration function on the CPU writes the JAX package's
    map_files bytes for bench_extra.py's Parameters, with at least one
    row."""
    r = _port_run(case, data)
    out = os.path.join(data["dir"], f"jax_{case}.paf")
    jax_map_files(_jax_params(case, data, out))
    with open(out, "rb") as fh:
        want = fh.read()
    assert r.paf == want
    assert r.rows >= 1
    assert r.key == (case if case in ("oto", "ont", "rl")
                     else f"dense-{r.sketch_size}")
    assert 0 < r.build_s < r.seconds
    # data cut in length has other bytes than EXTRA_SHA256's; the gates hold
    assert bext.check(data, r) == [
        f"{r.key}: PAF sha256 {r.sha256} != the JAX package's "
        f"{bext.EXTRA_SHA256[r.key]}"]
    if case == "oto":
        assert bext.coverage_min(data, r)[0] >= bext.MIN_COVERAGE
    elif case == "ont":
        assert bext.mapped_fraction(data, r) > 0.5
    elif case.startswith("dense"):
        assert bext.ani_error(r) <= 1.0
        if case == "dense":
            assert r.sketch_size == 298


@pytest.mark.parametrize("script", ["bench_torch.py",
                                    "bench_extra_torch.py"])
def test_no_cuda_no_result(script):
    """Without a CUDA card each program exits non-zero before it runs
    anything, and prints no result: only an error line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 2
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    assert lines and all("error" in ln for ln in lines)
