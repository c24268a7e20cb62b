"""A whole run of the assembly job cell on the CPU at a small size (the
harness's look for a card skipped): two chromosomes of a few hundred kb
and their assembly's contigs, at the cell's -J 310. Sound comes out
correct, traced, with every per-layer metric the program's spans feed;
a row's place or identity altered where it is made does not."""

import time

import pytest
import torch

from benchmark import run
from test_benchmark_faults import _identity_off, _place_off

CELL = "hg38-chr21-22-asm-pi85.asm-job"
SCALE = 0.006


def _run(tmp_path, monkeypatch, trace=False):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    work = tmp_path / "work"
    work.mkdir()
    result, lines = run.run(CELL, 2**31 + 11, 0.0, trace,
                            torch.device("cpu"), str(work),
                            time.perf_counter(), scale=SCALE)
    assert lines[-1].startswith("compared id_gap")
    assert list(result)[-1] == "compared"
    return result


def test_sound_run_is_correct_at_s_310(tmp_path, monkeypatch):
    got = _run(tmp_path, monkeypatch, trace=True)
    assert got["correct"], got["compared"]
    assert got["attempted"] == 1 and got["failed"] == 0
    assert (got["window"]["k"], got["window"]["s"]) == (19, 310)
    assert got["window"]["host_route_fragments"] == [0]
    _, cell, _ = run.cell_files(CELL)
    assert got["window"]["query_bp"] == int(cell["params"]["query_bp"]
                                            * SCALE)
    assert got["window"]["checked_rows"] >= 10
    bench, _, _ = run.cell_files(CELL)
    spans = {m["name"] for m in run.metrics_of(bench, CELL)[1]
             if m["source"] == "program_span"}
    assert len(spans) == 11 and spans <= set(got["metrics"])
    assert all(got["metrics"][m]["value"] >= 0 for m in spans)


@pytest.mark.parametrize("fault, number", [
    (_identity_off, "id_gap"),
    (_place_off, "misplaced"),
])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault, number):
    from mashmap_tpu_torch.map import merge
    monkeypatch.setattr(merge, "merge_mappings_in_range",
                        fault(merge.merge_mappings_in_range))
    got = _run(tmp_path, monkeypatch)
    assert not got["correct"]
    assert got["compared"][number]["value"] > \
        got["compared"][number]["limit"]
    assert got["failed"] == got["attempted"]
