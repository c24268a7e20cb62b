"""A whole run of the job cell on the CPU at a small size (the harness's
look for a card skipped), once sound and once for each fault the cell
can have, planted in the program under the timed path: a row's answer
altered where it is made (its identity, its place), every fragment's
sketch one hash short (the loss that the reference allows one fragment
of a row, as a frequent seed) and half of the output left out. Sound
comes out correct; every fault does not."""

import copy
import time

import numpy as np
import pytest
import torch

from benchmark import run

CELL = "yeast8-pi85.selfmap-job"


@pytest.fixture(scope="module")
def files():
    bench, cell, cfg = run.cell_files(CELL)
    cfg = copy.deepcopy(cfg)
    cfg["shape"].update(haplotypes=3, chromosomes=[["chrII", 813184],
                                                   ["chrXII", 1078177]])
    return bench, cell, cfg


def _run(files, tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    work = tmp_path / "work"
    work.mkdir()
    result, lines = run.run(CELL, 2**31 + 5, 0.0, False, torch.device("cpu"),
                            str(work), time.perf_counter(), scale=0.03,
                            files=files)
    assert lines[-1].startswith("compared id_gap")
    assert list(result)[-1] == "compared"
    return result


def _identity_off(merge):
    def wrapped(mappings, max_dist):
        out = merge(mappings, max_dist)
        for m in out:
            m.nuc_identity = float(np.float32(m.nuc_identity - 1e-3))
        return out
    return wrapped


def _place_off(merge):
    def wrapped(mappings, max_dist):
        out = merge(mappings, max_dist)
        for m in out:
            m.ref_start += 15_000
            m.ref_end += 15_000
        return out
    return wrapped


def _hash_short(sketch_fragments):
    def wrapped(frags, k, s):
        h, strand, cnt, cx = sketch_fragments(frags, k, s)
        h = torch.cat([h[:, 1:], torch.full_like(h[:, :1], -1)], 1)
        strand = torch.cat([strand[:, 1:], torch.zeros_like(strand[:, :1])],
                           1)
        return h, strand, (cnt - 1).clamp(min=0), cx
    return wrapped


def _half_left_out(emit):
    def wrapped(self, q, rows, out):
        return emit(self, q, rows if q.counter % 2 == 0 else [], out)
    return wrapped


def test_sound_run_is_correct(files, tmp_path, monkeypatch):
    got = _run(files, tmp_path, monkeypatch)
    assert got["correct"], got["compared"]
    assert got["attempted"] == 1 and got["failed"] == 0
    assert got["window"]["checked_rows"] > 10


@pytest.mark.parametrize("fault, where, number", [
    (_identity_off, "merge", "id_gap"),
    (_place_off, "merge", "misplaced"),
    (_hash_short, "sketch", "id_gap"),
    (_half_left_out, "emit", "uncovered_pct"),
])
def test_fault_is_not_correct(files, tmp_path, monkeypatch, fault, where,
                              number):
    from mashmap_tpu_torch.kernels import mapdev
    from mashmap_tpu_torch.map import engine, merge
    if where == "merge":
        monkeypatch.setattr(merge, "merge_mappings_in_range",
                            fault(merge.merge_mappings_in_range))
    elif where == "sketch":
        for mod in (mapdev, engine):
            monkeypatch.setattr(mod, "sketch_fragments",
                                fault(mod.sketch_fragments))
    else:
        monkeypatch.setattr(engine.Mapper, "_emit",
                            fault(engine.Mapper._emit))
    got = _run(files, tmp_path, monkeypatch)
    assert not got["correct"]
    assert got["compared"][number]["value"] > \
        got["compared"][number]["limit"]
    assert got["failed"] == got["attempted"]
