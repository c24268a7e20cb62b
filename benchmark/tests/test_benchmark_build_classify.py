"""The reader of ``build_classify_s.job``: the program's ``build
classify`` span averaged over the window's jobs, and nothing where no
job has the span or the program keeps no jobs."""

import collections
import sys

import pytest

from benchmark import run
from mashmap_tpu_torch import trace

METRIC = "build_classify_s.job"
UNITS = [{"query_bp": 2_000_000_000}, {"query_bp": 2_000_000_000}]
JOBS = [
    (1, {"build classify": (9.0, 1)}),             # the warm unit
    (2, {"build worker-wait": (0.004, 1), "build classify": (0.125, 1),
         "build classify contigs": (0.0, 128), "build read": (0.25, 40),
         "build tail-sort": (0.3, 1), "map finalize": (0.4, 40)}),
    (3, {"build worker-wait": (0.002, 1), "build classify": (0.375, 1),
         "build classify contigs": (0.0, 20), "map finalize": (0.8, 40)}),
]


def test_reads_the_window_jobs_span(monkeypatch):
    monkeypatch.setattr(trace, "JOBS", collections.deque(JOBS, maxlen=64))
    got = run.reader(METRIC)({"units": UNITS, "trace": None})
    assert got == pytest.approx((0.125 + 0.375) / 2, rel=1e-12)


@pytest.mark.parametrize("jobs", [
    JOBS[-1:],                                           # too few jobs
    [(1, {}), (2, {"build worker-wait": (2.0, 1)})],     # no such span
    [(1, {}), (2, {"build classify contigs": (0.0, 3)})],  # the count alone
], ids=["too-few-jobs", "no-span", "count-only"])
def test_reads_nothing_where_no_job_has_the_span(jobs, monkeypatch):
    monkeypatch.setattr(trace, "JOBS", collections.deque(jobs))
    assert run.reader(METRIC)({"units": UNITS, "trace": None}) is None


def test_reads_nothing_without_the_programs_trace(monkeypatch):
    monkeypatch.setitem(sys.modules, "mashmap_tpu_torch.trace", None)
    monkeypatch.delattr("mashmap_tpu_torch.trace")
    assert run.reader(METRIC)({"units": UNITS, "trace": None}) is None
