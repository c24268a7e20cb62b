"""The readers of the program's span totals (``benchmark/spans.py``):
a hand-made window's value, nothing where the program keeps nothing,
and ``devtrace.label_gaps``, whose later groups label only the gaps
that the earlier ones leave as ``other``."""

import collections
import sys

import numpy as np
import pytest

from benchmark import devtrace, run
from mashmap_tpu_torch import trace

UNITS = [{"query_bp": 2_000_000_000}, {"query_bp": 2_000_000_000}]
JOBS = [
    (1, {"build worker-wait": (9.0, 1)}),          # the warm unit
    (2, {"build worker-wait": (2.0, 1), "build read": (0.25, 40),
         "build tail-concat": (0.1, 1), "build tail-sort": (0.3, 1),
         "build tail-ranks": (0.2, 1), "build tail-filter": (0.05, 1),
         "map setup": (0.2, 1), "setup-cutoffs": (0.1, 1),
         "tables-host": (0.3, 1), "tables-upload": (0.1, 1),
         "map query-wait": (0.05, 40), "map finalize": (0.4, 40),
         "merge-filter": (0.3, 40), "post-l2": (1.0, 900)}),
    (3, {"build worker-wait": (3.0, 1), "build read": (0.15, 40),
         "build tail-sort": (0.25, 1), "map setup": (0.4, 1),
         "tables-host": (0.2, 1), "map finalize": (0.8, 40),
         "post-l2": (3.0, 900)}),
]
WANT = {
    "build_worker_wait_s.job": (2.0 + 3.0) / 2,
    "build_tail_s.job": (0.1 + 0.3 + 0.2 + 0.05 + 0.25) / 2,
    "front_door_wait_s.job": (0.25 + 0.05 + 0.15) / 2,
    "map_setup_s.job": (0.2 + 0.3 + 0.1 + 0.4 + 0.2) / 2,
    "map_finalize_s_per_gbp.job": (0.4 + 0.8) / 4,
    "map_post_l2_s_per_gbp.job": (1.0 + 3.0) / 4,
}


@pytest.fixture
def jobs(monkeypatch):
    monkeypatch.setattr(trace, "JOBS", collections.deque(JOBS, maxlen=64))


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_the_window_jobs(metric, jobs):
    got = run.reader(metric)({"units": UNITS, "trace": None})
    assert got == pytest.approx(WANT[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_nothing_where_the_program_keeps_nothing(
        metric, monkeypatch):
    read = run.reader(metric)
    monkeypatch.setattr(trace, "JOBS", collections.deque(JOBS[-1:]))
    assert read({"units": UNITS, "trace": None}) is None   # too few jobs
    monkeypatch.setattr(trace, "JOBS", collections.deque(
        [(1, {}), (2, {"other": (1.0, 1)})]))
    assert read({"units": UNITS, "trace": None}) is None   # no such span
    # a program without trace.py (an older checkout)
    monkeypatch.setitem(sys.modules, "mashmap_tpu_torch.trace", None)
    monkeypatch.delattr("mashmap_tpu_torch.trace")
    assert read({"units": UNITS, "trace": None}) is None


def test_a_third_group_labels_only_what_the_first_two_left():
    gaps = np.array([[10, 20], [30, 40], [50, 60], [70, 80]], np.int64)
    main = [(0, 25, "map post")]
    worker = [(28, 45, "build host-classify"), (0, 25, "build x")]
    spans = [(5, 15, "map finalize"), (35, 38, "build worker-wait"),
             (48, 62, "build tail-sort")]
    two = devtrace.label_gaps(gaps, [main, worker])
    three = devtrace.label_gaps(gaps, [main, worker, spans])
    assert two == {"map post": 10, "build host-classify": 10, "other": 20}
    assert three == {"map post": 10, "build host-classify": 10,
                     "build tail-sort": 10, "other": 10}
