"""The port's cutoff table (stats.sketch_cutoffs) against the JAX
package's, and its memo on disk under $XDG_CACHE_HOME/mashmap_tpu_torch."""

import os
import subprocess
import sys

import numpy as np
import pytest

from mashmap_tpu import stats as jax_stats
from mashmap_tpu_torch import stats

ARGS = (40, 19, 0.0, 0.999)


@pytest.fixture
def cache_home(tmp_path, monkeypatch):
    """A fresh $XDG_CACHE_HOME and empty in-process memos."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    stats.sketch_cutoffs.cache_clear()
    jax_stats.sketch_cutoffs.cache_clear()
    yield tmp_path
    stats.sketch_cutoffs.cache_clear()
    jax_stats.sketch_cutoffs.cache_clear()


@pytest.mark.parametrize("args", [ARGS, (30, 16, 1.0, 0.999)])
def test_table_matches_jax_and_lands_on_disk(cache_home, args):
    got = stats.sketch_cutoffs(*args)
    np.testing.assert_array_equal(got, jax_stats.sketch_cutoffs(*args))
    path = stats.cutoffs_cache_path(*args)
    assert os.path.dirname(path) == str(cache_home / "mashmap_tpu_torch")
    np.testing.assert_array_equal(np.load(path), got)
    assert not [f for f in os.listdir(os.path.dirname(path))
                if ".tmp" in f]


def test_memo_is_read_back_without_computing(cache_home, monkeypatch):
    """With the in-process memo cleared, the table comes from the file."""
    want = stats.sketch_cutoffs(*ARGS)
    stats.sketch_cutoffs.cache_clear()

    def no_compute(*a):
        raise AssertionError("the table was computed again")
    monkeypatch.setattr(stats, "compute_cutoffs", no_compute)
    np.testing.assert_array_equal(stats.sketch_cutoffs(*ARGS), want)


def test_memo_is_read_by_a_new_process(cache_home):
    want = stats.sketch_cutoffs(*ARGS)
    code = ("import sys; from mashmap_tpu_torch import stats; "
            "stats.compute_cutoffs = None; "
            f"print(stats.sketch_cutoffs{ARGS!r}.tolist())")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert eval(r.stdout) == want.tolist()


def test_unreadable_memo_is_computed_again(cache_home):
    path = stats.cutoffs_cache_path(*ARGS)
    os.makedirs(os.path.dirname(path))
    with open(path, "wb") as fh:
        fh.write(b"not a table")
    got = stats.sketch_cutoffs(*ARGS)
    np.testing.assert_array_equal(got, stats.compute_cutoffs(*ARGS))
    np.testing.assert_array_equal(np.load(path), got)
