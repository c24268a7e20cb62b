"""The port on a CUDA card: the hand-written theta kernel against its plain
version, and the card's index build against the CPU's.

These tests need a card and skip without one. The card's machine has no
JAX, so run them there without the JAX-importing conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from mashmap_tpu_torch.index import builder
from mashmap_tpu_torch.kernels import theta as tt

sys.path.insert(0, os.path.dirname(__file__))
from genomes import pangenome  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("C,s_b,s,invalid_frac", [
    (64, 4982, 130, 0.02), (64, 513, 30, 0.0), (32, 4982, 398, 0.5),
    (7, 100, 200, 0.0)])   # s above the distinct count: all RSENT
def test_kernel_matches_plain_version(cuda, C, s_b, s, invalid_frac):
    rng = np.random.default_rng(C + s)
    cur = rng.integers(0, 4 * s_b, (C, s_b)).astype(np.int32)
    nxt = rng.integers(0, 4 * s_b, (C, s_b)).astype(np.int32)
    cur[rng.random((C, s_b)) < invalid_frac] = tt.RSENT
    nxt[rng.random((C, s_b)) < invalid_frac] = tt.RSENT
    c = torch.from_numpy(cur).to(cuda)
    n = torch.from_numpy(nxt).to(cuda)
    before = tt.LAUNCHES
    got = tt.theta_chunk(c, n, s, s_b)
    torch.cuda.synchronize()
    assert tt.LAUNCHES == before + 1
    assert torch.equal(got, tt.theta_chunk_ref(c, n, s, s_b))


def test_card_index_equals_cpu_index(cuda):
    contigs = pangenome(3, 40_000, 0.05, seed=5)
    before = tt.LAUNCHES
    a = builder.build_index(contigs, 11, 500, 24, device=cuda)
    assert tt.LAUNCHES > before
    b = builder.build_index(contigs, 11, 500, 24, device="cpu")
    for f in builder._NPZ_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.freq_threshold == b.freq_threshold
