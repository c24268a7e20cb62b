"""Port theta (kernels/theta.py, kernels/winnow.py) vs the JAX package.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against the same plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mashmap_tpu.kernels import winnow as jw
from mashmap_tpu.kernels.winnow_pallas import theta_chunk_pallas, C_T
from mashmap_tpu_torch.kernels import theta as tt
from mashmap_tpu_torch.kernels import winnow as tw

RSENT = tt.RSENT


def _blocks(seed, C, s, s_b, invalid_frac, alphabet=None):
    rng = np.random.default_rng(seed)
    hi = alphabet or 50 * s
    cur = rng.integers(0, hi, (C, s_b)).astype(np.int32)
    nxt = rng.integers(0, hi, (C, s_b)).astype(np.int32)
    cur[rng.random((C, s_b)) < invalid_frac] = RSENT
    nxt[rng.random((C, s_b)) < invalid_frac] = RSENT
    return cur, nxt


# the fast shapes of tests/test_winnow_pallas.py
@pytest.mark.parametrize("seed,s,s_b,invalid_frac", [
    (0, 20, 300, 0.1),
    (1, 30, 513, 0.0),      # s_b not a multiple of any segment length
    (2, 8, 64, 0.5),        # heavy invalidity
])
def test_theta_ref_matches_pallas_and_xla(seed, s, s_b, invalid_frac):
    cur, nxt = _blocks(seed, C_T, s, s_b, invalid_frac)
    ours = tt.theta_chunk(torch.from_numpy(cur), torch.from_numpy(nxt),
                          s, s_b).numpy()
    pallas = np.asarray(theta_chunk_pallas(
        jnp.asarray(cur), jnp.asarray(nxt), s, s_b, interpret=True))
    xla = np.asarray(jw._theta_chunk(jnp.asarray(cur), jnp.asarray(nxt),
                                     s, s_b))
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, xla)


def test_theta_scan_matches_bruteforce():
    """theta of every window of several contigs (block decomposition +
    chunked rows) against the brute-force definition, including a
    contig with fewer than s distinct hashes per window."""
    rng = np.random.default_rng(5)
    s, span = 6, 40
    contigs = [rng.integers(0, 500, n).astype(np.int32)
               for n in (40, 137, 300)]
    contigs.append(rng.integers(0, 4, 90).astype(np.int32))
    contigs[1][rng.random(137) < 0.2] = RSENT
    contigs.append(np.arange(20, dtype=np.int32))       # no full window
    got = tw.theta_scan_ranks([torch.from_numpy(c) for c in contigs],
                              s, span)
    assert got[-1] is None
    for c, g in zip(contigs[:-1], got[:-1]):
        bf = jw.window_thresholds_bruteforce(
            c.astype(np.uint64), c != RSENT, s, span)
        want = np.where(bf == jw.SENTINEL, RSENT, bf).astype(np.int32)
        np.testing.assert_array_equal(g.numpy(), want)


def test_rank_reduce_matches_jax():
    rng = np.random.default_rng(9)
    h = rng.integers(0, 2 ** 63, 3000, dtype=np.uint64) * np.uint64(2)
    h[rng.integers(0, 3000, 500)] = h[rng.integers(0, 3000, 500)]
    h[rng.random(3000) < 0.1] = jw.SENTINEL
    j_r, j_lut = jw._rank_reduce(jnp.asarray(h))
    t_r, t_lut = tw._rank_reduce(torch.from_numpy(h.view(np.int64)))
    np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
    np.testing.assert_array_equal(t_lut.numpy().view(np.uint64),
                                  np.asarray(j_lut))


def test_cpu_tensor_runs_plain_version_without_launch():
    """On a CPU tensor the wrapper runs the plain version: the launch
    count does not move (on a CUDA tensor it launches the kernel)."""
    cur, nxt = _blocks(4, 4, 5, 37, 0.3)
    before = tt.LAUNCHES
    got = tt.theta_chunk(torch.from_numpy(cur), torch.from_numpy(nxt),
                         5, 37)
    assert tt.LAUNCHES == before
    ref = tt.theta_chunk_ref(torch.from_numpy(cur), torch.from_numpy(nxt),
                             5, 37)
    assert torch.equal(got, ref)


def test_wrapper_rejects_bad_inputs():
    cur, nxt = _blocks(0, 2, 4, 16, 0.0)
    c, n = torch.from_numpy(cur), torch.from_numpy(nxt)
    with pytest.raises(TypeError):
        tt.theta_chunk(c.long(), n.long(), 4, 16)
    with pytest.raises(ValueError):
        tt.theta_chunk(c, n, 4, 17)
    with pytest.raises(ValueError):
        tt.theta_chunk(c, n, tt.S_MAX + 1, 16)
    with pytest.raises(ValueError):
        tt.theta_chunk(c.t(), n.t(), 4, 2)

