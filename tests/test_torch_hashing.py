"""Port hashing (mashmap_tpu_torch.kernels.murmur/kmers) vs the JAX
package and the byte-serial oracle; every comparison is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mashmap_tpu.kernels import kmers as jk
from mashmap_tpu.kernels import murmur as jm
from mashmap_tpu.index import builder as jb
from mashmap_tpu_torch.kernels import kmers as tk
from mashmap_tpu_torch.kernels import murmur as tm
from mashmap_tpu_torch.index import builder as tb

ACGTN = np.frombuffer(b"ACGTN", np.uint8)


def _seqs(seed, shape, n_frac=0.05):
    rng = np.random.default_rng(seed)
    s = rng.choice(ACGTN[:4], size=shape).astype(np.uint8)
    s[rng.random(shape) < n_frac] = ord("N")
    return s


def _u64(x):
    return np.asarray(x).view(np.uint64) if np.asarray(x).dtype == np.int64 \
        else np.asarray(x)


@pytest.mark.parametrize("k", [11, 16, 19, 32])
def test_hash_kmer_windows_matches_jax_and_oracle(k):
    seq = _seqs(k, (2, 257))
    ours = _u64(tm.hash_kmer_windows(torch.from_numpy(seq), k).numpy())
    ref = np.asarray(jm.hash_kmer_windows(jnp.asarray(seq), k))
    np.testing.assert_array_equal(ours, ref)
    for i in (0, 17, seq.shape[1] - k):
        assert int(ours[1, i]) == tm.murmur128_low64_py(
            seq[1, i:i + k].tobytes())
        assert tm.murmur128_low64_py(b"ACGT" * 8) == \
            jm.murmur128_low64_py(b"ACGT" * 8)


@pytest.mark.parametrize("k", [11, 16, 19, 32])
def test_canonical_kmer_hashes_matches_jax(k):
    seq = _seqs(100 + k, (3, 400), n_frac=0.1)
    ours = tk.canonical_kmer_hashes(torch.from_numpy(seq), k)
    ref = jk.canonical_kmer_hashes(jnp.asarray(seq), k)
    names = ("hashes", "strand", "palindrome", "has_n", "has_n_tail")
    for name, o, r in zip(names, ours, ref):
        np.testing.assert_array_equal(_u64(o.numpy()), np.asarray(r),
                                      err_msg=name)
    # canonical = unsigned min of the forward and reverse-complement hash
    row = seq[0]
    rc = tk.revcomp_np(row)
    for i in (0, 5, len(row) - k):
        f = tm.murmur128_low64_py(row[i:i + k].tobytes())
        b = tm.murmur128_low64_py(rc[len(rc) - i - k:len(rc) - i].tobytes())
        assert int(_u64(ours[0].numpy())[0, i]) == min(f, b)


def test_sanitize_and_revcomp_match_jax():
    raw = b"acgtNNxyACGTRYacgT"
    np.testing.assert_array_equal(tk.sanitize(raw), jk.sanitize(raw))
    s = jk.sanitize(raw)
    np.testing.assert_array_equal(tk.revcomp_np(s), jk.revcomp_np(s))


def test_first_slab_tail_n_rule(monkeypatch):
    """Only a contig's first k-1 bases are exempt from the N rule: N's
    there leave k-mers valid (addMinmers inspects window ends only),
    later N's invalidate every window that holds them — also when the
    contig is hashed in several slabs."""
    k = 11
    rng = np.random.default_rng(3)
    seq = rng.choice(ACGTN[:4], size=300).astype(np.uint8)
    seq[[2, 7, 150]] = ord("N")
    h, st = tb._hash_contig(seq, k, torch.device("cpu"))
    valid = h.numpy() != tm.UMAX
    jfn = jb._hash_slab_fn(k)
    jh, jst, jv = jfn(jnp.asarray(seq), True)
    np.testing.assert_array_equal(valid, np.asarray(jv))
    np.testing.assert_array_equal(_u64(h.numpy())[valid],
                                  np.asarray(jh)[valid])
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert valid[:3].all()                     # N at 2 and 7 are exempt
    assert not valid[150 - k + 1:151].any()    # the N at 150 is not
    # a slab that is not the contig's first uses the full-window rule
    _, _, jv2 = jfn(jnp.asarray(seq), False)
    assert not np.asarray(jv2)[:3].any()
    monkeypatch.setattr(tb, "_HASH_SLAB", 64)
    h2, st2 = tb._hash_contig(seq, k, torch.device("cpu"))
    assert torch.equal(h2, h) and torch.equal(st2, st)
