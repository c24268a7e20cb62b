"""Sequence byte sanitation and canonical k-mer hashing.

Reference semantics reimplemented here (counterpart of
``mashmap_tpu/kernels/kmers.py``):

- ``makeUpperCaseAndValidDNA``: uppercase a-z, then any byte that is not
  one of 'A','C','G','T' becomes 'N' (commonFunc.hpp:75-107).
- canonical hash = min(murmur(kmer), murmur(revcomp(kmer))); k-mers whose
  forward and reverse hashes are equal ("symmetric") are skipped; strand is
  FWD if the forward hash is the smaller one (commonFunc.hpp:225-240).
- ambiguity ('N') masking. The reference has *two different* N rules:
  * query sketching pre-scans the first k-1 bases, so a k-mer is invalid
    iff ANY of its k bases is 'N' (commonFunc.hpp:207-222);
  * reference winnowing (addMinmers) only inspects the last base of each
    window (commonFunc.hpp:412-415), so 'N's within the first k-1 bases of
    a contig do NOT invalidate k-mers. Both rules are returned
    (``has_n`` vs ``has_n_tail``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..hostcopy import to_device
from .murmur import flip, hash_kmer_windows

# strand labels (reference: base_types.hpp:103-108)
FWD = 1
AMBIG = 0
REV = -1

# --- host-side byte tables -------------------------------------------------

_SANITIZE = np.full(256, ord("N"), dtype=np.uint8)
for _b in b"ACGT":
    _SANITIZE[_b] = _b
    _SANITIZE[_b + 32] = _b  # lowercase

_COMPLEMENT = np.full(256, ord("N"), dtype=np.uint8)
for _x, _y in zip(b"ACGT", b"TGCA"):
    _COMPLEMENT[_x] = _y


def sanitize(seq_bytes: bytes | np.ndarray) -> np.ndarray:
    """Uppercase + non-ACGT -> 'N'. Host-side (numpy)."""
    arr = np.frombuffer(seq_bytes, dtype=np.uint8) if isinstance(
        seq_bytes, (bytes, bytearray)) else np.asarray(seq_bytes, np.uint8)
    return _SANITIZE[arr]


@functools.lru_cache(maxsize=None)
def _complement_on(device: torch.device) -> torch.Tensor:
    """The complement table on ``device``, uploaded once: a copy from host
    memory inside a step would be recorded into its CUDA graph, which
    would then read a pinned buffer that the host reuses."""
    return to_device(_COMPLEMENT, device)


def revcomp_np(seq_u8: np.ndarray) -> np.ndarray:
    """Reverse complement of a sanitized byte array (host)."""
    return _COMPLEMENT[seq_u8][::-1]


def _window_any(mask: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """any(mask[..., i:i+k]) for every window i < n."""
    cn = torch.cumsum(mask.to(torch.int32), dim=-1)
    left = torch.cat([torch.zeros_like(cn[..., :1]), cn[..., :n - 1]],
                     dim=-1)
    return (cn[..., k - 1:] - left) > 0


def canonical_kmer_hashes(seq_u8: torch.Tensor, k: int):
    """Canonical hashes + strand + masks for every k-mer window.

    Args:
      seq_u8: (..., L) sanitized uint8 ASCII bytes.
      k: k-mer size.

    Returns:
      hashes: (..., L-k+1) int64 u64 bits, canonical (unsigned min of
        fwd/rev) hashes.
      strand: (..., L-k+1) int8, +1 FWD / -1 REV.
      palindrome: (..., L-k+1) bool, fwd hash == rev hash (skipped kmers).
      has_n: (..., L-k+1) bool, window contains an 'N' (full-window rule).
      has_n_tail: (..., L-k+1) bool, addMinmers rule: an 'N' at a
        *window-end* base position within the window (positions >= k-1).
    """
    L = seq_u8.shape[-1]
    n = L - k + 1
    fwd = hash_kmer_windows(seq_u8, k)

    comp = _complement_on(seq_u8.device)
    rc = comp[torch.flip(seq_u8, dims=[-1]).long()]
    # rev-hash of window starting at i == hash of rc window at L-i-k
    bwd = torch.flip(hash_kmer_windows(rc, k), dims=[-1])

    palindrome = fwd == bwd
    fwd_lt = flip(fwd) < flip(bwd)               # unsigned fwd < bwd
    hashes = torch.where(fwd_lt, fwd, bwd)
    strand = torch.where(fwd_lt, FWD, REV).to(torch.int8)

    is_n = seq_u8 == ord("N")
    has_n = _window_any(is_n, k, n)
    # addMinmers rule: N at position p invalidates k-mers i with
    # max(i, k-1) <= p <= i+k-1, i.e. only p >= k-1 matter.
    is_n_tail = is_n.clone()
    is_n_tail[..., : k - 1] = False
    has_n_tail = _window_any(is_n_tail, k, n)
    return hashes, strand, palindrome, has_n, has_n_tail
