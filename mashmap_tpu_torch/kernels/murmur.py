"""Vectorized MurmurHash3_x64_128 (low 64 bits) over k-mer windows.

The reference hashes every k-mer (forward and reverse-complement) with
MurmurHash3_x64_128 seeded with 42 and keeps the low 64 bits
(reference: src/common/murmur3.h:226-303 and
src/map/include/commonFunc.hpp:37,138-147). Bit-exact parity is
mandatory: every downstream decision keys on these hash values.

Counterpart of ``mashmap_tpu/kernels/murmur.py``. The u64 lanes are held
in ``torch.int64`` (CPU torch has no ``>>`` for ``torch.uint64``):
wrapping multiplication, addition, xor and left shifts are bit-identical
in two's complement, and logical right shifts mask off the sign
extension (``_lsr``). Unsigned order, where needed, is signed order
after an xor with ``1 << 63`` (``flip``).
"""

from __future__ import annotations

import torch

SEED = 42  # reference: commonFunc.hpp:37

_MASK = (1 << 64) - 1
_SIGN = 1 << 63


def as_i64(u: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    u &= _MASK
    return u - (1 << 64) if u >= _SIGN else u


INT64_MIN = as_i64(_SIGN)
UMAX = as_i64(_MASK)         # u64 0xFFFF...FF, the "+inf"/invalid hash

_C1 = as_i64(0x87C37B91114253D5)
_C2 = as_i64(0x4CF5AD432745937F)
_F1 = as_i64(0xFF51AFD7ED558CCD)
_F2 = as_i64(0xC4CEB9FE1A85EC53)
_A1 = 0x52DCE729
_A2 = 0x38495AB5


def flip(x: torch.Tensor) -> torch.Tensor:
    """u64 bits in int64 -> int64 whose signed order is the u64 order."""
    return x ^ INT64_MIN


def _lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr(x, 64 - r)


def _fmix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _lsr(h, 33)
    h = h * _F1
    h = h ^ _lsr(h, 33)
    h = h * _F2
    h = h ^ _lsr(h, 33)
    return h


def _pack_window_word(seq: torch.Tensor, n: int, offset: int,
                      nbytes: int) -> torch.Tensor:
    """u64 word of bytes [offset, offset+nbytes) of every length-k window
    (seq is int64 bytes)."""
    w = torch.zeros(seq.shape[:-1] + (n,), dtype=torch.int64,
                    device=seq.device)
    for b in range(nbytes):
        w = w | (seq[..., offset + b: offset + b + n] << (8 * b))
    return w


def hash_kmer_windows(seq_u8: torch.Tensor, k: int,
                      seed: int = SEED) -> torch.Tensor:
    """Hash every length-k window of a byte sequence.

    Args:
      seq_u8: (..., L) uint8 ASCII bytes ('A','C','G','T','N').
      k: k-mer size.

    Returns:
      (..., L-k+1) int64 holding the u64 hash bits (window i covers
      seq[i:i+k]).
    """
    L = seq_u8.shape[-1]
    n = L - k + 1
    seq = seq_u8.to(torch.int64)
    shape = seq.shape[:-1] + (n,)
    h1 = torch.full(shape, seed, dtype=torch.int64, device=seq.device)
    h2 = torch.full(shape, seed, dtype=torch.int64, device=seq.device)

    nblocks = k // 16
    for i in range(nblocks):
        k1 = _pack_window_word(seq, n, i * 16, 8)
        k2 = _pack_window_word(seq, n, i * 16 + 8, 8)
        k1 = k1 * _C1
        k1 = _rotl64(k1, 31)
        k1 = k1 * _C2
        h1 = h1 ^ k1
        h1 = _rotl64(h1, 27)
        h1 = h1 + h2
        h1 = h1 * 5 + _A1
        k2 = k2 * _C2
        k2 = _rotl64(k2, 33)
        k2 = k2 * _C1
        h2 = h2 ^ k2
        h2 = _rotl64(h2, 31)
        h2 = h2 + h1
        h2 = h2 * 5 + _A2

    tail = k & 15
    toff = nblocks * 16
    if tail > 8:
        k2 = _pack_window_word(seq, n, toff + 8, tail - 8)
        k2 = k2 * _C2
        k2 = _rotl64(k2, 33)
        k2 = k2 * _C1
        h2 = h2 ^ k2
    if tail > 0:
        k1 = _pack_window_word(seq, n, toff, min(tail, 8))
        k1 = k1 * _C1
        k1 = _rotl64(k1, 31)
        k1 = k1 * _C2
        h1 = h1 ^ k1

    h1 = h1 ^ k
    h2 = h2 ^ k
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    return h1 + h2


# ---------------------------------------------------------------------------
# Pure-Python oracle (used by unit tests only; byte-serial, exact).
# ---------------------------------------------------------------------------


def _py_rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _MASK


def _py_fmix(h):
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _MASK
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _MASK
    h ^= h >> 33
    return h


def murmur128_low64_py(data: bytes, seed: int = SEED) -> int:
    """Byte-serial MurmurHash3_x64_128 low word; test oracle."""
    length = len(data)
    nblocks = length // 16
    h1 = h2 = seed
    c1 = 0x87C37B91114253D5
    c2 = 0x4CF5AD432745937F
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16: i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8: i * 16 + 16], "little")
        k1 = (k1 * c1) & _MASK
        k1 = _py_rotl(k1, 31)
        k1 = (k1 * c2) & _MASK
        h1 ^= k1
        h1 = _py_rotl(h1, 27)
        h1 = (h1 + h2) & _MASK
        h1 = (h1 * 5 + 0x52DCE729) & _MASK
        k2 = (k2 * c2) & _MASK
        k2 = _py_rotl(k2, 33)
        k2 = (k2 * c1) & _MASK
        h2 ^= k2
        h2 = _py_rotl(h2, 31)
        h2 = (h2 + h1) & _MASK
        h2 = (h2 * 5 + 0x38495AB5) & _MASK
    tail = data[nblocks * 16:]
    k1 = k2 = 0
    t = length & 15
    if t > 8:
        k2 = int.from_bytes(tail[8:t], "little")
        k2 = (k2 * c2) & _MASK
        k2 = _py_rotl(k2, 33)
        k2 = (k2 * c1) & _MASK
        h2 ^= k2
    if t > 0:
        k1 = int.from_bytes(tail[: min(t, 8)], "little")
        k1 = (k1 * c1) & _MASK
        k1 = _py_rotl(k1, 31)
        k1 = (k1 * c2) & _MASK
        h1 ^= k1
    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _MASK
    h2 = (h2 + h1) & _MASK
    h1 = _py_fmix(h1)
    h2 = _py_fmix(h2)
    h1 = (h1 + h2) & _MASK
    return h1
