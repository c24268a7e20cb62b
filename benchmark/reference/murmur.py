"""Canonical k-mer hashes as MashMap computes them, in plain PyTorch.

MurmurHash3_x64_128 with seed 42, low 64 bits, of the k ASCII bytes of a
k-mer and of its reverse complement; the canonical hash is the smaller
(unsigned) of the two, its strand forward where the forward hash is the
smaller; a k-mer whose two hashes are equal, or that holds a byte other
than A, C, G, T, is not valid. The u64 bits live in int64 (wrapping
multiplication and addition are the same bits); ``ukey`` maps them to
an int64 whose signed order is the unsigned order.
"""

from __future__ import annotations

import torch

SEED = 42
_M = (1 << 64) - 1


def _i64(u: int) -> int:
    u &= _M
    return u - (1 << 64) if u >> 63 else u


C1 = _i64(0x87C37B91114253D5)
C2 = _i64(0x4CF5AD432745937F)
F1 = _i64(0xFF51AFD7ED558CCD)
F2 = _i64(0xC4CEB9FE1A85EC53)
SIGN = _i64(1 << 63)


def ukey(h: torch.Tensor) -> torch.Tensor:
    return h ^ SIGN


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = (h ^ _shr(h, 33)) * F1
    h = (h ^ _shr(h, 33)) * F2
    return h ^ _shr(h, 33)


def _word(seq: torch.Tensor, n: int, off: int, nbytes: int) -> torch.Tensor:
    w = torch.zeros(seq.shape[:-1] + (n,), dtype=torch.int64,
                    device=seq.device)
    for b in range(nbytes):
        w |= seq[..., off + b: off + b + n] << (8 * b)
    return w


def murmur_windows(seq_u8: torch.Tensor, k: int) -> torch.Tensor:
    """MurmurHash3_x64_128 low word of every length-k window of the last
    axis of ``seq_u8`` (uint8 bytes): shape (..., L - k + 1)."""
    n = seq_u8.shape[-1] - k + 1
    seq = seq_u8.to(torch.int64)
    h1 = torch.full(seq.shape[:-1] + (n,), SEED, dtype=torch.int64,
                    device=seq.device)
    h2 = h1.clone()
    for i in range(k // 16):
        k1 = _rotl(_word(seq, n, 16 * i, 8) * C1, 31) * C2
        h1 = (_rotl(h1 ^ k1, 27) + h2) * 5 + 0x52DCE729
        k2 = _rotl(_word(seq, n, 16 * i + 8, 8) * C2, 33) * C1
        h2 = (_rotl(h2 ^ k2, 31) + h1) * 5 + 0x38495AB5
    tail, off = k & 15, 16 * (k // 16)
    if tail > 8:
        h2 = h2 ^ (_rotl(_word(seq, n, off + 8, tail - 8) * C2, 33) * C1)
    if tail:
        h1 = h1 ^ (_rotl(_word(seq, n, off, min(tail, 8)) * C1, 31) * C2)
    h1 = h1 ^ k
    h2 = h2 ^ k
    h1 = h1 + h2
    h2 = h2 + h1
    return _fmix(h1) + _fmix(h2)


_COMP = torch.full((256,), ord("N"), dtype=torch.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b


def canonical(seq_u8: torch.Tensor, k: int):
    """(hash, forward strand, valid) of every k-mer of ``seq_u8``
    (..., L): int64 u64 bits, bool, bool, each (..., L - k + 1)."""
    fwd = murmur_windows(seq_u8, k)
    rc = _COMP.to(seq_u8.device)[seq_u8.long()].flip(-1)
    bwd = murmur_windows(rc, k).flip(-1)
    bad = (seq_u8 != ord("A")) & (seq_u8 != ord("C")) \
        & (seq_u8 != ord("G")) & (seq_u8 != ord("T"))
    cb = torch.cumsum(bad.to(torch.int32), -1)
    cb = torch.cat([torch.zeros_like(cb[..., :1]), cb], -1)
    has_bad = (cb[..., k:] - cb[..., :-k]) > 0
    fwd_smaller = ukey(fwd) < ukey(bwd)
    h = torch.where(fwd_smaller, fwd, bwd)
    return h, fwd_smaller, (fwd != bwd) & ~has_bad
