"""Mapping result record (reference: MappingResult, base_types.hpp:154-206)."""

from __future__ import annotations

import dataclasses

import numpy as np

_M64 = (1 << 64) - 1
_MUL = ((0xC6A4A793 << 32) + 0x5BD1E995) & _M64


def _shift_mix(v: int) -> int:
    return v ^ (v >> 47)


def _libstdcxx_hash_bytes(data: bytes, seed: int = 0xC70F6907) -> int:
    """libstdc++ std::_Hash_bytes (Murmur2-style, 64-bit size_t).

    Needed because the reference subsamples mappings by
    ``std::hash``-combined row hashes (base_types.hpp:145-204); this
    reproduces the exact values the oracle binary computes.
    """
    h = (seed ^ ((len(data) * _MUL) & _M64)) & _M64
    la = len(data) & ~7
    for i in range(0, la, 8):
        d = int.from_bytes(data[i:i + 8], "little")
        d = (_shift_mix((d * _MUL) & _M64) * _MUL) & _M64
        h = ((h ^ d) * _MUL) & _M64
    if len(data) & 7:
        d = 0
        for b in reversed(data[la:]):
            d = ((d << 8) + b) & _M64
        h = ((h ^ d) * _MUL) & _M64
    h = (_shift_mix(h) * _MUL) & _M64
    return _shift_mix(h)


def _std_hash_int(v: int) -> int:
    """std::hash<integral> on libstdc++: static_cast<size_t> (sign-extends)."""
    return v & _M64


def _std_hash_float(x: float) -> int:
    f = np.float32(x)
    if f == np.float32(0.0):
        return 0        # libstdc++ special-cases +-0.0
    return _libstdcxx_hash_bytes(f.tobytes())


@dataclasses.dataclass
class MappingResult:
    query_len: int = 0
    ref_start: int = 0
    ref_end: int = 0
    query_start: int = 0
    query_end: int = 0
    ref_seq_id: int = 0
    query_seq_id: int = 0
    block_length: int = 0
    nuc_identity: float = 0.0          # [0,1]
    nuc_identity_ub: float = 0.0
    sketch_size: int = 0
    conserved_sketches: int = 0
    strand: int = 1                    # +1 / -1
    approx_matches: int = 0
    kmer_complexity: float = 0.0
    n_merged: int = 1
    split_mapping_id: int = 0
    discard: int = 0
    self_map_filter: bool = False

    def qlen(self) -> int:
        return self.query_end - self.query_start + 1

    def rlen(self) -> int:
        return self.ref_end - self.ref_start + 1

    def stable_hash(self) -> int:
        """MappingResult::hash() (base_types.hpp:187-204), bit-exact.

        boost-style hash_combine over the fields in declaration order,
        with libstdc++'s std::hash semantics (identity for integrals
        with sign extension, _Hash_bytes for floats) — so the
        --sparsifyMappings subsample selects exactly the rows the
        reference binary selects.
        """
        res = 0

        def comb(res: int, h: int) -> int:
            return res ^ ((h + 0x9E3779B9 + ((res << 6) & _M64)
                           + (res >> 2)) & _M64)

        for v in (self.query_len, self.ref_start, self.ref_end,
                  self.query_start, self.query_end, self.ref_seq_id,
                  self.query_seq_id, self.block_length):
            res = comb(res, _std_hash_int(int(v)))
        res = comb(res, _std_hash_float(self.nuc_identity))
        res = comb(res, _std_hash_float(self.nuc_identity_ub))
        for v in (self.sketch_size, self.conserved_sketches,
                  self.strand, self.approx_matches):
            res = comb(res, _std_hash_int(int(v)))
        return res
