"""FASTA writing of generated sequences (80 columns, as the generators'
originals write them)."""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

WIDTH = 80
NEWLINE = np.uint8(ord("\n"))
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def record_bytes(name: str, n: int) -> int:
    """Bytes of one record as ``write_fasta`` writes it."""
    return len(name) + 2 + n + -(-n // WIDTH)


def _record(name: str, seq: np.ndarray) -> bytes:
    n = len(seq)
    pad = (-n) % WIDTH
    if pad:
        seq = np.concatenate([seq, np.zeros(pad, np.uint8)])
    rows = seq.reshape(-1, WIDTH)
    out = np.empty((rows.shape[0], WIDTH + 1), np.uint8)
    out[:, :WIDTH] = rows
    out[:, WIDTH] = NEWLINE
    body = out.tobytes()
    if pad:
        body = body[:-(pad + 1)] + b"\n"
    return f">{name}\n".encode() + body


def write_fasta(path: str, records: Iterable[Tuple[str, np.ndarray]]) -> int:
    """Write (name, ASCII uint8 array) records; returns the bytes
    written."""
    total = 0
    with open(path, "wb") as fh:
        for name, seq in records:
            b = _record(name, seq)
            fh.write(b)
            total += len(b)
    return total
