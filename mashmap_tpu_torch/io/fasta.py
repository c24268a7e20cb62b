"""FASTA/FASTQ(.gz) streaming reader.

Behavioral contract follows the reference's seqiter
(reference: src/common/seqiter.hpp:20-112):

- format autodetected from the first byte ('>' fasta, '@' fastq);
- sequence name = header text up to the first space;
- with a keep-set / keep-prefix, non-kept sequences are still *yielded*
  with an empty sequence string (the reference calls the callback with ""),
  so sequence counters stay aligned with file order;
- gzip handled transparently (extension-independent: magic-byte sniff).
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterable, Iterator, Optional, Set, Tuple


def _open_text(filename: str) -> io.TextIOBase:
    f = open(filename, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="ascii")
    return io.TextIOWrapper(f, encoding="ascii")


def for_each_seq_in_file(
    filename: str,
    keep_seq: Optional[Set[str]] = None,
    keep_prefix: str = "",
) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) for every record, in file order.

    Non-kept records yield (name, "") — mirroring seqiter.hpp:84-96 so that
    downstream sequence counters match the reference exactly.
    """
    keep_seq = keep_seq or set()

    def _keep(name: str) -> bool:
        return ((not keep_prefix or name.startswith(keep_prefix))
                and (not keep_seq or name in keep_seq))

    with _open_text(filename) as fh:
        first = fh.readline()
        if not first:
            return
        if first.startswith(">"):
            name = first[1:].rstrip("\n").split(" ")[0]
            chunks = []
            keep = _keep(name)
            for line in fh:
                if line.startswith(">"):
                    yield name, "".join(chunks) if keep else ""
                    name = line[1:].rstrip("\n").split(" ")[0]
                    chunks = []
                    keep = _keep(name)
                else:
                    if keep:
                        chunks.append(line.rstrip("\n"))
            yield name, "".join(chunks) if keep else ""
        elif first.startswith("@"):
            line = first
            while line:
                name = line[1:].rstrip("\n").split(" ")[0]
                seq = fh.readline().rstrip("\n")
                fh.readline()   # '+'
                fh.readline()   # quality
                yield name, seq if _keep(name) else ""
                line = fh.readline()
        else:
            raise ValueError(
                f"unknown file format for {filename!r} (not FASTA/FASTQ)")


def read_all_seqs(filename: str) -> list[tuple[str, str]]:
    return list(for_each_seq_in_file(filename))


def total_seq_stats(filenames: Iterable[str]) -> tuple[int, int]:
    """(total sequences, total bp), using .fai when present.

    Reference: computeMap.hpp:279-304 (progress-meter sizing).
    """
    total_seqs = 0
    total_bp = 0
    for filename in filenames:
        fai = filename + ".fai"
        if os.path.exists(fai):
            with open(fai) as fh:
                for line in fh:
                    total_seqs += 1
                    total_bp += int(line.split("\t")[1])
        else:
            for _, seq in for_each_seq_in_file(filename):
                total_seqs += 1
                total_bp += len(seq)
    return total_seqs, total_bp

