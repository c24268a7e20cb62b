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
import queue
import threading
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

    Uses the native C++ parser (mashmap_tpu_torch.native, the
    kseq/gzstream equivalent — sequences arrive pre-sanitized, which
    every caller applies idempotently anyway) when it is buildable, else
    the pure-Python parser below.
    """
    keep_seq = keep_seq or set()

    def _keep(name: str) -> bool:
        return ((not keep_prefix or name.startswith(keep_prefix))
                and (not keep_seq or name in keep_seq))

    from .. import native
    if native.native_available():
        for name, seq in native.read_records(filename):
            yield name, (seq if _keep(name) else "")
        return

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


class PrefetchReader:
    """Background query-stream reader.

    Starts reading (and decompressing) query files on a worker thread
    the moment it is constructed, so the host I/O overlaps the index
    build (the reference overlaps I/O and compute with its thread pool,
    computeMap.hpp:607-637). The queue is bounded both by item count and
    by BUFFERED BASES (chromosome-scale contigs would otherwise park tens
    of GB behind a count-only bound): the producer blocks once
    ``max_bytes`` of sequence is in flight, so memory stays
    O(max_bytes + one contig). Items arrive in exact file order, so
    consumers see the same stream as ``for_each_seq_in_file`` over each
    file in turn. The thread is not a daemon: a consumer that stops
    early calls ``close()``.
    """

    def __init__(self, files, maxsize: int = 256,
                 max_bytes: int = 256 * 1024 * 1024):
        self._q = queue.Queue(maxsize=maxsize)
        self._stop = threading.Event()
        self._files = list(files)
        self._buffered = 0                    # bases currently queued
        self._cond = threading.Condition()    # guards _buffered
        self._max_bytes = int(max_bytes)
        self._t = threading.Thread(target=self._fill, daemon=False)
        self._t.start()

    def _fill(self):
        try:
            for fname in self._files:
                for name, seq in for_each_seq_in_file(fname):
                    with self._cond:
                        # admit at least one item however large, so a
                        # single contig above the budget still flows
                        while (self._buffered > 0
                               and self._buffered + len(seq)
                               > self._max_bytes
                               and not self._stop.is_set()):
                            self._cond.wait(timeout=0.5)
                        if self._stop.is_set():
                            return
                        self._buffered += len(seq)
                    self._q.put((name, seq))
            self._q.put(None)
        except BaseException as e:   # surfaced on the consumer side
            self._q.put(e)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            with self._cond:
                self._buffered -= len(item[1])
                self._cond.notify()
            yield item
        self._t.join()

    def close(self):
        """Abandon the stream (error paths): unblock + join the thread."""
        self._stop.set()
        while self._t.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._t.join()

