"""``mashmap-tpu-torch-align`` CLI — the reference's second binary.

Counterpart of ``mashmap_tpu/align/cli.py``, with the same flags and
messages. Option surface mirrors src/align/include/parseCmdArgs.hpp:27-60:
-s/--subject (+ --subjectList), -q/--query (+ --queryList), --mappingFile
(required), --pi/--perc_identity (required), -t/--threads, -o/--output.

    python -m mashmap_tpu_torch.align.cli -s ref.fa -q q.fa \
        --mappingFile map.out --pi 80 -o out.aln

runs on the CUDA device; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mashmap-tpu-torch-align",
        description="Post-process mashmap output to compute base-level "
                    "alignments (CIGARs). Provide the same reference and "
                    "query files that produced the mapping boundaries.")
    p.add_argument("-s", "--subject",
                   help="an input reference file (fasta/fastq)[.gz]")
    p.add_argument("--sl", "--subjectList", dest="subjectList",
                   help="file containing list of reference files")
    p.add_argument("-q", "--query", help="an input query file")
    p.add_argument("--ql", "--queryList", dest="queryList",
                   help="file containing list of query files")
    p.add_argument("--mappingFile", required=True,
                   help="mashmap output file with mapping boundaries")
    p.add_argument("--pi", "--perc_identity", dest="perc_identity",
                   type=float, required=True,
                   help="alignment identity threshold [0-100]; 0 disables "
                        "the edit-distance bound")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="host worker threads (accepted for option "
                        "compatibility; batching happens on the device)")
    p.add_argument("-o", "--output", default="mashmap.out.sam",
                   help="output file [default: mashmap.out.sam]")
    return p


def main(argv=None, device=None) -> int:
    """Parse argv (default: sys.argv[1:]) and align on ``device``
    (default CUDA; raises without a card unless the caller passes
    "cpu")."""
    a = build_parser().parse_args(argv)
    if a.subject:
        refs = [a.subject]
    elif a.subjectList:
        refs = [line.strip() for line in open(a.subjectList)
                if line.strip()]
    else:
        print("ERROR: provide reference file(s) with -s/--sl",
              file=sys.stderr)
        return 1
    if a.query:
        queries = [a.query]
    elif a.queryList:
        queries = [line.strip() for line in open(a.queryList)
                   if line.strip()]
    else:
        print("ERROR: provide query file(s) with -q/--ql", file=sys.stderr)
        return 1
    if not (0 <= a.perc_identity <= 100):
        print("ERROR: --pi must be in [0, 100]", file=sys.stderr)
        return 1
    from .driver import align_files
    align_files(refs, queries, a.mappingFile, a.perc_identity, a.output,
                device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
