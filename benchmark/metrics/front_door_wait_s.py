"""Seconds a job the main thread waits on the front door: the
program's ``build read`` spans (each reference record pulled from the
FASTA reader) and ``map query-wait`` spans (each query pulled from the
prefetching reader), averaged over the window's jobs."""

from benchmark import spans


def read(rec):
    return spans.per_job(rec, lambda n: n in ("build read",
                                              "map query-wait"))
