"""Seconds a job of the index build's tail after its last group
(the postings' concatenation, their stable sort, the ranks and the
frequent-seed filter): the program's ``build tail-*`` spans, averaged
over the window's jobs."""

from benchmark import spans


def read(rec):
    return spans.per_job(rec, lambda n: n.startswith("build tail-"))
