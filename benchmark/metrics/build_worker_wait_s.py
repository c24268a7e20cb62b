"""Seconds a job the index build's main thread waits on its worker
(``fut.result()`` in ``build_index``'s ``flush_pending``): the program's
``build worker-wait`` span, averaged over the window's jobs."""

from benchmark import spans


def read(rec):
    return spans.per_job(rec, lambda n: n == "build worker-wait")
