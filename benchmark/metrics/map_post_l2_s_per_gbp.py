"""Host seconds per query Gbp of the L2 stage inside the map's ``post``
phase: the program's ``post-l2`` total (the summed seconds of
``_post_batch``'s ``_do_l2`` calls), summed over the window's jobs, over
their query bases."""

from benchmark import spans


def read(rec):
    return spans.per_gbp(rec, lambda n: n == "post-l2")
