"""Host seconds per query Gbp of the map's output: the program's
``map finalize`` spans (each query's merge and filters, then its PAF
rows written), summed over the window's jobs, over their query bases."""

from benchmark import spans


def read(rec):
    return spans.per_gbp(rec, lambda n: n == "map finalize")
