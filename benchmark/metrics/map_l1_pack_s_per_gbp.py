"""Host seconds per query Gbp of packing each map batch's query rows and
allowed targets for the L1 step: the program's ``l1-pack`` spans (inside
the ``l1-dispatch`` phase), summed over the window's jobs, over their
query bases."""

from benchmark import spans


def read(rec):
    return spans.per_gbp(rec, lambda n: n == "l1-pack")
