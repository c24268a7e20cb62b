"""Seconds a job of the map's set-up: the program's ``map setup`` span
(``Mapper.__init__``: the cutoff table, the reference groups) and the
``tables-host`` and ``tables-upload`` spans inside the first
``l1-tables`` phase (the lookup tables made on the host and uploaded),
averaged over the window's jobs."""

from benchmark import spans


def read(rec):
    return spans.per_job(rec, lambda n: n in ("map setup", "tables-host",
                                              "tables-upload"))
