"""Seconds a job of the index build's device classify (pairing, strand
classification, chunking, row sort and u64 resolution of each device
group's membership events, ``classify_group``): the program's ``build
classify`` span, averaged over the window's jobs."""

from benchmark import spans


def read(rec):
    return spans.per_job(rec, lambda n: n == "build classify")
