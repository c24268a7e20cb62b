"""Seconds of the index build a job: the program's own INFO record
``reference index built in``, averaged over the window's jobs."""


def read(rec):
    got = [u["build_s"] for u in rec["units"] if u.get("build_s") is not None]
    return sum(got) / len(got) if got else None
