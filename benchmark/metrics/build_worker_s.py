"""Seconds a job of the index build's worker thread: the build's group
phases that ran on it (``index.builder.WORKER_PHASES`` in
``GROUP_PHASE_S``), summed over groups, averaged over the window's
jobs."""


def read(rec):
    got = [u["worker_s"] for u in rec["units"]
           if u.get("worker_s") is not None]
    return sum(got) / len(got) if got else None
