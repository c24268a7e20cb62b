"""The program's span totals of the window's jobs, for the per-layer
metrics that read them: each ``map_files`` call leaves its totals (span
name -> (seconds, count)) in ``mashmap_tpu_torch.trace.JOBS``, and the
window's units are the last jobs of the run."""


def job_totals(rec):
    """The totals of each of the window's jobs, or None where the
    program keeps none (a program without ``trace.py``, or fewer jobs
    than the window has units)."""
    units = rec.get("units") or []
    if not units:
        return None
    try:
        from mashmap_tpu_torch import trace
    except ImportError:
        return None
    jobs = list(trace.JOBS)[-len(units):]
    return [t for _, t in jobs] if len(jobs) == len(units) else None


def seconds(rec, match):
    """The seconds a job of the spans whose names ``match`` accepts,
    summed over the window's jobs: (sum, number of jobs), or None where
    no job has such a span."""
    jobs = job_totals(rec)
    if not jobs:
        return None
    got = [s for t in jobs for n, (s, _) in t.items() if match(n)]
    return (sum(got), len(jobs)) if got else None


def per_job(rec, match):
    """``seconds`` averaged over the window's jobs."""
    got = seconds(rec, match)
    return None if got is None else got[0] / got[1]


def per_gbp(rec, match):
    """``seconds`` over the window's query Gbp."""
    got = seconds(rec, match)
    if got is None:
        return None
    return got[0] / (sum(u["query_bp"] for u in rec["units"]) / 1e9)
