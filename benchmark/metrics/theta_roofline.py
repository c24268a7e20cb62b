"""theta.cu's share of its roofline in the traced unit, in percent: the
least time its launches could take (each launch's (C, S_B) int32 rows
cur and nxt read once and theta written once, over the card's 3.35 TB/s;
``devtrace.theta_bound_s``) over the device time of its two kernels in
the trace."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("theta_calls") or t["theta_s"] <= 0:
        return None
    return 100.0 * t["theta_bound_s"] / t["theta_s"]
