"""The device's idle share of the traced unit: one less the union of
the device operations' intervals (kernels, copies, sets; overlapping
ones once) over the traced window, from the torch.profiler trace."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
