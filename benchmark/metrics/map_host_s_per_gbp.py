"""Host seconds of the map's own phases per query Gbp: the program's
``map phase`` DEBUG records (``Mapper.phase_s``) other than the waits
for the device, summed over the window's units, over their query
bases."""

PHASES = ("l1-tables", "l1-dispatch", "l1-fetch", "l2-dispatch",
          "l2-fetch", "post")


def read(rec):
    units = [u for u in rec["units"] if u.get("phases")]
    if not units:
        return None
    sec = sum(u["phases"].get(p, 0.0) for u in units for p in PHASES)
    return sec / (sum(u["query_bp"] for u in units) / 1e9)
