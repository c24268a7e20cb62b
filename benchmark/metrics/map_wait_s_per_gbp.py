"""Host seconds the map waits for its device steps per query Gbp (the
L1 and L2 steps, replayed as CUDA graphs): the ``l1-wait`` and
``l2-wait`` phases of the program's ``map phase`` DEBUG records, summed
over the window's units, over their query bases."""

PHASES = ("l1-wait", "l2-wait")


def read(rec):
    units = [u for u in rec["units"] if u.get("phases")]
    if not units:
        return None
    sec = sum(u["phases"].get(p, 0.0) for u in units for p in PHASES)
    return sec / (sum(u["query_bp"] for u in units) / 1e9)
