"""Multi-device and multi-process runs of the port.

``mesh.py``: the list of devices a Mapper spreads its batches over (data
parallelism, the index replicated on each distinct device).
``sharded_index.py``: the index split by hash range (postings) and row
range (interval table) over those devices, and the L1/L2 steps over the
shards. ``distributed.py``: processes that each map a strided share of
the queries and meet at barriers, then merge their part files.
"""
