"""Mapping engine: L1 candidate regions, L2 sliding Jaccard, filtering."""
