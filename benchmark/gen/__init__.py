"""Sequence generators of the benchmark's configurations, seeded."""
