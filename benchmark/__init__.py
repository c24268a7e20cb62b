"""Benchmark of mashmap_tpu_torch on one CUDA card: run.py is its entry."""
