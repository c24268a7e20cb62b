"""The plain reference that decides ``correct``: plain NumPy and PyTorch.

It imports nothing of the program under test (mashmap_tpu_torch) or of
the JAX package; it works its answers out from the generated sequences.
"""
