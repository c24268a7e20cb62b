"""Device compute: PyTorch ops and the hand-written CUDA theta kernel."""
