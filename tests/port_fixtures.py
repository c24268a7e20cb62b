"""Module fixtures that the port's test files import by name."""

import pytest
import torch

from mashmap_tpu import native as jax_native


@pytest.fixture(scope="module", autouse=True)
def jax_native_reader():
    """Load the JAX package's native reader once, in one thread, before
    the module's first JAX run that reads FASTA: its map_files reads the
    reference while a prefetch thread reads the queries, and two first
    builds of the reader in one process race on one temporary file."""
    jax_native._load_fastaread()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work on the CPU: the
    test workers already share the cores, and several workers that each
    run a thread per core slow one another many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
