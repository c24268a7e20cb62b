"""mashmap-tpu on PyTorch and CUDA: the approximate genome mapper
(MashMap3-compatible) with its index build and mapping on an NVIDIA GPU.

A port of the JAX package ``mashmap_tpu`` (the reference it is held
against, bit for bit): k-mer hashing, the sliding bottom-s threshold
(theta) of reference winnowing as a hand-written CUDA kernel
(kernels/csrc/theta.cu), membership events, L1 candidate regions and L2
sliding Jaccard as PyTorch ops, and the host-side chaining, filtering
and PAF output. Entry points run on ``torch.device("cuda")`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .params import Parameters, FIXED  # noqa: E402,F401


def map_files(params, index=None, device=None, devices=None):
    """Library entry point: build/load the index and map the queries.

    See api.map_files; imported lazily so `import mashmap_tpu_torch`
    stays cheap."""
    from .api import map_files as _mf
    return _mf(params, index, device=device, devices=devices)


def build_or_load_index(params, device=None):
    """See api.build_or_load_index (imported lazily)."""
    from .api import build_or_load_index as _b
    return _b(params, device)
