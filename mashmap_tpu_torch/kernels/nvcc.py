"""Build a CUDA source of the port into a shared library with nvcc.

Each hand-written kernel lives in a ``csrc/*.cu`` file with a plain C
interface. ``build(src, stem)`` compiles it for ``sm_90a`` into
``mashmap_tpu_torch/_build/lib<stem>_<hash>.so`` (once per source
version: the name carries a hash of the source, so an edited source
never loads a stale build) and keeps nvcc's ``-Xptxas -v`` report
(registers, spills and shared memory of each kernel instance) beside it.
The caller loads the library with ctypes. Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    return "nvcc"


def ptxas_log_path(src: str, stem: str) -> str:
    """Where ``build`` keeps the ptxas report of this source version."""
    with open(src, "rb") as fh:
        tag = hashlib.sha1(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{stem}_{tag}.ptxas.txt")


def build(src: str, stem: str) -> str:
    """Compile ``src`` unless this version is built; return the .so path.
    Raises RuntimeError with nvcc's output when the build fails."""
    log = ptxas_log_path(src, stem)
    so = log[:-len(".ptxas.txt")] + ".so"
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        res = subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
             "-Xcompiler", "-fPIC", "-o", tmp, src],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
        with open(log, "w") as fh:
            fh.write(res.stderr)
        os.replace(tmp, so)
    return so
