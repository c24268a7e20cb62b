"""Native (C++) host reader, loaded via ctypes.

Counterpart of ``mashmap_tpu/native/``: the reference's kseq FASTA parser
and gzstream as one small C++ file (``fastaread.cpp``, the port's own
copy), compiled with the system toolchain at first use into the port's
build directory (``mashmap_tpu_torch/_build/``) and loaded through the C
ABI. Without a compiler or zlib the build fails, a warning is logged and
``io.fasta`` reads with its pure-Python parser instead; this is a host
reader, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Iterator, Optional, Tuple

logger = logging.getLogger("mashmap_tpu_torch.native")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastaread.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_FAILED = object()
_lib = None
_LOCK = threading.Lock()   # the reader thread and the index build race


def _build(src: str, out: str) -> bool:
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", out,
           "-lz"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:  # no compiler
        logger.warning("native reader build unavailable: %s", e)
        return False
    if r.returncode != 0:
        logger.warning("native reader build failed: %s", r.stderr[-800:])
        return False
    return True


def _load_fastaread() -> Optional[ctypes.CDLL]:
    """Build (once per source version) and load the reader; None, after
    one warning, when it cannot be built or loaded."""
    with _LOCK:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is _FAILED:
        return None
    if _lib is not None:
        return _lib
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(_BUILD, f"libfastaread-{tag}.so")
    if not os.path.exists(out):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = out + f".tmp{os.getpid()}"
        if not _build(_SRC, tmp):
            _lib = _FAILED
            return None
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(out)
    except OSError as e:
        logger.warning("native reader load failed: %s", e)
        _lib = _FAILED
        return None
    lib.fr_open.restype = ctypes.c_void_p
    lib.fr_open.argtypes = [ctypes.c_char_p]
    lib.fr_next.restype = ctypes.c_int
    lib.fr_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long)]
    lib.fr_close.restype = None
    lib.fr_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_fastaread() is not None


def read_records(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, sanitized_sequence) via the native parser.

    Raises ValueError on malformed input; RuntimeError when the native
    library is unavailable.
    """
    lib = _load_fastaread()
    if lib is None:
        raise RuntimeError("native fastaread unavailable")
    h = lib.fr_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    name_p = ctypes.c_char_p()
    name_n = ctypes.c_long()
    seq_p = ctypes.c_char_p()
    seq_n = ctypes.c_long()
    try:
        while True:
            rc = lib.fr_next(h, ctypes.byref(name_p), ctypes.byref(name_n),
                             ctypes.byref(seq_p), ctypes.byref(seq_n))
            if rc == 0:
                return
            if rc < 0:
                raise ValueError(
                    f"unknown file format for {path!r} (not FASTA/FASTQ)")
            name = ctypes.string_at(name_p, name_n.value).decode("ascii")
            seq = ctypes.string_at(seq_p, seq_n.value).decode("ascii")
            yield name, seq
    finally:
        lib.fr_close(h)
