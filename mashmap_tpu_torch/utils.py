"""Small host utilities.

``handy_parameter`` mirrors the reference's numeric-suffix parser
(reference: src/common/utils.cpp:9-31): accepts "5000", "5k"/"5K",
"1m"/"1M", "2g"/"2G" (decimal multipliers), returns -1 on junk the
same way the reference's strtod-based parser yields <= 0 for garbage.
"""

from __future__ import annotations


def handy_parameter(value: str) -> int:
    """Parse a number with optional k/m/g suffix into an int.

    Reference semantics (utils.cpp:9-31): the numeric prefix is parsed
    as a double, then scaled by 1e3/1e6/1e9 if the remainder starts
    with k/K, m/M, or g/G.
    """
    s = value.strip()
    if not s:
        return -1
    num = ""
    i = 0
    while i < len(s) and (s[i].isdigit() or s[i] in ".+-eE"):
        num += s[i]
        i += 1
    try:
        x = float(num)
    except ValueError:
        return -1
    rest = s[i:].strip()
    if rest[:1] in ("k", "K"):
        x *= 1e3
    elif rest[:1] in ("m", "M"):
        x *= 1e6
    elif rest[:1] in ("g", "G"):
        x *= 1e9
    return int(x)


def resolve_device(device=None):
    """The torch device an entry point runs on: CUDA unless the caller
    names another (the tests pass ``"cpu"``). Raises when CUDA is asked
    for (or defaulted to) and absent, instead of running on the CPU."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mashmap_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    return dev
