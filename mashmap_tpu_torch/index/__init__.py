"""Reference index: sorted-array / CSR structures built on the device."""

from .builder import ReferenceIndex, build_index  # noqa: F401
