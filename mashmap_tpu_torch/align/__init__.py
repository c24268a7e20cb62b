"""Base-level alignment stage (the reference's ``mashmap-align`` binary).

Counterpart of ``mashmap_tpu/align/``: turns mashmap mappings into
base-level alignments. Per mapping row, a semi-global (free target
end-gaps) unit-cost edit-distance alignment of the query region onto the
reference region, reported as the original row plus an edit-distance
rate and a standard CIGAR (reference:
src/align/include/computeAlignments.hpp:36-301).

Exact unique k-mer anchors are chained inside each mapped region
(anchors.py), the inter-anchor gaps become many small independent banded
DP problems batched on the device (kernel.py, a hand-written CUDA
kernel), and CIGARs are stitched on the host through the exact-match
anchors (driver.py).
"""

from .driver import Aligner, align_files  # noqa: F401
