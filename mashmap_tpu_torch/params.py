"""Run parameters and derived-parameter logic.

Mirrors the reference's ``skch::Parameters`` POD and the derived-parameter
rules that are part of the spec (reference: src/map/include/map_parameters.hpp:32-102
and src/map/include/parseCmdArgs.hpp:434-641):

- auto sketch size from the p-value model (parseCmdArgs.hpp:634-640),
- ``--dense`` sketch density formula (parseCmdArgs.hpp:626-631),
- ``block_length`` / ``chain_gap`` defaulting to ``segLength``
  (parseCmdArgs.hpp:471-489),
- no-query => self-mapping with ``skip_self`` (parseCmdArgs.hpp:326-330).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional


class _Fixed:
    """Internal constants not exposed on the CLI.

    Reference: src/map/include/map_parameters.hpp:86-102 (skch::fixed).
    """

    ss_table_max = 1000.0      # max size of the hypergeometric cutoff table
    pval_cutoff = 1e-3         # p-value cutoff for auto sketch size
    confidence_interval = 0.95  # CI to relax jaccard cutoff for mapping
    percentage_identity = 0.85
    ANIDiff = 0.0
    ANIDiffConf = 0.999
    VERSION = "3.1.3"          # reference version whose behavior we match


FIXED = _Fixed()

UINT64_MAX = (1 << 64) - 1

# filter modes (reference: src/map/include/base_types.hpp:117-122)
FILTER_MAP = 1
FILTER_ONETOONE = 2
FILTER_NONE = 3


def binary_effective_ref_size(size: int) -> int:
    """The referenceSize value the REFERENCE BINARY actually feeds its
    auto-sketch-size model — including its int32 wraparound for
    references >= 2 GiB.

    Chain in the reference: ``getReferenceSize`` returns the uint64 byte
    sum (commonFunc.hpp:591-603); it is assigned to
    ``Parameters::referenceSize`` of type ``offset_t`` = int32
    (parseCmdArgs.hpp:304, map_parameters.hpp:41, base_types.hpp:18-22
    without LARGE_CONTIG), wrapping modulo 2^32; the wrapped value is then
    converted back to ``uint64_t lengthReference`` in
    ``recommendedSketchSize``/``estimate_pvalue`` (map_stats.hpp:187,241),
    so a negative int32 becomes ~1.8e19 and the p-value loop picks a much
    larger sketch (s=40 instead of 20 on a 3.1 GB reference — verified
    against the stock binary). Mirroring this keeps our auto-selected
    operating point identical to every stock >2 GiB run; pass
    ``--exactRefSize`` for the un-wrapped (mathematically intended) value.
    """
    v32 = size & 0xFFFFFFFF
    if v32 >= 1 << 31:
        v32 -= 1 << 32          # uint64 -> int32: two's-complement wrap
    if v32 < 0:
        v32 += 1 << 64          # int32 -> uint64 conversion of a negative
    return v32


@dataclasses.dataclass
class Parameters:
    """All mapping knobs. Field names follow the reference for auditability."""

    kmer_size: int = 19
    kmer_pct_threshold: float = 0.001  # ignore top …% most frequent minmers
    seg_length: int = 5000
    block_length: Optional[int] = None       # default: seg_length
    chain_gap: Optional[int] = None           # default: seg_length
    alphabet_size: int = 4
    reference_size: int = 0                   # total bytes of the ref files
    percentage_identity: float = 0.85         # in [0,1]
    stage2_full_scan: bool = True
    stage1_topANI_filter: bool = True
    ANIDiff: float = FIXED.ANIDiff            # in [0,1]
    ANIDiffConf: float = FIXED.ANIDiffConf    # in [0,1]
    filter_mode: int = FILTER_MAP
    num_mappings_for_segment: int = 1
    num_mappings_for_short_sequence: int = 1
    ref_sequences: List[str] = dataclasses.field(default_factory=list)
    query_sequences: List[str] = dataclasses.field(default_factory=list)
    out_file_name: str = "mashmap.out"
    save_index_filename: str = ""
    load_index_filename: str = ""
    split: bool = True
    lower_triangular: bool = False
    skip_self: bool = False
    skip_prefix: bool = False
    prefix_delim: str = "\0"
    target_list: str = ""
    target_prefix: str = ""
    merge_mappings: bool = True
    keep_low_pct_id: bool = True
    report_ANI_percentage: bool = False
    filter_length_mismatches: bool = False
    kmer_complexity_threshold: float = 0.0
    sketch_size: Optional[int] = None         # None => derive (see finalize)
    dense: bool = False
    exact_ref_size: bool = False    # auto sketch size from the TRUE ref
    # size instead of mirroring the binary's int32 wrap (>= 2 GiB refs)
    sparsity_hash_threshold: int = UINT64_MAX
    legacy_output: bool = False
    threads: int = 1                          # host-side parallelism only

    # --- device-side knobs (no reference analog) ---
    # multi-process and sharded-index runs (parallel/, as the JAX
    # package's): a gloo coordinator for --numProcesses > 1, and the index
    # split across the devices with shard_index
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    shard_index: bool = False
    no_progress: bool = False       # reference always paints its meter
    # (progress.hpp:25-38); this flag is the opt-out
    batch_fragments: int = 512      # fragments per device batch
    use_device_pipeline: bool = True
    l1_postings_cap: int = 1024     # max gathered intervals per fragment
    l1_candidates_cap: int = 16     # max L1 candidate regions per fragment
    l2_entries_cap: int = 2048      # (x l2_batch = device area per call)
    l2_batch: int = 512             # L2 work items per device call

    def finalize(self) -> "Parameters":
        """Fill derived fields. Mirrors parseCmdArgs.hpp defaulting rules."""
        if self.block_length is None:
            self.block_length = self.seg_length    # parseCmdArgs.hpp:471-475
        if self.chain_gap is None:
            self.chain_gap = self.seg_length       # parseCmdArgs.hpp:487-489
        if not self.query_sequences:
            # all-vs-all self mapping mode (parseCmdArgs.hpp:326-330).
            # NOTE: the reference sets skip_self=true here but then
            # UNCONDITIONALLY overrides it from the -X flag at
            # parseCmdArgs.hpp:340-344, so no-query mode does NOT skip
            # self mappings unless -X is given — verified against the
            # reference binary (self rows appear in its output).
            self.query_sequences = list(self.ref_sequences)
        if self.reference_size == 0 and self.ref_sequences:
            self.reference_size = sum(
                os.path.getsize(f) for f in self.ref_sequences
            )  # commonFunc.hpp:591-603 (file byte size, not sequence length)
        if self.filter_mode == FILTER_NONE:
            self.stage1_topANI_filter = False      # parseCmdArgs.hpp:403-407
        if self.sketch_size is None:
            if self.dense:
                # density formula (parseCmdArgs.hpp:626-631)
                md = 1.0 - self.percentage_identity
                dens = 0.02 * (1.0 + md / 0.05)
                self.sketch_size = int(dens * (self.seg_length - self.kmer_size))
            else:
                from . import stats
                eff_size = (self.reference_size if self.exact_ref_size
                            else binary_effective_ref_size(self.reference_size))
                self.sketch_size = stats.recommended_sketch_size(
                    FIXED.pval_cutoff,
                    FIXED.confidence_interval,
                    self.kmer_size,
                    self.alphabet_size,
                    self.percentage_identity,
                    self.seg_length,
                    eff_size,
                )
        return self
