"""PAF / legacy output writer (reference: Map::reportReadMappings,
computeMap.hpp:1758-1805)."""

from __future__ import annotations

import math
from typing import IO, List, Sequence

from .results import MappingResult


def _cpp_float(x: float) -> str:
    """Format like C++ ostream default (6 significant digits)."""
    return f"{x:.6g}"


def cpp_round(x: float) -> int:
    """std::round: half away from zero (Python round() is banker's)."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def write_mappings(
    out: IO[str],
    mappings: List[MappingResult],
    query_name_of,
    ref_names: Sequence[str],
    ref_lengths,
    legacy_output: bool = False,
    merge_mappings: bool = True,
    report_ani_percentage: bool = False,
) -> None:
    """Emit one line per mapping.

    PAF-style columns: qName qLen qStart qEnd strand tName tLen tStart
    tEnd conservedSketches blockLength mapq id:f:.. kc:f:.. [jc:f:..].
    """
    sep = " " if legacy_output else "\t"
    for m in mappings:
        if m.nuc_identity == 1:
            mapq = 255
        else:
            mapq = cpp_round(-10.0 * math.log10(1 - m.nuc_identity))
        fields = [
            query_name_of(m),
            str(m.query_len),
            str(m.query_start),
            str(m.query_end - (1 if legacy_output else 0)),
            "+" if m.strand == 1 else "-",
            ref_names[m.ref_seq_id],
            str(int(ref_lengths[m.ref_seq_id])),
            str(m.ref_start),
            str(m.ref_end - (1 if legacy_output else 0)),
        ]
        if not legacy_output:
            fields += [
                str(m.conserved_sketches),
                str(m.block_length),
                str(int(mapq)),
                "id:f:" + _cpp_float(
                    (100.0 if report_ani_percentage else 1.0)
                    * m.nuc_identity),
                "kc:f:" + _cpp_float(m.kmer_complexity),
            ]
            if not merge_mappings:
                fields.append(
                    "jc:f:" + _cpp_float(
                        float(m.conserved_sketches) / m.sketch_size))
        else:
            fields.append(_cpp_float(m.nuc_identity * 100.0))
        out.write(sep.join(fields))
        out.write("\n")
