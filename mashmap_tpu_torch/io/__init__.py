"""Host-side sequence I/O."""

from .fasta import for_each_seq_in_file, read_all_seqs, \
    total_seq_stats  # noqa: F401
