"""Command-line interface, option-compatible with the reference mashmap.

Counterpart of ``mashmap_tpu/cli.py``, with the same flags, option
strings, defaults and validation messages (reference:
src/map/include/parseCmdArgs.hpp:30-135 for the options, :257-659 for
parsing and derivation), the runtime flags included: ``--shardIndex``
splits the index across the devices, ``--coordinator``,
``--numProcesses`` and ``--processId`` make the run one process of a
multi-process run (parallel/distributed.py).

    python -m mashmap_tpu_torch.cli -r ref.fa -q q.fa -o out.paf

runs on every visible CUDA device; ``main(argv, device="cpu")`` runs on
the CPU, and ``main(argv, devices=[...])`` on a list of devices, which
may repeat (parallel/mesh.py).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from .params import Parameters, FIXED, FILTER_MAP, FILTER_NONE, \
    FILTER_ONETOONE
from .utils import handy_parameter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mashmap-tpu-torch",
        description="Approximate long-read / contig mapper "
                    "(MashMap3-compatible) on PyTorch and CUDA",
    )
    p.add_argument("-v", "--version", action="store_true",
                   help="print version")
    p.add_argument("-r", "--ref", help="input reference file "
                   "(fasta/fastq)[.gz]")
    p.add_argument("--rl", "--refList", dest="refList",
                   help="file containing list of reference files")
    p.add_argument("-q", "--query", help="input query file")
    p.add_argument("--ql", "--queryList", dest="queryList",
                   help="file containing list of query files")
    p.add_argument("-s", "--segLength", type=handy_parameter, default=5000,
                   help="mapping segment length, accepts k/M/G suffixes "
                        "[default: 5,000]")
    p.add_argument("-J", "--sketchSize", type=int, default=None,
                   help="number of sketch elements")
    p.add_argument("--dense", action="store_true",
                   help="use dense sketching for higher ANI accuracy")
    p.add_argument("--exactRefSize", action="store_true",
                   help="derive the auto sketch size from the true "
                        "reference size; by default the reference binary's "
                        "int32 referenceSize wraparound (affects refs >= "
                        "2 GiB) is mirrored for output parity")
    p.add_argument("-l", "--blockLength", type=handy_parameter,
                   default=None,
                   help="keep merged mappings of at least this length "
                        "(k/M/G suffixes ok)")
    p.add_argument("-c", "--chainGap", type=handy_parameter, default=None,
                   help="chain mappings closer than this distance "
                        "(k/M/G suffixes ok)")
    p.add_argument("-n", "--numMappingsForSegment", type=int, default=1,
                   help="mappings to retain per segment [default: 1]")
    p.add_argument("--numMappingsForShortSeq", type=int, default=1,
                   help="mappings per sequence shorter than segment length")
    p.add_argument("--saveIndex", default="",
                   help="index file to save (npz)")
    p.add_argument("--loadIndex", default="",
                   help="index file to load (npz)")
    p.add_argument("--noSplit", action="store_true",
                   help="disable query splitting")
    p.add_argument("--pi", "--perc_identity", dest="perc_identity",
                   type=float, default=85.0,
                   help="identity threshold [default: 85]")
    p.add_argument("-K", "--dropLowMapId", action="store_true",
                   help="drop mappings below the identity threshold")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="host-side worker threads")
    p.add_argument("-o", "--output", default="mashmap.out",
                   help="output file [default: mashmap.out]")
    p.add_argument("-k", "--kmer", type=int, default=19,
                   help="kmer size [default: 19]")
    p.add_argument("--kmerThreshold", type=float, default=0.001,
                   help="ignore the top %% most-frequent minmers")
    p.add_argument("--kmerComplexity", type=float, default=0.0,
                   help="kmer complexity threshold [0,1]")
    p.add_argument("--noHgFilter", action="store_true",
                   help="disable the stage-1 hypergeometric filter")
    p.add_argument("--hgFilterAniDiff", type=float, default=0.0,
                   help="stage-1 ANI difference tolerance [default: 0]")
    p.add_argument("--hgFilterConf", type=float, default=99.9,
                   help="stage-1 filter confidence [default: 99.9]")
    p.add_argument("--filterLengthMismatches", action="store_true")
    p.add_argument("--lowerTriangular", action="store_true",
                   help="only map sequence i to j if i > j")
    p.add_argument("-X", "--skipSelf", action="store_true",
                   help="skip self mappings (all-vs-all mode)")
    p.add_argument("-Y", "--skipPrefix", default=None, metavar="C",
                   help="skip mappings when query/target share the prefix "
                        "before the last occurrence of C")
    p.add_argument("--targetPrefix", default="",
                   help="only index references with this prefix")
    p.add_argument("--targetList", default="",
                   help="file listing target sequence names")
    p.add_argument("-x", "--sparsifyMappings", type=float, default=1.0,
                   help="keep this fraction of mappings")
    p.add_argument("-M", "--noMerge", action="store_true",
                   help="don't merge consecutive segment mappings")
    p.add_argument("-f", "--filter_mode", default="map",
                   choices=["map", "one-to-one", "none"])
    p.add_argument("--legacy", action="store_true",
                   help="legacy MashMap2 output format")
    p.add_argument("--reportPercentage", action="store_true",
                   help="report ANI in [0,100] (for wfmash)")
    # device runtime knobs
    p.add_argument("--noDevicePipeline", action="store_true",
                   help="run L1/L2 on the host instead of the device")
    p.add_argument("--shardIndex", action="store_true",
                   help="shard the seed index by hash range across the "
                        "devices instead of replicating it (for indexes "
                        "larger than one device's memory)")
    p.add_argument("--batchFragments", type=int, default=512)
    p.add_argument("--coordinator", default=None,
                   help="multi-process launch: coordinator host:port "
                        "(or MASHMAP_TPU_COORDINATOR)")
    p.add_argument("--numProcesses", type=int, default=None,
                   help="multi-process launch: total process count "
                        "(or MASHMAP_TPU_NUM_PROCS)")
    p.add_argument("--processId", type=int, default=None,
                   help="multi-process launch: this process's id "
                        "(or MASHMAP_TPU_PROC_ID)")
    p.add_argument("--noProgress", action="store_true",
                   help="disable the live progress meter")
    p.add_argument("--profile", action="store_true",
                   help="enable stage timing logs")
    p.add_argument("--traceDir", default="",
                   help="write a torch.profiler trace (Chrome trace JSON) "
                        "of the run to this directory")
    return p


def args_to_params(a) -> Parameters:
    if a.ref:
        refs = [a.ref]
    elif a.refList:
        refs = [line.strip() for line in open(a.refList) if line.strip()]
    else:
        print("ERROR: provide reference file(s) with -r/--rl",
              file=sys.stderr)
        sys.exit(1)
    queries = []
    if a.query:
        queries = [a.query]
    elif a.queryList:
        queries = [line.strip() for line in open(a.queryList)
                   if line.strip()]

    # up-front input validation (validateInputFile, parseCmdArgs.hpp:165-178)
    for f in refs + queries:
        if not os.path.isfile(f) or not os.access(f, os.R_OK):
            print(f"ERROR: Could not open {f}", file=sys.stderr)
            sys.exit(1)

    # validation mirrors parseCmdArgs.hpp:455-581
    if a.segLength < 100:
        print("ERROR: minimum segment length is required to be >= 100 bp",
              file=sys.stderr)
        sys.exit(1)
    if a.blockLength is not None and a.blockLength < 0:
        print("ERROR: min block length has to be >= 0", file=sys.stderr)
        sys.exit(1)
    if a.chainGap is not None and a.chainGap < 0:
        print("ERROR: chain gap has to be >= 0", file=sys.stderr)
        sys.exit(1)
    if a.numMappingsForSegment <= 0 or a.numMappingsForShortSeq <= 0:
        print("ERROR: the number of mappings to retain has to be "
              "greater than 0", file=sys.stderr)
        sys.exit(1)
    if a.perc_identity < 50:
        print("ERROR: minimum nucleotide identity requirement should "
              "be >= 50%", file=sys.stderr)
        sys.exit(1)
    if not (0 <= a.hgFilterAniDiff <= 100):
        print("ERROR: ANI difference must be between 0 and 100",
              file=sys.stderr)
        sys.exit(1)
    if not (0 <= a.hgFilterConf <= 100):
        print("ERROR: hypergeometric confidence must be between 0 and "
              "100", file=sys.stderr)
        sys.exit(1)

    mode = {"map": FILTER_MAP, "one-to-one": FILTER_ONETOONE,
            "none": FILTER_NONE}[a.filter_mode]
    sparsity = ((1 << 64) - 1 if a.sparsifyMappings >= 1.0
                else int(a.sparsifyMappings * ((1 << 64) - 1)))

    params = Parameters(
        kmer_size=a.kmer,
        kmer_pct_threshold=a.kmerThreshold,
        seg_length=a.segLength,
        block_length=a.blockLength,
        chain_gap=a.chainGap,
        percentage_identity=a.perc_identity / 100.0,
        stage1_topANI_filter=not a.noHgFilter,
        ANIDiff=a.hgFilterAniDiff / 100.0,
        ANIDiffConf=a.hgFilterConf / 100.0,
        filter_mode=mode,
        num_mappings_for_segment=a.numMappingsForSegment,
        num_mappings_for_short_sequence=a.numMappingsForShortSeq,
        ref_sequences=refs,
        query_sequences=queries,
        out_file_name=a.output,
        save_index_filename=a.saveIndex,
        load_index_filename=a.loadIndex,
        split=not a.noSplit,
        lower_triangular=a.lowerTriangular,
        skip_self=a.skipSelf,
        skip_prefix=a.skipPrefix is not None,
        prefix_delim=a.skipPrefix or "\0",
        target_list=a.targetList,
        target_prefix=a.targetPrefix,
        merge_mappings=not a.noMerge,
        keep_low_pct_id=not a.dropLowMapId,
        report_ANI_percentage=a.reportPercentage,
        filter_length_mismatches=a.filterLengthMismatches,
        kmer_complexity_threshold=a.kmerComplexity,
        sketch_size=a.sketchSize,
        dense=a.dense,
        exact_ref_size=a.exactRefSize,
        sparsity_hash_threshold=sparsity,
        legacy_output=a.legacy,
        threads=a.threads,
        batch_fragments=a.batchFragments,
        use_device_pipeline=not a.noDevicePipeline,
        shard_index=a.shardIndex,
        no_progress=a.noProgress,
        coordinator=a.coordinator,
        num_processes=a.numProcesses,
        process_id=a.processId,
    ).finalize()
    return params


def echo_params(p: Parameters) -> None:
    """Parameter echo, mirroring printCmdOptions (parseCmdArgs.hpp:209-250)."""
    e = sys.stderr
    b = "[mashmap-tpu-torch]"
    print(f"{b} v{FIXED.VERSION}-compatible", file=e)
    print(f"{b} Reference = {p.ref_sequences}", file=e)
    print(f"{b} Query = {p.query_sequences}", file=e)
    print(f"{b} Kmer size = {p.kmer_size}", file=e)
    print(f"{b} Sketch size = {p.sketch_size}", file=e)
    print(f"{b} Segment length = {p.seg_length}"
          f"{' (read split allowed)' if p.split else ' (read split disabled)'}",
          file=e)
    if p.block_length <= p.seg_length:
        print(f"{b} No block length filtering", file=e)
    else:
        print(f"{b} Block length min = {p.block_length}", file=e)
    print(f"{b} Chaining gap max = {p.chain_gap}", file=e)
    print(f"{b} Mappings per segment = {p.num_mappings_for_segment}",
          file=e)
    print(f"{b} Percentage identity threshold = "
          f"{100 * p.percentage_identity}%", file=e)
    print(f"{b} {'Skip' if p.skip_self else 'Do not skip'} self mappings",
          file=e)
    if p.stage1_topANI_filter:
        print(f"{b} Hypergeometric filter w/ delta = {p.ANIDiff} "
              f"and confidence {p.ANIDiffConf}", file=e)
    else:
        print(f"{b} No hypergeometric filter", file=e)
    print(f"{b} Mapping output file = {p.out_file_name}", file=e)
    print(f"{b} Filter mode = {p.filter_mode} "
          f"(1 = map, 2 = one-to-one, 3 = none)", file=e)


def main(argv=None, device=None, devices=None) -> int:
    """Parse argv (default: sys.argv[1:]) and map on ``devices`` (default
    ``[device]``, or every visible CUDA device when neither is given;
    raises without a card unless the caller passes "cpu")."""
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"{FIXED.VERSION} (mashmap-tpu-torch)", file=sys.stderr)
        return 0
    logging.basicConfig(
        level=logging.INFO if args.profile else logging.WARNING,
        format="[mashmap-tpu-torch] %(message)s")
    params = args_to_params(args)
    if devices is None and device is not None:
        devices = [device]
    from .parallel.mesh import make_mesh
    devices = make_mesh(devices)
    echo_params(params)
    from .api import map_files
    if args.traceDir:
        # reference aux subsystem analog: ENABLE_TIME_PROFILE_L1_L2 /
        # PROFILE builds (SURVEY.md section 5) — here a torch.profiler
        # trace of host ops and, on a card, its kernels and copies,
        # viewable in Perfetto or chrome://tracing
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if any(d.type == "cuda" for d in devices):
            acts.append(ProfilerActivity.CUDA)
        # trace.recording: the program's spans in the trace, as
        # record_function ranges beside the host ops and kernels
        from . import trace
        with profile(activities=acts) as prof, trace.recording():
            map_files(params, devices=devices)
        os.makedirs(args.traceDir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.traceDir, "trace.json"))
    else:
        map_files(params, devices=devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
