"""aim-tpu-torch command-line launcher (NVIDIA GPUs).

The same flags, config derivation and output as ``aim_tpu.cli``; its
``build_parser`` and ``config_from_args`` are copies of that module's
(tests hold them equal):

    python -m aim_tpu_torch.cli wfa -i pairs.txt -o out -l 100 -e 0.01 \\
        -n 40000 -b -r

Every config runs.  The short-read tiers of WFA / WFA-adaptive (kernel
K1), NW (K2), SWG (K3) and GenASM (K4), the WFA long-read tier (K5, reads
of 1-16 kbp) and the streamed NW/SWG long-read tier (K6 forward, K7 walk)
with the GenASM long tier on it serve what the reference's kernels serve,
e.g.

    python -m aim_tpu_torch.cli nw -i pairs.txt -o out -l 100 -e 0.01 -b
    python -m aim_tpu_torch.cli genasm -i pairs.txt -o out -l 100 -e 0.01 -b
    python -m aim_tpu_torch.cli wfa -i pairs.txt -o out -l 10000 -e 0.01 \
        -b -r --variant hbm
    python -m aim_tpu_torch.cli nw -i pairs.txt -o out -l 4096 -e 0.01 \
        -b --variant hbm
    python -m aim_tpu_torch.cli swg -i pairs.txt -o out -l 4096 -e 0.01 \
        -b --variant hbm
    python -m aim_tpu_torch.cli genasm -i pairs.txt -o out -l 4096 \
        -e 0.01 -b

NW/SWG/GenASM-long pairs a kernel flags re-run on the wider bands of the
retry ladder (AIM_TPU_RETRY_PLANES, default 2,4,8), then on the exact host
oracle; AIM_TPU_ROUTE=0 keeps the streamed tier's primary band at one
plane.  The configs no kernel admits (WFA past the long-read tier's smax
1023, SWG int8 cells the band cannot prove, a negative match cost, reads
past 16352) run on the dense exact tiers in plain PyTorch on the card, and
GenASM past k = 508 on the host tier (the exact oracle); ``--backend xla``
puts every config there:

    python -m aim_tpu_torch.cli wfa -i pairs.txt -o out -l 100 -e 0.01 \
        -b -r --backend xla

``--profile DIR`` writes a torch.profiler chrome trace (CPU and CUDA
activities) of the whole call, parse to emit, to DIR/trace.json, each host
stage an ``aim.<stage>`` range; ``--device-log`` adds each stage's seconds
and the chunk and byte counters to its line; ``--energy`` prints the
GPU energy of the align span from NVML's total-energy counter, and the
host's from RAPL where the host has it.  The run shards its pairs over
every CUDA device of the host, as ``aim_tpu.cli`` does over its devices;
``-d N`` caps the count at N.  Each chunk splits into one contiguous block
a card, and the output file is the one-card run's, byte for byte.  Across
processes (hosts), ``python -m aim_tpu_torch.parallel.runner`` runs the
same command on each process's contiguous range of the file.
"""

from __future__ import annotations

import argparse
import sys

from aim_tpu_torch.config import derive_config, wram_feasible


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="aim-tpu", add_help=True)
    sub = ap.add_subparsers(dest="algo", required=True)

    def common(p, affine):
        p.add_argument("-i", "--input", type=str, required=True,
                       help="Input read pairs file path")
        p.add_argument("-o", "--output", type=str, default="./out",
                       help="Output alignment file path")
        p.add_argument("-l", "--read_length", type=int, required=True,
                       help="Read length")
        p.add_argument("-e", "--error", type=float, required=True,
                       help="Percentage error per read length")
        p.add_argument("-n", "--number_reads", type=int, required=True,
                       help="Number of read pairs to be aligned")
        if affine is not None:
            p.add_argument("-m", "--match_cost", type=int, default=0,
                           help="Cost of characters match")
            p.add_argument("-x", "--mismatch_cost", type=int, default=3,
                           help="Cost of characters mismatch")
        if affine:
            p.add_argument("-g", "--gap_opening", type=int, default=4,
                           help="Cost of opening a new gap")
            p.add_argument("-a", "--gap_extending", type=int, default=1,
                           help="Cost of extending gap")
        elif affine is not None:
            p.add_argument("-g", "--gap", type=int, default=4,
                           help="Cost of gap (GAP_I = GAP_D)")
        p.add_argument("-b", "--backtrace", action="store_true",
                       help="Enable backtracing")
        p.add_argument("-t", "--nr_of_tasklets", type=int, default=None,
                       help="force the per-device batch down to t x 1024 "
                            "pairs (the reference maps -t to NR_TASKLETS, "
                            "honored only when 1 <= t <= the heuristic "
                            "choice; ref: run-wfa-pim-mram.py:108-112)")
        p.add_argument("-d", "--nr_of_dpus", type=int, default=None,
                       help="reference compat; caps the TPU device count")
        p.add_argument("--variant", choices=["vmem", "hbm"], default="vmem",
                       help="memory tier: vmem=short-read (DPU-WRAM "
                            "analogue), hbm=long-read (DPU-MRAM analogue)")
        p.add_argument("--backend", choices=["auto", "pallas", "xla"],
                       default="auto")
        p.add_argument("--batch-pairs", type=int, default=None,
                       help="pairs per device batch")
        p.add_argument("--energy", action="store_true",
                       help="print the GPU energy (J) measured over the "
                            "align span by NVML's total-energy counter, and "
                            "the host's by RAPL where present; the "
                            "reference's -DENERGY probe analogue")
        p.add_argument("--device-log", type=str, default="",
                       help="per-device run log path (the reference's "
                            "dpu-out file; disabled when empty)")
        p.add_argument("--profile", type=str, default="",
                       help="write a torch.profiler chrome trace (CPU and "
                            "CUDA activities) of the whole call, each host "
                            "stage an aim.<stage> range, to "
                            "DIR/trace.json")
        p.add_argument("-q", "--quiet", action="store_true")

    nw = sub.add_parser("nw", help="Needleman-Wunsch edit distance")
    common(nw, affine=False)
    ga = sub.add_parser("genasm",
                        help="GenASM bitvector bounded edit distance "
                             "(beyond the reference snapshot: its genasm "
                             "submodule is empty)")
    common(ga, affine=None)
    swg = sub.add_parser("swg", help="Smith-Waterman-Gotoh affine gap")
    common(swg, affine=True)
    wfa = sub.add_parser("wfa", help="wavefront alignment")
    common(wfa, affine=True)
    wfa.add_argument("-r", "--reduced", action="store_true",
                     help="Enable WFA-Adaptive")
    wfa.add_argument("--overflow-backtrace", action="store_true",
                     help="WRAM-variant compat: emit a defined best-effort "
                          "CIGAR for score > MAX_SCORE pairs instead of the "
                          "MRAM-variant skip (the reference WRAM tier "
                          "backtraces on overflow via an out-of-bounds "
                          "read — UB; ref: WFA/DPU-WRAM/dpu/wfa.c:369-376)")
    gen = sub.add_parser(
        "gen", help="generate a synthetic pair file (the WFA repository's "
                    "generate_dataset semantics the reference points at; "
                    "ref: Datasets/README.md:18-26)")
    gen.add_argument("-o", "--output", type=str, required=True,
                     help="Output pair file path")
    gen.add_argument("-n", "--number_reads", type=int, required=True,
                     help="Number of read pairs to generate")
    gen.add_argument("-l", "--read_length", type=int, required=True,
                     help="Pattern length")
    gen.add_argument("-e", "--error", type=float, required=True,
                     help="Edit-error rate (ceil(l*e) edits per pair)")
    gen.add_argument("--seed", type=int, default=0)
    return ap


def config_from_args(args) -> "AlignConfig":
    if args.algo == "genasm":
        # unit costs by definition; MAX_SCORE derives from the NW formula
        cfg = derive_config("genasm", args.read_length, args.error,
                            backtrace=args.backtrace, variant=args.variant,
                            backend=args.backend)
    # Penalty validation mirrors the launchers (run-wfa-pim-mram.py:44-46).
    elif args.algo in ("swg", "wfa"):
        if (args.match_cost > 0 or args.mismatch_cost <= 0
                or args.gap_opening <= 0 or args.gap_extending <= 0):
            print("Wrong affine gap penalties must be  m <= 0 and g, a, x > 0\n")
            raise SystemExit(-1)
        cfg = derive_config(
            args.algo, args.read_length, args.error,
            match=args.match_cost, mismatch=args.mismatch_cost,
            gap_opening=args.gap_opening, gap_extending=args.gap_extending,
            backtrace=args.backtrace,
            adaptive=getattr(args, "reduced", False),
            variant=args.variant, backend=args.backend)
    else:
        if args.match_cost > 0 or args.mismatch_cost <= 0 or args.gap <= 0:
            print("Wrong penalties must be  m <= 0 and g, x > 0\n")
            raise SystemExit(-1)
        cfg = derive_config(
            "nw", args.read_length, args.error,
            match=args.match_cost, mismatch=args.mismatch_cost,
            gap=args.gap, backtrace=args.backtrace,
            variant=args.variant, backend=args.backend)
    if args.batch_pairs:
        cfg = cfg.replace(batch_pairs=args.batch_pairs)
    if getattr(args, "overflow_backtrace", False):
        cfg = cfg.replace(overflow_backtrace=True)
    # -t override: the reference honors it only when it forces the
    # heuristic DOWN (1 <= t <= chosen NR_TASKLETS, run-wfa-pim-mram.py:
    # 106-112).  The analogue knob here is the per-device pair batch, in
    # 1024-pair units (default 16384 = "16 tasklets").
    t = getattr(args, "nr_of_tasklets", None)
    if t is not None and 1 <= t <= cfg.batch_pairs // 1024:
        cfg = cfg.replace(batch_pairs=t * 1024)
    return cfg


def main(argv=None) -> int:
    """One run of the CLI: one call record of ``aim_tpu_torch.spans``,
    from the arguments to the result's release (pairs 0 where it aligned
    nothing)."""
    from aim_tpu_torch import spans
    with spans.call("cli"):
        return _main(argv)


def _main(argv) -> int:
    ap = build_parser()
    ap.prog = "aim-tpu-torch"
    args = ap.parse_args(argv)
    if args.algo == "gen":
        if args.read_length <= 0 or args.number_reads <= 0:
            print("Undefined read length / number of reads")
            return -1
        from aim_tpu_torch.datagen import write_pair_file
        n = write_pair_file(args.output, args.number_reads,
                            args.read_length, args.error, seed=args.seed)
        print(f"wrote {n} pairs (l={args.read_length}, e={args.error}) "
              f"to {args.output}")
        return 0
    if args.read_length <= 0:
        print("Undefined input read length")
        return -1
    if args.number_reads <= 0:
        print("Undefined number of input reads")
        return -1
    cfg = config_from_args(args)
    if cfg.variant == "vmem" and not wram_feasible(cfg):
        print("Data doesn't fit in the WRAM (short-read tier); "
              "use --variant hbm for long reads")
        return -1
    import torch
    if not torch.cuda.is_available():
        print("aim-tpu-torch: CUDA is not available. The port runs on an "
              "NVIDIA GPU (built for sm_90a); use `python -m aim_tpu.cli` "
              "on other hosts.", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"algo={cfg.algo} MAX_SCORE={cfg.max_score} "
              f"READ_SIZE={cfg.read_size} backtrace={cfg.backtrace} "
              f"adaptive={cfg.adaptive} variant={cfg.variant}")
    ndev = torch.cuda.device_count()
    if args.nr_of_dpus:
        ndev = min(ndev, args.nr_of_dpus)
    if args.number_reads <= ndev:
        # ref: host.c:180-184 rejects total_nb_reads <= NR_DPUS
        print("Allocated DPUs more than needed")
        return 1
    if ndev > 1 and not args.quiet:
        print(f"Allocated {ndev} device(s)")  # ref: host.c:189
        per = ((args.number_reads // ndev) + 7) // 8 * 8
        print(f"NumReads per device = {per}")  # ref: host.c:192
    from aim_tpu_torch.api import align_file
    from aim_tpu_torch.parallel import devices
    align_file(args.input, args.output, args.number_reads, cfg,
               device=devices(max(ndev, 1)), verbose=not args.quiet,
               device_log=args.device_log or None, energy=args.energy,
               profile_dir=args.profile or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
