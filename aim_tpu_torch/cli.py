"""aim-tpu-torch command-line launcher (one NVIDIA GPU).

The same flags, config derivation and output as ``aim_tpu.cli``, whose
``build_parser`` and ``config_from_args`` it reuses:

    python -m aim_tpu_torch.cli wfa -i pairs.txt -o out -l 100 -e 0.01 \\
        -n 40000 -b -r

Ported so far: the short-read tiers of WFA / WFA-adaptive (kernel K1), NW
(K2), SWG (K3) and GenASM (K4), and the WFA long-read tier (K5, reads of
1-16 kbp), e.g.

    python -m aim_tpu_torch.cli nw -i pairs.txt -o out -l 100 -e 0.01 -b
    python -m aim_tpu_torch.cli genasm -i pairs.txt -o out -l 100 -e 0.01 -b
    python -m aim_tpu_torch.cli wfa -i pairs.txt -o out -l 10000 -e 0.01 \
        -b -r --variant hbm

NW/SWG pairs a kernel flags go to the exact host oracle.  Other configs
(the NW/SWG streamed and GenASM long tiers, WFA past the long-read tier's
smax 1023, SWG int8 cells the reference tier cannot prove, a negative
match cost) exit 2 with the ROADMAP item that will port them.  ``-d``
caps the device count at 1 (multi-GPU is ROADMAP Queue 1 item 9);
``--backend xla``, ``--profile`` and ``--energy`` are not ported yet.
"""

from __future__ import annotations

import sys

from aim_tpu.cli import build_parser, config_from_args

_NOT_PORTED_FLAGS = (
    (lambda a: a.backend == "xla",
     "--backend xla: not yet ported (ROADMAP Queue 1 item 5, exact torch "
     "fallback tiers)"),
    (lambda a: bool(a.profile),
     "--profile: not yet ported (ROADMAP Queue 1 item 10, tooling)"),
    (lambda a: a.energy,
     "--energy: not yet ported (ROADMAP Queue 1 item 10, tooling)"),
)


def main(argv=None) -> int:
    ap = build_parser()
    ap.prog = "aim-tpu-torch"
    args = ap.parse_args(argv)
    if args.algo == "gen":
        if args.read_length <= 0 or args.number_reads <= 0:
            print("Undefined read length / number of reads")
            return -1
        from aim_tpu.datagen import write_pair_file
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
    from aim_tpu.config import wram_feasible
    if cfg.variant == "vmem" and not wram_feasible(cfg):
        print("Data doesn't fit in the WRAM (short-read tier); "
              "use --variant hbm for long reads")
        return -1
    for rejected, msg in _NOT_PORTED_FLAGS:
        if rejected(args):
            print(f"aim-tpu-torch: {msg}", file=sys.stderr)
            return 2
    from aim_tpu_torch.ops import kernels
    try:
        kernels.forward_fn(cfg)
    except NotImplementedError as e:
        print(f"aim-tpu-torch: {e}", file=sys.stderr)
        return 2

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
    ndev = min(torch.cuda.device_count(), 1)
    if args.nr_of_dpus:
        ndev = min(ndev, args.nr_of_dpus)
    if args.number_reads <= ndev:
        # ref: host.c:180-184 rejects total_nb_reads <= NR_DPUS
        print("Allocated DPUs more than needed")
        return 1
    from aim_tpu_torch.api import align_file
    align_file(args.input, args.output, args.number_reads, cfg,
               device=torch.device("cuda", 0), verbose=not args.quiet,
               device_log=args.device_log or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
