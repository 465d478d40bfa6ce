"""Smoke run of the PyTorch port (aim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero
before the last line:

  1. device   CUDA must be present; card name and power limit from
              nvidia-smi; build the CUDA kernels from csrc/ (timed).
  2. kernel   each kernel against its plain PyTorch version on the card:
              records byte-equal, and the scores/CIGARs of every pair (K1,
              K4, K5) or every unflagged pair (K2 NW, K3 SWG, K6/K7) equal
              to the native oracle.  K1 (csrc/wfa2.cu) on 12 configs, K2
              (csrc/nw.cu) on 14 and K3 (csrc/swg.cu) on 12 (band widths 8
              to 128), K4 (csrc/genasm.cu) on 15 (6 to 150 rows), 4096 seeded
              pairs each (4095 where neighbours in a warp differ: normal
              beside flagged, overflowing or edge pairs, the last warp
              part-empty; all of K1's); each K1-K4 line names the kernel's
              path (pairs a warp, windowed history); K5 (csrc/wfa_long.cu)
              on 8 long-read configs of 16 to 4096 pairs; K6/K7
              (csrc/nwswg_long.cu) on NW and SWG at planes 1, 2, 4 and 8,
              with and without backtrace, raw and packed, records of 256 to
              1024 lanes, flagged pairs, the raw two-plane shape the retry
              ladder hands them behind K2 and K3, K7's own cases
              (tests/torch_cases.py K7_CASES), and the GenASM adapter at
              k in each of its plane bands (K6 on meta and code rows, K7 and
              the wrapper nwswg_forward_long on records).
  3. main     the CLI paths: `wfa -l 100 -e 0.01 -b -r` (the main path),
              `nw -b`, `nw`, `swg -b`, `swg`, `genasm -b` and `genasm` at
              the same -l/-e, each on the same 1,000,000 generated pairs;
              `wfa -b`, `-b -r`, `-r` and the six NW/SWG/GenASM runs on
              data/sample-l100-e1-2K; `wfa -l 10000 -e 0.01 -b -r --variant
              hbm` on 8,192 generated pairs and `-b` on the first 1,024;
              the streamed tier `nw -l 4096 -e 0.01 -b --variant hbm` and
              `nw` (score only) on 1,024 generated pairs, `swg ... -b` on
              512 of them (and on 3 x 256 under AIM_TPU_ROUTE=0, where the
              primary band is C = 63 and the retry ladder climbs), and
              `genasm -l 4096 -e 0.01 -b` on the 1,024; K2's retry ladder:
              `nw -l 100 -e 0.01 -b` and `nw` on 4,096 pairs generated at
              10 % errors, which K2 flags and K6/K7 re-run at two planes.
              Every output file must equal the oracle's byte for byte;
              every launch and dense-call counter is set to 0 just before
              each run and read just after, and the run's own kernels must
              have launched and no other.  The 100 bp and WFA runs must
              flag no pair, the ladder runs aside; the streamed and ladder
              runs report the pairs the ladder certified at each stage and
              the oracle re-ran.
  4. timing   each kernel vs its plain version on one chunk of its
              canonical config (CUDA events): 16384 pairs at 100 bp, 1024
              pairs at 10 kbp, 4096 pairs at 4 kbp for K6 and K7 (K7 also
              on the SWG chunk, `swg -l 4096 -e 0.01 -b --variant hbm`); their
              records compared once more at this, the CLI's launch shape;
              K5 also alone on the 8,192 pairs of the 10 kbp CLI run, in its
              difficulty order; K6 also on the first 1024 pairs of its chunk
              (the 4 kbp CLI runs' size); K1's to K7's registers, spills,
              shared memory, resident blocks an SM and pairs a warp.  The
              WFA bounds count the live (level, diagonal) cells of the
              plain version's level extents and a compare a 32-base window
              of matched bases; the lines also give the operations the
              earlier count (every diagonal of every level reached) gave.
  5. probes   the tooling path: `aim_tpu_torch.tools.microbench` drives the
              13 CUDA probes of csrc/probes.cu (M1's twelve, M2) with their
              launch counters at 0; each probe's output equal to its plain
              version at 64 and 512 reps; per-rep ns, bound, plain time.
  6. dense    the exact tiers: `wfa -b -r`, `nw -b`, `swg -b` with
              `--backend xla` on the sample; configs no kernel admits on the
              default backend: `swg -m -1 -b` on the sample, `wfa -l 4096
              -e 0.05 -b --variant hbm` (MAX_SCORE 1024) and `genasm -l 2000
              -e 0.3 -b` (k 1200, the host tier) on 48 generated pairs, `nw
              -l 20000 -e 0.01 -b --variant hbm` on 4 (the NW oracle wraps its
              int16 cells there; the dense tier flags exactly those pairs
              to it).  Each output `cmp`-equal to the oracle's; no hand
              kernel launched, the dense tier's call counter (none for the
              host tier) above 0.
  7. fuzz     `aim_tpu_torch.tools.fuzz_kernels`: all 31 rows at seed 101
              on the card, each row's tier printed, 0 bad pairs.
  8. tools    `--profile` on `wfa -b -r` on the sample leaves a chrome
              trace with kernel events; `--energy` on the 1M-pair main
              path prints the GPU joules NVML measured, above 0.
  9. multi    pair sharding: `api.align_file` over `[cuda:0] * 4` (and
              over every card where there are more) on the 1M-pair main
              path, `nw -b`, `swg -b`, `genasm -b` on the sample, the
              first 1,024 of the 10 kbp pairs (`-b -r`, sorted and dealt
              over the shards) and K2's ladder input; each output
              `cmp`-equal to the one-device run's and to the oracle's,
              the run's kernel launched once a non-empty block (the
              ladder's K6/K7 above 0) and no other kernel, one device-log
              line a shard; the CLI with `-d` at the card count (the
              `Allocated` lines only over several cards); the runner
              (`aim_tpu_torch.parallel.runner`) in two processes with RANK,
              WORLD_SIZE and a file store, on cuda:(rank % cards), on the
              sample and the main input: the joined file `cmp`-equal, no
              part left; `tools.dryrun_multichip` over 4 shards.

 10. bench    `python -m aim_tpu_torch.tools.bench` at its defaults (1M
              pairs, 420 s budget), the command users run, in a process of
              its own: exit 0 and a complete line (no `degraded`, `error` or
              `skipped`; every key of `bench.KEYS`; every rate and slope of
              `bench.POSITIVE` above 0; the long-read slopes over whole
              waves of K5 and K6; the card's name and power limit), its
              oracle checks passed inside it; emitted with its wall time.

`python3 chip_smoke.py --only multi` runs phases 1 and 9 alone (a host
with several cards), making the inputs and one-device runs phase 9 needs;
`--only bench` runs phases 1 and 10.

The last two lines are the kernel table (time, plain time, the bound the
card sets for the same work and what sets it, launches on the main path)
and {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import filecmp
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = torch.device("cuda", 0)
SAMPLE = os.path.join(REPO, "data", "sample-l100-e1-2K")
SEED = 0
MAIN_PAIRS = 1_000_000   # the generated main-path run
LONG_PAIRS = 8_192       # the generated 10 kbp run
ORACLE_1T_PAIRS = 200_000
LONG_TIMING_PAIRS = 1_024   # the 10 kbp timing chunk (the plain version
                            # takes about half a minute on it)
# the generated 4 kbp streamed-tier runs: the host oracle's re-run of the
# ~40 % aliasing pairs is most of their time, so they are cut to keep the
# whole smoke near half its time limit
STREAM_PAIRS = 1_024
STREAM_SWG_PAIRS = 512
STREAM_TIMING_PAIRS = 4_096  # K6/K7's timing chunk
# the ladder's run: this many pairs at each error rate, one file
LADDER_ERRORS = (0.01, 0.025, 0.035)
LADDER_PAIRS_EACH = 256
# K2's ladder at 100 bp: pairs at 10 % errors run at -e 0.01, so that K2
# flags nearly all of them and K6/K7 re-run them at two planes
LADDER_100_PAIRS = 4_096
LADDER_100_LABEL = "datagen-100bp-e10"
# the main path's generated input, and the oracle's output of its first run
# (`wfa -b -r`), which the tools phase compares against once more
MAIN_INPUT = "pairs.txt"
MAIN_ORACLE = "oracle0"
FUZZ_SEED = 101
# The card's peaks for the bounds (H100 SXM data sheet and white paper, at
# the 700 W limit): HBM3 bytes a second; int32 operations a second (132 SMs
# x 64 INT32 lanes x 1.98 GHz boost clock).
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
# device cycles of spin a timed call, ahead of the timed span (~0.1 ms at
# the H100's clock: more than a wrapper's host work)
SPIN_CYCLES_PER_CALL = 200_000


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the "
              "port on an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    from aim_tpu_torch.ops import _build
    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "device", "gpu": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "nvcc_s": _build.build_seconds})
    return smi


def fuzz_batch(R, alphabet="ACGT"):
    """4096 seeded pairs made as tools/fuzz_kernels.py makes them."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from util import pack, random_pairs
    return pack(random_pairs(seed=SEED, n=4096, max_len=R - 8,
                             balanced=False, alphabet=alphabet), R)


def kernel_configs():
    """(name, cfg, (pats, txts, plens, tlens)) of every K1 check: 4095
    seeded pairs each, made as tools/fuzz_kernels.py makes them
    (tests/util.py) or by aim_tpu_torch.datagen."""
    from aim_tpu_torch import datagen
    from aim_tpu_torch.config import AlignConfig, derive_config

    main = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
    dg = datagen.generate_pairs(4096, 100, 0.01, read_size=112, seed=SEED)
    out = []
    for ad in (True, False):
        for bt in (True, False):
            out.append((f"main_ad{int(ad)}_bt{int(bt)}",
                        main.replace(adaptive=ad, backtrace=bt), dg))
    fuzz = [(48, dict(max_score=20, mismatch=2, gap_o=3, gap_e=2,
                      adaptive=False)),
            (48, dict(max_score=14, mismatch=5, gap_o=2, gap_e=1,
                      adaptive=True)),
            (96, dict(max_score=40, mismatch=3, gap_o=4, gap_e=1,
                      adaptive=True)),
            (200, dict(max_score=35, mismatch=4, gap_o=2, gap_e=2,
                       adaptive=True)),
            (248, dict(max_score=30, mismatch=3, gap_o=4, gap_e=1,
                       adaptive=True))]
    for R, kw in fuzz:
        out.append((f"fuzz_R{R}_s{kw['max_score']}",
                    AlignConfig(algo="wfa", read_size=R, backtrace=True,
                                **kw), fuzz_batch(R)))
    # 22 edits on 90 bp: scores 44 and up, some past 79
    out.append(("R112_s79", main.replace(max_score=79),
                datagen.generate_pairs(4096, 90, 0.24, read_size=112,
                                       seed=SEED)))
    # 10 edits on 100 bp: every pair past smax = 5
    out.append(("overflow", main,
                datagen.generate_pairs(4096, 100, 0.1, read_size=112,
                                       seed=SEED)))
    R, kw = fuzz[3]
    out.append(("acgtn_R200_s35",
                AlignConfig(algo="wfa", read_size=R, backtrace=True, **kw),
                fuzz_batch(R, "ACGTN")))
    # an odd count: the last warp of the two-pairs-a-warp path half empty
    return [(name, cfg, tuple(a[:4095] for a in b)) for name, cfg, b in out]


def phase_kernel():
    from aim_tpu_torch import native
    from aim_tpu_torch.ops import wfa2
    from aim_tpu_torch.ops.common import pack_seqs, to_device_batch
    max_err = 0
    for name, cfg, (p, t, pl, tl) in kernel_configs():
        up_p, up_t, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
        if name.startswith("acgtn") == packed:
            fail(f"{name}: packed={packed}")
        args = to_device_batch(up_p, up_t, pl, tl, DEVICE)
        before = wfa2.launch_count
        got = wfa2.wfa_forward2(*args, cfg=cfg, packed=packed)
        torch.cuda.synchronize()
        if wfa2.launch_count != before + 1:
            fail(f"{name}: launch not counted")
        want = wfa2.wfa2_reference(*args, cfg=cfg, packed=packed)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        err = int(np.abs(got.astype(np.int64) - want).max())
        max_err = max(max_err, err)
        rows = int((got != want).any(1).sum())
        smax = cfg.max_score
        sc, ops, b, e = native.wfa_steps_to_ops(got, pl, tl, max_score=smax,
                                                max_ops=2 * cfg.read_size)
        osc, oops, ob, oe = native.wfa_align(
            p, t, pl, tl, mismatch=cfg.mismatch, gap_o=cfg.gap_o,
            gap_e=cfg.gap_e, max_score=smax, adaptive=cfg.adaptive,
            backtrace=cfg.backtrace, threads=0)
        score_bad = int((sc != osc).sum())
        cigar_bad = 0
        if cfg.backtrace:
            cigar_bad = sum(ops[i, b[i]:e[i]].tobytes()
                            != oops[i, ob[i]:oe[i]].tobytes()
                            for i in range(len(pl)))
        over = int((osc > smax).sum())
        emit({"phase": "kernel", "config": name, "pairs": len(pl),
              "read_size": cfg.read_size, "max_score": smax,
              "adaptive": cfg.adaptive, "backtrace": cfg.backtrace,
              "packed": packed, "hist_in_smem": wfa2.hist_in_smem(cfg),
              "pairs_per_warp": wfa2.pairs_per_warp(cfg),
              "overflow_pairs": over, "record_rows_differ": rows,
              "max_abs_err": err, "score_bad": score_bad,
              "cigar_bad": cigar_bad})
        if rows or score_bad or cigar_bad:
            fail(f"{name}: kernel disagrees")
        if name == "overflow" and over != len(pl):
            fail("overflow batch has pairs within max_score")
    return max_err


def band_configs():
    """(name, cfg, (pats, txts, plens, tlens)) of every K2/K3 check, 4096
    seeded pairs each."""
    from aim_tpu_torch import datagen
    from aim_tpu_torch.config import AlignConfig, derive_config

    def dg(e, seed=SEED, length=100, R=112):
        return datagen.generate_pairs(4096, length, e, read_size=R,
                                      seed=seed)

    out = []
    for algo in ("nw", "swg"):
        main = derive_config(algo, 100, 0.01, backtrace=True)
        for bt in (True, False):
            out.append((f"{algo}_main_bt{int(bt)}",
                        main.replace(backtrace=bt), dg(0.01)))
        # 10 edits on 100 bp: the band flags nearly every pair
        out.append((f"{algo}_flag_heavy", main, dg(0.1)))
    # the NW rows of tools/fuzz_kernels.py (:27-33; the R = 96 `hbm` row
    # lands on K2 too: the NW gate ignores the variant) and its ACGTN row
    fuzz = [(48, dict(max_score=12, gap_i=2, gap_d=5, mismatch=1)),
            (48, dict(max_score=16, gap_i=1, gap_d=1, mismatch=4)),
            (96, dict(max_score=24, gap_i=3, gap_d=2, mismatch=2,
                      variant="hbm"))]
    for R, kw in fuzz:
        out.append((f"nw_fuzz_R{R}_s{kw['max_score']}",
                    AlignConfig(algo="nw", read_size=R, backtrace=True,
                                **kw), fuzz_batch(R)))
    R, kw = fuzz[2]
    out.append(("nw_acgtn_R96", AlignConfig(algo="nw", read_size=R,
                                            backtrace=True, **kw),
                fuzz_batch(R, "ACGTN")))
    swg_main = derive_config("swg", 100, 0.01, backtrace=True)
    out.append(("swg_acgtn", swg_main, fuzz_batch(112, "ACGTN")))
    # int16 cells: the :36-37 costs on the `hbm` variant (C 31, L 64)
    out.append(("swg_int16_R48", AlignConfig(
        algo="swg", read_size=48, max_score=60, match=0, mismatch=7,
        gap_o=2, gap_e=3, variant="hbm", backtrace=True), fuzz_batch(48)))
    # the range checks compiled in: NW (2R+2)*200 > 32767; SWG stored max
    # + margin = 129 > 127 at MAX_SCORE 9
    out.append(("nw_ovf_check", derive_config("nw", 100, 0.01,
                                              backtrace=True).replace(
        mismatch=200, gap_i=150, gap_d=150), dg(0.05)))
    out.append(("swg_ovf_check", swg_main.replace(max_score=9), dg(0.03)))
    # L = 128, code planes in the global scratch (~54 KB a pair)
    out.append(("nw_L128_R1120", AlignConfig(
        algo="nw", read_size=1120, max_score=120, gap_i=1, gap_d=1,
        mismatch=1, backtrace=True), dg(0.02, length=1000, R=1120)))
    # K2 and K3 at each band width past L = 16: 4 pairs a warp at L = 8,
    # one at 32, 128; L = 16 with its planes in the global scratch
    nw_main = derive_config("nw", 100, 0.01, backtrace=True)
    out += [("nw_L8", nw_main.replace(max_score=2), dg(0.005)),
            ("nw_L32", nw_main.replace(max_score=20), dg(0.02)),
            ("nw_L16_R800_global", AlignConfig(
                algo="nw", read_size=800, max_score=8, backtrace=True),
             dg(0.003, length=780, R=800))]
    out += [("swg_L8", swg_main.replace(max_score=2), dg(0.005)),
            ("swg_L32", swg_main.replace(max_score=10), dg(0.02)),
            ("swg_L128_R96", AlignConfig(
                algo="swg", read_size=96, max_score=60, match=0,
                mismatch=3, gap_o=4, gap_e=1, variant="hbm",
                backtrace=True), fuzz_batch(96)),
            ("swg_L16_R520_global", AlignConfig(
                algo="swg", read_size=520, max_score=5, match=0,
                mismatch=3, gap_o=4, gap_e=1, variant="hbm",
                backtrace=True), dg(0.002, length=500, R=520))]
    # unlike neighbours in one warp: 1 % and 10 % error pairs interleaved
    # (a normal pair beside a flagged one), the edge pairs among them, and
    # an odd pair count (the last warp part-empty)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_cases import EDGE_PAIRS, interleave
    from util import pack
    near, far = dg(0.01), dg(0.1, seed=SEED + 3)
    mixed = interleave(tuple(a[:2048] for a in near),
                       tuple(a[:2048] for a in far),
                       pack(EDGE_PAIRS * 8, 112))
    for algo, main in (("swg", swg_main), ("nw", nw_main)):
        for bt in (True, False):
            out.append((f"{algo}_mixed_neighbours_bt{int(bt)}",
                        main.replace(backtrace=bt),
                        tuple(a[:4095] for a in mixed)))
    return out


def phase_band_kernels():
    """K2/K3 against their plain versions; returns {kernel: max_abs_err}."""
    from aim_tpu_torch import native
    from aim_tpu_torch.api import _oracle_align
    from aim_tpu_torch.ops import nw, swg
    from aim_tpu_torch.ops.common import pack_seqs, to_device_batch
    max_err = {"nw": 0, "swg": 0}
    for name, cfg, (p, t, pl, tl) in band_configs():
        mod = nw if cfg.algo == "nw" else swg
        fwd = getattr(mod, f"{cfg.algo}_forward")
        ref = getattr(mod, f"{cfg.algo}_reference")
        up_p, up_t, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
        if ("acgtn" in name) == packed:
            fail(f"{name}: packed={packed}")
        args = to_device_batch(up_p, up_t, pl, tl, DEVICE)
        before = mod.launch_count
        got = fwd(*args, cfg=cfg, packed=packed)
        torch.cuda.synchronize()
        if mod.launch_count != before + 1:
            fail(f"{name}: launch not counted")
        want = ref(*args, cfg=cfg, packed=packed)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        err = int(np.abs(got.astype(np.int64) - want).max())
        max_err[cfg.algo] = max(max_err[cfg.algo], err)
        rows = int((got != want).any(1).sum())
        flagged = ((got[:, 0].astype(np.int32) >> 8) & 1).astype(bool)
        ok = ~flagged
        sc = got[:, 1].astype(np.int32)
        osc, oops, ob, oe = _oracle_align(p, t, pl, tl, cfg)
        score_bad = int((sc[ok] != osc[ok]).sum())
        cigar_bad = 0
        if cfg.backtrace:
            ops, b, e = native.wfa_runs_to_ops(
                got, sc, pl, tl, max_score=1 << 30,
                max_ops=2 * cfg.read_size)
            cigar_bad = sum(ops[i, b[i]:e[i]].tobytes()
                            != oops[i, ob[i]:oe[i]].tobytes()
                            for i in np.nonzero(ok)[0])
        C, L, _, NRL = nw.band_geometry(cfg)
        in_smem = mod.plane_layout(cfg)[0]
        ppw = nw.pairs_per_warp(cfg)
        emit({"phase": "kernel", "kernel": cfg.algo, "config": name,
              "pairs": len(pl), "read_size": cfg.read_size,
              "max_score": cfg.max_score, "C": C, "L": L, "NRL": NRL,
              "backtrace": cfg.backtrace, "packed": packed,
              "pairs_per_warp": ppw, "hist_windowed": False,
              "planes_in_smem": in_smem, "flagged": int(flagged.sum()),
              "record_rows_differ": rows, "max_abs_err": err,
              "score_bad": score_bad, "cigar_bad": cigar_bad})
        if rows or score_bad or cigar_bad:
            fail(f"{name}: kernel disagrees")
        if name.endswith("flag_heavy") and flagged.mean() < 0.9:
            fail(f"{name}: expected most pairs flagged")
        if name == "nw_L128_R1120" and (L != 128 or in_smem):
            fail(f"{name}: expected L = 128 with global planes")
        want_path = {"swg_main_bt1": (16, 2, True), "swg_L8": (8, 4, True),
                     "swg_L32": (32, 1, True), "swg_L128_R96": (128, 1, True),
                     "swg_L16_R520_global": (16, 2, False),
                     "nw_main_bt1": (16, 2, True), "nw_L8": (8, 4, True),
                     "nw_L32": (32, 1, True),
                     "nw_L128_R1120": (128, 1, False),
                     "nw_L16_R800_global": (16, 2, False)}.get(name)
        if want_path and want_path != (L, ppw, in_smem):
            fail(f"{name}: expected (L, pairs a warp, planes in shared "
                 f"memory) {want_path}, got {(L, ppw, in_smem)}")
        if "_mixed" in name and not 0.3 < flagged.mean() < 0.7:
            fail(f"{name}: expected flagged and unflagged neighbours")
    return max_err


def genasm_configs():
    """(name, cfg, (pats, txts, plens, tlens)) of every K4 check, 4096
    seeded pairs each."""
    from aim_tpu_torch import datagen
    from aim_tpu_torch.config import AlignConfig, derive_config
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_cases import GENASM_EDGES, interleave
    from util import pack

    main = derive_config("genasm", 100, 0.01, backtrace=True)
    dg = datagen.generate_pairs(4096, 100, 0.01, read_size=112, seed=SEED)
    # 5 edits on 100 bp against k = 2: nearly every pair overflows
    over = datagen.generate_pairs(4096, 100, 0.05, read_size=112,
                                  seed=SEED)
    out = []
    for bt in (True, False):
        tag = f"bt{int(bt)}"
        out += [(f"genasm_main_{tag}", main.replace(backtrace=bt), dg),
                (f"genasm_overflow_{tag}", main.replace(backtrace=bt), over),
                # tests/test_genasm.py's R 32 / k 12 geometry
                (f"genasm_R32_k12_{tag}", AlignConfig(
                    algo="genasm", read_size=32, max_score=12,
                    backtrace=bt), fuzz_batch(32)),
                # the gate's k edge at the main width: 108 rows, the
                # history in the global scratch
                (f"genasm_R112_k26_{tag}", AlignConfig(
                    algo="genasm", read_size=112, max_score=26,
                    backtrace=bt),
                 datagen.generate_pairs(4096, 100, 0.1, read_size=112,
                                        seed=SEED))]
    # tests/test_genasm.py's edge pairs, empty sequences included
    out.append(("genasm_R16_k5_edges", AlignConfig(
        algo="genasm", read_size=16, max_score=5, backtrace=True),
        tuple(a[:4096] for a in pack(GENASM_EDGES * 205, 16))))
    # 150 rows (the most the gate admits), global history
    out.append(("genasm_R160_k24", AlignConfig(
        algo="genasm", read_size=160, max_score=24, backtrace=True),
        fuzz_batch(160)))
    # the segmented path's other shapes: 24 rows windowed (k 5), 32 rows
    # with the full history in the global scratch (k 7), 11 rows with the
    # full history (R 24, k 10: two pairs a warp)
    out += [("genasm_R112_k5", main.replace(max_score=5),
             datagen.generate_pairs(4096, 100, 0.03, read_size=112,
                                    seed=SEED)),
            ("genasm_R112_k7", main.replace(max_score=7),
             datagen.generate_pairs(4096, 100, 0.04, read_size=112,
                                    seed=SEED)),
            ("genasm_R24_k10", AlignConfig(
                algo="genasm", read_size=24, max_score=10, backtrace=True),
             fuzz_batch(24))]
    # unlike neighbours in one warp: main and overflowing pairs
    # interleaved, the edge pairs among them, an odd pair count
    mixed = interleave(tuple(a[:2048] for a in dg),
                       tuple(a[:2048] for a in over),
                       pack(GENASM_EDGES * 4, 112))
    for bt in (True, False):
        out.append((f"genasm_mixed_neighbours_bt{int(bt)}",
                    main.replace(backtrace=bt),
                    tuple(a[:4095] for a in mixed)))
    return out


def phase_genasm_kernel():
    """K4 against its plain version and the GenASM oracle."""
    from aim_tpu_torch import native
    from aim_tpu_torch.ops import genasm
    from aim_tpu_torch.ops.common import pack_seqs, to_device_batch
    max_err = 0
    for name, cfg, (p, t, pl, tl) in genasm_configs():
        up_p, up_t, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
        if not packed:
            fail(f"{name}: the batch does not pack")
        args = to_device_batch(up_p, up_t, pl, tl, DEVICE)
        before = genasm.launch_count
        got = genasm.genasm_forward(*args, cfg=cfg)
        torch.cuda.synchronize()
        if genasm.launch_count != before + 1:
            fail(f"{name}: launch not counted")
        want = genasm.genasm_reference(*args, cfg=cfg)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        err = int(np.abs(got.astype(np.int64) - want).max())
        max_err = max(max_err, err)
        rows = int((got != want).any(1).sum())
        R, k = cfg.read_size, cfg.max_score
        sc = got[:, R + 3]
        osc, oops, ob, oe = native.genasm_align(
            p, t, pl, tl, max_score=k, backtrace=cfg.backtrace, threads=0)
        score_bad = int((sc != osc).sum())
        cigar_bad = 0
        if cfg.backtrace:
            _, ops, b, e = native.wfa_steps_to_ops(got, pl, tl, max_score=R,
                                                   max_ops=2 * R)
            cigar_bad = sum(ops[i, b[i]:e[i]].tobytes()
                            != oops[i, ob[i]:oe[i]].tobytes()
                            for i in range(len(pl)))
        over = int((osc > k).sum())
        path = (genasm.pairs_per_warp(cfg), genasm.hist_windowed(cfg),
                genasm.hist_in_smem(cfg))
        emit({"phase": "kernel", "kernel": "genasm", "config": name,
              "pairs": len(pl), "read_size": R, "max_score": k,
              "rows": genasm.geom(cfg)[3], "backtrace": cfg.backtrace,
              "pairs_per_warp": path[0], "hist_windowed": path[1],
              "hist_in_smem": path[2],
              "overflow_pairs": over, "record_rows_differ": rows,
              "max_abs_err": err, "score_bad": score_bad,
              "cigar_bad": cigar_bad})
        if rows or score_bad or cigar_bad:
            fail(f"{name}: kernel disagrees")
        if "overflow" in name and over < 0.9 * len(pl):
            fail(f"{name}: expected most pairs past k")
        if "k26" in name and genasm.hist_in_smem(cfg):
            fail(f"{name}: expected the global history")
        want_path = {"genasm_main_bt1": (2, True, True),
                     "genasm_R112_k5": (1, True, True),
                     "genasm_R112_k7": (1, False, False),
                     "genasm_R24_k10": (2, False, True),
                     "genasm_R16_k5_edges": (4, True, True),
                     "genasm_R112_k26_bt1": (1, False, False)}.get(name)
        if want_path and want_path != path:
            fail(f"{name}: expected (pairs a warp, windowed, in shared "
                 f"memory) {want_path}, got {path}")
        if "mixed" in name and not 0.2 < over / len(pl) < 0.8:
            fail(f"{name}: expected overflowing and normal neighbours")
    return max_err


def long_configs():
    """(name, cfg, (pats, txts, plens, tlens)) of every K5 check."""
    from aim_tpu_torch import datagen
    from aim_tpu_torch.config import derive_config
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_cases import mixed_lengths_batch

    def dg(n, length, e, cfg, seed=SEED):
        return datagen.generate_pairs(n, length, e, read_size=cfg.read_size,
                                      seed=seed)

    l10k = derive_config("wfa", 10000, 0.01, backtrace=True, adaptive=True,
                         variant="hbm")
    b10k = dg(256, 10000, 0.01, l10k)
    l16k = derive_config("wfa", 16000, 0.01, backtrace=True, adaptive=True,
                         variant="hbm")
    l1k = derive_config("wfa", 1000, 0.01, backtrace=True, adaptive=True,
                        variant="hbm")
    mixed = mixed_lengths_batch(R=520, n=256)
    # 'N' at 0.1 % of the text positions: the batch cannot 2-bit pack
    p, t, pl, tl = dg(64, 10000, 0.01, l10k, seed=SEED + 2)
    rng = np.random.default_rng(SEED)
    t = np.where(rng.random(t.shape) < 0.001, ord("N"), t).astype(np.uint8)
    return [("wfa_long_10k_s500", l10k, b10k),
            ("wfa_long_10k_s500_nonadaptive", l10k.replace(adaptive=False),
             b10k),
            ("wfa_long_10k_s500_nobt", l10k.replace(backtrace=False), b10k),
            ("wfa_long_16k_s800", l16k, dg(64, 16000, 0.01, l16k)),
            # smax 1023, the tier's cap; 2 % errors score about 860
            ("wfa_long_10k_s1023", l10k.replace(max_score=1023),
             dg(64, 10000, 0.02, l10k)),
            ("wfa_long_1k_s50", l1k, dg(4096, 1000, 0.01, l1k)),
            ("wfa_long_mixed_R520_s50", l1k.replace(read_size=520),
             mixed),
            ("wfa_long_acgtn_10k", l10k, (p, t, pl, tl))]


def phase_long_kernel():
    """K5 against its plain version and the WFA oracle."""
    from aim_tpu_torch import native
    from aim_tpu_torch.ops import wfa_long
    from aim_tpu_torch.ops.common import pack_seqs, to_device_batch
    max_err = 0
    for name, cfg, (p, t, pl, tl) in long_configs():
        up_p, up_t, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
        if name.endswith("acgtn_10k") == packed:
            fail(f"{name}: packed={packed}")
        if not packed:
            up_p, up_t = p, t
        args = to_device_batch(up_p, up_t, pl, tl, DEVICE)
        before = wfa_long.launch_count
        t0 = time.perf_counter()
        got = wfa_long.wfa_forward_long(*args, cfg=cfg, packed=packed)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        if wfa_long.launch_count != before + 1:
            fail(f"{name}: launch not counted")
        t0 = time.perf_counter()
        want = wfa_long.wfa_long_reference(*args, cfg=cfg, packed=packed)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        got, want = got.cpu().numpy(), want.cpu().numpy()
        err = int(np.abs(got.astype(np.int64) - want).max())
        max_err = max(max_err, err)
        rows = int((got != want).any(1).sum())
        smax = cfg.max_score
        sc, ops, b, e = native.wfa_steps_to_ops(got, pl, tl, max_score=smax,
                                                max_ops=2 * cfg.read_size)
        osc, oops, ob, oe = oracle_align(p, t, pl, tl, cfg, threads=0)
        score_bad = int((sc != osc).sum())
        cigar_bad = 0
        if cfg.backtrace:
            cigar_bad = sum(ops[i, b[i]:e[i]].tobytes()
                            != oops[i, ob[i]:oe[i]].tobytes()
                            for i in range(len(pl)))
        emit({"phase": "kernel", "kernel": "wfa_long", "config": name,
              "pairs": len(pl), "read_size": cfg.read_size, "max_score": smax,
              "adaptive": cfg.adaptive, "backtrace": cfg.backtrace,
              "packed": packed, "overflow_pairs": int((osc > smax).sum()),
              "record_rows_differ": rows, "max_abs_err": err,
              "score_bad": score_bad, "cigar_bad": cigar_bad,
              "kernel_s": t_kernel, "plain_s": t_plain})
        if rows or score_bad or cigar_bad:
            fail(f"{name}: kernel disagrees")
    return max_err


def stream_configs():
    """(name, cfg, (pats, txts, plens, tlens), planes, packed) of every
    K6/K7 check: the 4 kbp CLI configs, planes 1 to 8, several row
    blocks, mixed lengths, records of 256, 512 and 1024 lanes, and pairs
    that flag (aliasing, band exit, the SWG int16 wrap bound)."""
    from aim_tpu_torch import datagen
    from aim_tpu_torch.config import AlignConfig, derive_config
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_cases import (K7_CASES, NW_LONG, SWG_LONG,
                             mixed_lengths_batch, nwswg_long_case)

    def dg(n, length, e, cfg, seed=SEED):
        return datagen.generate_pairs(n, length, e, read_size=cfg.read_size,
                                      seed=seed)

    nw4 = derive_config("nw", 4096, 0.01, backtrace=True, variant="hbm")
    swg4 = derive_config("swg", 4096, 0.01, backtrace=True, variant="hbm")
    b_nw4 = dg(512, 4096, 0.01, nw4)
    b_swg4 = dg(256, 4096, 0.01, swg4)
    nw15 = derive_config("nw", 1500, 0.02, backtrace=True, variant="hbm")
    swg2k = AlignConfig(read_size=2048, **SWG_LONG)           # NRL 512
    unit4 = AlignConfig(algo="nw", read_size=4144, max_score=400,
                        backtrace=True, gap_i=1, gap_d=1, mismatch=1)
    nw10 = derive_config("nw", 10000, 0.01, backtrace=False, variant="hbm")
    # gap extension 40: pairs longer than ~800 flag on the int16 wrap bound
    wrap = AlignConfig(algo="swg", read_size=1040, max_score=400, match=0,
                       mismatch=3, gap_o=4, gap_e=40, variant="hbm",
                       backtrace=True)
    out = [("nw_4k_p1_bt", nw4, b_nw4, 1, True),
           ("nw_4k_p1_nobt", nw4.replace(backtrace=False), b_nw4, 1, False),
           ("nw_4k_p2_bt", nw4, b_nw4, 2, False),
           ("swg_4k_p2_bt", swg4, b_swg4, 2, True),
           ("swg_4k_p1_bt", swg4, b_swg4, 1, False),
           ("swg_4k_p4_nobt", swg4.replace(backtrace=False), b_swg4, 4,
            True),
           ("nw_1k5_p4_bt", nw15, dg(512, 1500, 0.02, nw15), 4, False),
           ("nw_1k5_p8_bt", nw15, dg(256, 1500, 0.02, nw15), 8, True),
           ("swg_2k_p8_bt_nrl512", swg2k, dg(256, 2000, 0.03, swg2k), 8,
            False),
           ("swg_2k_p2_bt_nrl512", swg2k, dg(512, 2000, 0.02, swg2k), 2,
            True),
           ("nw_unit_4k_p2_bt_nrl1024", unit4, dg(256, 4096, 0.02, unit4),
            2, True),
           ("nw_10k_p2_nobt_nrl1024", nw10, dg(64, 10000, 0.01, nw10), 2,
            True),
           ("nw_mixed_R520_p1", AlignConfig(read_size=520, **NW_LONG),
            mixed_lengths_batch(R=520, n=256), 1, False),
           ("nw_mixed_R520_p2", AlignConfig(read_size=520, **NW_LONG),
            mixed_lengths_batch(R=520, n=256), 2, True),
           ("swg_wrap_R1040_p2", wrap, fuzz_batch(1040), 2, False)]
    # and K7's own cases: a match run of 4224 rows, runs ending on 32-row
    # word and row-block boundaries, gaps, planes 1 to 8 (packed, so the
    # raw ones above and these differ)
    for case in ("swg_wide_retry", "ladder_p4", "ladder_p8", "nrl1024_p2",
                 "nw_ovf_p1") + tuple(K7_CASES):
        cfg, p, t, pl, tl, planes = nwswg_long_case(case)
        out.append((f"case_{case}", cfg, (p, t, pl, tl), planes,
                    case.startswith("k7_")))
    # the shape the ladder hands K6/K7 behind K2 and K3: raw bytes, two
    # planes, at 100 bp on 10 % errors (K2 flags nearly every pair) and on
    # K3's int16 cells
    nw1 = derive_config("nw", 100, 0.01, backtrace=True)
    e10 = datagen.generate_pairs(4096, 100, 0.1, read_size=112, seed=SEED)
    swg48 = AlignConfig(algo="swg", read_size=48, max_score=60, match=0,
                        mismatch=7, gap_o=2, gap_e=3, variant="hbm",
                        backtrace=True)
    out += [("retry_nw_R112_p2_bt", nw1, e10, 2, False),
            ("retry_nw_R112_p2_nobt", nw1.replace(backtrace=False), e10, 2,
             False),
            ("retry_swg_int16_R48_p2_bt", swg48, fuzz_batch(48), 2, False)]
    return out


def plain_long(args, cfg, planes, packed):
    """The plain versions of K6 and K7 on the card: (meta, codes, ism,
    records)."""
    from aim_tpu_torch.ops import nwswg_long as L
    meta, codes, ism = L.nwswg_long_fwd_reference(*args, cfg=cfg,
                                                  packed=packed,
                                                  planes=planes)
    if cfg.backtrace:
        rec = L.nwswg_long_walk_reference(codes, ism, meta, args[2], args[3],
                                          cfg=cfg, planes=planes)
    else:
        rec = L.score_only_records(meta, L.runs_lanes_long(cfg))
    return meta, codes, ism, rec


def kernel_long(args, cfg, planes, packed):
    """K6 then (with backtrace) K7 on the card: (meta, codes, ism,
    records)."""
    from aim_tpu_torch.ops import nwswg_long as L
    meta, codes, ism, rec = L.launch_forward(*args, cfg=cfg, packed=packed,
                                             planes=planes)
    if cfg.backtrace:
        L.launch_walk(codes, ism, meta, args[2], args[3], rec, cfg=cfg,
                      planes=planes)
    return meta, codes, ism, rec


def rows_differ(a, b):
    return int((a != b).reshape(a.shape[0], -1).any(1).sum())


def code_rows_err(got, want, tlens):
    """Max |difference| of the code bytes over each pair's rows < tlen
    (rows past it are never written by K6 nor read by K7)."""
    live = (torch.arange(got.shape[1], device=got.device)[None, :]
            < tlens[:, None].long())[:, :, None]
    d = (got.int() - want.int()).abs() * live
    return int(d.max()) if d.numel() else 0


def phase_stream_kernel():
    """K6 and K7 against their plain versions and the oracle; returns
    {"nwswg_long_fwd": max_abs_err, "nwswg_long_walk": max_abs_err}."""
    from aim_tpu_torch import native
    from aim_tpu_torch.ops import nwswg_long as L
    from aim_tpu_torch.ops.common import pack_seqs, to_device_batch
    err = {"nwswg_long_fwd": 0, "nwswg_long_walk": 0}
    for name, cfg, (p, t, pl, tl), planes, packed in stream_configs():
        up_p, up_t = p, t
        if packed:
            up_p, up_t, ok = pack_seqs(p, t, pl, tl, cfg.read_size)
            if not ok:
                fail(f"{name}: the batch does not pack")
        args = to_device_batch(up_p, up_t, pl, tl, DEVICE)
        t0 = time.perf_counter()
        got = kernel_long(args, cfg, planes, packed)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = plain_long(args, cfg, planes, packed)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        # the wrapper the main path calls: its checks, its choice of K7
        before = (L.launch_count, L.walk_launch_count)
        wrapped = L.nwswg_forward_long(*args, cfg=cfg, packed=packed,
                                       planes=planes)
        torch.cuda.synchronize()
        if (L.launch_count - before[0], L.walk_launch_count - before[1]) \
                != (1, int(cfg.backtrace)):
            fail(f"{name}: the wrapper's launches were not K6 + K7")
        e6 = int((got[0].long() - want[0].long()).abs().max())
        rows6 = rows_differ(got[0], want[0])
        if cfg.backtrace:
            e6 = max(e6, code_rows_err(got[1], want[1], args[3]),
                     code_rows_err(got[2], want[2], args[3]))
        rec, ref = got[3].cpu().numpy(), want[3].cpu().numpy()
        wrapped = wrapped.cpu().numpy()
        e7 = int(max(np.abs(rec.astype(np.int64) - ref).max(),
                     np.abs(wrapped.astype(np.int64) - ref).max()))
        rows7 = int((rec != ref).any(1).sum())
        rows_w = int((wrapped != ref).any(1).sum())
        err["nwswg_long_fwd"] = max(err["nwswg_long_fwd"], e6)
        err["nwswg_long_walk"] = max(err["nwswg_long_walk"], e7)
        lane0 = rec[:, 0].astype(np.int32)
        flagged = ((lane0 >> 8) & 1).astype(bool)
        ok = ~flagged
        sc = rec[:, 1].astype(np.int32)
        # the NW oracle keeps the reference's int16 cells over the whole
        # table, which wrap once (R+1) x a gap cost passes 32767 (10 kbp
        # at gap 4); the band's live cells do not, so it is not compared
        checked = cfg.algo != "nw" or \
            (cfg.read_size + 1) * max(cfg.gap_i, cfg.gap_d) <= 32767
        score_bad = cigar_bad = 0
        if checked:
            osc, oops, ob, oe = oracle_align(p, t, pl, tl, cfg, threads=0)
            score_bad = int((sc[ok] != osc[ok]).sum())
        if checked and cfg.backtrace:
            ops, b, e = native.wfa_runs_to_ops(rec, sc, pl, tl,
                                               max_score=1 << 30,
                                               max_ops=2 * cfg.read_size)
            cigar_bad = sum(ops[i, b[i]:e[i]].tobytes()
                            != oops[i, ob[i]:oe[i]].tobytes()
                            for i in np.nonzero(ok)[0])
        emit({"phase": "kernel", "kernel": "nwswg_long", "config": name,
              "algo": cfg.algo, "pairs": len(pl), "read_size": cfg.read_size,
              "max_score": cfg.max_score, "planes": planes,
              "C": L.band_c(planes), "NRL": rec.shape[1],
              "backtrace": cfg.backtrace, "packed": packed,
              "flagged": int(flagged.sum()),
              "cursor_hi_pairs": int(((lane0 >> 10) > 0).sum()),
              "oracle_checked": checked,
              "meta_rows_differ": rows6, "record_rows_differ": rows7,
              "wrapper_rows_differ": rows_w,
              "k6_max_abs_err": e6, "k7_max_abs_err": e7,
              "score_bad": score_bad, "cigar_bad": cigar_bad,
              "kernel_s": t_kernel, "plain_s": t_plain})
        if rows6 or rows7 or rows_w or e6 or score_bad or cigar_bad:
            fail(f"{name}: kernel disagrees")
        if name.startswith("retry_nw") and flagged.all():
            fail(f"{name}: expected pairs certified at two planes")
        if name.startswith("case_swg_wide") and flagged.sum() < 5:
            fail(f"{name}: expected the band and alias flags")
        if name == "swg_wrap_R1040_p2" and not 0 < flagged.sum() < len(pl):
            fail(f"{name}: expected some pairs past the wrap bound")
        if "nrl1024" in name and rec.shape[1] != 1024:
            fail(f"{name}: expected 1024-lane records")
    err["nwswg_long_walk"] = max(err["nwswg_long_walk"],
                                 phase_genasm_long_kernel())
    return err


def phase_genasm_long_kernel():
    """The GenASM long tier at k in each of its plane bands: K6/K7 and the
    device rewrite against the plain versions and the GenASM oracle."""
    from aim_tpu_torch import datagen
    from aim_tpu_torch.config import AlignConfig
    from aim_tpu_torch.ops import genasm_long as G
    from aim_tpu_torch.ops.common import pack_seqs, to_device_batch
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_cases import genasm_long_case
    k300 = AlignConfig(algo="genasm", read_size=2048, max_score=300,
                       backtrace=True)
    configs = [(c, genasm_long_case(c)) for c in ("k40_r576", "k160_r640")]
    configs.append(("k300_r2048", (k300, *datagen.generate_pairs(
        256, 2000, 0.1, read_size=2048, seed=SEED))))
    max_err = 0
    for name, (cfg, p, t, pl, tl) in configs:
        up_p, up_t, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
        args = to_device_batch(up_p, up_t, pl, tl, DEVICE)
        planes = G._npl(cfg)
        got = G.genasm_forward_long(*args, cfg=cfg, packed=packed)
        want = G.overflow_rewrite(
            plain_long(args, G._nw_cfg(cfg), planes, packed)[3], args[2],
            args[3], cfg=cfg)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        err = int(np.abs(got.astype(np.int64) - want).max())
        max_err = max(max_err, err)
        rows = int((got != want).any(1).sum())
        flagged = ((got[:, 0].astype(np.int32) >> 8) & 1).astype(bool)
        sc = got[:, 1].astype(np.int32)
        osc = oracle_align(p, t, pl, tl, cfg, threads=0)[0]
        score_bad = int((sc[~flagged] != osc[~flagged]).sum())
        over = int(((sc > cfg.max_score) & ~flagged).sum())
        emit({"phase": "kernel", "kernel": "genasm_long", "config": name,
              "pairs": len(pl), "read_size": cfg.read_size,
              "max_score": cfg.max_score, "planes": planes,
              "packed": packed, "flagged": int(flagged.sum()),
              "overflow_pairs": over, "record_rows_differ": rows,
              "max_abs_err": err, "score_bad": score_bad})
        if rows or score_bad:
            fail(f"{name}: the GenASM long tier disagrees")
    return max_err


def read_device_log(path):
    """The fields of a device log's first line (a sharded run writes the
    same fields on one line a device)."""
    with open(path) as f:
        fields = f.readline().split("|", 1)[1].split()
    return dict(f.split("=", 1) for f in fields)


def launch_counters():
    """{kernel: (module, counter attribute)} of every kernel of the CLI's
    tiers, and the call counters of the dense tiers (which launch no kernel
    of their own)."""
    from aim_tpu_torch.ops import (genasm, nw, nw_xla, nwswg_long, swg,
                                   swg_xla, wfa2, wfa_long, wfa_xla)
    return {"wfa": (wfa2, "launch_count"), "nw": (nw, "launch_count"),
            "swg": (swg, "launch_count"),
            "genasm": (genasm, "launch_count"),
            "wfa_long": (wfa_long, "launch_count"),
            "nwswg_long_fwd": (nwswg_long, "launch_count"),
            "nwswg_long_walk": (nwswg_long, "walk_launch_count"),
            "dense_nw": (nw_xla, "call_count"),
            "dense_swg": (swg_xla, "call_count"),
            "dense_wfa": (wfa_xla, "call_count")}


def counted(call, env=None):
    """``call()`` under ``env`` with every launch counter set to 0 just
    before it; returns (its value, wall s, {kernel: launches})."""
    mods = launch_counters()
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    for mod, attr in mods.values():
        setattr(mod, attr, 0)
    try:
        t0 = time.perf_counter()
        value = call()
        wall = time.perf_counter() - t0
        launches = {k: getattr(mod, attr) for k, (mod, attr) in mods.items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return value, wall, launches


def run_cli(argv, out, log, env=None, quiet=True):
    """One CLI run with every launch counter set to 0 just before it;
    returns (wall s, {kernel: launches}, device log)."""
    from aim_tpu_torch import cli
    rc, wall, launches = counted(
        lambda: cli.main(argv + ["-o", out, "--device-log", log]
                         + (["-q"] if quiet else [])), env)
    if rc != 0:
        fail(f"cli {argv} returned {rc}")
    return wall, launches, read_device_log(log)


def oracle_align(p, t, pl, tl, cfg, threads):
    from aim_tpu_torch import native
    if cfg.algo == "genasm":
        return native.genasm_align(p, t, pl, tl, max_score=cfg.max_score,
                                   backtrace=cfg.backtrace, threads=threads)
    if cfg.algo == "wfa":
        return native.wfa_align(
            p, t, pl, tl, mismatch=cfg.mismatch, gap_o=cfg.gap_o,
            gap_e=cfg.gap_e, max_score=cfg.max_score, adaptive=cfg.adaptive,
            backtrace=cfg.backtrace, threads=threads)
    if cfg.algo == "nw":
        return native.nw_align(p, t, pl, tl, mismatch=cfg.mismatch,
                               gap_i=cfg.gap_i, gap_d=cfg.gap_d,
                               backtrace=cfg.backtrace, threads=threads)
    return native.swg_align(p, t, pl, tl, match=cfg.match,
                            mismatch=cfg.mismatch, gap_o=cfg.gap_o,
                            gap_e=cfg.gap_e, max_score=cfg.max_score,
                            cell_width=cfg.cell_width,
                            backtrace=cfg.backtrace, threads=threads)


def oracle_file(path, inp, n, cfg, threads=0):
    from aim_tpu_torch import native
    t0 = time.perf_counter()
    p, t, pl, tl = native.parse_pairs(inp, n, cfg.read_size, threads=0)
    t1 = time.perf_counter()
    sc, ops, b, e = oracle_align(p, t, pl, tl, cfg, threads)
    t2 = time.perf_counter()
    native.emit_output(path, np.arange(len(sc), dtype=np.int32), sc, ops, b,
                       e, cfg.backtrace)
    return len(sc), t2 - t1, time.perf_counter() - t0, (p, t, pl, tl)


MAIN_RUNS = [("wfa", ["-b", "-r"]), ("nw", ["-b"]), ("nw", []),
             ("swg", ["-b"]), ("swg", []), ("genasm", ["-b"]),
             ("genasm", [])]
SAMPLE_RUNS = [("wfa", f) for f in (["-b"], ["-b", "-r"], ["-r"])] + \
    MAIN_RUNS[1:]
LONG_RUNS = [(LONG_PAIRS, ["-b", "-r"]), (1_024, ["-b"])]
# (algo, flags, input, pairs, env) of the 4 kbp streamed-tier runs: the
# 4,096-pair file at e = 1 %, and for the ladder a file of pairs at 1, 2.5
# and 3.5 %, run at -e 0.03 with the primary band at C = 63, so that
# stages 2, 4 and 8 each have pairs to certify (SWG scores near 170, 430
# and 600: inside the envelopes of C = 127, 255 and 511)
STREAM_RUNS = [
    ("nw", ["-e", "0.01", "-b", "--variant", "hbm"], "4k", STREAM_PAIRS, {}),
    ("nw", ["-e", "0.01", "--variant", "hbm"], "4k", STREAM_PAIRS, {}),
    ("swg", ["-e", "0.01", "-b", "--variant", "hbm"], "4k", STREAM_SWG_PAIRS,
     {}),
    ("swg", ["-e", "0.03", "-b", "--variant", "hbm"], "4k_mixed",
     len(LADDER_ERRORS) * LADDER_PAIRS_EACH, {"AIM_TPU_ROUTE": "0"}),
    ("genasm", ["-e", "0.01", "-b"], "4k", STREAM_PAIRS, {})]
STREAM_KERNELS = ("nwswg_long_fwd", "nwswg_long_walk")


def ladder_stages(log):
    """{planes: pairs certified} from a device log."""
    if log.get("retry_by_planes", "-") == "-":
        return {}
    return {int(p): int(k) for p, k in
            (item.split(":") for item in log["retry_by_planes"].split(","))}


def phase_main(smi, tmp):
    """Every CLI run, its files in ``tmp``; returns {kernel: launches in its
    canonical run} (the 1M-pair `-b` run at 100 bp, the 8,192-pair `-b -r`
    run at 10 kbp, the `nw -b` run at 4 kbp) and {argv: (output file,
    oracle file)}.  The main path's input and its oracle output stay in
    ``tmp`` as MAIN_INPUT and MAIN_ORACLE."""
    from aim_tpu_torch import datagen
    from aim_tpu_torch.cli import build_parser, config_from_args
    gpu = torch.cuda.get_device_name(0)
    main_launches, files = {}, {}
    inp = os.path.join(tmp, MAIN_INPUT)
    t0 = time.perf_counter()
    datagen.write_pair_file(inp, MAIN_PAIRS, 100, 0.01, seed=SEED)
    t_gen = time.perf_counter() - t0
    inp_long = os.path.join(tmp, "pairs_10k.txt")
    t0 = time.perf_counter()
    datagen.write_pair_file(inp_long, LONG_PAIRS, 10000, 0.01, seed=SEED)
    t_gen_long = time.perf_counter() - t0
    inp_4k = {"4k": os.path.join(tmp, "pairs_4k.txt"),
              "4k_mixed": os.path.join(tmp, "pairs_4k_mixed.txt")}
    t0 = time.perf_counter()
    datagen.write_pair_file(inp_4k["4k"], STREAM_PAIRS, 4096, 0.01,
                            seed=SEED)
    t_gen_4k = time.perf_counter() - t0
    inp_e10 = os.path.join(tmp, "pairs_e10.txt")
    datagen.write_pair_file(inp_e10, LADDER_100_PAIRS, 100, 0.1,
                            seed=SEED + 6)
    half = os.path.join(tmp, "half.txt")
    with open(inp_4k["4k_mixed"], "wb") as out:
        for err in LADDER_ERRORS:
            datagen.write_pair_file(half, LADDER_PAIRS_EACH, 4096, err,
                                    seed=SEED + 5)
            with open(half, "rb") as f:
                out.write(f.read())
    hundred = ["-l", "100", "-e", "0.01"]
    long_ = ["-l", "10000", "-e", "0.01", "--variant", "hbm"]
    runs = [(inp, MAIN_PAIRS, a, hundred + f, (a,), "datagen", t_gen, {})
            for a, f in MAIN_RUNS] + \
        [(SAMPLE, 1000, a, hundred + f, (a,), "sample-l100-e1-2K", None,
          {}) for a, f in SAMPLE_RUNS] + \
        [(inp_long, n, "wfa", long_ + f, ("wfa_long",), "datagen-10kbp",
          t_gen_long if n == LONG_PAIRS else None, {})
         for n, f in LONG_RUNS] + \
        [(inp_4k[src], n, a, ["-l", "4096"] + f,
          STREAM_KERNELS if "-b" in f else STREAM_KERNELS[:1],
          "datagen-4kbp", t_gen_4k if src == "4k" else None, env)
         for a, f, src, n, env in STREAM_RUNS] + \
        [(inp_e10, LADDER_100_PAIRS, "nw", hundred + f,
          ("nw",) + (STREAM_KERNELS if "-b" in f else STREAM_KERNELS[:1]),
          LADDER_100_LABEL, None, {}) for f in (["-b"], [])]
    # t_src: the generation time, on the runs over a whole generated
    # file; their `-b` runs get the one-thread oracle rate
    for i, (src, n, algo, flags, kerns, label, t_src, env) in \
            enumerate(runs):
        argv = [algo, "-i", src, "-n", str(n)] + flags
        cfg = config_from_args(build_parser().parse_args(argv))
        out = os.path.join(tmp, f"port{i}")
        ref = os.path.join(tmp, f"oracle{i}")
        wall, launches, log = run_cli(argv, out, os.path.join(tmp, "log"),
                                      env)
        n_done, t_mt, t_file, batch = oracle_file(ref, src, n, cfg)
        same = filecmp.cmp(out, ref, shallow=False)
        files[" ".join(argv)] = (out, ref)
        kern = kerns[0]
        stages = ladder_stages(log)
        row = {"phase": "main", "input": label, "argv": " ".join(argv),
               "env": env, "kernel": kern, "pairs": n_done,
               "launches": launches[kern], "launches_all": launches,
               "fallback": int(log["fallback"]),
               "retry": int(log["retry"]),
               "retry_stages": stages,
               "t_load_s": float(log["load_s"]),
               "t_kernel_s": float(log["kernel_s"]),
               "t_retrieve_s": float(log["retrieve_s"]),
               "e2e_s": wall, "e2e_pairs_s": n_done / wall,
               "device_phase_pairs_s": n_done / (
                   float(log["load_s"]) + float(log["kernel_s"])
                   + float(log["retrieve_s"])),
               "oracle_mt_s": t_mt,
               "oracle_mt_pairs_s": n_done / t_mt,
               "oracle_mt_file_pairs_s": n_done / t_file,
               "cmp_equal": same, "gpu": gpu, "nvidia_smi": smi}
        if t_src is not None and "-b" in flags:
            # one thread on the first ORACLE_1T_PAIRS pairs (a rate per
            # pair; NW and SWG take ~26 s a million on one core), on
            # 64 pairs at 4 kbp
            k1 = ORACLE_1T_PAIRS if label != "datagen-4kbp" else 64
            p, t, pl, tl = (a[:k1] for a in batch)
            t1 = time.perf_counter()
            oracle_align(p, t, pl, tl, cfg, threads=1)
            row["oracle_1t_pairs_s"] = len(pl) / (time.perf_counter()
                                                  - t1)
            row["oracle_1t_pairs"] = len(pl)
            row["host_cpu_cores"] = os.cpu_count()
            row["gen_s"] = t_src
            for k in kerns:
                main_launches.setdefault(k, launches[k])
        emit(row)
        if not same:
            fail(f"{argv}: output differs from the oracle")
        others = sum(v for k, v in launches.items() if k not in kerns)
        flag_ok = int(log["fallback"]) == 0 or label in (
            "datagen-4kbp", LADDER_100_LABEL)
        if not flag_ok or min(launches[k] for k in kerns) <= 0 \
                or others or n_done != n:
            fail(f"{argv}: fallback={log['fallback']} "
                 f"launches={launches} pairs={n_done}")
        if env.get("AIM_TPU_ROUTE") == "0" and set(stages) != {2, 4, 8}:
            fail(f"{argv}: expected ladder stages 2, 4 and 8: {stages}")
        if label == LADDER_100_LABEL and not stages.get(2):
            fail(f"{argv}: expected pairs certified at two planes: "
                 f"{stages}")
    return main_launches, files


# int32 operations a cell or wavefront diagonal, the least each kernel's
# recurrence needs (adds, mins and compares; no address arithmetic); the
# WFA extend adds one 64-bit compare a window of 32 matched bases
CELL_OPS = {"nw": 8, "swg": 14, "genasm_word": 6, "wfa_diag": 10}
WFA_WINDOW_BASES = 32


def bound_ms(nbytes, ops):
    """The least time the card could take: bytes over HBM_BYTES_S or int32
    operations over INT32_OPS_S, whichever is larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def wfa_ops(stats):
    """int32 operations of a WFA forward over the live cells its plain
    version's level extents held (``wfa2.wfa_records`` stats): the
    recurrence on each live (level, diagonal) cell and a compare a window
    of matched bases."""
    return (CELL_OPS["wfa_diag"] * stats["live_cells"]
            + stats["ext_bases"] // WFA_WINDOW_BASES)


def chunk_bound(name, cfg, args, rec, stats=None):
    """(bound ms, bound_by, bytes, ops) of one kernel call on this chunk:
    each input read once, each output written once, and the recurrence's
    int32 operations over the cells this data needs (for WFA, from the
    plain version's ``stats`` on the same chunk; without them the bound is
    the bytes' alone and ops is None)."""
    from aim_tpu_torch.ops import nw, nwswg_long as L
    pl = args[2].cpu().numpy().astype(np.int64)
    tl = args[3].cpu().numpy().astype(np.int64)
    n = len(pl)
    inputs = 2 * n * args[0].shape[1] + 8 * n
    out = rec.numel() * rec.element_size()
    if name in ("wfa", "wfa_long"):
        ops = wfa_ops(stats) if stats is not None else None
    elif name in ("nw", "swg"):
        B = 2 * nw.band_geometry(cfg)[0] + 1
        ops = CELL_OPS[name] * B * int(tl.sum())
    elif name == "genasm":
        words = -(-(pl + 1) // 32)
        ops = CELL_OPS["genasm_word"] * (cfg.max_score + 1) * int(
            (tl * words).sum())
    elif name == "nwswg_long_fwd":
        planes = L.route_planes(cfg)
        B = 2 * L.band_c(planes) + 1
        ops = CELL_OPS[cfg.algo] * B * int(tl.sum())
        out = 8 * n + (int(tl.sum()) * sum(L.row_bytes(cfg, planes))
                       if cfg.backtrace else out)
    else:  # nwswg_long_walk: meta, lengths, one code word and one
        # is-match byte a text row of each walked pair, the records
        flagged = ((rec[:, 0].cpu().numpy().astype(np.int32) >> 8) & 1)
        inputs = 16 * n + 5 * int(tl[flagged == 0].sum())
        ops = 0
    ms, by = bound_ms(inputs + out, ops or 0)
    return ms, by, inputs + out, ops


def phase_timing(reps=20):
    """Each kernel against its plain version on one chunk of its canonical
    config: 16384 pairs at 100 bp, LONG_TIMING_PAIRS at 10 kbp,
    STREAM_TIMING_PAIRS at 4 kbp for K6 and K7; returns {kernel: (kernel ms,
    plain ms, err, bound ms, bound_by)}."""
    from aim_tpu_torch import datagen
    from aim_tpu_torch.config import derive_config
    from aim_tpu_torch.ops import genasm, nw, nwswg_long, swg, wfa2, wfa_long
    from aim_tpu_torch.ops.common import pack_seqs, to_device_batch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    gpu = torch.cuda.get_device_name(0)

    def timed(fn, n, warm=True):
        if warm:
            fn()
        torch.cuda.synchronize()
        # the stream spins while the host enqueues the n calls, so that a
        # kernel shorter than its wrapper's host work is timed on the card
        # and not at the host's pace
        torch.cuda._sleep(SPIN_CYCLES_PER_CALL * n)
        ev[0].record()
        for _ in range(n):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / n

    def cfg_of(algo, length, **kw):
        return derive_config(algo, length, 0.01, backtrace=True, **kw)

    def report(name, cfg, length, flags, n, k_ms, p_ms, k_reps, err, bnd,
               info=None):
        emit({"phase": "timing", "kernel": name,
              "config": f"{cfg.algo} -l {length} -e 0.01 {flags}"
                        f" (R{cfg.read_size} smax{cfg.max_score})",
              "pairs": n, "kernel_ms": k_ms, "plain_ms": p_ms,
              "kernel_reps": k_reps, "max_abs_err": err,
              "bound_ms": bnd[0], "bound_by": bnd[1], "bound_bytes": bnd[2],
              "bound_int32_ops": bnd[3], **(info or {}), "gpu": gpu})
        if err:
            fail(f"{name}: {n}-pair chunk: kernel disagrees with the "
                 "plain version")

    out = {}
    for name, cfg, fwd, ref, n, flags in (
            ("wfa", cfg_of("wfa", 100, adaptive=True), wfa2.wfa_forward2,
             wfa2.wfa2_reference, 16384, "-b -r"),
            ("nw", cfg_of("nw", 100), nw.nw_forward, nw.nw_reference, 16384,
             "-b"),
            ("swg", cfg_of("swg", 100), swg.swg_forward, swg.swg_reference,
             16384, "-b"),
            ("genasm", cfg_of("genasm", 100), genasm.genasm_forward,
             genasm.genasm_reference, 16384, "-b"),
            ("wfa_long", cfg_of("wfa", 10000, adaptive=True, variant="hbm"),
             wfa_long.wfa_forward_long, wfa_long.wfa_long_reference,
             LONG_TIMING_PAIRS, "-b -r --variant hbm")):
        length = 10000 if name == "wfa_long" else 100
        p, t, pl, tl = datagen.generate_pairs(n, length, 0.01,
                                              read_size=cfg.read_size,
                                              seed=SEED + 1)
        pp, pt, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
        args = to_device_batch(pp, pt, pl, tl, DEVICE)
        k_reps = reps if length == 100 else 5
        k_ms = timed(lambda: fwd(*args, cfg=cfg, packed=packed), k_reps)
        # the plain version at 10 kbp takes tens of seconds: one call
        p_ms = timed(lambda: ref(*args, cfg=cfg, packed=packed),
                     2 if length == 100 else 1, warm=length == 100)
        # the same chunk, the CLI's launch shape: kernel against plain;
        # the WFA plain versions also count the live cells
        rec = fwd(*args, cfg=cfg, packed=packed)
        got = rec.cpu().numpy()
        stats = {} if name in ("wfa", "wfa_long") else None
        kw = {"stats": stats} if stats is not None else {}
        want = ref(*args, cfg=cfg, packed=packed, **kw).cpu().numpy()
        err = int(np.abs(got.astype(np.int64) - want).max())
        bnd = chunk_bound(name, cfg, args, rec, stats)
        # the redesigned kernels' registers, spills, shared memory and
        # resident blocks an SM, pairs a warp (CUDA's function attributes)
        info = {"nw": nw, "swg": swg, "genasm": genasm, "wfa": wfa2,
                "wfa_long": wfa_long}.get(name)
        info = info.kernel_info(cfg) if info else {}
        if stats is not None:
            # the WFA bound's operations, counted two ways: over the live
            # cells (the bound) and, as the bound once counted them, over
            # every diagonal of every level a pair reaches, (score+1)^2 a
            # pair
            s_ = np.minimum(got[:, cfg.max_score + 3].astype(np.int64),
                            cfg.max_score)
            info.update(live_cells=stats["live_cells"],
                        ext_bases=stats["ext_bases"],
                        ops_all_diagonals=CELL_OPS["wfa_diag"]
                        * int(((s_ + 1) ** 2).sum()))
        report(name, cfg, length, flags, len(pl), k_ms, p_ms, k_reps, err,
               bnd, info)
        out[name] = (k_ms, p_ms, err) + bnd[:2]
        if name == "wfa_long":
            # K5 on the chunk the 10 kbp CLI run launches: its LONG_PAIRS
            # pairs in the CLI's difficulty order, kernel only (the plain
            # version would take minutes; the run's output is cmp-checked
            # against the oracle in phase 3), the bound its bytes'
            from aim_tpu_torch.api import _difficulty_order
            p, t, pl, tl = datagen.generate_pairs(LONG_PAIRS, length, 0.01,
                                                  read_size=cfg.read_size,
                                                  seed=SEED)
            o = _difficulty_order(p, t, pl, tl)
            pp, pt, packed = pack_seqs(p[o], t[o], pl[o], tl[o],
                                       cfg.read_size)
            big = to_device_batch(pp, pt, pl[o], tl[o], DEVICE)
            k_ms = timed(lambda: fwd(*big, cfg=cfg, packed=packed), 5)
            rec = fwd(*big, cfg=cfg, packed=packed)
            report(name, cfg, length, flags, LONG_PAIRS, k_ms, None, 5,
                   None, chunk_bound(name, cfg, big, rec),
                   wfa_long.kernel_info(cfg, packed))
            del big, rec

    # K6 and K7 apart, on the streamed tier's canonical chunk: 4096 pairs of
    # `nw -l 4096 -e 0.01 -b --variant hbm`, at its routed plane count
    cfg = cfg_of("nw", 4096, variant="hbm")
    planes = nwswg_long.route_planes(cfg)
    p, t, pl, tl = datagen.generate_pairs(STREAM_TIMING_PAIRS, 4096, 0.01,
                                          read_size=cfg.read_size,
                                          seed=SEED + 1)
    pp, pt, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
    args = to_device_batch(pp, pt, pl, tl, DEVICE)
    fwd_out = kernel_long(args, cfg, planes, packed)
    meta, codes, ism, rec = fwd_out
    k6_ms = timed(lambda: nwswg_long.launch_forward(
        *args, cfg=cfg, packed=packed, planes=planes), 5)
    k7_ms = timed(lambda: nwswg_long.launch_walk(
        codes, ism, meta, args[2], args[3], rec, cfg=cfg, planes=planes), 5)
    t0 = time.perf_counter()
    pmeta, pcodes, pism = nwswg_long.nwswg_long_fwd_reference(
        *args, cfg=cfg, packed=packed, planes=planes)
    torch.cuda.synchronize()
    p6_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    prec = nwswg_long.nwswg_long_walk_reference(
        pcodes, pism, pmeta, args[2], args[3], cfg=cfg, planes=planes)
    torch.cuda.synchronize()
    p7_ms = (time.perf_counter() - t0) * 1e3
    e6 = max(int((meta.long() - pmeta.long()).abs().max()),
             code_rows_err(codes, pcodes, args[3]),
             code_rows_err(ism, pism, args[3]))
    e7 = int((rec.long() - prec.long()).abs().max())
    flags = "-b --variant hbm"
    k6_info = nwswg_long.kernel_info(cfg, planes)
    k7_info = nwswg_long.kernel_info(cfg, planes, walk=True)
    for name, k_ms, p_ms, err, r in (("nwswg_long_fwd", k6_ms, p6_ms, e6,
                                      rec),
                                     ("nwswg_long_walk", k7_ms, p7_ms, e7,
                                      rec)):
        bnd = chunk_bound(name, cfg, args, r)
        report(name, cfg, 4096, flags, STREAM_TIMING_PAIRS, k_ms, p_ms, 5,
               err, bnd, k6_info if name == "nwswg_long_fwd" else k7_info)
        out[name] = (k_ms, p_ms, err) + bnd[:2]
    # K7 on the SWG chunk too (`swg -l 4096 -e 0.01 -b --variant hbm`, its
    # routed planes): K6's code rows from the kernel, K7 against the plain
    # walk on them
    scfg = cfg_of("swg", 4096, variant="hbm")
    splanes = nwswg_long.route_planes(scfg)
    p, t, pl, tl = datagen.generate_pairs(STREAM_TIMING_PAIRS, 4096, 0.01,
                                          read_size=scfg.read_size,
                                          seed=SEED + 1)
    pp, pt, spacked = pack_seqs(p, t, pl, tl, scfg.read_size)
    sargs = to_device_batch(pp, pt, pl, tl, DEVICE)
    smeta, scodes, sism, srec = kernel_long(sargs, scfg, splanes, spacked)
    sk7_ms = timed(lambda: nwswg_long.launch_walk(
        scodes, sism, smeta, sargs[2], sargs[3], srec, cfg=scfg,
        planes=splanes), 5)
    t0 = time.perf_counter()
    sprec = nwswg_long.nwswg_long_walk_reference(
        scodes, sism, smeta, sargs[2], sargs[3], cfg=scfg, planes=splanes)
    torch.cuda.synchronize()
    sp7_ms = (time.perf_counter() - t0) * 1e3
    report("nwswg_long_walk", scfg, 4096, flags, STREAM_TIMING_PAIRS, sk7_ms,
           sp7_ms, 5, int((srec.long() - sprec.long()).abs().max()),
           chunk_bound("nwswg_long_walk", scfg, sargs, srec),
           nwswg_long.kernel_info(scfg, splanes, walk=True))
    del scodes, sism, sprec
    # K6 on the first STREAM_PAIRS of the chunk too, the 4 kbp CLI runs'
    # size (a quarter wave): latency, where the full chunk shows throughput
    small = tuple(a[:STREAM_PAIRS] for a in args)
    k6s_ms = timed(lambda: nwswg_long.launch_forward(
        *small, cfg=cfg, packed=packed, planes=planes), 5)
    got = nwswg_long.launch_forward(*small, cfg=cfg, packed=packed,
                                    planes=planes)
    e6s = max(int((got[0].long() - pmeta[:STREAM_PAIRS].long()).abs().max()),
              code_rows_err(got[1], pcodes[:STREAM_PAIRS], small[3]),
              code_rows_err(got[2], pism[:STREAM_PAIRS], small[3]))
    bnd = chunk_bound("nwswg_long_fwd", cfg, small, rec[:STREAM_PAIRS])
    report("nwswg_long_fwd", cfg, 4096, flags, STREAM_PAIRS, k6s_ms, None, 5,
           e6s, bnd, k6_info)
    return out


def phase_probes(smi):
    """The tooling path of M1 and M2: `aim_tpu_torch.tools.microbench`
    drives every probe with its launch counter at 0 (it holds each byte-equal
    to its plain version at both rep counts, then times it).  Returns
    {probe: its row}."""
    from aim_tpu_torch.ops import probes
    from aim_tpu_torch.tools import microbench
    gpu = torch.cuda.get_device_name(0)
    probes.reset_launch_count()
    rows = microbench.run(device=DEVICE, out=lambda line: print(
        line, flush=True))
    launches = dict(probes.launch_counts)
    out = {}
    for m in rows:
        name = m["probe"]
        args = probes.inputs(name, DEVICE)
        nbytes = sum(a.numel() * a.element_size() for a in args) + \
            probes.elements(name) * args[0].element_size()
        ops = probes.elements(name) * probes.PROBES[name].ops_per_rep * \
            microbench.REPS_HI
        b_ms, b_by = bound_ms(nbytes, ops)
        m.update(phase="probes", launches=launches[name], bound_ms=b_ms,
                 bound_by=b_by, gpu=gpu, nvidia_smi=smi)
        emit(m)
        if m["max_abs_err"] or launches[name] <= 0:
            fail(f"probe {name}: max_abs_err={m['max_abs_err']} "
                 f"launches={launches[name]}")
        out[name] = m
    if len(out) != len(probes.PROBES):
        fail(f"the microbench drove {len(out)} probes")
    return out


def dense_runs(tmp):
    """(label, input, pairs, argv tail, tier) of the exact-tier CLI runs:
    `--backend xla` on the sample, then configs no kernel admits."""
    from aim_tpu_torch import datagen
    gen = {}
    for key, n, length, err in (("4k_e5", 48, 4096, 0.05),
                                ("2k_e30", 48, 2000, 0.3),
                                ("20k", 4, 20000, 0.01)):
        gen[key] = os.path.join(tmp, f"dense_{key}.txt")
        datagen.write_pair_file(gen[key], n, length, err, seed=SEED + 7)
    hundred = ["-l", "100", "-e", "0.01"]
    xla = ["--backend", "xla"]
    return [
        ("sample-l100-e1-2K", SAMPLE, 1000,
         ["wfa"] + hundred + ["-b", "-r"] + xla, "dense_wfa"),
        ("sample-l100-e1-2K", SAMPLE, 1000, ["nw"] + hundred + ["-b"] + xla,
         "dense_nw"),
        ("sample-l100-e1-2K", SAMPLE, 1000, ["swg"] + hundred + ["-b"] + xla,
         "dense_swg"),
        # a negative match cost: no kernel admits it
        ("sample-l100-e1-2K", SAMPLE, 1000,
         ["swg"] + hundred + ["-m", "-1", "-b"], "dense_swg"),
        # MAX_SCORE 1024, one past K5
        ("datagen-4kbp-e5", gen["4k_e5"], 48,
         ["wfa", "-l", "4096", "-e", "0.05", "-b", "--variant", "hbm"],
         "dense_wfa"),
        # k 1200, past the GenASM long tier's 508: the host tier
        ("datagen-2kbp-e30", gen["2k_e30"], 48,
         ["genasm", "-l", "2000", "-e", "0.3", "-b"], "host"),
        # READ_SIZE 20208, past the streamed tier's 16352
        ("datagen-20kbp", gen["20k"], 4,
         ["nw", "-l", "20000", "-e", "0.01", "-b", "--variant", "hbm"],
         "dense_nw"),
    ]


def phase_dense(smi, tmp):
    """The exact tiers through the CLI: each output `cmp`-equal to the
    oracle's, no hand kernel launched, the dense tier called (the host tier
    runs no device work)."""
    from aim_tpu_torch.cli import build_parser, config_from_args
    from aim_tpu_torch.ops import kernels
    gpu = torch.cuda.get_device_name(0)
    for i, (label, src, n, tail, tier) in enumerate(dense_runs(tmp)):
        argv = tail[:1] + ["-i", src, "-n", str(n)] + tail[1:]
        cfg = config_from_args(build_parser().parse_args(argv))
        name = kernels.forward_fn(cfg).name
        if name != ("host" if tier == "host" else "dense"):
            fail(f"{argv}: served by {name}, not the exact tier")
        out = os.path.join(tmp, f"dense_port{i}")
        ref = os.path.join(tmp, f"dense_oracle{i}")
        wall, launches, log = run_cli(argv, out, os.path.join(tmp, "log"))
        n_done, t_mt, t_file, _ = oracle_file(ref, src, n, cfg)
        same = filecmp.cmp(out, ref, shallow=False)
        others = {k: v for k, v in launches.items() if k != tier and v}
        row = {"phase": "dense", "input": label, "argv": " ".join(argv),
               "tier": tier, "read_size": cfg.read_size,
               "max_score": cfg.max_score, "pairs": n_done,
               "calls": launches.get(tier, 0), "launches_all": launches,
               "fallback": int(log["fallback"]),
               "t_load_s": float(log["load_s"]),
               "t_kernel_s": float(log["kernel_s"]),
               "t_retrieve_s": float(log["retrieve_s"]),
               "e2e_s": wall, "e2e_pairs_s": n_done / wall,
               "oracle_mt_s": t_mt, "oracle_mt_file_pairs_s": n_done / t_file,
               "cmp_equal": same, "gpu": gpu, "nvidia_smi": smi}
        emit(row)
        if not same or others or n_done != n or \
                (tier != "host" and launches[tier] <= 0):
            fail(f"{argv}: cmp_equal={same} launches={launches} "
                 f"pairs={n_done}")
        # the NW oracle's int16 cells wrap past (R+1) x gap 32767: the dense
        # tier flags those pairs (all of them at 20 kbp) to it
        if label == "datagen-20kbp" and int(log["fallback"]) != n:
            fail(f"{argv}: expected every pair flagged to the oracle")


def phase_fuzz():
    """tools.fuzz_kernels on the card: every row of CONFIGS at FUZZ_SEED,
    0 bad pairs."""
    from aim_tpu_torch.tools import fuzz_kernels
    t0 = time.perf_counter()
    total, reports = fuzz_kernels.fuzz([FUZZ_SEED], device=DEVICE,
                                       out=lambda line: None)
    for rep in reports:
        emit({"phase": "fuzz", **rep})
    emit({"phase": "fuzz", "rows": len(reports), "total_bad": total,
          "seconds": time.perf_counter() - t0})
    if total or len(reports) != len(fuzz_kernels.CONFIGS):
        fail(f"fuzz: TOTAL BAD {total} over {len(reports)} rows")


def phase_tools(smi, tmp):
    """`--profile` on the main path's `wfa -b -r` over the sample: a chrome
    trace with kernel events; `--energy` on the 1M-pair main path: the GPU
    joules NVML measured, above 0.  Both outputs `cmp`-equal to the
    oracle's."""
    import contextlib
    import io
    gpu = torch.cuda.get_device_name(0)
    prof = os.path.join(tmp, "profile")
    hundred = ["-l", "100", "-e", "0.01", "-b", "-r"]
    argv = ["wfa", "-i", SAMPLE, "-n", "1000"] + hundred + ["--profile", prof]
    out, ref = os.path.join(tmp, "tools_port"), os.path.join(tmp,
                                                             "tools_oracle")
    from aim_tpu_torch.cli import build_parser, config_from_args
    cfg = config_from_args(build_parser().parse_args(argv))
    _, launches, _ = run_cli(argv, out, os.path.join(tmp, "log"))
    oracle_file(ref, SAMPLE, 1000, cfg)
    trace = os.path.join(prof, "trace.json")
    events = json.load(open(trace))["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kern if "wfa2" in e.get("name", "")]
    row = {"phase": "tools", "tool": "profile", "argv": " ".join(argv),
           "trace_bytes": os.path.getsize(trace), "events": len(events),
           "kernel_events": len(kern), "k1_events": len(k1),
           "k1_launches": launches["wfa"],
           "cmp_equal": filecmp.cmp(out, ref, shallow=False), "gpu": gpu}
    emit(row)
    if not (row["cmp_equal"] and k1 and launches["wfa"] > 0):
        fail(f"--profile: {row}")
    main = os.path.join(tmp, MAIN_INPUT)
    argv = ["wfa", "-i", main, "-n", str(MAIN_PAIRS)] + hundred + \
        ["--energy"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        wall, launches, _ = run_cli(argv, out, os.path.join(tmp, "log"),
                                    quiet=False)
    text = buf.getvalue()
    lines = [ln for ln in text.splitlines() if ln.startswith("GPU Energy")]
    joules = None
    if lines and "not measured" not in lines[0]:
        joules = float(lines[0].rsplit(":", 1)[1])
    row = {"phase": "tools", "tool": "energy", "argv": " ".join(argv),
           "gpu_energy_line": lines[0] if lines else None,
           "gpu_joules": joules,
           "host_energy_line": next((ln for ln in text.splitlines()
                                     if ln.startswith("Host Energy")), None),
           "e2e_s": wall, "launches": launches["wfa"],
           "cmp_equal": filecmp.cmp(out, os.path.join(tmp, MAIN_ORACLE),
                                    shallow=False),
           "gpu": gpu, "nvidia_smi": smi}
    emit(row)
    if not (row["cmp_equal"] and joules is not None and joules > 0):
        fail(f"--energy: {row}")


# phase 9: the shards of an in-process run on cuda:0 (and one a card where
# the host has more than one), the 10 kbp run's pairs, the runner's
# processes
MULTI_SHARDS = 4
MULTI_LONG_PAIRS = 1_024
RUNNER_PROCS = 2


def multi_runs(tmp):
    """(input label, file, pairs, argv, kernel, retry kernels) of phase 9's
    sharded runs."""
    hundred = ["-l", "100", "-e", "0.01"]
    long_ = ["-l", "10000", "-e", "0.01", "-b", "-r", "--variant", "hbm"]
    main = os.path.join(tmp, MAIN_INPUT)
    return ([("datagen", main, MAIN_PAIRS, ["wfa"] + hundred + ["-b", "-r"],
              "wfa", ())]
            + [("sample-l100-e1-2K", SAMPLE, 1000, [a] + hundred + ["-b"], a,
                ()) for a in ("nw", "swg", "genasm")]
            + [("datagen-10kbp", os.path.join(tmp, "pairs_10k.txt"),
                MULTI_LONG_PAIRS, ["wfa"] + long_, "wfa_long", ()),
               (LADDER_100_LABEL, os.path.join(tmp, "pairs_e10.txt"),
                LADDER_100_PAIRS, ["nw"] + hundred + ["-b"], "nw",
                STREAM_KERNELS)])


def ensure_inputs(tmp):
    """The generated inputs phase 3 writes, where it has not run."""
    from aim_tpu_torch import datagen
    for name, n, length, err, seed in (
            (MAIN_INPUT, MAIN_PAIRS, 100, 0.01, SEED),
            ("pairs_10k.txt", LONG_PAIRS, 10000, 0.01, SEED),
            ("pairs_e10.txt", LADDER_100_PAIRS, 100, 0.1, SEED + 6)):
        path = os.path.join(tmp, name)
        if not os.path.exists(path):
            datagen.write_pair_file(path, n, length, err, seed=seed)


def one_device_files(argv, src, n, tmp, files):
    """(one-device output, oracle output) of a run: phase 3's files, or a
    one-device CLI run and the oracle's file made now."""
    from aim_tpu_torch.cli import build_parser, config_from_args
    key = " ".join([argv[0], "-i", src, "-n", str(n)] + argv[1:])
    if key not in files:
        tag = len(files)
        out, ref = (os.path.join(tmp, f"multi_{k}{tag}")
                    for k in ("one", "oracle"))
        full = [argv[0], "-i", src, "-n", str(n)] + argv[1:]
        run_cli(full + ["-d", "1"], out, os.path.join(tmp, "log"))
        oracle_file(ref, src, n, config_from_args(
            build_parser().parse_args(full)))
        files[key] = (out, ref)
    return files[key]


def expected_blocks(cfg, n, devs):
    """The non-empty blocks of an n-pair run over ``devs``: one launch
    each of the run's kernel (DNA inputs pack)."""
    from aim_tpu_torch import api
    bs = api._plan_bs(cfg, n, devs)
    return sum(1 for lo in range(0, n, bs)
               for _ in api._blocks(lo, min(lo + bs, n), bs, devs))


def run_runner(argv, out, store, n_procs):
    """``aim_tpu_torch.parallel.runner`` in ``n_procs`` processes (RANK,
    WORLD_SIZE and a file store); returns (wall s, their outputs)."""
    cmd = [sys.executable, "-m", "aim_tpu_torch.parallel.runner"] + argv + \
        ["-o", out, "-q", "--init-method", f"file://{store}"]
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(env, RANK=str(r),
                                       WORLD_SIZE=str(n_procs)))
             for r in range(n_procs)]
    try:
        texts = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, text in zip(procs, texts):
        if p.returncode != 0:
            fail(f"runner {argv} exited {p.returncode}:\n{text[-4000:]}")
    return wall, texts


def phase_multi(smi, tmp, files):
    """Pair sharding: the sharded runs over each device list, each
    `cmp`-equal to its one-device run and to the oracle, the run's kernel
    launched once a non-empty block (its retry kernels above 0 on the
    ladder input) and no other; the CLI with -d at the card count; the
    runner in RUNNER_PROCS processes on the sample and the main input;
    tools.dryrun_multichip over MULTI_SHARDS shards."""
    import contextlib
    import glob
    import io
    from aim_tpu_torch import api
    from aim_tpu_torch.cli import build_parser, config_from_args
    from aim_tpu_torch.parallel import devices
    from aim_tpu_torch.tools import dryrun_multichip
    gpu = torch.cuda.get_device_name(0)
    n_cards = torch.cuda.device_count()
    ensure_inputs(tmp)
    lists = [devices(1) * MULTI_SHARDS] + ([devices()] if n_cards > 1
                                           else [])
    out, log = os.path.join(tmp, "multi_out"), os.path.join(tmp, "log")
    for label, src, n, argv, kern, retry_kerns in multi_runs(tmp):
        one, ref = one_device_files(argv, src, n, tmp, files)
        cfg = config_from_args(build_parser().parse_args(
            [argv[0], "-i", src] + argv[1:] + ["-n", str(n)]))
        for devs in lists:
            res, wall, launches = counted(lambda: api.align_file(
                src, out, n, cfg, device=devs, verbose=False,
                device_log=log))
            blocks = expected_blocks(cfg, len(res.scores), devs)
            with open(log) as f:
                log_lines = f.read().splitlines()
            others = {k: v for k, v in launches.items()
                      if v and k != kern and k not in retry_kerns}
            row = {"phase": "multi", "input": label,
                   "argv": " ".join(argv), "pairs": len(res.scores),
                   "shards": len(devs),
                   "cards": len({str(d) for d in devs}),
                   "kernel": kern, "launches": launches[kern],
                   "blocks": blocks,
                   "retry_launches": {k: launches[k] for k in retry_kerns},
                   "other_launches": others,
                   "fallback": res.n_fallback, "retry": res.n_retry,
                   "device_log_lines": len(log_lines),
                   "t_load_s": res.t_load, "t_kernel_s": res.t_kernel,
                   "t_retrieve_s": res.t_retrieve, "e2e_s": wall,
                   "cmp_one_device": filecmp.cmp(out, one, shallow=False),
                   "cmp_oracle": filecmp.cmp(out, ref, shallow=False),
                   "gpu": gpu, "nvidia_smi": smi}
            emit(row)
            if not (row["cmp_one_device"] and row["cmp_oracle"]
                    and launches[kern] == blocks and not others
                    and all(launches[k] > 0 for k in retry_kerns)
                    and len(log_lines) == len(devs)
                    and len(res.scores) == n):
                fail(f"sharded {argv} over {len(devs)} shards: {row}")
    # the CLI over every card: -d at the card count
    hundred = ["-l", "100", "-e", "0.01", "-b", "-r"]
    argv = ["wfa", "-i", SAMPLE, "-n", "1000"] + hundred
    one, ref = one_device_files(["wfa"] + hundred, SAMPLE, 1000, tmp, files)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        wall, launches, _ = run_cli(argv + ["-d", str(n_cards)], out, log,
                                    quiet=False)
    text = buf.getvalue().splitlines()
    alloc = [ln for ln in text if ln.startswith(("Allocated",
                                                 "NumReads per device"))]
    want = [f"Allocated {n_cards} device(s)",
            f"NumReads per device = {((1000 // n_cards) + 7) // 8 * 8}"] \
        if n_cards > 1 else []
    blocks = expected_blocks(config_from_args(build_parser().parse_args(
        argv)), 1000, devices())
    row = {"phase": "multi", "tool": "cli", "argv": " ".join(argv + [
        "-d", str(n_cards)]), "cards": n_cards, "lines": alloc,
        "launches": launches["wfa"], "blocks": blocks, "e2e_s": wall,
        "cmp_one_device": filecmp.cmp(out, one, shallow=False),
        "cmp_oracle": filecmp.cmp(out, ref, shallow=False), "gpu": gpu}
    emit(row)
    if not (alloc == want and launches["wfa"] == blocks
            and row["cmp_one_device"] and row["cmp_oracle"]):
        fail(f"cli -d {n_cards}: {row}")
    # the runner: RUNNER_PROCS processes, each on cuda:(rank % cards)
    for label, src, n in (("sample-l100-e1-2K", SAMPLE, 1000),
                          ("datagen", os.path.join(tmp, MAIN_INPUT),
                           MAIN_PAIRS)):
        one, ref = one_device_files(["wfa"] + hundred, src, n, tmp, files)
        argv = ["wfa", "-i", src, "-n", str(n)] + hundred
        joined = os.path.join(tmp, f"runner_{label}")
        wall, _ = run_runner(argv, joined,
                             os.path.join(tmp, f"store_{label}"),
                             RUNNER_PROCS)
        left = glob.glob(joined + ".part*")
        row = {"phase": "multi", "tool": "runner", "input": label,
               "argv": " ".join(argv), "processes": RUNNER_PROCS,
               "devices": [f"cuda:{r % n_cards}"
                           for r in range(RUNNER_PROCS)],
               "wall_s": wall, "parts_left": left,
               "cmp_one_device": filecmp.cmp(joined, one, shallow=False),
               "cmp_oracle": filecmp.cmp(joined, ref, shallow=False),
               "gpu": gpu}
        emit(row)
        if left or not (row["cmp_one_device"] and row["cmp_oracle"]):
            fail(f"runner on {label}: {row}")
    t0 = time.perf_counter()
    for rep in dryrun_multichip.dryrun(MULTI_SHARDS):
        emit({"phase": "multi", "tool": "dryrun_multichip", **rep})
    emit({"phase": "multi", "tool": "dryrun_multichip",
          "seconds": time.perf_counter() - t0})


KERNELS = [("wfa2", "wfa", "aim_tpu_torch/csrc/wfa2.cu",
            "aim_tpu/ops/wfa_pallas2.py:72"),
           ("nw", "nw", "aim_tpu_torch/csrc/nw.cu",
            "aim_tpu/ops/nw_pallas.py:161"),
           ("swg", "swg", "aim_tpu_torch/csrc/swg.cu",
            "aim_tpu/ops/swg_pallas.py:82"),
           ("genasm", "genasm", "aim_tpu_torch/csrc/genasm.cu",
            "aim_tpu/ops/genasm_pallas.py:106"),
           ("wfa_long", "wfa_long", "aim_tpu_torch/csrc/wfa_long.cu",
            "aim_tpu/ops/wfa_pallas_long.py:102"),
           ("nwswg_long_fwd", "nwswg_long_fwd",
            "aim_tpu_torch/csrc/nwswg_long.cu",
            "aim_tpu/ops/nwswg_pallas_long.py:220"),
           ("nwswg_long_walk", "nwswg_long_walk",
            "aim_tpu_torch/csrc/nwswg_long.cu",
            "aim_tpu/ops/nwswg_pallas_long.py:585")]


def phase_bench():
    """`python -m aim_tpu_torch.tools.bench` at its defaults in a process
    of its own (this one keeps its cache of device memory out of the
    bench's memory caps): exit 0 and a complete line, checked here; the
    bench checks the port's scores against the oracles itself."""
    from aim_tpu_torch.ops import nwswg_long, wfa_long
    from aim_tpu_torch.tools import bench
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "aim_tpu_torch.tools.bench"],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=bench.MEASURE_BUDGET + 120)
    wall = time.perf_counter() - t0
    sys.stderr.write(r.stderr)
    lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
    if r.returncode != 0 or not lines:
        fail(f"bench exited {r.returncode}:\n{r.stdout[-2000:]}\n"
             f"{r.stderr[-4000:]}")
    line = json.loads(lines[-1])
    bad = [k for k in ("degraded", "error", "skipped") if k in line]
    missing = [k for k in bench.KEYS if k not in line]
    if bad or missing:
        fail(f"bench line incomplete: has {bad}, lacks {missing}: {line}")
    nonpos = [k for k in bench.POSITIVE if not line[k] > 0]
    if nonpos:
        fail(f"bench: rates or slopes not above 0: {nonpos}: {line}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key, info in (
            ("longread_10kbp_slope_pairs", wfa_long.kernel_info(
                bench.stage_config("K5"), packed=True)),
            ("nw_long_4kbp_slope_pairs", nwswg_long.kernel_info(
                bench.stage_config("K6"), 1))):
        wave = bench.slope_sizes(info, sms, 1 << 40)[0]
        small, large = line[key]
        if small != wave or large % wave or large < 2 * wave:
            fail(f"bench: {key} {line[key]} is not 1 and 2-4 waves of "
                 f"{wave} pairs")
    if line["gpu"] != torch.cuda.get_device_name(0) or \
            not line["power_limit_w"] > 0:
        fail(f"bench: card {line['gpu']!r}, {line['power_limit_w']} W")
    emit({"phase": "bench", "wall_s": wall, **line})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--only", "multi"], ["--only", "bench"]):
        print("usage: chip_smoke.py [--only multi|bench]", file=sys.stderr)
        return 2
    smi = phase_device()
    if argv:
        # phase 9 alone (a host with several cards): it makes the inputs
        # and one-device runs it needs; or phase 10 alone
        if argv[1] == "multi":
            with tempfile.TemporaryDirectory(prefix="aim_chip_smoke_") as tmp:
                phase_multi(smi, tmp, {})
        else:
            phase_bench()
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    max_err = {"wfa": phase_kernel()}
    max_err.update(phase_band_kernels())
    max_err["genasm"] = phase_genasm_kernel()
    max_err["wfa_long"] = phase_long_kernel()
    max_err.update(phase_stream_kernel())
    with tempfile.TemporaryDirectory(prefix="aim_chip_smoke_") as tmp:
        launches, files = phase_main(smi, tmp)
        timing = phase_timing()
        probe_rows = phase_probes(smi)
        phase_dense(smi, tmp)
        phase_fuzz()
        phase_tools(smi, tmp)
        phase_multi(smi, tmp, files)
    phase_bench()
    table = []
    for name, key, src, replaces in KERNELS:
        k_ms, p_ms, err, b_ms, b_by = timing[key]
        # no single PyTorch call computes banded or wavefront alignment
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[key],
                      "max_abs_err": max(max_err[key], err),
                      "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None})
    from aim_tpu_torch.ops import probes
    from aim_tpu_torch.tools.microbench import REPS_HI
    for name, m in probe_rows.items():
        # times of one launch at REPS_HI reps; launches from the microbench
        # run (the tooling path); no PyTorch call computes a probe's chain
        table.append({"name": f"probe_{name}", "route": "cuda",
                      "source": "aim_tpu_torch/csrc/probes.cu",
                      "replaces": "tools/microbench_mosaic.py:"
                                  f"{probes.PROBES[name].tpu_line}",
                      "launches": m["launches"],
                      "max_abs_err": m["max_abs_err"],
                      "ms": m[f"ms_{REPS_HI}"],
                      "plain_ms": m[f"plain_ms_{REPS_HI}"],
                      "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                      "library_ms": None})
    emit({"kernels": table})
    print(smi, flush=True)
    # the smoke needs one card (phase 9 shards over cuda:0 and, where
    # there are more, over every card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
