"""Smoke run of the PyTorch port (aim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero
before the last line:

  1. device   CUDA must be present; card name and power limit from
              nvidia-smi; build the CUDA kernels from csrc/ (timed).
  2. kernel   each kernel against its plain PyTorch version on the card:
              records byte-equal, and the scores/CIGARs of every pair (K1,
              K4, K5) or every unflagged pair (K2 NW, K3 SWG) equal to the
              native oracle.  K1 (csrc/wfa2.cu) on 12 configs, K2
              (csrc/nw.cu) and K3 (csrc/swg.cu) on 14, K4 (csrc/genasm.cu)
              on 12, 4096 seeded pairs each; K5 (csrc/wfa_long.cu) on 8
              long-read configs of 16 to 4096 pairs.
  3. main     the CLI paths: `wfa -l 100 -e 0.01 -b -r` (the main path),
              `nw -b`, `nw`, `swg -b`, `swg`, `genasm -b` and `genasm` at
              the same -l/-e, each on the same 1,000,000 generated pairs;
              `wfa -b`, `-b -r`, `-r` and the six NW/SWG/GenASM runs on
              data/sample-l100-e1-2K; `wfa -l 10000 -e 0.01 -b -r --variant
              hbm` on 8,192 generated pairs and `-b` on the first 1,024.
              Every output file must equal the oracle's byte for byte, with
              0 fallback pairs; every launch counter is set to 0 just
              before each run and read just after, and the run's own kernel
              must have launched and no other.
  4. timing   each kernel vs its plain version on one chunk of its
              canonical config (CUDA events): 16384 pairs at 100 bp, 1024
              pairs at 10 kbp; their records compared once more at this,
              the CLI's launch shape.

The last two lines are the kernel table and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
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
    """(name, cfg, (pats, txts, plens, tlens)) of every K1 check: 4096
    seeded pairs each, made as tools/fuzz_kernels.py makes them
    (tests/util.py) or by aim_tpu.datagen."""
    from aim_tpu import datagen
    from aim_tpu.config import AlignConfig, derive_config

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
    return out


def phase_kernel():
    from aim_tpu import native
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
    from aim_tpu import datagen
    from aim_tpu.config import AlignConfig, derive_config

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
    return out


def phase_band_kernels():
    """K2/K3 against their plain versions; returns {kernel: max_abs_err}."""
    from aim_tpu import native
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
        in_smem = nw.planes_in_smem(cfg, 3 if cfg.algo == "nw"
                                    else swg.N_PLANES)
        emit({"phase": "kernel", "kernel": cfg.algo, "config": name,
              "pairs": len(pl), "read_size": cfg.read_size,
              "max_score": cfg.max_score, "C": C, "L": L, "NRL": NRL,
              "backtrace": cfg.backtrace, "packed": packed,
              "planes_in_smem": in_smem, "flagged": int(flagged.sum()),
              "record_rows_differ": rows, "max_abs_err": err,
              "score_bad": score_bad, "cigar_bad": cigar_bad})
        if rows or score_bad or cigar_bad:
            fail(f"{name}: kernel disagrees")
        if name.endswith("flag_heavy") and flagged.mean() < 0.9:
            fail(f"{name}: expected most pairs flagged")
        if name == "nw_L128_R1120" and (L != 128 or in_smem):
            fail(f"{name}: expected L = 128 with global planes")
    return max_err


def genasm_configs():
    """(name, cfg, (pats, txts, plens, tlens)) of every K4 check, 4096
    seeded pairs each."""
    from aim_tpu import datagen
    from aim_tpu.config import AlignConfig, derive_config
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_cases import GENASM_EDGES
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
    return out


def phase_genasm_kernel():
    """K4 against its plain version and the GenASM oracle."""
    from aim_tpu import native
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
        emit({"phase": "kernel", "kernel": "genasm", "config": name,
              "pairs": len(pl), "read_size": R, "max_score": k,
              "rows": genasm.geom(cfg)[3], "backtrace": cfg.backtrace,
              "hist_in_smem": genasm.hist_in_smem(cfg),
              "overflow_pairs": over, "record_rows_differ": rows,
              "max_abs_err": err, "score_bad": score_bad,
              "cigar_bad": cigar_bad})
        if rows or score_bad or cigar_bad:
            fail(f"{name}: kernel disagrees")
        if "overflow" in name and over < 0.9 * len(pl):
            fail(f"{name}: expected most pairs past k")
        if "k26" in name and genasm.hist_in_smem(cfg):
            fail(f"{name}: expected the global history")
    return max_err


def long_configs():
    """(name, cfg, (pats, txts, plens, tlens)) of every K5 check."""
    from aim_tpu import datagen
    from aim_tpu.config import derive_config
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
    from aim_tpu import native
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


def read_device_log(path):
    fields = open(path).read().split("|", 1)[1].split()
    return dict(f.split("=", 1) for f in fields)


def launch_counters():
    from aim_tpu_torch.ops import genasm, nw, swg, wfa2, wfa_long
    return {"wfa": wfa2, "nw": nw, "swg": swg, "genasm": genasm,
            "wfa_long": wfa_long}


def run_cli(argv, out, log):
    """One CLI run with every launch counter set to 0 just before it;
    returns (wall s, {kernel: launches}, device log)."""
    from aim_tpu_torch import cli
    mods = launch_counters()
    for mod in mods.values():
        mod.reset_launch_count()
    t0 = time.perf_counter()
    rc = cli.main(argv + ["-o", out, "--device-log", log, "-q"])
    wall = time.perf_counter() - t0
    launches = {k: mod.launch_count for k, mod in mods.items()}
    if rc != 0:
        fail(f"cli {argv} returned {rc}")
    return wall, launches, read_device_log(log)


def oracle_align(p, t, pl, tl, cfg, threads):
    from aim_tpu import native
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
    from aim_tpu import native
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


def phase_main(smi):
    """Every CLI run; returns {kernel: launches in its canonical run} (the
    1M-pair `-b` run at 100 bp, the 8,192-pair `-b -r` run at 10 kbp)."""
    from aim_tpu import datagen
    from aim_tpu.cli import build_parser, config_from_args
    gpu = torch.cuda.get_device_name(0)
    main_launches = {}
    with tempfile.TemporaryDirectory(prefix="aim_chip_smoke_") as tmp:
        inp = os.path.join(tmp, "pairs.txt")
        t0 = time.perf_counter()
        datagen.write_pair_file(inp, MAIN_PAIRS, 100, 0.01, seed=SEED)
        t_gen = time.perf_counter() - t0
        inp_long = os.path.join(tmp, "pairs_10k.txt")
        t0 = time.perf_counter()
        datagen.write_pair_file(inp_long, LONG_PAIRS, 10000, 0.01, seed=SEED)
        t_gen_long = time.perf_counter() - t0
        hundred = ["-l", "100", "-e", "0.01"]
        long_ = ["-l", "10000", "-e", "0.01", "--variant", "hbm"]
        runs = [(inp, MAIN_PAIRS, a, hundred + f, a, "datagen", t_gen)
                for a, f in MAIN_RUNS] + \
            [(SAMPLE, 1000, a, hundred + f, a, "sample-l100-e1-2K", None)
             for a, f in SAMPLE_RUNS] + \
            [(inp_long, n, "wfa", long_ + f, "wfa_long", "datagen-10kbp",
              t_gen_long if n == LONG_PAIRS else None)
             for n, f in LONG_RUNS]
        # t_src: the generation time, on the runs over a whole generated
        # file; their `-b` runs get the one-thread oracle rate
        for i, (src, n, algo, flags, kern, label, t_src) in enumerate(runs):
            argv = [algo, "-i", src, "-n", str(n)] + flags
            cfg = config_from_args(build_parser().parse_args(argv))
            out = os.path.join(tmp, f"port{i}")
            ref = os.path.join(tmp, f"oracle{i}")
            wall, launches, log = run_cli(argv, out, os.path.join(tmp, "log"))
            n_done, t_mt, t_file, batch = oracle_file(ref, src, n, cfg)
            same = filecmp.cmp(out, ref, shallow=False)
            row = {"phase": "main", "input": label, "argv": " ".join(argv),
                   "kernel": kern, "pairs": n_done,
                   "launches": launches[kern], "launches_all": launches,
                   "fallback": int(log["fallback"]),
                   "t_load_s": float(log["load_s"]),
                   "t_kernel_s": float(log["kernel_s"]),
                   "t_retrieve_s": float(log["retrieve_s"]),
                   "e2e_s": wall, "e2e_pairs_s": n_done / wall,
                   "device_phase_pairs_s": n_done / (
                       float(log["load_s"]) + float(log["kernel_s"])
                       + float(log["retrieve_s"])),
                   "oracle_mt_pairs_s": n_done / t_mt,
                   "oracle_mt_file_pairs_s": n_done / t_file,
                   "cmp_equal": same, "gpu": gpu, "nvidia_smi": smi}
            if t_src is not None and "-b" in flags:
                # one thread on the first ORACLE_1T_PAIRS pairs (a rate per
                # pair; NW and SWG take ~26 s a million on one core)
                p, t, pl, tl = (a[:ORACLE_1T_PAIRS] for a in batch)
                t1 = time.perf_counter()
                oracle_align(p, t, pl, tl, cfg, threads=1)
                row["oracle_1t_pairs_s"] = len(pl) / (time.perf_counter()
                                                      - t1)
                row["oracle_1t_pairs"] = len(pl)
                row["host_cpu_cores"] = os.cpu_count()
                row["gen_s"] = t_src
                main_launches.setdefault(kern, launches[kern])
            emit(row)
            if not same:
                fail(f"{argv}: output differs from the oracle")
            others = sum(v for k, v in launches.items() if k != kern)
            if int(log["fallback"]) != 0 or launches[kern] <= 0 \
                    or others or n_done != n:
                fail(f"{argv}: fallback={log['fallback']} "
                     f"launches={launches} pairs={n_done}")
    return main_launches


def phase_timing(reps=20):
    """Each kernel against its plain version on one chunk of its canonical
    config: 16384 pairs at 100 bp, LONG_TIMING_PAIRS at 10 kbp; returns
    {kernel: (kernel ms, plain ms, err)}."""
    from aim_tpu import datagen
    from aim_tpu.config import derive_config
    from aim_tpu_torch.ops import genasm, nw, swg, wfa2, wfa_long
    from aim_tpu_torch.ops.common import pack_seqs, to_device_batch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn, n, warm=True):
        if warm:
            fn()
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(n):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / n

    def cfg_of(algo, length, **kw):
        return derive_config(algo, length, 0.01, backtrace=True, **kw)

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
        # the same chunk, the CLI's launch shape: kernel against plain
        got = fwd(*args, cfg=cfg, packed=packed).cpu().numpy()
        want = ref(*args, cfg=cfg, packed=packed).cpu().numpy()
        err = int(np.abs(got.astype(np.int64) - want).max())
        emit({"phase": "timing", "kernel": name,
              "config": f"{cfg.algo} -l {length} -e 0.01 {flags}"
                        f" (R{cfg.read_size} smax{cfg.max_score})",
              "pairs": len(pl), "kernel_ms": k_ms, "plain_ms": p_ms,
              "kernel_reps": k_reps, "max_abs_err": err,
              "gpu": torch.cuda.get_device_name(0)})
        if err:
            fail(f"{name}: {n}-pair chunk: kernel disagrees with the "
                 "plain version")
        out[name] = (k_ms, p_ms, err)
    return out


KERNELS = [("wfa2", "wfa", "aim_tpu_torch/csrc/wfa2.cu",
            "aim_tpu/ops/wfa_pallas2.py:72"),
           ("nw", "nw", "aim_tpu_torch/csrc/nw.cu",
            "aim_tpu/ops/nw_pallas.py:161"),
           ("swg", "swg", "aim_tpu_torch/csrc/swg.cu",
            "aim_tpu/ops/swg_pallas.py:82"),
           ("genasm", "genasm", "aim_tpu_torch/csrc/genasm.cu",
            "aim_tpu/ops/genasm_pallas.py:106"),
           ("wfa_long", "wfa_long", "aim_tpu_torch/csrc/wfa_long.cu",
            "aim_tpu/ops/wfa_pallas_long.py:102")]


def main() -> int:
    smi = phase_device()
    max_err = {"wfa": phase_kernel()}
    max_err.update(phase_band_kernels())
    max_err["genasm"] = phase_genasm_kernel()
    max_err["wfa_long"] = phase_long_kernel()
    launches = phase_main(smi)
    timing = phase_timing()
    table = []
    for name, key, src, replaces in KERNELS:
        k_ms, p_ms, err = timing[key]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[key],
                      "max_abs_err": max(max_err[key], err),
                      "ms": k_ms, "plain_ms": p_ms})
    emit({"kernels": table})
    print(smi, flush=True)
    # the port runs on one device (its CLI caps -d at 1)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
