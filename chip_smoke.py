"""Smoke run of the PyTorch port (aim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero
before the last line:

  1. device   CUDA must be present; card name and power limit from
              nvidia-smi; build the CUDA kernels from csrc/ (timed).
  2. kernel   each kernel against its plain PyTorch version on the card,
              4096 seeded pairs per config: records byte-equal, and the
              scores/CIGARs of every pair (K1) or every unflagged pair (K2
              NW, K3 SWG) equal to the native oracle.  K1 (csrc/wfa2.cu) on
              12 configs, K2 (csrc/nw.cu) and K3 (csrc/swg.cu) on 14.
  3. main     the CLI paths: `wfa -l 100 -e 0.01 -b -r` (the main path),
              `nw -b`, `nw`, `swg -b` and `swg` at the same -l/-e, each on
              the same 1,000,000 generated pairs; then `wfa -b`, `-b -r`,
              `-r` and the four NW/SWG runs on data/sample-l100-e1-2K.
              Every output file must equal the oracle's byte for byte, with
              0 fallback pairs; every launch counter is set to 0 just
              before each run and read just after, and the run's own kernel
              must have launched.
  4. timing   each kernel vs its plain version on one 16384-pair chunk of
              its canonical config (CUDA events), and their records
              compared once more at this, the CLI's launch shape.

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
ORACLE_1T_PAIRS = 200_000


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


def read_device_log(path):
    fields = open(path).read().split("|", 1)[1].split()
    return dict(f.split("=", 1) for f in fields)


def launch_counters():
    from aim_tpu_torch.ops import nw, swg, wfa2
    return {"wfa": wfa2, "nw": nw, "swg": swg}


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
             ("swg", ["-b"]), ("swg", [])]
SAMPLE_RUNS = [("wfa", f) for f in (["-b"], ["-b", "-r"], ["-r"])] + \
    MAIN_RUNS[1:]


def phase_main(smi):
    """Every CLI run; returns {kernel: launches in its 1M-pair `-b` run}."""
    from aim_tpu import datagen
    from aim_tpu.cli import build_parser, config_from_args
    gpu = torch.cuda.get_device_name(0)
    main_launches = {}
    with tempfile.TemporaryDirectory(prefix="aim_chip_smoke_") as tmp:
        inp = os.path.join(tmp, "pairs.txt")
        t0 = time.perf_counter()
        datagen.write_pair_file(inp, MAIN_PAIRS, 100, 0.01, seed=SEED)
        t_gen = time.perf_counter() - t0
        runs = [(inp, MAIN_PAIRS, a, f) for a, f in MAIN_RUNS] + \
            [(SAMPLE, 1000, a, f) for a, f in SAMPLE_RUNS]
        for i, (src, n, algo, flags) in enumerate(runs):
            argv = [algo, "-i", src, "-l", "100", "-e", "0.01",
                    "-n", str(n)] + flags
            cfg = config_from_args(build_parser().parse_args(argv))
            out = os.path.join(tmp, f"port{i}")
            ref = os.path.join(tmp, f"oracle{i}")
            wall, launches, log = run_cli(argv, out, os.path.join(tmp, "log"))
            n_done, t_mt, t_file, batch = oracle_file(ref, src, n, cfg)
            same = filecmp.cmp(out, ref, shallow=False)
            row = {"phase": "main", "input": "datagen" if src == inp
                   else "sample-l100-e1-2K", "argv": " ".join(argv),
                   "pairs": n_done, "launches": launches[algo],
                   "launches_all": launches,
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
            if src == inp and "-b" in flags:
                # one thread on the first ORACLE_1T_PAIRS pairs (a rate per
                # pair; NW and SWG take ~26 s a million on one core)
                p, t, pl, tl = (a[:ORACLE_1T_PAIRS] for a in batch)
                t1 = time.perf_counter()
                oracle_align(p, t, pl, tl, cfg, threads=1)
                row["oracle_1t_pairs_s"] = len(pl) / (time.perf_counter()
                                                      - t1)
                row["oracle_1t_pairs"] = len(pl)
                row["host_cpu_cores"] = os.cpu_count()
                row["gen_s"] = t_gen
                main_launches[algo] = launches[algo]
            emit(row)
            if not same:
                fail(f"{argv}: output differs from the oracle")
            others = sum(v for k, v in launches.items() if k != algo)
            if int(log["fallback"]) != 0 or launches[algo] <= 0 \
                    or others or n_done != n:
                fail(f"{argv}: fallback={log['fallback']} "
                     f"launches={launches} pairs={n_done}")
    return main_launches


def phase_timing(reps=20):
    """Each kernel against its plain version on one 16384-pair chunk of
    its canonical config; returns {kernel: (kernel ms, plain ms, err)}."""
    from aim_tpu import datagen
    from aim_tpu.config import derive_config
    from aim_tpu_torch.ops import nw, swg, wfa2
    from aim_tpu_torch.ops.common import pack_seqs, to_device_batch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn, n):
        fn()
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(n):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / n

    out = {}
    for name, cfg, fwd, ref in (
            ("wfa", derive_config("wfa", 100, 0.01, backtrace=True,
                                  adaptive=True),
             wfa2.wfa_forward2, wfa2.wfa2_reference),
            ("nw", derive_config("nw", 100, 0.01, backtrace=True),
             nw.nw_forward, nw.nw_reference),
            ("swg", derive_config("swg", 100, 0.01, backtrace=True),
             swg.swg_forward, swg.swg_reference)):
        p, t, pl, tl = datagen.generate_pairs(cfg.batch_pairs, 100, 0.01,
                                              read_size=112, seed=SEED + 1)
        pp, pt, packed = pack_seqs(p, t, pl, tl, 112)
        args = to_device_batch(pp, pt, pl, tl, DEVICE)
        k_ms = timed(lambda: fwd(*args, cfg=cfg, packed=packed), reps)
        p_ms = timed(lambda: ref(*args, cfg=cfg, packed=packed), 2)
        # the same chunk, the CLI's launch shape: kernel against plain
        got = fwd(*args, cfg=cfg, packed=packed).cpu().numpy()
        want = ref(*args, cfg=cfg, packed=packed).cpu().numpy()
        err = int(np.abs(got.astype(np.int64) - want).max())
        emit({"phase": "timing", "kernel": name,
              "config": f"{name} -l 100 -e 0.01 -b"
                        + (" -r" if cfg.adaptive else "")
                        + f" (R{cfg.read_size} smax{cfg.max_score})",
              "pairs": len(pl), "kernel_ms": k_ms, "plain_ms": p_ms,
              "kernel_reps": reps, "max_abs_err": err,
              "gpu": torch.cuda.get_device_name(0)})
        if err:
            fail(f"{name}: 16384-pair chunk: kernel disagrees with the "
                 "plain version")
        out[name] = (k_ms, p_ms, err)
    return out


KERNELS = [("wfa2", "wfa", "aim_tpu_torch/csrc/wfa2.cu",
            "aim_tpu/ops/wfa_pallas2.py:72"),
           ("nw", "nw", "aim_tpu_torch/csrc/nw.cu",
            "aim_tpu/ops/nw_pallas.py:161"),
           ("swg", "swg", "aim_tpu_torch/csrc/swg.cu",
            "aim_tpu/ops/swg_pallas.py:82")]


def main() -> int:
    smi = phase_device()
    max_err = {"wfa": phase_kernel()}
    max_err.update(phase_band_kernels())
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
