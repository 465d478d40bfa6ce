"""Where the band and wavefront kernels spend their time on the card (GPU
only).

    python -m aim_tpu_torch.tools.row_profile [--sass] [--stamps]
        [--only band|wfa|walk] [--times] [--out FILE]

Readings of K6, the streamed forward (csrc/nwswg_long.cu), at the
streamed tier's timing config (`nw -l 4096 -e 0.01 -b --variant hbm`,
seed 1), and of K2 (csrc/nw.cu) at `nw -l 100 -e 0.01 -b` (``--only
band``), and of K5 (csrc/wfa_long.cu) at `wfa -l 10000 -e 0.01 -b -r
--variant hbm` and K1 (csrc/wfa2.cu) at `wfa -l 100 -e 0.01 -b -r`
(``--only wfa``), and of K7, the streamed walk (csrc/nwswg_long.cu), at
`nw` and `swg -l 4096 -e 0.01 -b --variant hbm` (``--only walk``):

  1. scaling: the kernel's time (CUDA events) at pair counts from one warp
     a warp scheduler (4 pairs a block on 132 SMs) to several waves.  If a
     row's time stays flat while the warps an SM grow, a row's dependent
     chain (latency) binds; if it grows with them, the SM's instruction
     throughput does.
  2. ptxas: registers, stack and spill bytes a thread of each kernel
     instance (`nvcc -Xptxas -v` on the sources); with ``--sass``, the
     instructions in the loops of K6 and K2's segmented kernel, by opcode
     (`cuobjdump -sass` of the built library).
  3. stamps (``--stamps``): a copy of csrc/nwswg_long.cu with clock64()
     stamps inserted around the parts of K6's NW row (the anchors of
     ``STAMPS``), built alone into a temporary directory -- the tree's
     source is not touched -- and run on the timing chunk and on one warp a
     scheduler.  Cycles a row of each part, summed over warps.  The
     compiler may move arithmetic across a stamp, and a load's latency
     shows where its value is first used, so the parts are approximate;
     their sum is not.
  4. band (K5, K1): the live band the plain version's forward keeps
     (``wfa2.wfa_records``' stats): levels with a band a pair, their mean
     and widest band [klo, khi], live (level, diagonal) cells and matched
     bases a pair, beside the 2*smax+1 diagonals a level of every level a
     pair reaches.
  5. walk (K7): steps a walked pair of the plain version's loop (``stats``
     of ``nwswg_long_walk_reference``: match steps, the match steps that
     continue a run past its 32-row word, those after a D-run) on 64
     pairs; K7's time from the first walked pair alone to the 4,096-pair
     chunk (the chunk runs in one wave, so a lone pair's time against the
     chunk's says whether a step's dependent loads bind); with
     ``--stamps``, clock64() stamps of a step's parts (``WALK_STAMPS``),
     as in 3.

``--times`` prints only the kernel times that compare two trees of the
port (K1 on 16,384 pairs; K5 on 1,024 pairs adaptive and non-adaptive,
and on the 8,192 pairs of chip_smoke.py's 10 kbp CLI run in the CLI's
difficulty order; K6 and K7 on the 4,096-pair NW and SWG 4 kbp chunks,
with a digest of K7's records); it drives the kernels through their public
wrappers alone, so it runs unchanged from the root of an older tree.

Each reading prints one JSON line (and appends it to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import tempfile

import numpy as np
import torch

from aim_tpu_torch import datagen
from aim_tpu_torch.config import derive_config
from aim_tpu_torch.ops import _build, nw, nwswg_long, wfa2, wfa_long
from aim_tpu_torch.ops.common import pack_seqs, to_device_batch
from aim_tpu_torch.tools import timing

SMS = 132
K6_COUNTS = (4, 4 * SMS, 8 * SMS, 16 * SMS, 24 * SMS, 1024, 2048, 4096,
             8192)
K2_COUNTS = (4 * SMS, 16 * SMS, 40 * SMS, 16384)
K5_COUNTS = (4, 4 * SMS, 1024, 4096, 8192)
K1_COUNTS = (4 * SMS, 16 * SMS, 40 * SMS, 16384)
K5_BAND_PAIRS = 16   # the plain version's pairs for the band reading
K1_BAND_PAIRS = 2048
LONG_CLI_PAIRS = 8192  # chip_smoke.py's 10 kbp CLI run (seed 0)

# (name, anchor, where): a stamp closes the part that ends at the anchor
# line (inserted before it, or after it with where = "after").  Anchors of
# K6's NW row in its first design (a register window slid a row, symbols
# read from global memory) and in its design with a shared-memory symbol
# ring; the one whose anchors all match the source is used.
STAMPS = {
    "window": [
        ("slide", "    const int tsym = sym_at(trow, P, h - 1);", "before"),
        ("symbol_masks", "    int cur[E];", "before"),
        ("cells_scan", "      if (P.backtrace) {\n        const int ln = "
         "from_left(cur[E - 1], lane, seam_l);", "before"),
        ("codes", "    if (P.backtrace) {\n      store_bits<E * CB>",
         "before"),
        ("stores", "    if (h == tlen && hit_in) {  // warp-uniform",
         "before"),
        ("score_copy", "    for (int e = 0; e < E; ++e) pm[e] = cur[e];",
         "after"),
    ],
    "stream": [
        ("masks_symbols", "    // ---- row cells", "before"),
        ("cells_scan", "      // ---- codes", "before"),
        ("codes_stores", "    // ---- row end", "before"),
    ],
}
LOOP = "  for (int h = 1; h <= hmax; ++h) {"
AFTER_LOOP = "  ovf = __any_sync(kFull, ovf);"


def _emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def k6_batch(n, dev):
    cfg = derive_config("nw", 4096, 0.01, backtrace=True, variant="hbm")
    p, t, pl, tl = datagen.generate_pairs(n, 4096, 0.01,
                                          read_size=cfg.read_size, seed=1)
    pp, pt, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
    return cfg, to_device_batch(pp, pt, pl, tl, dev), packed, int(tl.max())


def scaling(dev, out):
    planes = nwswg_long.route_planes(derive_config(
        "nw", 4096, 0.01, backtrace=True, variant="hbm"))
    for n in K6_COUNTS:
        cfg, args, packed, rows = k6_batch(n, dev)
        s = timing.best_of(lambda: nwswg_long.launch_forward(
            *args, cfg=cfg, packed=packed, planes=planes), device=dev,
            min_anchor_s=1e-5)
        _emit({"reading": "scaling", "kernel": "nwswg_long_fwd", "pairs": n,
               "blocks": -(-n // 4), "rows": rows, "ms": s * 1e3,
               "us_per_row": s * 1e6 / rows}, out)
    cfg = derive_config("nw", 100, 0.01, backtrace=True)
    for n in K2_COUNTS:
        p, t, pl, tl = datagen.generate_pairs(n, 100, 0.01,
                                              read_size=cfg.read_size,
                                              seed=1)
        pp, pt, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
        args = to_device_batch(pp, pt, pl, tl, dev)
        s = timing.best_of(lambda: nw.nw_forward(*args, cfg=cfg,
                                                 packed=packed),
                           device=dev, min_anchor_s=1e-6)
        _emit({"reading": "scaling", "kernel": "nw", "pairs": n,
               "ms": s * 1e3, "us_per_row": s * 1e6 / int(tl.max())}, out)


def wfa_batch(length, n, dev, seed=1, **kw):
    """(cfg, device tensors, packed) of n generated pairs of `wfa -l length
    -e 0.01 -b -r` (--variant hbm at 10 kbp), 2-bit packed."""
    cfg = derive_config("wfa", length, 0.01, backtrace=True, adaptive=True,
                        variant="hbm" if length > 1000 else "vmem")
    cfg = cfg.replace(**kw)
    p, t, pl, tl = datagen.generate_pairs(n, length, 0.01,
                                          read_size=cfg.read_size, seed=seed)
    pp, pt, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
    return cfg, to_device_batch(pp, pt, pl, tl, dev), packed


def _wfa_fn(cfg):
    """(launch counter name, module) of the kernel that serves cfg."""
    return ("wfa_long", wfa_long) if cfg.read_size > 1000 else ("wfa", wfa2)


def _wfa_time(cfg, args, packed):
    mod = _wfa_fn(cfg)[1]
    fwd = mod.wfa_forward_long if mod is wfa_long else mod.wfa_forward2
    s = timing.best_of(lambda: fwd(*args, cfg=cfg, packed=packed),
                       device=args[0].device, min_anchor_s=1e-6)
    rec = fwd(*args, cfg=cfg, packed=packed)
    sc = rec[:, cfg.max_score + 3].clamp(max=cfg.max_score).long() + 1
    info = mod.kernel_info(cfg) if hasattr(mod, "kernel_info") else {}
    return s * 1e3, float(sc.float().mean()), info


def wfa_scaling(dev, out):
    """K5's and K1's time by pair count; K5 also without backtrace and
    non-adaptive."""
    rows = [(10000, n, {}) for n in K5_COUNTS] + [
        (10000, 1024, {"backtrace": False}),
        (10000, 1024, {"adaptive": False})] + [
        (100, n, {}) for n in K1_COUNTS]
    for length, n, kw in rows:
        cfg, args, packed = wfa_batch(length, n, dev, **kw)
        ms, levels, info = _wfa_time(cfg, args, packed)
        _emit({"reading": "scaling", "kernel": _wfa_fn(cfg)[0], "pairs": n,
               "read_size": cfg.read_size, "max_score": cfg.max_score,
               "adaptive": cfg.adaptive, "backtrace": cfg.backtrace,
               "ms": ms, "levels_reached_per_pair": levels,
               "us_per_level": ms * 1e3 / levels, **info}, out)


def wfa_band(dev, out):
    """The live band of the plain version's forward, beside the K
    diagonals a level of every level reached."""
    for length, n, kw in ((10000, K5_BAND_PAIRS, {}),
                          (10000, K5_BAND_PAIRS, {"adaptive": False}),
                          (100, K1_BAND_PAIRS, {})):
        cfg, args, packed = wfa_batch(length, n, dev, **kw)
        name, mod = _wfa_fn(cfg)
        ref = (mod.wfa_long_reference if mod is wfa_long
               else mod.wfa2_reference)
        st = {}
        rec = ref(*args, cfg=cfg, packed=packed, stats=st)
        reached = int((rec[:, cfg.max_score + 3].clamp(max=cfg.max_score)
                       + 1).sum())
        K = 2 * cfg.max_score + 1
        _emit({"reading": "band", "kernel": name, "pairs": n,
               "read_size": cfg.read_size, "max_score": cfg.max_score,
               "adaptive": cfg.adaptive,
               "levels_reached_per_pair": reached / n,
               "band_levels_per_pair": st["levels"] / n,
               "mean_width": st["live_cells"] / max(st["levels"], 1),
               "max_width": st["max_width"],
               "live_cells_per_pair": st["live_cells"] / n,
               "ext_bases_per_pair": st["ext_bases"] / n,
               "full_k_cells_per_pair": K * reached / n}, out)


def wfa_times(dev, out):
    """The kernel times two trees are compared on (module docstring)."""
    from aim_tpu_torch import api
    rows = [wfa_batch(100, 16384, dev), wfa_batch(10000, 1024, dev),
            wfa_batch(10000, 1024, dev, adaptive=False)]
    cfg = wfa_batch(10000, 4, dev)[0]
    p, t, pl, tl = datagen.generate_pairs(LONG_CLI_PAIRS, 10000, 0.01,
                                          read_size=cfg.read_size, seed=0)
    o = api._difficulty_order(p, t, pl, tl)
    pp, pt, packed = pack_seqs(p[o], t[o], pl[o], tl[o], cfg.read_size)
    rows.append((cfg, to_device_batch(pp, pt, pl[o], tl[o], dev), packed))
    for cfg, args, packed in rows:
        ms, levels, info = _wfa_time(cfg, args, packed)
        _emit({"reading": "times", "kernel": _wfa_fn(cfg)[0],
               "pairs": len(args[2]),
               "read_size": cfg.read_size, "adaptive": cfg.adaptive,
               "ms": ms, "levels_reached_per_pair": levels, **info}, out)


def ptxas(out, srcs=("nwswg_long.cu", "nw.cu", "wfa2.cu", "wfa_long.cu")):
    """Registers and spills a kernel instance from `nvcc -Xptxas -v`."""
    with tempfile.TemporaryDirectory() as tmp:
        for src in srcs:
            r = subprocess.run(
                [_build._nvcc()] + _build.NVCC_FLAGS +
                ["-Xptxas", "-v", "-c", os.path.join(_build.CSRC, src),
                 "-o", os.path.join(tmp, src + ".o")],
                capture_output=True, text=True)
            if r.returncode:
                raise RuntimeError(r.stdout + r.stderr)
            fn = None
            rows = {}
            for line in (r.stdout + r.stderr).splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    fn = m.group(1)
                    rows[fn] = {}
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores", line)
                if m and fn:
                    rows[fn].update(stack=int(m.group(1)),
                                    spill_stores=int(m.group(2)))
                m = re.search(r"Used (\d+) registers", line)
                if m and fn:
                    rows[fn]["registers"] = int(m.group(1))
            for fn, row in rows.items():
                _emit({"reading": "ptxas", "source": src, "function": fn,
                       **row}, out)


SASS_FUNCS = ("fwd_kernel", "nw_seg_kernel", "wfa_long_kernel",
              "wfa2_kernel", "walk_kernel")


def sass(out):
    """Static instruction counts of the loops of K6, K2's segmented kernels,
    K5 and K1 in the built library (`cuobjdump -sass`): for each backward
    branch its span in instructions and the count of each opcode in it,
    the three largest loops a function."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", _build.build()],
                          capture_output=True, text=True, check=True).stdout
    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);")
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        if not any(f in name for f in SASS_FUNCS):
            continue
        rows = [(int(m.group(1), 16), m.group(2), m.group(3))
                for m in ins.finditer(block)]
        loops = []
        for addr, op, rest in rows:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                body = [o for a, o, _ in rows
                        if int(t.group(1), 16) <= a <= addr and o != "NOP"]
                ops = {}
                for o in body:
                    k = o.split(".")[0]
                    ops[k] = ops.get(k, 0) + 1
                loops.append((len(body), dict(sorted(
                    ops.items(), key=lambda kv: -kv[1]))))
        loops.sort(key=lambda x: -x[0])
        _emit({"reading": "sass", "function": name,
               "instructions": len(rows),
               "loops": [{"instructions": n, "by_opcode": o}
                         for n, o in loops[:3]]}, out)


def instrumented(text, marksets=STAMPS, begin=LOOP, end=AFTER_LOOP,
                 count="hmax"):
    """The source with clock64() stamps around the parts of a loop, and the
    names of the parts: the first anchor set of ``marksets`` that matches
    the source (a list of marks, or a dict of "marks" and "ticks"); the
    stamps start before ``begin`` and are summed before ``end`` (after it
    at K6's loop end; lane 0 of each warp adds its cycles a part and
    ``count``, the loop's trips, to global accumulators).  With ticks
    (anchors), the trips are counted after each of them instead."""
    for marks in marksets.values():
        ticks = []
        if isinstance(marks, dict):
            marks, ticks = marks["marks"], marks["ticks"]
        if all(anchor in text for _, anchor, _ in marks) and \
                all(t in text for t in ticks):
            break
    else:
        raise RuntimeError("no stamp anchor set matches the source")
    ns = len(marks)
    assert text.count(begin) == 1 and text.count(end) == 1
    for k, (_, anchor, where) in enumerate(marks):
        assert text.count(anchor) == 1, anchor
        stamp = f"    AIM_STAMP({k});\n"
        text = text.replace(anchor, anchor + "\n" + stamp.rstrip("\n")
                            if where == "after" else stamp + anchor)
    for tick in ticks:
        assert text.count(tick) == 1, tick
        text = text.replace(tick, tick + "\n      ++_steps;")
        count = "_steps"
    text = text.replace(begin, "  AIM_STAMP_BEGIN;\n" + begin)
    text = text.replace(end, (end + "\n  AIM_STAMP_END;") if end == AFTER_LOOP
                        else "  AIM_STAMP_END;\n" + end)
    head = f"""
#include <cuda_runtime.h>
__device__ unsigned long long aim_stamp_acc[{ns + 1}];
#define AIM_STAMP_BEGIN long long _sa[{ns}] = {{}}; \\
  long long _steps = 0; long long _sl = clock64()
#define AIM_STAMP(k) {{ const long long _t = clock64(); \\
  _sa[k] += _t - _sl; _sl = _t; }}
#define AIM_STAMP_END if ((threadIdx.x & 31) == 0) {{ \\
  for (int _k = 0; _k < {ns}; ++_k) \\
    atomicAdd(&aim_stamp_acc[_k], (unsigned long long)_sa[_k]); \\
  atomicAdd(&aim_stamp_acc[{ns}], (unsigned long long)({count})); }}
"""
    tail = f"""
extern "C" int aim_stamp_io(unsigned long long *host, int clear) {{
  if (clear) {{
    unsigned long long z[{ns + 1}] = {{}};
    return (int)cudaMemcpyToSymbol(aim_stamp_acc, z, sizeof(z));
  }}
  return (int)cudaMemcpyFromSymbol(host, aim_stamp_acc,
                                   sizeof(unsigned long long) * {ns + 1});
}}
"""
    return head + text + tail, [m[0] for m in marks]


def stamped_library(tmp, text):
    """Build ``text`` (an instrumented csrc/nwswg_long.cu) alone into a
    library in ``tmp``; returns it with its entry points declared."""
    cu = os.path.join(tmp, "nwswg_long_stamped.cu")
    open(cu, "w").write(text)
    so = os.path.join(tmp, "libstamped.so")
    r = subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS +
                       [f"-I{_build.CSRC}", "-shared", cu, "-o", so],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    lib = ctypes.CDLL(so)
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.aim_nwswg_long_forward.restype = ci
    lib.aim_nwswg_long_forward.argtypes = [vp] * 8 + [cl] + [ci] * 16 + [vp]
    lib.aim_nwswg_long_walk.restype = ci
    lib.aim_nwswg_long_walk.argtypes = [vp] * 6 + [cl] + [ci] * 5 + [vp]
    lib.aim_stamp_io.restype = ci
    lib.aim_stamp_io.argtypes = [vp, ci]
    return lib


def stamps(dev, out):
    src = os.path.join(_build.CSRC, "nwswg_long.cu")
    text, names = instrumented(open(src).read())
    with tempfile.TemporaryDirectory() as tmp:
        lib = stamped_library(tmp, text)
        fwd, io = lib.aim_nwswg_long_forward, lib.aim_stamp_io
        vp = ctypes.c_void_p
        acc = (ctypes.c_ulonglong * (len(names) + 1))()
        for n in (4 * SMS, 4096):
            cfg, args, packed, _ = k6_batch(n, dev)
            planes = nwswg_long.route_planes(cfg)
            R = cfg.read_size
            cb, ib = nwswg_long.row_bytes(cfg, planes)
            meta = torch.empty((n, 2), dtype=torch.int32, device=dev)
            codes = torch.empty((n, R, cb), dtype=torch.uint8, device=dev)
            ism = torch.empty((n, R, ib), dtype=torch.uint8, device=dev)
            rec = torch.empty((n, nwswg_long.runs_lanes_long(cfg)),
                              dtype=torch.int16, device=dev)
            weff, lpad = nwswg_long.seq_geometry(cfg, args[0].shape[1],
                                                 packed, planes)
            assert io(None, 1) == 0
            stream = ctypes.c_void_p(torch.cuda.current_stream(dev)
                                     .cuda_stream)
            rc = fwd(*(a.data_ptr() for a in args), meta.data_ptr(),
                     codes.data_ptr(), ism.data_ptr(), rec.data_ptr(), n,
                     args[0].shape[1], int(packed), weff, lpad, R, planes,
                     nwswg_long.runs_lanes_long(cfg), 0, 1, cfg.gap_i,
                     cfg.gap_d, cfg.mismatch, cfg.match, cfg.gap_o,
                     cfg.gap_e, cfg.max_score, stream)
            torch.cuda.synchronize(dev)
            assert rc == 0 and io(ctypes.cast(acc, vp), 0) == 0
            want = nwswg_long.launch_forward(*args, cfg=cfg, packed=packed,
                                             planes=planes)[0]
            if not torch.equal(meta, want):
                raise RuntimeError("the stamped copy disagrees with K6")
            vals = np.array(acc[:], dtype=np.float64)
            rows = vals[-1]
            cyc = vals[:-1] / rows
            _emit({"reading": "stamps", "kernel": "nwswg_long_fwd",
                   "pairs": n, "warp_rows": int(rows),
                   "cycles_per_row": float(cyc.sum()),
                   "parts": dict(zip(names, cyc.tolist()))}, out)


# K7's parts: in its first design ("three_loads": the D-run search, code2
# and the match run each a load round of its own) and its second
# ("rounds": a step that meets an edit reads the code row in one round,
# the is-match window topped up in the same round; match pieces come from
# the window); parts named without "nw_" or "swg_" are both algorithms'.
# The stamps count the reference's steps at the ``ticks``.
WALK_STAMPS = {
    "three_loads": {
        "marks": [
            ("nw_d_search", "        out.emit(true, kOpD, dlen);", "after"),
            ("nw_code2", "        const bool is_m = act2 && code2 == kCM;",
             "after"),
            ("nw_match_run",
             "        continue;\n      }\n      // SWG: the M", "before"),
            ("swg_nibble_d_search", "      out.emit(is_d, kOpD, dlen);",
             "after"),
            ("swg_match_run", "      vcur -= is_x ? 1 : dlen + mrun;",
             "after"),
        ],
        "ticks": ["      if (!(hcur > 0 && vcur > 0 && hcur > blk_lo)) "
                  "break;"],
    },
    "rounds": {
        "marks": [
            ("nw_round", "      out.emit(true, kOpD, dlen);", "after"),
            ("swg_round", "      const bool is_d = in_m && ch == kCD;",
             "after"),
            ("step", "    ++it;\n    // ---- the match pieces ahead",
             "before"),
            ("pieces", "  }\n  bool flag = mflag || (hcur > 0 && vcur > 0);",
             "before"),
        ],
        "ticks": ["    int ones = 0;  // is-match rows from row down at the M "
                  "run's position",
                  "        out.emit(true, kOpM, mrun);",
                  "                           min(vcur, hcur));\n"
                  "      out.emit(true, kOpM, mrun);"],
    },
}
WALK_BEGIN = "  // forward-flagged pairs do not walk (reference :608-623)"
WALK_END = "  bool flag = mflag || (hcur > 0 && vcur > 0);"
WALK_COUNTS = (1, 4, 4 * SMS, 1024, 4096)
WALK_STEP_PAIRS = 64   # the plain version's pairs for the step counts


def walk_batch(algo, n, dev, seed=1):
    """K7's inputs on n generated pairs of `<algo> -l 4096 -e 0.01 -b
    --variant hbm` at the routed plane count: (cfg, planes, the pair
    tensors, K6's (meta, codes, ism, rec))."""
    cfg = derive_config(algo, 4096, 0.01, backtrace=True, variant="hbm")
    planes = nwswg_long.route_planes(cfg)
    p, t, pl, tl = datagen.generate_pairs(n, 4096, 0.01,
                                          read_size=cfg.read_size, seed=seed)
    pp, pt, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
    args = to_device_batch(pp, pt, pl, tl, dev)
    fwd = nwswg_long.launch_forward(*args, cfg=cfg, packed=packed,
                                    planes=planes)
    return cfg, planes, args, packed, fwd


def _walk(cfg, planes, args, fwd, n, lo=0):
    meta, codes, ism, rec = (x[lo:lo + n] for x in fwd)
    return lambda: nwswg_long.launch_walk(codes, ism, meta, args[2][lo:lo + n],
                                          args[3][lo:lo + n], rec, cfg=cfg,
                                          planes=planes)


def walk_profile(dev, out, stamps_too):
    """K7 at NW (one plane) and SWG (two) 4 kbp: steps a walked pair from
    the plain version's loop, the time by pair count from a lone walked
    pair to the 4,096-pair chunk, and (``stamps_too``) clock64() stamps of
    a step's parts."""
    for algo in ("nw", "swg"):
        cfg, planes, args, packed, fwd = walk_batch(algo, 4096, dev)
        meta = fwd[0]
        lone = int(torch.nonzero(meta[:, 1] == 0)[0])   # first walked pair
        st = {}
        k = WALK_STEP_PAIRS
        nwswg_long.nwswg_long_walk_reference(
            fwd[1][:k], fwd[2][:k], meta[:k], args[2][:k], args[3][:k],
            cfg=cfg, planes=planes, stats=st)
        w = max(st["walked"], 1)
        _emit({"reading": "steps", "kernel": "nwswg_long_walk",
               "algo": algo, "planes": planes, "pairs": min(k, len(meta)),
               "walked": st["walked"], **{f"{key}_per_walked_pair":
                                          st[key] / w for key in (
                   "steps", "m_steps", "m_pieces", "d_then_m")},
               "max_steps": st["max_steps"]}, out)
        lone_st = {}
        nwswg_long.nwswg_long_walk_reference(
            *(x[lone:lone + 1] for x in (fwd[1], fwd[2], meta, args[2],
                                         args[3])),
            cfg=cfg, planes=planes, stats=lone_st)
        for n in WALK_COUNTS:
            lo = lone if n == 1 else 0
            s = timing.best_of(_walk(cfg, planes, args, fwd, n, lo),
                               device=dev, min_anchor_s=1e-6)
            row = {"reading": "scaling", "kernel": "nwswg_long_walk",
                   "algo": algo, "planes": planes, "pairs": n,
                   "walked": int((meta[lo:lo + n, 1] == 0).sum()),
                   "ms": s * 1e3}
            if n == 1:
                row.update(steps=lone_st["steps"],
                           us_per_step=s * 1e6 / lone_st["steps"])
            _emit(row, out)
        if stamps_too:
            walk_stamps(dev, out, cfg, planes, args, fwd, lone)


def walk_stamps(dev, out, cfg, planes, args, fwd, lone):
    """clock64() stamps of K7's step on the lone walked pair and on the
    4,096-pair chunk: cycles a step of each part (a copy of the source,
    built alone; its records must equal K7's)."""
    src = os.path.join(_build.CSRC, "nwswg_long.cu")
    text, names = instrumented(open(src).read(), WALK_STAMPS, WALK_BEGIN,
                               WALK_END)
    other = "swg_" if cfg.algo == "nw" else "nw_"
    mine = [i for i, nm in enumerate(names) if not nm.startswith(other)]
    with tempfile.TemporaryDirectory() as tmp:
        lib = stamped_library(tmp, text)
        acc = (ctypes.c_ulonglong * (len(names) + 1))()
        vp = ctypes.c_void_p
        for n, lo in ((1, lone), (4096, 0)):
            meta, codes, ism, rec = (x[lo:lo + n] for x in fwd)
            got = torch.empty_like(rec)
            assert lib.aim_stamp_io(None, 1) == 0
            stream = ctypes.c_void_p(torch.cuda.current_stream(dev)
                                     .cuda_stream)
            rc = lib.aim_nwswg_long_walk(
                codes.data_ptr(), ism.data_ptr(), meta.data_ptr(),
                args[2][lo:].data_ptr(), args[3][lo:].data_ptr(),
                got.data_ptr(), n, cfg.read_size, planes,
                nwswg_long.runs_lanes_long(cfg),
                nwswg_long.block_rows(cfg.algo, planes),
                int(cfg.algo == "swg"), stream)
            torch.cuda.synchronize(dev)
            assert rc == 0 and lib.aim_stamp_io(ctypes.cast(acc, vp), 0) == 0
            _walk(cfg, planes, args, fwd, n, lo)()
            if not torch.equal(got, rec):
                raise RuntimeError("the stamped copy disagrees with K7")
            vals = np.array(acc[:], dtype=np.float64)
            steps = max(vals[-1], 1.0)
            cyc = {names[i]: vals[i] / steps for i in mine}
            _emit({"reading": "stamps", "kernel": "nwswg_long_walk",
                   "algo": cfg.algo, "planes": planes, "pairs": n,
                   "warp_steps": int(vals[-1]),
                   "cycles_per_step": float(sum(cyc.values())),
                   "parts": cyc}, out)


def walk_times(dev, out):
    """The K6 and K7 times two trees are compared on: the 4,096-pair NW and
    SWG 4 kbp chunks, through the public launchers, with a digest of the
    records so the trees' outputs compare too."""
    import hashlib
    for algo in ("nw", "swg"):
        cfg, planes, args, packed, fwd = walk_batch(algo, 4096, dev)
        k6 = timing.best_of(lambda: nwswg_long.launch_forward(
            *args, cfg=cfg, packed=packed, planes=planes), device=dev,
            min_anchor_s=1e-5)
        k7 = timing.best_of(_walk(cfg, planes, args, fwd, 4096), device=dev,
                            min_anchor_s=1e-6)
        _walk(cfg, planes, args, fwd, 4096)()
        digest = hashlib.sha256(fwd[3].cpu().numpy().tobytes()).hexdigest()
        _emit({"reading": "times", "algo": algo, "planes": planes,
               "pairs": len(args[2]),
               "walked": int((fwd[0][:, 1] == 0).sum()),
               "nwswg_long_fwd_ms": k6 * 1e3, "nwswg_long_walk_ms": k7 * 1e3,
               "records_sha256": digest[:16]}, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--only", choices=("band", "wfa", "walk"), default=None)
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("row_profile: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    _emit({"reading": "device", "gpu": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}, a.out)
    if a.times:
        if a.only in (None, "wfa"):
            wfa_times(dev, a.out)
        if a.only in (None, "walk"):
            walk_times(dev, a.out)
        return 0
    ptxas(a.out, ("nwswg_long.cu",) if a.only == "walk" else
          ("nwswg_long.cu", "nw.cu", "wfa2.cu", "wfa_long.cu"))
    if a.sass:
        sass(a.out)
    if a.only in (None, "band"):
        scaling(dev, a.out)
        if a.stamps:
            stamps(dev, a.out)
    if a.only in (None, "wfa"):
        wfa_scaling(dev, a.out)
        wfa_band(dev, a.out)
    if a.only in (None, "walk"):
        walk_profile(dev, a.out, a.stamps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
