"""Where the NW band kernels spend a text row on the card (GPU only).

    python -m aim_tpu_torch.tools.row_profile [--sass] [--stamps] [--out FILE]

Three readings of K6, the streamed forward (csrc/nwswg_long.cu), at the
streamed tier's timing config (`nw -l 4096 -e 0.01 -b --variant hbm`,
seed 1), and of K2 (csrc/nw.cu) at `nw -l 100 -e 0.01 -b`:

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
from aim_tpu_torch.ops import _build, nw, nwswg_long
from aim_tpu_torch.ops.common import pack_seqs, to_device_batch
from aim_tpu_torch.tools import timing

SMS = 132
K6_COUNTS = (4, 4 * SMS, 8 * SMS, 16 * SMS, 24 * SMS, 1024, 2048, 4096,
             8192)
K2_COUNTS = (4 * SMS, 16 * SMS, 40 * SMS, 16384)

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


def ptxas(out):
    """Registers and spills a kernel instance from `nvcc -Xptxas -v`."""
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("nwswg_long.cu", "nw.cu"):
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


SASS_FUNCS = ("fwd_kernel", "nw_seg_kernel")


def sass(out):
    """Static instruction counts of the loops of K6's and K2's segmented
    kernels in the built library (`cuobjdump -sass`): for each backward
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


def instrumented(text):
    """The source with stamps around the parts of K6's row, and the names
    of the parts."""
    for marks in STAMPS.values():
        if all(anchor in text for _, anchor, _ in marks):
            break
    else:
        raise RuntimeError("no STAMPS anchor set matches the source")
    ns = len(marks)
    assert text.count(LOOP) == 1 and text.count(AFTER_LOOP) == 1
    for k, (_, anchor, where) in enumerate(marks):
        assert text.count(anchor) == 1, anchor
        stamp = f"    AIM_STAMP({k});\n"
        text = text.replace(anchor, anchor + "\n" + stamp.rstrip("\n")
                            if where == "after" else stamp + anchor)
    text = text.replace(LOOP, "  AIM_STAMP_BEGIN;\n" + LOOP)
    text = text.replace(AFTER_LOOP, AFTER_LOOP + "\n  AIM_STAMP_END;")
    head = f"""
#include <cuda_runtime.h>
__device__ unsigned long long aim_stamp_acc[{ns + 1}];
#define AIM_STAMP_BEGIN long long _sa[{ns}] = {{}}; \\
  long long _sl = clock64()
#define AIM_STAMP(k) {{ const long long _t = clock64(); \\
  _sa[k] += _t - _sl; _sl = _t; }}
#define AIM_STAMP_END if ((threadIdx.x & 31) == 0) {{ \\
  for (int _k = 0; _k < {ns}; ++_k) \\
    atomicAdd(&aim_stamp_acc[_k], (unsigned long long)_sa[_k]); \\
  atomicAdd(&aim_stamp_acc[{ns}], (unsigned long long)hmax); }}
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


def stamps(dev, out):
    src = os.path.join(_build.CSRC, "nwswg_long.cu")
    text, names = instrumented(open(src).read())
    with tempfile.TemporaryDirectory() as tmp:
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
        fwd = lib.aim_nwswg_long_forward
        fwd.restype = ci
        fwd.argtypes = [vp] * 8 + [cl] + [ci] * 16 + [vp]
        io = lib.aim_stamp_io
        io.restype = ci
        io.argtypes = [vp, ci]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--sass", action="store_true")
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
    ptxas(a.out)
    if a.sass:
        sass(a.out)
    scaling(dev, a.out)
    if a.stamps:
        stamps(dev, a.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
