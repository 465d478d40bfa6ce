"""A scalar model of K7's walk (csrc/nwswg_long.cu), for its round counts.

    python -m aim_tpu_torch.tools.walk_model [--pairs N] [--out FILE]

Walks one pair at a time, in Python, the way K7 does: a step that reads the
code row is one load round, and so is a window of ``groups`` 32-row groups
of is-match rows (64 band positions around the step's) loaded where the
walk has left the window in hand (``keep_window``; without it every such
step loads a window); a step whose row's is-match bit is set at its band
position is a match piece taken from the window.  The records must equal
the plain version's (``nwswg_long_walk_reference``), which
``tests/test_torch_walk_model.py`` holds; the counts are what the model is
for: rounds, windows and the is-match and code bytes those read (whole
32-byte sectors), a walked pair, on the plain forward's code rows of `nw`
(one plane) and `swg` (two planes) at 4 kbp, seed 1.  CPU only; no timing.
Each reading prints one JSON line (and appends it to ``--out``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from aim_tpu_torch import datagen
from aim_tpu_torch.config import ALGO_SWG, derive_config
from aim_tpu_torch.ops import nwswg_long as L
from aim_tpu_torch.ops.common import pack_seqs, to_device_batch

C_D, C_I, C_M, C_X = L.C_D, L.C_I, L.C_M, L.C_X
SECTOR = 32


class _Runs:
    """band.cuh's Runs: the top run merges up to 4095."""

    def __init__(self, nrl):
        self.rec = np.zeros(nrl, np.int32)
        self.nrl, self.rc, self.top_op, self.top_len = nrl, nrl - 1, 0, 0

    def emit(self, mask, op, length):
        if not (mask and length > 0):
            return
        if (self.top_len > 0 and self.top_op == op
                and self.top_len + length <= 4095 and self.rc < self.nrl - 1):
            self.top_len += length
            return
        self.flush()
        self.top_op, self.top_len = op, min(length, 4095)
        self.rc -= 1

    def flush(self):
        if self.top_len > 0 and 2 <= self.rc + 1 <= self.nrl - 1:
            self.rec[self.rc + 1] = (self.top_op << 12) | self.top_len


def walk_pair(codes, ism, score, mflag, plen, tlen, cfg, planes, groups=8,
              keep_window=True, counts=None):
    """One pair's record (int16 [NRL]) from its unpacked code rows
    ``codes`` [R, P] and is-match bits ``ism`` [R, P]; adds the loads to
    ``counts``."""
    swg = cfg.algo == ALGO_SWG
    R, C, NP = cfg.read_size, L.band_c(planes), 128 * planes
    RB = L.block_rows(cfg.algo, planes)
    it_cap = 3 * R + 4 if swg else 2 * R + 2
    cbytes, ibytes = L.row_bytes(cfg, planes)
    out = _Runs(L.runs_lanes_long(cfg))
    c = counts if counts is not None else {}
    hcur, vcur = (0, 0) if mflag else (tlen, plen)
    layer, blk, it = L.L_M, -(-R // RB) - 1, 0
    win = None  # (lowest row, highest row, first position) in hand

    def count(key, n=1):
        c[key] = c.get(key, 0) + n

    def next_step():
        nonlocal blk, it
        while blk >= 0:
            if it < it_cap and hcur > 0 and vcur > 0 and hcur > blk * RB:
                return True
            blk, it = blk - 1, 0
        return False

    def load_window(row, col):
        nonlocal win
        lo = max((row | 31) - 32 * groups + 1, 0)
        win = (lo, row, 32 * max(0, min((col - 16) >> 5, NP // 32 - 2)))
        count("windows")
        count("ism_bytes", SECTOR * ((row * ibytes + ibytes - 1) // SECTOR
                                     - lo * ibytes // SECTOR + 1))

    def covered(row, col):
        return (win is not None and win[0] <= (row & ~31) and row <= win[1]
                and win[2] <= col < win[2] + 64)

    def piece(row, col):
        n, pos = 0, row & 31
        while n <= pos and ism[row - n, col]:
            n += 1
        return n

    def marked(row, q):
        for b in range(q, -1, -1):
            if ((codes[row, b] >> 2) & 1) if swg else codes[row, b] != C_D:
                return b
        return -1

    while next_step():
        hm1 = hcur - 1 - blk * RB
        inblk, row = hm1 < RB, blk * RB + hm1
        bb = vcur - hcur + C
        q = max(0, min(bb, NP - 1))
        if inblk:
            count("rounds")
            count("code_bytes", -(-cbytes // SECTOR) * SECTOR)
            if not (keep_window and covered(row, q)):
                load_window(row, q)
        if not swg:
            dlen = min(bb - (marked(row, q) if inblk else -1), vcur)
            out.emit(True, L.OP_D, dlen)
            vcur -= dlen
            q2 = max(0, min(vcur - hcur + C, NP - 1))
            code2 = codes[row, q2] if inblk else 0
            is_i, is_x, is_m = (vcur > 0 and code2 == k
                                for k in (C_I, C_X, C_M))
            mrun = 0
            if is_m:
                if not covered(row, q2):
                    count("rounds")
                    load_window(row, q2)
                mrun = min(piece(row, q2), vcur, hcur)
            out.emit(is_i or is_m or is_x,
                     L.OP_I if is_i else L.OP_M if is_m else L.OP_X,
                     mrun if is_m else 1)
            hcur -= 1 if (is_i or is_x) else mrun
            vcur -= 1 if is_x else mrun
        else:
            nib = codes[row, q] if inblk else 0
            io, in_i = (nib >> 3) & 1, layer == L.L_I
            out.emit(in_i, L.OP_I, 1)
            if in_i and io:
                layer = L.L_M
            in_m, ch = layer == L.L_M and not in_i, nib & 3
            is_d = in_m and ch == L.CH_D
            dlen = bb - (marked(row, q) if inblk else -1) + 1 if is_d else 0
            capped = is_d and dlen >= vcur
            dlen = min(dlen, vcur)
            out.emit(is_d, L.OP_D, dlen)
            if capped:
                layer = L.L_D
            is_i, is_x, is_m = (in_m and ch == k
                                for k in (L.CH_I, L.CH_X, L.CH_M))
            mrun = min(piece(row, q), vcur, hcur) if is_m else 0
            out.emit(is_i or is_m or is_x,
                     L.OP_I if is_i else L.OP_M if is_m else L.OP_X,
                     mrun if is_m else 1)
            if is_i:
                layer = L.L_M if io else L.L_I
            hcur -= 1 if (in_i or is_i or is_x) else mrun
            vcur -= 1 if is_x else dlen + mrun
        it += 1
        # match pieces from the window while the next step is one
        while next_step():
            r = hcur - 1
            b = vcur - hcur + C
            col = max(0, min(b, NP - 1))
            if (hcur - 1 - blk * RB >= RB or (swg and layer != L.L_M)
                    or (not swg and b != col) or not covered(r, col)
                    or not ism[r, col]):
                break
            mrun = min(piece(r, col), vcur, hcur)
            out.emit(True, L.OP_M, mrun)
            hcur, vcur, it = hcur - mrun, vcur - mrun, it + 1
            count("pieces")
    flag = mflag or (hcur > 0 and vcur > 0)
    for _ in range(L.TAIL_CHUNKS):
        hc = max(0, min(hcur, 4095))
        out.emit(hc > 0, L.OP_I, hc)
        hcur -= hc
    for _ in range(L.TAIL_CHUNKS):
        vc = max(0, min(vcur, 4095))
        out.emit(vc > 0, L.OP_D, vc)
        vcur -= vc
    out.flush()
    flag = flag or out.rc < 1
    rcc = max(0, min(out.rc, out.nrl - 1))
    out.rec[0] = ((rcc & 255) | (int(flag) << 8) | (int(mflag) << 9)
                  | ((rcc >> 8) << 10))
    out.rec[1] = max(-32768, min(score, 32767))
    return out.rec.astype(np.int16)


def walk_batch(meta, codes, ism, plens, tlens, cfg, planes, **kw):
    """The model on the plain forward's outputs (CPU tensors): (records
    [n, NRL] int16, counts summed over the pairs)."""
    bits = L.code_bits(cfg)
    n, R = codes.shape[:2]
    cu = L._unpack_bits(codes.reshape(n * R, -1), bits).reshape(n, R, -1)
    iu = L._unpack_bits(ism.reshape(n * R, -1), 1).reshape(n, R, -1)
    counts = {}
    rec = np.stack([walk_pair(cu[k].numpy(), iu[k].numpy(),
                              int(meta[k, 0]), bool(meta[k, 1]),
                              int(plens[k]), int(tlens[k]), cfg, planes,
                              counts=counts, **kw) for k in range(n)])
    return rec, counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    for algo in ("nw", "swg"):
        cfg = derive_config(algo, 4096, 0.01, backtrace=True, variant="hbm")
        planes = L.route_planes(cfg)
        p, t, pl, tl = datagen.generate_pairs(a.pairs, 4096, 0.01,
                                              read_size=cfg.read_size,
                                              seed=1)
        pp, pt, packed = pack_seqs(p, t, pl, tl, cfg.read_size)
        args = to_device_batch(pp, pt, pl, tl, "cpu")
        meta, codes, ism = L.nwswg_long_fwd_reference(
            *args, cfg=cfg, packed=packed, planes=planes)
        want = L.nwswg_long_walk_reference(codes, ism, meta, args[2],
                                           args[3], cfg=cfg, planes=planes)
        walked = max(int((meta[:, 1] == 0).sum()), 1)
        for groups, keep in ((4, False), (4, True), (8, True)):
            rec, counts = walk_batch(meta, codes, ism, pl, tl, cfg, planes,
                                     groups=groups, keep_window=keep)
            if not np.array_equal(rec, want.numpy()):
                raise SystemExit("walk_model: records differ from the plain "
                                 "version")
            line = json.dumps({"reading": "walk_model", "algo": algo,
                               "planes": planes, "pairs": a.pairs,
                               "walked": walked, "groups": groups,
                               "keep_window": keep,
                               **{f"{k}_per_walked_pair": v / walked
                                  for k, v in sorted(counts.items())}})
            print(line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
