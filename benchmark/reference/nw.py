"""Plain NumPy NW (Needleman-Wunsch): global, minimising, linear gaps,
with backtrace.

The semantics of the AIM reference's DPU-MRAM NW (safaad/aim,
NW/DPU-MRAM/dpu/nw.c:151-237, launched by run-nw-pim-mram.py:76-97):

- Cells of int16 (`NW_W16`).  Every sum is taken in int and stored
  wrapped to int16, and ties are compared on the stored values, sums
  wrapped likewise.
- One flat tape `dp[(tlen+1)*h + v]`, v up to plen.  Row 0 holds
  gap_d * v; then column 0 holds gap_i * h (written after row 0, so it
  wins where the two meet); cell (0, 0) holds 0.  In program order, text
  row h = 1..tlen and pattern column v = 1..plen, a cell is
  min(dp[t-nc-1] + (0 or mismatch), dp[t-nc] + gap_i, dp[t-1] + gap_d)
  at t = nc*h + v, nc = tlen + 1; the score is the last cell computed (0
  where none is).
- The backtrace walks the final tape from (tlen, plen): D where the cell
  equals its left neighbour + gap_d, else I where it equals the cell
  above + gap_i, else a diagonal step, `X` where it equals the diagonal
  + mismatch and `M` where not (no base is compared).  What is left of
  the text becomes `I`s, then what is left of the pattern `D`s.  Ops are
  written right to left into a buffer filled with `M`.

Where plen > tlen + 1 a row runs past the next row's start: its cells at
v > nc overwrite the next row's columns, and column 0 of row h holds row
h-1's column nc.  The tape is computed as the program writes it, one text
row at a time in segments of nc cells: the cells of a segment read the
earlier ones at lags nc and nc + 1, which lie before the segment, and
the lag-1 deletion chain inside a segment is a running minimum:
D(v) = min over u <= v of a(u) + gap_d * (v - u), with a(u) the better
of the diagonal and the insertion.  Pairs with plen <= tlen + 1 take one
segment a row.  Rows, not cells, are the Python steps.

The running minimum holds in exact arithmetic, which int16 keeps where no
sum wraps: each pair's tape is checked to stay inside int16 with every
step added, and a pair that does not goes to the per-cell simulation
(`flat_tape_cells`), one Python step a cell.  At 4 kbp with x = 3 and
g = 4 no tape comes near the range.

Departures from the reference's code, none of them in its output: the
tape is int32 and held whole a pair (the reference keeps it in MRAM and
streams it through WRAM); pairs run one after another (the reference
spreads them over DPUs); the comparison of bases is on the bytes as
given, as nw.c compares its bytes.

`control` breaks the aliasing guarantee: pairs with plen > tlen + 1 are
scored and walked on a clean (tlen+1) x (plen+1) table (row stride
plen + 1), as a proper 2-D NW would.

`align` returns scores, the ops buffer with begin and end offsets (the
layout the output writer reads), and each pair's band cells: the cells of
the (p x t) table on the diagonals |h - v| <= K, K = max(|t - p|,
S // min(gap_i, gap_d)) with S the pair's score, the widest band an
alignment of cost at most S can touch.
"""

from __future__ import annotations

import numpy as np

import roofline

# int32 operations an NW cell takes (the three candidates, their minimum
# and the direction code), as PERF.md's kernel table counts them
OPS_PER_CELL = 8
_LO, _HI = -32768, 32767


def _wrap(x: int) -> int:
    return ((x + 32768) & 0xFFFF) - 32768


def _start(plen, tlen, stride, gap_i, gap_d, dtype):
    """The tape before the first row: row 0, then column 0 over it."""
    tape = np.zeros(tlen * stride + plen + 1, dtype)
    tape[:plen + 1] = gap_d * np.arange(plen + 1)
    tape[stride * np.arange(1, tlen + 1)] = gap_i * np.arange(1, tlen + 1)
    return tape


def segmented_tape(pat, txt, plen, tlen, mismatch, gap_i, gap_d,
                   stride=None):
    """The final tape of one pair in exact int32 values, rows of `stride`
    cells (the flat tape's tlen + 1 by default): (tape, score)."""
    nc = tlen + 1 if stride is None else stride
    tape = _start(plen, tlen, nc, gap_i, gap_d, np.int32)
    if plen == 0 or tlen == 0:
        return tape, 0
    p = np.frombuffer(bytes(pat[:plen]), np.uint8)
    # segment s of a row: columns s*nc + 1 .. min((s+1)*nc, plen)
    segs = [(lo, min(lo + nc, plen + 1)) for lo in range(1, plen + 1, nc)]
    lift = gap_d * np.arange(plen + 1, dtype=np.int32)
    # a(v) - gap_d * v: the insertion's step, and the diagonal's for each
    # text byte, column v at index v
    ins = gap_i - lift
    diag = {}
    q = np.empty(min(nc, plen) + 1, np.int32)
    d = np.empty_like(q)
    for h, c in enumerate(bytes(txt[:tlen]), 1):
        if c not in diag:
            diag[c] = np.where(p == c, 0, mismatch).astype(np.int32) \
                - lift[1:]
        dg = diag[c]
        row = h * nc
        for lo, hi in segs:
            t0, t1 = row + lo, row + hi
            k = hi - lo + 1
            np.add(tape[t0 - nc:t1 - nc], ins[lo:hi], out=q[1:k])
            np.add(tape[t0 - nc - 1:t1 - nc - 1], dg[lo - 1:hi - 1],
                   out=d[1:k])
            np.minimum(q[1:k], d[1:k], out=q[1:k])
            # the cell left of the segment, then the running minimum
            q[0] = tape[t0 - 1] - lift[lo - 1]
            np.minimum.accumulate(q[:k], out=q[:k])
            np.add(q[1:k], lift[lo:hi], out=tape[t0:t1])
    return tape, int(tape[tlen * nc + plen])


def flat_tape_cells(pat, txt, plen, tlen, mismatch, gap_i, gap_d,
                    stride=None):
    """The same tape one Python step a cell, every sum wrapped to int16 as
    the reference stores it: (tape, score)."""
    nc = tlen + 1 if stride is None else stride
    tape = [_wrap(int(x)) for x in _start(plen, tlen, nc, gap_i, gap_d,
                                          np.int64)]
    score = 0
    for h in range(1, tlen + 1):
        tc = txt[h - 1]
        for v in range(1, plen + 1):
            t = h * nc + v
            best = min(_wrap(tape[t - nc - 1]
                             + (0 if pat[v - 1] == tc else mismatch)),
                       _wrap(tape[t - nc] + gap_i),
                       _wrap(tape[t - 1] + gap_d))
            tape[t] = best
            score = best
    return np.array(tape, np.int64), score


def _sound(tape, mismatch, gap_i, gap_d) -> bool:
    """No stored cell, nor a step added to one, leaves int16."""
    steps = (0, mismatch, gap_i, gap_d)
    return (int(tape.max()) + max(max(steps), 0) <= _HI
            and int(tape.min()) + min(min(steps), 0) >= _LO)


def _walk(tape, plen, tlen, nc, mismatch, gap_i, gap_d, ops_row):
    """The backtrace over a final tape, ops written right to left into
    `ops_row`: (begin, end)."""
    end = plen + tlen
    op = end - 1
    h, v = tlen, plen
    while h > 0 and v > 0:
        t = h * nc + v
        cur = int(tape[t])
        if cur == _wrap(int(tape[t - 1]) + gap_d):
            ops_row[op] = ord("D")
            v -= 1
        elif cur == _wrap(int(tape[t - nc]) + gap_i):
            ops_row[op] = ord("I")
            h -= 1
        else:
            ops_row[op] = ord("X") if cur == _wrap(
                int(tape[t - nc - 1]) + mismatch) else ord("M")
            h -= 1
            v -= 1
        op -= 1
    ops_row[op - h + 1:op + 1] = ord("I")
    op -= h
    ops_row[op - v + 1:op + 1] = ord("D")
    op -= v
    return op + 1, end


def band_cells(plens, tlens, scores, gap_i, gap_d):
    """Cells of each pair's (p x t) table on the diagonals |h - v| <= K,
    K = max(|t - p|, S // min(gap_i, gap_d))."""
    p = np.asarray(plens, np.int64)
    t = np.asarray(tlens, np.int64)
    s = np.maximum(np.asarray(scores, np.int64), 0)
    wide = np.maximum(p, t)
    g = min(gap_i, gap_d)
    k = s // g if g > 0 else wide
    k = np.minimum(np.maximum(np.abs(t - p), k), wide)
    hs = np.arange(1, int(t.max(initial=0)) + 1)[None, :]
    lo = np.maximum(1, hs - k[:, None])
    hi = np.minimum(p[:, None], hs + k[:, None])
    per_row = np.where(hs <= t[:, None], np.maximum(hi - lo + 1, 0), 0)
    return per_row.sum(1)


def align(pats, txts, plens, tlens, *, mismatch, gap_i, gap_d,
          backtrace=True, clean_table=False):
    """Scores `[n]` int32; with backtrace ops `[n, 2R]` uint8 with begin
    and end `[n]` int32 (a pair's CIGAR ops are `ops[i, begin[i]:end[i]]`),
    else None for the three; and each pair's band cells `[n]` int64.
    `clean_table` scores and walks plen > tlen + 1 pairs on a table of
    row stride plen + 1 (the control)."""
    n, R = pats.shape
    max_ops = 2 * R
    plens = np.asarray(plens, np.int64)
    tlens = np.asarray(tlens, np.int64)
    scores = np.zeros(n, np.int32)
    ops = np.full((n, max_ops), ord("M"), np.uint8)
    begin = (plens + tlens - 1).astype(np.int32)
    end = (plens + tlens).astype(np.int32)
    for i in range(n):
        p, t = int(plens[i]), int(tlens[i])
        nc = p + 1 if clean_table and p > t + 1 else t + 1
        pat, txt = pats[i], txts[i]
        tape, score = segmented_tape(pat, txt, p, t, mismatch, gap_i, gap_d,
                                     stride=nc)
        if not _sound(tape, mismatch, gap_i, gap_d):
            tape, score = flat_tape_cells(pat.tolist(), txt.tolist(), p, t,
                                          mismatch, gap_i, gap_d, stride=nc)
        scores[i] = score
        if backtrace:
            begin[i], end[i] = _walk(tape, p, t, nc, mismatch, gap_i, gap_d,
                                     ops[i])
    cells = band_cells(plens, tlens, scores, gap_i, gap_d)
    if not backtrace:
        return scores, None, None, None, cells
    return scores, ops, begin, end, cells


def run(pats, txts, plens, tlens, config, control=False):
    """`align` with the penalties a configuration file states; `control`
    scores plen > tlen + 1 pairs on a clean table.  The harness calls every
    reference module so, and reads the last output as `work`'s `extra`."""
    return align(pats, txts, plens, tlens, mismatch=config["mismatch"],
                 gap_i=config["gap_i"], gap_d=config["gap_d"],
                 backtrace=config["backtrace"], clean_table=control)


def work(plens, tlens, cells):
    """(bytes, int32 ops) an NW kernel must do for these pairs: the bytes
    of `roofline.wfa_bytes` (2-bit bases in, a 4-byte score, 2-bit CIGAR
    ops out) and `OPS_PER_CELL` a band cell (`cells`, the reference's
    count a pair)."""
    return (roofline.wfa_bytes(plens, tlens),
            int(round(OPS_PER_CELL * float(np.sum(cells)))))
