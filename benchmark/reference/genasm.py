"""Plain NumPy GenASM: bounded edit distance with traceback.

The repo's GenASM rule (the AIM reference ships GenASM as an empty
submodule, safaad/aim .gitmodules:1-3, so the port defines its output):

- the score is the Levenshtein distance of pattern and text, or k + 1
  where it passes k = MAX_SCORE;
- the CIGAR is the one the NW walker writes at unit costs (mismatch 1,
  gap_i 1, gap_d 1), walking from the end with the priority D (consume
  pattern), then I (consume text), then the diagonal, a diagonal step
  written `M` where the two bases are equal and `X` where not; what is
  left of the text at the table's edge is written as `I`s, then what is
  left of the pattern as `D`s, ops right to left into a buffer filled
  with `M`;
- a pair past k gets no walk: its ops are the buffer's `M`s, begin
  plen + tlen - 1, end plen + tlen.

This module checks that rule without the bitvectors of the GenASM-DC/TB
scheme (Senol Cali et al., MICRO 2020) that the program runs: a unit-cost
edit-distance table, vectorised over the pairs of a block, one text row
at a time.  Where the golden's wording differs:

- The golden keeps a bitvector a distance d <= k; here each cell holds
  the distance itself, capped at k + 1.  The cap is exact: min(x, k + 1)
  commutes with every min and + 1 of the recurrence, and on a walk whose
  cells are at most k a capped neighbour never ties.
- The golden folds a run of D's into one step of its walk; here the walk
  takes one op a step, as the NW walker does.
- The table is the proper 2-D one (text rows, pattern columns), as the
  port's GenASM oracle has it, not the NW oracle's flat tape (row stride
  tlen + 1).  The two agree on every pair within k whose sequences are
  not empty and whose plen is at most tlen + 1; past that the flat tape
  aliases, and on an empty sequence it scores 0.

Within a row the deletion chain is a running minimum: with
a(v) = min(H(h-1, v-1) + (bases differ), H(h-1, v) + 1) and
a(0) = H(h, 0) = h, H(h, v) = min over u <= v of a(u) + v - u, so H is v
plus a prefix minimum of a(u) - u.  A block's table takes at most
`BLOCK_BYTES`.

`control` takes the diagonal first on ties, then I, then D: every
alignment is still optimal and every score exact, but an indel in a run
of equal bases moves to the run's left end, which breaks the guarantee
that each CIGAR is the NW walk's.
"""

from __future__ import annotations

import numpy as np

import roofline

# int32 operations a 32-bit word of a distance level takes at a text
# position (PERF.md's kernel table; chip_smoke.py's CELL_OPS["genasm_word"])
OPS_PER_WORD = 6
WORD_BITS = 32
BLOCK_BYTES = 256 << 20


def _forward(pats, txts, plens, tlens, cap):
    """The table of a block, [T+1, P+1, B] int8 (row, column, pair), each
    cell its distance capped at `cap`."""
    B = len(plens)
    P = int(plens.max(initial=0))
    T = int(tlens.max(initial=0))
    cols = np.arange(P + 1, dtype=np.int16)[:, None]
    tab = np.empty((T + 1, P + 1, B), np.int8)
    tab[0] = np.minimum(cols, cap)
    pat = np.ascontiguousarray(pats[:, :P].T)
    txt = np.ascontiguousarray(txts[:, :T].T)
    q = np.empty((P + 1, B), np.int16)
    for h in range(1, T + 1):
        up = tab[h - 1].astype(np.int16)
        # a(v) - v for v >= 1: the diagonal, then the insertion
        a = up[:-1] + (pat != txt[h - 1])
        np.minimum(a, up[1:] + 1, out=a)
        q[0] = min(h, cap)
        np.subtract(a, cols[1:], out=q[1:])
        np.minimum.accumulate(q, axis=0, out=q)
        q += cols
        np.minimum(q, cap, out=q)
        tab[h] = q
    return tab


def _walk(tab, pats, txts, plens, tlens, walked, max_ops, diagonal_first):
    """Ops, begin and end of a block's pairs; `walked` marks the pairs
    whose distance is at most k."""
    T1, P1, B = tab.shape
    flat = tab.reshape(-1).astype(np.int16)
    row, col = P1 * B, B
    ops = np.full((B, max_ops), ord("M"), np.uint8)
    end = (plens + tlens).astype(np.int64)
    op = end - 1
    h = tlens.astype(np.int64)
    v = plens.astype(np.int64)
    live = np.nonzero(walked & (h > 0) & (v > 0))[0]
    while len(live):
        hl, vl = h[live], v[live]
        t = hl * row + vl * col + live
        cur = flat[t]
        to_d = cur == flat[t - col] + 1
        to_i = cur == flat[t - row] + 1
        same = pats[live, vl - 1] == txts[live, hl - 1]
        if diagonal_first:
            diag = cur == flat[t - row - col] + ~same
            to_i &= ~diag
            to_d &= ~diag & ~to_i
        else:
            to_i &= ~to_d
        ops[live, op[live]] = np.where(
            to_d, ord("D"), np.where(to_i, ord("I"),
                                     np.where(same, ord("M"), ord("X"))))
        op[live] -= 1
        h[live] -= ~to_d
        v[live] -= ~to_i
        live = live[(h[live] > 0) & (v[live] > 0)]
    cols = np.arange(max_ops)[None, :]
    w = walked[:, None]
    fill_i = w & (cols > (op - h)[:, None]) & (cols <= op[:, None])
    op = np.where(walked, op - h, op)
    fill_d = w & (cols > (op - v)[:, None]) & (cols <= op[:, None])
    op = np.where(walked, op - v, op)
    ops[fill_i] = ord("I")
    ops[fill_d] = ord("D")
    begin = np.where(walked, op + 1, end - 1)
    return ops, begin.astype(np.int32), end.astype(np.int32)


def align(pats, txts, plens, tlens, *, max_score, backtrace=True,
          diagonal_first=False, block=None):
    """Scores `[n]` int32; with backtrace ops `[n, 2R]` uint8 with begin
    and end `[n]` int32 (a pair's CIGAR ops are `ops[i, begin[i]:end[i]]`),
    else None for the three; and each pair's distance levels, k + 1.
    `diagonal_first` breaks ties diagonal first (the control)."""
    n, R = pats.shape
    max_ops = 2 * R
    k = int(max_score)
    cap = k + 1
    if cap > 127:
        raise ValueError(f"max_score {k}: the table's int8 cells hold at "
                         "most 127")
    plens = np.asarray(plens, np.int64)
    tlens = np.asarray(tlens, np.int64)
    scores = np.zeros(n, np.int32)
    ops = np.full((n, max_ops), ord("M"), np.uint8)
    begin = (plens + tlens - 1).astype(np.int32)
    end = (plens + tlens).astype(np.int32)
    if block is None:
        block = max(1, BLOCK_BYTES // ((R + 1) * (R + 1)))
    for lo in range(0, n, block):
        r = slice(lo, min(lo + block, n))
        tab = _forward(pats[r], txts[r], plens[r], tlens[r], cap)
        sc = tab[tlens[r], plens[r], np.arange(len(plens[r]))]
        scores[r] = sc
        if backtrace:
            ops[r], begin[r], end[r] = _walk(
                tab, pats[r], txts[r], plens[r], tlens[r], sc <= k,
                max_ops, diagonal_first)
    levels = np.full(n, cap, np.int64)
    if not backtrace:
        return scores, None, None, None, levels
    return scores, ops, begin, end, levels


def run(pats, txts, plens, tlens, config, control=False):
    """`align` with the cap a configuration file states; `control` breaks
    ties diagonal first.  The harness calls every reference module so, and
    reads the last output as `work`'s `extra`."""
    return align(pats, txts, plens, tlens, max_score=config["max_score"],
                 backtrace=config["backtrace"], diagonal_first=control)


def work(plens, tlens, levels):
    """(bytes, int32 ops) a GenASM kernel must do for these pairs: the
    bytes of `roofline.wfa_bytes` (2-bit bases in, a 4-byte score, 2-bit
    CIGAR ops out) and `OPS_PER_WORD` for each 32-bit word of a pair's
    plen + 1 bits, each of its `levels` distance levels (k + 1) and each
    text position."""
    p = np.asarray(plens, np.int64)
    t = np.asarray(tlens, np.int64)
    words = -(-(p + 1) // WORD_BITS)
    return (roofline.wfa_bytes(p, t),
            int(round(OPS_PER_WORD * float(
                np.sum(np.asarray(levels, np.float64) * t * words)))))
