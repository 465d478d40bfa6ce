"""Plain NumPy SWG (Smith-Waterman-Gotoh): global, minimising, gap-affine,
with backtrace.

The semantics of the AIM reference's DPU-WRAM SWG (safaad/aim,
SWG/DPU-WRAM/dpu/swg.c and its launcher run-swg-pim-wram.py), vectorised
over the pairs of a block, one text row at a time:

- Three tapes M, I and D of the reference's cell type: int8 when
  MAX_SCORE < 127 (the configuration's `cell_width` 1), else int16.
  Every sum is taken in int and stored wrapped to the cell type, and
  ties are compared on the stored values, sums wrapped likewise.
- Row 0 holds D = gap_o + v * gap_e, M = D, I = MAX_SCORE; column 0
  holds I = gap_o + h * gap_e, M = I, D = MAX_SCORE; cell (0, 0) holds
  M = 0 and I = D = MAX_SCORE.  A cell is
  D = min(M(h, v-1) + gap_o + gap_e, D(h, v-1) + gap_e),
  I = min(M(h-1, v) + gap_o + gap_e, I(h-1, v) + gap_e),
  M = min(M(h-1, v-1) + (match or mismatch), I, D); the score is the
  last cell computed, (tlen, plen).
- The tapes are one flat buffer `dp[(tlen+1)*h + v]` with v up to plen.
  Where plen == tlen + 1, column plen of row h is column 0 of row h+1:
  row 0's column plen reads as row 1's column-0 start, and from row 2 on
  column 0 holds the row above's column plen.  Pairs with plen > tlen + 1
  alias further and are simulated on the flat tape in program order, as
  are the rare pairs whose values come near the cell type's range (there
  the wrap decides) and pairs with an empty sequence.
- The backtrace walks the final tapes from (tlen, plen) with a 3-layer
  automaton: on M it takes D if M == D, else I if M == I, else a match if
  M == M(h-1, v-1) + match, else a mismatch if M == M(h-1, v-1) +
  mismatch (no base is compared), else it writes `?` and stops; on D it
  writes `D` and returns to M when D == M(h, v-1) + gap_o + gap_e, on I
  likewise.  What is left of either sequence becomes `I`s, then `D`s.
  Ops are written right to left into a buffer filled with `M`.

Within a row the deletion chain is a running minimum: with
a(v) = min(diagonal, I), D(v) = min(a(v-1) + gap_o + gap_e, D(v-1) + g),
g = min(gap_o + gap_e, gap_e), so D is g * v plus a prefix minimum.
That holds in exact arithmetic, which the cell type keeps where no sum
wraps: a block's tables are kept in exact values, each pair's are checked
to stay inside the cell type with every step added, and the pairs that
do not go to the flat-tape simulation.  A block's three tables take at
most `BLOCK_BYTES`.

`align` returns scores, the ops buffer with begin and end offsets (the
layout the output writer reads), and each pair's band cells: the cells
of the (p x t) table on the diagonals |h - v| <= K, K = max(|t - p|,
max(0, S - gap_o) // gap_e) with S the pair's score, the widest band an
alignment of cost at most S can touch.
"""

from __future__ import annotations

import numpy as np

import roofline

# int32 operations an SWG cell takes (the three recurrences and the
# traceback's compares), as PERF.md's kernel table counts them
OPS_PER_CELL = 14
BLOCK_BYTES = 256 << 20
_LIMITS = {1: (-128, 127), 2: (-32768, 32767)}


def _wrap(x: int, width: int) -> int:
    bits = 8 * width
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _flat_tape(pat, txt, plen, tlen, match, mismatch, o, e, smax, width,
               read_size, max_ops, ops_row, x_char):
    """One pair on the flat tape, in program order: (score, begin, end)."""
    nc = tlen + 1
    size = (read_size + 1) * (read_size + 1) + read_size + 2
    m = [0] * size
    d = [0] * size
    i_ = [0] * size

    def w(x):
        return _wrap(x, width)

    oe = o + e
    d[0] = w(smax)
    i_[0] = w(smax)
    m[0] = 0
    for v in range(1, plen + 1):
        d[v] = w(o + v * e)
        i_[v] = w(smax)
        m[v] = d[v]
    for h in range(1, tlen + 1):
        t = h * nc
        d[t] = w(smax)
        i_[t] = w(o + h * e)
        m[t] = i_[t]
    score = 0
    for h in range(1, tlen + 1):
        tc = txt[h - 1]
        for v in range(1, plen + 1):
            t = h * nc + v
            dl = min(w(m[t - 1] + oe), w(d[t - 1] + e))
            d[t] = dl
            ins = min(w(m[t - nc] + oe), w(i_[t - nc] + e))
            i_[t] = ins
            dg = w(m[t - nc - 1] + (match if pat[v - 1] == tc else mismatch))
            best = min(dg, ins, dl)
            m[t] = best
            score = best
    end = plen + tlen
    op = end - 1
    h, v, layer = tlen, plen, 0
    while h > 0 and v > 0:
        t = h * nc + v
        if layer == 2:
            ops_row[op] = ord("D")
            op -= 1
            if d[t] == w(m[t - 1] + oe):
                layer = 0
            v -= 1
        elif layer == 1:
            ops_row[op] = ord("I")
            op -= 1
            if i_[t] == w(m[t - nc] + oe):
                layer = 0
            h -= 1
        elif m[t] == d[t]:
            layer = 2
        elif m[t] == i_[t]:
            layer = 1
        elif m[t] == w(m[t - nc - 1] + match):
            ops_row[op] = ord("M")
            op -= 1
            h -= 1
            v -= 1
        elif m[t] == w(m[t - nc - 1] + mismatch):
            ops_row[op] = x_char
            op -= 1
            h -= 1
            v -= 1
        else:
            ops_row[op] = ord("?")
            op -= 1
            break
    ops_row[op - h + 1:op + 1] = ord("I")
    op -= h
    ops_row[op - v + 1:op + 1] = ord("D")
    op -= v
    return score, op + 1, end


def _compute_type(P, T, match, mismatch, o, e, smax):
    """int16 where no value of a (T+1) x (P+1) table, nor a step added to
    one, can leave it; else int64."""
    step = abs(o) + abs(e) + abs(match) + abs(mismatch)
    bound = abs(smax) + abs(o) + (P + T + 2) * step
    return np.int16 if bound < 30000 else np.int64


def _forward(pats, txts, plens, tlens, match, mismatch, o, e, smax, width):
    """The tapes of a block of pairs with 1 <= plen <= tlen + 1, each
    [T+1, P+1, B] (row, column, pair); the scores; and which pairs stay
    inside the cell type's range with every step added, where the cell
    type's wrap never acts and exact values are the reference's."""
    lo_c, hi_c = _LIMITS[width]
    B = len(plens)
    P = int(plens.max())
    T = int(tlens.max())
    dt = _compute_type(P, T, match, mismatch, o, e, smax)
    oe = o + e
    g = min(oe, e)
    steps = (oe, e, match, mismatch)
    pl = plens.astype(np.int64)
    tl = tlens.astype(np.int64)
    pairs = np.arange(B)
    cols = np.arange(P + 1, dtype=np.int64)
    a = np.nonzero(pl == tl + 1)[0]       # the aliased pairs
    pa = pl[a]
    tm = np.empty((T + 1, P + 1, B), dt)
    ti = np.empty_like(tm)
    td = np.empty_like(tm)
    # row 0, and for aliased pairs its column plen read as row 1's start
    tm[0] = (o + cols * e)[:, None]
    tm[0, 0] = 0
    td[0] = tm[0]
    td[0, 0] = smax
    ti[0] = smax
    tm[0, pa, a] = oe
    ti[0, pa, a] = oe
    td[0, pa, a] = smax
    pat = np.ascontiguousarray(pats[:, :P].T)
    txt = np.ascontiguousarray(txts[:, :T].T)
    cost_m, cost_x = dt(match), dt(mismatch)
    # q[v-1] + g * v is D(v): the running minimum of the deletion chain
    lift = (oe - g * cols[2:]).astype(dt)[:, None]
    gv = (g * cols[1:]).astype(dt)[:, None]
    q = np.empty((P, B), dt)
    for h in range(1, T + 1):
        mp, ip = tm[h - 1], ti[h - 1]
        ins = ti[h, 1:]
        np.minimum(mp[1:] + dt(oe), ip[1:] + dt(e), out=ins)
        av = mp[:-1] + np.where(pat == txt[h - 1], cost_m, cost_x)
        np.minimum(av, ins, out=av)
        # column 0: the start, or (aliased, from row 2) the row above's
        # column plen
        tm[h, 0] = o + h * e
        ti[h, 0] = o + h * e
        td[h, 0] = smax
        if h >= 2 and len(a):
            tm[h, 0, a] = mp[pa, a]
            ti[h, 0, a] = ip[pa, a]
            td[h, 0, a] = td[h - 1, pa, a]
        q[0] = np.minimum(tm[h, 0] + dt(oe), td[h, 0] + dt(e)) - dt(g)
        np.add(av[:-1], lift, out=q[1:])
        np.minimum.accumulate(q, axis=0, out=q)
        dl = td[h, 1:]
        np.add(q, gv, out=dl)
        np.minimum(av, dl, out=tm[h, 1:])
    # every cell of a pair's columns, its padding's too: a bound at least
    # as wide as the cells the pair reads
    vmax = np.maximum(np.maximum(tm.max((0, 1)), ti.max((0, 1))),
                      td.max((0, 1))).astype(np.int64)
    vmin = np.minimum(np.minimum(tm.min((0, 1)), ti.min((0, 1))),
                      td.min((0, 1))).astype(np.int64)
    sound = (vmax + max(max(steps), 0) <= hi_c) \
        & (vmin + min(min(steps), 0) >= lo_c)
    scores = tm[tl, pl, pairs].astype(np.int32)
    return (tm, ti, td), scores, sound


def _backtrace(tapes, plens, tlens, match, mismatch, o, e, max_ops,
               x_char):
    """The ops of a block from its final tapes, [T+1, P+1, B] each:
    (ops, begin, end).  Exact values: the block's sound pairs, where no
    sum wraps."""
    T1, P1, B = tapes[0].shape
    tm, ti, td = (t.reshape(-1) for t in tapes)
    oe = o + e
    row, col = P1 * B, B
    ops = np.full((B, max_ops), ord("M"), np.uint8)
    end = (plens + tlens).astype(np.int64)
    op = end - 1
    h = tlens.astype(np.int64)
    v = plens.astype(np.int64)
    layer = np.zeros(B, np.int8)
    live = np.nonzero((h > 0) & (v > 0))[0]
    while len(live):
        ly = layer[live]
        t = h[live] * row + v[live] * col + live
        on_d, on_i, on_m = ly == 2, ly == 1, ly == 0
        # layer D: write D; back to M where D was opened here
        j, tj = live[on_d], t[on_d]
        ops[j, op[j]] = ord("D")
        op[j] -= 1
        layer[j[td[tj] == tm[tj - col] + oe]] = 0
        v[j] -= 1
        # layer I likewise
        j, tj = live[on_i], t[on_i]
        ops[j, op[j]] = ord("I")
        op[j] -= 1
        layer[j[ti[tj] == tm[tj - row] + oe]] = 0
        h[j] -= 1
        # layer M: D, then I, then match, then mismatch
        j, tj = live[on_m], t[on_m]
        m = tm[tj].astype(np.int64)
        to_d = m == td[tj]
        to_i = ~to_d & (m == ti[tj])
        diag = tm[tj - row - col].astype(np.int64)
        mat = ~to_d & ~to_i & (m == diag + match)
        mis = ~to_d & ~to_i & ~mat & (m == diag + mismatch)
        bad = ~(to_d | to_i | mat | mis)
        layer[j[to_d]] = 2
        layer[j[to_i]] = 1
        step = j[mat | mis]
        ops[step, op[step]] = np.where(mat, ord("M"), x_char)[mat | mis]
        jb = j[bad]
        ops[jb, op[jb]] = ord("?")
        op[step] -= 1
        op[jb] -= 1
        h[step] -= 1
        v[step] -= 1
        keep = np.ones(len(live), bool)
        keep[np.nonzero(on_m)[0][bad]] = False
        live = live[keep]
        live = live[(h[live] > 0) & (v[live] > 0)]
    cols = np.arange(max_ops)[None, :]
    fill_i = (cols > (op - h)[:, None]) & (cols <= op[:, None])
    op = op - h
    fill_d = (cols > (op - v)[:, None]) & (cols <= op[:, None])
    op = op - v
    ops[fill_i] = ord("I")
    ops[fill_d] = ord("D")
    return ops, (op + 1).astype(np.int32), end.astype(np.int32)


def band_cells(plens, tlens, scores, gap_o, gap_e):
    """Cells of each pair's (p x t) table on the diagonals |h - v| <= K,
    K = max(|t - p|, max(0, S - gap_o) // gap_e)."""
    p = np.asarray(plens, np.int64)
    t = np.asarray(tlens, np.int64)
    s = np.asarray(scores, np.int64)
    wide = np.maximum(p, t)
    if gap_e > 0:
        k = np.maximum(0, s - gap_o) // gap_e
    else:
        k = wide
    k = np.minimum(np.maximum(np.abs(t - p), k), wide)
    hs = np.arange(1, int(t.max(initial=0)) + 1)[None, :]
    lo = np.maximum(1, hs - k[:, None])
    hi = np.minimum(p[:, None], hs + k[:, None])
    per_row = np.where(hs <= t[:, None], np.maximum(hi - lo + 1, 0), 0)
    return per_row.sum(1)


def align(pats, txts, plens, tlens, *, match, mismatch, gap_opening,
          gap_extending, max_score, cell_width, backtrace=True,
          mismatch_as_match=False, block=None):
    """Scores `[n]` int32; with backtrace ops `[n, 2R]` uint8 with begin
    and end `[n]` int32 (a pair's CIGAR ops are `ops[i, begin[i]:end[i]]`),
    else None for the three; and each pair's band cells `[n]` int64.
    `mismatch_as_match` writes mismatches as `M` (the control)."""
    n, R = pats.shape
    max_ops = 2 * R
    o, e = gap_opening, gap_extending
    plens = np.asarray(plens, np.int64)
    tlens = np.asarray(tlens, np.int64)
    x_char = ord("M") if mismatch_as_match else ord("X")
    scores = np.zeros(n, np.int32)
    ops = np.full((n, max_ops), ord("M"), np.uint8)
    begin = (plens + tlens - 1).astype(np.int32)
    end = (plens + tlens).astype(np.int32)
    rows = np.nonzero((plens >= 1) & (tlens >= 1) & (plens <= tlens + 1))[0]
    if block is None:
        per_pair = 3 * (R + 1) * (R + 1) * np.dtype(_compute_type(
            R, R, match, mismatch, o, e, max_score)).itemsize
        block = max(1, BLOCK_BYTES // per_pair)
    slow = [np.nonzero(~np.isin(np.arange(n), rows))[0]]
    for lo in range(0, len(rows), block):
        r = rows[lo:lo + block]
        tapes, sc, sound = _forward(pats[r], txts[r], plens[r], tlens[r],
                                    match, mismatch, o, e, max_score,
                                    cell_width)
        scores[r] = sc
        if backtrace:
            ops[r], begin[r], end[r] = _backtrace(
                tapes, plens[r], tlens[r], match, mismatch, o, e, max_ops,
                x_char)
        slow.append(r[~sound])
    for i in np.sort(np.concatenate(slow)).tolist():
        row = np.full(max_ops, ord("M"), np.uint8)
        scores[i], b, en = _flat_tape(
            pats[i].tolist(), txts[i].tolist(), int(plens[i]),
            int(tlens[i]), match, mismatch, o, e, max_score, cell_width, R,
            max_ops, row, x_char)
        if backtrace:
            ops[i], begin[i], end[i] = row, b, en
    cells = band_cells(plens, tlens, scores, o, e)
    if not backtrace:
        return scores, None, None, None, cells
    return scores, ops, begin, end, cells


def run(pats, txts, plens, tlens, config, control=False):
    """`align` with the penalties, cell width and cap a configuration file
    states; `control` writes mismatches as `M`.  The harness calls every
    reference module so, and reads the last output as `work`'s `extra`."""
    return align(pats, txts, plens, tlens, match=config["match"],
                 mismatch=config["mismatch"],
                 gap_opening=config["gap_opening"],
                 gap_extending=config["gap_extending"],
                 max_score=config["max_score"],
                 cell_width=config["cell_width"],
                 backtrace=config["backtrace"], mismatch_as_match=control)


def work(plens, tlens, cells):
    """(bytes, int32 ops) an SWG kernel must do for these pairs: the bytes
    of `roofline.wfa_bytes` (2-bit bases in, a 4-byte score, 2-bit CIGAR
    ops out) and `OPS_PER_CELL` a band cell (`cells`, the reference's
    count a pair)."""
    return (roofline.wfa_bytes(plens, tlens),
            int(round(OPS_PER_CELL * float(np.sum(cells)))))
