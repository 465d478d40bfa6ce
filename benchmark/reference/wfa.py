"""Plain NumPy gap-affine WFA and WFA-adaptive, with backtrace.

The semantics of the AIM reference's DPU-MRAM WFA (safaad/aim,
WFA/DPU-MRAM/dpu/wfa.c and wfa_backtracing.c), vectorised over pairs: the
wavefronts of one score level are computed for every pair of a block at
once, and the backtrace walks every pair one step a round.

- Offsets live in int16 with NULL = INT16_MIN / 2 (the reference's
  `ewf_offset_t`).  A component whose source wavefronts are all null
  contributes -10 to the M maximum, as the reference's locals do.
- Score 0 holds diagonal 0 at offset 0.  A level extends along matches,
  then WFA-adaptive reduces it when it spans `min_wavefront_length`
  diagonals or more: diagonals whose remaining distance exceeds the
  least by more than `max_distance_threshold` are cut from either end,
  never past the alignment diagonal; a level cut to nothing is nulled
  with its extents kept.  A pair ends at the first level whose M
  wavefront reaches the end on its alignment diagonal, or at
  `max_score + 1` (overflow, no CIGAR).
- The backtrace prefers, at each step, deletion-extend, deletion-open,
  insertion-extend, insertion-open, then mismatch, and writes matches
  between them; CIGAR ops fill a buffer of `M` from its end.

`align` returns scores, the ops buffer with begin and end offsets (the
layout the output writer reads), and the cells each pair computed.
"""

from __future__ import annotations

import numpy as np

NULL = -16384
_I16 = np.int16


def _forward(pats, txts, plens, tlens, x, o, e, smax, reduce, min_len,
             max_dist):
    P, R = pats.shape
    K = 2 * smax + 1
    L = K + 2                    # one pad lane each side: lane = k + smax + 1
    S1 = smax + 1
    hm = np.full((P, S1, L), NULL, _I16)
    hi_ = np.full((P, S1, L), NULL, _I16)
    hd = np.full((P, S1, L), NULL, _I16)
    klo = np.zeros((P, S1), np.int32)
    khi = np.zeros((P, S1), np.int32)
    flags = np.zeros((P, S1), np.uint8)
    hm[:, 0, smax + 1] = 0
    flags[:, 0] = 1 | 4 | 8
    plens = plens.astype(np.int32)
    tlens = tlens.astype(np.int32)
    ak = tlens - plens
    scores = np.full(P, smax + 1, np.int32)
    cells = np.ones(P, np.int64)
    active = np.ones(P, bool)
    ks = np.arange(-smax - 1, smax + 2, dtype=np.int32)   # k of each lane
    pflat = pats.reshape(-1)
    tflat = txts.reshape(-1)
    W = 16
    jj = np.arange(W, dtype=np.int32)
    for s in range(S1):
        act = np.nonzero(active)[0]
        if not len(act):
            break
        f = flags[act, s]
        m = hm[act, s].astype(np.int32)
        lo = klo[act, s]
        hi = khi[act, s]
        mnull = ((f & 1) == 0) | ((f >> 1) & 1 == 1)
        # ---- extend ----
        cand = (~mnull[:, None]) & (ks[None, :] >= lo[:, None]) \
            & (ks[None, :] <= hi[:, None]) & (m >= 0)
        ci, cl = np.nonzero(cand)
        off = m[ci, cl]
        v = off - ks[cl]
        pl = plens[act[ci]]
        tl = tlens[act[ci]]
        base = act[ci].astype(np.int64) * R
        go = (v >= 0) & (v < pl) & (off < tl)
        idx = np.nonzero(go)[0]
        while len(idx):
            vv = v[idx][:, None] + jj
            hh = off[idx][:, None] + jj
            ok = (vv < pl[idx][:, None]) & (hh < tl[idx][:, None])
            b = base[idx][:, None]
            eq = ok & (pflat[b + np.minimum(vv, R - 1)]
                       == tflat[b + np.minimum(hh, R - 1)])
            run = np.where(eq.all(1), W, np.argmin(eq, axis=1))
            v[idx] += run
            off[idx] += run
            idx = idx[run == W]
        m[ci, cl] = off
        # ---- reduce (WFA-adaptive) ----
        if reduce:
            red = (~mnull) & ((hi - lo + 1) >= min_len)
            if red.any():
                ra = np.nonzero(red)[0]
                mr = m[ra]
                rlo, rhi = lo[ra], hi[ra]
                pl_r = plens[act[ra]][:, None]
                tl_r = tlens[act[ra]][:, None]
                inr = (ks[None, :] >= rlo[:, None]) & (ks[None, :] <= rhi[:, None])
                dist = np.maximum(pl_r - (mr - ks[None, :]), tl_r - mr)
                min_d = np.minimum(np.maximum(pl_r[:, 0], tl_r[:, 0]),
                                   np.where(inr, dist, 1 << 30).min(1))
                near = inr & (dist - min_d[:, None] <= max_dist)
                akr = ak[act[ra]]
                top = np.minimum(akr - 1, rhi)
                big = 1 << 30
                first = np.where(near & (ks[None, :] < top[:, None]),
                                 ks[None, :], big).min(1)
                nlo = np.maximum(rlo, np.minimum(top, first))
                bottom = np.maximum(akr + 1, nlo)
                last = np.where(near & (ks[None, :] > bottom[:, None]),
                                ks[None, :], -big).max(1)
                nhi = np.minimum(rhi, np.maximum(bottom, last))
                empty = nlo > nhi
                nlo = np.where(empty, rlo, nlo)
                nhi = np.where(empty, rhi, nhi)
                f2 = f[ra] | np.where(empty, 2 | 4 | 8, 0).astype(np.uint8)
                f[ra] = f2
                lo[ra] = nlo
                hi[ra] = nhi
                mnull = ((f & 1) == 0) | ((f >> 1) & 1 == 1)
                flags[act, s] = f
                klo[act, s] = lo
                khi[act, s] = hi
        hm[act, s] = m.astype(_I16)
        # ---- end reached? ----
        aka = ak[act]
        lane = np.clip(aka + smax + 1, 0, L - 1)
        end = (~mnull) & (lo <= aka) & (aka <= hi) & (np.abs(aka) <= smax) \
            & (m[np.arange(len(act)), lane] >= tlens[act])
        scores[act[end]] = s
        active[act[end]] = False
        if s == smax:
            break
        act = act[~end]
        if not len(act):
            break
        # ---- next level s + 1 ----
        n1 = s + 1

        def comp(level, bit):
            if level < 0:
                return np.ones(len(act), bool)
            fl = flags[act, level]
            return ((fl & 1) == 0) | ((fl >> bit) & 1 == 1)

        s_sub, s_o, s_e = n1 - x, n1 - o - e, n1 - e
        m_sub_null = comp(s_sub, 1)
        m_o_null = comp(s_o, 1)
        i_e_null = comp(s_e, 2)
        d_e_null = comp(s_e, 3)
        i_out_null = m_o_null & i_e_null
        d_out_null = m_o_null & d_e_null
        gone = m_sub_null & i_out_null & d_out_null
        flags[act[gone], n1] = 0
        klo[act[gone], n1] = 1
        khi[act[gone], n1] = -1
        keep = ~gone
        a = act[keep]
        if not len(a):
            continue
        m_sub_null, m_o_null = m_sub_null[keep], m_o_null[keep]
        i_e_null, d_e_null = i_e_null[keep], d_e_null[keep]
        i_out_null, d_out_null = i_out_null[keep], d_out_null[keep]

        def ext(level, null):
            if level < 0:
                return (np.ones(len(a), np.int32), -np.ones(len(a), np.int32))
            return (np.where(null, 1, klo[a, level]),
                    np.where(null, -1, khi[a, level]))

        sub_lo, sub_hi = ext(s_sub, m_sub_null)
        o_lo, o_hi = ext(s_o, m_o_null)
        e_lo, e_hi = ext(s_e, i_e_null & d_e_null)
        nlo = np.maximum(np.minimum(np.minimum(sub_lo, o_lo), e_lo) - 1, -smax)
        nhi = np.minimum(np.maximum(np.maximum(sub_hi, o_hi), e_hi) + 1, smax)
        klo[a, n1] = nlo
        khi[a, n1] = nhi
        flags[a, n1] = 1 | (i_out_null.astype(np.uint8) << 2) \
            | (d_out_null.astype(np.uint8) << 3)
        cells[a] += np.maximum(nhi - nlo + 1, 0)

        def row(arr, level):
            if level < 0:
                return np.full((len(a), L), NULL, np.int32)
            return arr[a, level].astype(np.int32)

        zero = np.full((len(a), 1), NULL, np.int32)
        mo = row(hm, s_o)
        ie = row(hi_, s_e)
        de = row(hd, s_e)
        ms = row(hm, s_sub)
        kk = ks[None, :]
        # sources at k - 1 (insertion) and k + 1 (deletion), by lane shift
        mo_l = np.concatenate([zero, mo[:, :-1]], 1)
        ie_l = np.concatenate([zero, ie[:, :-1]], 1)
        mo_r = np.concatenate([mo[:, 1:], zero], 1)
        de_r = np.concatenate([de[:, 1:], zero], 1)

        def inb(lo_, hi_v, kv):
            return (lo_[:, None] <= kv) & (kv <= hi_v[:, None])

        ins_g = np.where((~m_o_null)[:, None] & inb(o_lo, o_hi, kk - 1),
                         mo_l, NULL)
        ins_i = np.where((~i_e_null)[:, None] & inb(e_lo, e_hi, kk - 1),
                         ie_l, NULL)
        ins = np.where((ins_g == NULL) & (ins_i == NULL), NULL,
                       np.maximum(ins_g, ins_i) + 1)
        ins = np.where(i_out_null[:, None], -10, ins)
        del_g = np.where((~m_o_null)[:, None] & inb(o_lo, o_hi, kk + 1),
                         mo_r, NULL)
        del_d = np.where((~d_e_null)[:, None] & inb(e_lo, e_hi, kk + 1),
                         de_r, NULL)
        dele = np.maximum(del_g, del_d)
        dele = np.where(d_out_null[:, None], -10, dele)
        sub = np.where(inb(sub_lo, sub_hi, kk), ms + 1, NULL)
        sub = np.where(m_sub_null[:, None], -10, sub)
        band = inb(nlo, nhi, kk)
        hm[a, n1] = np.where(band, np.maximum(np.maximum(dele, sub), ins),
                             NULL).astype(_I16)
        hi_[a, n1] = np.where(band & ~i_out_null[:, None], ins,
                              NULL).astype(_I16)
        hd[a, n1] = np.where(band & ~d_out_null[:, None], dele,
                             NULL).astype(_I16)
    return scores, cells, (hm, hi_, hd, klo, khi, flags)


def _backtrace(hist, scores, plens, tlens, x, o, e, smax, max_ops,
               mismatch_as_match=False):
    hm, hi_, hd, klo, khi, flags = hist
    P = len(scores)
    ops = np.full((P, max_ops), ord("M"), np.uint8)
    plens = plens.astype(np.int64)
    tlens = tlens.astype(np.int64)
    ak = tlens - plens
    end = plens + tlens
    op = end - 1
    begin = op.copy()
    bt = np.nonzero(scores <= smax)[0]
    if not len(bt):
        return ops, begin.astype(np.int32), end.astype(np.int32)
    sc = scores[bt].astype(np.int64)
    k = ak[bt].copy()
    pl, tl = plens[bt], tlens[bt]
    opp = op[bt].copy()

    def read(arr, lvl, kv, bit, rows):
        ok = lvl >= 0
        lv = np.where(ok, lvl, 0)
        fl = flags[rows, lv]
        ok &= (fl & 1) == 1
        if bit:
            ok &= ((fl >> bit) & 1) == 0
        ok &= (klo[rows, lv] <= kv) & (kv <= khi[rows, lv]) & (np.abs(kv) <= smax)
        lane = np.clip(kv + smax + 1, 0, 2 * smax + 2)
        val = arr[rows, lv, lane].astype(np.int64)
        return ok, val

    ok, val = read(hm, sc, k, 0, bt)
    offset = np.where(ok, val, NULL)
    v, h = offset - k, offset.copy()
    valid = (v > 0) & (v <= pl) & (h > 0) & (h <= tl)
    btype = np.zeros(len(bt), np.int64)
    live = (v > 0) & (h > 0) & (sc > 0)
    X = ord("X") if not mismatch_as_match else ord("M")
    while live.any():
        i = np.nonzero(live)[0]
        rows = bt[i]
        # a path that re-enters the matrix adds its trailing gap
        newly = (~valid[i]) & (v[i] > 0) & (v[i] <= pl[i]) & (h[i] > 0) \
            & (h[i] <= tl[i])
        for j in np.nonzero(newly)[0]:
            q = i[j]
            r = bt[q]
            n_gap = abs(int(ak[r] - k[q]))
            ch = ord("I") if k[q] < ak[r] else ord("D")
            ops[r, opp[q] - n_gap + 1:opp[q] + 1] = ch
            opp[q] -= n_gap
        valid[i] |= newly
        s_i, k_i, bty = sc[i], k[i], btype[i]
        s_o, s_e, s_x = s_i - o - e, s_i - e, s_i - x
        ok, dv = read(hd, s_e, k_i + 1, 3, rows)
        d_ext = np.where(ok & (bty != 1), dv, NULL)
        ok, mv = read(hm, s_o, k_i + 1, 0, rows)
        d_open = np.where(ok & (bty != 1), mv, NULL)
        ok, iv = read(hi_, s_e, k_i - 1, 2, rows)
        i_ext = np.where(ok & (bty != 2), iv + 1, NULL)
        ok, mv = read(hm, s_o, k_i - 1, 0, rows)
        i_open = np.where(ok & (bty != 2), mv + 1, NULL)
        ok, mv = read(hm, s_x, k_i, 0, rows)
        sub = np.where(ok & (bty == 0), mv + 1, NULL)
        best = np.maximum(sub, np.maximum(np.maximum(i_ext, i_open),
                                          np.maximum(d_ext, d_open)))
        off = offset[i]
        on_m = bty == 0
        opp[i] -= np.where(on_m, np.maximum(off - best, 0), 0)
        off = np.where(on_m, best, off)
        vv, hh = off - k_i, off
        stop = on_m & ((vv <= 0) | (hh <= 0))
        offset[i] = off
        v[i], h[i] = vv, hh
        go = ~stop
        g = i[go]
        bst = best[go]
        c_de = bst == d_ext[go]
        c_do = ~c_de & (bst == d_open[go])
        c_ie = ~c_de & ~c_do & (bst == i_ext[go])
        c_io = ~c_de & ~c_do & ~c_ie & (bst == i_open[go])
        c_x = ~c_de & ~c_do & ~c_ie & ~c_io & (bst == sub[go])
        c_no = ~(c_de | c_do | c_ie | c_io | c_x)
        ch = np.select([c_de | c_do, c_ie | c_io, c_x], [ord("D"), ord("I"), X],
                       ord("?"))
        write = valid[g] | c_no
        ops[bt[g[write]], opp[g[write]]] = ch[write]
        opp[g[write]] -= 1
        sc[g] = np.select([c_de | c_ie, c_do | c_io, c_x],
                          [s_e[go], s_o[go], s_x[go]], sc[g])
        k[g] += np.where(c_de | c_do, 1, np.where(c_ie | c_io, -1, 0))
        offset[g] -= np.where(c_ie | c_io | c_x, 1, 0)
        btype[g] = np.select([c_de, c_ie, c_do | c_io], [2, 1, 0], btype[g])
        v[g], h[g] = offset[g] - k[g], offset[g]
        live[i[stop]] = False
        live[g[c_no]] = False
        live[g] = live[g] & (v[g] > 0) & (h[g] > 0) & (sc[g] > 0)
    zero = sc == 0
    opp -= np.where(zero, np.maximum(offset, 0), 0)
    for q in np.nonzero(~zero)[0]:
        r = bt[q]
        nd, ni = max(int(v[q]), 0), max(int(h[q]), 0)
        ops[r, opp[q] - nd + 1:opp[q] + 1] = ord("D")
        opp[q] -= nd
        ops[r, opp[q] - ni + 1:opp[q] + 1] = ord("I")
        opp[q] -= ni
    begin[bt] = opp + 1
    return ops, begin.astype(np.int32), end.astype(np.int32)


def align(pats, txts, plens, tlens, *, mismatch, gap_opening, gap_extending,
          max_score, adaptive, min_wavefront_length=10,
          max_distance_threshold=50, mismatch_as_match=False, block=None):
    """Scores `[n]` int32, ops `[n, 2R]` uint8 with begin and end `[n]`
    int32 (a pair's CIGAR ops are `ops[i, begin[i]:end[i]]`), and the WFA
    cells each pair computed `[n]` int64.  `mismatch_as_match` writes
    mismatches as `M`, the CIGAR of SAM's `M` convention (the control)."""
    n, R = pats.shape
    max_ops = 2 * R
    if block is None:
        per_pair = 3 * 2 * (max_score + 1) * (2 * max_score + 3) + 4 * R
        block = max(1, min(n, (768 << 20) // per_pair))
    scores = np.zeros(n, np.int32)
    cells = np.zeros(n, np.int64)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)
    for lo in range(0, n, block):
        sl = slice(lo, min(n, lo + block))
        sc, ce, hist = _forward(pats[sl], txts[sl], plens[sl], tlens[sl],
                                mismatch, gap_opening, gap_extending,
                                max_score, adaptive, min_wavefront_length,
                                max_distance_threshold)
        scores[sl], cells[sl] = sc, ce
        ops[sl], begin[sl], end[sl] = _backtrace(
            hist, sc, plens[sl], tlens[sl], mismatch, gap_opening,
            gap_extending, max_score, max_ops, mismatch_as_match)
    return scores, ops, begin, end, cells


def run(pats, txts, plens, tlens, config, control=False):
    """`align` with the penalties, cap and reduction a configuration file
    states; `control` writes mismatches as `M`.  The harness calls every
    reference module so, and reads the last output as `work`'s `extra`."""
    red = config.get("reduction", {})
    return align(pats, txts, plens, tlens, mismatch=config["mismatch"],
                 gap_opening=config["gap_opening"],
                 gap_extending=config["gap_extending"],
                 max_score=config["max_score"], adaptive=config["adaptive"],
                 min_wavefront_length=red.get("min_wavefront_length", 10),
                 max_distance_threshold=red.get("max_distance_threshold", 50),
                 mismatch_as_match=control)


def work(plens, tlens, cells):
    """(bytes, int32 ops) a WFA kernel must do for these pairs, by the
    frozen counts of `roofline.py`; `cells` the reference's count a pair."""
    import roofline
    return (roofline.wfa_bytes(plens, tlens),
            roofline.wfa_ops(plens, tlens, cells))
