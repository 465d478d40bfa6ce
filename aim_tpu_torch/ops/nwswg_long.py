"""K6 and K7: the streamed banded NW/SWG long-read tier (forward and walk).

Port of ``aim_tpu/ops/nwswg_pallas_long.py``: ``_fwd_kernel`` (K6, with its
XLA prologue ``_mm_blocks``) and ``_walk_kernel`` (K7), both launched by
``_nwswg_long_jit``.  Per pair, the band of ``P = 128 * planes`` positions
``b = v - h + C`` (half-width ``C = band_c(planes)``, in band where
``b < B = 2C + 1``) runs the NW or SWG min-plus recurrence over the text
rows h = 1..tlen, with the full-depth deletion chain; the forward keeps
per-pair scores and exactness flags and, with backtrace, one row of
direction codes and is-match bits per text row.  The walk then runs the
event-driven traceback down the rows and writes the run-length record:

    packed_runs [n, NRL] int16, NRL in {256, 512, 1024} (runs_lanes_long)
      lane 0   cursor low 8 bits | needs_fallback << 8 | score-only
               uncertainty << 9 | cursor high bits << 10
      lane 1   score, clipped to int16
      lanes cursor+1 .. NRL-1   runs, op << 12 | length (last run first)

The code rows are the port's own layout (``csrc/nwswg_long.cu`` documents
the same; the TPU's row-block / 128-lane plane tiling does not carry over):

    codes [n, R, P * bits / 8] uint8   row h-1 of a pair; position b's code
                                       at bits*b .. of the row, little-endian
                                       (NW: 2 bits, D I M X; SWG: 4 bits,
                                       choice | d_open << 2 | i_open << 3)
    ism   [n, R, P / 8] uint8          position b's is-match bit at bit b
    meta  [n, 2] int32                 score, forward flag

Entry points:

  * ``nwswg_forward_long``   the public wrapper.  A CUDA tensor launches K6
    and (with backtrace) K7 from ``csrc/nwswg_long.cu`` or raises; a CPU
    tensor runs the plain versions.
  * ``nwswg_long_fwd_reference`` / ``nwswg_long_walk_reference``   the
    plain PyTorch versions: the reference kernels' arithmetic on [n, P]
    tensors a row (a step of the walk), same codes and records as K6/K7.
  * ``band_c``, ``block_rows``, ``runs_lanes_long``, ``long_fit_nwswg``,
    ``route_planes``: copies of the reference's geometry, admission and
    routing, held equal by tests.  ``device_bytes_per_pair`` is the port's
    own footprint.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from aim_tpu_torch.config import ALGO_NW, ALGO_SWG, AlignConfig
from aim_tpu_torch.ops.common import check_pair_tensors, round_up
from aim_tpu_torch.ops.nw import (emit_merge, floordiv, seg_at, seq_codes,
                                  to_int16)

I32 = torch.int32
INF = 2 ** 20
INT16_MAX = 32767
SEAM_CAP = 1 << 24   # a value crossing a 128-position seam is capped here
OP_M, OP_X, OP_I, OP_D = 0, 1, 2, 3
C_D, C_I, C_M, C_X = 0, 1, 2, 3          # NW 2-bit codes
CH_D, CH_I, CH_M, CH_X = 0, 1, 2, 3      # SWG choice bits
L_M, L_I, L_D = 0, 1, 2                  # SWG walk layers
PLANES = (1, 2, 4, 8)
TAIL_CHUNKS = -(-16352 // 4095)          # 4095-long tail runs a tail needs

# Launches of K6 (forward) and K7 (walk) since the last reset; CPU calls
# never count.
launch_count = 0
walk_launch_count = 0


def reset_launch_count():
    global launch_count, walk_launch_count
    launch_count = 0
    walk_launch_count = 0


# ---------------------------------------------------------------------------
# geometry, admission and routing (copies of nwswg_pallas_long.py:84-199)
# ---------------------------------------------------------------------------

def runs_lanes_long(cfg: AlignConfig) -> int:
    """Record lanes: the smallest of {256, 512, 1024} that covers the
    worst-case run count of a certified score (2 * max_score / the
    cheapest edit event + tails)."""
    if cfg.algo == ALGO_NW:
        min_event = min(cfg.mismatch, cfg.gap_i, cfg.gap_d)
    else:
        min_event = min(cfg.mismatch, cfg.gap_o + cfg.gap_e)
    need = 2 * cfg.max_score // max(min_event, 1) + 8
    for nrl in (256, 512):
        if need <= nrl - 3:
            return nrl
    return 1024


def band_c(npl: int) -> int:
    """Band half-width at npl planes: B = 2*C+1 <= 128*npl positions."""
    return 64 * npl - 1


def block_rows(algo: str, npl: int = 1) -> int:
    """Rows of the reference's streamed blocks.  The walk's step budget
    starts afresh at every block boundary, so the port keeps the blocks
    for that rule alone."""
    return max(32, (512 if algo == ALGO_NW else 256) // npl // 32 * 32)


def long_fit_nwswg(cfg: AlignConfig) -> bool:
    """Admission: up to 16 kbp reads; SWG int8-cell configs and negative
    match costs stay on the exact tiers."""
    if cfg.algo != ALGO_NW and cfg.cell_width == 1:
        return False
    if cfg.algo == ALGO_NW:
        if min(cfg.gap_i, cfg.gap_d) <= 0:
            return False
    else:
        if cfg.gap_e <= 0 or cfg.match < 0:
            return False
    return 2 <= cfg.read_size <= 16352


def route_planes(cfg: AlignConfig, max_planes: int = 8) -> int:
    """The primary plane count: the smallest whose certified envelope
    covers the predicted p90 score under the dataset generator's planted
    errors (ceil(e*l) edits, type uniform).  Outputs do not depend on it:
    every plane count derives its own flags.  AIM_TPU_ROUTE=0 keeps the
    primary at one plane."""
    if os.environ.get("AIM_TPU_ROUTE", "1") == "0":
        return 1
    if cfg.algo == ALGO_NW:
        max_cost = max(cfg.mismatch, cfg.gap_i + cfg.gap_d)
        avg_cost = (cfg.mismatch + cfg.gap_i + cfg.gap_d) / 3.0
    else:
        max_cost = max(cfg.mismatch, cfg.gap_o + cfg.gap_e)
        avg_cost = (cfg.mismatch + 2 * (cfg.gap_o + cfg.gap_e)) / 3.0
    wrong = cfg.max_score / max(max_cost, 1)
    s_p90 = int(math.ceil(1.1 * wrong * avg_cost))
    kend_est = int(math.ceil(2.5 * math.sqrt(2.0 * wrong / 3.0)))
    for p in (1, 2, 4, 8):
        if p > max_planes:
            break
        C = band_c(p)
        if cfg.algo == ALGO_NW:
            dmax = s_p90 // (cfg.gap_i + cfg.gap_d)
        else:
            dmax = max(0, s_p90 - 2 * cfg.gap_o) // (2 * cfg.gap_e) + 1
        if dmax + kend_est + 1 <= C:
            return p
    return min(8, max_planes)


def pack_lane0(rc, flag, meta_flag, NRL: int):
    """lane0 = cursor_lo8 | needs_fallback << 8 | score_unc << 9
    | cursor_hi << 10 (the reference's _pack_lane0)."""
    rcc = rc.clamp(0, NRL - 1)
    return (rcc & 255) | (flag.to(I32) << 8) | (meta_flag.to(I32) << 9) \
        | ((rcc >> 8) << 10)


# ---------------------------------------------------------------------------
# the port's layout
# ---------------------------------------------------------------------------

def code_bits(cfg: AlignConfig) -> int:
    return 2 if cfg.algo == ALGO_NW else 4


def row_bytes(cfg: AlignConfig, planes: int):
    """(code bytes, is-match bytes) of one text row of one pair."""
    P = 128 * planes
    return P * code_bits(cfg) // 8, P // 8


def device_bytes_per_pair(cfg: AlignConfig, planes: int = 1) -> int:
    """Device memory one pair holds during a call: its uploaded sequences
    (raw bytes, the larger form), lengths, meta, record and, with
    backtrace, its code and is-match rows (R rows)."""
    per = 2 * cfg.read_size + 8 + 8 + 2 * runs_lanes_long(cfg)
    if cfg.backtrace:
        per += cfg.read_size * sum(row_bytes(cfg, planes))
    return per


def kernel_info(cfg: AlignConfig, planes: int) -> dict:
    """What K6 (csrc/nwswg_long.cu) runs at ``planes`` for ``cfg`` on the
    card (``_build.INFO_KEYS``: registers, spill bytes, shared memory and
    resident blocks an SM, pairs a warp)."""
    from aim_tpu_torch.ops import _build
    return _build.kernel_info("nwswg_long", planes,
                              int(cfg.algo == ALGO_SWG))


def seq_geometry(cfg: AlignConfig, width: int, packed: bool, npl: int):
    """(weff, lpad) of the reference's symbol rows: symbols j < weff come
    from the input (the unpacked codes are cut at R), positions up to
    lpad read 0 (its padding to whole row blocks), the rest -1."""
    RB = block_rows(cfg.algo, npl)
    Rp = round_up(cfg.read_size, RB)
    weff = min(cfg.read_size, 4 * width) if packed else width
    return weff, max(weff, Rp)


def _shift(w, d: int):
    """Value at band position b + d (d = +1 or -1) of each pair's row: INF
    past either end, capped at SEAM_CAP where it crosses a 128-position
    plane seam (the reference's lane broadcasts, sr1p / sl1p)."""
    fill = torch.full_like(w[:, :1], INF)
    if d > 0:
        out = torch.cat([w[:, 1:], fill], 1)
        seam = torch.arange(127, w.shape[1] - 1, 128, device=w.device)
    else:
        out = torch.cat([fill, w[:, :-1]], 1)
        seam = torch.arange(128, w.shape[1], 128, device=w.device)
    if len(seam):
        out[:, seam] = out[:, seam].clamp(max=SEAM_CAP)
    return out


def _min_scan(y, at127):
    """The reference's full-depth prefix min over the band (masked
    log-step rolls a plane, the plane carry folded in): every position is
    also capped at INF except position 127 of plane 0."""
    m = torch.cummin(y, 1).values
    return torch.where(at127, m, m.clamp(max=INF))


def _pack_bits(vals, bits: int):
    """[n, P] small ints -> [n, P * bits / 8] uint8, position b at bits
    bits*b.. of the little-endian row."""
    per = 8 // bits
    v = vals.to(torch.int32).reshape(vals.shape[0], -1, per)
    sh = torch.arange(per, dtype=torch.int32, device=vals.device) * bits
    return (v << sh).sum(2).to(torch.uint8)


def _unpack_bits(row, bits: int):
    per = 8 // bits
    sh = torch.arange(per, dtype=torch.uint8, device=row.device) * bits
    return ((row[:, :, None] >> sh) & ((1 << bits) - 1)).reshape(
        row.shape[0], -1).to(I32)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def nwswg_long_fwd_reference(pats, txts, plens, tlens, *, cfg: AlignConfig,
                             packed: bool = False, planes: int = 1):
    """Plain K6 on any device: (meta [n, 2] int32, codes, ism), the code
    rows None without backtrace.  Rows past a pair's tlen are computed and
    never read."""
    algo = cfg.algo
    R = cfg.read_size
    npl = planes
    C = band_c(npl)
    B = 2 * C + 1
    P = 128 * npl
    dev = pats.device
    n = pats.shape[0]
    weff, lpad = seq_geometry(cfg, pats.shape[1], packed, npl)
    ps = seq_codes(pats, packed, weff)
    ts = seq_codes(txts, packed, weff)
    patp = torch.full((n, C + lpad + P), -1, dtype=I32, device=dev)
    patp[:, C:C + lpad] = 0
    patp[:, C:C + weff] = ps
    txtp = torch.zeros((n, lpad), dtype=I32, device=dev)
    txtp[:, :weff] = ts

    pl1 = plens.to(I32)
    tl1 = tlens.to(I32)
    pl, tl = pl1[:, None], tl1[:, None]
    b = torch.arange(P, device=dev, dtype=I32)[None, :]
    in_band = b < B
    at127 = b == 127
    kend = pl1 - tl1
    aliased = (pl1 == tl1 + 1)[:, None]
    ramp = b * (cfg.gap_d if algo == ALGO_NW else cfg.gap_e)
    hitpos = (kend + C)[:, None]
    hitmask = (b == hitpos) & in_band
    hmax = min(int(tl1.max()), R) if n else 0
    score = torch.zeros(n, dtype=I32, device=dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    cbytes, ibytes = row_bytes(cfg, npl)
    codes = ism = None
    if cfg.backtrace:
        codes = torch.zeros((n, R, cbytes), dtype=torch.uint8, device=dev)
        ism = torch.zeros((n, R, ibytes), dtype=torch.uint8, device=dev)
    v0 = b - C

    if algo == ALGO_NW:
        gi, gd, x = cfg.gap_i, cfg.gap_d, cfg.mismatch
        prev = torch.where((v0 >= 0) & (v0 <= pl) & in_band, v0 * gd, INF)
        prev = torch.where(aliased & (v0 == pl) & in_band & (v0 >= 0), gi,
                           prev)
        upper = torch.minimum(pl, tl + C)
        for h in range(1, hmax + 1):
            mm = patp[:, h - 1:h - 1 + P] != txtp[:, h - 1:h]
            v = b + (h - C)
            valid = (v >= 1) & (v <= upper) & in_band
            col0 = (v == 0) & in_band
            insv = _shift(prev, 1) + gi
            z = torch.where(valid, torch.minimum(insv, prev + mm.to(I32) * x),
                            INF)
            z = torch.where(col0, h * gi, z)
            cur = _min_scan(z - ramp, at127) + ramp
            cur = torch.where(valid | col0, cur, INF)
            ovf |= (valid & (h <= tl) & (cur.abs() > INT16_MAX)).any(1)
            if cfg.backtrace:
                code = torch.where(
                    cur == _shift(cur, -1) + gd, C_D,
                    torch.where(cur == insv, C_I,
                                torch.where(cur == prev + x, C_X, C_M)))
                codes[:, h - 1] = _pack_bits(code, 2)
                ism[:, h - 1] = _pack_bits(code == C_M, 1)
            hit = hitmask & (tl == h)
            score = torch.where(hit.any(1), (cur * hit).sum(1).to(I32),
                                score)
            prev = cur
    else:
        mat, mis = cfg.match, cfg.mismatch
        go, ge, ms = cfg.gap_o, cfg.gap_e, cfg.max_score
        cmax = INT16_MAX
        margin = go + ge + max(mis, abs(mat), ge)
        r0_valid = (v0 >= 0) & (v0 <= pl) & in_band
        d0 = torch.where(v0 == 0, ms, go + v0 * ge)
        i0 = torch.full_like(d0, ms)
        m0 = torch.where(v0 == 0, 0, d0)
        at_alias = aliased & (v0 == pl) & (v0 > 0)
        i0 = torch.where(at_alias, go + ge, i0)
        m0 = torch.where(at_alias, go + ge, m0)
        pm = torch.where(r0_valid, m0, INF)
        pi = torch.where(r0_valid, i0, INF)
        for h in range(1, hmax + 1):
            mm = patp[:, h - 1:h - 1 + P] != txtp[:, h - 1:h]
            sub = mat + mm.to(I32) * (mis - mat)
            v = b + (h - C)
            valid = (v >= 1) & (v <= pl) & in_band
            col0 = (v == 0) & in_band
            live_any = valid | col0
            mb = go + h * ge
            db = torch.where(aliased & (h >= 2), INF, torch.full_like(pl, ms))
            i_open_v = _shift(pm, 1) + go + ge
            i_cur = torch.minimum(i_open_v, _shift(pi, 1) + ge)
            i_cur = torch.where(valid, i_cur, INF)
            i_cur = torch.where(col0, mb, i_cur)
            c = torch.where(valid, torch.minimum(pm + sub, i_cur), INF)
            m_left = _shift(torch.where(col0, mb, INF), -1)
            z = torch.where(col0, db,
                            torch.where(v == 1, m_left + go + ge,
                                        _shift(c, -1) + go + ge))
            z = torch.where(live_any, z, INF)
            d_cur = _min_scan(z - ramp, at127) + ramp
            d_cur = torch.where(live_any, d_cur, INF)
            m_cur = torch.minimum(c, d_cur)
            m_cur = torch.where(col0, mb, m_cur)
            m_cur = torch.where(live_any, m_cur, INF)
            mx = torch.maximum(m_cur.abs(),
                               torch.maximum(i_cur.abs(), d_cur.abs()))
            ovf |= (valid & (h <= tl) & (mx > cmax - margin)
                    & (mx < INF // 2)).any(1)
            if cfg.backtrace:
                choice = torch.where(
                    m_cur == d_cur, CH_D,
                    torch.where(m_cur == i_cur, CH_I,
                                torch.where(m_cur == pm + mat, CH_M, CH_X)))
                d_open = (d_cur == _shift(m_cur, -1) + go + ge).to(I32)
                i_open = (i_cur == i_open_v).to(I32)
                code = torch.where(valid, choice | (d_open << 2)
                                   | (i_open << 3), CH_M)
                codes[:, h - 1] = _pack_bits(code, 4)
                ism[:, h - 1] = _pack_bits(valid & ((code & 3) == CH_M), 1)
            hit = hitmask & (tl == h)
            score = torch.where(hit.any(1), (m_cur * hit).sum(1).to(I32),
                                score)
            pm, pi = m_cur, i_cur

    score = torch.where((pl1 == 0) | (tl1 == 0), 0, score)
    multi_alias = pl1 > tl1 + 1
    al = aliased[:, 0]
    if algo == ALGO_NW:
        gi, gd = cfg.gap_i, cfg.gap_d
        dmax = floordiv(score, gi + gd)
        hs = C + dmax + 3
        flag = (multi_alias | ((kend.abs() + dmax + 1) > C)
                | (al & (hs * gi > (pl1 - hs) * gd)) | ovf
                | (pl1 > tl1 + C) | (tl1 > pl1 + C))
    else:
        dmax = floordiv((score - 2 * go).clamp(min=0), 2 * ge) + 1
        bad_sentinel = (floordiv(score - ms, ge) + dmax) > C
        hs = C + dmax + 3
        bad_alias = al & (((2 * go + (hs + 1) * ge) > (pl1 - hs - 1) * ge)
                          | (mat < 0))
        bad_wrap = ((go + torch.maximum(pl1, tl1) * ge + margin) > cmax) \
            | (ms + margin > cmax)
        flag = (multi_alias | ((kend.abs() + dmax + 1) > C) | bad_sentinel
                | bad_alias | ovf | bad_wrap | (pl1 > tl1 + C)
                | (tl1 > pl1 + C) | (score < 0))
    meta = torch.stack([score, flag.to(I32)], 1)
    return meta, codes, ism


def score_only_records(meta, NRL: int):
    """The record of a run without backtrace: no runs, cursor NRL - 1,
    both flag bits from the forward flag (reference :1019-1028)."""
    n = meta.shape[0]
    flag = meta[:, 1] > 0
    rec = torch.zeros((n, NRL), dtype=I32, device=meta.device)
    rec[:, 0] = pack_lane0(torch.full_like(meta[:, 0], NRL - 1), flag, flag,
                           NRL)
    rec[:, 1] = meta[:, 0].clamp(-32768, 32767)
    return to_int16(rec)


def _flush(runs, rc, top_op, top_len, NRL: int):
    b = torch.arange(runs.shape[1], device=runs.device, dtype=I32)[None, :]
    w = (top_len > 0) & (rc + 1 >= 2) & (rc + 1 <= NRL - 1)
    return torch.where(w[:, None] & (b == (rc + 1)[:, None]),
                       ((top_op << 12) | top_len)[:, None], runs)


def nwswg_long_walk_reference(codes, ism, meta, plens, tlens, *,
                              cfg: AlignConfig, planes: int = 1):
    """Plain K7 on any device: the records [n, NRL] int16 from K6's code
    rows and meta."""
    algo = cfg.algo
    R = cfg.read_size
    npl = planes
    C = band_c(npl)
    P = 128 * npl
    RB = block_rows(algo, npl)
    NBK = round_up(R, RB) // RB
    NRL = runs_lanes_long(cfg)
    it_cap = (2 * R + 2) if algo == ALGO_NW else (3 * R + 4)
    bits = code_bits(cfg)
    dev = meta.device
    n = meta.shape[0]
    ar = torch.arange(n, device=dev)
    bpos = torch.arange(P, device=dev, dtype=I32)[None, :]
    t32 = torch.arange(32, device=dev, dtype=I32)[None, :]
    live = meta[:, 1] == 0
    zero = torch.zeros(n, dtype=I32, device=dev)
    hcur = torch.where(live, tlens.to(I32), 0)
    vcur = torch.where(live, plens.to(I32), 0)
    layer = zero.clone()
    st = (torch.zeros((n, NRL), dtype=I32, device=dev), zero + NRL - 1,
          zero.clone(), zero.clone())

    def at(arr, pos):
        return seg_at(arr, pos, P)

    def match_run(hm1, inblk, blk_lo, pos_b):
        """Consecutive is-match rows at band position pos_b from local row
        hm1 down to the first row of its 32-row word (zero outside the
        block, as the reference reads zero words there)."""
        pos = (hm1 & 31)[:, None]
        rows = (blk_lo + hm1[:, None] - t32).clamp(0, R - 1).long()
        q = pos_b.clamp(0, P - 1)
        byte = ism[ar[:, None], rows, (q >> 3).long()[:, None]].to(I32)
        ok = (((byte >> (q & 7)[:, None]) & 1) == 1) & (t32 <= pos) \
            & inblk[:, None]
        fail = torch.cat([~ok, torch.ones((n, 1), dtype=torch.bool,
                                          device=dev)], 1)
        return fail.to(torch.int8).argmax(1).to(I32)

    if cfg.backtrace:
        for blk in range(NBK - 1, -1, -1):
            blk_lo = blk * RB
            for _ in range(it_cap):
                act = (hcur > 0) & (vcur > 0) & (hcur > blk_lo)
                if not bool(act.any()):
                    break
                hm1 = (hcur - 1 - blk_lo).clamp(min=0)
                inblk = hm1 < RB
                row = (blk_lo + hm1).clamp(0, R - 1).long()
                crow = _unpack_bits(codes[ar, row], bits)
                crow = torch.where(inblk[:, None], crow, 0)
                bb = vcur - hcur + C
                if algo == ALGO_NW:
                    pm = torch.cummax(torch.where(crow != C_D, bpos, -1),
                                      1).values
                    dlen = torch.where(act, torch.minimum(bb - at(pm, bb),
                                                          vcur), 0)
                    st = emit_merge(st, act, OP_D, dlen, NRL)
                    vcur = vcur - dlen
                    act2 = act & (vcur > 0)
                    b2 = vcur - hcur + C
                    code2 = at(crow, b2)
                    is_i = act2 & (code2 == C_I)
                    is_x = act2 & (code2 == C_X)
                    is_m = act2 & (code2 == C_M)
                    mrun = match_run(hm1, inblk, blk_lo, b2)
                    mrun = torch.where(is_m, torch.minimum(
                        mrun, torch.minimum(vcur, hcur)), 0)
                    op = torch.where(is_i, OP_I, torch.where(is_m, OP_M,
                                                             OP_X))
                    st = emit_merge(st, is_i | is_m | is_x, op,
                                    torch.where(is_m, mrun, 1), NRL)
                    hcur = hcur - torch.where(is_i | is_x, 1, mrun)
                    vcur = vcur - torch.where(is_x, 1, mrun)
                    continue
                one = torch.ones_like(hcur)
                in_i = act & (layer == L_I)
                st = emit_merge(st, in_i, OP_I, one, NRL)
                io_here = (at(crow, bb) >> 3) & 1
                layer = torch.where(in_i & (io_here == 1), L_M, layer)
                in_m = act & (layer == L_M) & ~in_i
                ch = at(crow, bb) & 3
                is_d = in_m & (ch == CH_D)
                pmd = torch.cummax(torch.where(((crow >> 2) & 1) == 1,
                                               bpos, -1), 1).values
                dlen = torch.where(is_d, bb - at(pmd, bb) + 1, 0)
                capped = is_d & (dlen >= vcur)
                dlen = torch.minimum(dlen, vcur)
                st = emit_merge(st, is_d, OP_D, dlen, NRL)
                layer = torch.where(capped, L_D, layer)
                is_i = in_m & (ch == CH_I)
                is_x = in_m & (ch == CH_X)
                is_m = in_m & (ch == CH_M)
                mrun = match_run(hm1, inblk, blk_lo, bb)
                mrun = torch.where(is_m, torch.minimum(
                    mrun, torch.minimum(vcur, hcur)), 0)
                op = torch.where(is_i, OP_I, torch.where(is_m, OP_M, OP_X))
                st = emit_merge(st, is_i | is_m | is_x, op,
                                torch.where(is_m, mrun, one), NRL)
                layer = torch.where(is_i, torch.where(io_here == 1, L_M, L_I),
                                    layer)
                hcur = hcur - torch.where(in_i | is_i | is_x, 1, mrun)
                vcur = vcur - torch.where(is_x, 1, dlen + mrun)

    mflag = meta[:, 1] > 0
    flag = mflag | ((hcur > 0) & (vcur > 0))
    hrem, vrem = hcur, vcur
    for _ in range(TAIL_CHUNKS):
        hc = hrem.clamp(0, 4095)
        st = emit_merge(st, hc > 0, OP_I, hc, NRL)
        hrem = hrem - hc
    for _ in range(TAIL_CHUNKS):
        vc = vrem.clamp(0, 4095)
        st = emit_merge(st, vc > 0, OP_D, vc, NRL)
        vrem = vrem - vc
    runs, rc, top_op, top_len = st
    runs = _flush(runs, rc, top_op, top_len, NRL)
    flag = flag | (rc < 1)
    runs[:, 0] = pack_lane0(rc, flag, mflag, NRL)
    runs[:, 1] = meta[:, 0].clamp(-32768, 32767)
    return to_int16(runs)


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------

def _check_cuda(rc: int, what: str):
    from aim_tpu_torch.ops import _build
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {_build.error_string(rc)} "
                           f"(cudaError {rc})")


def launch_forward(pats, txts, plens, tlens, *, cfg: AlignConfig,
                   packed: bool = False, planes: int = 1):
    """Launch K6 alone on CUDA tensors: returns (meta, codes, ism, rec),
    the code rows with backtrace (rec then still to be written by K7), the
    score-only record without (codes and ism None).  Raises if the launch
    fails."""
    global launch_count
    from aim_tpu_torch.ops import _build
    lib = _build.load()
    dev = pats.device
    n = pats.shape[0]
    R = cfg.read_size
    NRL = runs_lanes_long(cfg)
    rec = torch.empty((n, NRL), dtype=torch.int16, device=dev)
    meta = torch.empty((n, 2), dtype=I32, device=dev)
    codes = ism = None
    if cfg.backtrace:
        cbytes, ibytes = row_bytes(cfg, planes)
        codes = torch.empty((n, R, cbytes), dtype=torch.uint8, device=dev)
        ism = torch.empty((n, R, ibytes), dtype=torch.uint8, device=dev)
    if n == 0:
        return meta, codes, ism, rec
    weff, lpad = seq_geometry(cfg, pats.shape[1], packed, planes)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.aim_nwswg_long_forward(
            pats.data_ptr(), txts.data_ptr(), plens.data_ptr(),
            tlens.data_ptr(), meta.data_ptr(),
            codes.data_ptr() if codes is not None else None,
            ism.data_ptr() if ism is not None else None, rec.data_ptr(), n,
            pats.shape[1], int(packed), weff, lpad, R, planes, NRL,
            int(cfg.algo == ALGO_SWG), int(cfg.backtrace), cfg.gap_i,
            cfg.gap_d, cfg.mismatch, cfg.match, cfg.gap_o, cfg.gap_e,
            cfg.max_score, stream)
    _check_cuda(rc, "K6 (nwswg_long forward)")
    launch_count += 1
    return meta, codes, ism, rec


def launch_walk(codes, ism, meta, plens, tlens, rec, *, cfg: AlignConfig,
                planes: int = 1):
    """Launch K7 alone on K6's outputs, writing ``rec``.  Raises if the
    launch fails."""
    global walk_launch_count
    from aim_tpu_torch.ops import _build
    lib = _build.load()
    n = meta.shape[0]
    if n == 0:
        return rec
    dev = meta.device
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.aim_nwswg_long_walk(
            codes.data_ptr(), ism.data_ptr(), meta.data_ptr(),
            plens.data_ptr(), tlens.data_ptr(), rec.data_ptr(), n,
            cfg.read_size, planes, runs_lanes_long(cfg),
            block_rows(cfg.algo, planes), int(cfg.algo == ALGO_SWG), stream)
    _check_cuda(rc, "K7 (nwswg_long walk)")
    walk_launch_count += 1
    return rec


def nwswg_forward_long(pats, txts, plens, tlens, *, cfg: AlignConfig,
                       packed: bool = False, planes: int = 1):
    """Streamed banded NW/SWG forward + walk -> packed_runs [n, NRL] int16.

    pats/txts: [n, W] uint8, 2-bit packed (``packed``) or raw bytes;
    plens/tlens: [n] int32 (each <= cfg.read_size); planes in {1, 2, 4, 8}
    sets the band half-width C = 64 * planes - 1.  CUDA tensors launch K6
    and, with backtrace, K7 (csrc/nwswg_long.cu) and raise if either fails;
    CPU tensors run the plain versions."""
    if cfg.algo not in (ALGO_NW, ALGO_SWG) or not long_fit_nwswg(cfg) \
            or planes not in PLANES:
        raise ValueError(f"config outside the streamed NW/SWG tier "
                         f"(planes={planes}): {cfg}")
    check_pair_tensors(pats, txts, plens, tlens, "nwswg_forward_long")
    if pats.device.type == "cpu":
        meta, codes, ism = nwswg_long_fwd_reference(
            pats, txts, plens, tlens, cfg=cfg, packed=packed, planes=planes)
        if not cfg.backtrace:
            return score_only_records(meta, runs_lanes_long(cfg))
        return nwswg_long_walk_reference(codes, ism, meta, plens, tlens,
                                         cfg=cfg, planes=planes)
    meta, codes, ism, rec = launch_forward(pats, txts, plens, tlens, cfg=cfg,
                                           packed=packed, planes=planes)
    if cfg.backtrace and pats.shape[0]:
        launch_walk(codes, ism, meta, plens, tlens, rec, cfg=cfg,
                    planes=planes)
    return rec
