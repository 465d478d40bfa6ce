"""K1: WFA / WFA-adaptive short-read tier (the main path's one kernel).

Port of ``aim_tpu/ops/wfa_pallas2.py`` (``_wfa2_kernel`` launched by
``wfa_forward_pallas2``).  One call aligns a pair batch: gap-affine
wavefront forward (extend, optional adaptive reduce, next-score compute)
up to ``cfg.max_score``, then a level walk backtrace that writes one step
record per score level.  The output grammar is the reference's, byte for
byte (``native.wfa_steps_to_ops`` expands it):

    records [n, smax+4] int32
      rows 0..smax  one step record per score level:
                    bits 0..13 match stroke, 14..15 op (0 none, 1 X, 2 I,
                    3 D), 16..26 trailing gap, 27 trailing gap is D
      row  smax+1   final D (or M, at score 0) stroke
      row  smax+2   final I stroke
      row  smax+3   score (smax+1 on overflow: no backtrace rows)

Entry points:

  * ``wfa_forward2``   the public wrapper.  A CUDA tensor launches the
                       hand-written kernel ``csrc/wfa2.cu`` (or raises); a
                       CPU tensor runs the plain version below.
  * ``wfa2_reference`` the plain PyTorch version: the same function,
                       vectorised over a pair dimension and a diagonal
                       dimension, looping over scores and levels.
  * ``wfa_records``    its recursion and walk, given an extend; K5's plain
                       version (``ops/wfa_long.py``) runs it too.
  * ``vmem_fit2``      the reference tier's admission gate, reproduced
                       exactly so every config routes as it does in JAX.
"""

from __future__ import annotations

import ctypes

import torch

from aim_tpu_torch.config import AlignConfig
from aim_tpu_torch.ops.common import check_pair_tensors, round_up

NULL = -16384       # int16 offset sentinel (reference OFFSET_NULL_16)
BIG = 2 ** 20       # "infinity" of the adaptive-reduce min/max
OP_M, OP_X, OP_I, OP_D = 0, 1, 2, 3
# CUDA kernel geometry: one warp per pair, WARPS per block (kWarps in
# csrc/wfa2.cu); the score history lives in shared memory while a block's
# share fits.
WARPS = 4
SMEM_HIST_LIMIT = 48 * 1024
REF_CHUNK = 4096    # pairs per step of the plain version

# Launches of the CUDA kernel since the last reset (CPU calls never count).
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


def record_rows(smax: int) -> int:
    """Padded record rows of the reference kernel's output tile (the
    returned records keep the first smax+4)."""
    return round_up(smax + 4, 8)


def vmem_fit2(cfg: AlignConfig) -> bool:
    """Admission gate of the WFA short-read tier, reproduced exactly from
    ``aim_tpu.ops.wfa_pallas2.vmem_fit2``: the record bit fields (14-bit
    stroke, 11-bit gap) cap smax at 1023 and R+2 at 0x3FFF, the reference
    kernel's 4-bit next-word table caps Rp at 256, and its on-chip scratch
    budget caps smax (79 at R=112, 75 at R=248).  The CUDA kernel serves
    every config this admits; the rest route to later tiers."""
    smax = cfg.max_score
    R = cfg.read_size
    if smax > 1023 or R + 2 > 0x3FFF:
        return False
    K8 = round_up(2 * smax + 1, 8)
    Rp = round_up(R + 2, 16)
    if Rp > 256:
        return False
    S2 = smax + 2
    P = 128
    hist = 3 * S2 * K8 * P * 2
    mm = (Rp // 16) * K8 * P * 4
    side = S2 * 8 * P * 4
    seqs = (round_up(Rp + K8, 8) + Rp) * P * 4
    return hist + mm + side + seqs + 5 * 1024 * 1024 < 16 * 1024 * 1024


def _geometry(cfg: AlignConfig):
    smax = cfg.max_score
    K = 2 * smax + 1
    Rp = round_up(cfg.read_size + 2, 16)
    return smax, K, Rp


def hist_bytes_per_pair(cfg: AlignConfig) -> int:
    """m/i/d offset history of one pair: 3 planes x (smax+1) levels x K
    diagonals of int16."""
    smax, K, _ = _geometry(cfg)
    return 3 * (smax + 1) * K * 2


def warp_smem_bytes(cfg: AlignConfig, hist_in_smem: bool) -> int:
    """Shared memory of one warp (pair) in csrc/wfa2.cu: klo/khi/flags per
    level, the unpacked pattern and text, and (optionally) the history.
    The kernel's host function computes the same layout."""
    smax, K, Rp = _geometry(cfg)
    b = 12 * (smax + 1) + 2 * Rp
    if hist_in_smem:
        b += hist_bytes_per_pair(cfg)
    return round_up(b, 16)


def hist_in_smem(cfg: AlignConfig) -> bool:
    return WARPS * warp_smem_bytes(cfg, True) <= SMEM_HIST_LIMIT


def device_bytes_per_pair(cfg: AlignConfig) -> int:
    """Device memory one pair holds during a kernel call: its two uploaded
    sequences (raw bytes, the larger form), lengths, records and (when the
    history does not fit in shared memory) its global history scratch."""
    per = 2 * cfg.read_size + 8 + 4 * (cfg.max_score + 4)
    if not hist_in_smem(cfg):
        per += hist_bytes_per_pair(cfg)
    return per


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _unpack(x, n):
    shifts = torch.arange(4, dtype=torch.uint8, device=x.device) * 2
    return ((x[:, :, None] >> shifts) & 3).reshape(n, -1)


def _fit_width(x, Rp):
    w = x.shape[1]
    if w < Rp:
        x = torch.nn.functional.pad(x, (0, Rp - w))
    return x[:, :Rp]


def _next_mismatch(pats, txts, plens, tlens, smax, K, Rp):
    """nm[p, j, h] = first text position >= h that is NOT a match on
    diagonal k = j - smax of pair p: pattern[h-k] != text[h], or h outside
    [max(k,0), min(tlen, plen+k)).  A forced mismatch at h = that upper
    bound (< Rp) terminates every live diagonal; the bounds come from the
    lengths only, never from the (zero-padded) data."""
    dev = pats.device
    h = torch.arange(Rp, device=dev)
    kvec = torch.arange(K, device=dev) - smax
    idx = (h[None, :] - kvec[:, None]).clamp(0, Rp - 1)            # [K, Rp]
    eq = pats[:, idx] == txts[:, None, :]                            # [n,K,Rp]
    lo_b = kvec.clamp(min=0)
    hi_b = torch.minimum(tlens[:, None], plens[:, None] + kvec[None, :])
    hi_b = hi_b.clamp(min=0)                                         # [n, K]
    inb = (h >= lo_b[:, None]) & (h[None, None, :] < hi_b[:, :, None])
    pos = torch.where(eq & inb, Rp, h.to(torch.int32))
    return pos.flip(-1).cummin(-1).values.flip(-1)


def wfa2_reference(pats, txts, plens, tlens, *, cfg: AlignConfig,
                   packed: bool = False):
    """Plain PyTorch WFA2 forward + level-walk backtrace on any device.

    Same inputs and records as ``wfa_forward2``.  Records are a per-pair
    function, so the batch is processed in chunks of REF_CHUNK pairs to
    bound the [n, K, Rp] next-mismatch table."""
    n = pats.shape[0]
    smax = cfg.max_score
    out = torch.zeros((n, smax + 4), dtype=torch.int32, device=pats.device)
    for lo in range(0, n, REF_CHUNK):
        hi = min(n, lo + REF_CHUNK)
        out[lo:hi] = _reference_chunk(pats[lo:hi], txts[lo:hi],
                                      plens[lo:hi], tlens[lo:hi], cfg, packed)
    return out


def _reference_chunk(pats, txts, plens, tlens, cfg, packed):
    smax, K, Rp = _geometry(cfg)
    n = pats.shape[0]
    if packed:
        pats, txts = _unpack(pats, n), _unpack(txts, n)
    pats = _fit_width(pats, Rp).to(torch.int32)
    txts = _fit_width(txts, Rp).to(torch.int32)
    pl = plens.to(torch.int32)
    tl = tlens.to(torch.int32)
    nm = _next_mismatch(pats, txts, pl, tl, smax, K, Rp)

    def extend(m, do_ext):
        ext = nm.gather(2, m.clamp(0, Rp - 1).long()[..., None])[..., 0]
        return torch.where(do_ext & (m < Rp), ext, m)

    return wfa_records(pl, tl, cfg, extend)


def wfa_records(pl, tl, cfg, extend):  # noqa: C901
    """The WFA recursion and level-walk backtrace of one pair batch, shared
    by K1's and K5's plain versions: ``pl``/``tl`` [n] int32 lengths;
    ``extend(m, do_ext)`` returns the offsets [n, K] of the diagonals
    ``do_ext`` marks advanced to their first mismatch, the others as
    they are.  Returns records [n, smax+4] int32."""
    smax = cfg.max_score
    K = 2 * smax + 1
    x, go, ge = cfg.mismatch, cfg.gap_o, cfg.gap_e
    n = pl.shape[0]
    dev = pl.device
    I32 = torch.int32
    ak = tl - pl                                   # alignment diagonal [n]
    kvec = torch.arange(K, device=dev, dtype=I32) - smax     # [K]

    S2 = smax + 2
    hm = torch.full((S2, n, K), NULL, dtype=torch.int16, device=dev)
    hi = torch.full_like(hm, NULL)
    hd = torch.full_like(hm, NULL)
    skl = torch.zeros((S2, n), dtype=I32, device=dev)
    skh = torch.zeros_like(skl)
    sfl = torch.zeros_like(skl)
    hm[0, :, smax] = 0
    sfl[0] = 1 | (1 << 2) | (1 << 3)

    def side(s):
        """(klo, khi, flags) at score s; scores < 0 read as nonexistent."""
        if s < 0:
            one = torch.ones(n, dtype=I32, device=dev)
            return one, -one, one * 0
        return skl[s], skh[s], sfl[s]

    def col(v):
        return v[:, None]

    def shift_km1(w):   # value at diagonal k-1; outside K reads NULL
        return torch.cat([torch.full_like(w[:, :1], NULL), w[:, :-1]], 1)

    def shift_kp1(w):   # value at diagonal k+1
        return torch.cat([w[:, 1:], torch.full_like(w[:, :1], NULL)], 1)

    active = torch.ones(n, dtype=torch.bool, device=dev)
    scores = torch.zeros(n, dtype=I32, device=dev)
    ak_in = (ak >= -smax) & (ak <= smax)
    ak_col = col((ak + smax).clamp(0, K - 1).long())
    s = 0
    while s <= smax and bool(active.any()):
        m = hm[s].to(I32)
        kl, kh, fl = side(s)
        m_null = ((fl & 1) == 0) | (((fl >> 1) & 1) == 1)
        inr = (col(kl) <= kvec) & (kvec <= col(kh))

        # extend
        offi = extend(m, col(active & ~m_null) & inr & (m >= 0))
        hm[s] = offi.to(torch.int16)

        # adaptive reduce
        if cfg.adaptive:
            width = kh - kl + 1
            do_red = active & ~m_null & (width >= 10)
            v = offi - kvec
            dist = torch.maximum(col(pl) - v, col(tl) - offi)
            dmask = torch.where(inr, dist, BIG)
            mind = torch.minimum(dmask.min(1).values, torch.maximum(pl, tl))
            keep = (dist - col(mind)) <= 50
            top_limit = torch.minimum(ak - 1, kh)
            cand_lo = torch.where((kvec >= col(kl)) & (kvec < col(top_limit))
                                  & keep, kvec, BIG)
            fk = cand_lo.min(1).values
            klo_new = torch.maximum(kl, torch.minimum(fk, top_limit))
            bottom_limit = torch.maximum(ak + 1, klo_new)
            cand_hi = torch.where((kvec <= col(kh))
                                  & (kvec > col(bottom_limit)) & keep,
                                  kvec, -BIG)
            lk = cand_hi.max(1).values
            khi_new = torch.minimum(kh, torch.maximum(lk, bottom_limit))
            nullify = do_red & (klo_new > khi_new)
            shrink = do_red & ~nullify
            kl = torch.where(shrink, klo_new, kl)
            kh = torch.where(shrink, khi_new, kh)
            fl = torch.where(nullify, fl | 0b1110, fl)
            skl[s], skh[s], sfl[s] = kl, kh, fl
            m_null = m_null | nullify

        # end reached
        m_at_ak = torch.where(ak_in, offi.gather(1, ak_col)[:, 0], 0)
        er = active & ~m_null & (kl <= ak) & (ak <= kh) & (m_at_ak >= tl)
        scores = torch.where(er, s, scores)
        active = active & ~er

        # compute score s+1
        s2 = s + 1
        l_sub, h_sub, f_sub = side(s2 - x)
        l_o, h_o, f_o = side(s2 - go - ge)
        l_e, h_e, f_e = side(s2 - ge)
        m_sub_null = ((f_sub & 1) == 0) | (((f_sub >> 1) & 1) == 1)
        m_o_null = ((f_o & 1) == 0) | (((f_o >> 1) & 1) == 1)
        i_e_null = ((f_e & 1) == 0) | (((f_e >> 2) & 1) == 1)
        d_e_null = ((f_e & 1) == 0) | (((f_e >> 3) & 1) == 1)
        i_out_null = m_o_null & i_e_null
        d_out_null = m_o_null & d_e_null
        allnull = m_sub_null & i_out_null & d_out_null
        sub_lo = torch.where(m_sub_null, 1, l_sub)
        sub_hi = torch.where(m_sub_null, -1, h_sub)
        o_lo = torch.where(m_o_null, 1, l_o)
        o_hi = torch.where(m_o_null, -1, h_o)
        e_both = i_e_null & d_e_null
        e_lo = torch.where(e_both, 1, l_e)
        e_hi = torch.where(e_both, -1, h_e)
        lo = torch.minimum(torch.minimum(sub_lo, o_lo), e_lo) - 1
        hi_ = torch.maximum(torch.maximum(sub_hi, o_hi), e_hi) + 1

        mw_sub = hm[max(s2 - x, 0)].to(I32)
        mw_o = hm[max(s2 - go - ge, 0)].to(I32)
        iw_e = hi[max(s2 - ge, 0)].to(I32)
        dw_e = hd[max(s2 - ge, 0)].to(I32)
        km1 = kvec - 1
        kp1 = kvec + 1
        ins_g = torch.where(col(~m_o_null) & (col(o_lo) <= km1)
                            & (km1 <= col(o_hi)), shift_km1(mw_o), NULL)
        ins_i = torch.where(col(~i_e_null) & (col(e_lo) <= km1)
                            & (km1 <= col(e_hi)), shift_km1(iw_e), NULL)
        both_null = (ins_g == NULL) & (ins_i == NULL)
        ins = torch.where(both_null, NULL, torch.maximum(ins_g, ins_i) + 1)
        del_g = torch.where(col(~m_o_null) & (col(o_lo) <= kp1)
                            & (kp1 <= col(o_hi)), shift_kp1(mw_o), NULL)
        del_d = torch.where(col(~d_e_null) & (col(e_lo) <= kp1)
                            & (kp1 <= col(e_hi)), shift_kp1(dw_e), NULL)
        dl = torch.maximum(del_g, del_d)
        sub = torch.where((col(sub_lo) <= kvec) & (kvec <= col(sub_hi)),
                          mw_sub + 1, NULL)
        ins_m = torch.where(col(i_out_null), -10, ins)
        del_m = torch.where(col(d_out_null), -10, dl)
        sub_m = torch.where(col(m_sub_null), -10, sub)
        m_new = torch.maximum(del_m, torch.maximum(sub_m, ins_m))

        write = col(~allnull) & (col(lo) <= kvec) & (kvec <= col(hi_))
        hm[s2] = torch.where(write, m_new, NULL).to(torch.int16)
        hi[s2] = torch.where(write & col(~i_out_null), ins,
                             NULL).to(torch.int16)
        hd[s2] = torch.where(write & col(~d_out_null), dl,
                             NULL).to(torch.int16)
        sfl[s2] = torch.where(allnull, 0, 1 | (i_out_null.to(I32) << 2)
                              | (d_out_null.to(I32) << 3))
        skl[s2] = torch.where(allnull, 1, lo)
        skh[s2] = torch.where(allnull, -1, hi_)
        s = s2
    scores = torch.where(active, smax + 1, scores)

    rec = torch.zeros((n, smax + 4), dtype=I32, device=dev)
    rec[:, smax + 3] = scores
    if not cfg.backtrace:
        return rec

    # backtrace over score levels
    bt_ok = scores <= smax
    lvl0 = int(torch.where(bt_ok, scores, 0).max()) if n else 0
    zero = torch.zeros(n, dtype=I32, device=dev)
    score, k, offset, btype = scores.clone(), zero, zero, zero
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    started = torch.zeros_like(valid)

    def gat(plane, kx):
        """plane[p, kx[p] + smax] (callers mask out-of-range kx)."""
        j = (kx + smax).clamp(0, K - 1).long()[:, None]
        return plane.gather(1, j)[:, 0]

    def ok(kl_, kh_, fl_, kx, sx):
        return (sx >= 0) & ((fl_ & 1) == 1) & (kl_ <= kx) & (kx <= kh_)

    def ok_bit(kl_, kh_, fl_, kx, sx, bit):
        return ok(kl_, kh_, fl_, kx, sx) & (((fl_ >> bit) & 1) == 0)

    for s in range(lvl0, -1, -1):
        s_o, s_e, s_x = s - go - ge, s - ge, s - x
        kl_o, kh_o, fl_o = side(s_o)
        kl_e, kh_e, fl_e = side(s_e)
        kl_x, kh_x, fl_x = side(s_x)
        mo = hm[max(s_o, 0)].to(I32)
        mx = hm[max(s_x, 0)].to(I32)
        ie = hi[max(s_e, 0)].to(I32)
        de = hd[max(s_e, 0)].to(I32)

        # pairs whose walk begins at this level
        start = bt_ok & (scores == s) & ~started
        off0 = torch.where(ak_in & start, gat(hm[s].to(I32), ak), 0)
        offset = torch.where(start, off0, offset)
        k = torch.where(start, ak, k)
        btype = torch.where(start, 0, btype)
        started = started | start
        v = offset - k
        h = offset
        valid0 = (v > 0) & (v <= pl) & (h > 0) & (h <= tl)
        valid = torch.where(start, valid0, valid)

        act = started & (score == s) & (s > 0)
        pre = act & (v > 0) & (h > 0)
        now_valid = (v > 0) & (v <= pl) & (h > 0) & (h <= tl)
        newly = pre & ~valid & now_valid
        gap_len = torch.where(newly & (k != ak), (ak - k).abs(), 0)
        gap_d = (newly & (k > ak)).to(I32)
        valid = valid | newly

        not_i = btype != 1
        not_d = btype != 2
        is_m = btype == 0
        del_ext = torch.where(pre & not_i
                              & ok_bit(kl_e, kh_e, fl_e, k + 1, s_e, 3),
                              gat(de, k + 1), NULL)
        del_open = torch.where(pre & not_i & ok(kl_o, kh_o, fl_o, k + 1, s_o),
                               gat(mo, k + 1), NULL)
        ins_ext = torch.where(pre & not_d
                              & ok_bit(kl_e, kh_e, fl_e, k - 1, s_e, 2),
                              gat(ie, k - 1) + 1, NULL)
        ins_open = torch.where(pre & not_d & ok(kl_o, kh_o, fl_o, k - 1, s_o),
                               gat(mo, k - 1) + 1, NULL)
        misms = torch.where(pre & is_m & ok(kl_x, kh_x, fl_x, k, s_x),
                            gat(mx, k) + 1, NULL)
        max_all = torch.maximum(misms, torch.maximum(
            torch.maximum(ins_ext, ins_open), torch.maximum(del_ext, del_open)))

        mstroke = pre & is_m
        nmatch = torch.where(mstroke, (offset - max_all).clamp(min=0), 0)
        offset = torch.where(mstroke, max_all, offset)
        brk = mstroke & ((offset - k <= 0) | (offset <= 0))
        go_ = pre & ~brk

        b0 = go_ & (max_all == del_ext)
        b1 = go_ & ~b0 & (max_all == del_open)
        b2 = go_ & ~b0 & ~b1 & (max_all == ins_ext)
        b3 = go_ & ~b0 & ~b1 & ~b2 & (max_all == ins_open)
        b4 = go_ & ~b0 & ~b1 & ~b2 & ~b3 & (max_all == misms)
        opv = torch.where((b0 | b1) & valid, OP_D,
                          torch.where((b2 | b3) & valid, OP_I,
                                      torch.where(b4 & valid, OP_X, 0)))
        rec[:, s] = (nmatch.clamp(max=0x3FFF) | (opv << 14)
                     | (gap_len.clamp(max=0x7FF) << 16) | (gap_d << 27))

        score = torch.where(b0 | b2, s_e,
                            torch.where(b1 | b3, s_o,
                                        torch.where(b4, s_x, score)))
        k = k + (b0 | b1).to(I32) - (b2 | b3).to(I32)
        offset = offset - (b2 | b3 | b4).to(I32)
        btype = torch.where(b0, 2, torch.where(b2, 1,
                            torch.where(b1 | b3, 0, btype)))

    # final strokes; reference emission order: D(v) before I(h)
    v = offset - k
    h = offset
    fin_m = bt_ok & (score == 0)
    fin_g = bt_ok & ~fin_m
    rec[:, smax + 1] = torch.where(
        fin_m, offset.clamp(0, 0x3FFF) | (OP_M << 14),
        torch.where(fin_g, v.clamp(0, 0x3FFF) | (OP_D << 14), 0))
    rec[:, smax + 2] = torch.where(fin_g, h.clamp(0, 0x3FFF) | (OP_I << 14),
                                   0)
    return rec


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------

def wfa_forward2(pats, txts, plens, tlens, *, cfg: AlignConfig,
                 packed: bool = False):
    """WFA2 forward + on-device backtrace -> records [n, smax+4] int32.

    pats/txts: [n, W] uint8, 2-bit packed (4 bases a byte, ``packed``) or
    raw bytes; plens/tlens: [n] int32 (each <= cfg.read_size).  CUDA
    tensors launch csrc/wfa2.cu and raise if it fails; CPU tensors run
    ``wfa2_reference``."""
    global launch_count
    if not vmem_fit2(cfg):
        raise ValueError(f"config outside the WFA short-read tier: {cfg}")
    check_pair_tensors(pats, txts, plens, tlens, "wfa_forward2")
    dev = pats.device
    if dev.type == "cpu":
        return wfa2_reference(pats, txts, plens, tlens, cfg=cfg,
                              packed=packed)
    from aim_tpu_torch.ops import _build
    lib = _build.load()
    n = pats.shape[0]
    smax, K, Rp = _geometry(cfg)
    rec = torch.empty((n, smax + 4), dtype=torch.int32, device=dev)
    if n == 0:
        return rec
    in_smem = hist_in_smem(cfg)
    scratch = None
    if not in_smem:
        scratch = torch.empty((n, hist_bytes_per_pair(cfg) // 2),
                              dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.aim_wfa2_forward(
            pats.data_ptr(), txts.data_ptr(), plens.data_ptr(),
            tlens.data_ptr(), rec.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            n, pats.shape[1], int(packed), smax, Rp, cfg.mismatch,
            cfg.gap_o, cfg.gap_e, int(cfg.adaptive), int(cfg.backtrace),
            int(in_smem), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"wfa2 kernel launch failed: "
                           f"{_build.error_string(rc)} (cudaError {rc})")
    launch_count += 1
    return rec
