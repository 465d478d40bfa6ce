"""The dense exact WFA tier: the torch counterpart of JAX's XLA tier
(``aim_tpu/ops/wfa_xla.py``: ``build_nm_table`` :47, ``wfa_forward`` :74),
in plain PyTorch on the caller's device.  It serves the WFA configs no
kernel admits (MAX_SCORE past the long-read tier's 1023) and every WFA
config under ``--backend xla``.

Lanes are the wavefront diagonals k (dense over [-S, S], lane k + S), rows
the pairs; one score loop for the batch (a Python loop, one host sync a
score for the exit test) with per-pair done masks.

  * Extend is one gather into the "next mismatch" table NM[n, k, h] (the
    first position h' >= h on diagonal k that fails the match condition),
    built once a batch by a reverse cumulative minimum.  The reference's
    one-hot extend (a TPU workaround, wfa_xla.py:128-135) is
    ``torch.take_along_dim`` here.  The NM build runs in slices of
    diagonals, so the int64 indices ``cummin`` returns stay a bounded
    scratch (``NM_SLICE_ELEMS`` a pair).
  * The wavefront history is dense, [n, S+2, 3K] int16 (m | i | d along
    the lanes) with klo | khi | flags beside it, and is walked on the host
    by ``native.wfa_backtrace_batch``.
  * The reference's quirks stay: OFFSET_NULL arithmetic in int16, the live
    ``-10`` defaults of skipped I/D branches, del = max(del_g, del_d) with
    no both-null case, the adaptive reduce's trim limits, and overflow =
    MAX_SCORE + 1 with no backtrace.
"""

from __future__ import annotations

import torch

from aim_tpu_torch.config import AlignConfig

I16 = torch.int16
I32 = torch.int32
NULL16 = -16384
BIG = 2 ** 20
# Elements (diagonals x positions) of one pair's NM slice: the build's
# int32 values, their int64 indices and two flipped copies, about 24 bytes
# an element.
NM_SLICE_ELEMS = 1 << 18

# Calls since the last reset (the dense tier launches no kernel of its own).
call_count = 0


def reset_call_count():
    global call_count
    call_count = 0


def _slice_diagonals(cfg: AlignConfig) -> int:
    return max(1, min(2 * cfg.max_score + 1,
                      NM_SLICE_ELEMS // (cfg.read_size + 1)))


def device_bytes_per_pair(cfg: AlignConfig) -> int:
    """Device memory one pair holds during a call: the inputs, the NM table
    and its build slice, the dense history and meta, and the [K] rows of
    one score step."""
    R, smax = cfg.read_size, cfg.max_score
    K = 2 * smax + 1
    nm = K * (R + 1) * 2
    build = _slice_diagonals(cfg) * (R + 1) * 28
    hist = (smax + 2) * (3 * K + 3) * 2
    return 2 * R + 8 + nm + build + hist + 400 * K


def build_nm_table(pats, txts, plens, tlens, smax: int, read_size: int):
    """NM[n, K, h] = the first mismatch position >= h on diagonal k - smax,
    h in [0, R], values in [0, R] (R: no mismatch before the end) -> int16.
    ``pats``/``txts``: [n, read_size] uint8."""
    n = pats.shape[0]
    R = read_size
    K = 2 * smax + 1
    dev = pats.device
    h = torch.arange(R, dtype=I32, device=dev)
    nm = torch.empty((n, K, R + 1), dtype=I16, device=dev)
    ks = max(1, min(K, NM_SLICE_ELEMS // (R + 1)))
    tl_ok = h[None, None, :] < tlens[:, None, None]
    for k0 in range(0, K, ks):
        k = torch.arange(k0, min(K, k0 + ks), dtype=I32, device=dev) - smax
        v = h[None, :] - k[:, None]                          # [ks, R]
        pg = pats[:, v.clamp(0, R - 1).long()]               # [n, ks, R]
        ok = (v[None] >= 0) & (v[None] < plens[:, None, None]) & tl_ok
        match = ok & (pg == txts[:, None, :])
        # R fills the matches: the reverse running minimum is then the
        # first mismatch position, or R if none
        arr = torch.where(match, R, h[None, None, :]).to(I32)
        arr = torch.cat([arr, torch.full((n, len(k), 1), R, dtype=I32,
                                         device=dev)], dim=2)
        run = torch.cummin(arr.flip(2), dim=2).values.flip(2)
        nm[:, k0:k0 + len(k)] = run.to(I16)
    return nm


def wfa_forward(pats, txts, plens, tlens, *, cfg: AlignConfig, packed=False):
    """Batch WFA forward on the tensors' device.

    pats, txts: [n, >= R] uint8 raw bytes, zero-padded; plens, tlens: [n]
    int32.  Returns a dict: ``scores`` [n] int32 (MAX_SCORE + 1 on
    overflow) and, with backtrace, ``packed_hist`` [n, S+1, 3K] int16
    (m | i | d) and ``packed_meta`` [n, S+1, 3] int16 (klo | khi | flags:
    bit 0 exists, 1 m null, 2 i null, 3 d null)."""
    global call_count
    if packed:
        raise ValueError("the dense WFA tier compares raw bytes")
    call_count += 1
    smax = cfg.max_score
    R = cfg.read_size
    K = 2 * smax + 1
    S2 = smax + 2   # slot smax+1 is scratch for the last next-score step
    n = pats.shape[0]
    dev = pats.device
    x, go, ge = cfg.mismatch, cfg.gap_o, cfg.gap_e

    plens = plens.to(I32)
    tlens = tlens.to(I32)
    ak = tlens - plens                                   # the end diagonal
    kvec = torch.arange(K, dtype=I32, device=dev) - smax

    nm = build_nm_table(pats[:, :R], txts[:, :R], plens, tlens, smax, R)

    hist = torch.full((n, S2, 3 * K), NULL16, dtype=I16, device=dev)
    hm, hi, hd = hist[:, :, :K], hist[:, :, K:2 * K], hist[:, :, 2 * K:]
    meta = torch.zeros((n, S2, 3), dtype=I16, device=dev)
    meta[:, :, 0] = 1
    meta[:, :, 1] = -1
    klo, khi, flags = meta[:, :, 0], meta[:, :, 1], meta[:, :, 2]
    # score 0: lo = hi = 0, m[0] = 0, i/d null (ref: wfa.c:364-366)
    hm[:, 0, smax] = 0
    klo[:, 0] = 0
    khi[:, 0] = 0
    flags[:, 0] = 1 | (1 << 2) | (1 << 3)

    null16 = torch.tensor(NULL16, dtype=I16, device=dev)
    minus10 = torch.tensor(-10, dtype=I16, device=dev)

    def k_in(lo, hi_, d=0):
        return (lo[:, None] <= kvec + d) & (kvec + d <= hi_[:, None])

    def sl(w):  # value at lane k-1
        out = torch.empty_like(w)
        out[:, 1:] = w[:, :-1]
        out[:, 0] = NULL16
        return out

    def sr(w):  # value at lane k+1
        out = torch.empty_like(w)
        out[:, :-1] = w[:, 1:]
        out[:, -1] = NULL16
        return out

    def rd(sx):
        """(exists, m null, i null, d null, lo, hi, m, i, d) of slot sx;
        a slot below 0 reads as not existing."""
        i = max(sx, 0)
        f = flags[:, i].to(I32)
        ex = (f & 1).bool() & (sx >= 0)
        return (ex, (f >> 1) & 1, (f >> 2) & 1, (f >> 3) & 1,
                klo[:, i].to(I32), khi[:, i].to(I32), hm[:, i], hi[:, i],
                hd[:, i])

    s = 0
    active = torch.ones(n, dtype=torch.bool, device=dev)
    scores = torch.zeros(n, dtype=I32, device=dev)
    while s <= smax and bool(active.any()):
        kl = klo[:, s].to(I32)
        kh = khi[:, s].to(I32)
        fl = flags[:, s].to(I32)
        exists = (fl & 1).bool()
        m_null = ~exists | ((fl >> 1) & 1).bool()
        inr = k_in(kl, kh)

        # ---- extend ----
        offi = hm[:, s].to(I32)
        do_ext = active[:, None] & ~m_null[:, None] & inr & (offi >= 0)
        ext = torch.take_along_dim(nm, offi.clamp(0, R).long()[:, :, None],
                                   dim=2)[:, :, 0].to(I32)
        offi = torch.where(do_ext, ext, offi)
        hm[:, s] = offi.to(I16)

        # ---- reduce (WFA-adaptive) ----
        if cfg.adaptive:
            width = kh - kl + 1
            do_red = active & ~m_null & (width >= 10)
            v = offi - kvec[None]
            dist = torch.maximum(plens[:, None] - v, tlens[:, None] - offi)
            dmask = torch.where(inr, dist, BIG)
            mind = torch.minimum(dmask.min(1).values,
                                 torch.maximum(plens, tlens))
            keep = (dist - mind[:, None]) <= 50
            top_limit = torch.minimum(ak - 1, kh)
            cand_lo = torch.where((kvec >= kl[:, None])
                                  & (kvec < top_limit[:, None]) & keep,
                                  kvec, BIG)
            fk = cand_lo.min(1).values
            klo_new = torch.maximum(kl, torch.minimum(fk, top_limit))
            bottom_limit = torch.maximum(ak + 1, klo_new)
            cand_hi = torch.where((kvec <= kh[:, None])
                                  & (kvec > bottom_limit[:, None]) & keep,
                                  kvec, -BIG)
            lk = cand_hi.max(1).values
            khi_new = torch.minimum(kh, torch.maximum(lk, bottom_limit))
            nullify = do_red & (klo_new > khi_new)
            shrink = do_red & ~nullify
            kl = torch.where(shrink, klo_new, kl)
            kh = torch.where(shrink, khi_new, kh)
            fl = torch.where(nullify, fl | 0b1110, fl)
            klo[:, s] = kl.to(I16)
            khi[:, s] = kh.to(I16)
            flags[:, s] = fl.to(I16)
            m_null = m_null | nullify

        # ---- end reached ----
        akp = (ak + smax).clamp(0, K - 1).long()
        m_at_ak = offi.gather(1, akp[:, None])[:, 0]
        er = active & ~m_null & (kl <= ak) & (ak <= kh) & (m_at_ak >= tlens)
        scores = torch.where(er, s, scores)
        active = active & ~er

        # ---- compute the next score ----
        s2 = s + 1
        ex_sub, mn_sub, _, _, l_sub, h_sub, mw_sub, _, _ = rd(s2 - x)
        ex_o, mn_o, _, _, l_o, h_o, mw_o, _, _ = rd(s2 - go - ge)
        ex_e, _, in_e, dn_e, l_e, h_e, _, iw_e, dw_e = rd(s2 - ge)

        m_sub_null = ~ex_sub | mn_sub.bool()
        m_o_null = ~ex_o | mn_o.bool()
        i_e_null = ~ex_e | in_e.bool()
        d_e_null = ~ex_e | dn_e.bool()
        i_out_null = m_o_null & i_e_null
        d_out_null = m_o_null & d_e_null
        allnull = m_sub_null & i_out_null & d_out_null

        sub_lo = torch.where(m_sub_null, 1, l_sub)
        sub_hi = torch.where(m_sub_null, -1, h_sub)
        o_lo = torch.where(m_o_null, 1, l_o)
        o_hi = torch.where(m_o_null, -1, h_o)
        e_null_both = i_e_null & d_e_null
        e_lo = torch.where(e_null_both, 1, l_e)
        e_hi = torch.where(e_null_both, -1, h_e)
        lo = torch.minimum(torch.minimum(sub_lo, o_lo), e_lo) - 1
        hi_ = torch.maximum(torch.maximum(sub_hi, o_hi), e_hi) + 1

        ins_g = torch.where(~m_o_null[:, None] & k_in(o_lo, o_hi, -1),
                            sl(mw_o), null16)
        ins_i = torch.where(~i_e_null[:, None] & k_in(e_lo, e_hi, -1),
                            sl(iw_e), null16)
        both_null = (ins_g == NULL16) & (ins_i == NULL16)
        ins = torch.where(both_null, null16,
                          torch.maximum(ins_g, ins_i) + 1)
        del_g = torch.where(~m_o_null[:, None] & k_in(o_lo, o_hi, 1),
                            sr(mw_o), null16)
        del_d = torch.where(~d_e_null[:, None] & k_in(e_lo, e_hi, 1),
                            sr(dw_e), null16)
        dl = torch.maximum(del_g, del_d)
        sub = torch.where(k_in(sub_lo, sub_hi), mw_sub + 1, null16)

        ins_m = torch.where(i_out_null[:, None], minus10, ins)
        del_m = torch.where(d_out_null[:, None], minus10, dl)
        sub_m = torch.where(m_sub_null[:, None], minus10, sub)
        m_new = torch.maximum(del_m, torch.maximum(sub_m, ins_m))

        write = ~allnull[:, None] & k_in(lo, hi_)
        hm[:, s2] = torch.where(write, m_new, null16)
        hi[:, s2] = torch.where(write & ~i_out_null[:, None], ins, null16)
        hd[:, s2] = torch.where(write & ~d_out_null[:, None], dl, null16)
        flags[:, s2] = torch.where(
            allnull, 0, 1 | (i_out_null.to(I32) << 2)
            | (d_out_null.to(I32) << 3)).to(I16)
        klo[:, s2] = torch.where(allnull, 1, lo).to(I16)
        khi[:, s2] = torch.where(allnull, -1, hi_).to(I16)
        s = s2
    scores = torch.where(active, smax + 1, scores)

    out = {"scores": scores}
    if cfg.backtrace:
        out["packed_hist"] = hist[:, :smax + 1]
        out["packed_meta"] = meta[:, :smax + 1]
    return out
