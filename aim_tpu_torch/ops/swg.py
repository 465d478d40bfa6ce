"""K3: banded SWG (Gotoh affine gap, global, minimising), short-read tier,
with on-device traceback.

Port of ``aim_tpu/ops/swg_pallas.py`` (``_swg_kernel`` launched by
``swg_forward_pallas``).  The band layout, record grammar and walk
machinery are K2's (``ops/nw.py``); the cell is the M/I/D triple.  I comes
from the previous row (lane b+1), the diagonal M term from lane b, and the
coupled M/D in-row chain is one truncated min-plus scan of depth DS
(D[v] = min(c[v-1]+GO+GE, D[v-1]+GE) with c = min(diag+sub, I)).  Codes are
4 bits a cell: bits 0..1 the M choice (0 D, 1 I, 2 match, 3 mismatch;
priority in that order), bit 2 D opened, bit 3 I opened; plus an is-match
bit.  The walk is layered (M / I / D).

Cells are int32 here and in the CUDA kernel: the reference computes in
int32 too, and admission (``swg_int8_sound``) proves that int8 cells of
the reference tape never wrap on the configs this tier serves.

Entry points: ``swg_forward`` (CUDA kernel ``csrc/swg.cu`` for CUDA
tensors, the plain version for CPU tensors), ``swg_reference`` (the plain
PyTorch version), and exact copies of the reference gates
``swg_int8_sound`` and ``vmem_fit_swg``.
"""

from __future__ import annotations

import torch

from aim_tpu.config import AlignConfig, wram_feasible
from aim_tpu_torch.ops import nw
from aim_tpu_torch.ops.common import check_pair_tensors
from aim_tpu_torch.ops.nw import (I32, INF, OP_D, OP_I, OP_M, OP_X,
                                  band_geometry, band_half, chunk_pairs,
                                  emit_merge, emit_tails, floordiv,
                                  launch_band, match_run, record,
                                  runs_lanes_nw, scan_rounds, seg_at,
                                  seq_codes, shift, trunc_scan, walk_state)

CH_D, CH_I, CH_M, CH_X = 0, 1, 2, 3
L_M, L_I, L_D = 0, 1, 2
N_PLANES = 5        # 4 code bits + is-match

launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


# ---------------------------------------------------------------------------
# admission (copies of aim_tpu/ops/swg_pallas.py:466-490)
# ---------------------------------------------------------------------------

def swg_int8_sound(cfg: AlignConfig) -> bool:
    """True when no int8 accumulation can leave [0, 127] anywhere in the
    reference's int8 tape, so int8 arithmetic equals exact arithmetic."""
    if cfg.cell_width != 1:
        return True
    stored_max = max(cfg.max_score, cfg.gap_o) + cfg.read_size * cfg.gap_e
    step_max = max(cfg.gap_o + cfg.gap_e, cfg.mismatch)
    return cfg.match == 0 and stored_max + step_max <= 127


def vmem_fit_swg(cfg: AlignConfig) -> bool:
    R = cfg.read_size
    plane = 128 * 128 * 4
    need = ((R + 7) // 8 + 2 * ((R + 31) // 32)) * plane
    return (need + 4 * 1024 * 1024 < 16 * 1024 * 1024
            and R <= 2047 and band_half(cfg) >= 2)


def admitted(cfg: AlignConfig) -> bool:
    """The reference's K3 admission (pallas_kernels.py:119-127): the
    short-read gate, int8 cells only where the reference WRAM tier exists
    and provably cannot wrap, and no negative match cost (it voids the
    band-exactness argument)."""
    int8_ok = cfg.cell_width != 1 or (wram_feasible(cfg)
                                      and swg_int8_sound(cfg))
    return vmem_fit_swg(cfg) and int8_ok and cfg.match >= 0


def cell_limits(cfg: AlignConfig):
    """(cmax, margin, check_ovf) of the reference kernel (swg_pallas.py
    :91-92, :419-424): the cell type's maximum, the largest step a
    transient sum adds, and whether the per-row range check is compiled
    in (only when the static bound cannot prove it away)."""
    cmax = 127 if cfg.cell_width == 1 else 32767
    margin = cfg.gap_o + cfg.gap_e + max(cfg.mismatch, abs(cfg.match),
                                         cfg.gap_e)
    stored_max = max(cfg.max_score, cfg.gap_o) + cfg.read_size * cfg.gap_e
    check_ovf = not (cfg.match >= 0 and stored_max + margin <= cmax)
    return cmax, margin, check_ovf


def device_bytes_per_pair(cfg: AlignConfig) -> int:
    return nw.device_bytes_per_pair(cfg, N_PLANES)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def swg_reference(pats, txts, plens, tlens, *, cfg: AlignConfig,
                  packed: bool = False):
    """Plain PyTorch K3 on any device: same inputs and records as
    ``swg_forward``, in chunks of ``chunk_pairs(cfg)`` pairs."""
    n = pats.shape[0]
    NRL = runs_lanes_nw(cfg)
    out = torch.zeros((n, NRL), dtype=torch.int16, device=pats.device)
    step = chunk_pairs(cfg)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        out[lo:hi] = _swg_chunk(pats[lo:hi], txts[lo:hi], plens[lo:hi],
                                tlens[lo:hi], cfg, packed)
    return out


def _swg_chunk(pats, txts, plens, tlens, cfg, packed):  # noqa: C901
    R = cfg.read_size
    mat, mis, go, ge = cfg.match, cfg.mismatch, cfg.gap_o, cfg.gap_e
    ms = cfg.max_score
    C, L, _, NRL = band_geometry(cfg)
    B = 2 * C + 1
    DS = (1 << scan_rounds(cfg, ge)) - 1
    cmax, margin, check_ovf = cell_limits(cfg)
    dev = pats.device
    n = pats.shape[0]
    pc = seq_codes(pats, packed, R)
    tc = seq_codes(txts, packed, R)
    pl1 = plens.to(I32)
    tl1 = tlens.to(I32)
    pl, tl = pl1[:, None], tl1[:, None]
    b = torch.arange(L, device=dev, dtype=I32)[None, :]
    in_band = b < B
    kend = pl1 - tl1
    aliased = pl1 == tl1 + 1

    # row-0 triples (ref swg.c:128-137)
    v0 = b - C
    r0_valid = (v0 >= 0) & (v0 <= pl) & in_band
    d0 = torch.where(v0 == 0, ms, go + v0 * ge)
    i0 = torch.full_like(d0, ms)
    m0 = torch.where(v0 == 0, 0, d0)
    at_alias = (pl == tl + 1) & (v0 == pl) & (v0 > 0)
    i0 = torch.where(at_alias, go + ge, i0)
    m0 = torch.where(at_alias, go + ge, m0)
    pm = torch.where(r0_valid, m0, INF)
    pi = torch.where(r0_valid, i0, INF)
    ramp = b * ge
    hmax = min(int(tl1.max()), R) if n else 0
    kc = kend + C
    hit_in = (kc >= 0) & (kc < B)
    score = torch.zeros(n, dtype=I32, device=dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    if cfg.backtrace:
        codes = torch.zeros((n, max(hmax, 1), L), dtype=torch.uint8,
                            device=dev)
        ism = torch.zeros((n, max(hmax, 1), L), dtype=torch.bool, device=dev)

    for h in range(1, hmax + 1):
        v = b + (h - C)
        valid = (v >= 1) & (v <= pl) & in_band
        col0 = (v == 0) & in_band
        live = valid | col0
        pidx = (v - 1).clamp(0, R - 1).expand(n, L).long()
        sub = mat + (pc.gather(1, pidx) != tc[:, h - 1:h]).to(I32) \
            * (mis - mat)
        # column-0 triple: M = I = GO+h*GE; D = MS (INF from h >= 2 for
        # aliased pairs)
        mb = go + h * ge
        db = torch.where(aliased & (h >= 2), INF, ms)[:, None]
        i_open_v = shift(pm, 1, INF) + go + ge
        i_cur = torch.minimum(i_open_v, shift(pi, 1, INF) + ge)
        i_cur = torch.where(valid, i_cur, INF)
        i_cur = torch.where(col0, mb, i_cur)
        c = torch.where(valid, torch.minimum(pm + sub, i_cur), INF)
        m_left = shift(torch.where(col0, mb, INF), -1, INF)
        z = torch.where(col0, db,
                        torch.where(v == 1, m_left + go + ge,
                                    shift(c, -1, INF) + go + ge))
        z = torch.where(live, z, INF)
        d_cur = trunc_scan(z - ramp, DS, torch.minimum, INF) + ramp
        d_cur = torch.where(live, d_cur, INF)
        m_cur = torch.minimum(c, d_cur)
        m_cur = torch.where(col0, mb, m_cur)
        m_cur = torch.where(live, m_cur, INF)
        if check_ovf:
            mx = torch.maximum(m_cur.abs(),
                               torch.maximum(i_cur.abs(), d_cur.abs()))
            ovf |= (valid & (h <= tl) & (mx > cmax - margin)
                    & (mx < INF // 2)).any(1)
        if cfg.backtrace:
            choice = torch.where(
                m_cur == d_cur, CH_D,
                torch.where(m_cur == i_cur, CH_I,
                            torch.where(m_cur == pm + mat, CH_M, CH_X)))
            d_open = (d_cur == shift(m_cur, -1, INF) + go + ge).to(I32)
            i_open = (i_cur == i_open_v).to(I32)
            code = torch.where(valid, choice | (d_open << 2) | (i_open << 3),
                               CH_M)
            codes[:, h - 1] = code.to(torch.uint8)
            ism[:, h - 1] = valid & (choice == CH_M)
        hit = (tl1 == h) & hit_in
        score = torch.where(hit, seg_at(m_cur, kc, L), score)
        pm, pi = m_cur, i_cur

    score = torch.where((pl1 == 0) | (tl1 == 0), 0, score)
    dmax = floordiv((score - 2 * go).clamp(min=0), 2 * ge) + 1
    hs = C + dmax + 3
    flag = ((pl1 > tl1 + 1)
            | (kend.abs() + dmax + 1 > C)
            | (floordiv(score - ms, ge) + dmax > C)
            | (aliased & (((2 * go + (hs + 1) * ge) > (pl1 - hs - 1) * ge)
                          | (mat < 0)))
            | ovf
            | ((go + torch.maximum(pl1, tl1) * ge + margin) > cmax)
            | (ms + margin > cmax)
            | (floordiv(score, ge) > DS)
            | (pl1 > tl1 + C) | (tl1 > pl1 + C) | (score < 0))

    hcur, vcur, st = walk_state(tl1, pl1, L, NRL)
    if not cfg.backtrace:
        return record(st[0], st[1], flag, score, NRL)
    rows = torch.arange(n, device=dev)
    layer = torch.zeros(n, dtype=I32, device=dev)
    one = torch.ones(n, dtype=I32, device=dev)
    for _ in range(3 * R + 4):
        act = (hcur > 0) & (vcur > 0)
        if not bool(act.any()):
            break
        hm1 = (hcur - 1).clamp(min=0)
        crow = codes[rows, hm1.clamp(max=codes.shape[1] - 1).long()].to(I32)
        choice = crow & 3
        dopen = (crow >> 2) & 1
        io = seg_at((crow >> 3) & 1, vcur - hcur + C, L)
        bb = vcur - hcur + C
        # I layer: one 'I' a row; iopen at the cell returns the walk to M
        in_i = act & (layer == L_I)
        st = emit_merge(st, in_i, OP_I, one, NRL)
        layer = torch.where(in_i & (io == 1), L_M, layer)
        # M layer: one chain link an iteration
        in_m = act & (layer == L_M) & ~in_i
        ch = seg_at(choice, bb, L)
        is_d = in_m & (ch == CH_D)
        # D-run: stops at the first opened D (inclusive)
        pmd = trunc_scan(torch.where(dopen == 1, b, -1), DS, torch.maximum,
                         -1)
        dlen = torch.where(is_d, bb - seg_at(pmd, bb, L) + 1, 0)
        capped = is_d & (dlen >= vcur)
        dlen = torch.minimum(dlen, vcur)
        st = emit_merge(st, is_d, OP_D, dlen, NRL)
        layer = torch.where(capped, L_D, layer)
        is_i = in_m & (ch == CH_I)
        is_x = in_m & (ch == CH_X)
        is_m = in_m & (ch == CH_M)
        mrun = match_run(ism, hm1, bb, L)
        mrun = torch.where(is_m, torch.minimum(mrun, torch.minimum(vcur, hcur)),
                           0)
        op = torch.where(is_i, OP_I, torch.where(is_m, OP_M, OP_X))
        st = emit_merge(st, is_i | is_m | is_x, op,
                        torch.where(is_m, mrun, 1), NRL)
        layer = torch.where(is_i, torch.where(io == 1, L_M, L_I), layer)
        hcur = hcur - torch.where(in_i | is_i | is_x, 1, mrun)
        vcur = vcur - torch.where(is_x, 1, dlen + mrun)
    flag = flag | ((hcur > 0) & (vcur > 0))
    runs, rc = emit_tails(st, hcur, vcur, NRL)
    flag = flag | (rc < 1)
    return record(runs, rc, flag, score, NRL)


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------

def kernel_args(cfg: AlignConfig):
    """(DS, costs) of csrc/swg.cu: the gap chain's scan depth, then the
    costs, max_score and the cell limits of ``cell_limits``."""
    cmax, margin, check_ovf = cell_limits(cfg)
    DS = (1 << scan_rounds(cfg, cfg.gap_e)) - 1
    return DS, (cfg.match, cfg.mismatch, cfg.gap_o, cfg.gap_e,
                cfg.max_score, cmax, margin, int(check_ovf))


def swg_forward(pats, txts, plens, tlens, *, cfg: AlignConfig,
                packed: bool = False):
    """Banded SWG forward + on-device traceback -> packed_runs [n, NRL]
    int16 (inputs as ``nw.nw_forward``).  CUDA tensors launch
    csrc/swg.cu and raise if it fails; CPU tensors run ``swg_reference``."""
    global launch_count
    if cfg.algo != "swg" or not admitted(cfg):
        raise ValueError(f"config outside the SWG short-read tier: {cfg}")
    check_pair_tensors(pats, txts, plens, tlens, "swg_forward")
    if pats.device.type == "cpu":
        return swg_reference(pats, txts, plens, tlens, cfg=cfg,
                             packed=packed)
    rec = launch_band("swg", cfg, N_PLANES, *kernel_args(cfg), pats, txts,
                      plens, tlens, packed)
    if pats.shape[0]:
        launch_count += 1
    return rec
