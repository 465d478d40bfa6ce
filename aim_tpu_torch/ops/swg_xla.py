"""The dense exact SWG tier: the torch counterpart of JAX's XLA tier
(``aim_tpu/ops/swg_xla.py::swg_forward``), in plain PyTorch on the
caller's device.  It serves the SWG configs no kernel admits (int8 cells
the band cannot prove, a negative match cost, reads past 16352) and every
SWG config under ``--backend xla``.

Lanes are DP columns, a Python loop runs over text rows.  Per row the I
matrix is elementwise from the previous row; the coupled M/D chain is
one min-plus scan, because with c[v] = min(diag + sub, I[v])

    D[v] = min(c[v-1] + GO + GE, D[v-1] + GE)         (GE <= GO + GE).

Reference semantics (ref: SWG/DPU-WRAM/dpu/swg.c:128-163), as in JAX:
MAX_SCORE is the init sentinel; plen == tlen + 1 is the boundary chain
and plen > tlen + 1 is flagged; cells are int8 (``cfg.cell_width`` 1) or
int16 in the reference, computed in int32 here, and a pair whose live
values pass ``cmax - margin`` is flagged, since the reference's per-op
truncation could show there.

Direction codes with backtrace: bits 0..1 the M choice (D, I, diag-M,
diag-X), bit 2 D-open, bit 3 I-open; two 4-bit codes a byte, walked on the
host by ``native.swg_traceback_bits``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aim_tpu_torch.config import AlignConfig
from aim_tpu_torch.ops.common import (gather_lane, min_plus_scan,
                                      shift_right_lanes)
from aim_tpu_torch.ops.nw_xla import pack_codes

I32 = torch.int32

# Calls since the last reset (the dense tier launches no kernel of its own).
call_count = 0


def reset_call_count():
    global call_count
    call_count = 0


def bits_width(read_size: int) -> int:
    """Bytes a row of direction codes: two 4-bit codes a byte."""
    return -(-(read_size + 1) // 2)


def device_bytes_per_pair(cfg: AlignConfig) -> int:
    """Device memory one pair holds during a call: the inputs, the packed
    direction codes (backtrace only) and the row tensors of one step (three
    carried rows, the scan's values and int64 indices, codes, masks)."""
    R = cfg.read_size
    W = R + 1
    bits = (R + 1) * bits_width(R) if cfg.backtrace else 0
    return 2 * R + 8 + bits + 160 * W


def swg_forward(pats, txts, plens, tlens, *, cfg: AlignConfig, packed=False):
    """Batch SWG forward (+ direction codes) on the tensors' device.

    pats, txts: [n, >= R] uint8 raw bytes, zero-padded; plens, tlens: [n]
    int32.  Returns a dict: ``scores`` [n] int32, ``needs_fallback`` [n]
    bool, and with backtrace ``bits`` [n, R+1, ceil((R+1)/2)] uint8."""
    global call_count
    if packed:
        raise ValueError("the dense SWG tier compares raw bytes")
    call_count += 1
    R = cfg.read_size
    W = R + 1
    mat, mis = cfg.match, cfg.mismatch
    go, ge = cfg.gap_o, cfg.gap_e
    ms = cfg.max_score
    n = pats.shape[0]
    dev = pats.device
    cmax = 127 if cfg.cell_width == 1 else 32767
    # a live value past cmax - margin could wrap under the reference's cell
    # type in some intermediate: flag conservatively
    margin = go + ge + max(mis, abs(mat), ge)

    plens = plens.to(I32)
    tlens = tlens.to(I32)
    aliased = plens == tlens + 1
    multi_alias = plens > tlens + 1

    lane = torch.arange(W, dtype=I32, device=dev)[None, :]
    pats_sh = F.pad(pats[:, :R], (1, 0)).to(I32)
    txts_i = txts[:, :R].to(I32)

    # Row 0 triples (swg.c:128-137): v=0 -> (M=0, I=D=MAX_SCORE); v>=1 ->
    # D = GO + v*GE, I = MAX_SCORE, M = D.  The aliased pairs' slot v == plen
    # holds the h=1 row-init triple (D=MAX_SCORE, I=GO+GE, M=I).
    d0 = torch.where(lane == 0, ms, go + lane * ge).expand(n, W)
    i0 = torch.full((n, W), ms, dtype=I32, device=dev)
    m0 = torch.where(lane == 0, 0, d0)
    at_alias = aliased[:, None] & (lane == plens[:, None]) & (lane > 0)
    pd = torch.where(at_alias, ms, d0).to(I32)
    pi = torch.where(at_alias, go + ge, i0).to(I32)
    pm = torch.where(at_alias, go + ge, m0).to(I32)

    valid_lane = lane <= plens[:, None]
    score = torch.zeros(n, dtype=I32, device=dev)
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)
    bits = None
    if cfg.backtrace:
        bits = torch.zeros((n, R + 1, bits_width(R)), dtype=torch.uint8,
                           device=dev)
    for i in range(R):
        h = i + 1
        subc = torch.where(pats_sh == txts_i[:, i:i + 1], mat, mis).to(I32)
        pm_s = shift_right_lanes(pm, 0)
        # column-0 boundary triple: (GO + h*GE, GO + h*GE, MAX_SCORE), or the
        # previous row's (plen) triple on the aliased chain
        m_b = torch.where(aliased, gather_lane(pm, plens), go + h * ge)
        i_b = torch.where(aliased, gather_lane(pi, plens), go + h * ge)
        d_b = torch.where(aliased, gather_lane(pd, plens), ms)
        # I row: elementwise (v >= 1)
        i_cur = torch.minimum(pm + (go + ge), pi + ge)
        i_cur[:, 0] = i_b
        # c[v] = min(diag + sub, I[v]) for v >= 1
        c = torch.minimum(pm_s + subc, i_cur)
        # the D scan: z[0] = D boundary, z[1] = M0 + GO + GE,
        # z[v>=2] = c[v-1] + GO + GE
        z = shift_right_lanes(c, 0) + (go + ge)
        z[:, 0] = d_b
        z[:, 1] = m_b + (go + ge)
        d_cur = min_plus_scan(z, ge)
        m_cur = torch.minimum(c, d_cur)
        m_cur[:, 0] = m_b
        live = valid_lane & (h <= tlens)[:, None]
        mx = torch.maximum(m_cur.abs(),
                           torch.maximum(i_cur.abs(), d_cur.abs()))
        overflow |= (live & (mx > cmax - margin)).any(1)
        score = torch.where(h == tlens, gather_lane(m_cur, plens), score)
        if bits is not None:
            m_cur_s = shift_right_lanes(m_cur, 0)
            choice = torch.where(
                m_cur == d_cur, 0,
                torch.where(m_cur == i_cur, 1,
                            torch.where(m_cur == pm_s + mat, 2, 3)))
            d_open = (d_cur == m_cur_s + (go + ge)).to(I32)
            i_open = (i_cur == pm + (go + ge)).to(I32)
            bits[:, h] = pack_codes(choice | (d_open << 2) | (i_open << 3),
                                    2)
        d_cur[:, 0] = d_b
        pm, pi, pd = m_cur, i_cur, d_cur
    out = {"scores": score, "needs_fallback": multi_alias | overflow}
    if bits is not None:
        out["bits"] = bits
    return out
