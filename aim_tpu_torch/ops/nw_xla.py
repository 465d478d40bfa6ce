"""The dense exact NW tier: the torch counterpart of JAX's XLA tier
(``aim_tpu/ops/nw_xla.py::nw_forward``), in plain PyTorch on the caller's
device.  It serves the NW configs no kernel admits (reads past the
streamed tier's 16352) and every NW config under ``--backend xla``.  The
file keeps the ``_xla`` name of the CLI flag that selects it.

One lane a DP column v (pattern position), one row a pair; a Python loop
over text positions h takes the place of ``lax.scan``.  The in-row
deletion chain is one ``min_plus_scan`` a row.  Reference semantics, as
in JAX (ref: NW/DPU-WRAM/dpu/nw.c:109-153):

  * the flat-tape aliasing of plen == tlen + 1 is the "boundary chain":
    column 0 of row h >= 2 holds cell(h-1, plen), row 1's column 0 and
    row 0's column plen hold GAP_I;
  * pairs with plen > tlen + 1 alias across several columns and are
    flagged (``needs_fallback``) for the exact-tape oracle;
  * cells are int16 in the reference (NW_W16); cells are computed in
    int32 here and pairs whose live cells pass int16 are flagged.

Direction codes with backtrace: 2 bits a cell (D, I, M, X with the
reference's tie-break priority, nw.c:76-94), four a byte, walked on the
host by ``native.nw_traceback_bits``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aim_tpu_torch.config import AlignConfig
from aim_tpu_torch.ops.common import (gather_lane, min_plus_scan,
                                      shift_right_lanes)

I32 = torch.int32
INT16_MAX = 32767

# Calls since the last reset (the dense tier launches no kernel of its own).
call_count = 0


def reset_call_count():
    global call_count
    call_count = 0


def bits_width(read_size: int) -> int:
    """Bytes a row of direction codes: four 2-bit codes a byte."""
    return -(-(read_size + 1) // 4)


def device_bytes_per_pair(cfg: AlignConfig) -> int:
    """Device memory one pair holds during a call: the inputs, the packed
    direction codes (backtrace only) and the row tensors of one step (the
    carried row, the scan's values and int64 indices, the codes, masks)."""
    R = cfg.read_size
    W = R + 1
    bits = (R + 1) * bits_width(R) if cfg.backtrace else 0
    return 2 * R + 8 + bits + 96 * W


def pack_codes(codes: torch.Tensor, per_byte: int) -> torch.Tensor:
    """[n, W] codes (< 2 ** (8 // per_byte)) -> [n, ceil(W/per_byte)] u8,
    code j of a byte at bit (8 // per_byte) * j."""
    n, W = codes.shape
    wb = -(-W // per_byte)
    c = F.pad(codes.to(I32), (0, wb * per_byte - W)).view(n, wb, per_byte)
    shift = torch.arange(per_byte, dtype=I32, device=codes.device) \
        * (8 // per_byte)
    return (c << shift).sum(2).to(torch.uint8)


def nw_forward(pats, txts, plens, tlens, *, cfg: AlignConfig, packed=False):
    """Batch NW forward (+ direction codes) on the tensors' device.

    pats, txts: [n, >= R] uint8 raw bytes, zero-padded; plens, tlens: [n]
    int32.  Returns a dict: ``scores`` [n] int32, ``needs_fallback`` [n]
    bool, and with backtrace ``bits`` [n, R+1, ceil((R+1)/4)] uint8."""
    global call_count
    if packed:
        raise ValueError("the dense NW tier compares raw bytes")
    call_count += 1
    R = cfg.read_size
    W = R + 1
    gi, gd, x = cfg.gap_i, cfg.gap_d, cfg.mismatch
    n = pats.shape[0]
    dev = pats.device

    plens = plens.to(I32)
    tlens = tlens.to(I32)
    aliased = plens == tlens + 1          # the common tape-aliasing case
    multi_alias = plens > tlens + 1       # needs the exact-tape oracle

    lane = torch.arange(W, dtype=I32, device=dev)[None, :]
    # pats_sh[:, v] = pattern[v-1]
    pats_sh = F.pad(pats[:, :R], (1, 0)).to(I32)
    txts_i = txts[:, :R].to(I32)

    # Row 0: v*GAP_D, except the aliased pairs' column plen holds GAP_I.
    prev = (lane * gd).expand(n, W)
    prev = torch.where(aliased[:, None] & (lane == plens[:, None]),
                       torch.tensor(gi, dtype=I32, device=dev), prev)
    valid_lane = lane <= plens[:, None]
    score = torch.zeros(n, dtype=I32, device=dev)
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)
    bits = None
    if cfg.backtrace:
        bits = torch.zeros((n, R + 1, bits_width(R)), dtype=torch.uint8,
                           device=dev)
    for i in range(R):
        h = i + 1
        subc = torch.where(pats_sh == txts_i[:, i:i + 1], 0, x).to(I32)
        prev_s = shift_right_lanes(prev, 0)
        indep = torch.minimum(prev + gi, prev_s + subc)
        # column-0 boundary: h*GAP_I, or the aliased chain cell(h-1, plen)
        b_alias = torch.full_like(score, gi) if h == 1 \
            else gather_lane(prev, plens)
        indep[:, 0] = torch.where(aliased, b_alias, h * gi)
        cur = min_plus_scan(indep, gd)
        # int16 range of the live region (the reference's cells are int16)
        live = valid_lane & (h <= tlens)[:, None]
        overflow |= (live & (cur.abs() > INT16_MAX)).any(1)
        score = torch.where(h == tlens, gather_lane(cur, plens), score)
        if bits is not None:
            cur_s = shift_right_lanes(cur, 0)
            code = torch.where(
                cur == cur_s + gd, 0,
                torch.where(cur == prev + gi, 1,
                            torch.where(cur == prev_s + x, 3, 2)))
            bits[:, h] = pack_codes(code, 4)
        prev = cur
    out = {"scores": score, "needs_fallback": multi_alias | overflow}
    if bits is not None:
        out["bits"] = bits
    return out
