"""K4: GenASM bitvector edit distance, short-read tier, with traceback.

Port of ``aim_tpu/ops/genasm_pallas.py`` (``_genasm_kernel`` launched by
``genasm_forward_pallas``).  Per pair and text position i, the bitvectors
B_d (bit j set iff ed(pattern[:j], text[:i]) <= d, d = 0..k) are updated
from B^{i-1} with the per-symbol pattern masks; the deletion term, a
prefix dependency along d, is closed by log-doubling shifted ORs.  The
traceback walks text levels i = tlen..1 over the stored bit volume and
writes one step record per level, in the WFA step-record grammar
(``native.wfa_steps_to_ops`` with max_score = read_size expands it):

    records [n, R+4] int32
      rows 0..R   one record per text level: bit 0 match, 14..15 op
                  (0 none, 1 X, 2 I), 16..26 D-run length, 27 D-run flag
      row  R+1    final D stroke (leftover pattern); (OP_M << 14) | 1 on
                  overflow, in score-only mode too
      row  R+2    final I stroke (leftover text)
      row  R+3    score (k+1 on overflow)

The reference packs 28 bits a word (a TPU relay bound); the port packs 32.
Records cannot differ: shifts move bits only upward and the d-group
alignment keeps a bit at its j, so the bits above R+1 where the layouts
differ never reach the bits that are read (j <= plen <= R).

Entry points:

  * ``genasm_forward``    the public wrapper.  A CUDA tensor launches the
                          hand-written kernel ``csrc/genasm.cu`` (or
                          raises); a CPU tensor runs the plain version.
  * ``genasm_reference``  the plain PyTorch version, vectorised over pairs
                          and (d, word) rows, looping over text positions.
  * ``genasm_record_rows``, ``ref_geom``, ``vmem_fit_genasm``: exact copies
    of the reference's geometry and admission, held equal by tests.
"""

from __future__ import annotations

import ctypes

import torch

from aim_tpu_torch.config import AlignConfig
from aim_tpu_torch.ops.common import check_pair_tensors, round_up

I64 = torch.int64
REF_WBITS = 28      # the reference's word width (admission only)
WBITS = 32          # the port's word width
M32 = (1 << 32) - 1
OP_M, OP_X, OP_I, OP_D = 0, 1, 2, 3
# CUDA kernel geometry (csrc/genasm.cu): WARPS warps a block.  Where the
# DW rows of a pair fit in 32 lanes, a pair takes a segment of the smallest
# power of two >= DW lanes (several pairs a warp, a row a lane); the history
# is windowed to k+1 words a level for k <= WINDOW_MAX_K.  Past 32 rows, one
# warp a pair with the full history.  The history lives in shared memory
# while a block's share fits in SMEM_HIST_LIMIT.
WARPS = 4
SMEM_HIST_LIMIT = 48 * 1024
WINDOW_MAX_K = 6    # a window of bits [l - 3k, l + 2k + 1]: 5k + 2 <= 32
REF_WORDS = 1 << 24  # history words (levels x pairs x rows) of a plain chunk

# Launches of the CUDA kernel since the last reset (CPU calls never count).
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


# ---------------------------------------------------------------------------
# geometry and admission (copies of aim_tpu/ops/genasm_pallas.py:59-83)
# ---------------------------------------------------------------------------

def genasm_record_rows(read_size: int) -> int:
    """Level rows 0..read_size + 2 final strokes + scores row (padded, as
    the reference's output tile; the records keep the first R+4)."""
    return round_up(read_size + 4, 8)


def ref_geom(cfg: AlignConfig):
    """(R, k, Wg, DW) of the reference's 28-bit layout."""
    R = cfg.read_size
    k = cfg.max_score
    Wg = -(-(R + 2) // REF_WBITS)
    return R, k, Wg, (k + 1) * Wg


def vmem_fit_genasm(cfg: AlignConfig) -> bool:
    """Admission gate of the GenASM short-read tier, reproduced exactly:
    the ones-run masks need k < 27 and the record fields R+2 <= 0x3FFF; the
    reference's bit-volume history plus working planes must fit its
    on-chip budget.  The CUDA kernel serves every config this admits."""
    R, k, Wg, DW = ref_geom(cfg)
    if k >= REF_WBITS - 1 or R + 2 > 0x3FFF:
        return False
    DWp = round_up(DW, 8)
    P = 128
    hist = (R + 1) * DWp * P * 4
    seqs = 2 * round_up(R + 2, 8) * P * 4
    recs = genasm_record_rows(R) * P * 4
    stack = 24 * DWp * P * 4
    return hist + seqs + recs + stack + 2 * 1024 * 1024 < 16 * 1024 * 1024


def geom(cfg: AlignConfig):
    """(R, k, Wg, DW, Rp) of the port's 32-bit layout: Wg words a d-group,
    DW = (k+1)*Wg rows, Rp pattern codes (the reference's padded width)."""
    R = cfg.read_size
    k = cfg.max_score
    Wg = -(-(R + 2) // WBITS)
    return R, k, Wg, (k + 1) * Wg, round_up(R + 2, 8)


def seg_lanes(cfg: AlignConfig) -> int:
    """Lanes a pair on the segmented path (the smallest power of two >= DW),
    0 on the wide path (DW > 32, one warp a pair)."""
    DW = geom(cfg)[3]
    if DW > 32:
        return 0
    S = 1
    while S < DW:
        S *= 2
    return S


def pairs_per_warp(cfg: AlignConfig) -> int:
    S = seg_lanes(cfg)
    return 32 // S if S else 1


def hist_windowed(cfg: AlignConfig) -> bool:
    """Whether a level keeps one 32-bit window a group (k+1 words) rather
    than the full DW rows: the segmented path at k <= WINDOW_MAX_K."""
    return seg_lanes(cfg) > 0 and cfg.max_score <= WINDOW_MAX_K


def hist_bytes_per_pair(cfg: AlignConfig) -> int:
    """History of one pair: R+1 levels x (k+1 windows, or DW rows) of 32
    bits."""
    R, k, _, DW, _ = geom(cfg)
    return (R + 1) * ((k + 1) if hist_windowed(cfg) else DW) * 4


def warp_smem_bytes(cfg: AlignConfig, hist_in_smem: bool) -> int:
    """Shared memory of one warp in csrc/genasm.cu.  Segmented path: for
    each of its pairs the pattern and text codes and the history when it is
    kept there (backtrace only).  Wide path: the four pattern masks, two row
    buffers, the history when kept there, and the codes.  The kernel's host
    function computes the same layout."""
    _, _, Wg, DW, Rp = geom(cfg)
    hist = hist_bytes_per_pair(cfg) if hist_in_smem and cfg.backtrace else 0
    if seg_lanes(cfg):
        return pairs_per_warp(cfg) * round_up(2 * Rp + hist, 16)
    return round_up(16 * Wg + 8 * DW + 2 * Rp + hist, 16)


def hist_in_smem(cfg: AlignConfig) -> bool:
    """Whether the history of a block's pairs fits in 48 KB of shared
    memory (else it goes to a global scratch)."""
    return WARPS * warp_smem_bytes(cfg.replace(backtrace=True), True) \
        <= SMEM_HIST_LIMIT


def device_bytes_per_pair(cfg: AlignConfig) -> int:
    """Device memory one pair holds during a kernel call: its two uploads
    (2-bit packed), lengths, records and (with backtrace, when the history
    does not fit in shared memory) its global history scratch."""
    per = 2 * geom(cfg)[4] // 4 + 8 + 4 * (cfg.read_size + 4)
    if cfg.backtrace and not hist_in_smem(cfg):
        per += hist_bytes_per_pair(cfg)
    return per


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _codes(x, Rp: int):
    """2-bit packed [n, W] uint8 -> [n, Rp] int64 codes, zero past W*4."""
    n = x.shape[0]
    shifts = torch.arange(4, dtype=torch.uint8, device=x.device) * 2
    c = ((x[:, :, None] >> shifts) & 3).reshape(n, -1).to(I64)
    if c.shape[1] < Rp:
        c = torch.nn.functional.pad(c, (0, Rp - c.shape[1]))
    return c[:, :Rp]


def _highest_bit(z):
    """floor(log2 z) for 0 < z < 2**32 (0 for z == 0), by binary search."""
    hb = torch.zeros_like(z)
    for s in (16, 8, 4, 2, 1):
        hb = hb + torch.where((z >> (hb + s)) > 0, s, 0)
    return hb


def genasm_reference(pats, txts, plens, tlens, *, cfg: AlignConfig,
                     packed: bool = True):
    """Plain PyTorch GenASM forward + traceback on any device.

    Same inputs and records as ``genasm_forward``.  Records are a per-pair
    function, so the batch is processed in chunks that bound the
    [levels, pairs, rows] history."""
    if not packed:
        raise ValueError("the GenASM tier takes 2-bit packed codes")
    n = pats.shape[0]
    R, _, _, DW, _ = geom(cfg)
    out = torch.zeros((n, R + 4), dtype=torch.int32, device=pats.device)
    step = max(1, REF_WORDS // ((R + 1) * DW))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        out[lo:hi] = _reference_chunk(pats[lo:hi], txts[lo:hi],
                                      plens[lo:hi], tlens[lo:hi], cfg)
    return out


def _reference_chunk(pats, txts, plens, tlens, cfg):  # noqa: C901
    R, k, Wg, DW, Rp = geom(cfg)
    n = pats.shape[0]
    dev = pats.device
    pat = _codes(pats, Rp)
    txt = _codes(txts, Rp)
    pl = plens.to(I64)
    tl = tlens.to(I64)
    rows = torch.arange(DW, device=dev)
    g = rows // Wg                      # d-group of each row
    w = rows - g * Wg                   # word within the group

    # per-symbol pattern masks: bit j of the bitvector set iff
    # pattern[j-1] == sym, for 1 <= j <= Rp
    j = torch.arange(WBITS * Wg, device=dev)
    pc = pat[:, (j - 1).clamp(0, Rp - 1)]                     # [n, 32*Wg]
    jok = (j >= 1) & (j <= Rp)
    weights = torch.ones(WBITS, dtype=I64, device=dev) << torch.arange(
        WBITS, device=dev)
    pm_rows = []
    for sym in range(4):
        bits = ((pc == sym) & jok).to(I64).reshape(n, Wg, WBITS)
        pm_rows.append((bits * weights).sum(-1)[:, w])        # [n, DW]
    pm_rows = torch.stack(pm_rows)                            # [4, n, DW]

    def shl(x, s):
        """Bitvector shift-left by s (0 < s < 32) within each d-group."""
        carry = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
        carry = torch.where(w >= 1, carry >> (WBITS - s), 0)
        return ((x << s) & M32) | carry

    def prevd(x, lv):
        """Rows of the (d - lv) group aligned onto group d."""
        y = torch.cat([torch.zeros_like(x[:, :lv * Wg]), x[:, :DW - lv * Wg]],
                      1) if lv * Wg < DW else torch.zeros_like(x)
        return torch.where(g >= lv, y, 0)

    # init: B_d^0 bit j = (j <= d)
    nbits = (g - w * WBITS + 1).clamp(0, WBITS)
    b0 = ((torch.ones_like(nbits) << nbits) - 1).expand(n, DW)
    tmax = int(tl.max()) if n else 0
    hist = torch.zeros((tmax + 1, n, DW), dtype=I64, device=dev)
    hist[0] = b0
    B = hist[0]
    nidx = torch.arange(n, device=dev)
    for i in range(1, tmax + 1):
        pm = pm_rows[txt[:, i - 1], nidx]                     # [n, DW]
        sh = shl(B, 1)
        u = (sh & pm) | prevd(sh, 1) | prevd(B, 1)
        u = u | torch.where((w == 0) & (g >= i), 1, 0)
        s = 1
        while s <= k:
            u = u | shl(prevd(u, s), s)
            s *= 2
        hist[i] = u
        B = u

    # scores: the lowest d with bit plen set at level tlen
    groups = torch.arange(k + 1, device=dev)
    last = hist[tl, nidx]                                     # [n, DW]
    wp = (pl >> 5)[:, None] + groups[None, :] * Wg
    hit = (last.gather(1, wp) >> (pl & 31)[:, None]) & 1      # [n, k+1]
    scores = torch.where(hit > 0, groups, k + 1).min(1).values

    rec = torch.zeros((n, R + 4), dtype=torch.int32, device=dev)
    rec[:, R + 3] = scores.to(torch.int32)
    over = scores > k
    overflow_rec = (OP_M << 14) | 1
    if not cfg.backtrace:
        rec[:, R + 1] = torch.where(over, overflow_rec, 0).to(torch.int32)
        return rec

    # traceback over text levels
    ok = ~over
    lvl0 = int(torch.where(ok, tl, 0).max()) if n else 0
    jj, ti = pl.clone(), tl.clone()
    dd = torch.zeros_like(pl)
    started = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(lvl0, -1, -1):
        Bi = hist[i]
        Bprev = hist[max(i - 1, 0)]
        start = ok & (tl == i) & ~started
        jj = torch.where(start, pl, jj)
        dd = torch.where(start, scores, dd)
        ti = torch.where(start, tl, ti)
        started = started | start
        act = started & (ti == i) & (jj > 0) & (i > 0)

        # D-run: anti-diagonal ones-run of B^i from (d-1, j-1) downward;
        # anti bit g = bit (jj - dd + g) of group g
        bpos = jj[:, None] - dd[:, None] + groups[None, :]     # [n, k+1]
        v_ok = (bpos >= 0) & (bpos <= R + 1)
        bc = bpos.clamp(0, R + 1)
        word = Bi.gather(1, groups[None, :] * Wg + (bc >> 5))
        bit = ((word >> (bc & 31)) & 1) * v_ok
        anti = (bit << groups[None, :]).sum(1)
        # leading ones of anti from bit dd-1 down (zeros below bit 0)
        y = torch.where(dd >= 1, (anti << (WBITS - dd).clamp(0, WBITS))
                        & M32, 0)
        z = ~y & M32
        run = torch.where(z > 0, WBITS - 1 - _highest_bit(z), WBITS)
        L = torch.where(act, torch.minimum(torch.minimum(run, dd),
                                           jj.clamp(min=0)), 0)
        jj = jj - L
        dd = dd - L

        act2 = act & (jj > 0)
        # I-check: bit jj of group dd-1 in B^{i-1}
        row = ((dd - 1).clamp(min=0) * Wg + (jj.clamp(min=0) >> 5))[:, None]
        ibit = (Bprev.gather(1, row)[:, 0] >> (jj.clamp(min=0) & 31)) & 1
        i_ok = act2 & (dd >= 1) & (ibit > 0)
        # diagonal: match iff pattern[jj-1] == text[i-1]
        pj = pat.gather(1, (jj - 1).clamp(0, Rp - 1)[:, None])[:, 0]
        tc = txt[:, max(i - 1, 0)]
        diag = act2 & ~i_ok
        is_m = diag & (pj == tc)
        is_x = diag & (pj != tc)
        opv = torch.where(i_ok, OP_I, torch.where(is_x, OP_X, 0))
        rec[:, i] = (is_m.to(I64) | (opv << 14) | (L.clamp(max=0x7FF) << 16)
                     | ((L > 0).to(I64) << 27)).to(torch.int32)
        jj = jj - diag.to(I64)
        dd = dd - (i_ok | is_x).to(I64)
        ti = ti - act2.to(I64)

    # final strokes: leftover pattern (D) and text (I); overflow pairs get
    # the oracle's default single-'M' record
    fin_d = torch.where(ok, jj.clamp(min=0), 0)
    fin_i = torch.where(ok, ti.clamp(min=0), 0)
    rec1 = torch.where(fin_d > 0, fin_d.clamp(max=0x3FFF) | (OP_D << 14), 0)
    rec[:, R + 1] = torch.where(over, overflow_rec, rec1).to(torch.int32)
    rec[:, R + 2] = torch.where(fin_i > 0, fin_i.clamp(max=0x3FFF)
                                | (OP_I << 14), 0).to(torch.int32)
    return rec


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------

def genasm_forward(pats, txts, plens, tlens, *, cfg: AlignConfig,
                   packed: bool = True):
    """GenASM forward + on-device traceback -> records [n, R+4] int32.

    pats/txts: [n, W] uint8, 2-bit packed (4 bases a byte; the tier needs
    a batch that packs); plens/tlens: [n] int32 (each <= cfg.read_size).
    CUDA tensors launch csrc/genasm.cu and raise if it fails; CPU tensors
    run ``genasm_reference``."""
    global launch_count
    if not vmem_fit_genasm(cfg):
        raise ValueError(f"config outside the GenASM short-read tier: {cfg}")
    if not packed:
        raise ValueError("the GenASM tier takes 2-bit packed codes")
    check_pair_tensors(pats, txts, plens, tlens, "genasm_forward")
    dev = pats.device
    if dev.type == "cpu":
        return genasm_reference(pats, txts, plens, tlens, cfg=cfg)
    R, k, _, _, Rp = geom(cfg)
    from aim_tpu_torch.ops import _build
    lib = _build.load()
    n = pats.shape[0]
    rec = torch.empty((n, R + 4), dtype=torch.int32, device=dev)
    if n == 0:
        return rec
    in_smem = hist_in_smem(cfg)
    scratch = None
    if cfg.backtrace and not in_smem:
        scratch = torch.empty((n, hist_bytes_per_pair(cfg) // 4),
                              dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.aim_genasm_forward(
            pats.data_ptr(), txts.data_ptr(), plens.data_ptr(),
            tlens.data_ptr(), rec.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            n, pats.shape[1], R, k, Rp, int(cfg.backtrace), int(in_smem),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"genasm kernel launch failed: "
                           f"{_build.error_string(rc)} (cudaError {rc})")
    launch_count += 1
    return rec


def kernel_info(cfg: AlignConfig) -> dict:
    """What csrc/genasm.cu runs at ``cfg`` on the card (``_build.INFO_KEYS``:
    registers, spill bytes, shared memory and resident blocks an SM, pairs a
    warp, windowed history)."""
    from aim_tpu_torch.ops import _build
    return _build.kernel_info("genasm", cfg.read_size, cfg.max_score,
                              int(cfg.backtrace), int(hist_in_smem(cfg)))
