"""K2: banded NW edit distance, short-read tier, with on-device traceback.

Port of ``aim_tpu/ops/nw_pallas.py`` (``_nw_kernel`` launched by
``nw_forward_pallas``).  Per pair, the cells (h, v) with |v - h| <= C are
laid out over L lanes, b = v - h + C; each text row h is one step of a
min-plus recurrence whose in-row deletion chain is a truncated prefix-min
scan of depth DS.  Direction codes (2 bits) and an
is-match bit per cell are kept, then an event-driven walk writes the
CIGAR as run-length records:

    packed_runs [n, NRL] int16
      lane 0      cursor rc | flags << 8 (bit 8: needs_fallback), int16-wrapped
      lane 1      score, clipped to int16
      lanes rc+1 .. NRL-1   runs, op << 12 | length (last run first)

``native.wfa_runs_to_ops`` expands the runs.  Pairs the band cannot prove
exact are flagged and re-run by the caller on the exact host oracle.

Entry points:

  * ``nw_forward``    the public wrapper.  A CUDA tensor launches the
                      hand-written kernel ``csrc/nw.cu`` (or raises); a CPU
                      tensor runs the plain version.
  * ``nw_reference``  the plain PyTorch version: the JAX kernel's
                      arithmetic on an [n, L] tensor per row.
  * ``band_geometry``, ``band_half``, ``runs_lanes_nw``, ``group_geom``,
    ``scan_rounds``, ``vmem_fit_nw``: exact copies of the reference's
    geometry and admission (``aim_tpu.ops.nw_pallas`` imports jax), held
    equal by tests.

The band helpers below (lane shifts, truncated scans, run emission, the
record epilogue) are shared with ``ops/swg.py``.
"""

from __future__ import annotations

import ctypes

import torch

from aim_tpu.config import AlignConfig
from aim_tpu_torch.ops.common import check_pair_tensors, round_up

I32 = torch.int32
INF = 2 ** 20       # in-band "+infinity" of the reference kernels
INT16_MAX = 32767
OP_M, OP_X, OP_I, OP_D = 0, 1, 2, 3
C_D, C_I, C_M, C_X = 0, 1, 2, 3        # NW direction codes
# CUDA kernel geometry (kWarps in csrc/band.cuh): one warp per pair; the
# code planes live in shared memory while a block's share fits.
WARPS = 4
SMEM_PLANES_LIMIT = 48 * 1024
REF_CELLS = 1 << 26  # code cells (pairs x rows x lanes) of a plain chunk

# Launches of the CUDA kernel since the last reset (CPU calls never count).
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


# ---------------------------------------------------------------------------
# geometry and admission (copies of aim_tpu/ops/nw_pallas.py:84-158, 620-629)
# ---------------------------------------------------------------------------

def band_geometry(cfg: AlignConfig):
    """(C, L, G, NRL): band half-width, segment lanes, pairs per 128-lane
    row of the reference layout, record lanes.  The smallest power-of-two
    segment whose band and record capacity cover every pair with score
    <= MAX_SCORE (see the reference for the argument)."""
    smax = cfg.max_score
    if cfg.algo == "swg":
        skew = max(0, smax - cfg.gap_o) // cfg.gap_e + 1
        dmax = max(0, smax - 2 * cfg.gap_o) // (2 * cfg.gap_e) + 1
        mincost = max(1, min(cfg.mismatch, cfg.gap_o + cfg.gap_e))
    else:
        skew = smax // max(1, min(cfg.gap_i, cfg.gap_d))
        dmax = smax // max(1, cfg.gap_i + cfg.gap_d)
        mincost = max(1, min(cfg.mismatch, cfg.gap_i, cfg.gap_d))
    need_c = min(dmax + skew + 1, smax + 2, 62)
    need_runs = min(2 * (smax // mincost) + 5, 2 * smax + 6)
    for L in (8, 16, 32, 64, 128):
        C = min(smax + 2, (L - 1) // 2, 62)
        NRL = min(L, round_up(2 * smax + 8, 8))
        if C >= need_c and NRL - 2 >= need_runs:
            return C, L, 128 // L, NRL
    return min(smax + 2, 62), 128, 1, min(128, round_up(2 * smax + 8, 8))


def band_half(cfg: AlignConfig) -> int:
    return band_geometry(cfg)[0]


def runs_lanes_nw(cfg: AlignConfig) -> int:
    return band_geometry(cfg)[3]


def group_geom(cfg: AlignConfig):
    _, L, G, _ = band_geometry(cfg)
    return L, G


def scan_rounds(cfg: AlignConfig, chain_cost: int) -> int:
    """Rounds of the truncated deletion scan: depth 2^r - 1 covers the
    deepest in-row chain a <= MAX_SCORE path can fund."""
    L, _ = group_geom(cfg)
    need = min(cfg.max_score // max(chain_cost, 1) + 1, L - 1)
    r = 0
    while (1 << r) - 1 < need:
        r += 1
    return r


def vmem_fit_nw(cfg: AlignConfig) -> bool:
    """Admission gate of the NW short-read tier, reproduced exactly from
    the reference (its on-chip budget is the TPU's; the CUDA kernel serves
    every config it admits, so configs route as they do in JAX)."""
    R = cfg.read_size
    plane = 128 * 128 * 4
    need = ((R + 15) // 16 + 2 * ((R + 31) // 32)) * plane
    return (need + 4 * 1024 * 1024 < 16 * 1024 * 1024
            and R <= 2047 and band_half(cfg) >= 2)


# ---------------------------------------------------------------------------
# kernel geometry shared with csrc/ (code planes: one bit a lane a row)
# ---------------------------------------------------------------------------

def plane_words(cfg: AlignConfig) -> int:
    """32-bit words a plane row takes: one bit per band lane."""
    return max(1, band_geometry(cfg)[1] // 32)


def plane_bytes_per_pair(cfg: AlignConfig, n_planes: int) -> int:
    """Code planes of one pair: R rows x n_planes planes x plane_words."""
    if not cfg.backtrace:
        return 0
    return cfg.read_size * n_planes * plane_words(cfg) * 4


def warp_smem_bytes(cfg: AlignConfig, n_planes: int, in_smem: bool) -> int:
    """Shared memory of one warp (pair) in csrc/nw.cu and csrc/swg.cu: the
    unpacked pattern and text, and (optionally) the code planes.  The
    kernels' host functions compute the same layout."""
    b = 2 * round_up(cfg.read_size, 16)
    if in_smem:
        b += plane_bytes_per_pair(cfg, n_planes)
    return round_up(b, 16)


def planes_in_smem(cfg: AlignConfig, n_planes: int) -> bool:
    return WARPS * warp_smem_bytes(cfg, n_planes, True) <= SMEM_PLANES_LIMIT


def device_bytes_per_pair(cfg: AlignConfig, n_planes: int = 3) -> int:
    """Device memory one pair holds during a kernel call: its two uploaded
    sequences (raw bytes, the larger form), lengths, the record and (when
    the code planes do not fit in shared memory) its global plane scratch."""
    per = 2 * cfg.read_size + 8 + 2 * runs_lanes_nw(cfg)
    if not planes_in_smem(cfg, n_planes):
        per += plane_bytes_per_pair(cfg, n_planes)
    return per


# ---------------------------------------------------------------------------
# band helpers of the plain versions (shared with ops/swg.py)
# ---------------------------------------------------------------------------

def seq_codes(x, packed: bool, R: int):
    """[n, W] uint8 rows -> [n, R] int32 symbols: raw bytes, or the 2-bit
    codes of packed rows (4 a byte, low bits first); zero past W."""
    n = x.shape[0]
    if packed:
        shifts = torch.arange(4, dtype=torch.uint8, device=x.device) * 2
        x = ((x[:, :, None] >> shifts) & 3).reshape(n, -1)
    w = x.shape[1]
    if w < R:
        x = torch.nn.functional.pad(x, (0, R - w))
    return x[:, :R].to(I32)


def shift(w, d: int, fill: int):
    """Value at band lane b + d of each pair's row, or ``fill`` where b + d
    lies outside [0, L) (the reference's masked rolls: sl1 is d = -1, sr1
    d = +1, the scan steps d = -s)."""
    L = w.shape[1]
    if abs(d) >= L:
        return torch.full_like(w, fill)
    pad = torch.full_like(w[:, :abs(d)], fill)
    if d > 0:
        return torch.cat([w[:, d:], pad], 1)
    return torch.cat([pad, w[:, :d]], 1)


def trunc_scan(x, DS: int, op, fill: int):
    """Truncated prefix scan: after steps s = 1, 2, 4, ... <= DS a lane
    holds op over the DS + 1 lanes ending at it (clipped at lane 0)."""
    s = 1
    while s <= DS:
        x = op(x, shift(x, -s, fill))
        s *= 2
    return x


def seg_at(arr, pos, L: int):
    """arr[p, clip(pos[p], 0, L-1)] per pair."""
    return arr.gather(1, pos.clamp(0, L - 1).long()[:, None])[:, 0]


def match_run(ism, hm1, lane, L: int):
    """Consecutive is-match rows at band lane ``lane`` from row hm1 (0-based)
    down to the first row of its 32-row word -- what the reference reads
    from its descending-packed is-match word with one ctz."""
    n = ism.shape[0]
    dev = ism.device
    t = torch.arange(32, device=dev, dtype=I32)[None, :]
    pos = (hm1 & 31)[:, None]
    rows = (hm1[:, None] - t).clamp(min=0).long()
    col = lane.clamp(0, L - 1).long()[:, None].expand(n, 32)
    ok = ism[torch.arange(n, device=dev)[:, None], rows, col] & (t <= pos)
    fail = torch.cat([~ok, torch.ones((n, 1), dtype=torch.bool, device=dev)],
                     1)
    return fail.to(torch.int8).argmax(1).to(I32)


def emit_merge(st, mask, op, length, NRL: int):
    """Append or merge a run (reference ``emit_merge``): the top run stays
    in (top_op, top_len) and lands in lane rc+1 when the next is pushed; a
    merge needs top_len + length <= 4095 and rc < NRL-1; rc has no floor."""
    runs, rc, top_op, top_len = st
    b = torch.arange(runs.shape[1], device=runs.device, dtype=I32)[None, :]
    if torch.is_tensor(op):
        op = op.to(I32)
    do = mask & (length > 0)
    can = do & (top_len > 0) & (top_op == op) \
        & (top_len + length <= 4095) & (rc < NRL - 1)
    top_len = torch.where(can, top_len + length, top_len)
    push = do & ~can
    val_old = (top_op << 12) | top_len
    w = push & (top_len > 0) & (rc + 1 >= 2) & (rc + 1 <= NRL - 1)
    runs = torch.where(w[:, None] & (b == (rc + 1)[:, None]),
                       val_old[:, None], runs)
    top_op = torch.where(push, op, top_op)
    top_len = torch.where(push, length.clamp(max=4095), top_len)
    rc = torch.where(push, rc - 1, rc)
    return runs, rc, top_op, top_len


def emit_tails(st, hcur, vcur, NRL: int):
    """Tails after the walk (I x h, then D x v) and the final flush.
    Returns (runs, rc)."""
    st = emit_merge(st, hcur > 0, OP_I, hcur, NRL)
    runs, rc, top_op, top_len = emit_merge(st, vcur > 0, OP_D, vcur, NRL)
    b = torch.arange(runs.shape[1], device=runs.device, dtype=I32)[None, :]
    w = (top_len > 0) & (rc + 1 <= NRL - 1) & (rc + 1 >= 2)
    runs = torch.where(w[:, None] & (b == (rc + 1)[:, None]),
                       ((top_op << 12) | top_len)[:, None], runs)
    return runs, rc


def walk_state(tl, pl, L: int, NRL: int):
    n = tl.shape[0]
    z = torch.zeros(n, dtype=I32, device=tl.device)
    return (tl.clone(), pl.clone(),
            (torch.zeros((n, L), dtype=I32, device=tl.device), z + NRL - 1,
             z, z))


def to_int16(x):
    """int32 -> int16 keeping the low 16 bits (two's complement wrap)."""
    return (((x + 32768) & 0xFFFF) - 32768).to(torch.int16)


def record(runs, rc, flag, score, NRL: int):
    """The packed_runs record of a chunk: lane 0 = rc | flag << 8 (int16
    wrap), lane 1 = clip(score), lanes 2.. = runs."""
    rec = runs[:, :NRL].clone()
    rec[:, 0] = rc | (flag.to(I32) << 8)
    rec[:, 1] = score.clamp(-32768, 32767)
    return to_int16(rec)


def chunk_pairs(cfg: AlignConfig) -> int:
    """Pairs per step of a plain version: bounds its [pairs, R, L] code
    tensor to REF_CELLS cells."""
    _, L, _, _ = band_geometry(cfg)
    return max(1, min(4096, REF_CELLS // (cfg.read_size * L)))


def floordiv(a, k: int):
    return torch.div(a, k, rounding_mode="floor")


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def nw_reference(pats, txts, plens, tlens, *, cfg: AlignConfig,
                 packed: bool = False):
    """Plain PyTorch K2 on any device: same inputs and records as
    ``nw_forward``.  Records are a per-pair function, so the batch runs in
    chunks of ``chunk_pairs(cfg)``."""
    n = pats.shape[0]
    NRL = runs_lanes_nw(cfg)
    out = torch.zeros((n, NRL), dtype=torch.int16, device=pats.device)
    step = chunk_pairs(cfg)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        out[lo:hi] = _nw_chunk(pats[lo:hi], txts[lo:hi], plens[lo:hi],
                               tlens[lo:hi], cfg, packed)
    return out


def _nw_chunk(pats, txts, plens, tlens, cfg, packed):  # noqa: C901
    R = cfg.read_size
    gi, gd, x = cfg.gap_i, cfg.gap_d, cfg.mismatch
    C, L, _, NRL = band_geometry(cfg)
    B = 2 * C + 1
    DS = (1 << scan_rounds(cfg, gd)) - 1
    check_ovf = (2 * R + 2) * max(gi, gd, x) > INT16_MAX
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

    # row 0: v = b - C, cell v*gd; the aliased slot v == plen reads gi
    v0 = b - C
    prev = torch.where((v0 >= 0) & (v0 <= pl) & in_band, v0 * gd, INF)
    prev = torch.where((pl == tl + 1) & (v0 == pl) & in_band & (v0 >= 0),
                       gi, prev)
    ramp = b * gd
    upper = torch.minimum(pl, tl + C)
    hmax = min(int(tl1.max()), R) if n else 0
    kc = kend + C
    hit_in = (kc >= 0) & (kc < B)
    score = torch.zeros(n, dtype=I32, device=dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    codes = torch.zeros((n, max(hmax, 1), L), dtype=torch.uint8, device=dev) \
        if cfg.backtrace else None

    for h in range(1, hmax + 1):
        v = b + (h - C)
        valid = (v >= 1) & (v <= upper) & in_band
        col0 = (v == 0) & in_band
        pidx = (v - 1).clamp(0, R - 1).expand(n, L).long()
        sub = (pc.gather(1, pidx) != tc[:, h - 1:h]).to(I32) * x
        insv = shift(prev, 1, INF) + gi
        z = torch.where(valid, torch.minimum(insv, prev + sub), INF)
        z = torch.where(col0, h * gi, z)
        cur = trunc_scan(z - ramp, DS, torch.minimum, INF) + ramp
        cur = torch.where(valid | col0, cur, INF)
        if check_ovf:
            ovf |= (valid & (h <= tl) & (cur.abs() > INT16_MAX)).any(1)
        if cfg.backtrace:
            # priority D -> I -> X; anything else (dead lanes too) is M
            code = torch.where(
                cur == shift(cur, -1, INF) + gd, C_D,
                torch.where(cur == insv, C_I,
                            torch.where(cur == prev + x, C_X, C_M)))
            codes[:, h - 1] = code.to(torch.uint8)
        hit = (tl1 == h) & hit_in
        score = torch.where(hit, seg_at(cur, kc, L), score)
        prev = cur

    score = torch.where((pl1 == 0) | (tl1 == 0), 0, score)
    dmax = floordiv(score, gi + gd)
    hs = C + dmax + 3
    flag = ((pl1 > tl1 + 1)
            | (kend.abs() + dmax + 1 > C)
            | (aliased & (hs * gi > (pl1 - hs) * gd))
            | ovf
            | (floordiv(score, gd) > DS)
            | (pl1 > tl1 + C) | (tl1 > pl1 + C))

    hcur, vcur, st = walk_state(tl1, pl1, L, NRL)
    if not cfg.backtrace:
        return record(st[0], st[1], flag, score, NRL)
    ism = codes == C_M
    rows = torch.arange(n, device=dev)
    for _ in range(2 * R + 2):
        act = (hcur > 0) & (vcur > 0)
        if not bool(act.any()):
            break
        hm1 = (hcur - 1).clamp(min=0)
        crow = codes[rows, hm1.clamp(max=codes.shape[1] - 1).long()].to(I32)
        # D-run: the last non-D lane at or below the band position
        pm = trunc_scan(torch.where(crow != C_D, b, -1), DS, torch.maximum,
                        -1)
        bb = vcur - hcur + C
        dlen = torch.where(act, torch.minimum(bb - seg_at(pm, bb, L), vcur),
                           0)
        st = emit_merge(st, act, OP_D, dlen, NRL)
        vcur = vcur - dlen
        act2 = act & (vcur > 0)
        b2 = vcur - hcur + C
        code2 = seg_at(crow, b2, L)
        is_i = act2 & (code2 == C_I)
        is_x = act2 & (code2 == C_X)
        is_m = act2 & (code2 == C_M)
        mrun = match_run(ism, hm1, b2, L)
        mrun = torch.where(is_m, torch.minimum(mrun, torch.minimum(vcur, hcur)),
                           0)
        op = torch.where(is_i, OP_I, torch.where(is_m, OP_M, OP_X))
        st = emit_merge(st, is_i | is_m | is_x, op,
                        torch.where(is_m, mrun, 1), NRL)
        hcur = hcur - torch.where(is_i | is_x, 1, mrun)
        vcur = vcur - torch.where(is_x, 1, mrun)
    flag = flag | ((hcur > 0) & (vcur > 0))
    runs, rc = emit_tails(st, hcur, vcur, NRL)
    flag = flag | (rc < 1)
    return record(runs, rc, flag, score, NRL)


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------

def kernel_args(cfg: AlignConfig):
    """(DS, costs) of csrc/nw.cu: the deletion chain's scan depth, then
    gap_i, gap_d, mismatch and whether the int16 range check is compiled
    in ((2R+2) times the largest cost past INT16_MAX)."""
    check_ovf = (2 * cfg.read_size + 2) * max(cfg.gap_i, cfg.gap_d,
                                              cfg.mismatch) > INT16_MAX
    DS = (1 << scan_rounds(cfg, cfg.gap_d)) - 1
    return DS, (cfg.gap_i, cfg.gap_d, cfg.mismatch, int(check_ovf))


def launch_band(kind, cfg, n_planes, DS, costs, pats, txts, plens, tlens,
                packed):
    """Allocate the record (and the plane scratch when the planes do not
    fit in shared memory) and launch ``aim_<kind>_forward`` from csrc/ on
    the current stream.  Raises if the launch fails."""
    from aim_tpu_torch.ops import _build
    lib = _build.load()
    dev = pats.device
    n = pats.shape[0]
    C, L, _, NRL = band_geometry(cfg)
    rec = torch.empty((n, NRL), dtype=torch.int16, device=dev)
    if n == 0:
        return rec
    in_smem = planes_in_smem(cfg, n_planes)
    scratch = None
    if cfg.backtrace and not in_smem:
        scratch = torch.empty(
            (n, plane_bytes_per_pair(cfg, n_planes) // 4), dtype=torch.int32,
            device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"aim_{kind}_forward")(
            pats.data_ptr(), txts.data_ptr(), plens.data_ptr(),
            tlens.data_ptr(), rec.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            n, pats.shape[1], int(packed), cfg.read_size, C, L, NRL, DS,
            *costs, int(cfg.backtrace), int(in_smem),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{kind} kernel launch failed: "
                           f"{_build.error_string(rc)} (cudaError {rc})")
    return rec


def nw_forward(pats, txts, plens, tlens, *, cfg: AlignConfig,
               packed: bool = False):
    """Banded NW forward + on-device traceback -> packed_runs [n, NRL]
    int16.

    pats/txts: [n, W] uint8, 2-bit packed (``packed``) or raw bytes;
    plens/tlens: [n] int32 (each <= cfg.read_size).  CUDA tensors launch
    csrc/nw.cu and raise if it fails; CPU tensors run ``nw_reference``."""
    global launch_count
    if cfg.algo != "nw" or not vmem_fit_nw(cfg):
        raise ValueError(f"config outside the NW short-read tier: {cfg}")
    check_pair_tensors(pats, txts, plens, tlens, "nw_forward")
    if pats.device.type == "cpu":
        return nw_reference(pats, txts, plens, tlens, cfg=cfg, packed=packed)
    rec = launch_band("nw", cfg, 3, *kernel_args(cfg), pats, txts, plens,
                      tlens, packed)
    if pats.shape[0]:
        launch_count += 1
    return rec
