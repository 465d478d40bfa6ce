"""K5: WFA / WFA-adaptive long-read tier (the DPU-MRAM analogue).

Port of ``aim_tpu/ops/wfa_pallas_long.py`` (``_wfa_long_kernel`` launched
by ``wfa_forward_pallas_long`` and ``wfa_forward_pallas_long_bytes``).  It
computes K1's function -- the same wavefront recursion, adaptive reduce
and level-walk backtrace, the same step records (``ops/wfa2.py``) -- for
the configs past K1's on-chip budget, reads of 1-16 kbp.  What the sizes
change:

  * the m/i/d offset history, 3 x (smax+1) x (2*smax+1) int16 a pair
    (3.0 MB at smax 500), always lives in device memory;
  * the extend compares a machine word of bases at a time instead of one
    base a step (a match run is about 100 bases at e = 1 %).  Records do
    not depend on the word layout, so 2-bit packed batches and raw-byte
    batches (alphabets of more than four symbols) take the same kernel.

Entry points:

  * ``wfa_forward_long``   the public wrapper.  A CUDA tensor launches the
                           hand-written kernel ``csrc/wfa_long.cu`` (or
                           raises); a CPU tensor runs the plain version.
  * ``wfa_long_reference`` the plain PyTorch version: ``wfa2.wfa_records``
                           with a windowed extend (K1's [n, K, Rp]
                           next-mismatch table would hold 647 M entries for
                           64 pairs at 10 kbp).
  * ``record_cols``, ``ring_depths``, ``long_tile_pairs``, ``long_fit``:
    exact copies of the reference's admission, which budget the TPU's
    on-chip memory on purpose so that every config routes as in JAX.
"""

from __future__ import annotations

import ctypes

import torch

from aim_tpu_torch.config import AlignConfig
from aim_tpu_torch.ops import wfa2
from aim_tpu_torch.ops.common import check_pair_tensors, round_up

# the reference's extend layouts and window (admission only)
WB = 14             # bases per packed word, 2-bit mode
WB_BYTES = 3        # bases per word, byte mode
CW = 8              # extend scan-window words per round
EXT_WINDOW = 32     # bases the plain version compares a round
REF_HIST_BYTES = 1 << 30  # history bytes of one plain-version chunk
# CUDA kernel geometry (kWarps in csrc/wfa_long.cu): one warp per pair,
# WARPS a block; bases a staged 32-bit word, 2-bit packed or raw bytes
WARPS = 4
BASES_PER_WORD = {True: 16, False: 4}

# Launches of the CUDA kernel since the last reset (CPU calls never count).
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


# ---------------------------------------------------------------------------
# admission (copies of aim_tpu/ops/wfa_pallas_long.py:85-91, 798-840)
# ---------------------------------------------------------------------------

def record_cols(smax: int) -> int:
    return round_up(smax + 4, 128)


def ring_depths(cfg: AlignConfig):
    """(WRM, WRE): the reference's ring slots for the m plane (read at lags
    x and o+e) and the i/d planes (read at lag e)."""
    WRM = max(cfg.mismatch, cfg.gap_o + cfg.gap_e, 1) + 1
    WRE = max(cfg.gap_e, 1) + 1
    return WRM, WRE


def long_tile_pairs(cfg: AlignConfig, bytes_mode: bool = False):
    """The reference's largest pair tile whose buffers fit its 16 MB
    on-chip budget, or None: the record fields cap smax at 1023 and R+2
    at 0x3FFF, int16 offsets cap R+smax+2 below 32767."""
    smax = cfg.max_score
    R = cfg.read_size
    if smax > 1023 or R + 2 > 0x3FFF or R + smax + 2 >= 32767:
        return None
    wb = WB_BYTES if bytes_mode else WB
    Kp = round_up(2 * smax + 1, 128)
    Wp = round_up(-(-(R + 2) // wb), 128)
    WRM, WRE = ring_depths(cfg)
    for P in (64, 48, 32, 16, 8):
        ring = (WRM + 2 * WRE) * P * Kp * 2
        btb = 2 * 5 * P * Kp * 2
        seqs = 2 * P * Wp * 4
        side = (smax + 2) * P * 8 * 2
        recs = 2 * P * record_cols(smax) * 4
        stack = 15 * P * Kp * 4 + (40 + 2 * CW + 1) * P * 128 * 4
        if ring + btb + seqs + side + recs + stack + 3 * 1024 * 1024 \
                < 16 * 1024 * 1024:
            return P
    return None


def long_fit(cfg: AlignConfig, bytes_mode: bool = False) -> bool:
    return long_tile_pairs(cfg, bytes_mode) is not None


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------

def hist_bytes_per_pair(cfg: AlignConfig) -> int:
    """m/i/d offset history of one pair: 3 planes x (smax+1) levels x K
    diagonals of int16."""
    return wfa2.hist_bytes_per_pair(cfg)


def seq_words(cfg: AlignConfig, packed: bool) -> int:
    """32-bit words of one staged sequence in csrc/wfa_long.cu: R+2
    bases, one 64-bit read past the last, and a spare word."""
    bpw = BASES_PER_WORD[packed]
    return -(-(cfg.read_size + 2) // bpw) + 3


def warp_smem_bytes(cfg: AlignConfig, packed: bool) -> int:
    """Shared memory of one warp (pair) in csrc/wfa_long.cu: klo/khi/flags
    per level and the two staged sequences.  The kernel's host function
    computes the same layout."""
    return round_up(12 * (cfg.max_score + 1) + 8 * seq_words(cfg, packed), 16)


def device_bytes_per_pair(cfg: AlignConfig) -> int:
    """Device memory one pair holds during a kernel call: its two uploads
    (raw bytes, the larger form), lengths, records and its history."""
    return (2 * cfg.read_size + 8 + 4 * (cfg.max_score + 4)
            + hist_bytes_per_pair(cfg))


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _codes(x, packed: bool, width: int):
    """[n, W] uint8 (2-bit packed or raw bytes) -> [n, width] int32 codes,
    zero past the input."""
    n = x.shape[0]
    if packed:
        shifts = torch.arange(4, dtype=torch.uint8, device=x.device) * 2
        x = ((x[:, :, None] >> shifts) & 3).reshape(n, -1)
    x = x.to(torch.int32)
    if x.shape[1] < width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    return x[:, :width]


def _windowed_extend(pat, txt, pl, tl, kvec):
    """extend(m, do_ext) for ``wfa2.wfa_records``: each marked diagonal
    compares EXT_WINDOW bases a round and advances to its first mismatch;
    the rounds go on for the diagonals that matched a whole window.  The
    bounds come from the lengths only: positions h in [max(k, 0),
    min(tlen, plen + k))."""
    L = pat.shape[1]
    ar = torch.arange(EXT_WINDOW, device=pat.device)
    lo_b = kvec.clamp(min=0)
    hi_b = torch.minimum(tl[:, None], pl[:, None] + kvec[None, :]).clamp(
        min=0)

    def extend(m, do_ext):
        live = (do_ext & (m >= lo_b) & (m < hi_b)).nonzero()
        out = m.clone()
        p, j = live[:, 0], live[:, 1]
        h = m[p, j].long()
        k = kvec[j].long()
        hb = hi_b[p, j].long()
        while len(p):
            pos = h[:, None] + ar
            pr = p[:, None]
            eq = ((txt[pr, pos.clamp(max=L - 1)]
                   == pat[pr, (pos - k[:, None]).clamp(0, L - 1)])
                  & (pos < hb[:, None]))
            run = torch.where(eq.all(1), EXT_WINDOW,
                              (~eq).to(torch.int32).argmax(1))
            h = h + run
            done = run < EXT_WINDOW
            out[p[done], j[done]] = h[done].to(out.dtype)
            cont = ~done
            p, j, h, k, hb = p[cont], j[cont], h[cont], k[cont], hb[cont]
        return out

    return extend


def wfa_long_reference(pats, txts, plens, tlens, *, cfg: AlignConfig,
                       packed: bool = False):
    """Plain PyTorch long-read WFA forward + level-walk backtrace on any
    device.  Same inputs and records as ``wfa_forward_long``; the batch
    runs in chunks whose offset history stays under REF_HIST_BYTES."""
    n = pats.shape[0]
    smax = cfg.max_score
    K = 2 * smax + 1
    out = torch.zeros((n, smax + 4), dtype=torch.int32, device=pats.device)
    width = cfg.read_size + 2 + EXT_WINDOW
    step = max(1, REF_HIST_BYTES // hist_bytes_per_pair(cfg))
    kvec = torch.arange(K, device=pats.device, dtype=torch.int32) - smax
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        pl = plens[lo:hi].to(torch.int32)
        tl = tlens[lo:hi].to(torch.int32)
        ext = _windowed_extend(_codes(pats[lo:hi], packed, width),
                               _codes(txts[lo:hi], packed, width), pl, tl,
                               kvec)
        out[lo:hi] = wfa2.wfa_records(pl, tl, cfg, ext)
    return out


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------

def wfa_forward_long(pats, txts, plens, tlens, *, cfg: AlignConfig,
                     packed: bool = False):
    """Long-read WFA forward + on-device backtrace -> records [n, smax+4]
    int32, the step-record grammar of ``wfa2.wfa_forward2``.

    pats/txts: [n, W] uint8, 2-bit packed (4 bases a byte, ``packed``) or
    raw bytes; plens/tlens: [n] int32 (each <= cfg.read_size).  CUDA
    tensors launch csrc/wfa_long.cu and raise if it fails; CPU tensors run
    ``wfa_long_reference``."""
    global launch_count
    if not long_fit(cfg, bytes_mode=not packed):
        raise ValueError(f"config outside the WFA long-read tier: {cfg}")
    check_pair_tensors(pats, txts, plens, tlens, "wfa_forward_long")
    dev = pats.device
    if dev.type == "cpu":
        return wfa_long_reference(pats, txts, plens, tlens, cfg=cfg,
                                  packed=packed)
    from aim_tpu_torch.ops import _build
    lib = _build.load()
    n = pats.shape[0]
    smax = cfg.max_score
    rec = torch.empty((n, smax + 4), dtype=torch.int32, device=dev)
    if n == 0:
        return rec
    scratch = torch.empty((n, hist_bytes_per_pair(cfg) // 2),
                          dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.aim_wfa_long_forward(
            pats.data_ptr(), txts.data_ptr(), plens.data_ptr(),
            tlens.data_ptr(), rec.data_ptr(), scratch.data_ptr(),
            n, pats.shape[1], int(packed), smax, cfg.read_size,
            cfg.mismatch, cfg.gap_o, cfg.gap_e, int(cfg.adaptive),
            int(cfg.backtrace), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"wfa_long kernel launch failed: "
                           f"{_build.error_string(rc)} (cudaError {rc})")
    launch_count += 1
    return rec
