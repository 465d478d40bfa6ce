"""High-level alignment API of the port: batches, device phases, decode.

The counterpart of ``aim_tpu/api.py`` for the kernel tiers the port has:
sort long reads by estimated difficulty, pack the pairs, pick the tier for
the batch's alphabet, upload each chunk, run the kernel, pull the records,
decode them by their grammar (WFA and GenASM step records or NW/SWG packed
runs) into scores and CIGARs with the native decoders, re-run the pairs a
kernel flags on the exact host oracle, emit the reference-format file.
The host runtime (parser, record decoders, emitter, oracle) is
``aim_tpu.native``, shared with the reference package.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from aim_tpu import native
from aim_tpu.config import ALGO_NW, ALGO_SWG, ALGO_WFA, AlignConfig
from aim_tpu_torch.ops import kernels
from aim_tpu_torch.ops.common import pack_seqs, round_up, to_device_batch

WAVE = 8            # chunks uploaded together before their kernels run
DEFAULT_BUDGET = 2 << 30


@dataclass
class AlignResult:
    scores: np.ndarray                 # [n] int32
    ops: np.ndarray | None = None      # [n, 2R] uint8 (backtrace only)
    begin: np.ndarray | None = None    # [n] int32
    end: np.ndarray | None = None      # [n] int32
    # device phase timings (seconds): upload, kernel, download
    t_load: float = 0.0
    t_kernel: float = 0.0
    t_retrieve: float = 0.0
    # pairs a kernel flagged (packed-run bit 8) and the exact host oracle
    # re-ran; WFA and GenASM never flag
    n_fallback: int = 0


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_memory_budget(device: torch.device) -> int:
    """Half of the device memory free now (CUDA), else a conservative
    default for devices that report none (CPU)."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free) // 2
    return DEFAULT_BUDGET


def _memory_batch_cap(cfg: AlignConfig, device: torch.device,
                      budget_bytes: int | None = None,
                      packed_ok: bool = True) -> int:
    """Pairs per chunk that fit the device budget, at the per-pair
    footprint of the kernel that serves the config (uploads, records,
    global scratch)."""
    if budget_bytes is None:
        budget_bytes = _device_memory_budget(device)
    per_pair = kernels.forward_fn(cfg, packed_ok).device_bytes_per_pair
    return max(256, budget_bytes // per_pair)


def _plan_bs(cfg: AlignConfig, n: int, device: torch.device,
             packed_ok: bool = True) -> int:
    """Chunk size: cfg.batch_pairs, capped by device memory and by the
    batch itself, rounded to 8."""
    bs = min(cfg.batch_pairs,
             _memory_batch_cap(cfg, device, packed_ok=packed_ok),
             round_up(n, 8))
    return max(round_up(bs, 8), 8)


def _difficulty_order(pats, txts, plens, tlens):
    """Stable ascending sort order by a cheap edit-distance proxy
    (subsampled diagonal Hamming count + length skew), copied from
    ``aim_tpu/api.py``: pairs of one chunk then end near one score, and
    the chunk's slowest pair sets its time.  Column subsampling (<= 512
    sampled positions) keeps the host pass cheap at long read lengths."""
    pl = np.asarray(plens).astype(np.int64)
    tl = np.asarray(tlens).astype(np.int64)
    step = max(1, pats.shape[1] // 512)
    pos = np.arange(0, pats.shape[1], step)
    valid = pos[None, :] < np.minimum(pl, tl)[:, None]
    ham = ((pats[:, pos] != txts[:, pos]) & valid).sum(1).astype(np.int64)
    return np.argsort(ham * step + np.abs(pl - tl), kind="stable")


def align(pats, txts, plens, tlens, cfg: AlignConfig,
          device="cuda") -> AlignResult:
    """Align a pair batch ([n, R] uint8 pats/txts, [n] int32 lengths) on
    ``device``.  Returns scores (+ ops buffers when cfg.backtrace).
    Device work runs in cfg.batch_pairs chunks.

    As in ``aim_tpu.api.align``, long reads (read_size >= 1024, more than
    128 pairs) run in estimated-difficulty order; AIM_TPU_SORT=0 turns
    that off, =1 on for any read size.  The output order is the input's;
    the sort's host time counts in ``t_load``."""
    cfg.validate()
    plens = np.ascontiguousarray(plens, np.int32)
    tlens = np.ascontiguousarray(tlens, np.int32)
    n = pats.shape[0]
    if n and max(int(plens.max()), int(tlens.max())) > cfg.read_size:
        raise ValueError(f"sequence longer than read_size={cfg.read_size}")
    sort_env = os.environ.get("AIM_TPU_SORT", "")
    sort_on = sort_env == "1" if sort_env in ("0", "1") \
        else cfg.read_size >= 1024
    if not (sort_on and n > 128):
        return _align_impl(pats, txts, plens, tlens, cfg, device)
    t0 = time.perf_counter()
    order = _difficulty_order(pats, txts, plens, tlens)
    t_sort = time.perf_counter() - t0
    res = _align_impl(pats[order], txts[order], plens[order], tlens[order],
                      cfg, device)
    inv = np.empty_like(order)
    inv[order] = np.arange(n)
    return AlignResult(
        res.scores[inv],
        res.ops[inv] if res.ops is not None else None,
        res.begin[inv] if res.begin is not None else None,
        res.end[inv] if res.end is not None else None,
        t_load=res.t_load + t_sort, t_kernel=res.t_kernel,
        t_retrieve=res.t_retrieve, n_fallback=res.n_fallback)


def _align_impl(pats, txts, plens, tlens, cfg: AlignConfig,
                device) -> AlignResult:
    device = torch.device(device)
    kernels.forward_fn(cfg)  # an unported config raises before any work
    n = pats.shape[0]
    R = cfg.read_size
    max_ops = 2 * R

    scores = np.zeros(n, np.int32)
    ops = np.zeros((n, max_ops), np.uint8) if cfg.backtrace else None
    begin = np.zeros(n, np.int32) if cfg.backtrace else None
    end = np.zeros(n, np.int32) if cfg.backtrace else None
    res = AlignResult(scores, ops, begin, end)
    if n == 0:
        return res

    # 2-bit-pack the uploads when the batch alphabet allows it; then pick
    # the tier for it (aim_tpu/api.py:555-570): K1 and K2/K3 compare raw
    # bytes too, K5 takes its byte layout, K4 needs the packed codes.
    up_pats, up_txts, packed = pack_seqs(pats, txts, plens, tlens, R)
    fwd = kernels.forward_fn(cfg, packed_ok=packed)
    bs = _plan_bs(cfg, n, device, packed_ok=packed)
    starts = list(range(0, n, bs))
    records = []
    for w0 in range(0, len(starts), WAVE):
        wave = starts[w0:w0 + WAVE]
        t0 = time.perf_counter()
        uploads = [to_device_batch(up_pats[lo:lo + bs], up_txts[lo:lo + bs],
                                   plens[lo:lo + bs], tlens[lo:lo + bs],
                                   device) for lo in wave]
        _sync(device)
        res.t_load += time.perf_counter() - t0

        outs = []
        for args in uploads:
            t1 = time.perf_counter()
            outs.append(fwd(*args, cfg=cfg, packed=packed))
            _sync(device)
            res.t_kernel += time.perf_counter() - t1
        del uploads

        t2 = time.perf_counter()
        records.extend(o.cpu().numpy() for o in outs)
        res.t_retrieve += time.perf_counter() - t2
        del outs

    smax = cfg.max_score
    for lo, rec in zip(starts, records):
        chunk = slice(lo, lo + rec.shape[0])
        flagged = None
        if fwd.records in (kernels.STEP_RECORDS, kernels.GENASM_RECORDS):
            # WFA: row smax+3 holds the score; GenASM: the same grammar
            # with one level row a text position, the score in row R+3
            # (no fallback conditions)
            levels = smax if fwd.records == kernels.STEP_RECORDS else R
            scores[chunk] = rec[:, levels + 3]
            if cfg.backtrace:
                _, o, b, e = native.wfa_steps_to_ops(
                    rec, plens[chunk], tlens[chunk], max_score=levels,
                    max_ops=max_ops)
                ops[chunk], begin[chunk], end[chunk] = o, b, e
        else:
            # NW/SWG packed runs: lane 0 = cursor | flags << 8 (bit 8 =
            # needs_fallback), lane 1 = score, then the runs
            lane0 = rec[:, 0].astype(np.int32)
            scores[chunk] = rec[:, 1]
            flagged = np.nonzero((lane0 >> 8) & 1)[0]
            if cfg.backtrace:
                o, b, e = native.wfa_runs_to_ops(
                    rec, scores[chunk], plens[chunk], tlens[chunk],
                    max_score=1 << 30, max_ops=max_ops)
                ops[chunk], begin[chunk], end[chunk] = o, b, e
        if flagged is not None and len(flagged):
            # pairs the band cannot prove exact: the exact host oracle
            # (the reference's wide-band device retry is not ported yet)
            sel = lo + flagged
            res.n_fallback += len(sel)
            osc, oops, ob, oe = _oracle_align(pats[sel], txts[sel],
                                              plens[sel], tlens[sel], cfg)
            scores[sel] = osc
            if cfg.backtrace:
                ops[sel], begin[sel], end[sel] = oops, ob, oe
    return _overflow_bt_pass(pats, txts, plens, tlens, cfg, res)


def _oracle_align(pats, txts, plens, tlens, cfg: AlignConfig):
    """The exact host path for flagged NW/SWG pairs (aim_tpu/api.py
    ``_oracle_align``), on a pool sized from the host."""
    if cfg.algo == ALGO_NW:
        return native.nw_align(pats, txts, plens, tlens,
                               mismatch=cfg.mismatch, gap_i=cfg.gap_i,
                               gap_d=cfg.gap_d, backtrace=cfg.backtrace,
                               threads=0)
    if cfg.algo == ALGO_SWG:
        return native.swg_align(pats, txts, plens, tlens, match=cfg.match,
                                mismatch=cfg.mismatch, gap_o=cfg.gap_o,
                                gap_e=cfg.gap_e, max_score=cfg.max_score,
                                cell_width=cfg.cell_width,
                                backtrace=cfg.backtrace, threads=0)
    raise ValueError(f"{cfg.algo}: no flagged pairs expected")


def _overflow_bt_pass(pats, txts, plens, tlens, cfg: AlignConfig,
                      res: AlignResult) -> AlignResult:
    """Opt-in WFA WRAM-variant overflow-backtrace compat
    (cfg.overflow_backtrace): overflowed pairs (score > MAX_SCORE, which
    the kernel leaves CIGAR-less per the MRAM behaviour) get the host
    oracle's defined best-effort CIGAR.  Scores are unchanged."""
    if not (cfg.algo == ALGO_WFA and cfg.backtrace
            and cfg.overflow_backtrace):
        return res
    sel = np.nonzero(res.scores > cfg.max_score)[0]
    if not len(sel):
        return res
    _, oops, ob, oe = native.wfa_align(
        pats[sel], txts[sel], plens[sel], tlens[sel],
        mismatch=cfg.mismatch, gap_o=cfg.gap_o, gap_e=cfg.gap_e,
        max_score=cfg.max_score, adaptive=cfg.adaptive, backtrace=True,
        threads=0, overflow_backtrace=True)
    res.ops[sel] = oops
    res.begin[sel] = ob
    res.end[sel] = oe
    return res


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def write_device_log(path: str, cfg: AlignConfig, res: AlignResult, n: int,
                     device):
    """The dpu-out analogue: one line for the device with its run."""
    device = torch.device(device)
    label = f"GPU {device.index or 0}" if device.type == "cuda" else "CPU"
    with open(path, "w") as f:
        f.write(f"{label}: {device_name(device)} | "
                f"algo={cfg.algo} max_score={cfg.max_score} "
                f"read_size={cfg.read_size} backtrace={cfg.backtrace} "
                f"adaptive={cfg.adaptive} pairs={n} "
                f"load_s={res.t_load:.6f} kernel_s={res.t_kernel:.6f} "
                f"retrieve_s={res.t_retrieve:.6f} "
                f"fallback={res.n_fallback}\n")


def align_file(input_path: str, output_path: str, n_reads: int,
               cfg: AlignConfig, device="cuda", verbose=True,
               device_log: str | None = None) -> AlignResult:
    """File-to-file pipeline (the reference host main, host.c:136).
    n_reads is the number of PAIRS requested; fewer are aligned if the
    file is shorter."""
    device = torch.device(device)
    t0 = time.perf_counter()
    pats, txts, plens, tlens = native.parse_pairs(input_path, n_reads,
                                                  cfg.read_size, threads=0)
    t_parse = time.perf_counter() - t0
    res = align(pats, txts, plens, tlens, cfg, device)
    n = len(res.scores)
    native.emit_output(output_path, np.arange(n, dtype=np.int32), res.scores,
                       res.ops, res.begin, res.end, cfg.backtrace)
    if device_log:
        write_device_log(device_log, cfg, res, n, device)
    if verbose:
        print(f"Parsed {n} pairs in {t_parse * 1e3:.3f} ms")
        print(f"CPU-GPU: {res.t_load * 1e3:f} ms")
        print(f"GPU Kernel: {res.t_kernel * 1e3:f} ms")
        print(f"GPU-CPU: {res.t_retrieve * 1e3:f} ms")
        total = res.t_load + res.t_kernel + res.t_retrieve
        if total > 0:
            print(f"pairs/s (device phases): {n / total:.1f}")
    return res
