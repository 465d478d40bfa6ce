"""High-level alignment API of the port: batches, device phases, decode.

The counterpart of ``aim_tpu/api.py``: sort long reads by estimated
difficulty, pack the pairs, pick the tier for the batch's alphabet, upload
each chunk, run the kernel (or the dense exact tier), pull the records,
decode them by their grammar (WFA and GenASM step records, packed runs, or
the dense tiers' direction codes and histories) into scores and CIGARs
with the native decoders, re-run the pairs a tier flags on the wider bands
of the retry ladder and then on the exact host oracle, emit the
reference-format file.  GenASM configs no kernel admits run on the host
tier: the oracle is their compute path.  The host runtime (parser, record
decoders, emitter, oracle) is the port's ``aim_tpu_torch.native``;
``align_file`` can trace the align span (``profile_dir``) and measure its
energy (``energy``: the GPU's NVML counter, the host's RAPL counters).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from aim_tpu_torch import energy as _energy
from aim_tpu_torch import native
from aim_tpu_torch.config import ALGO_GENASM, ALGO_NW, ALGO_SWG, ALGO_WFA, \
    AlignConfig
from aim_tpu_torch.ops import kernels
from aim_tpu_torch.ops.nwswg_long import band_c
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
    # re-ran; WFA and the GenASM short tier never flag
    n_fallback: int = 0
    # flagged pairs a wider band of the retry ladder certified, in all and
    # by plane count
    n_retry: int = 0
    retry_by_planes: dict = field(default_factory=dict)
    # energy measured over align_file's align span (J), None where not
    # measured: the GPU's NVML total-energy counter, the host's RAPL
    # package + DRAM counters
    gpu_energy_j: float | None = None
    energy_measured_j: float | None = None


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
                      packed_ok: bool = True,
                      per_pair: int | None = None) -> int:
    """Pairs per chunk that fit the device budget, at the per-pair
    footprint of the kernel that serves the config (uploads, records,
    global scratch) unless ``per_pair`` gives another."""
    if budget_bytes is None:
        budget_bytes = _device_memory_budget(device)
    if per_pair is None:
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
        t_retrieve=res.t_retrieve, n_fallback=res.n_fallback,
        n_retry=res.n_retry, retry_by_planes=res.retry_by_planes)


def _align_impl(pats, txts, plens, tlens, cfg: AlignConfig,
                device) -> AlignResult:
    device = torch.device(device)
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
    # bytes too, K5 takes its byte layout, K4 needs the packed codes, the
    # dense tiers take raw bytes.
    up_pats, up_txts, packed = pack_seqs(pats, txts, plens, tlens, R)
    fwd = kernels.forward_fn(cfg, packed_ok=packed)
    if fwd.records == kernels.HOST:
        # the host tier (aim_tpu/api.py:572-581): the exact multi-threaded
        # oracle is the compute path
        t0 = time.perf_counter()
        osc, oops, ob, oe = _oracle_align(pats, txts, plens, tlens, cfg)
        res.t_kernel = time.perf_counter() - t0
        scores[:] = osc
        if cfg.backtrace:
            ops[:], begin[:], end[:] = oops, ob, oe
        return _overflow_bt_pass(pats, txts, plens, tlens, cfg, res)
    bs = _plan_bs(cfg, n, device, packed_ok=packed)
    if fwd.records in kernels.DENSE_RECORDS:
        up_pats, up_txts, packed = pats, txts, False
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
        records.extend({k: v.cpu().numpy() for k, v in o.items()}
                       if isinstance(o, dict) else o.cpu().numpy()
                       for o in outs)
        res.t_retrieve += time.perf_counter() - t2
        del outs

    smax = cfg.max_score
    retry_stages = _retry_stages(fwd)
    for lo, rec in zip(starts, records):
        chunk = slice(lo, min(lo + bs, n))
        flagged = None
        if fwd.records in kernels.DENSE_RECORDS:
            _decode_dense(fwd.records, rec, cfg, chunk, pats, txts, plens,
                          tlens, scores, ops, begin, end)
            if "needs_fallback" in rec:
                flagged = np.nonzero(rec["needs_fallback"])[0]
        elif fwd.records in (kernels.STEP_RECORDS, kernels.GENASM_RECORDS):
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
            # packed runs: lane 0 = cursor | flags << 8 (bit 8 =
            # needs_fallback), lane 1 = score, then the runs
            lane0 = rec[:, 0].astype(np.int32)
            scores[chunk] = rec[:, 1]
            flagged = np.nonzero((lane0 >> 8) & 1)[0]
            if cfg.backtrace:
                o, b, e = native.wfa_runs_to_ops(
                    rec, scores[chunk], plens[chunk], tlens[chunk],
                    max_score=1 << 30, max_ops=max_ops)
                ops[chunk], begin[chunk], end[chunk] = o, b, e
        if flagged is None or not len(flagged):
            continue
        # flagged pairs: the wider bands of the ladder on the device, then
        # the exact host oracle for what they still flag
        sel = flagged
        for p in retry_stages:
            if not len(sel):
                break
            sel = _retry_wide(fwd, cfg, pats[chunk], txts[chunk],
                              plens[chunk], tlens[chunk], sel, scores, ops,
                              begin, end, lo, max_ops, device, res, planes=p)
        if not len(sel):
            continue
        sel = lo + sel
        res.n_fallback += len(sel)
        osc, oops, ob, oe = _oracle_align(pats[sel], txts[sel], plens[sel],
                                          tlens[sel], cfg)
        scores[sel] = osc
        if cfg.backtrace:
            ops[sel], begin[sel], end[sel] = oops, ob, oe
    return _overflow_bt_pass(pats, txts, plens, tlens, cfg, res)


def _decode_dense(grammar, rec, cfg: AlignConfig, chunk, pats, txts, plens,
                  tlens, scores, ops, begin, end):
    """Scores and, with backtrace, CIGARs of a dense tier's chunk
    (aim_tpu/api.py:730-747): WFA histories walked by
    ``native.wfa_backtrace_batch``, NW/SWG direction codes by the native
    walkers."""
    scores[chunk] = rec["scores"]
    if not cfg.backtrace:
        return
    if grammar == kernels.DENSE_WFA:
        ph, pm = rec["packed_hist"], rec["packed_meta"]
        K = 2 * cfg.max_score + 1
        o, b, e = native.wfa_backtrace_batch(
            ph[:, :, :K], ph[:, :, K:2 * K], ph[:, :, 2 * K:3 * K],
            pm[:, :, 0].astype(np.int32), pm[:, :, 1].astype(np.int32),
            pm[:, :, 2].astype(np.uint8), rec["scores"], pats[chunk],
            txts[chunk], plens[chunk], tlens[chunk], mismatch=cfg.mismatch,
            gap_o=cfg.gap_o, gap_e=cfg.gap_e, max_score=cfg.max_score)
    else:
        walker = (native.nw_traceback_bits if grammar == kernels.DENSE_NW
                  else native.swg_traceback_bits)
        o, b, e = walker(rec["bits"], plens[chunk], tlens[chunk],
                         2 * cfg.read_size)
    ops[chunk], begin[chunk], end[chunk] = o, b, e


def _retry_stages(tier) -> tuple:
    """The plane counts of the band-retry ladder, ascending (copied from
    ``aim_tpu/api.py::_retry_stages``): AIM_TPU_RETRY_PLANES (default
    "2,4,8"; malformed or out-of-range tokens are warned about and
    dropped, an explicit empty string turns the ladder off), keeping only
    stages wider than the tier's primary band.  A tier without a retry
    has none."""
    if getattr(tier, "retry", None) is None:
        return ()
    raw = os.environ.get("AIM_TPU_RETRY_PLANES", "2,4,8")
    stages = set()
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            p = int(tok)
        except ValueError:
            print(f"AIM_TPU_RETRY_PLANES: ignoring malformed token "
                  f"{tok!r}", file=sys.stderr)
            continue
        if 1 < p <= 8:
            stages.add(p)
        else:
            print(f"AIM_TPU_RETRY_PLANES: ignoring out-of-range plane "
                  f"count {p} (need 2..8)", file=sys.stderr)
    if not stages and raw.strip() != "":
        stages = {2}
    primary = getattr(tier, "primary_planes", 1)
    return tuple(sorted(p for p in stages if p > primary))


def _retry_wide(tier, cfg: AlignConfig, cpats, ctxts, cplens, ctlens, sel,
                scores, ops, begin, end, lo, max_ops, device,
                res: AlignResult, planes: int = 2):
    """Re-run a chunk's flagged pairs ``sel`` (indices into the chunk) on
    ``tier``'s retry at ``planes`` planes (band half-width 64*planes - 1),
    as ``aim_tpu/api.py::_retry_wide`` does: pairs this band flags for
    host-computable reasons are skipped, batches are capped by device
    memory (at most 8192, a power of two), certified pairs land their
    scores and CIGARs and count in ``res.n_retry``; returns the pairs
    still flagged.  The raw rows are uploaded (no 2-bit packing).  A
    launch that fails raises: nothing falls back quietly."""
    unfix = (cplens[sel] > ctlens[sel] + 1) \
        | (ctlens[sel].astype(np.int64) > cplens[sel] + band_c(planes))
    if cfg.algo == ALGO_SWG:
        margin = cfg.gap_o + cfg.gap_e + max(cfg.mismatch, abs(cfg.match),
                                             cfg.gap_e)
        if cfg.max_score + margin > 32767:
            return sel
        unfix = unfix | ((cfg.gap_o + np.maximum(cplens[sel], ctlens[sel])
                          .astype(np.int64) * cfg.gap_e + margin) > 32767)
    if unfix.any():
        keep = sel[~unfix]
        if not len(keep):
            return sel
        left = _retry_wide(tier, cfg, cpats, ctxts, cplens, ctlens, keep,
                           scores, ops, begin, end, lo, max_ops, device, res,
                           planes)
        return np.sort(np.concatenate([sel[unfix], left]))
    cap = 128
    budget_cap = _memory_batch_cap(
        cfg, torch.device(device),
        per_pair=tier.retry_bytes_per_pair(planes))
    while cap * 2 <= min(8192, budget_cap):
        cap *= 2
    if len(sel) > cap:
        return np.concatenate([
            _retry_wide(tier, cfg, cpats, ctxts, cplens, ctlens,
                        sel[s0:s0 + cap], scores, ops, begin, end, lo,
                        max_ops, device, res, planes)
            for s0 in range(0, len(sel), cap)])
    rpl = cplens[sel].astype(np.int32)
    rtl = ctlens[sel].astype(np.int32)
    args = to_device_batch(cpats[sel], ctxts[sel], rpl, rtl, device)
    pr = np.ascontiguousarray(
        tier.retry(*args, cfg=cfg, planes=planes).cpu().numpy())
    sc2 = pr[:, 1].astype(np.int32)
    fb2 = ((pr[:, 0].astype(np.int32) >> 8) & 1).astype(bool)
    good = ~fb2
    if good.any():
        g = sel[good]
        res.n_retry += len(g)
        res.retry_by_planes[planes] = \
            res.retry_by_planes.get(planes, 0) + len(g)
        scores[lo + g] = sc2[good]
        if ops is not None:
            o, b, e = native.wfa_runs_to_ops(pr, sc2, rpl, rtl,
                                             max_score=1 << 30,
                                             max_ops=max_ops)
            ops[lo + g] = o[good]
            begin[lo + g] = b[good]
            end[lo + g] = e[good]
    return sel[fb2]


def _oracle_align(pats, txts, plens, tlens, cfg: AlignConfig):
    """The exact host path for flagged pairs (aim_tpu/api.py
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
    if cfg.algo == ALGO_GENASM:
        return native.genasm_align(pats, txts, plens, tlens,
                                   max_score=cfg.max_score,
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
    stages = ",".join(f"{p}:{k}" for p, k in
                      sorted(res.retry_by_planes.items())) or "-"
    with open(path, "w") as f:
        f.write(f"{label}: {device_name(device)} | "
                f"algo={cfg.algo} max_score={cfg.max_score} "
                f"read_size={cfg.read_size} backtrace={cfg.backtrace} "
                f"adaptive={cfg.adaptive} pairs={n} "
                f"load_s={res.t_load:.6f} kernel_s={res.t_kernel:.6f} "
                f"retrieve_s={res.t_retrieve:.6f} "
                f"fallback={res.n_fallback} retry={res.n_retry} "
                f"retry_by_planes={stages}\n")


def _profiled_align(profile_dir, pats, txts, plens, tlens, cfg, device):
    """``align`` under torch.profiler (CPU activities, and CUDA ones on a
    CUDA device), its trace written to ``profile_dir/trace.json`` as a
    chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        res = align(pats, txts, plens, tlens, cfg, device)
        _sync(device)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return res


def align_file(input_path: str, output_path: str, n_reads: int,
               cfg: AlignConfig, device="cuda", verbose=True,
               device_log: str | None = None, energy: bool = False,
               profile_dir: str | None = None) -> AlignResult:
    """File-to-file pipeline (the reference host main, host.c:136).
    n_reads is the number of PAIRS requested; fewer are aligned if the
    file is shorter.

    profile_dir: a torch.profiler trace of the align span is written there
    (``trace.json``, chrome format).  energy: the GPU's and the host's
    energy over the align span are measured and printed (NVML's
    total-energy counter, RAPL); what cannot be read is reported as not
    measured, never estimated."""
    device = torch.device(device)
    t0 = time.perf_counter()
    pats, txts, plens, tlens = native.parse_pairs(input_path, n_reads,
                                                  cfg.read_size, threads=0)
    t_parse = time.perf_counter() - t0
    meter = _energy.Meter(device) if energy else None
    if profile_dir:
        res = _profiled_align(profile_dir, pats, txts, plens, tlens, cfg,
                              device)
    else:
        res = align(pats, txts, plens, tlens, cfg, device)
    if meter is not None:
        _sync(device)
        res.gpu_energy_j, res.energy_measured_j = meter.stop()
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
        if energy:
            if res.gpu_energy_j is not None:
                print(f"GPU Energy (J, measured, NVML total-energy counter "
                      f"over the align span): {res.gpu_energy_j:f}")
            else:
                print(f"GPU Energy: not measured ({meter.gpu_missing})")
            if res.energy_measured_j is not None:
                print(f"Host Energy (J, measured, RAPL package+DRAM over "
                      f"the align span): {res.energy_measured_j:f}")
    return res
