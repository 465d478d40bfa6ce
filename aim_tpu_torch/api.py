"""High-level alignment API of the port: batches, device phases, decode.

The counterpart of ``aim_tpu/api.py``: pack the pairs, pick the tier for
the batch's alphabet, upload each chunk, run the kernel (or the dense
exact tier), pull the records, decode them by their grammar (WFA and
GenASM step records, packed runs, or the dense tiers' direction codes and
histories) into scores and CIGARs with the native decoders (step records
and packed runs in one pass over the batch, on row ranges across the
host's cores), re-run the pairs a tier flags on the wider bands of the
retry ladder and then on the exact host oracle, emit the reference-format
file.  Every batch takes this one path, in input order, at every read
size.  ``device`` is one device or a list of them: a list shards each
chunk into one contiguous block an entry, as ``aim_tpu``'s ``shard_map``
over its pair mesh does (``parallel.mesh``).
GenASM configs no kernel admits run on the host tier: the oracle is their
compute path.  The host runtime (parser, record
decoders, emitter, oracle) is the port's ``aim_tpu_torch.native``.
Each host stage of a call runs under ``aim_tpu_torch.spans``: the call's
record of stage seconds and byte counters comes back on the result, and
under a torch profiler each stage is a ``record_function`` range.
``align_file`` can trace the whole call (``profile_dir``) and measure the
align span's energy (``energy``: the GPU's NVML counter, the host's RAPL
counters).
"""

from __future__ import annotations

import contextlib
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from aim_tpu_torch import energy as _energy
from aim_tpu_torch import native, spans
from aim_tpu_torch.config import ALGO_GENASM, ALGO_NW, ALGO_SWG, ALGO_WFA, \
    AlignConfig
from aim_tpu_torch.ops import kernels
from aim_tpu_torch.ops.nwswg_long import band_c
from aim_tpu_torch.ops.common import pack_seqs, round_up, to_device_batch

WAVE = 8            # chunks uploaded together before their kernels run
DEFAULT_BUDGET = 2 << 30
# output bytes (rows of ops) a thread of the decode pass takes at least:
# below twice this the pass runs on the calling thread.  On an H100's
# 8-core host a pool thread costs ~1 ms to start, and a pass of 14 MiB
# ran no faster on 2 to 4 threads than on one; 28 MiB and more did.
DECODE_MIN_BYTES = 10 << 20


@dataclass
class AlignResult:
    scores: np.ndarray                 # [n] int32
    ops: np.ndarray | None = None      # [n, 2R] uint8 (backtrace only)
    begin: np.ndarray | None = None    # [n] int32
    end: np.ndarray | None = None      # [n] int32
    # device phase timings (seconds), from the call's stages: upload,
    # kernel, retrieve
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
    # the call's record: stage seconds and counters (aim_tpu_torch.spans)
    spans: spans.Record | None = None


def _device_list(device) -> list[torch.device]:
    """``device``, one device or a sequence of them, as a list: each entry
    one shard, in order (an entry may repeat).  Raises on an empty list and
    on a CUDA device this host does not have."""
    if isinstance(device, (str, torch.device)):
        devs = [torch.device(device)]
    else:
        devs = [torch.device(d) for d in device]
    if not devs:
        raise ValueError("no device to align on")
    for d in devs:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"{d}: this host has "
                               f"{torch.cuda.device_count()} CUDA device(s)")
    return devs


def _sync(devices: list[torch.device]):
    """Wait for every CUDA device of the list."""
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _device_memory_budget(device: torch.device) -> int:
    """Half of the device memory free now (CUDA), else a conservative
    default for devices that report none (CPU)."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free) // 2
    return DEFAULT_BUDGET


def _memory_batch_cap(cfg: AlignConfig, device,
                      budget_bytes: int | None = None,
                      packed_ok: bool = True,
                      per_pair: int | None = None) -> int:
    """Pairs per chunk that fit the smallest budget of ``device`` (one
    device or a list), at the per-pair footprint of the kernel that serves
    the config (uploads, records, global scratch) unless ``per_pair``
    gives another."""
    if budget_bytes is None:
        budget_bytes = min(_device_memory_budget(d)
                           for d in dict.fromkeys(_device_list(device)))
    if per_pair is None:
        per_pair = kernels.forward_fn(cfg, packed_ok).device_bytes_per_pair
    return max(256, budget_bytes // per_pair)


def _plan_bs(cfg: AlignConfig, n: int, devices,
             packed_ok: bool = True) -> int:
    """Chunk size (aim_tpu/api.py:439-448): cfg.batch_pairs, capped by
    device memory and by the batch itself, rounded to 8 a device of
    ``devices`` (one device or a list), so that each device's block is
    ``bs // ndev`` pairs."""
    align_to = max(8, 8 * len(_device_list(devices)))
    bs = min(cfg.batch_pairs,
             _memory_batch_cap(cfg, devices, packed_ok=packed_ok),
             round_up(n, align_to))
    return max(round_up(bs, align_to), align_to)


def _blocks(lo: int, hi: int, bs: int, devices):
    """The non-empty blocks of chunk [lo, hi) of a ``bs``-pair plan as
    (device, b0, b1): one contiguous block of ``bs // ndev`` pairs a
    device, in order; the tail chunk's last blocks may be short or
    empty."""
    blk = bs // len(devices)
    for d, dev in enumerate(devices):
        b0 = lo + d * blk
        b1 = min(b0 + blk, hi)
        if b0 < b1:
            yield dev, b0, b1


def _gather(parts):
    """One chunk's host records from its blocks' (arrays, or dicts of
    arrays), in pair order."""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], dict):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


def align(pats, txts, plens, tlens, cfg: AlignConfig,
          device="cuda") -> AlignResult:
    """Align a pair batch ([n, R] uint8 pats/txts, [n] int32 lengths) on
    ``device``.  Returns scores (+ ops buffers when cfg.backtrace).
    Device work runs in cfg.batch_pairs chunks.

    ``device`` is one device or a sequence of them, each entry one shard:
    every chunk splits into one contiguous block an entry, in order, each
    block's kernel runs on its device (the blocks of a chunk are launched
    on all devices before any is waited for), and the records come back in
    pair order; a block's flagged pairs climb the retry ladder on its
    device.  The output is the one-device run's, byte for byte.

    The call's host stages are timed by ``aim_tpu_torch.spans``; the
    record is ``res.spans``, and ``t_load`` (upload), ``t_kernel`` and
    ``t_retrieve`` are its stages."""
    with spans.call("align", pats.shape[0]) as rec:
        cfg.validate()
        devs = _device_list(device)
        plens = np.ascontiguousarray(plens, np.int32)
        tlens = np.ascontiguousarray(tlens, np.int32)
        n = pats.shape[0]
        if n and max(int(plens.max()), int(tlens.max())) > cfg.read_size:
            raise ValueError(
                f"sequence longer than read_size={cfg.read_size}")
        res = _align_impl(pats, txts, plens, tlens, cfg, devs)
        if cfg.algo == ALGO_GENASM:
            # on the final scores, so that every GenASM tier counts alike
            spans.count("over_k_pairs", int(np.count_nonzero(
                res.scores > cfg.max_score)))
        sec = rec.seconds
        res.t_load = sec["upload"]
        res.t_kernel = sec["kernel"]
        res.t_retrieve = sec["retrieve"]
        res.spans = rec
    return res


def _nbytes(out) -> int:
    """Bytes of a block's host records (an array, or a dict of them)."""
    if isinstance(out, dict):
        return sum(v.nbytes for v in out.values())
    return out.nbytes


def _align_impl(pats, txts, plens, tlens, cfg: AlignConfig,
                devices: list[torch.device]) -> AlignResult:
    n = pats.shape[0]
    R = cfg.read_size
    max_ops = 2 * R

    with spans.span("plan"):
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
    with spans.span("pack"):
        up_pats, up_txts, packed = pack_seqs(pats, txts, plens, tlens, R)
        fwd = kernels.forward_fn(cfg, packed_ok=packed)
    if fwd.records == kernels.HOST:
        # the host tier (aim_tpu/api.py:572-581): the exact multi-threaded
        # oracle is the compute path
        with spans.span("kernel"):
            osc, oops, ob, oe = _oracle_align(pats, txts, plens, tlens, cfg)
            scores[:] = osc
            if cfg.backtrace:
                ops[:], begin[:], end[:] = oops, ob, oe
        return _overflow_bt_pass(pats, txts, plens, tlens, cfg, res)
    with spans.span("plan"):
        bs = _plan_bs(cfg, n, devices, packed_ok=packed)
    if fwd.records in kernels.DENSE_RECORDS:
        up_pats, up_txts, packed = pats, txts, False
    starts = list(range(0, n, bs))
    spans.count("chunks", len(starts))
    # a chunk's blocks as [(device, b0, b1, host records)], in pair order
    records = []
    for w0 in range(0, len(starts), WAVE):
        wave = starts[w0:w0 + WAVE]
        with spans.span("upload"):
            uploads = [[(dev, b0, b1,
                         to_device_batch(up_pats[b0:b1], up_txts[b0:b1],
                                         plens[b0:b1], tlens[b0:b1], dev))
                        for dev, b0, b1 in _blocks(lo, min(lo + bs, n), bs,
                                                   devices)]
                       for lo in wave]
            _sync(devices)
            spans.count("h2d_bytes", sum(t.nbytes for blocks in uploads
                                         for *_, args in blocks
                                         for t in args))

        outs = []
        for blocks in uploads:
            with spans.span("kernel"):
                outs.append([(dev, b0, b1, fwd(*args, cfg=cfg,
                                               packed=packed))
                             for dev, b0, b1, args in blocks])
                _sync(devices)
        del uploads

        with spans.span("retrieve"):
            got = [[(dev, b0, b1, {k: v.cpu().numpy() for k, v in o.items()}
                     if isinstance(o, dict) else o.cpu().numpy())
                    for dev, b0, b1, o in blocks] for blocks in outs]
            spans.count("d2h_bytes", sum(_nbytes(r) for blocks in got
                                         for *_, r in blocks))
        records.extend(got)
        del outs, got

    with spans.span("decode"):
        # each chunk's records, gathered from its blocks, by first row
        chunks = [(lo, _gather([r for *_, r in blocks]))
                  for lo, blocks in zip(starts, records)]
        if fwd.records in kernels.DENSE_RECORDS:
            for lo, rec in chunks:
                _decode_dense(fwd.records, rec, cfg,
                              slice(lo, min(lo + bs, n)), pats, txts, plens,
                              tlens, scores, ops, begin, end)
            threads = int(cfg.backtrace)
        else:
            threads = _decode_pass(fwd.records, chunks, cfg, plens, tlens,
                                   scores, ops, begin, end,
                                   _decode_threads(n, max_ops))
        flags = [_flagged(fwd.records, rec) for _, rec in chunks]
    spans.count("decode_threads", threads)
    rows = [lo + f for lo, f in zip(starts, flags) if f is not None]
    if rows:
        rows = np.concatenate(rows)
        spans.count("flagged_pairs", len(rows))
        # past tlen + 1 the flat tape aliases: the ladder skips these
        spans.count("alias_pairs", int(np.count_nonzero(
            plens[rows] > tlens[rows] + 1)))

    retry_stages = _retry_stages(fwd)
    for lo, blocks, flagged in zip(starts, records, flags):
        chunk = slice(lo, min(lo + bs, n))
        if flagged is None or not len(flagged):
            continue
        # flagged pairs: the wider bands of the ladder on the device of
        # their block, then the exact host oracle for what they still flag
        with spans.span("retry"):
            left = []
            for dev, b0, b1, _ in blocks:
                sel = flagged[(flagged >= b0 - lo) & (flagged < b1 - lo)]
                for p in retry_stages:
                    if not len(sel):
                        break
                    sel = _retry_wide(fwd, cfg, pats[chunk], txts[chunk],
                                      plens[chunk], tlens[chunk], sel,
                                      scores, ops, begin, end, lo, max_ops,
                                      dev, res, planes=p)
                left.append(sel)
            sel = np.concatenate(left)
        if not len(sel):
            continue
        with spans.span("fallback"):
            sel = lo + sel
            res.n_fallback += len(sel)
            spans.count("fallback_pairs", len(sel))
            spans.count("fallback_cells", int(
                ((plens[sel] + 1).astype(np.int64) * (tlens[sel] + 1)).sum()))
            osc, oops, ob, oe = _oracle_align(pats[sel], txts[sel],
                                              plens[sel], tlens[sel], cfg)
            scores[sel] = osc
            if cfg.backtrace:
                ops[sel], begin[sel], end[sel] = oops, ob, oe
    return _overflow_bt_pass(pats, txts, plens, tlens, cfg, res)


def _decode_threads(n: int, max_ops: int) -> int:
    """Threads for a decode pass of ``n`` output rows of ``max_ops`` bytes:
    one for each ``DECODE_MIN_BYTES``, at least one, at most parse's
    min(cores, 16)."""
    cores = min(os.cpu_count() or 1, 16)
    return max(1, min(cores, n * max_ops // DECODE_MIN_BYTES))


def _decode_pass(grammar, chunks, cfg: AlignConfig, plens, tlens, scores,
                 ops, begin, end, threads: int) -> int:
    """Scores and, with backtrace, CIGARs of the wave loop's step records
    (WFA, GenASM) or packed runs (``chunks``: (first row, records) a
    chunk), the whole batch in one pass: its rows split into up to
    ``threads`` ranges, each range's records decoded by the native
    expander straight into their rows of ``scores``/``ops``/``begin``/
    ``end``, the ranges on a thread pool of the call (ctypes drops the
    GIL) or, at one, on this thread.  Returns the threads that decoded
    CIGARs: 0 without backtrace, where only scores are copied.  Counts the
    step records' ``decode_skipped_rows`` and ``decode_clamped_pairs``
    (``native.wfa_steps_to_ops``'s ``stats``), summed over the ranges."""
    if grammar == kernels.PACKED_RUNS:
        col = 1
    else:
        # WFA: row smax+3 holds the score; GenASM: the same grammar with
        # one level row a text position, the score in row R+3
        levels = cfg.max_score if grammar == kernels.STEP_RECORDS \
            else cfg.read_size
        col = levels + 3
    if not cfg.backtrace:
        for lo, r in chunks:
            scores[lo:lo + len(r)] = r[:, col]
        return 0
    max_ops = ops.shape[1]
    # range t holds rows [t * step, (t + 1) * step), cut where chunks end
    step = -(-len(scores) // threads)
    ranges = [[] for _ in range(threads)]
    for c0, r in chunks:
        lo, c1 = c0, c0 + len(r)
        while lo < c1:
            hi = min(c1, (lo // step + 1) * step)
            ranges[lo // step].append((lo, hi, r[lo - c0:hi - c0]))
            lo = hi
    ranges = [part for part in ranges if part]

    def run(part):
        stats = {}
        for lo, hi, r in part:
            if grammar == kernels.PACKED_RUNS:
                scores[lo:hi] = r[:, col]
                native.wfa_runs_to_ops(
                    r, scores[lo:hi], plens[lo:hi], tlens[lo:hi],
                    max_score=1 << 30, max_ops=max_ops,
                    out=(ops[lo:hi], begin[lo:hi], end[lo:hi]))
            else:
                native.wfa_steps_to_ops(
                    r, plens[lo:hi], tlens[lo:hi], max_score=levels,
                    max_ops=max_ops,
                    out=(scores[lo:hi], ops[lo:hi], begin[lo:hi],
                         end[lo:hi]), stats=stats)
        return stats

    if len(ranges) == 1:
        done = [run(ranges[0])]
    else:
        with ThreadPoolExecutor(len(ranges)) as ex:
            done = list(ex.map(run, ranges))
    for key in ("skipped_rows", "clamped_pairs"):
        spans.count("decode_" + key, sum(st.get(key, 0) for st in done))
    return len(ranges)


def _flagged(grammar, rec):
    """The pairs of a chunk's records that its tier flags, as indices into
    the chunk: the dense tiers' ``needs_fallback``; packed runs' lane 0 =
    cursor | flags << 8, bit 8 = needs_fallback.  Step records (WFA,
    GenASM) never flag: None."""
    if grammar in kernels.DENSE_RECORDS:
        return np.nonzero(rec["needs_fallback"])[0] \
            if "needs_fallback" in rec else None
    if grammar == kernels.PACKED_RUNS:
        return np.nonzero((rec[:, 0] >> 8) & 1)[0]
    return None


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
        spans.count("retry_pairs", len(g))
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


def _oracle_align(pats, txts, plens, tlens, cfg: AlignConfig,
                  threads: int = 0):
    """The exact host path for flagged pairs (aim_tpu/api.py
    ``_oracle_align``), on ``threads`` threads (0: a pool sized from the
    host)."""
    if cfg.algo == ALGO_NW:
        return native.nw_align(pats, txts, plens, tlens,
                               mismatch=cfg.mismatch, gap_i=cfg.gap_i,
                               gap_d=cfg.gap_d, backtrace=cfg.backtrace,
                               threads=threads)
    if cfg.algo == ALGO_SWG:
        return native.swg_align(pats, txts, plens, tlens, match=cfg.match,
                                mismatch=cfg.mismatch, gap_o=cfg.gap_o,
                                gap_e=cfg.gap_e, max_score=cfg.max_score,
                                cell_width=cfg.cell_width,
                                backtrace=cfg.backtrace, threads=threads)
    if cfg.algo == ALGO_GENASM:
        return native.genasm_align(pats, txts, plens, tlens,
                                   max_score=cfg.max_score,
                                   backtrace=cfg.backtrace, threads=threads)
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
    with spans.span("fallback"):
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
    """The dpu-out analogue (aim_tpu/api.py:833-846): one line a device
    of ``device`` (one device or a list) with the run, then the seconds of
    the call's other stages and its counters (``res.spans``; ``kernel_s``
    and ``retrieve_s`` are those stages already)."""
    stages = ",".join(f"{p}:{k}" for p, k in
                      sorted(res.retry_by_planes.items())) or "-"
    rec = res.spans
    tail = "" if rec is None else "".join(
        [f" {s}_s={v:.6f}" for s, v in rec.seconds.items()
         if s not in ("kernel", "retrieve")]
        + [f" {c}={v}" for c, v in rec.counts.items()])
    with open(path, "w") as f:
        for dev in _device_list(device):
            label = f"GPU {dev.index or 0}" if dev.type == "cuda" else "CPU"
            f.write(f"{label}: {device_name(dev)} | "
                    f"algo={cfg.algo} max_score={cfg.max_score} "
                    f"read_size={cfg.read_size} backtrace={cfg.backtrace} "
                    f"adaptive={cfg.adaptive} pairs={n} "
                    f"load_s={res.t_load:.6f} kernel_s={res.t_kernel:.6f} "
                    f"retrieve_s={res.t_retrieve:.6f} "
                    f"fallback={res.n_fallback} retry={res.n_retry} "
                    f"retry_by_planes={stages}{tail}\n")


@contextlib.contextmanager
def _profiled(profile_dir, devices):
    """The block under torch.profiler (CPU activities, and CUDA ones when
    a device of the list is CUDA), its trace written to
    ``profile_dir/trace.json`` as a chrome trace; without a
    ``profile_dir``, the block alone."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        _sync(devices)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def align_file(input_path: str, output_path: str, n_reads: int,
               cfg: AlignConfig, device="cuda", verbose=True,
               device_log: str | None = None, energy: bool = False,
               profile_dir: str | None = None) -> AlignResult:
    """File-to-file pipeline (the reference host main, host.c:136).
    n_reads is the number of PAIRS requested; fewer are aligned if the
    file is shorter.  ``device``: one device or a list, as in ``align``.

    profile_dir: a torch.profiler trace of the whole call, parse to emit,
    is written there (``trace.json``, chrome format), each stage of
    ``aim_tpu_torch.spans`` an ``aim.<stage>`` range inside ``aim.call``.
    energy: the GPU's and the host's energy over the align span are
    measured and printed (NVML's total-energy counter, RAPL); what cannot
    be read is reported as not measured, never estimated.  device_log: the
    file gets one line a device, with the call's stage seconds and
    counters."""
    devs = _device_list(device)
    with _profiled(profile_dir, devs), spans.call("align_file") as rec:
        with spans.span("parse"):
            threads = native.parse_threads(input_path, n_reads,
                                           cfg.read_size)
            pats, txts, plens, tlens = native.parse_pairs(
                input_path, n_reads, cfg.read_size, threads)
        spans.count("parse_threads", threads)
        rec.pairs = len(plens)
        meter = _energy.Meter(devs) if energy else None
        res = align(pats, txts, plens, tlens, cfg, devs)
        if meter is not None:
            _sync(devs)
            res.gpu_energy_j, res.energy_measured_j = meter.stop()
        n = len(res.scores)
        with spans.span("emit"):
            native.emit_output(output_path, np.arange(n, dtype=np.int32),
                               res.scores, res.ops, res.begin, res.end,
                               cfg.backtrace)
    if device_log:
        write_device_log(device_log, cfg, res, n, devs)
    if verbose:
        print(f"Parsed {n} pairs in {rec.seconds['parse'] * 1e3:.3f} ms")
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
        if res.n_retry:
            print(f"wide-band device retry pairs: {res.n_retry}")
        if res.n_fallback:
            print(f"host-oracle fallback pairs: {res.n_fallback}")
    return res
