"""ctypes bindings to the native host runtime (oracle.cpp).

The port's own copy of ``aim_tpu/native`` (parser, exact oracles, record
decoders, output emitter; tests hold the two equal).  The shared library
is built with g++ at first use into ``aim_tpu_torch/_build/``, keyed on a
hash of ``oracle.cpp``: each builder writes a temporary file of its own and
moves it into place with ``os.replace``, so processes that build at once
do not race.  Nothing is written next to the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "oracle.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_LOCK = threading.Lock()
_LIB = None

_i8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS")
_i16pv = np.ctypeslib.ndpointer(dtype=np.int16)  # strided views OK
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_chp = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")  # char*
# parse_pairs' allocator, called once from inside the parse with the pair
# count: fills out[0:4] with the outputs' addresses and returns 0, or
# returns 1 where they cannot be had
_PARSE_ALLOC = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_long,
                                ctypes.POINTER(ctypes.c_void_p))
# file bytes a thread of the parse pass takes at least
PARSE_MIN_BYTES = 1 << 20


def library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"liboracle_{h.hexdigest()[:16]}.so")


def _build() -> str:
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++"] + _FLAGS + ["-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def load():
    """Load (building if needed) the native library. Raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(_build())

        lib.aim_parse_pairs_par.restype = ctypes.c_long
        lib.aim_parse_pairs_par.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            _PARSE_ALLOC,
        ]
        lib.aim_parse_pairs_range.restype = ctypes.c_long
        lib.aim_parse_pairs_range.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            _i8p, _i8p, _i32p, _i32p,
        ]
        lib.aim_count_pairs.restype = ctypes.c_long
        lib.aim_count_pairs.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.aim_nw_align.restype = None
        lib.aim_nw_align.argtypes = [
            _i8p, _i8p, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _i32p, _chp, _i32p, _i32p,
        ]
        lib.aim_nw_traceback_bits.restype = None
        lib.aim_nw_traceback_bits.argtypes = [
            _i8p, ctypes.c_long, ctypes.c_long, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, _chp, _i32p, _i32p,
        ]
        lib.aim_swg_align.restype = None
        lib.aim_swg_align.argtypes = [
            _i8p, _i8p, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i32p, _chp, _i32p, _i32p,
        ]
        lib.aim_swg_traceback_bits.restype = None
        lib.aim_swg_traceback_bits.argtypes = [
            _i8p, ctypes.c_long, ctypes.c_long, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, _chp, _i32p, _i32p,
        ]
        lib.aim_wfa_align.restype = None
        lib.aim_wfa_align.argtypes = [
            _i8p, _i8p, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i32p, _chp, _i32p, _i32p,
        ]
        lib.aim_wfa_backtrace_batch.restype = None
        lib.aim_wfa_backtrace_batch.argtypes = [
            _i16pv, _i16pv, _i16pv, _i32p, _i32p, _i8p, _i32p,
            _i8p, _i8p, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, _chp, _i32p, _i32p,
        ]
        lib.aim_wfa_runs_to_ops.restype = None
        lib.aim_wfa_runs_to_ops.argtypes = [
            _i16p, ctypes.c_long, _i32p, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, _chp, _i32p, _i32p,
        ]
        lib.aim_genasm_align.restype = None
        lib.aim_genasm_align.argtypes = [
            _i8p, _i8p, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i32p, _chp, _i32p, _i32p,
        ]
        lib.aim_wfa_steps_to_ops.restype = None
        lib.aim_wfa_steps_to_ops.argtypes = [
            _i32p, ctypes.c_long, _i32p, _i32p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, _chp, _i32p, _i32p, _i32p, _i64p,
        ]
        lib.aim_pack_seqs.restype = ctypes.c_int
        lib.aim_pack_seqs.argtypes = [
            _i8p, _i8p, _i32p, _i32p, ctypes.c_long, ctypes.c_int,
            ctypes.c_int, _i8p, _i8p, ctypes.c_int,
        ]
        lib.aim_emit_output.restype = ctypes.c_long
        lib.aim_emit_output.argtypes = [
            ctypes.c_char_p, _i32p, _i32p, _chp, _i32p, _i32p,
            ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        _LIB = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# numpy-facing wrappers
# ---------------------------------------------------------------------------

def parse_threads(path: str, max_pairs: int, read_size: int) -> int:
    """Threads for ``parse_pairs(path, max_pairs, read_size)``: one for
    each ``PARSE_MIN_BYTES`` of the bytes it maps (the file, or the
    2 * (read_size + 2) bytes a pair that ``max_pairs`` valid pairs take
    at most, where that is shorter), at least one, at most min(cores,
    16), the cap of the pack and decode passes."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 1  # parse_pairs reports the path
    size = min(size, max(max_pairs, 0) * 2 * (read_size + 2))
    return max(1, min(os.cpu_count() or 1, 16, size // PARSE_MIN_BYTES))


def parse_pairs(path: str, max_pairs: int, read_size: int, threads: int = 1):
    """Parse a '>pattern\\n<text\\n' pair file (ref: host.c get_reads).

    Returns (patterns [n,R] u8, texts [n,R] u8, plens [n] i32, tlens [n] i32).
    Raises ValueError if a sequence exceeds read_size, at the global first
    offender's line.

    One pass over a read-only map of the file (``aim_parse_pairs_par``):
    ``threads`` byte ranges each count their lines and then copy their
    pairs straight from the map into the rows, each range on a thread of
    the call (ctypes releases the GIL); 0 picks ``parse_threads``.  The
    outputs are made once the pair count is known, with ``np.empty``:
    the pass writes every byte of them.
    """
    lib = load()
    if threads in (None, 0):
        threads = parse_threads(path, max_pairs, read_size)
    out = []

    @_PARSE_ALLOC
    def alloc(n, ptrs):
        try:
            out.extend((np.empty((n, read_size), np.uint8),
                        np.empty((n, read_size), np.uint8),
                        np.empty(n, np.int32), np.empty(n, np.int32)))
        except MemoryError:
            return 1
        for k, a in enumerate(out):
            ptrs[k] = a.ctypes.data
        return 0

    n = lib.aim_parse_pairs_par(path.encode(), max_pairs, read_size,
                                max(1, int(threads)), alloc)
    if n == -1000000000:
        raise FileNotFoundError(path)
    if n == -1000000001:
        raise OSError(f"cannot map {path}")
    if n == -1000000002:
        raise MemoryError(f"no room for the pairs of {path}")
    if n < 0:
        # Mirrors the reference's fatal "READ LENGTH less than length of the
        # input reads" (ref: host.c:119-123).
        raise ValueError(
            f"read longer than READ_SIZE={read_size} at line {-n} of {path}")
    return tuple(out)


def parse_pairs_range(path: str, start_pair: int, max_pairs: int,
                      read_size: int):
    """Parse only pairs [start_pair, start_pair + max_pairs) of a pair
    file: the seek phase is a newline count (no copies), so a multi-host
    process touches O(its block) of parsing/packing work (the reference
    host streams each DPU's contiguous block, host.c:91-134).  Same
    return contract and fatal READ_SIZE semantics (global line numbers)
    as parse_pairs."""
    lib = load()
    pats = np.zeros((max_pairs, read_size), np.uint8)
    txts = np.zeros((max_pairs, read_size), np.uint8)
    plens = np.zeros(max_pairs, np.int32)
    tlens = np.zeros(max_pairs, np.int32)
    n = lib.aim_parse_pairs_range(path.encode(), start_pair, max_pairs,
                                  read_size, pats, txts, plens, tlens)
    if n == -1000000000:
        raise FileNotFoundError(path)
    if n < 0:
        raise ValueError(
            f"read longer than READ_SIZE={read_size} at line {-n} of {path}")
    return pats[:n], txts[:n], plens[:n], tlens[:n]


def count_pairs(path: str, max_pairs: int) -> int:
    """Count complete pairs in a pair file (newline scan, no parsing),
    capped at max_pairs."""
    lib = load()
    n = lib.aim_count_pairs(path.encode(), max_pairs)
    if n == -1000000000:
        raise FileNotFoundError(path)
    return int(n)


def _prep(pats, txts, plens, tlens):
    return (np.ascontiguousarray(pats, np.uint8),
            np.ascontiguousarray(txts, np.uint8),
            np.ascontiguousarray(plens, np.int32),
            np.ascontiguousarray(tlens, np.int32))


def _run_chunked(n, threads, worker):
    """Run worker(lo, hi) over [0, n) with a thread pool.  ctypes releases
    the GIL during the C calls, so row-chunk parallelism scales; threads=1
    keeps the single-thread semantics (the bench baseline), threads=0
    picks a pool size from the host."""
    if threads in (None, 0):
        threads = min(os.cpu_count() or 1, 16)
    if threads <= 1 or n < 64:
        worker(0, n)
        return
    from concurrent.futures import ThreadPoolExecutor
    step = -(-n // threads)
    spans = [(i * step, min(n, (i + 1) * step)) for i in range(threads)
             if i * step < n]
    with ThreadPoolExecutor(len(spans)) as ex:
        list(ex.map(lambda s: worker(*s), spans))


def nw_align(pats, txts, plens, tlens, *, mismatch, gap_i, gap_d, backtrace,
             threads=1):
    lib = load()
    pats, txts, plens, tlens = _prep(pats, txts, plens, tlens)
    n, read_size = pats.shape
    max_ops = 2 * read_size
    scores = np.zeros(n, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)

    def worker(lo, hi):
        lib.aim_nw_align(pats[lo:hi], txts[lo:hi], plens[lo:hi],
                         tlens[lo:hi], hi - lo, read_size,
                         mismatch, gap_i, gap_d, int(backtrace),
                         scores[lo:hi], ops[lo:hi], begin[lo:hi], end[lo:hi])

    _run_chunked(n, threads, worker)
    return scores, ops, begin, end


def swg_align(pats, txts, plens, tlens, *, match, mismatch, gap_o, gap_e,
              max_score, cell_width, backtrace, threads=1):
    lib = load()
    pats, txts, plens, tlens = _prep(pats, txts, plens, tlens)
    n, read_size = pats.shape
    max_ops = 2 * read_size
    scores = np.zeros(n, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)

    def worker(lo, hi):
        lib.aim_swg_align(pats[lo:hi], txts[lo:hi], plens[lo:hi],
                          tlens[lo:hi], hi - lo, read_size,
                          match, mismatch, gap_o, gap_e, max_score,
                          cell_width, int(backtrace),
                          scores[lo:hi], ops[lo:hi], begin[lo:hi], end[lo:hi])

    _run_chunked(n, threads, worker)
    return scores, ops, begin, end


def wfa_align(pats, txts, plens, tlens, *, mismatch, gap_o, gap_e, max_score,
              adaptive, backtrace, threads=1, overflow_backtrace=False):
    lib = load()
    pats, txts, plens, tlens = _prep(pats, txts, plens, tlens)
    n, read_size = pats.shape
    max_ops = 2 * read_size
    scores = np.zeros(n, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)

    def worker(lo, hi):
        lib.aim_wfa_align(pats[lo:hi], txts[lo:hi], plens[lo:hi],
                          tlens[lo:hi], hi - lo, read_size,
                          mismatch, gap_o, gap_e, max_score, int(adaptive),
                          int(backtrace), int(overflow_backtrace),
                          scores[lo:hi], ops[lo:hi], begin[lo:hi], end[lo:hi])

    _run_chunked(n, threads, worker)
    return scores, ops, begin, end


def nw_traceback_bits(bits, plens, tlens, max_ops):
    """Walk device-produced NW direction bits [n, H, W] u8 into ops buffers."""
    lib = load()
    bits = np.ascontiguousarray(bits, np.uint8)
    n, H, W = bits.shape
    plens = np.ascontiguousarray(plens, np.int32)
    tlens = np.ascontiguousarray(tlens, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)
    lib.aim_nw_traceback_bits(bits, H, W, plens, tlens, n, max_ops,
                              ops, begin, end)
    return ops, begin, end


def swg_traceback_bits(bits, plens, tlens, max_ops):
    lib = load()
    bits = np.ascontiguousarray(bits, np.uint8)
    n, H, W = bits.shape
    plens = np.ascontiguousarray(plens, np.int32)
    tlens = np.ascontiguousarray(tlens, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)
    lib.aim_swg_traceback_bits(bits, H, W, plens, tlens, n, max_ops,
                               ops, begin, end)
    return ops, begin, end


def wfa_backtrace_batch(hist_m, hist_i, hist_d, klo, khi, flags, scores,
                        pats, txts, plens, tlens, *, mismatch, gap_o, gap_e,
                        max_score, score_major=False):
    """Walk device-produced dense WFA histories into ops buffers.

    Two accepted layouts (zero-copy either way):
      score_major=False: hist [n, S+1, K] int16, klo/khi/flags [n, S+1]
      score_major=True:  hist [S', n, Kp] int16 (S' >= S+1, Kp >= K),
                         klo/khi/flags [S', n] — the Pallas kernels' native
                         layout; walked via strides, no transpose.
    """
    lib = load()
    pats, txts, plens, tlens = _prep(pats, txts, plens, tlens)
    n, read_size = pats.shape
    max_ops = 2 * read_size

    def prep16(a):
        # Views are fine (e.g. lane slices of a packed transfer buffer):
        # the C walker takes element strides; only the k rows must be dense.
        a = np.asarray(a)
        assert a.dtype == np.int16 and a.strides[-1] == a.itemsize, \
            (a.dtype, a.shape, a.strides)
        return a

    hist_m, hist_i, hist_d = prep16(hist_m), prep16(hist_i), prep16(hist_d)
    klo = np.ascontiguousarray(klo, np.int32)
    khi = np.ascontiguousarray(khi, np.int32)
    flags = np.ascontiguousarray(flags, np.uint8)
    scores = np.ascontiguousarray(scores, np.int32)
    st = [x // hist_m.itemsize for x in hist_m.strides]
    if score_major:
        Sp, n2, Kp = hist_m.shape
        assert n2 >= n  # padded batch; walker visits the first n pairs
        h_score, h_pair = st[0], st[1]
        m_pair, m_score = 1, flags.shape[1]
    else:
        _, S1, K = hist_m.shape
        h_pair, h_score = st[0], st[1]
        m_pair, m_score = S1, 1
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)
    lib.aim_wfa_backtrace_batch(hist_m, hist_i, hist_d, klo, khi, flags,
                                scores, pats, txts, plens, tlens, n,
                                read_size, mismatch, gap_o, gap_e, max_score,
                                h_pair, h_score, m_pair, m_score,
                                ops, begin, end)
    return ops, begin, end


def emit_output(path, idx, scores, ops, begin, end, backtrace):
    """Write the reference-format output file (ref: host.c:332-353)."""
    lib = load()
    idx = np.ascontiguousarray(idx, np.int32)
    scores = np.ascontiguousarray(scores, np.int32)
    if ops is None:
        ops = np.zeros((len(scores), 1), np.uint8)
        begin = np.zeros(len(scores), np.int32)
        end = np.zeros(len(scores), np.int32)
    ops = np.ascontiguousarray(ops, np.uint8)
    begin = np.ascontiguousarray(begin, np.int32)
    end = np.ascontiguousarray(end, np.int32)
    max_ops = ops.shape[1]
    n = len(scores)
    r = lib.aim_emit_output(path.encode(), idx, scores, ops, begin, end, n,
                            max_ops, int(backtrace))
    if r < 0:
        raise IOError(f"cannot write {path}")
    return r


def pack_seqs(pats, txts, plens, tlens, rp, threads: int = 1):
    """2-bit-pack a pair batch for upload (see ops/common.pack_seqs): one
    fused pass that reads each row once, its rows split into up to
    ``threads`` ranges, each on a thread of the call.  Returns
    (packed_pats, packed_txts, True, fused threads) or (pats, txts, False,
    0); the fused threads are 0 where a byte outside ACGT sent the batch
    through the generic alphabet path, or the batch is empty."""
    lib = load()
    pats, txts, plens, tlens = _prep(pats, txts, plens, tlens)
    n, read_size = pats.shape
    if txts.shape != pats.shape or plens.shape != (n,) or \
            tlens.shape != (n,):
        raise ValueError("pack_seqs: need [n, R] pats and txts, [n] lens")
    rb = rp // 4
    # every byte of the [n, rb] rows is written
    out_p = np.empty((n, rb), np.uint8)
    out_t = np.empty((n, rb), np.uint8)
    r = lib.aim_pack_seqs(pats, txts, plens, tlens, n, read_size, rp,
                          out_p, out_t, max(1, int(threads)))
    if r < 0:
        return pats, txts, False, 0
    return out_p, out_t, True, r


def _decoded(out, n: int, max_ops: int, with_scores: bool):
    """The record decoders' outputs: ([n] int32 scores,) [n, max_ops] uint8
    ops, [n] int32 begin and end, fresh, or the caller's ``out`` checked
    for shape, dtype and C order (a row block of a C-contiguous array is
    one)."""
    want = ([((n,), np.int32)] if with_scores else []) + [
        ((n, max_ops), np.uint8), ((n,), np.int32), ((n,), np.int32)]
    if out is None:
        return tuple(np.zeros(shape, dtype) for shape, dtype in want)
    if len(out) != len(want) or any(
            a.shape != shape or a.dtype != dtype or not a.flags.c_contiguous
            for a, (shape, dtype) in zip(out, want)):
        raise ValueError(
            f"out: need {len(want)} C-contiguous arrays of "
            f"{[(shape, np.dtype(dtype).name) for shape, dtype in want]}")
    return tuple(out)


def wfa_runs_to_ops(runs, scores, plens, tlens, *, max_score, max_ops,
                    out=None):
    """Expand device CIGAR runs ([n, NRL] i16, lane 0 = cursor) into the
    reference ops buffers (see oracle.cpp aim_wfa_runs_to_ops).  Returns
    (ops, begin, end), written into ``out`` when it is given."""
    lib = load()
    runs = np.ascontiguousarray(runs, np.int16)
    n, nrl = runs.shape
    scores = np.ascontiguousarray(scores, np.int32)
    plens = np.ascontiguousarray(plens, np.int32)
    tlens = np.ascontiguousarray(tlens, np.int32)
    ops, begin, end = _decoded(out, n, max_ops, with_scores=False)
    lib.aim_wfa_runs_to_ops(runs, nrl, scores, plens, tlens, n,
                            max_score, max_ops, ops, begin, end)
    return ops, begin, end


def wfa_steps_to_ops(records, plens, tlens, *, max_score, max_ops,
                     out=None, stats=None):
    """Expand the step records ([n, SR] i32: K1, K5, and K4 with
    max_score = read_size; see oracle.cpp aim_wfa_steps_to_ops) into the
    reference ops buffers.  Returns (scores, ops, begin, end), written into
    ``out`` when it is given; scores come from the record's score row.
    With a dict ``stats``, adds to its ``skipped_rows`` (level rows only
    stepped over) and ``clamped_pairs`` (pairs whose runs overran their
    row, expanded clamped)."""
    lib = load()
    records = np.ascontiguousarray(records, np.int32)
    n, sr = records.shape
    plens = np.ascontiguousarray(plens, np.int32)
    tlens = np.ascontiguousarray(tlens, np.int32)
    scores, ops, begin, end = _decoded(out, n, max_ops, with_scores=True)
    got = np.zeros(2, np.int64)
    lib.aim_wfa_steps_to_ops(records, sr, plens, tlens, n,
                             max_score, max_ops, ops, scores, begin, end, got)
    if stats is not None:
        for key, v in zip(("skipped_rows", "clamped_pairs"), got):
            stats[key] = stats.get(key, 0) + int(v)
    return scores, ops, begin, end


def genasm_align(pats, txts, plens, tlens, *, max_score, backtrace,
                 threads=1):
    """GenASM host semantics: CLEAN bounded Levenshtein distance + the NW
    walker's D -> I -> diagonal priority on a proper 2-D table (see
    golden/genasm.py and oracle.cpp aim_genasm_align for the anchoring
    argument).  Distances above max_score report max_score+1 with the
    default "M" CIGAR (the framework's WFA overflow convention)."""
    lib = load()
    pats, txts, plens, tlens = _prep(pats, txts, plens, tlens)
    n, read_size = pats.shape
    max_ops = 2 * read_size
    scores = np.zeros(n, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)

    def worker(lo, hi):
        lib.aim_genasm_align(pats[lo:hi], txts[lo:hi], plens[lo:hi],
                             tlens[lo:hi], hi - lo, read_size, max_score,
                             int(backtrace), scores[lo:hi], ops[lo:hi],
                             begin[lo:hi], end[lo:hi])

    _run_chunked(n, threads, worker)
    return scores, ops, begin, end
