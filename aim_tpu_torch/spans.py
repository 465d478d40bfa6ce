"""One span mechanism for the host stages of a call.

``call(entry, pairs)`` opens a call's record; the outermost of
``cli.main`` / ``api.align_file`` / ``api.align`` opens it, and a nested
call joins its caller's record.  Records are per thread.  Inside a call,
``span(stage)`` adds the stage's host-clock seconds to the record and
``count(name, n)`` adds to a counter.  The stages are disjoint: none
nests in another, so their sum never exceeds the call.

While a torch profiler is active, ``call`` and ``span`` also open
``record_function("aim.call")`` / ``"aim.<stage>"`` (``aim.call`` at the
outermost entry that finds the profiler active, so ``align_file``'s own
profiler still shows it inside ``cli.main``'s call): the stages then sit
on the device trace's own clock, and each idle gap of the card is
labelled by the stage the host was in (a span's seconds then hold its
range's own cost).  With none active a span reads a flag and dispatches
no torch op.

A finished call appends one row to a process-wide ring of ``CAPACITY``
rows (``calls()``, newest last) and stays on the ``AlignResult`` it
returns (``AlignResult.spans``).  A call that raises records nothing.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch.autograd.profiler as _profiler

STAGES = (
    "parse",     # native.parse_pairs
    # "sort" and "permute": no code opens them, so they read 0; they stay
    # because benchmark/metrics/sort_ms_per_mpair.py and
    # permute_ms_per_mpair.py index these fields of the ring
    "sort",
    "permute",
    "pack",      # pack_seqs and the tier pick
    "plan",      # _plan_bs (cudaMemGetInfo), the result arrays
    "upload",    # to_device_batch and the sync, a wave
    "kernel",    # launch and sync, a chunk; on the host tier, the oracle
    "retrieve",  # the records' .cpu().numpy(), a wave
    "decode",    # the call's records into scores and CIGARs, one pass
    "retry",     # _retry_wide, its own transfers included
    "fallback",  # the host oracle on flagged pairs, _overflow_bt_pass
    "emit",      # native.emit_output
)
COUNTERS = (
    "chunks",     # chunks of the wave loop
    "h2d_bytes",  # the four arrays of each wave-loop block, after packing
    "d2h_bytes",  # the wave loop's records
    "decode_threads",  # threads that decoded the call's CIGARs, 0 if none
    "pack_threads",    # threads of the fused ACGT pack pass, 0 if none
    "parse_threads",   # threads of the parse pass over the mapped file
    "flagged_pairs",   # pairs the primary tier flagged
    "retry_pairs",     # flagged pairs a wider band of the ladder certified
    "fallback_pairs",  # flagged pairs the exact host oracle computed
    "alias_pairs",     # flagged pairs with plen > tlen + 1: no band certifies
    "fallback_cells",  # cells of the oracle's tables, (plen+1)(tlen+1) a pair
    "over_k_pairs",    # GenASM pairs past k, scored k + 1, walked by none
    "decode_skipped_rows",   # step-record level rows decoded with no write
    "decode_clamped_pairs",  # step records that overran their row, clamped
)
ENTRIES = ("align", "align_file", "cli")
CAPACITY = 16384
DTYPE = np.dtype([("entry", "U10"), ("pairs", np.int64),
                  ("call_s", np.float64)]
                 + [(s, np.float64) for s in STAGES]
                 + [(c, np.int64) for c in COUNTERS])
_RANGES = {s: "aim." + s for s in STAGES}


class Record:
    """One call: its entry, pairs, wall seconds (set when it closes), the
    seconds of each stage and the counters."""

    __slots__ = ("entry", "pairs", "call_s", "seconds", "counts", "ranged")

    def __init__(self, entry: str, pairs: int):
        self.entry = entry
        self.pairs = pairs
        self.call_s = 0.0
        self.ranged = False     # an aim.call range is open
        self.seconds = dict.fromkeys(STAGES, 0.0)
        self.counts = dict.fromkeys(COUNTERS, 0)

    def row(self) -> tuple:
        return (self.entry, self.pairs, self.call_s,
                *self.seconds.values(), *self.counts.values())


class Ring:
    """The last ``capacity`` records as rows of ``DTYPE``, in fixed
    memory."""

    def __init__(self, capacity: int):
        self._rows = np.zeros(capacity, DTYPE)
        self._written = 0
        self._lock = threading.Lock()

    def append(self, rec: Record):
        with self._lock:
            self._rows[self._written % len(self._rows)] = rec.row()
            self._written += 1

    def rows(self) -> np.ndarray:
        """A copy of the rows held, oldest first."""
        with self._lock:
            cap = len(self._rows)
            if self._written <= cap:
                return self._rows[:self._written].copy()
            cut = self._written % cap
            return np.concatenate((self._rows[cut:], self._rows[:cut]))


_LOG = Ring(CAPACITY)
_local = threading.local()


def calls() -> np.ndarray:
    """The log of finished calls (``DTYPE`` rows), newest last."""
    return _LOG.rows()


def _range(name: str):
    """An entered ``record_function`` range while a profiler is active,
    else None: a flag read, no torch op."""
    if not _profiler._is_profiler_enabled:
        return None
    rf = _profiler.record_function(name)
    rf.__enter__()
    return rf


class span:
    """``with span(stage):`` adds the block's host-clock seconds to the
    open call's ``stage``."""

    __slots__ = ("stage", "rec", "rf", "t0")

    def __init__(self, stage: str):
        if stage not in _RANGES:
            raise ValueError(f"unknown stage {stage!r}")
        self.stage = stage

    def __enter__(self):
        self.rec = getattr(_local, "rec", None)
        self.t0 = time.perf_counter()
        self.rf = _range(_RANGES[self.stage])
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.rec is not None:
            self.rec.seconds[self.stage] += time.perf_counter() - self.t0
        return False


def count(name: str, n: int):
    """Add ``n`` to the open call's counter ``name``."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.counts[name] += n


class call:
    """``with call(entry, pairs) as rec:`` opens this thread's record, or
    joins the one open (a nested call); the outermost, when it ends
    without raising, sets ``rec.call_s`` and appends the record to the
    log."""

    __slots__ = ("rec", "outer", "rf", "t0")

    def __init__(self, entry: str, pairs: int = 0):
        if entry not in ENTRIES:
            raise ValueError(f"unknown entry {entry!r}")
        self.rec = getattr(_local, "rec", None)
        self.outer = self.rec is None
        if self.outer:
            self.rec = Record(entry, pairs)

    def __enter__(self) -> Record:
        if self.outer:
            _local.rec = self.rec
            self.t0 = time.perf_counter()
        self.rf = None if self.rec.ranged else _range("aim.call")
        self.rec.ranged |= self.rf is not None
        return self.rec

    def __exit__(self, exc_type, exc, tb):
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
            self.rec.ranged = False
        if not self.outer:
            return False
        self.rec.call_s = time.perf_counter() - self.t0
        _local.rec = None
        if exc_type is None:
            _LOG.append(self.rec)
        return False
