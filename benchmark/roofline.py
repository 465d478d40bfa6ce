"""Frozen work counts and the table of peaks.

The work of a kernel is counted from the problem it solves, never from
how the program solves it: the pairs' lengths, and the plain reference's
scores and WFA cells.  A change to the program's kernels, records or
launch shapes leaves these counts as they are.

WFA (K1 at 100 bp, K5 at 10 kbp), a pair of pattern length p and text
length t:

- bytes: the bases in at 2 bits each, `ceil(p/4) + ceil(t/4)`; the score
  out, 4; the CIGAR out at 2 bits an op, an alignment having at least
  `max(p, t)` ops, `ceil(max(p, t)/4)`.  Each byte is counted once, read
  or written, whatever a kernel reads again.
- int32 operations: 10 a WFA cell the reference computed (each level's
  diagonals, from the sources' extents, before the adaptive cut), plus
  one a 32-base window of the `min(p, t)` bases the extensions compare.

The bound of a count is the larger of bytes over the card's memory
bandwidth and operations over its int32 rate; a kernel's share of its
roofline is that bound over the kernel's device time.
"""

from __future__ import annotations

import numpy as np

OPS_PER_CELL = 10
WINDOW_BASES = 32

# Published peaks (NVIDIA's data sheet, SXM part, at its 700 W limit):
# HBM3 bandwidth, and int32 lanes x SMs x boost clock (64 x 132 x 1.98 GHz).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_s": 3.35e12, "int32_ops_s": 16.7e12},
}


def _ceil_div(a, b):
    return -(-np.asarray(a, np.int64) // b)


def wfa_bytes(plens, tlens) -> int:
    """Bytes a WFA kernel must move for these pairs."""
    p = np.asarray(plens, np.int64)
    t = np.asarray(tlens, np.int64)
    return int((_ceil_div(p, 4) + _ceil_div(t, 4) + 4
                + _ceil_div(np.maximum(p, t), 4)).sum())


def wfa_ops(plens, tlens, cells) -> int:
    """int32 operations of the WFA cells and match windows of these
    pairs; `cells` is the reference's count a pair."""
    p = np.asarray(plens, np.int64)
    t = np.asarray(tlens, np.int64)
    return int(OPS_PER_CELL * np.asarray(cells, np.int64).sum()
               + _ceil_div(np.minimum(p, t), WINDOW_BASES).sum())


def bound_s(n_bytes: float, n_ops: float, card: str) -> float | None:
    """The least time the card could take for this work, or None for a
    card not in the table."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    return max(n_bytes / peak["bytes_s"], n_ops / peak["int32_ops_s"])


def share(run, kernel: str) -> float | None:
    """A kernel's share of its roofline in a traced run, in %: the bound of
    the window's work over the device time of the kernels whose names hold
    `kernel`; None where the trace shows no such kernel or the card has no
    peaks here."""
    if run.trace is None:
        return None
    dev_s = sum(v for k, v in run.trace["device_s_by_name"].items()
                if kernel in k)
    if dev_s <= 0:
        return None
    by_unit = {}
    n_bytes = n_ops = 0
    for b in run.batches:
        if b["unit"] not in by_unit:
            by_unit[b["unit"]] = run.entry.work(b["unit"])
        work = by_unit[b["unit"]]
        if work is None:
            return None
        n_bytes += work[0]
        n_ops += work[1]
    bound = bound_s(n_bytes, n_ops, run.card)
    return None if bound is None else 100.0 * bound / dev_s
