"""The program's own record of the window's batches, for the
`program_span` readers: the last `len(run.batches)` rows of
`aim_tpu_torch.spans.calls()`, one row a batch's outermost call (stage
seconds and counters).

`rows` returns None where the program keeps no such log (a tree without
`aim_tpu_torch.spans`), where the log does not reach back past the
window's first batch (the warm batch's row comes before it), or where the
rows' pairs are not the batches' pairs, in order."""

from __future__ import annotations


def rows(run):
    try:
        from aim_tpu_torch import spans
    except ImportError:
        return None
    n = len(run.batches)
    log = spans.calls()
    if n == 0 or len(log) <= n:
        return None
    tail = log[-n:]
    if [int(p) for p in tail["pairs"]] != [b["pairs"] for b in run.batches]:
        return None
    return tail


def spanned_s(tail) -> float:
    """Seconds of every stage span in the rows."""
    from aim_tpu_torch.spans import STAGES
    return sum(float(tail[s].sum()) for s in STAGES)


def ms_per_mpair(run, stage: str):
    """One stage's seconds over the window's batches, milliseconds a
    million pairs."""
    tail = rows(run)
    if tail is None:
        return None
    return float(tail[stage].sum()) * 1e3 / (float(tail["pairs"].sum()) / 1e6)


def gb_s(run, counter: str, stage: str):
    """A byte counter over a stage's seconds, GB/s; None where the stage
    took no time."""
    tail = rows(run)
    if tail is None:
        return None
    seconds = float(tail[stage].sum())
    if seconds <= 0:
        return None
    return float(tail[counter].sum()) / seconds / 1e9
