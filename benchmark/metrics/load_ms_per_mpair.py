"""load_ms_per_mpair: the program's load time over the window's batches,
milliseconds a million pairs (the span the program reports)."""

import stats


def read(run):
    return stats.span_per_mpair(run.batches, "load_ms")
