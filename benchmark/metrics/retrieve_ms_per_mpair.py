"""retrieve_ms_per_mpair: the program's retrieve time over the window's batches,
milliseconds a million pairs (the span the program reports)."""

import stats


def read(run):
    return stats.span_per_mpair(run.batches, "retrieve_ms")
