"""pairs_s: pairs aligned in the window's completed batches over all of
the window's time (host clock)."""

import stats


def read(run):
    if not run.batches:
        return None
    return stats.rate([b["pairs"] for b in run.batches], run.window_s)
