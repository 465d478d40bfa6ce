"""batch_ms_p95: the 95th percentile, by nearest rank, of the wall time
of every batch of the window (host clock)."""

import stats


def read(run):
    walls = [b["wall_s"] * 1e3 for b in run.batches]
    return stats.percentile(walls, 95) if walls else None
