"""device_idle_pct: the share of the traced window in which a card ran no
kernel and no copy, the mean over the cell's cards (device trace)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    busy = run.trace["busy_s"]
    mean = sum(busy.get(d, 0.0) for d in range(run.chips)) / run.chips
    return 100.0 * (1.0 - mean / run.trace["window_s"])
