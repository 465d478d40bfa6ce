"""fallback_ns_per_cell: the program's `fallback` spans over its counter
`fallback_cells` (the (plen + 1)(tlen + 1) cells of each table the host
oracle filled), the oracle's wall nanoseconds a table cell on the host's
threads; None where the program has no such counter or the oracle took
no pair (program span and counter)."""

import program_spans

COUNTER = "fallback_cells"


def read(run):
    tail = program_spans.rows(run)
    if tail is None or COUNTER not in tail.dtype.names:
        return None
    cells = int(tail[COUNTER].sum())
    seconds = float(tail["fallback"].sum())
    if cells <= 0 or seconds <= 0:
        return None
    return seconds * 1e9 / cells
